"""The command's refusals: no result and a non-zero exit without a card,
and in a folder that holds only the benchmark's files."""
from __future__ import annotations

import shutil
import subprocess
import sys

import pytest

import perfbench_cpu_cells  # noqa: F401
from perfbench.harness import cells

ROOT = cells.ROOT
ARGS = ["--workload", "qwen2moe-ar-wave-b32", "--seed", str(2**31 + 3),
        "--seconds", "1", "--trace", "0"]


def _run(root):
    return subprocess.run([sys.executable, "perfbench/run.py", *ARGS],
                          cwd=root, capture_output=True, text=True,
                          timeout=300)


def test_no_result_without_a_card():
    torch = pytest.importorskip("torch")
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would measure it")
    out = _run(ROOT)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA card" in out.stderr


def test_no_result_with_only_the_benchmarks_files(tmp_path):
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout == ""
    assert "src/repro_torch" in out.stderr
