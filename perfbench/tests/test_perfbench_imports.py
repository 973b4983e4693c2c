"""Nothing under perfbench/ imports JAX or the JAX package, compared by
whole top-level name (``repro_torch`` is the port, ``repro`` the JAX
package); nothing reads the JAX package's ``benchmarks/``; the reference
imports nothing of the program."""
from __future__ import annotations

import ast
import subprocess
import sys

import pytest

import perfbench_cpu_cells  # noqa: F401
from perfbench.harness import cells, runner

BENCH = cells.BENCH_DIR
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imported_tops(path) -> set:
    tree = ast.parse(path.read_text())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              in ("import_module",) and node.args
              and isinstance(node.args[0], ast.Constant)):
            tops.add(str(node.args[0].value).split(".")[0])
    return tops


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_and_no_jax_package(path):
    assert not imported_tops(path) & FORBIDDEN
    text = path.read_text()
    jax_benchmarks = "benchmarks" + "/"
    assert '"' + jax_benchmarks not in text
    assert "'" + jax_benchmarks not in text


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        tops = imported_tops(path)
        assert tops <= {"__future__", "math", "typing", "torch"}, tops


def test_the_top_level_name_is_compared_whole():
    ok = ["repro_torch", "repro_torch.models.moe", "jaxtyping", "reprox",
          "torch", "numpy"]
    assert runner.forbidden_modules(ok) == []
    assert runner.forbidden_modules(ok + ["repro.models", "jax.numpy",
                                          "flax"]) == ["flax", "jax",
                                                       "repro"]


def test_a_run_of_the_harness_loads_no_jax():
    code = ("import sys; sys.path[:0] = [%r, %r]; "
            "from perfbench.harness import runner, check; "
            "from perfbench import calibrate, run; "
            "import repro_torch.serving.engine, repro_torch.core.eagle; "
            "print(runner.forbidden_modules())"
            % (str(cells.ROOT), str(cells.ROOT / "src")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    assert out.strip() == "[]"
