"""The port's examples (examples/*_torch.py) import the port alone.

``sparsity_sweep_torch.py`` is host arithmetic (the simulator and the
Alg. 1 fit) and finishes in seconds: it runs here whole, in a fresh
interpreter that must not load JAX.  The other three train models and
serve them; they take minutes on the CPU and are checked for what they
import only.
"""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
EXAMPLES = ("quickstart_torch.py", "serve_moesd_torch.py",
            "sparsity_sweep_torch.py", "train_100m_torch.py")


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_imports_only_the_port(name):
    tree = ast.parse((REPO / "examples" / name).read_text())
    mods = {a.name.split(".")[0] for n in ast.walk(tree)
            if isinstance(n, ast.Import) for a in n.names}
    mods |= {n.module.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom) and n.module}
    assert not mods & {"jax", "repro", "jaxlib", "flax"}, mods
    assert "repro_torch" in mods
    assert "--device" in (REPO / "examples" / name).read_text()


def test_sparsity_sweep_runs_without_jax():
    code = ("import runpy, sys; sys.argv = sys.argv[1:]; "
            "runpy.run_path(sys.argv[0], run_name='__main__'); "
            "assert 'jax' not in sys.modules")
    out = subprocess.run(
        [sys.executable, "-c", code,
         str(REPO / "examples" / "sparsity_sweep_torch.py")],
        capture_output=True, text=True, timeout=120, cwd=str(REPO),
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.splitlines()
    assert sum(line.split()[0] in {"1", "2", "4", "8", "16", "32"}
               for line in lines if line.strip()) == 6
    assert any("Alg.1 model fitted on 21 points" in line for line in lines)
    assert sum("model" in line and "simulator" in line for line in lines) == 3
