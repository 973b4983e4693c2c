"""Build and load the port's CUDA kernels (``nvcc`` into a shared library
with a plain C interface, loaded with ``ctypes``).

Each source under ``csrc/`` is compiled at first use for ``sm_90a`` into
``build/kernels/`` at the root of the checkout, named by the hash of its
source and of the headers it includes with ``#include "..."``, so an edited
source or header is rebuilt and an unchanged one is reused.
Nothing is compiled when a module is imported: the CPU tests import every
module, and there is no ``nvcc`` there.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Sequence

REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_loaded: Dict[Path, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``/usr/local/cuda``'s,
    or the one on ``PATH``.  Raises when there is none."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([Path(home) / "bin" / "nvcc"] if home else []) + [
            Path("/usr/local/cuda/bin/nvcc")]:
        if cand.is_file():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                           "(set CUDA_HOME or put nvcc on PATH)")
    return found


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _source_bytes(source: Path, seen=None) -> bytes:
    """The source and, recursively, every header it includes with quotes."""
    seen = set() if seen is None else seen
    source = source.resolve()
    if source in seen:
        return b""
    seen.add(source)
    text = source.read_bytes()
    return text + b"".join(_source_bytes(source.parent / inc.decode(), seen)
                           for inc in _LOCAL_INCLUDE.findall(text))


def library_path(source: Path) -> Path:
    digest = hashlib.sha256(_source_bytes(source)
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{source.stem}-{digest}.so"


def build(source: Path) -> Path:
    """Compile ``source`` unless its library is already built; returns the
    library's path.  The output is written under a temporary name and then
    renamed, so concurrent builds never load a half-written file."""
    out = library_path(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(source)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {source.name}:\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def build_all(sources: Sequence[Path]) -> None:
    """Compile every source at once, one ``nvcc`` process each."""
    with ThreadPoolExecutor(max_workers=max(len(sources), 1)) as pool:
        for fut in [pool.submit(build, s) for s in sources]:
            fut.result()


def load(source: Path) -> ctypes.CDLL:
    """Build (if needed) and load the shared library of one source."""
    with _lock:
        lib = _loaded.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(build(source)))
            _loaded[source] = lib
        return lib


def check(status: int, what: str) -> None:
    """Raise if a launcher returned an error: its cudaGetLastError(), or a
    negative code of its own for arguments it refused."""
    if status != 0:
        kind = "CUDA error" if status > 0 else "launcher refused its arguments,"
        raise RuntimeError(f"{what}: {kind} {status} at launch")
