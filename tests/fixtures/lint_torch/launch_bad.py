"""Fixture: ctypes bindings that disagree with their extern "C" (P3xx)."""
import ctypes
from pathlib import Path

from repro_torch.kernels import build

SOURCE = Path(__file__).resolve().parent / "launch_bad.cu"


def _lib():
    lib = build.load(SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.toy_launch.argtypes = [p, p, i]
    lib.toy_scale.argtypes = [p, i, i]
    lib.toy_bytes.argtypes = [i]
    lib.toy_count.argtypes = [i]
    lib.toy_count.restype = ctypes.c_float
    return lib


def launch(x):
    lib = _lib()
    lib.toy_scale(x, 1, 2.0, 3)
    return lib.toy_missing(x)
