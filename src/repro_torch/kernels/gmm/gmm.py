"""Capacity-binned grouped matmul: the wrapper around the CUDA kernel in
``csrc/gmm_capacity.cu``.

Port of ``repro.kernels.gmm.gmm.gmm_capacity``: ``out[e] = x[e] @ w[e]`` for
tokens already dispatched to fixed-capacity expert bins, fp32 accumulation,
cast to x's dtype.  The reference asserts that C, F and D are multiples of
its blocks (min(128, ·), min(512, D)); the kernels mask ragged edges, so
they take any C (the reference's own tests use C = 4).

Three kernels, chosen per call by ``_route``: ``"sm90"`` (bf16 through TMA
and wgmma, whenever TMA can address x and w), ``"wmma"`` (bf16 shapes whose
row pitch or base TMA cannot take) and ``"simt"`` (fp32).

CPU tensors take the plain PyTorch version (``ref.gmm_capacity_ref``); CUDA
tensors launch the kernel or raise.  ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels.gmm.ref import gmm_capacity_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "gmm_capacity.cu"

# kernel launches since the last reset
LAUNCHES = {"gmm_capacity": 0}

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
_MAX_GRID = 65535


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gmm_capacity_launch.argtypes = [i, i, p, p, p, i, i, i, i, i, p]
        lib.gmm_capacity_launch.restype = i
        lib.gmm_capacity_sm90_launch.argtypes = [p, p, p, i, i, i, i, p]
        lib.gmm_capacity_sm90_launch.restype = i
        lib._argtypes_set = True
    return lib


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dtype not in _DTYPES:
        raise TypeError(f"gmm_capacity takes bf16 or fp32, got {x.dtype}")
    if x.dim() != 3 or w.dim() != 3 or w.shape[:2] != (x.shape[0], x.shape[2]):
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} must be "
                         "(E, C, D) and (E, D, F)")
    if w.device != x.device or w.dtype != x.dtype:
        raise ValueError("x and w must share device and dtype")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("gmm_capacity takes contiguous tensors")
    if x.shape[0] > _MAX_GRID:
        raise ValueError(f"{x.shape[0]} experts exceed the grid")


def _route(x: torch.Tensor, w: torch.Tensor) -> str:
    """The kernel a call takes: ``"simt"`` for fp32; for bf16 ``"sm90"``
    when TMA can address both operands (row pitches D and F multiples of
    16 bytes, 16-byte aligned bases), else ``"wmma"``."""
    if x.dtype == torch.float32:
        return "simt"
    vec = 16 // x.element_size()
    if (x.shape[2] % vec == 0 and w.shape[2] % vec == 0
            and x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0):
        return "sm90"
    return "wmma"


def gmm_capacity(x: torch.Tensor,           # (E, C, D) dispatched tokens
                 w: torch.Tensor            # (E, D, F) expert weights
                 ) -> torch.Tensor:         # (E, C, F)
    """Batched per-expert product with fp32 accumulation, cast to x's
    dtype, through the kernel ``_route`` picks."""
    if x.device.type == "cpu":
        return gmm_capacity_ref(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"no gmm_capacity kernel for device {x.device}")
    _check(x, w)
    E, C, D = x.shape
    F = w.shape[2]
    out = torch.empty((E, C, F), dtype=x.dtype, device=x.device)
    if 0 in (E, C, F):
        return out
    route = _route(x, w)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        if route == "sm90":
            status = _lib().gmm_capacity_sm90_launch(
                x.data_ptr(), w.data_ptr(), out.data_ptr(), E, C, D, F, stream)
        else:
            bm = 64 if C >= 64 else 16
            # fp32 loads 16-byte vectors where every row and base allows;
            # the WMMA kernel serves only shapes that do not
            aligned = route == "simt" and (
                D % 4 == 0 and F % 4 == 0
                and all(t.data_ptr() % 16 == 0 for t in (x, w, out)))
            status = _lib().gmm_capacity_launch(
                _DTYPES[x.dtype], bm, x.data_ptr(), w.data_ptr(),
                out.data_ptr(), E, C, D, F, int(aligned), stream)
    build.check(status, "gmm_capacity")
    LAUNCHES["gmm_capacity"] += 1
    return out
