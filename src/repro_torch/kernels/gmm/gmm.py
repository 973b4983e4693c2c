"""Capacity-binned grouped matmul: the wrapper around the CUDA kernel in
``csrc/gmm_capacity.cu``.

Port of ``repro.kernels.gmm.gmm.gmm_capacity``: ``out[e] = x[e] @ w[e]`` for
tokens already dispatched to fixed-capacity expert bins, fp32 accumulation,
cast to x's dtype.  The reference asserts that C, F and D are multiples of
its blocks (min(128, ·), min(512, D)); the kernels mask ragged edges, so
they take any C (the reference's own tests use C = 4).

Two bodies, chosen per call by ``_route`` before the launch, each taking
any D, F and base: ``"sm90"`` for every bf16 call (TMA and wgmma; its
producer loads the tiles by TMA where TMA can address both operands and
stages the one it cannot by ``cp.async`` into the same layout otherwise,
``_producer``: ``"tma"`` or ``"staged"``) and ``"simt90"`` for every fp32
call (the CUDA cores through a ring of shared-memory tiles, 16-byte copies
where every piece is aligned and 4-byte ones otherwise).

CPU tensors take the plain PyTorch version (``ref.gmm_capacity_ref``); CUDA
tensors launch the kernel or raise.  ``LAUNCHES`` counts kernel launches,
``LAST_ROUTE`` holds the route of the last one, ``LAST_PRODUCER`` the
producer its launcher reported (None after an fp32 launch), and
``ROUTE_LAUNCHES`` tallies them by route.
"""
from __future__ import annotations

import ctypes
from collections import Counter
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import build, refuse_autograd
from repro_torch.kernels.gmm.ref import gmm_capacity_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "gmm_capacity.cu"

# kernel launches since the last reset
LAUNCHES = {"gmm_capacity": 0}
# the route of the last launch, the bf16 body's producer as its launcher
# reported it ("tma" or "staged"; None after an fp32 launch), and launches
# since the last reset by route
LAST_ROUTE = {"gmm_capacity": None}
LAST_PRODUCER = {"gmm_capacity": None}
ROUTE_LAUNCHES: Counter = Counter()

_DTYPES = (torch.bfloat16, torch.float32)
_MAX_GRID = 65535


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    ROUTE_LAUNCHES.clear()


def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gmm_capacity_sm90_launch.argtypes = [p, p, p, i, i, i, i, p,
                                                 ctypes.POINTER(i)]
        lib.gmm_capacity_simt90_launch.argtypes = [p, p, p, i, i, i, i, p]
        for fn in (lib.gmm_capacity_sm90_launch,
                   lib.gmm_capacity_simt90_launch):
            fn.restype = i
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
    """The body a call takes: ``"sm90"`` for bf16, ``"simt90"`` for fp32,
    at any D, F and base."""
    return "simt90" if x.dtype == torch.float32 else "sm90"


def _producer(x: torch.Tensor, w: torch.Tensor) -> Optional[str]:
    """The producer the bf16 body takes: ``"tma"`` when TMA can address x
    and w (D and F multiples of 8, both bases 16-byte aligned; the output,
    a new tensor, always is), ``"staged"`` otherwise; None for fp32."""
    if x.dtype == torch.float32:
        return None
    tma = (x.shape[2] % 8 == 0 and w.shape[2] % 8 == 0
           and x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0)
    return "tma" if tma else "staged"


def gmm_capacity(x: torch.Tensor,           # (E, C, D) dispatched tokens
                 w: torch.Tensor            # (E, D, F) expert weights
                 ) -> torch.Tensor:         # (E, C, F)
    """Batched per-expert product with fp32 accumulation, cast to x's
    dtype, through the kernel ``_route`` picks."""
    refuse_autograd("gmm_capacity", x, w)
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
    route, producer = _route(x, w), _producer(x, w)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    args = (x.data_ptr(), w.data_ptr(), out.data_ptr(), E, C, D, F, stream)
    staged = ctypes.c_int(-1)
    with torch.cuda.device(x.device):
        if route == "sm90":
            status = _lib().gmm_capacity_sm90_launch(*args,
                                                     ctypes.byref(staged))
        else:
            status = _lib().gmm_capacity_simt90_launch(*args)
    build.check(status, "gmm_capacity")
    # lint: allow[T106] credited by RoundGraphs on every replay
    LAUNCHES["gmm_capacity"] += 1
    # lint: allow[T106] a replay launches what its capture did
    LAST_ROUTE["gmm_capacity"] = route
    # lint: allow[T106] eager runs and captures only (chip_smoke's checks)
    ROUTE_LAUNCHES[route] += 1
    reported = (None if route == "simt90"
                else "staged" if staged.value else "tma")
    # lint: allow[T106] a replay launches what its capture did
    LAST_PRODUCER["gmm_capacity"] = reported
    if reported != producer:
        raise RuntimeError(f"gmm_capacity: the launcher took the {reported} "
                           f"producer, _producer predicted {producer}")
    return out
