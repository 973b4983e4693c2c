"""Paged decode/verify attention: the wrapper around the CUDA kernel in
``csrc/paged_decode_attention.cu``.

Port of ``repro.kernels.decode_attention.ops.paged_decode_attention``: T
fresh queries per sequence at positions ``lengths + t`` attend to the K/V
pages the block table maps for that sequence, straight from the pool, with
no dense ``pool[table]`` gather.

CPU tensors take the plain PyTorch version (``ref.py``); CUDA tensors launch
the kernel or raise.  ``lengths`` and ``table`` stay on the device: the
wrapper checks dtypes, devices, shapes and contiguity, never table values,
because reading them would sync.  ``LAUNCHES`` counts calls that launched
the kernel (one per call, whether or not it also ran its combine step).

Two split-KV bodies at head dims 32, 64, 128 and 256, on pages of any
size: bf16 runs the TMA + wgmma body (``csrc/paged_sm90.cuh``: K/V boxes of
gcd(page size, 64) rows, or chunks staged by cp.async on pages that are not
a multiple of 8), fp32 the CUDA-core body (``kernels/csrc/decode_f32.cuh``).
The launcher reports which one it launched, and ``LAST_ROUTE`` holds it
(``"sm90"`` or ``"f32"``; ``ROUTE_LAUNCHES`` tallies launches by (route,
head dim)).  The split partials go into scratch the launcher sizes
(``paged_decode_attention_scratch_bytes``) and this wrapper allocates.
"""
from __future__ import annotations

import ctypes
import math
from collections import Counter
from pathlib import Path

import torch

from repro_torch.kernels import build, refuse_autograd
from repro_torch.kernels.decode_attention.ref import paged_decode_attention_plain

SOURCE = Path(__file__).resolve().parent / "csrc" / "paged_decode_attention.cu"

# kernel launches since the last reset
LAUNCHES = {"paged_decode_attention": 0}
# the body the last launch ran, as the launcher reported it
LAST_ROUTE = {"paged_decode_attention": None}
# launches since the last reset by (route, head dim): eager calls and
# the calls a CUDA graph captures (a replay runs what was captured)
ROUTE_LAUNCHES: Counter = Counter()
_ROUTES = ("sm90", "f32")     # the launcher's kernel codes

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
HEAD_DIMS = (32, 64, 128, 256)
MAX_ROWS = 64                  # g * T query rows one block holds


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    ROUTE_LAUNCHES.clear()


def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    if not getattr(lib, "_argtypes_set", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.paged_decode_attention_launch.argtypes = [
            i, i, p, p, p, p, p, p, p, i, i, i, i, i, i, i, f, f, p,
            ctypes.POINTER(i)]
        lib.paged_decode_attention_launch.restype = i
        lib.paged_decode_attention_scratch_bytes.argtypes = [i] * 8
        lib.paged_decode_attention_scratch_bytes.restype = ctypes.c_longlong
        lib._argtypes_set = True
    return lib


def _check(q, k_pages, v_pages, lengths, table) -> None:
    if q.dtype not in _DTYPES:
        raise TypeError(f"paged attention takes bf16 or fp32, got {q.dtype}")
    if q.dim() != 4 or k_pages.dim() != 4:
        raise ValueError("q must be (B, T, Hq, D) and the pools (NP, ps, Hkv, D)")
    B, T, Hq, D = q.shape
    _, _, Hkv, Dk = k_pages.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"the kernel is built for head dims {HEAD_DIMS}, "
                         f"got {D}")
    if Dk != D or v_pages.shape != k_pages.shape:
        raise ValueError(f"pools {tuple(k_pages.shape)}, "
                         f"{tuple(v_pages.shape)} do not match q {tuple(q.shape)}")
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"{Hq} query heads do not group over {Hkv} KV heads")
    if (Hq // Hkv) * T > MAX_ROWS:
        raise ValueError(f"g*T = {(Hq // Hkv) * T} query rows exceed the "
                         f"kernel's {MAX_ROWS}")
    for t in (k_pages, v_pages):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError("q and the pools must share device and dtype")
    for t, shape in ((lengths, (B,)), (table, (B, table.shape[-1]))):
        if (t.dtype != torch.int32 or t.device != q.device
                or tuple(t.shape) != shape):
            raise ValueError(f"lengths/table must be int32 {shape} on "
                             f"{q.device}")
    for t in (q, k_pages, v_pages, lengths, table):
        if not t.is_contiguous():
            raise ValueError("the paged kernel takes contiguous tensors")
    if any(t.data_ptr() % 16 for t in (q, k_pages, v_pages)):
        raise ValueError("q and the pools must be 16-byte aligned")


def paged_decode_attention(
    q: torch.Tensor,           # (B, T, Hq, D)
    k_pages: torch.Tensor,     # (NP, ps, Hkv, D) physical page pool
    v_pages: torch.Tensor,
    lengths: torch.Tensor,     # (B,) int32: queries sit at lengths + t
    table: torch.Tensor,       # (B, MP) int32 logical -> physical page
    *,
    scale: float = 0.0,
    logit_cap: float = 0.0,
) -> torch.Tensor:             # (B, T, Hq, D)
    """Causal decode/verify attention over the paged pool; the result is in
    q's dtype.  ``scale`` 0 means 1/sqrt(D); ``logit_cap`` > 0 softcaps the
    logits with tanh."""
    refuse_autograd("paged_decode_attention", q, k_pages, v_pages)
    if q.device.type == "cpu":
        return paged_decode_attention_plain(
            q, k_pages, v_pages, lengths, table, scale=scale,
            logit_cap=logit_cap)
    if q.device.type != "cuda":
        raise ValueError(f"no paged attention kernel for device {q.device}")
    _check(q, k_pages, v_pages, lengths, table)
    B, T, Hq, D = q.shape
    NP, ps, Hkv, _ = k_pages.shape
    MP = table.shape[1]
    if scale == 0.0:
        scale = 1.0 / math.sqrt(D)
    out = torch.empty_like(q)
    if B == 0 or T == 0:
        return out
    kernel = ctypes.c_int(-1)
    with torch.cuda.device(q.device):
        lib = _lib()
        dt = _DTYPES[q.dtype]
        n = lib.paged_decode_attention_scratch_bytes(dt, D, B, T, Hq, Hkv, ps,
                                                     MP)
        scratch = torch.empty((n,), dtype=torch.uint8, device=q.device) \
            if n else None
        status = lib.paged_decode_attention_launch(
            dt, D, q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            lengths.data_ptr(), table.data_ptr(), out.data_ptr(),
            scratch.data_ptr() if n else None, B, T, Hq, Hkv, NP, ps, MP,
            float(scale), float(logit_cap),
            torch.cuda.current_stream().cuda_stream, ctypes.byref(kernel))
    build.check(status, "paged_decode_attention")
    # lint: allow[T106] credited by RoundGraphs on every replay
    LAUNCHES["paged_decode_attention"] += 1
    # lint: allow[T106] a replay launches what its capture did
    LAST_ROUTE["paged_decode_attention"] = _ROUTES[kernel.value]
    # lint: allow[T106] eager runs and captures only (chip_smoke's checks)
    ROUTE_LAUNCHES[LAST_ROUTE["paged_decode_attention"], D] += 1
    return out
