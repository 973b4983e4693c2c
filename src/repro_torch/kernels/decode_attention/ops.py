"""Dense decode/verify attention: the wrapper around the CUDA kernel in
``csrc/decode_attention.cu``, in the (B, T, H, D) layout the model uses.

Port of ``repro.kernels.decode_attention.ops.decode_attention``: T fresh
queries per sequence at positions ``lengths + t`` attend, causally, to a
contiguous (B, S, Hkv, D) cache that already holds their own K/V.  The
reference transposes q and the cache to (B, H, T, D) first; the port's
kernel reads them in place through their strides, so a slice of the model's
(B, S+1, Hkv, D) cache is passed as it is and no per-layer copy is made.

CPU tensors take the plain PyTorch version (``ref.py``); CUDA tensors launch
the kernel or raise.  ``lengths`` stays on the device: the wrapper checks
dtypes, devices, shapes and strides, never values, because reading them
would sync.  ``LAUNCHES`` counts calls that launched the kernel (one per
call, whether or not it also ran its combine step).  The paged wrapper of
the same reference module is ``paged.paged_decode_attention``.

Three bodies: bf16 at head dims 64, 128 and 256 with g * T <= 64 query
rows per KV head runs the split-KV TMA + wgmma body
(``csrc/decode_sm90.cuh``), other bf16 calls (head dim 32, or more rows)
the WMMA body and fp32 the CUDA-core body of
``kernels/csrc/attention_tile.cuh``.  The launcher
reports which one it launched, and ``LAST_ROUTE`` holds it (``"sm90"``,
``"wmma"`` or ``"simt"``; ``ROUTE_LAUNCHES`` tallies launches by (route, head
dim)).  The split partials go into scratch the launcher sizes
(``decode_attention_scratch_bytes``) and this wrapper takes from torch's
allocator on the current stream, so a call never syncs and can be captured
in a CUDA graph.

``decode_attention_partial`` is the same kernel's entry over one key block
of a cache split along its sequence over the ranks of a mesh (keys at
positions ``k_lo ..``): it returns the block's output and the fp32
log-sum-exp of each row, which ``distributed/collectives.lse_combine``
merges across the blocks; ``LAUNCHES["decode_attention_partial"]`` counts
it.
"""
from __future__ import annotations

import ctypes
import math
from collections import Counter
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import attention_launch, build, refuse_autograd
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_partial_plain, decode_attention_plain)

SOURCE = Path(__file__).resolve().parent / "csrc" / "decode_attention.cu"

# kernel launches since the last reset
LAUNCHES = {"decode_attention": 0, "decode_attention_partial": 0}
# the body the last launch ran, as the launcher reported it
LAST_ROUTE = {"decode_attention": None, "decode_attention_partial": None}
# launches since the last reset by (route, head dim), both entries: eager
# calls and
# the calls a CUDA graph captures (a replay runs what was captured)
ROUTE_LAUNCHES: Counter = Counter()
_ROUTES = ("sm90", "wmma", "simt")     # the launcher's kernel codes


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    ROUTE_LAUNCHES.clear()


def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    if not getattr(lib, "_argtypes_set", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        st = ctypes.POINTER(ctypes.c_longlong)
        lib.decode_attention_launch.argtypes = [
            i, i, p, p, p, p, p, p, p, st, i, i, i, i, i, i, f, f, p,
            ctypes.POINTER(i)]
        lib.decode_attention_launch.restype = i
        lib.decode_attention_scratch_bytes.argtypes = [i] * 8
        lib.decode_attention_scratch_bytes.restype = ctypes.c_longlong
        lib._argtypes_set = True
    return lib


def _launch(entry: str, q, k, v, lengths, scale: float, logit_cap: float,
            k_lo: Optional[int]):
    """Check, size scratch and launch the library's kernel: the whole call,
    or the partial entry when ``k_lo`` is given; returns (out, lse or
    None)."""
    if q.device.type != "cuda":
        raise ValueError(f"no decode attention kernel for device {q.device}")
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    attention_launch.check("decode attention", q, k, v,
                           g_rows=Hq // max(Hkv, 1))
    if (lengths.dtype != torch.int32 or lengths.device != q.device
            or tuple(lengths.shape) != (B,) or not lengths.is_contiguous()):
        raise ValueError(f"lengths must be a contiguous int32 ({B},) tensor "
                         f"on {q.device}")
    if scale == 0.0:
        scale = 1.0 / math.sqrt(D)
    out = torch.empty((B, T, Hq, D), dtype=q.dtype, device=q.device)
    lse = None if k_lo is None else torch.empty(
        (B, T, Hq), dtype=torch.float32, device=q.device)
    if B == 0 or T == 0:
        return out, lse
    st = attention_launch.strides(q, k, v, out)
    kernel = ctypes.c_int(-1)
    with torch.cuda.device(q.device):
        lib = _lib()
        dt = attention_launch.DTYPES[q.dtype]
        n = lib.decode_attention_scratch_bytes(dt, D, B, T, S, Hq, Hkv,
                                               int(k_lo is not None))
        scratch = torch.empty((n,), dtype=torch.uint8, device=q.device) \
            if n else None
        status = lib.decode_attention_launch(
            dt, D, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            lengths.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            scratch.data_ptr() if n else None, st, B, T, S, Hq, Hkv,
            int(k_lo or 0), float(scale), float(logit_cap),
            torch.cuda.current_stream().cuda_stream, ctypes.byref(kernel))
    build.check(status, entry)
    LAUNCHES[entry] += 1
    LAST_ROUTE[entry] = _ROUTES[kernel.value]
    ROUTE_LAUNCHES[LAST_ROUTE[entry], D] += 1
    return out, lse


def decode_attention(
    q: torch.Tensor,           # (B, T, Hq, D)
    k: torch.Tensor,           # (B, S, Hkv, D) cache including the fresh writes
    v: torch.Tensor,
    lengths: torch.Tensor,     # (B,) int32: queries sit at lengths + t
    *,
    scale: float = 0.0,
    logit_cap: float = 0.0,
) -> torch.Tensor:             # (B, T, Hq, D)
    """Causal decode/verify attention over the dense cache; the result is in
    q's dtype.  ``scale`` 0 means 1/sqrt(D); ``logit_cap`` > 0 softcaps the
    logits with tanh."""
    refuse_autograd("decode_attention", q, k, v)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, lengths, scale=scale,
                                      logit_cap=logit_cap)
    return _launch("decode_attention", q, k, v, lengths, scale, logit_cap,
                   None)[0]


def decode_attention_partial(
    q: torch.Tensor,           # (B, T, Hq, D)
    k: torch.Tensor,           # (B, n, Hkv, D): the keys at k_lo .. k_lo + n - 1
    v: torch.Tensor,
    lengths: torch.Tensor,     # (B,) int32: queries sit at lengths + t
    *,
    k_lo: int,
    scale: float = 0.0,
    logit_cap: float = 0.0,
):
    """The partial entry: causal decode/verify attention over one block of
    a cache split along its sequence (``ref.decode_attention_partial_plain``
    states it): the block's normalized output in q's dtype and the fp32
    log-sum-exp (B, T, Hq) of every row, -inf where the block holds no key
    the row sees.  The same three bodies as :func:`decode_attention`; the
    sm90 body writes every live split's partial to scratch and one merge
    kernel normalizes them and writes the log-sum-exp."""
    refuse_autograd("decode_attention_partial", q, k, v)
    if q.device.type == "cpu":
        return decode_attention_partial_plain(q, k, v, lengths, k_lo=k_lo,
                                              scale=scale,
                                              logit_cap=logit_cap)
    return _launch("decode_attention_partial", q, k, v, lengths, scale,
                   logit_cap, k_lo)
