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
would sync.  ``LAUNCHES`` counts kernel launches.  The paged wrapper of the
same reference module is ``paged.paged_decode_attention``.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from repro_torch.kernels import attention_launch, build
from repro_torch.kernels.decode_attention.ref import decode_attention_plain

SOURCE = Path(__file__).resolve().parent / "csrc" / "decode_attention.cu"

# kernel launches since the last reset
LAUNCHES = {"decode_attention": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    if not getattr(lib, "_argtypes_set", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        st = ctypes.POINTER(ctypes.c_longlong)
        lib.decode_attention_launch.argtypes = [
            i, i, p, p, p, p, p, st, i, i, i, i, i, f, f, p]
        lib.decode_attention_launch.restype = i
        lib._argtypes_set = True
    return lib


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
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, lengths, scale=scale,
                                      logit_cap=logit_cap)
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
    if B == 0 or T == 0:
        return out
    st = attention_launch.strides(q, k, v, out)
    with torch.cuda.device(q.device):
        status = _lib().decode_attention_launch(
            attention_launch.DTYPES[q.dtype], D, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), lengths.data_ptr(), out.data_ptr(), st, B, T, S, Hq,
            Hkv, float(scale), float(logit_cap),
            torch.cuda.current_stream().cuda_stream)
    build.check(status, "decode_attention")
    LAUNCHES["decode_attention"] += 1
    return out
