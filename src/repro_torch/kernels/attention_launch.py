"""Checks and launch arguments shared by the wrappers of the two kernels
built on ``csrc/attention_tile.cuh`` (flash prefill and dense decode/verify).

Both kernels read q, k, v and write out in place through element strides, so
a wrapper hands them the model's (B, T, H, D) tensors, a (B, H, T, D) view
or a slice of the (B, S+1, Hkv, D) cache without copying.
"""
from __future__ import annotations

import ctypes

import torch

DTYPES = {torch.bfloat16: 0, torch.float32: 1}
HEAD_DIMS = (32, 64, 128)
MAX_ROWS = 64                  # query rows of one block


def check(what: str, q, k, v, *, g_rows: int) -> None:
    """Raise unless the kernel takes these (B, T, H, D)-indexed views: one
    dtype and device, a head dim it is built for, a contiguous head dim,
    16-byte aligned rows, and at most ``MAX_ROWS`` heads folded per block."""
    if q.dtype not in DTYPES:
        raise TypeError(f"{what} takes bf16 or fp32, got {q.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{what}: q, k, v must be 4-d")
    B, _, Hq, D = q.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"{what}: the kernel is built for head dims "
                         f"{HEAD_DIMS}, got {D}")
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"{what}: k {tuple(k.shape)}, v {tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)}")
    Hkv = k.shape[2]
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"{what}: {Hq} query heads do not group over {Hkv} "
                         "KV heads")
    if g_rows > MAX_ROWS:
        raise ValueError(f"{what}: {g_rows} query heads per block exceed the "
                         f"kernel's {MAX_ROWS} rows")
    vec = 16 // q.element_size()
    for t in (q, k, v):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{what}: q, k and v must share device and dtype")
        if (t.stride(3) != 1 or any(s % vec for s in t.stride()[:3])
                or t.data_ptr() % 16):
            raise ValueError(f"{what}: the kernel needs a contiguous head dim "
                             "and 16-byte aligned rows")


def strides(q, k, v, out):
    """The 12 element strides the kernels take: q, k, v, out as
    (batch, position, head), each tensor indexed (B, T, H, D)."""
    vals = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    return (ctypes.c_longlong * 12)(*vals)
