"""Flash attention in the (B, T, H, D) layout the model uses.

Port of ``repro.kernels.flash_attention.ops.flash_attention``.  The reference
transposes to (B, H, T, D) before its kernel; the port's kernel reads the
(B, T, H, D) tensors in place through their strides, so nothing is copied.
CPU tensors take the plain version; CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.flash_attention import (
    check_blocks, flash_attention_btd)
from repro_torch.kernels.flash_attention.ref import flash_attention_plain


def flash_attention(
    q: torch.Tensor,           # (B, T, Hq, D)
    k: torch.Tensor,           # (B, S, Hkv, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    scale: float = 0.0,
    logit_cap: float = 0.0,
) -> torch.Tensor:             # (B, T, Hq, D)
    check_blocks(q.shape[1], k.shape[1])
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale, logit_cap=logit_cap)
    if q.device.type != "cuda":
        raise ValueError(f"no flash attention kernel for device {q.device}")
    return flash_attention_btd(q, k, v, causal=causal, window=window,
                               scale=scale, logit_cap=logit_cap)
