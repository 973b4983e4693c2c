"""Plain PyTorch version of flash attention.

Port of ``repro.kernels.flash_attention.ref``: ``flash_attention_ref`` keeps
the reference oracle's (B, Hq, T, D) layout; ``flash_attention_plain`` is the
(B, T, Hq, D) layout of ``ops.flash_attention``.  Causal masking is by index
(query t sees keys s <= t), as in the kernel.

These are the CPU path of the wrappers in ``flash_attention.py`` and
``ops.py`` and the yardstick the CUDA kernel is held against on the card.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def flash_attention_ref(
    q: torch.Tensor,           # (B, Hq, T, D)
    k: torch.Tensor,           # (B, Hkv, S, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    scale: float = 0.0,
    logit_cap: float = 0.0,
) -> torch.Tensor:
    B, Hq, T, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    g = Hq // Hkv
    if scale == 0.0:
        scale = 1.0 / math.sqrt(D)
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    s = torch.einsum("bhtd,bhsd->bhts", q.float(), k.float()) * scale
    if logit_cap > 0:
        s = torch.tanh(s / logit_cap) * logit_cap
    if causal:
        q_pos = torch.arange(T, device=q.device)[:, None]
        k_pos = torch.arange(S, device=q.device)[None, :]
        mask = k_pos <= q_pos
        if window > 0:
            mask = mask & (k_pos > q_pos - window)
        s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhts,bhsd->bhtd", p, v.float())
    return out.to(q.dtype)


def flash_attention_plain(
    q: torch.Tensor,           # (B, T, Hq, D)
    k: torch.Tensor,           # (B, S, Hkv, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    scale: float = 0.0,
    logit_cap: float = 0.0,
) -> torch.Tensor:             # (B, T, Hq, D)
    """(B, T, H, D) layout, as the model and the kernel's ops wrapper take it."""
    out = flash_attention_ref(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=causal,
        window=window, scale=scale, logit_cap=logit_cap)
    return out.transpose(1, 2)
