"""Plain PyTorch versions of decode/verify attention.

Ports of ``repro.kernels.decode_attention.ref``: ``decode_attention_ref``
and ``paged_decode_attention_ref`` keep the reference oracles' (B, Hq, T, D)
layout; ``decode_attention_plain`` and ``paged_decode_attention_plain`` are
the (B, T, Hq, D) wrappers of ``repro.kernels.decode_attention.ops``.  The
plain paged version gathers ``pool[table]`` into the dense view and delegates to
the dense one, so trash or stale page contents are masked, never read into
the softmax.

These are the CPU path of ``ops.decode_attention`` and
``paged.paged_decode_attention`` and the yardsticks their CUDA kernels are
held against on the card.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def decode_attention_ref(
    q: torch.Tensor,           # (B, Hq, T, D)
    k: torch.Tensor,           # (B, Hkv, S, D)
    v: torch.Tensor,
    lengths: torch.Tensor,     # (B,)
    *,
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
    dev = q.device
    q_pos = (lengths.to(torch.int64)[:, None, None, None]
             + torch.arange(T, device=dev)[None, None, :, None])
    k_pos = torch.arange(S, device=dev)[None, None, None, :]
    s = s.masked_fill(k_pos > q_pos, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhts,bhsd->bhtd", p, v.float())
    return out.to(q.dtype)


def decode_attention_plain(
    q: torch.Tensor,           # (B, T, Hq, D)
    k: torch.Tensor,           # (B, S, Hkv, D)
    v: torch.Tensor,
    lengths: torch.Tensor,     # (B,)
    *,
    scale: float = 0.0,
    logit_cap: float = 0.0,
) -> torch.Tensor:             # (B, T, Hq, D)
    """(B, T, Hq, D) layout, as the kernel and the model take it."""
    out = decode_attention_ref(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), lengths,
        scale=scale, logit_cap=logit_cap)
    return out.transpose(1, 2)


def paged_view(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """The dense (B, MP*ps, ...) view of a (NP, ps, ...) pool through the
    block table (B, MP): logical position p of row b is
    ``pool[table[b, p // ps], p % ps]``."""
    B, MP = table.shape
    g = pool[table.to(torch.int64)]                       # (B, MP, ps, ...)
    return g.reshape((B, MP * pool.shape[1]) + pool.shape[2:])


def paged_decode_attention_ref(
    q: torch.Tensor,           # (B, Hq, T, D)
    k_pages: torch.Tensor,     # (NP, ps, Hkv, D) physical page pool
    v_pages: torch.Tensor,
    lengths: torch.Tensor,     # (B,)
    table: torch.Tensor,       # (B, MP) logical page -> physical page
    *,
    scale: float = 0.0,
    logit_cap: float = 0.0,
) -> torch.Tensor:
    """Gather ``pool[table]`` into the dense view, then
    :func:`decode_attention_ref`.  Logical positions beyond
    ``length + T - 1`` are masked there."""
    return decode_attention_ref(
        q, paged_view(k_pages, table).transpose(1, 2),
        paged_view(v_pages, table).transpose(1, 2), lengths, scale=scale,
        logit_cap=logit_cap)


def paged_decode_attention_plain(
    q: torch.Tensor,           # (B, T, Hq, D)
    k_pages: torch.Tensor,     # (NP, ps, Hkv, D)
    v_pages: torch.Tensor,
    lengths: torch.Tensor,     # (B,)
    table: torch.Tensor,       # (B, MP)
    *,
    scale: float = 0.0,
    logit_cap: float = 0.0,
) -> torch.Tensor:             # (B, T, Hq, D)
    """(B, T, Hq, D) layout, as the kernel and the model take it."""
    out = paged_decode_attention_ref(
        q.transpose(1, 2), k_pages, v_pages, lengths, table, scale=scale,
        logit_cap=logit_cap)
    return out.transpose(1, 2)
