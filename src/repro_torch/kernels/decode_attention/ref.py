"""Plain PyTorch versions of decode/verify attention.

Ports of ``repro.kernels.decode_attention.ref``: ``decode_attention_ref``
and ``paged_decode_attention_ref`` keep the reference oracles' (B, Hq, T, D)
layout; ``decode_attention_plain`` and ``paged_decode_attention_plain`` are
the (B, T, Hq, D) wrappers of ``repro.kernels.decode_attention.ops``.  The
plain paged version gathers ``pool[table]`` into the dense view and delegates to
the dense one, so trash or stale page contents are masked out of the
softmax, and their V rows zeroed before the P V product, as the kernels
zero them.

These are the CPU path of ``ops.decode_attention`` and
``paged.paged_decode_attention`` and the yardsticks their CUDA kernels are
held against on the card.

``split_plan``, ``split_chunks`` and ``row_tiles`` mirror the host planner,
the per-block key ranges and the row tiles of the split-KV bodies
(``kernels/csrc/splitkv_sm90.cuh``), and ``decode_attention_split_plain``
computes the dense attention split by split (and row tile by row tile) and
merges the partials as their combine kernel does; the CPU tests hold them
against the reference.  Nothing on the card's path calls them.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30
CHUNK = 64                 # keys of one chunk of the split-KV bodies (BK)
TILE_ROWS = 64             # query rows of one row tile (splitkv ROWS)
F32_TILE_ROWS = 32         # the same of the fp32 body (decode_f32 TILE_ROWS)
DENSE_MIN_CHUNKS = 8       # decode_sm90.cuh's MIN_CHUNKS
PAGED_MIN_CHUNKS = 4       # paged_sm90.cuh's MIN_CHUNKS


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
    # V rows past the newest query, length + T - 1, are zeroed as the CUDA
    # kernels zero them: a stale value there, even NaN, never enters the
    # result (a zero probability times NaN would)
    past = k_pos[..., 0, :, None] > q_pos[:, :, -1:, :]        # (B, 1, S, 1)
    out = torch.einsum("bhts,bhsd->bhtd", p, v.float().masked_fill(past, 0.0))
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


def decode_attention_partial_plain(
    q: torch.Tensor,           # (B, T, Hq, D)
    k: torch.Tensor,           # (B, n, Hkv, D): keys at positions k_lo + s
    v: torch.Tensor,
    lengths: torch.Tensor,     # (B,): queries sit at lengths + t
    *,
    k_lo: int,
    scale: float = 0.0,
    logit_cap: float = 0.0,
):
    """Decode/verify attention over ONE block of keys, the n positions
    [k_lo, k_lo + n) of a cache split along its sequence: the output
    normalized over the block's visible keys (q's dtype) and the fp32
    log-sum-exp of their scores (B, T, Hq).  A row that sees no key of
    the block gets 0 and -inf.  V rows past each row's newest query are
    zeroed, as in :func:`decode_attention_ref`.  The partials of every
    block merge into :func:`decode_attention_plain`'s result
    (``distributed/collectives.lse_combine``)."""
    B, T, Hq, D = q.shape
    n, Hkv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    if scale == 0.0:
        scale = 1.0 / math.sqrt(D)
    kk = k.float().repeat_interleave(g, dim=2)
    vv = v.float().repeat_interleave(g, dim=2)
    s = torch.einsum("bthd,bshd->bhts", q.float(), kk) * scale
    if logit_cap > 0:
        s = torch.tanh(s / logit_cap) * logit_cap
    dev = q.device
    q_pos = (lengths.to(torch.int64)[:, None, None, None]
             + torch.arange(T, device=dev)[None, None, :, None])
    k_pos = k_lo + torch.arange(n, device=dev)[None, None, None, :]
    s = s.masked_fill(k_pos > q_pos, float("-inf"))
    lse = torch.logsumexp(s, dim=-1)                          # (B, Hq, T)
    safe = torch.where(torch.isfinite(lse), lse, torch.zeros_like(lse))
    p = torch.exp(s - safe[..., None])
    past = (k_pos[..., 0, :, None] > q_pos[:, :, -1:, :])[:, 0]   # (B, n, 1)
    vv = vv.masked_fill(past[:, :, :, None], 0.0)
    out = torch.einsum("bhts,bshd->bthd", p, vv)
    return out.to(q.dtype), lse.transpose(1, 2).contiguous()


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


def split_plan(B: int, Hkv: int, n_keys: int, sm_count: int, *,
               min_chunks: int = DENSE_MIN_CHUNKS, waves: int = 1):
    """(chunks per split, splits) as ``splitkv::plan`` picks them on the
    host for rows of at most ``n_keys`` keys (S for the dense cache, MP * ps
    for the paged one): as many splits as fill ``waves`` blocks per SM over
    the B * Hkv (sequence, KV head) pairs, none shorter than ``min_chunks``
    chunks of ``CHUNK`` keys."""
    n_chunks = -(-n_keys // CHUNK)
    n = min(waves * sm_count // (B * Hkv), n_chunks // min_chunks)
    n = max(n, 1)
    cps = -(-n_chunks // n)
    return cps, -(-n_chunks // cps)


def split_chunks(length: int, T: int, limit: int, cps: int, splits: int):
    """Per split of one row, the (first key, chunks) its block loads, as the
    split-KV kernels compute them: split s starts at s * cps * CHUNK, and a
    split that starts past the row's last key min(length + T - 1, limit - 1)
    loads nothing (its block returns at once)."""
    last = min(length + T - 1, limit - 1)
    out = []
    for sp in range(splits):
        k0 = sp * cps * CHUNK
        out.append((k0, 0 if k0 > last else min(cps, (last - k0) // CHUNK + 1)))
    return out


def row_tiles(g: int, T: int, rows: int = TILE_ROWS):
    """(positions per tile tp, tiles n) as ``splitkv::row_tiles`` cuts a KV
    head's g * T query rows: as few tiles as hold at most ``rows`` rows each
    in whole query positions (one position a tile when g > ``rows``), the
    positions spread as evenly as whole tiles allow; tile j holds positions
    [j tp, min((j + 1) tp, T)), its row r position j tp + r // g of head
    r % g.  The TMA + wgmma body cuts at 64 rows, the fp32 body
    (``decode_f32.cuh``) at ``F32_TILE_ROWS``."""
    most = rows // g if rows >= g else 1
    n = -(-T // most)
    tp = -(-T // n)
    return tp, -(-T // tp)


def decode_attention_split_plain(
    q: torch.Tensor,           # (B, T, Hq, D)
    k: torch.Tensor,           # (B, S, Hkv, D)
    v: torch.Tensor,
    lengths: torch.Tensor,     # (B,)
    *,
    splits: int,
    tiled: bool = False,
    scale: float = 0.0,
    logit_cap: float = 0.0,
) -> torch.Tensor:             # (B, T, Hq, D)
    """:func:`decode_attention_plain` computed as the split-KV bodies do:
    the S keys cut into ``splits`` ranges of whole ``CHUNK``-key chunks
    (fewer when ``splits`` does not divide the chunks), each range's
    unnormalised accumulator O_s, row max m_s and sum l_s in fp32 with the
    scores in log2 units, then merged as the combine kernel merges them:
    out = sum_s 2^(m_s - M) O_s / sum_s 2^(m_s - M) l_s with M = max_s m_s,
    a range with no visible key (m_s = -inf) weighing 0.  With
    ``tiled`` the query positions are cut as :func:`row_tiles` cuts
    them and each (split, row tile) is a partial of its own, merged per
    row over the splits its tile sees (those that start at or before the
    tile's last query; the rest, whose keys it cannot see, are left out)."""
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    if scale == 0.0:
        scale = 1.0 / math.sqrt(D)
    n_chunks = -(-S // CHUNK)
    span = -(-n_chunks // splits) * CHUNK
    qf = q.float().transpose(1, 2)                              # (B, Hq, T, D)
    kf = k.float().transpose(1, 2).repeat_interleave(g, dim=1)  # (B, Hq, S, D)
    vf = v.float().transpose(1, 2).repeat_interleave(g, dim=1)
    s = torch.einsum("bhtd,bhsd->bhts", qf, kf) * scale
    if logit_cap > 0:
        s = torch.tanh(s / logit_cap) * logit_cap
    s = s * (1.0 / math.log(2.0))                               # log2 units
    q_pos = (lengths.to(torch.int64)[:, None, None, None]
             + torch.arange(T, device=q.device)[None, None, :, None])
    k_pos = torch.arange(S, device=q.device)[None, None, None, :]
    s = s.masked_fill(k_pos > q_pos, float("-inf"))
    tp, n_tiles = row_tiles(g, T) if tiled else (T, 1)
    outs = []
    for j in range(n_tiles):
        t0, t1 = j * tp, min((j + 1) * tp, T)
        # the splits this tile sees: those starting at or before the last
        # key of its last query, min(length + t1 - 1, S - 1), in any row
        last = (lengths.to(torch.int64) + t1 - 1).clamp(max=S - 1).amax()
        parts = []
        for lo in range(0, S, span):
            if lo > last:
                break
            x = s[:, :, t0:t1, lo:lo + span]
            m = x.amax(-1, keepdim=True)
            p = torch.exp2(x - torch.where(m == float("-inf"), 0.0, m))
            parts.append((m, p.sum(-1, keepdim=True),
                          p @ vf[:, :, lo:lo + span]))
        top = torch.stack([m for m, _, _ in parts]).amax(0)
        num = torch.zeros_like(parts[0][2])
        den = torch.zeros_like(parts[0][1])
        for m, l, o in parts:
            w = torch.where(m == float("-inf"), 0.0, torch.exp2(m - top))
            num = num + w * o
            den = den + w * l
        outs.append(num / den.clamp_min(1e-30))
    out = torch.cat(outs, dim=2)
    return out.to(q.dtype).transpose(1, 2)
