"""Attention blocks: GQA ("attn"), sliding window ("swa"), multi-head
latent attention ("mla") and cross-attention (whisper's decoder over its
encoder's output).

Port of ``repro.models.attention``.  Two execution modes share one code path:
  * ``prefill`` — over the prompt (or, cacheless and with ``causal=False``,
                  an encoder's frames), writes the KV cache from pos 0.
  * ``extend``  — T new tokens (T=1 → plain decode, T=γ+1 → SD verify)
                  appended at per-sequence offsets against a populated
                  cache.

Caches, for a logical capacity of S positions::

    full attention   {"k": (B, S+1, Hkv, D), "v": ...}
    sliding window   {"k": (B, W, Hkv, D), "v": ..., "pos": (B, W) int32}
                     ring buffer, slot = position % W, ``pos`` starts at -1,
                     W = min(sliding_window + SWA_RING_PAD, S)
    MLA              {"latent": (B, S+1, r_kv), "k_rope": (B, S+1, Dr)}

Slot S of a full-attention or MLA cache is a trash slot: the reference's
scatter drops writes past S (a row that ran ahead of its wave), and
PyTorch's would fault, so such writes are clamped onto slot S, which
attention never reads.  A ring needs none: its slots are taken modulo W.

RoPE is applied at write time for K (absolute positions), query side at read
time, so cached K never needs re-rotation.

Paged cache (``make_attn_cache(..., paged=True)``): ``{"k_pages": (NP, ps,
Hkv, D), "v_pages": ...}`` (MLA: ``{"latent_pages": (NP, ps, r_kv),
"k_rope_pages": (NP, ps, Dr)}``), a physical page pool shared by all rows and
addressed through the model-level block table (B, MP); SWA rings are bounded
per row already and stay dense.  Page 0 is the
trash page unallocated and retired rows point at.  Decode/verify extends
(causal, T <= 8) attend straight from the pool through the CUDA kernel of
``kernels/decode_attention``; wider extends attend over the dense
``pool[table]`` view.  ``paged_attention="gather"`` sends decode/verify
extends to that view too, as a CPU cross-check of the kernel path; on CUDA
tensors it raises, so the card's paged verify always runs the kernel.

Dense attention stays explicit matmul + softmax in fp32, as in the
reference.  ``use_flash`` selects the reference's two kernel branches: a
causal prefill of T >= 128 tokens runs the flash kernel
(``kernels/flash_attention``), and an extend against a dense cache of
logical capacity S >= 512 with no logit cap runs the dense decode/verify
kernel (``kernels/decode_attention/ops.py``), which reads the cache in place
and never its trash slot.  A sliding window goes to the flash kernel and the
chunked and masked paths; the decode kernel takes no window, so ring extends
attend by mask as in the reference.  MLA calls no kernel in the reference and
none here: it is explicit matmul + softmax over the expanded latent.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.distributed import collectives as col
from repro_torch.kernels.decode_attention.ops import (decode_attention,
                                                      decode_attention_partial)
from repro_torch.kernels.decode_attention.paged import paged_decode_attention
from repro_torch.kernels.decode_attention.ref import paged_view
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.layers import (apply_mrope, apply_rope, dense_init,
                                      softcap)

NEG_INF = -1e30

# decode/verify widths up to this many queries take the paged kernel; wider
# extends (a verify of gamma 8 and up) attend over the gathered view, as in
# the reference (src/repro/models/attention.py, T <= 8)
PAGED_KERNEL_MAX_T = 8
# slots a sliding-window ring keeps beyond its window, as in the reference,
# so a batched extend of T <= SWA_RING_PAD + 1 tokens (an SD verify writes
# gamma + 1 before any attends) never evicts an entry still inside an
# earlier query's window
SWA_RING_PAD = 8
GATHER_ON_CUDA = ("paged_attention='gather' is a CPU cross-check of the "
                  "paged kernel path; on a CUDA device paged decode/verify "
                  "runs the kernel (paged_attention='kernel')")


# ---------------------------------------------------------------------------
# init / cache
# ---------------------------------------------------------------------------

def init_gqa(cfg, dtype, *, generator, device) -> dict:
    d, hd = cfg.d_model, cfg.head_dim
    kw = dict(generator=generator, device=device)
    p = {
        "wq": dense_init((d, cfg.num_heads * hd), dtype, **kw),
        "wk": dense_init((d, cfg.num_kv_heads * hd), dtype, **kw),
        "wv": dense_init((d, cfg.num_kv_heads * hd), dtype, **kw),
        "wo": dense_init((cfg.num_heads * hd, d), dtype, **kw),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", cfg.num_heads), ("bk", cfg.num_kv_heads),
                            ("bv", cfg.num_kv_heads)):
            p[name] = torch.zeros((width * hd,), dtype=dtype, device=device)
    return p


def init_mla(cfg, dtype, *, generator, device) -> dict:
    d = cfg.d_model
    r_kv, r_q = cfg.mla_kv_lora_rank, cfg.mla_q_lora_rank
    dn, dr, dv = cfg.mla_qk_nope_dim, cfg.mla_qk_rope_dim, cfg.mla_v_head_dim
    H = cfg.num_heads
    kw = dict(generator=generator, device=device)
    p = {
        "w_dkv": dense_init((d, r_kv + dr), dtype, **kw),     # latent + k_rope
        "w_uk": dense_init((r_kv, H * dn), dtype, **kw),
        "w_uv": dense_init((r_kv, H * dv), dtype, **kw),
        "wo": dense_init((H * dv, d), dtype, **kw),
        "kv_norm": torch.ones((r_kv,), dtype=dtype, device=device),
    }
    if r_q > 0:
        p["w_dq"] = dense_init((d, r_q), dtype, **kw)
        p["w_uq"] = dense_init((r_q, H * (dn + dr)), dtype, **kw)
        p["q_norm"] = torch.ones((r_q,), dtype=dtype, device=device)
    else:
        p["wq"] = dense_init((d, H * (dn + dr)), dtype, **kw)
    return p


def init_cross_attn(cfg, dtype, *, generator, device) -> dict:
    return init_gqa(cfg, dtype, generator=generator, device=device)


def make_attn_cache(cfg, batch: int, max_seq: int, kind: str, dtype, device,
                    *, paged: bool = False, page_size: int = 64,
                    pool_pages: Optional[int] = None) -> dict:
    """Per-layer decode cache: dense with one trailing trash slot, or a
    physical page pool (``pool_pages`` pages of ``page_size`` positions;
    default: every row at ``max_seq`` plus the trash page).  A ``"swa"``
    ring is dense either way."""
    if kind not in ("attn", "swa", "mla"):
        raise NotImplementedError(
            f"block kind {kind!r} has no KV cache; its recurrent state is "
            "models/ssm.py's")
    zeros = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)
    hkv, hd = cfg.num_kv_heads, cfg.head_dim
    if kind == "swa":
        w = min(cfg.sliding_window + SWA_RING_PAD, max_seq)
        return {"k": zeros(batch, w, hkv, hd), "v": zeros(batch, w, hkv, hd),
                "pos": torch.full((batch, w), -1, dtype=torch.int32,
                                  device=device)}
    if paged:
        npg = (batch * (-(-max_seq // page_size)) + 1
               if pool_pages is None else pool_pages)
        if kind == "mla":
            return {"latent_pages": zeros(npg, page_size, cfg.mla_kv_lora_rank),
                    "k_rope_pages": zeros(npg, page_size, cfg.mla_qk_rope_dim)}
        return {"k_pages": zeros(npg, page_size, hkv, hd),
                "v_pages": zeros(npg, page_size, hkv, hd)}
    if kind == "mla":
        return {"latent": zeros(batch, max_seq + 1, cfg.mla_kv_lora_rank),
                "k_rope": zeros(batch, max_seq + 1, cfg.mla_qk_rope_dim)}
    return {"k": zeros(batch, max_seq + 1, hkv, hd),
            "v": zeros(batch, max_seq + 1, hkv, hd)}


def _write(cache: dict, positions: torch.Tensor, lo: int = 0,
           n: Optional[int] = None, **vals) -> None:
    """Write each ``vals`` leaf at (B, T) positions of a dense cache in place
    (saves copying the whole cache per token, which the reference's
    functional update does).  The cache holds the positions [lo, lo + n)
    (a block of a cache split along its sequence; by default all of them)
    and a trash slot n past them, where every other position lands."""
    bidx = torch.arange(positions.shape[0], device=positions.device)[:, None]
    for name, val in vals.items():
        size = cache[name].shape[1] - 1 if n is None else n
        slot = positions - lo
        slot = torch.where((slot >= 0) & (slot < size), slot,
                           torch.full_like(slot, size))
        cache[name][bidx, slot] = val


def _ring_write(cache: dict, positions: torch.Tensor, k, v) -> None:
    """Write K/V and their positions into a sliding-window ring in place,
    slot = position % W."""
    w = cache["k"].shape[1]
    bidx = torch.arange(positions.shape[0], device=positions.device)[:, None]
    slots = positions % w
    cache["k"][bidx, slots] = k
    cache["v"][bidx, slots] = v
    cache["pos"][bidx, slots] = positions.to(torch.int32)


def _pool_write(cache: dict, table: torch.Tensor, positions: torch.Tensor,
                shard, **vals) -> None:
    """:func:`_paged_write` of each ``vals`` leaf.  A page pool is whole on
    every rank of ``"data"`` while the rows in flight are the rank's only
    (a batch split over ``"data"``): every rank writes every row, so the
    pools stay equal and a page a row shares with another rank's row holds
    what that row wrote."""
    if shard is not None and "data" in shard.batch_axes:
        rows = lambda t: col.gather(t, 0, shard, "data")
        table, positions = rows(table), rows(positions)
        vals = {k: rows(v) for k, v in vals.items()}
    for name, val in vals.items():
        _paged_write(cache[name], table, positions, val)


def _paged_write(pool: torch.Tensor, table: torch.Tensor,
                 positions: torch.Tensor, vals: torch.Tensor) -> None:
    """Scatter per-row values at logical ``positions`` (B, T) into the
    physical pool (NP, ps, ...) through the block table (B, MP), in place.
    Unallocated positions resolve to the trash page.  The logical page index
    is clamped to MP-1, as the reference's gather clamps it; an index past
    the table would fault here."""
    ps = pool.shape[1]
    bidx = torch.arange(positions.shape[0], device=positions.device)[:, None]
    lp = (positions // ps).clamp(max=table.shape[1] - 1)
    pid = table[bidx, lp].to(torch.int64)                    # (B, T)
    pool[pid, positions % ps] = vals


# ---------------------------------------------------------------------------
# core scaled-dot-product with GQA grouping
# ---------------------------------------------------------------------------

def _sdpa(q, k, v, mask, scale, logit_cap: float = 0.0, lse: bool = False):
    """q: (B,T,Hq,D)  k/v: (B,S,Hkv,D)  mask: (B,1,T,S) bool → (B,T,Hq,Dv).
    With ``lse``, also the fp32 log-sum-exp of each row's scores (B,T,Hq),
    a row with no visible key giving 0 and -inf: the partial over one key
    block that ``collectives.lse_combine`` merges."""
    B, T, Hq, D = q.shape
    Hkv = k.shape[2]
    g = Hq // Hkv
    qg = q.reshape(B, T, Hkv, g, D)
    logits = torch.einsum("btkgd,bskd->bkgts", qg.float(), k.float()) * scale
    if logit_cap > 0:
        logits = softcap(logits, logit_cap)
    # masked_fill takes the scalar as a kernel argument; a device tensor
    # made from it would be a host-to-device copy (a sync) per layer
    logits = logits.masked_fill(~mask[:, :, None, :, :],
                                float("-inf") if lse else NEG_INF)
    if lse:
        row = torch.logsumexp(logits, dim=-1)                  # (B,Hkv,g,T)
        safe = torch.where(torch.isfinite(row), row, torch.zeros_like(row))
        probs = torch.exp(logits - safe[..., None])
    else:
        probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgts,bskd->btkgd", probs, v.float())
    out = out.reshape(B, T, Hq, v.shape[-1]).to(q.dtype)
    if not lse:
        return out
    return out, row.permute(0, 3, 1, 2).reshape(B, T, Hq)


def _chunk_scores(qg, k_t, p_t, q_pos, scale, logit_cap, causal, window):
    """Masked, softcapped fp32 scores (B, Hkv, g, T, C) of one key chunk."""
    B, T = q_pos.shape
    s = torch.einsum("btkgd,bckd->bkgtc", qg, k_t) * scale
    if logit_cap > 0:
        s = softcap(s, logit_cap)
    valid = p_t[:, None, :] >= 0
    if causal:
        valid = valid & (p_t[:, None, :] <= q_pos[:, :, None])
        if window > 0:
            valid = valid & (p_t[:, None, :] > q_pos[:, :, None] - window)
    else:
        valid = valid.expand(B, T, p_t.shape[-1])
    return s.masked_fill(~valid[:, None, None], NEG_INF)


def _chunked_fwd(q, k, v, q_pos, k_pos, scale, window, logit_cap, chunk,
                 causal):
    """Online softmax over key chunks: (out (B,T,Hq,Dv) in q's dtype, the
    running max m and sum l (B,Hkv,g,T), fp32)."""
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    g = Hq // Hkv
    qg = q.reshape(B, T, Hkv, g, D).float()
    m = torch.full((B, Hkv, g, T), NEG_INF, device=q.device)
    l = torch.zeros((B, Hkv, g, T), device=q.device)
    acc = torch.zeros((B, Hkv, g, T, Dv), device=q.device)
    for s0 in range(0, S, chunk):
        v_t = v[:, s0:s0 + chunk].float()
        s = _chunk_scores(qg, k[:, s0:s0 + chunk].float(),
                          k_pos[:, s0:s0 + chunk], q_pos, scale, logit_cap,
                          causal, window)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bkgtc,bckd->bkgtd", p, v_t)
        m = m_new
    out = acc / l.clamp(min=1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(B, T, Hq, Dv).to(q.dtype)
    return out, m, l


class _ChunkedSDPA(torch.autograd.Function):
    """The reference's ``custom_vjp`` (``_make_chunked``): the backward
    saves only (q, k, v, positions, out, m, l), never a chunk's scores, and
    recomputes each chunk's probabilities from m and l."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, k_pos, scale, window, logit_cap, chunk,
                causal):
        out, m, l = _chunked_fwd(q, k, v, q_pos, k_pos, scale, window,
                                 logit_cap, chunk, causal)
        ctx.save_for_backward(q, k, v, q_pos, k_pos, out, m, l)
        ctx.args = (scale, window, logit_cap, chunk, causal)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, q_pos, k_pos, out, m, l = ctx.saved_tensors
        scale, window, logit_cap, chunk, causal = ctx.args
        B, T, Hq, D = q.shape
        S, Hkv = k.shape[1], k.shape[2]
        Dv = v.shape[-1]
        g = Hq // Hkv
        qg = q.reshape(B, T, Hkv, g, D).float()
        do = dout.reshape(B, T, Hkv, g, Dv).permute(0, 2, 3, 1, 4).float()
        og = out.reshape(B, T, Hkv, g, Dv).permute(0, 2, 3, 1, 4).float()
        l_safe = l.clamp(min=1e-30)
        drow = (do * og).sum(-1)                            # (B,Hkv,g,T)
        dq = torch.zeros((B, T, Hkv, g, D), device=q.device)
        dk = torch.empty((B, S, Hkv, D), dtype=k.dtype, device=k.device)
        dv = torch.empty((B, S, Hkv, Dv), dtype=v.dtype, device=v.device)
        for s0 in range(0, S, chunk):
            k_t = k[:, s0:s0 + chunk].float()
            v_t = v[:, s0:s0 + chunk].float()
            s = _chunk_scores(qg, k_t, k_pos[:, s0:s0 + chunk], q_pos, scale,
                              logit_cap, causal, window)
            p = torch.exp(s - m[..., None]) / l_safe[..., None]
            dp = torch.einsum("bkgtd,bckd->bkgtc", do, v_t)
            ds = p * (dp - drow[..., None])
            if logit_cap > 0:   # d softcap: 1 - tanh^2 of the raw scores
                raw = torch.einsum("btkgd,bckd->bkgtc", qg, k_t) * scale
                ds = ds * (1.0 - torch.square(torch.tanh(raw / logit_cap)))
            dq += torch.einsum("bkgtc,bckd->btkgd", ds, k_t) * scale
            dk[:, s0:s0 + chunk] = torch.einsum("bkgtc,btkgd->bckd", ds,
                                                qg) * scale
            dv[:, s0:s0 + chunk] = torch.einsum("bkgtc,bkgtd->bckd", p, do)
        return (dq.reshape(B, T, Hq, D).to(q.dtype), dk, dv,
                None, None, None, None, None, None, None)


def chunked_sdpa(q, k, v, q_pos, k_pos, *, scale: float, window: int = 0,
                 logit_cap: float = 0.0, chunk: int = 1024,
                 causal: bool = True):
    """Online-softmax attention over key chunks with the reference's
    flash-style recompute backward; neither pass builds the (T, S) score
    matrix.  q: (B,T,Hq,D), k/v: (B,S,Hkv,D), q_pos: (B,T), k_pos: (B,S).
    Invalid slots carry k_pos < 0."""
    return _ChunkedSDPA.apply(q, k, v, q_pos, k_pos, scale, window,
                              logit_cap, chunk, causal)


def _causal_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, window: int = 0):
    """q_pos: (B,T), k_pos: (B,S) → (B,1,T,S).  k visible iff k_pos <= q_pos
    (and within the window when window > 0) and k_pos >= 0 (valid slot)."""
    m = (k_pos[:, None, :] <= q_pos[:, :, None]) & (k_pos[:, None, :] >= 0)
    if window > 0:
        m = m & (k_pos[:, None, :] > q_pos[:, :, None] - window)
    return m[:, None, :, :]


# ---------------------------------------------------------------------------
# GQA forward
# ---------------------------------------------------------------------------

def _blocked(shard, name: str) -> bool:
    return shard is not None and shard.blocked(name)


def _cols(x, xf, params, w: str, b: str, lo: int, hi: int, shard):
    """``x @ params[w][:, lo:hi] (+ params[b][lo:hi])`` for a projection
    that is whole or this rank's ``"model"`` block (``shard``'s placement;
    ``xf`` is ``x`` after *f*): a block computes on its own columns only
    when they are exactly [lo, hi); otherwise it is gathered first."""
    wt, bt = params[w], params.get(b)
    if _blocked(shard, w):
        n = wt.shape[-1]
        if (shard.j * n, shard.j * n + n) == (lo, hi):
            y = xf @ wt
            return y if bt is None else y + bt
        wt = col.gather(wt, 1, shard)
    if bt is not None and _blocked(shard, b):
        bt = col.gather(bt, 0, shard)
    y = x @ wt[:, lo:hi]
    return y if bt is None else y + bt[lo:hi]


def _rows_out(o: torch.Tensor, wo: torch.Tensor, lo: int, hi: int,
              width: int, shard) -> torch.Tensor:
    """The output projection of an attention output ``o`` (B, T, hi - lo)
    that holds flattened head columns [lo, hi) of ``width``: ``wo`` whole,
    or this rank's block of its rows (``shard``'s placement) and then *g*.
    With a block, the heads computed are the block's or all of them (then
    split to the block's columns first); with a whole ``wo`` and a rank's
    heads, the product is a partial sum and *g* adds the ranks' up."""
    if _blocked(shard, "wo"):
        n = wo.shape[0]
        rlo = shard.j * n
        if (lo, hi) != (rlo, rlo + n):
            o = col.split(o, -1, shard)
        return col.reduce_from(o @ wo, shard)
    if (lo, hi) == (0, width):
        return o @ wo
    return col.reduce_from(o @ wo[lo:hi], shard)


def _project_qkv(params, cfg, x, heads=None, kv_heads=None, shard=None):
    """q, k, v (B, T, heads, hd) of the query heads ``heads`` and KV heads
    ``kv_heads`` ((lo, hi); all by default) from whole or ``"model"``-block
    projections."""
    hd = cfg.head_dim
    B, T, _ = x.shape
    H, Hkv = cfg.num_heads, cfg.num_kv_heads
    hq = heads or (0, H)
    hk = kv_heads or (0, Hkv)
    xf = col.copy_to(x, shard) if shard is not None else x

    def proj(w, bias, h):
        return _cols(x, xf, params, w, bias, h[0] * hd, h[1] * hd, shard)

    q = proj("wq", "bq", hq)
    k = proj("wk", "bk", hk)
    v = proj("wv", "bv", hk)
    return (q.reshape(B, T, hq[1] - hq[0], hd),
            k.reshape(B, T, hk[1] - hk[0], hd),
            v.reshape(B, T, hk[1] - hk[0], hd))


def _rotate(cfg, q, k, positions, mrope_positions=None):
    if cfg.rope_type == "mrope":
        if mrope_positions is None:  # text only: all three components equal
            mrope_positions = positions[..., None].expand(
                positions.shape + (3,))
        return (apply_mrope(q, mrope_positions, cfg.rope_theta,
                            cfg.mrope_sections),
                apply_mrope(k, mrope_positions, cfg.rope_theta,
                            cfg.mrope_sections))
    if cfg.rope_type == "rope":
        return (apply_rope(q, positions, cfg.rope_theta),
                apply_rope(k, positions, cfg.rope_theta))
    # "none", "learned", "sinusoidal": positions (if any) enter at the
    # embedding (Model._embed), as in the reference
    return q, k


def _ring_write_block(cache: dict, positions: torch.Tensor, k, v, lo: int,
                      w: int) -> None:
    """:func:`_ring_write` into a block of ring slots [lo, lo + n) of a
    ring of ``w`` slots: the positions whose slot it holds land there,
    the others nowhere (a ring block has no trash slot).  ``pos`` is
    whole on every rank and takes every write."""
    B, T = positions.shape
    n = cache["k"].shape[1]
    bidx = torch.arange(B, device=positions.device)[:, None]
    slots = positions % w
    local = slots - lo
    ok = (local >= 0) & (local < n)
    idx = torch.where(ok, local, torch.zeros_like(local))
    # the T slots of one write are distinct (T <= w): add each kept value
    # onto zeros once, and take the slots that were hit
    hit = torch.zeros((B, n), dtype=torch.int32, device=positions.device)
    hit.index_put_((bidx.expand(B, T), idx), ok.to(torch.int32),
                   accumulate=True)
    for name, val in (("k", k), ("v", v)):
        acc = torch.zeros_like(cache[name])
        acc.index_put_((bidx.expand(B, T), idx),
                       torch.where(ok[..., None, None], val,
                                   torch.zeros_like(val)), accumulate=True)
        cache[name].copy_(torch.where(hit[..., None, None] > 0, acc,
                                      cache[name]))
    cache["pos"][bidx, slots] = positions.to(torch.int32)


def _kv_layout(cfg, kind, cache, shard):
    """How this rank holds a GQA layer under a mesh (``shard``'s params and
    cache placement): (query heads, KV heads, sequence block).  Heads are
    (lo, hi), None for all; the block is (first slot, slots), None for the
    whole sequence.

    A cache whose KV heads are split over ``"model"`` gives the rank its
    heads; a cacheless pass takes them when the KV heads divide and the
    projections are blocks.  A cache split along its sequence (a ring
    along its slots) and a whole cache give every head, computed on every
    rank."""
    H, Hkv = cfg.num_heads, cfg.num_kv_heads
    if shard is None:
        return None, None, None
    m, j = shard.m, shard.j
    block = None
    if cache is None:
        local = Hkv % m == 0 and shard.blocked("wq")
    else:
        split = shard.cache_split("k_pages" if "k_pages" in cache else "k")
        local = split == 2                     # (B or pages, S, Hkv, hd)
        if split == 1:
            # a ring has no trash slot; a dense cache keeps its own
            n = cache["k"].shape[1] - (0 if kind == "swa" else 1)
            block = (j * n, n)
    if not local:
        return None, None, block
    return ((j * H // m, (j + 1) * H // m),
            (j * Hkv // m, (j + 1) * Hkv // m), None)


def gqa_forward(
    params: dict,
    cfg,
    x: torch.Tensor,                 # (B, T, d)
    positions: torch.Tensor,         # (B, T) absolute positions
    *,
    kind: str = "attn",              # "attn" | "swa"
    cache: Optional[dict] = None,
    mode: str = "prefill",           # prefill | extend
    mrope_positions: Optional[torch.Tensor] = None,
    use_flash: bool = False,
    causal: bool = True,
    page_table: Optional[torch.Tensor] = None,
    paged_attention: str = "kernel",
    shard=None,
) -> Tuple[torch.Tensor, Optional[dict]]:
    """GQA over this rank's part under a mesh (``shard``,
    ``distributed/collectives.Shard``, scoped to the mixer): its query and
    KV heads, with the output projection's rows and *g*, when the cache
    splits the KV heads over ``"model"``; every head otherwise, and over a
    cache split along its sequence each rank attends over its own block
    and the partials are merged by their log-sum-exp."""
    if kind not in ("attn", "swa"):
        raise NotImplementedError(
            f"block kind {kind!r} is not a GQA kind; recurrent mixers are "
            "models/ssm.py's")
    if mode not in ("prefill", "extend"):
        raise ValueError(f"mode must be 'prefill' or 'extend', got {mode!r}")
    B, T, _ = x.shape
    H, hd = cfg.num_heads, cfg.head_dim
    window = cfg.sliding_window if kind == "swa" else 0
    scale = 1.0 / math.sqrt(hd)
    heads, kv_heads, block = _kv_layout(cfg, kind, cache, shard)
    q, k, v = _project_qkv(params, cfg, x, heads, kv_heads, shard)
    q, k = _rotate(cfg, q, k, positions, mrope_positions)
    cap = cfg.attn_logit_softcap
    hq = heads or (0, H)

    def finish(out):
        return _rows_out(out.reshape(B, T, -1), params["wo"], hq[0] * hd,
                         hq[1] * hd, H * hd, shard)

    def attend(q_, k_, v_, q_pos, k_pos):
        S = k_.shape[1]
        if use_flash and causal and T == S and T >= 128:
            # masks by index: every prefill's positions are arange(T)
            return flash_attention(q_, k_, v_, causal=True, window=window,
                                   scale=scale, logit_cap=cap)
        if T * S > 2_097_152:  # avoid materializing big (T,S) score tensors
            return chunked_sdpa(q_, k_, v_, q_pos, k_pos, scale=scale,
                                window=window, logit_cap=cap, causal=causal)
        mask = _causal_mask(q_pos, k_pos, window) if causal else (
            (k_pos[:, None, :] >= 0)[:, None, :, :].expand(B, 1, T, S))
        return _sdpa(q_, k_, v_, mask, scale, cap)

    def attend_block(k_, v_, k_pos):
        # this rank's keys only, then every rank's partial merged
        out, lse = _sdpa(q, k_, v_, _causal_mask(positions, k_pos, window),
                         scale, cap, lse=True)
        return col.gather_partials(out, lse, shard)

    if mode == "prefill":
        # attention over the in-flight K/V, never through the cache (no
        # ring-slot collisions, no S_max-wide scores)
        out = attend(q, k, v, positions, positions)
        if cache is not None and kind == "swa":
            tw = min(T, cache["pos"].shape[1])   # the ring keeps the last w
            if block is not None:
                _ring_write_block(cache, positions[:, -tw:], k[:, -tw:],
                                  v[:, -tw:], block[0], cache["pos"].shape[1])
            else:
                _ring_write(cache, positions[:, -tw:], k[:, -tw:], v[:, -tw:])
        elif cache is not None and "k_pages" in cache:
            _pool_write(cache, page_table, positions, shard, k_pages=k,
                        v_pages=v)
        elif cache is not None and block is not None:
            _write(cache, positions, *block, k=k, v=v)
        elif cache is not None:
            _write(cache, positions, k=k, v=v)
        return finish(out), cache

    # extend: write the new tokens first, then attend over the cache
    if kind == "swa":
        if block is not None:
            lo, n = block
            _ring_write_block(cache, positions, k, v, lo,
                              cache["pos"].shape[1])
            return finish(attend_block(cache["k"], cache["v"],
                                       cache["pos"][:, lo:lo + n])), cache
        _ring_write(cache, positions, k, v)
        out = attend(q, cache["k"], cache["v"], positions, cache["pos"])
        return finish(out), cache
    if "k_pages" in cache:
        _pool_write(cache, page_table, positions, shard, k_pages=k, v_pages=v)
        kernel_width = causal and T <= PAGED_KERNEL_MAX_T
        if kernel_width and paged_attention == "gather" and q.is_cuda:
            raise ValueError(GATHER_ON_CUDA)
        if kernel_width and paged_attention == "kernel":
            # decode/verify: the block-table-walking kernel reads the pages
            # straight from the pool; no dense gather
            out = paged_decode_attention(
                q.contiguous(), cache["k_pages"], cache["v_pages"],
                positions[:, 0].to(torch.int32), page_table, scale=scale,
                logit_cap=cap)
        else:
            # stale and trash content is masked the way rejected SD suffixes
            # are: the causal mask admits only positions <= q_pos.  V rows
            # past each row's newest query are zeroed, as kernels 3 and 4
            # zero them: a recycled page's stale NaN there would otherwise
            # enter the P V product as 0 x NaN
            S = page_table.shape[1] * cache["k_pages"].shape[1]
            k_pos = torch.arange(S, device=x.device)[None, :].expand(B, S)
            past = k_pos > positions[:, -1:]                     # (B, S)
            v_view = paged_view(cache["v_pages"], page_table).masked_fill_(
                past[:, :, None, None], 0.0)       # a fresh gather: in place
            out = attend(q, paged_view(cache["k_pages"], page_table), v_view,
                         positions, k_pos)
        return finish(out), cache
    if block is not None:
        lo, n = block
        _write(cache, positions, lo, n, k=k, v=v)
        kb, vb = cache["k"][:, :n], cache["v"][:, :n]
        if use_flash and window == 0 and cap == 0.0 and n * shard.m >= 512:
            # kernel 4's partial entry over this rank's key block
            out, lse = decode_attention_partial(
                q, kb, vb, positions[:, 0].to(torch.int32), k_lo=lo,
                scale=scale)
            return finish(col.gather_partials(out, lse, shard)), cache
        k_pos = (lo + torch.arange(n, device=x.device))[None, :].expand(B, n)
        return finish(attend_block(kb, vb, k_pos)), cache
    _write(cache, positions, k=k, v=v)
    S = cache["k"].shape[1] - 1                 # logical capacity: no trash slot
    if use_flash and window == 0 and cap == 0.0 and S >= 512:
        # decode/verify kernel: T queries against the cache read in place,
        # per-sequence lengths = first query position
        out = decode_attention(q, cache["k"][:, :S], cache["v"][:, :S],
                               positions[:, 0].to(torch.int32), scale=scale)
        return finish(out), cache
    k_pos = torch.arange(S, device=x.device)[None, :].expand(B, S)
    out = attend(q, cache["k"][:, :S], cache["v"][:, :S], positions, k_pos)
    return finish(out), cache


# ---------------------------------------------------------------------------
# MLA forward (DeepSeek-V2 / MiniCPM3 multi-head latent attention)
# ---------------------------------------------------------------------------

def _rms(x, scale, eps):
    xf = x.float()
    out = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (out * scale.float()).to(x.dtype)


def _mla_q(params, cfg, x):
    B, T, _ = x.shape
    dn, dr = cfg.mla_qk_nope_dim, cfg.mla_qk_rope_dim
    if "w_dq" in params:
        q = _rms(x @ params["w_dq"], params["q_norm"], cfg.norm_eps) \
            @ params["w_uq"]
    else:
        q = x @ params["wq"]
    q = q.reshape(B, T, cfg.num_heads, dn + dr)
    return q[..., :dn], q[..., dn:]


def mla_forward(
    params: dict,
    cfg,
    x: torch.Tensor,                 # (B, T, d)
    positions: torch.Tensor,         # (B, T)
    *,
    cache: Optional[dict] = None,
    mode: str = "prefill",           # prefill | extend
    page_table: Optional[torch.Tensor] = None,
    shard=None,
) -> Tuple[torch.Tensor, Optional[dict]]:
    """Latent attention: the cache holds the normalised KV latent and one
    rope key shared by every head; each pass expands the latent it attends
    over into per-head K_nope and V (``w_uk``, ``w_uv``).  Writes the cache
    in place; plain PyTorch, as the reference is plain JAX.  Under a mesh
    the weights come whole (``Model`` gathers them) and every rank
    computes every head; a dense cache split along its sequence
    (``shard``'s cache placement) is attended block by block, the
    partials merged by their log-sum-exp."""
    if mode not in ("prefill", "extend"):
        raise ValueError(f"mode must be 'prefill' or 'extend', got {mode!r}")
    B, T, _ = x.shape
    H = cfg.num_heads
    dn, dr, dv = cfg.mla_qk_nope_dim, cfg.mla_qk_rope_dim, cfg.mla_v_head_dim
    r_kv = cfg.mla_kv_lora_rank
    scale = 1.0 / math.sqrt(dn + dr)

    q_nope, q_rope = _mla_q(params, cfg, x)                # (B,T,H,dn/(dr))
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    dkv = x @ params["w_dkv"]                              # (B,T,r_kv+dr)
    latent = _rms(dkv[..., :r_kv], params["kv_norm"], cfg.norm_eps)
    k_rope_new = apply_rope(dkv[..., None, r_kv:], positions,
                            cfg.rope_theta)[..., 0, :]     # (B,T,dr), one head

    paged = cache is not None and "latent_pages" in cache
    block = None
    if shard is not None and not paged and shard.cache_split("latent") == 1:
        n = cache["latent"].shape[1] - 1
        block = (shard.j * n, n)
    if paged:
        _pool_write(cache, page_table, positions, shard, latent_pages=latent,
                    k_rope_pages=k_rope_new)
    elif block is not None:
        _write(cache, positions, *block, latent=latent,
               k_rope=k_rope_new)
    elif cache is not None:
        _write(cache, positions, latent=latent, k_rope=k_rope_new)
    if mode == "prefill" or cache is None:
        lat_all, k_rope_all, k_pos = latent, k_rope_new, positions
    elif block is not None:
        lo, n = block
        lat_all, k_rope_all = cache["latent"][:, :n], cache["k_rope"][:, :n]
        k_pos = (lo + torch.arange(n, device=x.device))[None, :].expand(B, n)
    elif paged:
        S = page_table.shape[1] * cache["latent_pages"].shape[1]
        k_pos = torch.arange(S, device=x.device)[None, :].expand(B, S)
        # latents past each row's newest query are zeroed, so a recycled
        # page's stale NaN never reaches V (the GQA gathered view's rule)
        lat_all = paged_view(cache["latent_pages"], page_table).masked_fill_(
            (k_pos > positions[:, -1:])[:, :, None], 0.0)
        k_rope_all = paged_view(cache["k_rope_pages"], page_table)
    else:
        S = cache["latent"].shape[1] - 1          # logical capacity
        lat_all, k_rope_all = cache["latent"][:, :S], cache["k_rope"][:, :S]
        k_pos = torch.arange(S, device=x.device)[None, :].expand(B, S)

    # expand the latent into per-head K_nope and V; fold the shared rope key
    # into one concatenated head dim so plain SDPA applies:
    #   q.k = q_nope.k_nope + q_rope.k_rope
    S = lat_all.shape[1]
    k_nope = (lat_all @ params["w_uk"]).reshape(B, S, H, dn)
    v = (lat_all @ params["w_uv"]).reshape(B, S, H, dv)
    k_cat = torch.cat([k_nope, k_rope_all[:, :, None, :].expand(B, S, H, dr)],
                      dim=-1)
    q_cat = torch.cat([q_nope, q_rope], dim=-1)
    if block is not None:
        part, lse = _sdpa(q_cat, k_cat, v, _causal_mask(positions, k_pos),
                          scale, lse=True)
        out = col.gather_partials(part, lse, shard)
    elif T * S > 2_097_152:
        out = chunked_sdpa(q_cat, k_cat, v, positions, k_pos, scale=scale)
    else:
        out = _sdpa(q_cat, k_cat, v, _causal_mask(positions, k_pos), scale)
    return out.reshape(B, T, H * dv) @ params["wo"], cache


# ---------------------------------------------------------------------------
# cross attention (whisper decoder -> encoder output)
# ---------------------------------------------------------------------------

def cross_attn_prefill_cache(params: dict, cfg, enc_out: torch.Tensor,
                             dtype) -> dict:
    """Project the encoder output to K/V once; static for the whole decode."""
    B, S, _ = enc_out.shape
    k = (enc_out @ params["wk"]).reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    v = (enc_out @ params["wv"]).reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    return {"k": k.to(dtype), "v": v.to(dtype)}


def cross_attn_forward(params: dict, cfg, x: torch.Tensor, kv: dict,
                       shard=None) -> torch.Tensor:
    """Every query attends over every encoder frame (no mask, no RoPE);
    plain PyTorch, as the reference is plain JAX.  Under a mesh the weights
    come whole and the cross K/V block (heads or frames over ``"model"``)
    is gathered first."""
    split = None if shard is None else shard.cache_split("cross/k")
    if split is not None:
        kv = {n: col.gather(kv[n], split, shard) for n in ("k", "v")}
    B, T, _ = x.shape
    q = (x @ params["wq"]).reshape(B, T, cfg.num_heads, cfg.head_dim)
    S = kv["k"].shape[1]
    scale = 1.0 / math.sqrt(cfg.head_dim)
    if T * S > 2_097_152:  # chunked online softmax for long decoder inputs
        q_pos = torch.zeros((B, T), dtype=torch.int32, device=x.device)
        k_pos = torch.zeros((B, S), dtype=torch.int32, device=x.device)
        out = chunked_sdpa(q, kv["k"], kv["v"], q_pos, k_pos, scale=scale,
                           causal=False, chunk=min(1024, S))
    else:
        mask = torch.ones((B, 1, T, S), dtype=torch.bool, device=x.device)
        out = _sdpa(q, kv["k"], kv["v"], mask, scale)
    return out.reshape(B, T, -1) @ params["wo"]
