"""GQA self-attention with a dense KV cache ("attn" block kind).

Port of ``repro.models.attention`` for the kinds this slice serves.  Two
execution modes share one code path:
  * ``prefill`` — causal over the prompt, writes the KV cache from pos 0.
  * ``extend``  — T new tokens (T=1 → plain decode, T=γ+1 → SD verify)
                  appended at per-sequence offsets against a populated
                  cache.

Cache: ``{"k": (B, S+1, Hkv, D), "v": ...}`` for a logical capacity of S
positions.  Slot S is a trash slot: the reference's scatter drops writes past
S (a row that ran ahead of its wave), and PyTorch's would fault, so such
writes are clamped onto slot S, which attention never reads.

RoPE is applied at write time for K (absolute positions), query side at read
time, so cached K never needs re-rotation.

Paged cache (``make_attn_cache(..., paged=True)``): ``{"k_pages": (NP, ps,
Hkv, D), "v_pages": ...}``, a physical page pool shared by all rows and
addressed through the model-level block table (B, MP).  Page 0 is the
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
and never its trash slot.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.decode_attention.paged import paged_decode_attention
from repro_torch.kernels.decode_attention.ref import paged_view
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.layers import apply_rope, dense_init, softcap

NEG_INF = -1e30

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


def make_attn_cache(cfg, batch: int, max_seq: int, kind: str, dtype, device,
                    *, paged: bool = False, page_size: int = 64,
                    pool_pages: Optional[int] = None) -> dict:
    """Per-layer decode cache: dense with one trailing trash slot, or a
    physical page pool (``pool_pages`` pages of ``page_size`` positions;
    default: every row at ``max_seq`` plus the trash page)."""
    if kind != "attn":
        raise NotImplementedError(
            f"block kind {kind!r} is ROADMAP queue 1 item 9; this slice "
            "ports 'attn' only")
    if paged:
        npg = (batch * (-(-max_seq // page_size)) + 1
               if pool_pages is None else pool_pages)
        shape = (npg, page_size, cfg.num_kv_heads, cfg.head_dim)
        return {"k_pages": torch.zeros(shape, dtype=dtype, device=device),
                "v_pages": torch.zeros(shape, dtype=dtype, device=device)}
    shape = (batch, max_seq + 1, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _write(cache: dict, positions: torch.Tensor, k, v) -> None:
    """Write K/V at (B, T) positions in place (saves copying the whole cache
    per token, which the reference's functional update does)."""
    S = cache["k"].shape[1] - 1
    bidx = torch.arange(positions.shape[0], device=positions.device)[:, None]
    slot = positions.clamp(max=S)
    cache["k"][bidx, slot] = k
    cache["v"][bidx, slot] = v


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

def _sdpa(q, k, v, mask, scale, logit_cap: float = 0.0):
    """q: (B,T,Hq,D)  k/v: (B,S,Hkv,D)  mask: (B,1,T,S) bool → (B,T,Hq,Dv)."""
    B, T, Hq, D = q.shape
    Hkv = k.shape[2]
    g = Hq // Hkv
    qg = q.reshape(B, T, Hkv, g, D)
    logits = torch.einsum("btkgd,bskd->bkgts", qg.float(), k.float()) * scale
    if logit_cap > 0:
        logits = softcap(logits, logit_cap)
    # masked_fill takes the scalar as a kernel argument; a device tensor
    # made from it would be a host-to-device copy (a sync) per layer
    logits = logits.masked_fill(~mask[:, :, None, :, :], NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgts,bskd->btkgd", probs, v.float())
    return out.reshape(B, T, Hq, v.shape[-1]).to(q.dtype)


def chunked_sdpa(q, k, v, q_pos, k_pos, *, scale: float, window: int = 0,
                 logit_cap: float = 0.0, chunk: int = 1024,
                 causal: bool = True):
    """Forward-only online-softmax attention over key chunks; never builds
    the (T, S) score matrix.  q: (B,T,Hq,D), k/v: (B,S,Hkv,D), q_pos: (B,T),
    k_pos: (B,S).  Invalid slots carry k_pos < 0."""
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    g = Hq // Hkv
    qg = q.reshape(B, T, Hkv, g, D).float()
    m = torch.full((B, Hkv, g, T), NEG_INF, device=q.device)
    l = torch.zeros((B, Hkv, g, T), device=q.device)
    acc = torch.zeros((B, Hkv, g, T, Dv), device=q.device)
    for s0 in range(0, S, chunk):
        k_t, v_t = k[:, s0:s0 + chunk].float(), v[:, s0:s0 + chunk].float()
        p_t = k_pos[:, s0:s0 + chunk]
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
        s = s.masked_fill(~valid[:, None, None], NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bkgtc,bckd->bkgtd", p, v_t)
        m = m_new
    out = acc / l.clamp(min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, T, Hq, Dv).to(q.dtype)


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

def _project_qkv(params, cfg, x):
    hd = cfg.head_dim
    B, T, _ = x.shape
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if "bq" in params:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    return (q.reshape(B, T, cfg.num_heads, hd),
            k.reshape(B, T, cfg.num_kv_heads, hd),
            v.reshape(B, T, cfg.num_kv_heads, hd))


def _rotate(cfg, q, k, positions):
    if cfg.rope_type != "rope":
        raise NotImplementedError(
            f"rope_type {cfg.rope_type!r} is ROADMAP queue 1 item 9")
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta))


def gqa_forward(
    params: dict,
    cfg,
    x: torch.Tensor,                 # (B, T, d)
    positions: torch.Tensor,         # (B, T) absolute positions
    *,
    kind: str = "attn",
    cache: Optional[dict] = None,
    mode: str = "prefill",           # prefill | extend
    use_flash: bool = False,
    causal: bool = True,
    page_table: Optional[torch.Tensor] = None,
    paged_attention: str = "kernel",
) -> Tuple[torch.Tensor, Optional[dict]]:
    if kind != "attn":
        raise NotImplementedError(
            f"block kind {kind!r} is ROADMAP queue 1 item 9")
    if mode not in ("prefill", "extend"):
        raise ValueError(f"mode must be 'prefill' or 'extend', got {mode!r}")
    B, T, _ = x.shape
    scale = 1.0 / math.sqrt(cfg.head_dim)
    q, k, v = _project_qkv(params, cfg, x)
    q, k = _rotate(cfg, q, k, positions)
    cap = cfg.attn_logit_softcap

    def attend(q_, k_, v_, q_pos, k_pos):
        S = k_.shape[1]
        if use_flash and causal and T == S and T >= 128:
            # masks by index: every prefill's positions are arange(T)
            return flash_attention(q_, k_, v_, causal=True, scale=scale,
                                   logit_cap=cap)
        if T * S > 2_097_152:  # avoid materializing big (T,S) score tensors
            return chunked_sdpa(q_, k_, v_, q_pos, k_pos, scale=scale,
                                logit_cap=cap, causal=causal)
        mask = _causal_mask(q_pos, k_pos) if causal else (
            (k_pos[:, None, :] >= 0)[:, None, :, :].expand(B, 1, T, S))
        return _sdpa(q_, k_, v_, mask, scale, cap)

    if mode == "prefill":
        # attention over the in-flight K/V, never through the cache
        out = attend(q, k, v, positions, positions)
        if cache is not None and "k_pages" in cache:
            _paged_write(cache["k_pages"], page_table, positions, k)
            _paged_write(cache["v_pages"], page_table, positions, v)
        elif cache is not None:
            _write(cache, positions, k, v)
        return out.reshape(B, T, -1) @ params["wo"], cache

    # extend: write the new tokens first, then attend over the cache
    if "k_pages" in cache:
        _paged_write(cache["k_pages"], page_table, positions, k)
        _paged_write(cache["v_pages"], page_table, positions, v)
        if causal and T <= 8 and paged_attention == "gather" and q.is_cuda:
            raise ValueError(GATHER_ON_CUDA)
        if causal and T <= 8 and paged_attention == "kernel":
            # decode/verify: the block-table-walking kernel reads the pages
            # straight from the pool; no dense gather
            out = paged_decode_attention(
                q.contiguous(), cache["k_pages"], cache["v_pages"],
                positions[:, 0].to(torch.int32), page_table, scale=scale,
                logit_cap=cap)
        else:
            # stale and trash content is masked the way rejected SD suffixes
            # are: the causal mask admits only positions <= q_pos
            S = page_table.shape[1] * cache["k_pages"].shape[1]
            k_pos = torch.arange(S, device=x.device)[None, :].expand(B, S)
            out = attend(q, paged_view(cache["k_pages"], page_table),
                         paged_view(cache["v_pages"], page_table), positions,
                         k_pos)
        return out.reshape(B, T, -1) @ params["wo"], cache
    _write(cache, positions, k, v)
    S = cache["k"].shape[1] - 1                 # logical capacity: no trash slot
    if use_flash and cap == 0.0 and S >= 512:
        # decode/verify kernel: T queries against the cache read in place,
        # per-sequence lengths = first query position
        out = decode_attention(q, cache["k"][:, :S], cache["v"][:, :S],
                               positions[:, 0].to(torch.int32), scale=scale)
        return out.reshape(B, T, -1) @ params["wo"], cache
    k_pos = torch.arange(S, device=x.device)[None, :].expand(B, S)
    out = attend(q, cache["k"][:, :S], cache["v"][:, :S], positions, k_pos)
    return out.reshape(B, T, -1) @ params["wo"], cache
