"""Decoder block and stack.

Port of ``repro.models.transformer`` for the attention kinds ``"attn"``,
``"swa"`` and ``"mla"`` (the recurrent kinds and cross-attention are ROADMAP
queue 1 item 9).  A *block* is an attention sublayer and
an FFN sublayer (dense or MoE) with pre-norms and residuals.  The reference
scans over periods with per-slot parameters stacked over ``num_periods``;
here the stack is a list of per-layer blocks and a Python loop, layer
``l`` having kind ``layer_pattern[l % period]``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import apply_mlp, apply_norm, init_mlp, init_norm


ATTN_KINDS = ("attn", "swa", "mla")


def layer_kinds(cfg):
    """(kind, is_moe) of every layer, in order."""
    return [(cfg.layer_pattern[l % cfg.period], cfg.moe_pattern[l % cfg.period])
            for l in range(cfg.num_layers)]


def init_block(cfg, kind: str, is_moe: bool, dtype, *, generator,
               device) -> dict:
    if kind not in ATTN_KINDS:
        raise NotImplementedError(
            f"block kind {kind!r} is ROADMAP queue 1 item 9")
    kw = dict(generator=generator, device=device)
    mixer = attn.init_mla if kind == "mla" else attn.init_gqa
    p: Dict[str, Any] = {"norm1": init_norm(cfg, dtype, device),
                         "mixer": mixer(cfg, dtype, **kw)}
    if is_moe or cfg.d_ff > 0:
        p["norm2"] = init_norm(cfg, dtype, device)
        p["ffn"] = (moe_mod.init_moe(cfg, dtype, **kw) if is_moe
                    else init_mlp(cfg.d_model, cfg.d_ff, dtype, **kw))
    return p


def block_forward(params: dict, cfg, kind: str, is_moe: bool,
                  x: torch.Tensor, positions: torch.Tensor,
                  cache: Optional[dict], *, mode: str,
                  dispatch: str = "onehot",
                  use_flash: bool = False,
                  page_table: Optional[torch.Tensor] = None,
                  paged_attention: str = "kernel",
                  want_metrics: bool = False,
                  prefetch_mask: Optional[torch.Tensor] = None,
                  mrope_positions: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, dict]:
    """One block; writes this layer's KV into ``cache`` in place.  Returns
    the output and the MoE layer's metrics (``moe_forward``'s; empty for a
    dense layer or when none are asked for)."""
    h = apply_norm(params["norm1"], x, cfg.norm_eps)
    if kind == "mla":
        out, _ = attn.mla_forward(params["mixer"], cfg, h, positions,
                                  cache=cache, mode=mode,
                                  page_table=page_table)
    else:
        out, _ = attn.gqa_forward(params["mixer"], cfg, h, positions,
                                  kind=kind, cache=cache, mode=mode,
                                  mrope_positions=mrope_positions,
                                  use_flash=use_flash, page_table=page_table,
                                  paged_attention=paged_attention)
    x = x + out
    metrics: dict = {}
    if "ffn" in params:
        h = apply_norm(params["norm2"], x, cfg.norm_eps)
        if is_moe:
            y, metrics = moe_mod.moe_forward(
                params["ffn"], cfg, h, dispatch=dispatch,
                return_metrics=want_metrics, prefetch_mask=prefetch_mask)
        else:
            y = apply_mlp(params["ffn"], h, cfg.mlp_activation)
        x = x + y
    return x, metrics


def init_stack(cfg, dtype, *, generator, device) -> List[dict]:
    """Per-layer block params, in layer order."""
    return [init_block(cfg, kind, is_moe, dtype, generator=generator,
                       device=device)
            for kind, is_moe in layer_kinds(cfg)]


def make_stack_cache(cfg, batch: int, max_seq: int, dtype, device, *,
                     paged: bool = False, page_size: int = 64,
                     pool_pages: Optional[int] = None) -> List[dict]:
    """One cache per layer; a paged cache gives every full-attention and
    MLA layer a pool of the same ``pool_pages`` (default: every row at
    ``max_seq`` + trash page); SWA rings stay dense."""
    if paged and pool_pages is None:
        pool_pages = batch * (-(-max_seq // page_size)) + 1
    return [attn.make_attn_cache(cfg, batch, max_seq, kind, dtype, device,
                                 paged=paged, page_size=page_size,
                                 pool_pages=pool_pages)
            for kind, _ in layer_kinds(cfg)]


def stack_forward(layer_params: List[dict], cfg, x: torch.Tensor,
                  positions: torch.Tensor, caches: Optional[List[dict]], *,
                  mode: str, dispatch: str = "onehot",
                  use_flash: bool = False,
                  page_table: Optional[torch.Tensor] = None,
                  paged_attention: str = "kernel",
                  want_metrics: bool = False,
                  prefetch_masks: Optional[List[torch.Tensor]] = None,
                  mrope_positions: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, dict]:
    """Run every layer in order (the reference's scan over periods).

    ``page_table`` (B, MP) is the block table of a paged cache, shared by
    every layer; ``paged_attention`` picks the paged extend backend:
    "kernel" walks the table in the CUDA kernel, "gather" (CPU only)
    attends over the dense ``pool[table]`` view.

    Returns the output and the metrics summed over layers:
    ``want_metrics`` adds the router's ``aux_loss`` and ``expert_counts``
    (E,), and ``prefetch_masks`` (one (E,) mask per layer,
    ``models/moe.PrefetchPlan.masks``) the ``prefetch_hits``/``_actual``/
    ``_predicted`` counts, all on the device; nothing asked gives {}.
    ``mrope_positions`` (B, T, 3) are M-RoPE's (t, h, w) ids (text-only
    positions when None)."""
    metrics: Dict[str, torch.Tensor] = {}
    dev = x.device
    if want_metrics:
        metrics["aux_loss"] = torch.zeros((), dtype=torch.float32, device=dev)
        metrics["expert_counts"] = torch.zeros(
            (max(cfg.num_experts, 1),), dtype=torch.int32, device=dev)
    if prefetch_masks is not None:
        for k in ("prefetch_hits", "prefetch_actual", "prefetch_predicted"):
            metrics[k] = torch.zeros((), dtype=torch.int32, device=dev)
    for l, (kind, is_moe) in enumerate(layer_kinds(cfg)):
        x, m = block_forward(layer_params[l], cfg, kind, is_moe, x, positions,
                             None if caches is None else caches[l], mode=mode,
                             dispatch=dispatch, use_flash=use_flash,
                             page_table=page_table,
                             paged_attention=paged_attention,
                             want_metrics=want_metrics,
                             prefetch_mask=None if prefetch_masks is None
                             else prefetch_masks[l],
                             mrope_positions=mrope_positions)
        for k, v in m.items():
            metrics[k] = metrics[k] + v
    return x, metrics
