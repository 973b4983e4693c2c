"""Decoder block and stack.

Port of ``repro.models.transformer``.  A *block* is an attention sublayer and
an FFN sublayer (dense or MoE) with pre-norms and residuals.  The reference
scans over periods with per-slot parameters stacked over ``num_periods``;
here the stack is a list of per-layer blocks and a Python loop, layer
``l`` having kind ``layer_pattern[l % period]``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import apply_mlp, apply_norm, init_mlp, init_norm


def layer_kinds(cfg):
    """(kind, is_moe) of every layer, in order."""
    return [(cfg.layer_pattern[l % cfg.period], cfg.moe_pattern[l % cfg.period])
            for l in range(cfg.num_layers)]


def init_block(cfg, kind: str, is_moe: bool, dtype, *, generator,
               device) -> dict:
    if kind != "attn":
        raise NotImplementedError(
            f"block kind {kind!r} is ROADMAP queue 1 item 9")
    kw = dict(generator=generator, device=device)
    p: Dict[str, Any] = {"norm1": init_norm(cfg, dtype, device),
                         "mixer": attn.init_gqa(cfg, dtype, **kw)}
    if is_moe or cfg.d_ff > 0:
        p["norm2"] = init_norm(cfg, dtype, device)
        p["ffn"] = (moe_mod.init_moe(cfg, dtype, **kw) if is_moe
                    else init_mlp(cfg.d_model, cfg.d_ff, dtype, **kw))
    return p


def block_forward(params: dict, cfg, kind: str, is_moe: bool,
                  x: torch.Tensor, positions: torch.Tensor,
                  cache: Optional[dict], *, mode: str,
                  dispatch: str = "onehot",
                  use_flash: bool = False) -> torch.Tensor:
    """One block; writes this layer's KV into ``cache`` in place."""
    h = apply_norm(params["norm1"], x, cfg.norm_eps)
    out, _ = attn.gqa_forward(params["mixer"], cfg, h, positions, kind=kind,
                              cache=cache, mode=mode, use_flash=use_flash)
    x = x + out
    if "ffn" in params:
        h = apply_norm(params["norm2"], x, cfg.norm_eps)
        if is_moe:
            y = moe_mod.moe_forward(params["ffn"], cfg, h, dispatch=dispatch)
        else:
            y = apply_mlp(params["ffn"], h, cfg.mlp_activation)
        x = x + y
    return x


def init_stack(cfg, dtype, *, generator, device) -> List[dict]:
    """Per-layer block params, in layer order."""
    return [init_block(cfg, kind, is_moe, dtype, generator=generator,
                       device=device)
            for kind, is_moe in layer_kinds(cfg)]


def make_stack_cache(cfg, batch: int, max_seq: int, dtype, device, *,
                     paged: bool = False) -> List[dict]:
    return [attn.make_attn_cache(cfg, batch, max_seq, kind, dtype, device,
                                 paged=paged)
            for kind, _ in layer_kinds(cfg)]


def stack_forward(layer_params: List[dict], cfg, x: torch.Tensor,
                  positions: torch.Tensor, caches: Optional[List[dict]], *,
                  mode: str, dispatch: str = "onehot",
                  use_flash: bool = False) -> torch.Tensor:
    """Run every layer in order (the reference's scan over periods)."""
    for l, (kind, is_moe) in enumerate(layer_kinds(cfg)):
        x = block_forward(layer_params[l], cfg, kind, is_moe, x, positions,
                          None if caches is None else caches[l], mode=mode,
                          dispatch=dispatch, use_flash=use_flash)
    return x
