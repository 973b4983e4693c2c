"""Decoder block and stack.

Port of ``repro.models.transformer``.  A *block* is a mixer sublayer
(attention: ``"attn"``, ``"swa"``, ``"mla"``; recurrent: ``"mamba"``,
``"mlstm"``, ``"slstm"``, models/ssm.py), an optional cross-attention
sublayer over an encoder's output (whisper's decoder) and an optional FFN
sublayer (dense or MoE), with pre-norms and residuals.  The reference
scans over periods with per-slot parameters stacked over ``num_periods``;
here the stack is a list of per-layer blocks and a Python loop, layer
``l`` having kind ``layer_pattern[l % period]``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import collectives as col
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import apply_mlp, apply_norm, init_mlp, init_norm
from repro_torch.training.tree import tree_leaves


ATTN_KINDS = ("attn", "swa", "mla")
RECURRENT_KINDS = ("mamba", "mlstm", "slstm")


def layer_kinds(cfg):
    """(kind, is_moe) of every layer, in order."""
    return [(cfg.layer_pattern[l % cfg.period], cfg.moe_pattern[l % cfg.period])
            for l in range(cfg.num_layers)]


def _has_ffn(cfg, kind: str, is_moe: bool) -> bool:
    if kind in ("mlstm", "slstm"):
        return False  # xLSTM blocks are self-contained
    return is_moe or cfg.d_ff > 0


def init_block(cfg, kind: str, is_moe: bool, dtype, *, generator,
               device, cross: bool = False) -> dict:
    kw = dict(generator=generator, device=device)
    if kind in ("attn", "swa"):
        mixer = attn.init_gqa
    elif kind == "mla":
        mixer = attn.init_mla
    elif kind in RECURRENT_KINDS:
        mixer = ssm_mod.INIT[kind]
    else:
        raise ValueError(f"unknown block kind {kind!r}")
    p: Dict[str, Any] = {"norm1": init_norm(cfg, dtype, device),
                         "mixer": mixer(cfg, dtype, **kw)}
    if cross:
        p["cross_norm"] = init_norm(cfg, dtype, device)
        p["cross"] = attn.init_cross_attn(cfg, dtype, **kw)
    if _has_ffn(cfg, kind, is_moe):
        p["norm2"] = init_norm(cfg, dtype, device)
        p["ffn"] = (moe_mod.init_moe(cfg, dtype, **kw) if is_moe
                    else init_mlp(cfg.d_model, cfg.d_ff, dtype, **kw))
    return p


def block_forward(params: dict, cfg, kind: str, is_moe: bool,
                  x: torch.Tensor, positions: torch.Tensor,
                  cache: Optional[dict], *, mode: str,
                  collect: bool = False,
                  causal: bool = True,
                  dispatch: str = "onehot",
                  use_flash: bool = False,
                  cross_kv: Optional[dict] = None,
                  page_table: Optional[torch.Tensor] = None,
                  paged_attention: str = "kernel",
                  want_metrics: bool = False,
                  prefetch_mask: Optional[torch.Tensor] = None,
                  mrope_positions: Optional[torch.Tensor] = None,
                  mesh=None, mesh_layout: Optional[str] = None,
                  shard=None) -> Tuple[torch.Tensor, dict, Optional[dict]]:
    """One block; writes this layer's KV into ``cache`` in place.  A
    recurrent layer writes its final state into ``cache`` in place, except
    in an extend with ``collect``, which leaves the state as it was and
    returns every per-step state (T, B, ...) for ``Model.commit`` to gather.
    Returns the output, the MoE layer's metrics (``moe_forward``'s; empty
    for a dense layer or when none are asked for) and the collected states
    (None unless collected).

    ``shard`` (``distributed/collectives.Shard``, the layer's) computes on
    this rank's part of a mesh: ``params`` hold ``"model"`` blocks where
    the layer computes on them (its ``params`` specs; ``Model`` gathers
    the rest), the attention follows its cache's placement (its ``cache``
    specs), and a recurrent state split over ``"model"`` is gathered
    before the mixer and split back after it."""
    h = apply_norm(params["norm1"], x, cfg.norm_eps)
    collected = None
    if kind in RECURRENT_KINDS:
        state = cache if cache is not None else ssm_mod.MAKE_STATE[kind](
            cfg, x.shape[0], x.dtype, x.device)
        split = {k: None if shard is None else shard.cache_split(k)
                 for k in state}
        state = {k: v if split[k] is None else col.gather(v, split[k], shard)
                 for k, v in state.items()}
        collect = mode == "extend" and collect
        out, new = ssm_mod.FORWARD[kind](params["mixer"], cfg, h, state,
                                         collect_states=collect)
        if collect:
            collected = {k: v if split[k] is None else
                         col.split(v, split[k] + 1, shard)
                         for k, v in new.items()}
        elif cache is not None:
            for k, leaf in cache.items():
                leaf.copy_(new[k] if split[k] is None else
                           col.split(new[k], split[k], shard))
    elif kind == "mla":
        out, _ = attn.mla_forward(params["mixer"], cfg, h, positions,
                                  cache=cache, mode=mode,
                                  page_table=page_table, shard=shard)
    else:
        out, _ = attn.gqa_forward(params["mixer"], cfg, h, positions,
                                  kind=kind, cache=cache, mode=mode,
                                  mrope_positions=mrope_positions,
                                  use_flash=use_flash, causal=causal,
                                  page_table=page_table,
                                  paged_attention=paged_attention,
                                  shard=_sub(shard, "mixer"))
    x = x + out
    if "cross" in params and cross_kv is not None:
        h = apply_norm(params["cross_norm"], x, cfg.norm_eps)
        x = x + attn.cross_attn_forward(params["cross"], cfg, h, cross_kv,
                                        shard=shard)
    metrics: dict = {}
    if "ffn" in params:
        h = apply_norm(params["norm2"], x, cfg.norm_eps)
        if is_moe:
            y, metrics = moe_mod.moe_forward(
                params["ffn"], cfg, h, dispatch=dispatch,
                return_metrics=want_metrics, prefetch_mask=prefetch_mask,
                mesh=mesh, mesh_layout=mesh_layout, shard=_sub(shard, "ffn"))
        else:
            y = apply_mlp(params["ffn"], h, cfg.mlp_activation,
                          shard=_sub(shard, "ffn"))
        x = x + y
    return x, metrics, collected


def _sub(shard, key: str):
    return None if shard is None else shard.sub(key)


def init_stack(cfg, dtype, *, generator, device,
               cross: bool = False) -> List[dict]:
    """Per-layer block params, in layer order; ``cross`` gives every block a
    cross-attention sublayer (an encoder-decoder's decoder)."""
    return [init_block(cfg, kind, is_moe, dtype, generator=generator,
                       device=device, cross=cross)
            for kind, is_moe in layer_kinds(cfg)]


def make_stack_cache(cfg, batch: int, max_seq: int, dtype, device, *,
                     paged: bool = False, page_size: int = 64,
                     pool_pages: Optional[int] = None) -> List[dict]:
    """One cache per layer; a paged cache gives every full-attention and
    MLA layer a pool of the same ``pool_pages`` (default: every row at
    ``max_seq`` + trash page); SWA rings and recurrent states are bounded
    per row and stay dense."""
    if paged and pool_pages is None:
        pool_pages = batch * (-(-max_seq // page_size)) + 1
    return [ssm_mod.MAKE_STATE[kind](cfg, batch, dtype, device)
            if kind in RECURRENT_KINDS else
            attn.make_attn_cache(cfg, batch, max_seq, kind, dtype, device,
                                 paged=paged, page_size=page_size,
                                 pool_pages=pool_pages)
            for kind, _ in layer_kinds(cfg)]


def stack_forward(layer_params: List[dict], cfg, x: torch.Tensor,
                  positions: torch.Tensor, caches: Optional[List[dict]], *,
                  mode: str, collect: bool = False, causal: bool = True,
                  dispatch: str = "onehot",
                  use_flash: bool = False,
                  cross_kvs: Optional[List[dict]] = None,
                  page_table: Optional[torch.Tensor] = None,
                  paged_attention: str = "kernel",
                  want_metrics: bool = False,
                  prefetch_masks: Optional[List[torch.Tensor]] = None,
                  mrope_positions: Optional[torch.Tensor] = None,
                  remat: bool = False, mesh=None,
                  mesh_layout: Optional[str] = None, shard=None,
                  prepare=None
                  ) -> Tuple[torch.Tensor, dict, List[Optional[dict]]]:
    """Run every layer in order (the reference's scan over periods).

    ``collect`` (extend only) leaves recurrent states as they were and
    returns each recurrent layer's per-step states (block_forward);
    ``causal=False`` is the encoder's bidirectional attention;
    ``cross_kvs`` (one {"k", "v"} per layer) the encoder's projected
    output that cross-attention sublayers read.

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
    positions when None).  The third value holds each layer's collected
    states (None where nothing was collected).

    ``remat`` under autograd (grad on, a parameter requiring grad) runs
    each layer under a non-reentrant checkpoint, the reference's per-layer
    ``jax.checkpoint``: the backward recomputes one layer at a time
    instead of keeping every layer's intermediates.

    ``mesh``/``mesh_layout`` go to every MoE layer's ``"ep"`` dispatch,
    ``shard`` to every block (``block_forward``), and ``prepare(l,
    params)`` gives layer ``l`` its params as it computes on them and its
    ``Shard`` (``Model`` gathers what it does not compute on a block of),
    inside the layer's checkpoint under ``remat``."""
    metrics: Dict[str, torch.Tensor] = {}
    dev = x.device
    if want_metrics:
        metrics["aux_loss"] = torch.zeros((), dtype=torch.float32, device=dev)
        metrics["expert_counts"] = torch.zeros(
            (max(cfg.num_experts, 1),), dtype=torch.int32, device=dev)
    if prefetch_masks is not None:
        for k in ("prefetch_hits", "prefetch_actual", "prefetch_predicted"):
            metrics[k] = torch.zeros((), dtype=torch.int32, device=dev)
    collected: List[Optional[dict]] = []
    def run(l, params, *a, **kw):
        if prepare is not None:
            params, kw["shard"] = prepare(l, params)
        return block_forward(params, *a, **kw)

    block = run
    if remat and torch.is_grad_enabled() and any(
            p.requires_grad for p in tree_leaves(layer_params)):
        block = lambda *a, **kw: checkpoint(run, *a, **kw,
                                            use_reentrant=False)
    for l, (kind, is_moe) in enumerate(layer_kinds(cfg)):
        x, m, c = block(
            l, layer_params[l], cfg, kind, is_moe, x, positions,
            None if caches is None else caches[l], mode=mode,
            collect=collect, causal=causal, dispatch=dispatch,
            use_flash=use_flash,
            cross_kv=None if cross_kvs is None else cross_kvs[l],
            page_table=page_table, paged_attention=paged_attention,
            want_metrics=want_metrics,
            prefetch_mask=None if prefetch_masks is None
            else prefetch_masks[l],
            mrope_positions=mrope_positions, mesh=mesh,
            mesh_layout=mesh_layout, shard=shard)
        for k, v in m.items():
            metrics[k] = metrics[k] + v
        collected.append(c)
    return x, metrics, collected
