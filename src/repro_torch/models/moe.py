"""Mixture-of-Experts FFN: top-k router and expert dispatch.

Port of ``repro.models.moe`` for the serving dispatches:

  * ``gmm``     — tokens sorted by expert id, ragged grouped matmul via the
                  CUDA kernels (``kernels/gmm/ragged.py``).  Serving path.
  * ``onehot``  — dense einsum over a (tokens, experts) combine tensor; kept
                  as a second oracle for tests.

Expert prefetch (SP-MoE, arXiv:2510.10302): a ``PrefetchPlan`` names, per
layer, the experts a router probe over the draft token stream predicts the
next verify pass will hit (``core/prefetch.py``).  ``warm_experts`` gathers
those experts' FFN weights into fixed-shape buffers during the SD round,
between propose and verify; verify still reads the original weights, so the
warm is a dispatch-level simulation, as in the reference.  ``moe_forward``
scores the plan against the experts a forward actually routed to
(``prefetch_hit_stats``: device int32 counts, no host sync).

  * ``ep``      — expert-parallel: the experts shard over a mesh's
                  ``"model"`` axis and tokens reach them through two
                  all-to-all hops into the same ragged kernels
                  (``distributed/collectives.moe_ep_forward``); with no mesh
                  it is ``onehot``, as in the reference.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels.gmm import ragged
from repro_torch.launch import costs
from repro_torch.models.layers import act_fn, apply_mlp, dense_init


class PrefetchPlan(NamedTuple):
    """Per-layer expert-warmup prediction.

    ``masks``: one ``(E,)`` bool tensor per layer, True where the probe
    predicts the verify pass will activate that expert (all False for a
    dense layer).  ``expert_ids``: one ``(M,)`` int64 tensor per layer, the
    top-M predicted ids behind the mask (``(0,)`` for a dense layer).  The
    reference stacks each period slot over ``num_periods`` ((P, E) and
    (P, M)); layer ``l`` here is period ``l // period`` of slot
    ``l % period`` there."""

    masks: Tuple[torch.Tensor, ...]
    expert_ids: Tuple[torch.Tensor, ...]


def _expert_rows(w: torch.Tensor) -> torch.Tensor:
    """``w`` (E, ...) as one row per expert, in 8-byte words where the row
    allows: the gather then moves a quarter as many bf16 elements, which
    on an H100 takes it from ~1.1 to ~2.5 TB/s (PERF.md)."""
    rows = w.view(w.shape[0], -1)
    if (rows.shape[1] * w.element_size()) % 8 == 0 and w.data_ptr() % 8 == 0:
        return rows.view(torch.int64)
    return rows


def _ep_block(mesh, cfg) -> Optional[Tuple[int, int]]:
    """(first expert, experts) of this rank's block when ``mesh`` shards
    the experts (a ``"model"`` axis wider than 1 that divides E), else
    None."""
    if mesh is None:
        return None
    from repro_torch.launch.mesh import mesh_dims
    m = mesh_dims(mesh).get("model", 1)
    if m <= 1 or cfg.num_experts % m != 0:
        return None
    e_local = cfg.num_experts // m
    return mesh.get_local_rank("model") * e_local, e_local


def warm_experts(layer_params: List[dict], cfg, plan: PrefetchPlan, *,
                 out: Optional[List[dict]] = None, mesh=None) -> List[dict]:
    """Gather the predicted experts' FFN weights: per MoE layer
    ``{"w_gate": (M, d, f), "w_up": (M, d, f), "w_down": (M, f, d)}``, a
    bit copy of ``ffn[k][expert_ids]``.

    ``out`` (the list a previous call returned) receives the gather in
    place, so a captured round writes the same buffers every replay.  The
    values are not consumed: verify reads the original weights (the
    reference's dispatch-level simulation, ``repro.models.moe``).

    ``mesh`` (expert-parallel serving, the experts over ``"model"``): each
    rank gathers only the predicted ids in its own expert block and zeroes
    the others' rows, the reference's shard_map branch (its result stacks
    the ranks' buffers on a leading axis; here each rank holds its own).
    The rank's expert leaves may be whole or already sharded."""
    kinds = [cfg.moe_pattern[l % cfg.period] for l in range(cfg.num_layers)]
    layers = [l for l, is_moe in enumerate(kinds)
              if is_moe and plan.expert_ids[l].shape[-1] > 0]
    if out is None:
        out = [{k: layer_params[l]["ffn"][k].new_empty(
                    (plan.expert_ids[l].shape[-1],)
                    + layer_params[l]["ffn"][k].shape[1:])
                for k in ("w_gate", "w_up", "w_down")} for l in layers]
    block = _ep_block(mesh, cfg)
    for l, buf in zip(layers, out):
        ffn, ids = layer_params[l]["ffn"], plan.expert_ids[l]
        if block is not None:
            first, e_local = block
            mine = (ids >= first) & (ids < first + e_local)
            ids = (ids - first).clamp(0, e_local - 1)
        for k in ("w_gate", "w_up", "w_down"):
            w = ffn[k]
            if block is not None and w.shape[0] == cfg.num_experts:
                w = w[first:first + e_local]
            torch.index_select(_expert_rows(w), 0, ids,
                               out=_expert_rows(buf[k]))
            if block is not None:
                buf[k].masked_fill_(~mine[:, None, None], 0)
    return out


def prefetch_hit_stats(prefetch_mask: torch.Tensor, indices: torch.Tensor,
                       num_experts: int) -> dict:
    """Score one layer's plan against the experts routed to: int32 device
    scalars ``prefetch_hits`` (activated and warmed), ``prefetch_actual``
    (activated) and ``prefetch_predicted`` (warmed)."""
    # the scalar fill is a kernel argument: no host copy, no host sync
    actual = torch.zeros((num_experts,), dtype=torch.int32,
                         device=indices.device).scatter_(
        0, indices.reshape(-1), 1) > 0
    predicted = prefetch_mask.to(torch.bool)
    return {
        "prefetch_hits": (actual & predicted).sum().to(torch.int32),
        "prefetch_actual": actual.sum().to(torch.int32),
        "prefetch_predicted": predicted.sum().to(torch.int32),
    }


def load_balance_loss(probs: torch.Tensor, indices: torch.Tensor,
                      num_experts: int) -> torch.Tensor:
    """Switch-transformer aux loss: E * sum_e f_e * P_e (arXiv:2101.03961)."""
    one_hot = torch.nn.functional.one_hot(indices, num_experts).float()
    f = one_hot.sum(1).mean(0)                   # fraction per expert
    return num_experts * (f * probs.mean(0)).sum()


def expert_activation_counts(indices: torch.Tensor,
                             num_experts: int) -> torch.Tensor:
    """Tokens routed to each expert (int32): the paper's N(t) measurement."""
    counts = torch.zeros((num_experts,), dtype=torch.int32,
                         device=indices.device)
    flat = indices.reshape(-1)
    return counts.scatter_add_(0, flat, torch.ones_like(flat,
                                                        dtype=torch.int32))


def init_moe(cfg, dtype, *, generator, device) -> dict:
    d, f = cfg.d_model, cfg.moe_d_ff
    E = cfg.num_experts
    kw = dict(generator=generator, device=device)
    p = {
        "router": dense_init((d, E), torch.float32, **kw),  # router in fp32
        "w_gate": dense_init((E, d, f), dtype, **kw),
        "w_up": dense_init((E, d, f), dtype, **kw),
        "w_down": dense_init((E, f, d), dtype, **kw),
    }
    if cfg.num_shared_experts:
        fs = f * cfg.num_shared_experts
        p["shared"] = {
            "w_gate": dense_init((d, fs), dtype, **kw),
            "w_up": dense_init((d, fs), dtype, **kw),
            "w_down": dense_init((fs, d), dtype, **kw),
        }
    return p


def router_topk(params: dict, cfg, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (N, d) → (weights (N,K), indices (N,K), router_probs (N,E)).

    ``lax.top_k`` puts the lower index first among equal values and
    ``torch.topk`` promises no order on ties, so the top K come from a
    stable descending sort."""
    logits = x.float() @ params["router"]
    probs = torch.softmax(logits, dim=-1)
    weights, indices = torch.sort(probs, dim=-1, descending=True, stable=True)
    K = cfg.num_experts_per_tok
    weights, indices = weights[:, :K], indices[:, :K]
    weights = weights / weights.sum(-1, keepdim=True)
    return weights, indices, probs


def _dispatch_onehot(params, cfg, x, weights, indices):
    """(N,d) → (N,d) via a dense one-hot combine: every expert's FFN on
    every token, weighted."""
    E = cfg.num_experts
    onehot = torch.nn.functional.one_hot(indices, E).to(weights.dtype)
    combine = torch.einsum("nk,nke->ne", weights, onehot)             # (N, E)
    h_gate = torch.einsum("nd,edf->enf", x, params["w_gate"])
    h_up = torch.einsum("nd,edf->enf", x, params["w_up"])
    h = act_fn(h_gate, cfg.mlp_activation) * h_up
    y = torch.einsum("enf,efd->end", h, params["w_down"])             # (E,N,d)
    return torch.einsum("end,ne->nd", y, combine.to(y.dtype))


def _dispatch_gmm(params, cfg, x, weights, indices):
    """Sort tokens by expert, ragged grouped matmul (2 kernel launches:
    fused gate+up, then down), weighted sum back to tokens in a fixed
    order.  Nothing here waits on the routing: group sizes stay on the
    device."""
    N, d = x.shape
    K, E = cfg.num_experts_per_tok, cfg.num_experts
    flat_expert = indices.reshape(-1)                       # (N*K,)
    order = torch.argsort(flat_expert, stable=True)         # jnp.argsort is stable
    token_of = order // K                                   # source token per slot
    xs = x[token_of]                                        # (N*K, d) sorted by expert
    # torch.bincount sizes its output from the data (a host sync); a
    # scatter-add into E counters does not
    group_sizes = torch.zeros((E,), dtype=torch.int32, device=x.device)
    group_sizes.scatter_add_(0, flat_expert,
                             torch.ones_like(flat_expert, dtype=torch.int32))
    # the meta device (the dry-run) holds no routing: a stated one
    group_sizes = costs.stated_group_sizes(group_sizes, N * K)
    ys = ragged.ragged_moe_ffn(xs, params["w_gate"], params["w_up"],
                               params["w_down"], group_sizes,
                               activation=cfg.mlp_activation)  # (N*K, d)
    w_flat = weights.reshape(-1)[order].to(ys.dtype)        # (N*K,)
    rows = ys * w_flat[:, None]
    # each token's K rows back in (token, k) order and summed by one
    # reduction: the same bits on every run, eager or replayed from a CUDA
    # graph (an index_add_ adds them with atomics on the card, in an order
    # that changes from run to run); the tests state the tolerance that
    # covers the order against the reference's scatter-add
    slots = torch.empty_like(rows).index_copy_(0, order, rows)
    return slots.view(N, K, d).sum(1)


def _global_balance_loss(probs, indices, num_experts: int, shard):
    """:func:`load_balance_loss` over every rank's rows when the batch is
    split (``shard.batch_axes``): the per-expert sums and the row count are
    summed over those axes first, so the loss is the whole batch's."""
    from repro_torch.distributed import collectives as col
    axes = shard.batch_axes
    one_hot = torch.nn.functional.one_hot(indices, num_experts).float()
    n = probs.shape[0] * shard.size(axes)
    f = col.reduce_over(one_hot.sum(1).sum(0), shard, axes) / n
    p = col.reduce_over(probs.sum(0), shard, axes) / n
    return num_experts * (f * p).sum()


def moe_forward(params: dict, cfg, x: torch.Tensor, *,
                dispatch: str = "onehot", return_metrics: bool = False,
                prefetch_mask: Optional[torch.Tensor] = None, mesh=None,
                mesh_layout: Optional[str] = None, shard=None):
    """Routed MoE FFN with the shared-expert add: (B, T, d) → (B, T, d).

    ``dispatch`` "gmm", "onehot" or "ep" (``mesh``/``mesh_layout`` go to
    the expert-parallel dispatch; the others ignore them).  Returns
    ``(output, metrics)``: ``return_metrics`` adds ``aux_loss`` and
    ``expert_counts``, a ``prefetch_mask`` (E,) the ``prefetch_hit_stats``
    counts; nothing asked gives {}.  ``shard`` (the layer's,
    ``distributed/collectives.Shard``, scoped to ``ffn``) carries the
    rank's place: the shared expert's ``"model"`` blocks, the rows of a
    split batch (the aux loss is then the whole batch's; the counts stay
    the rank's)."""
    if dispatch not in ("gmm", "onehot", "ep"):
        raise ValueError(f"dispatch must be 'gmm', 'onehot' or 'ep', got "
                         f"{dispatch!r}")
    B, T, d = x.shape
    xf = x.reshape(B * T, d)
    if dispatch == "ep":
        # the router runs inside each rank's shard; the metrics come from a
        # replicated re-route, as in the reference
        from repro_torch.distributed.collectives import moe_ep_forward
        y = moe_ep_forward(params, cfg, x, mesh=mesh, layout=mesh_layout,
                           shard=shard)
        if return_metrics or prefetch_mask is not None:
            _, indices, probs = router_topk(params, cfg, xf)
    else:
        weights, indices, probs = router_topk(params, cfg, xf)
        fn = _dispatch_gmm if dispatch == "gmm" else _dispatch_onehot
        y = fn(params, cfg, xf, weights.to(x.dtype), indices)
        if "shared" in params:
            y = y + apply_mlp(params["shared"], xf, cfg.mlp_activation,
                              shard=None if shard is None
                              else shard.sub("shared"))
        y = y.reshape(B, T, d)
    metrics = {}
    if return_metrics:
        metrics["aux_loss"] = (
            _global_balance_loss(probs, indices, cfg.num_experts, shard)
            if shard is not None and shard.batch_axes else
            load_balance_loss(probs, indices, cfg.num_experts))
        metrics["expert_counts"] = expert_activation_counts(indices,
                                                            cfg.num_experts)
    if prefetch_mask is not None:
        metrics.update(prefetch_hit_stats(prefetch_mask, indices,
                                          cfg.num_experts))
    return y, metrics
