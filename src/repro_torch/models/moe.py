"""Mixture-of-Experts FFN: top-k router and expert dispatch.

Port of ``repro.models.moe`` for the serving dispatches:

  * ``gmm``     — tokens sorted by expert id, ragged grouped matmul via the
                  CUDA kernels (``kernels/gmm/ragged.py``).  Serving path.
  * ``onehot``  — dense einsum over a (tokens, experts) combine tensor; kept
                  as a second oracle for tests.

Expert-parallel dispatch (``ep``) and the prefetch masks are later slices.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.gmm import ragged
from repro_torch.models.layers import act_fn, dense_init


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


def moe_forward(params: dict, cfg, x: torch.Tensor, *,
                dispatch: str = "onehot") -> torch.Tensor:
    """Routed MoE FFN with the shared-expert add: (B, T, d) → (B, T, d)."""
    if dispatch not in ("gmm", "onehot"):
        raise NotImplementedError(
            f"dispatch {dispatch!r}: expert-parallel serving is ROADMAP "
            "queue 1 item 11; this slice ports 'gmm' and 'onehot'")
    B, T, d = x.shape
    xf = x.reshape(B * T, d)
    weights, indices, _ = router_topk(params, cfg, xf)
    fn = _dispatch_gmm if dispatch == "gmm" else _dispatch_onehot
    y = fn(params, cfg, xf, weights.to(x.dtype), indices)
    if "shared" in params:
        s = params["shared"]
        h = act_fn(xf @ s["w_gate"], cfg.mlp_activation) * (xf @ s["w_up"])
        y = y + h @ s["w_down"]
    return y.reshape(B, T, d)

