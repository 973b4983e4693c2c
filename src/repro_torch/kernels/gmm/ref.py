"""Plain PyTorch versions of the grouped-matmul kernels and of the capacity
dispatch around them.

Ports of ``repro.kernels.gmm.ref``: ``ragged_gmm_ref``, ``fused_gate_up_ref``
and ``ragged_moe_ffn_ref`` for the ragged kernels; ``gmm_capacity_ref``,
``dispatch_ref``, ``combine_ref`` and ``moe_ffn_ref`` for the
capacity-binned path (``gmm.py``, ``ops.py``).  The reference oracle gathers ``w[e]`` per row into
an (N, D, F) tensor; at full width (N·K=320, D=3584, F=2560) that is ~11.7 GB
in fp32, so these loop over experts instead and multiply each expert's
contiguous row slab by its weight matrix.  Accumulation is fp32 and the
result is cast to the input dtype, as in the kernels.

These are the CPU path of the wrappers in ``ragged.py`` and ``gmm.py`` and
the yardstick the CUDA kernels are held against on the card.  The ragged
versions take ``sum(group_sizes) <= N``: the rows past the groups come out
zero (the kernels leave them unwritten; their callers never read them).
The ragged loop
reads the group boundaries on the host, so it synchronises; the kernels and
the capacity dispatch never do.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.models.layers import act_fn


def _group_bounds(group_sizes: torch.Tensor, n: int):
    """Host (start, end) row range per expert.  The groups may cover fewer
    than ``n`` rows (an expert-parallel receive buffer's empty slots sort
    past them): those rows belong to no expert and stay zero."""
    # lint: allow[T104] plain version: CPU tensors only, never captured
    ends = torch.cumsum(group_sizes.to(torch.int64), 0).clamp(max=n).tolist()
    starts = [0] + ends[:-1]
    return list(zip(starts, ends))


def _per_expert(xs: torch.Tensor, group_sizes: torch.Tensor, fn, width: int):
    out = torch.zeros((xs.shape[0], width), dtype=torch.float32,
                      device=xs.device)
    for e, (s, t) in enumerate(_group_bounds(group_sizes, xs.shape[0])):
        if t > s:
            out[s:t] = fn(xs[s:t].float(), e)
    return out


def ragged_gmm_ref(xs: torch.Tensor, w: torch.Tensor,
                   group_sizes: torch.Tensor) -> torch.Tensor:
    """``xs[n] @ w[e(n)]`` for expert-sorted rows: (N, D) → (N, F)."""
    out = _per_expert(xs, group_sizes, lambda x, e: x @ w[e].float(),
                      w.shape[-1])
    return out.to(xs.dtype)


def fused_gate_up_ref(xs, w_gate, w_up, group_sizes, activation="silu"):
    """``act(x @ wg[e]) * (x @ wu[e])`` per group, cast to the input dtype."""
    def ffn_in(x, e):
        return act_fn(x @ w_gate[e].float(), activation) * (x @ w_up[e].float())
    return _per_expert(xs, group_sizes, ffn_in, w_gate.shape[-1]).to(xs.dtype)


def ragged_moe_ffn_ref(xs, w_gate, w_up, w_down, group_sizes,
                       activation="silu"):
    """The 2-launch ragged expert FFN: ``h`` is rounded to the input dtype
    between the two products, as the kernels do."""
    h = fused_gate_up_ref(xs, w_gate, w_up, group_sizes, activation)
    return ragged_gmm_ref(h, w_down, group_sizes)


# ------------------------------------------------------------ capacity bins

def gmm_capacity_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(E, C, D) @ (E, D, F) → (E, C, F), fp32 accumulation, cast to x's
    dtype."""
    return torch.einsum("ecd,edf->ecf", x.float(), w.float()).to(x.dtype)


def dispatch_ref(
    x: torch.Tensor,           # (N, D) tokens
    indices: torch.Tensor,     # (N, K) expert ids
    num_experts: int,
    capacity: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Capacity-binned dispatch.

    Returns (bins (E, C, D), slot (N, K) position inside the bin or -1 if
    dropped, kept (N, K) bool).  Position = rank of the (token, k) pair
    among all pairs routed to that expert, in flat (n*K + k) order.  A
    dropped pair adds zeros into slot C-1, as the reference's scatter-add
    does.  Device ops only: nothing waits on the routing."""
    N, K = indices.shape
    flat = indices.reshape(-1).to(torch.int64)                  # (N*K,)
    onehot = torch.nn.functional.one_hot(flat, num_experts)     # (NK, E)
    rank = torch.cumsum(onehot, dim=0) - onehot                 # rank within expert
    slot = (rank * onehot).sum(-1)                              # (NK,)
    kept = slot < capacity
    slot = torch.where(kept, slot, torch.full_like(slot, -1))
    xt = x[torch.arange(N, device=x.device).repeat_interleave(K)]
    vals = torch.where(kept[:, None], xt, torch.zeros_like(xt))
    bins = torch.zeros((num_experts, capacity, x.shape[-1]), dtype=x.dtype,
                       device=x.device)
    bins.index_put_((flat, torch.where(kept, slot,
                                       torch.full_like(slot, capacity - 1))),
                    vals, accumulate=True)
    return bins, slot.reshape(N, K), kept.reshape(N, K)


def combine_ref(
    y_bins: torch.Tensor,      # (E, C, F) expert outputs
    indices: torch.Tensor,     # (N, K)
    weights: torch.Tensor,     # (N, K)
    slot: torch.Tensor,        # (N, K)
    kept: torch.Tensor,        # (N, K)
) -> torch.Tensor:             # (N, F)
    N, K = indices.shape
    gathered = y_bins[indices.reshape(-1).to(torch.int64),
                      slot.reshape(-1).clamp(min=0)]
    gathered = torch.where(kept.reshape(-1)[:, None], gathered,
                           torch.zeros_like(gathered))
    w = (weights * kept).reshape(-1)[:, None].to(gathered.dtype)
    return (gathered * w).reshape(N, K, -1).sum(1)


def moe_ffn_ref(x, w_gate, w_up, w_down, weights, indices, activation="silu"):
    """The whole capacity-free MoE FFN: exact one-hot combine (no drops),
    the ground truth the capacity path approaches as the capacity grows."""
    E = w_gate.shape[0]
    onehot = torch.nn.functional.one_hot(indices.to(torch.int64), E)
    combine = torch.einsum("nk,nke->ne", weights, onehot.to(weights.dtype))
    h = act_fn(torch.einsum("nd,edf->enf", x, w_gate), activation) \
        * torch.einsum("nd,edf->enf", x, w_up)
    y = torch.einsum("enf,efd->end", h, w_down)
    return torch.einsum("end,ne->nd", y, combine.to(y.dtype))
