"""Plain PyTorch versions of the ragged grouped-matmul kernels.

Ports of ``repro.kernels.gmm.ref`` (``ragged_gmm_ref``, ``fused_gate_up_ref``,
``ragged_moe_ffn_ref``).  The reference oracle gathers ``w[e]`` per row into
an (N, D, F) tensor; at full width (N·K=320, D=3584, F=2560) that is ~11.7 GB
in fp32, so these loop over experts instead and multiply each expert's
contiguous row slab by its weight matrix.  Accumulation is fp32 and the
result is cast to the input dtype, as in the kernels.

These are the CPU path of the wrappers in ``ragged.py`` and the yardstick
the CUDA kernels are held against on the card.  The loop reads the group
boundaries on the host, so it synchronises; the kernels never do.
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import act_fn


def _group_bounds(group_sizes: torch.Tensor, n: int):
    """Host (start, end) row range per expert.  Rows past the last group
    belong to expert E-1, as the reference's clamped gather assigns them."""
    ends = torch.cumsum(group_sizes.to(torch.int64), 0).clamp(max=n).tolist()
    ends[-1] = n
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
