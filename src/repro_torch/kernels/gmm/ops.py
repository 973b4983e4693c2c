"""Public wrappers around the gmm kernels: capacity dispatch → grouped matmul
→ weighted combine, i.e. a full MoE FFN built on the kernels.

Port of ``repro.kernels.gmm.ops``.  Grouped-matmul entry points:

  * ``gmm``         — the ragged kernel (``ragged.py``): no densification,
                      work scales with the routed tokens.  The serving path
                      behind ``moe_forward(dispatch="gmm")``.
  * ``gmm_legacy``  — the bin-to-capacity path: tokens are scattered into
                      fixed (E, C) bins and run through ``gmm_capacity``.
  * ``moe_ffn_gmm`` — capacity-limited full FFN (dispatch → 3 launches of
                      ``gmm_capacity`` → combine); overflow drops are
                      counted.

Nothing here reads a routing value on the host: bins, slots and the drop
count are built on the device.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from repro_torch.kernels.gmm.gmm import gmm_capacity
from repro_torch.kernels.gmm.ragged import ragged_gmm
from repro_torch.kernels.gmm.ref import combine_ref, dispatch_ref
from repro_torch.models.layers import act_fn


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def expert_capacity(n_tokens: int, k: int, num_experts: int,
                    capacity_factor: float = 2.0, align: int = 128) -> int:
    """Fixed per-expert bin size for the capacity-binned paths: the
    balanced-routing mean ``n_tokens * k / num_experts`` times
    ``capacity_factor``, rounded up to a multiple of ``align`` (at least
    ``align``)."""
    mean = n_tokens * k / num_experts
    return max(align, _round_up(int(mean * capacity_factor), align))


def moe_ffn_gmm(
    x: torch.Tensor,           # (N, D)
    w_gate: torch.Tensor,      # (E, D, F)
    w_up: torch.Tensor,
    w_down: torch.Tensor,      # (E, F, D)
    weights: torch.Tensor,     # (N, K) router weights
    indices: torch.Tensor,     # (N, K) expert ids
    *,
    capacity: int,
    activation: str = "silu",
    return_dropped: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Capacity-binned MoE FFN: dispatch → 3 grouped GEMMs → combine.

    ``h_gate`` and ``h_up`` come out of the kernel in x's dtype; ``h =
    act(h_gate) * h_up`` is taken in fp32 and rounded back to x's dtype
    before the down product, as in the reference.  A (token, k) pair past
    its expert's ``capacity`` is dropped (rank order ``n*K + k``); with
    ``return_dropped`` the int32 count of drops is returned too, as a device
    tensor."""
    E = w_gate.shape[0]
    bins, slot, kept = dispatch_ref(x, indices, E, capacity)
    h_gate = gmm_capacity(bins, w_gate)
    h_up = gmm_capacity(bins, w_up)
    h = (act_fn(h_gate.float(), activation) * h_up.float()).to(x.dtype)
    y_bins = gmm_capacity(h, w_down)
    y = combine_ref(y_bins, indices, weights, slot, kept)
    if return_dropped:
        return y, (~kept).sum().to(torch.int32)
    return y


def gmm(xs: torch.Tensor, w: torch.Tensor,
        group_sizes: torch.Tensor) -> torch.Tensor:
    """Sorted-token grouped matmul through the ragged kernel: (N, D) rows
    sorted by expert, ``group_sizes`` (E,) summing to N → (N, F)."""
    return ragged_gmm(xs, w, group_sizes)


def gmm_legacy(xs: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor,
               *, capacity: Optional[int] = None) -> torch.Tensor:
    """Bin-to-capacity grouped matmul: (N, D) expert-sorted rows → (N, F).

    Rows are scattered into (E, C) bins with C = ``round_up(capacity, 128)``
    (default ``round_up(N, 128)``, exact for any routing) and run through
    ``gmm_capacity``.  As in the reference, the bound is NOT checked: the
    rows of a group larger than C are dropped by the scatter, and reading
    back clamps their slot to C - 1, so those output rows silently receive
    another row's result.  Rows past ``sum(group_sizes)`` belong to no
    expert: their scatter is dropped and they read expert E-1's bin."""
    E, D, F = w.shape
    N = xs.shape[0]
    C = _round_up(max(int(N if capacity is None else capacity), 1), 128)
    sizes = group_sizes.to(torch.int64)
    ends = torch.cumsum(sizes, 0)
    offsets = ends - sizes
    row = torch.arange(N, device=xs.device)
    expert = torch.searchsorted(ends, row, right=True)          # may be E
    expert_c = expert.clamp(max=E - 1)
    slot = row - offsets[expert_c]
    # scatter into a flat (E*C + 1, D) buffer: writes the reference drops
    # land on the last row, which is not part of the bins
    keep = (expert < E) & (slot < C)
    dst = torch.where(keep, expert_c * C + slot,
                      torch.full_like(slot, E * C))
    flat = torch.zeros((E * C + 1, D), dtype=xs.dtype, device=xs.device)
    flat[dst] = xs
    y = gmm_capacity(flat[:E * C].view(E, C, D), w)
    return y[expert_c, slot.clamp(max=C - 1)]
