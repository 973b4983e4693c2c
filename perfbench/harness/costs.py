"""Peaks of the card and the work of the measured kernels, from shapes alone.

The peaks are NVIDIA's data sheet for one H100 SXM at 700 W (dense rates):
989 TFLOP/s in bf16, 3.35 TB/s of HBM.  A share of a peak is stated
against these, with the card's power limit printed beside it.
"""
from __future__ import annotations

from typing import Iterable, Optional, Tuple

BF16_FLOPS = 989e12
HBM_BYTES_S = 3.35e12


def expert_kernels_least_s(rows: int, spec: dict, experts_active: int,
                           elem: int = 2) -> float:
    """Least time of kernels 1-2 (the fused gate/up product, then down) for
    one MoE layer's forward over ``rows`` tokens: for each kernel the larger
    of its bytes over the HBM rate and its FLOPs over the bf16 peak.

    Bytes count each input and output once: the fused kernel reads the
    sorted rows x (rows * top_k, d), the active experts' gate and up weights
    and the group sizes, and writes h (rows * top_k, f); the down kernel
    reads h, the active experts' down weights and the group sizes, and
    writes (rows * top_k, d).  FLOPs are 2 * n * d * f a product."""
    d, f, E = spec["d"], spec["expert_ff"], spec["experts"]
    n = rows * spec["top_k"]
    sizes = 4 * E
    fused_b = elem * (n * d + 2 * experts_active * d * f + n * f) + sizes
    down_b = elem * (n * f + experts_active * f * d + n * d) + sizes
    fused = max(fused_b / HBM_BYTES_S, 4.0 * n * d * f / BF16_FLOPS)
    down = max(down_b / HBM_BYTES_S, 2.0 * n * f * d / BF16_FLOPS)
    return fused + down


# expected idle experts (uniform routing) under which a forward counts
# every expert active
ALL_ACTIVE_IDLE = 0.01


def expected_idle(rows: int, spec: dict) -> float:
    """Experts a forward of ``rows`` tokens leaves idle on average, each
    token choosing ``top_k`` distinct experts uniformly."""
    E, K = spec["experts"], spec["top_k"]
    return E * (1.0 - K / E) ** rows


def forward_experts_least_s(forwards: Iterable[Tuple[int, Optional[list]]],
                            spec: dict) -> float:
    """Least time of kernels 1-2 over forwards given as (rows, active),
    ``active`` the active experts of each MoE layer, or None for every
    expert."""
    total = 0.0
    for rows, active in forwards:
        counts = active if active is not None \
            else [spec["experts"]] * spec["layers"]
        total += sum(expert_kernels_least_s(rows, spec, a) for a in counts)
    return total


def sequence_flops(prompt: int, out: int, spec: dict, active: int) -> float:
    """Model FLOPs of one request: 2 * active parameters for each of its
    prompt + out positions, plus attention's 4 * head_dim * heads for each
    (query, visible key) pair of every layer (position i sees i + 1
    keys)."""
    L = prompt + out
    pairs = L * (L + 1) / 2
    return (2.0 * active * L
            + spec["layers"] * 4.0 * spec["head_dim"] * spec["heads"] * pairs)


def mfu_percent(requests: Iterable[Tuple[int, int]], spec: dict, active: int,
                seconds: float) -> float:
    """Share of the bf16 peak that the target's model FLOPs of the
    ``(prompt, out)`` requests fill over ``seconds``, in %."""
    flops = sum(sequence_flops(p, o, spec, active) for p, o in requests)
    return 100.0 * flops / (BF16_FLOPS * seconds)


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0-100) by linear interpolation between
    order statistics (numpy's default), of at least one value."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    k = (len(xs) - 1) * q / 100.0
    lo = int(k)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (k - lo)


def token_weighted(live, committed) -> float:
    """The batch an average token was decoded at: rows of each round (or
    wave) weighted by the tokens it committed (``occupancy_timeline``'s
    ``token_weighted_live``)."""
    total = float(sum(committed))
    if total <= 0:
        return 0.0
    return sum(float(n) * c for n, c in zip(live, committed)) / total
