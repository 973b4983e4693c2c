"""Numerical sentinel and resilience knobs of the SD serving loop (from
``repro.serving.faults``; ``FaultInjector`` and ``poison_cache_row`` are a
later slice)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


def logits_finite(logits: torch.Tensor) -> torch.Tensor:
    """Per-row finite check on raw verify logits: (B, W, V) → (B,) bool.

    A row is healthy iff EVERY logit it produced this round is finite.  It
    must read the raw logits, not probabilities: the greedy
    ``probs_from_logits`` path is ``one_hot(argmax)``, and argmax over an
    all-NaN row still returns a valid index."""
    return torch.isfinite(logits).reshape(logits.shape[0], -1).all(-1)


@dataclass
class ResilienceConfig:
    """Knobs of the continuous scheduler's degradation ladder.  The defaults
    change nothing about a healthy stream.

    ``round_deadline_s``
        Per-round wall-clock deadline; a slower round counts as faulty
        toward the ladder (it is not killed).
    ``max_rounds_per_request``
        Per-request round budget; past it the request finishes
        ``"timeout"``.
    ``free_page_watermark``
        Defer an admission that would leave the paged pool's free fraction
        below this, unless the pool is idle.
    ``max_pool_pages``
        Hard cap on page-pool growth; at the cap, page pressure preempts
        the youngest non-protected slot (recompute requeue).
    ``admit_retries`` / ``admit_backoff_rounds``
        Bounded retry for transient admission failures: attempt ``i``
        requeues ``backoff * 2**(i-1)`` rounds out; past the budget the
        request finishes ``"admit_failed"``.
    ``faulty_rounds_to_ar`` / ``faulty_rounds_to_stop``
        This many CONSECUTIVE faulty rounds (numerical fault, deadline
        overrun, acceptance collapse) force gamma=0 rounds; this many stop
        the stream safely (everything in flight finishes ``"aborted"``).
    ``collapse_alpha``
        An SD round whose acceptance falls below this counts as faulty
        (0 disables).
    ``stall_rounds``
        This many consecutive rounds with admissible work and no progress
        trigger the safe stop.
    """
    round_deadline_s: Optional[float] = None
    max_rounds_per_request: Optional[int] = None
    free_page_watermark: float = 0.0
    max_pool_pages: Optional[int] = None
    admit_retries: int = 3
    admit_backoff_rounds: int = 1
    faulty_rounds_to_ar: int = 2
    faulty_rounds_to_stop: int = 8
    collapse_alpha: float = 0.0
    stall_rounds: int = 512
