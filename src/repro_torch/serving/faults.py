"""Numerical sentinel of the SD round (from ``repro.serving.faults``; the
rest of that module serves the continuous scheduler, a later slice)."""
from __future__ import annotations

import torch


def logits_finite(logits: torch.Tensor) -> torch.Tensor:
    """Per-row finite check on raw verify logits: (B, W, V) → (B,) bool.

    A row is healthy iff EVERY logit it produced this round is finite.  It
    must read the raw logits, not probabilities: the greedy
    ``probs_from_logits`` path is ``one_hot(argmax)``, and argmax over an
    all-NaN row still returns a valid index."""
    return torch.isfinite(logits).reshape(logits.shape[0], -1).all(-1)
