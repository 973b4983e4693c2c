"""Stream analytics (``occupancy_timeline`` of ``repro.core.analytics``; the
rest of that module comes with the AutoTuner slice)."""
from __future__ import annotations

import numpy as np


def occupancy_timeline(live, committed=None):
    """Summarize a continuous stream's live-batch trajectory N(t).

    ``live`` is the per-round active-slot count (``StepReport.live``),
    ``committed`` the tokens credited per round (default: uniform).  Returns
    ``rounds``, ``peak_live``, ``final_live``, ``mean_live`` (each round
    weighted equally), ``token_weighted_live`` (the batch an average token
    was decoded at) and ``mean_occupancy`` (mean over peak)."""
    live = np.asarray(live, dtype=np.float64)
    if live.size == 0:
        return {"rounds": 0, "peak_live": 0.0, "final_live": 0.0,
                "mean_live": 0.0, "token_weighted_live": 0.0,
                "mean_occupancy": 0.0}
    committed = (np.ones_like(live) if committed is None
                 else np.asarray(committed, dtype=np.float64))
    w = committed / max(committed.sum(), 1e-12)
    peak = float(live.max())
    return {
        "rounds": int(live.size),
        "peak_live": peak,
        "final_live": float(live[-1]),
        "mean_live": float(live.mean()),
        "token_weighted_live": float((w * live).sum()),
        "mean_occupancy": float(live.mean() / max(peak, 1.0)),
    }
