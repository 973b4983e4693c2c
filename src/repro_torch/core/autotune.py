"""Beyond-paper: closed-loop SD auto-tuning from the fitted model.

The paper stops at *explaining* speedup; here the same model drives policy:

  * ``best_gamma(B)``    — γ* = argmax predicted speedup at the current batch
  * ``speedup_window()`` — the batch-size band where predicted speedup stays
                           above x_peak/√2 (the paper's Fig. 4 plateau
                           criterion), i.e. when SD should be ON at all
  * ``plan(B)``          — {use_sd, gamma} decision for the serving engine

Works off either the analytic simulator or a fitted SpeedupModel; the
serving engine re-plans as the admitted batch size changes (engine.py).

A copy of ``repro.core.autotune``; its default simulator prices the
``H100`` record (``core/simulator.py``) where the reference's prices a TPU
v5e.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core.analytics import sigma_from_alpha
from repro_torch.core.simulator import Simulator


@dataclass
class AutoTuner:
    target: ModelConfig
    draft: ModelConfig
    alpha: float = 0.8                 # measured acceptance rate (running est.)
    gammas: tuple = (1, 2, 3, 4, 5, 6, 8)
    sim: Optional[Simulator] = None
    predict: Optional[Callable] = None  # fitted SpeedupModel.predict

    def __post_init__(self):
        if self.sim is None:
            self.sim = Simulator()

    def speedup(self, batch: int, gamma: int, alpha: Optional[float] = None) -> float:
        a = self.alpha if alpha is None else alpha
        sigma = float(sigma_from_alpha(a, gamma))
        if self.predict is not None:
            return float(self.predict(batch, gamma, self.target.num_experts_per_tok,
                                      max(self.target.num_experts, 1), sigma))
        return self.sim.sd_speedup(self.target, self.draft, batch, gamma, sigma)

    def best_gamma(self, batch: int) -> tuple[int, float]:
        best = max(self.gammas, key=lambda g: self.speedup(batch, g))
        return best, self.speedup(batch, best)

    def speedup_window(self, batches=None) -> dict:
        """Fig. 4 analysis: peak batch, peak speedup, and the >= peak/sqrt(2)
        batch window, maximized over gamma per batch."""
        batches = batches if batches is not None else [1, 2, 4, 8, 16, 24, 32,
                                                       48, 64, 96, 128, 192, 256]
        curve = {b: self.best_gamma(b)[1] for b in batches}
        peak_b = max(curve, key=curve.get)
        thresh = curve[peak_b] / np.sqrt(2)
        window = [b for b, s in curve.items() if s >= thresh]
        return {"curve": curve, "peak_batch": peak_b, "peak": curve[peak_b],
                "window": (min(window), max(window)) if window else None}

    def plan(self, batch: int) -> dict:
        g, s = self.best_gamma(batch)
        return {"use_sd": s > 1.0, "gamma": g, "predicted_speedup": s}

    def update_alpha(self, alpha_observed: float, ema: float = 0.9):
        self.alpha = ema * self.alpha + (1 - ema) * alpha_observed
