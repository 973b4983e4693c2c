"""Algorithm 1 — the paper's fitted SD-speedup model + TRR fitting.

A copy of ``repro.core.perf_model`` (numpy and scipy); the default
``hw`` is the ``H100`` record of ``core/simulator.py``.

  T_target(t) = bias + k1·G(t; λRP, s) + k2·N(t) + k3·G(T̄_exp(t); λRP, s)
  T_draft(t)  = draft_bias + draft_k·G(t; λRP, s)
  T_reject(t) = reject_bias + reject_k·t

  Speedup(B, γ, K, E, σ) =
      σ(γ+1) · T_target(B) / (γ·T_draft(B) + T_target(B·γ) + T_reject(B·γ))

Ten relaxation parameters are fitted against measurements with
scipy.optimize.least_squares (Trust Region Reflective) under the physical
bounds of Appendix C.2 — bias/k2/draft_bias bounded by [1×, 5×] the
theoretical minimum load time from hardware constants.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np
from scipy.optimize import least_squares

from repro_torch.configs.base import ModelConfig
from repro_torch.core.analytics import (
    expected_activated_experts,
    mean_tokens_per_expert,
    predicted_decay_speedup,
    roofline_response,
)
from repro_torch.core.simulator import H100, Hardware

def ep_a2a_bytes(tokens: int, top_k: int, d_model: int, ep_degree: int,
                 *, dtype_bytes: int = 2) -> float:
    """Per-device all-to-all volume of one EP MoE layer: each routed copy
    crosses the interconnect twice (dispatch + combine), N·K·d·2·bytes
    total, split over ep_degree devices (``repro.distributed.collectives``'s
    function, copied until expert parallelism is ported)."""
    if ep_degree <= 1:
        return 0.0
    return 2.0 * tokens * top_k * d_model * dtype_bytes / ep_degree


PARAM_NAMES = ("bias", "k1", "k2", "k3", "draft_bias", "draft_k",
               "reject_bias", "reject_k", "lam", "s")


@dataclass
class Measurement:
    """One row of Alg. 1's measurement input M_i."""
    batch: int
    gamma: int
    top_k: int
    num_experts: int
    sigma: float
    speedup: float


@dataclass
class SpeedupModel:
    """``engine_semantics=False`` is the paper-faithful Alg. 1 (verify = B*gamma
    tokens, gamma draft forwards); True matches our engine (B*(gamma+1) verify
    tokens, gamma+1 draft forwards — the last draft forward only writes KV).

    ``dispatch`` selects the FFN cost regime priced by T_target:
      * "gmm"    — sparse grouped matmul (serving default): k2 scales with
                   N(t) activated experts, k3 with the per-ACTIVATED-expert
                   token response T̄_exp(t).
      * "onehot" — dense one-hot dispatch: every token runs through all E
                   experts, so k2 scales with E regardless of t and each
                   expert sees the full t tokens — the E/K× FLOP overhead
                   the ragged serving kernels remove.

    ``prefetch_hit_rate`` prices draft-phase expert warming (the prefetch
    proposer, core/prefetch.py): the k2 term is the expert-weight LOAD cost
    per activated expert, and a warmed expert's load was already streamed
    during the propose phase, so the VERIFY pass pays k2 · N(t) · (1 - h)
    where h is the measured hit rate.  Only the verify call benefits — the
    AR baseline has no propose phase to hide loads in — and only under the
    gmm regime (onehot reads every expert as part of the dense GEMM, there
    is no separable load to hide).
    """
    hw: Hardware = H100                 # the reference defaults to V5E
    params: np.ndarray | None = None
    engine_semantics: bool = False
    dispatch: str = "gmm"
    prefetch_hit_rate: float = 0.0

    # ------------------------------------------------------------ components
    def _terms(self, p: np.ndarray, dispatch: str | None = None):
        (bias, k1, k2, k3, draft_bias, draft_k, reject_bias, reject_k,
         lam, s) = p
        knee = lam * self.hw.ridge_point
        dispatch = self.dispatch if dispatch is None else dispatch

        def T_target(t, K, E, hit_rate=0.0):
            if dispatch == "onehot":
                n = E * np.ones_like(np.asarray(t, np.float64))
                t_exp = np.asarray(t, np.float64)
                k2_eff = k2                     # dense GEMM: no hidden loads
            else:
                n = expected_activated_experts(t, E, K)
                t_exp = mean_tokens_per_expert(t, K / E)
                k2_eff = k2 * (1.0 - np.clip(hit_rate, 0.0, 1.0))
            return (bias + k1 * roofline_response(t, knee, s)
                    + k2_eff * n + k3 * roofline_response(t_exp, knee, s))

        def T_draft(t):
            return draft_bias + draft_k * roofline_response(t, knee, s)

        def T_reject(t):
            return reject_bias + reject_k * t

        return T_target, T_draft, T_reject

    def target_time(self, t, top_k, num_experts, *, dispatch: str | None = None,
                    params: np.ndarray | None = None,
                    prefetch_hit_rate: float | None = None):
        """Predicted T_target(t) under a dispatch mode.

        Lets serving code compare the onehot (E-dense) and gmm (K-sparse)
        FFN regimes — and, via ``prefetch_hit_rate`` (default: the model's
        own), how much of the expert-load term draft-phase warming hides —
        with one fitted parameter set.
        """
        p = self.params if params is None else np.asarray(params, np.float64)
        assert p is not None, "fit() first or pass params"
        h = self.prefetch_hit_rate if prefetch_hit_rate is None \
            else prefetch_hit_rate
        T_target, _, _ = self._terms(p, dispatch)
        return T_target(np.asarray(t, np.float64),
                        np.asarray(top_k, np.float64),
                        np.asarray(num_experts, np.float64), hit_rate=h)

    def admission_time(self, rows, prompt_tokens, top_k, num_experts, *,
                       dispatch: str | None = None,
                       params: np.ndarray | None = None):
        """Predicted wall time of one admission prefill.

        A prefill forward processes ``rows * prompt_tokens`` tokens through
        the target in one call, so it is priced as
        ``T_target(rows * prompt_tokens)`` — admission work is ∝ ADMITTED
        tokens.  The legacy full-pool path pays
        ``admission_time(pool, global_bucket)`` per refill no matter how
        few rows were actually admitted; the row-sliced path pays
        ``admission_time(admitted, per_admission_bucket)``.  Monotone in
        both arguments, which is what makes the sliced path a strict win.
        """
        t = np.asarray(rows, np.float64) * np.asarray(prompt_tokens,
                                                      np.float64)
        return self.target_time(t, top_k, num_experts, dispatch=dispatch,
                                params=params, prefetch_hit_rate=0.0)

    def prefix_admission_time(self, rows, prompt_tokens, shared_tokens,
                              top_k, num_experts, *,
                              dispatch: str | None = None,
                              params: np.ndarray | None = None):
        """Predicted wall time of one PREFIX-SHARED admission prefill.

        Prefix sharing (serving/scheduler.py, docs/paged_attention.md)
        forks the common prompt prefix's KV pages from a live sibling, so
        the target prefills only the unshared tail: the admission
        processes ``rows * (prompt_tokens - shared_tokens)`` tokens
        (floored at one — the tail always keeps a token to extend with).
        Equal to :meth:`admission_time` at ``shared_tokens = 0``; the gap
        between the two curves is the model-side sharing win
        ``benchmarks/prefix_sweep.py`` holds against measurement.
        """
        tail = np.maximum(np.asarray(prompt_tokens, np.float64)
                          - np.asarray(shared_tokens, np.float64), 1.0)
        return self.admission_time(rows, tail, top_k, num_experts,
                                   dispatch=dispatch, params=params)

    def paged_extend_traffic_time(self, batch, mean_length, max_pages,
                                  page_size, kv_heads, head_dim, *,
                                  n_layers: int = 1, dtype_bytes: int = 2,
                                  mode: str = "kernel"):
        """Lower-bound HBM time of ONE paged decode/verify attention step.

        ``mode="gather"`` prices the dense ``pool[table]`` fallback: every
        extend MATERIALIZES the gathered (B, max_pages*page_size) K/V view
        — read the pages, write the dense copy, read it back inside the
        attention — so traffic scales with the table WIDTH, growing with
        every pool growth even when live contexts are short.
        ``mode="kernel"`` prices the block-table-walking paged kernel
        (kernels/decode_attention): K/V pages stream from the pool exactly
        once and only pages overlapping the live context are touched, so
        traffic scales with ``mean_length`` rounded up to a page.  The
        ratio of the two is the kernel's memory-boundedness headroom at a
        given occupancy — the quantity ``benchmarks/prefix_sweep.py``
        reports alongside the measured extend times.
        """
        if mode not in ("kernel", "gather"):
            raise ValueError(f"mode must be 'kernel' or 'gather', "
                             f"got {mode!r}")
        B = np.asarray(batch, np.float64)
        per_pos = 2.0 * kv_heads * head_dim * dtype_bytes    # K + V
        if mode == "gather":
            positions = float(max_pages) * float(page_size)
            passes = 3.0           # pool read + dense write + attend read
        else:
            positions = np.ceil(np.asarray(mean_length, np.float64)
                                / page_size) * page_size
            passes = 1.0
        return n_layers * B * positions * per_pos * passes / self.hw.hbm_bw

    def ep_a2a_time(self, tokens, top_k, d_model, ep_degree, *,
                    n_layers: int = 1, dtype_bytes: int = 2,
                    overlap_time: float = 0.0):
        """Modeled wall time of an EP MoE layer's all-to-all hops.

        The reference's expert-parallel dispatch
        (``repro.distributed.collectives``) moves each
        routed (token, k) payload across the interconnect twice — dispatch
        to the expert's shard and combine back — so per device the volume
        is ``tokens·K·d_model·2·dtype_bytes / ep_degree`` per MoE layer,
        priced against ``hw.ici_bw``.  ``overlap_time`` is the window of
        independent compute the dispatch is staggered against (the
        shared-expert matmul runs BETWEEN the two hops); the net cost
        clamps at zero when the collective hides entirely.  Returns 0 for
        ``ep_degree <= 1`` (no interconnect crossed).
        """
        toks = np.asarray(tokens, np.float64)
        vol = np.vectorize(
            lambda n: ep_a2a_bytes(float(n), top_k, d_model, ep_degree,
                                   dtype_bytes=dtype_bytes))(toks)
        raw = n_layers * vol / self.hw.ici_bw
        return np.maximum(raw - overlap_time, 0.0)

    def ep_target_time(self, t, top_k, num_experts, ep_degree, d_model, *,
                       n_moe_layers: int = 1, dtype_bytes: int = 2,
                       overlap_time: float = 0.0,
                       params: np.ndarray | None = None):
        """Predicted T_target(t) under expert-parallel sharded serving.

        Splits the fitted gmm-regime target time into its dense part
        (bias + k1·G(t): attention, router, shared experts — replicated
        work, unchanged by EP) and its expert part (k2·n(t) + k3·G(t̄_exp):
        expert weight loads + expert GEMMs — sharded E/ep per device), and
        adds the ``ep_a2a_time`` interconnect term net of overlap.  The
        EP deployment changes neither N(t) nor T̄_exp (§3.4), so the MoESD
        speedup analysis carries over with only this cost relabeling —
        ``benchmarks/ep_sweep.py`` holds the a2a term against measured
        per-phase timings.
        """
        p = self.params if params is None else np.asarray(params, np.float64)
        assert p is not None, "fit() first or pass params"
        (bias, k1, k2, k3, _db, _dk, _rb, _rk, lam, s) = p
        knee = lam * self.hw.ridge_point
        t = np.asarray(t, np.float64)
        dense = bias + k1 * roofline_response(t, knee, s)
        n = expected_activated_experts(t, num_experts, top_k)
        t_exp = mean_tokens_per_expert(t, top_k / num_experts)
        expert = k2 * n + k3 * roofline_response(t_exp, knee, s)
        a2a = self.ep_a2a_time(t, top_k, d_model, ep_degree,
                               n_layers=n_moe_layers,
                               dtype_bytes=dtype_bytes,
                               overlap_time=overlap_time)
        return dense + expert / max(ep_degree, 1) + a2a

    def compute_speedup(self, p: np.ndarray, batch, gamma, top_k,
                        num_experts, sigma):
        """Alg. 1 line 3 — vectorized over measurement arrays."""
        batch = np.asarray(batch, np.float64)
        gamma = np.asarray(gamma, np.float64)
        T_target, T_draft, T_reject = self._terms(p)
        gv = gamma + 1.0 if self.engine_semantics else gamma
        t_ar = T_target(batch, np.asarray(top_k, np.float64),
                        np.asarray(num_experts, np.float64))
        # only the VERIFY call sees warmed experts (hit_rate): the AR
        # baseline above has no draft phase to overlap the loads with
        t_ver = T_target(batch * gv, np.asarray(top_k, np.float64),
                         np.asarray(num_experts, np.float64),
                         hit_rate=self.prefetch_hit_rate)
        t_sd = gv * T_draft(batch) + t_ver + T_reject(batch * gv)
        return np.asarray(sigma, np.float64) * (gamma + 1.0) * t_ar / t_sd

    def predict(self, batch, gamma, top_k, num_experts, sigma):
        assert self.params is not None, "fit() first"
        return self.compute_speedup(self.params, batch, gamma, top_k,
                                    num_experts, sigma)

    def predict_decay(self, live, gammas, top_k, num_experts, sigma,
                      committed=None):
        """Occupancy-decay-aware speedup for a continuous stream.

        ``live``/``gammas`` are per-round arrays (the N(t) trajectory and
        the gammas a continuous scheduler actually planned —
        serving/scheduler.StepReport), ``committed`` the per-round token
        credits used as weights.  Returns ``{"per_round", "mean",
        "token_weighted"}``: the fitted speedup-vs-batch curve walked
        along the measured occupancy decay, with ``token_weighted`` the
        model-side number to hold against a measured continuous-vs-AR
        throughput ratio (see core/analytics.predicted_decay_speedup).
        """
        return predicted_decay_speedup(
            live, gammas,
            lambda b, g: float(self.predict(b, g, top_k, num_experts,
                                            sigma)),
            committed=committed)

    # ---------------------------------------------------------------- bounds
    def bounds(self, target_cfg: ModelConfig, draft_cfg: ModelConfig,
               t_rej_max: float, dtype_bytes: int = 2):
        """Appendix C.2 physically-grounded search bounds."""
        bw = self.hw.hbm_bw
        v_dense = (target_cfg.param_count()
                   - target_cfg.num_experts * 3 * target_cfg.d_model
                   * target_cfg.moe_d_ff
                   * sum(target_cfg.moe_pattern) * target_cfg.num_periods)
        v_dense = max(v_dense, 1)
        bias_min = v_dense * dtype_bytes / bw
        v_exp = 3 * target_cfg.d_model * target_cfg.moe_d_ff \
            * sum(target_cfg.moe_pattern) * target_cfg.num_periods
        k2_min = max(v_exp, 1) * dtype_bytes / bw / max(target_cfg.num_experts, 1)
        db_min = draft_cfg.param_count() * dtype_bytes / bw
        lo = np.array([bias_min, 0.0, k2_min, 0.0, db_min, 0.0,
                       0.0, 0.0, 0.2, 1.0])
        hi = np.array([5 * bias_min, np.inf, 5 * k2_min, np.inf, 5 * db_min,
                       np.inf, t_rej_max, t_rej_max, 1.0, 2.0])
        return lo, hi

    # ------------------------------------------------------------------ fit
    def fit(self, measurements: Sequence[Measurement],
            target_cfg: ModelConfig, draft_cfg: ModelConfig,
            t_rej_max: float = 1e-3, seed: int = 0,
            n_restarts: int = 8) -> dict:
        """Multi-start TRR: the loss surface has local minima, so we restart
        from ``n_restarts`` log-uniform points inside the bounds and keep the
        best solution (the paper fits once on GPU data; simulator data is
        smoother and rewards restarts)."""
        m = measurements
        B = np.array([x.batch for x in m], np.float64)
        G = np.array([x.gamma for x in m], np.float64)
        K = np.array([x.top_k for x in m], np.float64)
        E = np.array([x.num_experts for x in m], np.float64)
        S = np.array([x.sigma for x in m], np.float64)
        Y = np.array([x.speedup for x in m], np.float64)
        lo, hi = self.bounds(target_cfg, draft_cfg, t_rej_max)

        def resid(p):
            return self.compute_speedup(p, B, G, K, E, S) - Y

        rng = np.random.default_rng(seed)
        # scale for unbounded coefficients: draft-model load time is a
        # natural unit for the k's
        unit = lo[4] if lo[4] > 0 else 1e-4
        best = None
        total_nfev = 0
        for r in range(n_restarts):
            x0 = np.empty(10)
            for i in range(10):
                if np.isinf(hi[i]):
                    x0[i] = unit * 10 ** rng.uniform(-3, 1)
                else:
                    x0[i] = lo[i] + rng.uniform(0.05, 0.95) * (hi[i] - lo[i])
            sol = least_squares(resid, x0, bounds=(lo, hi), method="trf",
                                max_nfev=5_000)
            total_nfev += sol.nfev
            if best is None or sol.cost < best.cost:
                best = sol
        self.params = best.x
        mse = float(np.mean(best.fun ** 2))
        return {"params": dict(zip(PARAM_NAMES, best.x)), "mse": mse,
                "cost": float(best.cost), "nfev": total_nfev}


def stride_sample(rows: List[Measurement], m: int) -> List[Measurement]:
    """Appendix C.2 selection: M = df[::stride] with m = ceil(len/stride)."""
    stride = max(1, int(np.ceil(len(rows) / m)))
    return rows[::stride]
