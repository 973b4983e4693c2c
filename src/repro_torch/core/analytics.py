"""Closed-form theory from the paper (Sec. 3.2, Eqs. 6-11, Appendix B).

A copy of ``repro.core.analytics`` (numpy only): the functions the cost
model (``core/simulator.py``, ``core/perf_model.py``), the AutoTuner and
the stream summaries of the serving CLI use.
"""
from __future__ import annotations

import numpy as np


def expected_activated_experts(t, num_experts: int, top_k: int):
    """Eq. 8:  N(t) = E * (1 - ((E-K)/E)^t)  — expected #activated experts
    for t tokens through the gate, i.i.d. uniform routing."""
    t = np.asarray(t, dtype=np.float64)
    E = np.asarray(num_experts, dtype=np.float64)
    K = np.asarray(top_k, dtype=np.float64)
    return E * (1.0 - ((E - K) / E) ** t)


def activation_threshold(rho: float, tau: float = 0.95) -> int:
    """Eq. 9:  T_thres = ceil(log_{1-rho}(1-tau)) — tokens needed so that
    N(t) >= tau * E (near-full expert activation)."""
    if rho >= 1.0:
        return 1
    return int(np.ceil(np.log(1.0 - tau) / np.log(1.0 - rho)))


def mean_tokens_per_expert(t, rho: float):
    """Eq. 10:  T̄_exp(t; rho) = rho * t / (1 - (1-rho)^t) — average tokens
    each *activated* expert processes.  Monotone increasing in rho for t>1
    (Appendix B), hence sparser MoE ⇒ fewer tokens/expert ⇒ more
    memory-bound."""
    t = np.asarray(t, dtype=np.float64)
    rho = np.asarray(rho, dtype=np.float64)
    denom = 1.0 - (1.0 - rho) ** t
    dense = rho >= 1.0
    return np.where(
        t == 0, 0.0,
        np.where(dense, t, rho * t / np.maximum(denom, 1e-300)))


def roofline_response(t, knee: float, s: float):
    """Eq. 11:  G(t; knee, s) — execution-time response to token count.
    Exponential (slow start) below the ridge-point knee, C^1-continuous
    linear beyond it."""
    t = np.asarray(t, dtype=np.float64)
    s = max(float(s), 1.0 + 1e-9)
    below = np.power(s, np.minimum(t, knee))
    above = (s ** knee) * (1.0 + np.log(s) * (t - knee))
    return np.where(t <= knee, below, above)


def sigma_from_alpha(alpha, gamma: int):
    """Eq. 5: sigma = (1 - alpha^(gamma+1)) / ((1 - alpha)(gamma+1))."""
    alpha = np.asarray(alpha, dtype=np.float64)
    safe = np.abs(1.0 - alpha) > 1e-9
    num = np.where(safe, (1.0 - alpha ** (gamma + 1)) / np.where(safe, 1.0 - alpha, 1.0),
                   gamma + 1.0)
    return num / (gamma + 1)


def expected_accepted_len(alpha, gamma: int):
    """S/R = sigma * (gamma + 1): mean tokens committed per SD round."""
    return sigma_from_alpha(alpha, gamma) * (gamma + 1)


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


def admission_work(admit_shapes, pool: int, full_bucket: int):
    """Prefill token-work of a stream's admissions, sliced vs full-pool.

    ``admit_shapes`` is a list of ``(prompt_bucket, rows)`` pairs — one
    per admission prefill, exactly the entries ``SDEngine.admit_trace_log``
    records plus repeats for shape-sharing refills (callers usually pass
    per-round ``StepReport.admit_rows``/``admit_tokens`` reconstructions
    or the raw per-admission shapes).  The sliced path's prefill work is
    ``sum(rows_i * bucket_i)`` — ∝ what was admitted; the legacy full path
    pays ``pool * full_bucket`` per admission regardless.  Returns both
    totals and the fraction of prefill row-tokens the sliced path avoids.
    """
    shapes = [(int(t), int(r)) for t, r in admit_shapes]
    sliced = sum(r * t for t, r in shapes)
    full = len(shapes) * int(pool) * int(full_bucket)
    return {
        "admissions": len(shapes),
        "sliced_tokens": sliced,
        "full_tokens": full,
        "savings": 1.0 - sliced / max(full, 1),
    }


def predicted_decay_speedup(live, gammas, speedup_fn, committed=None):
    """Occupancy-decay-aware predicted speedup for a continuous stream.

    Evaluates ``speedup_fn(batch, gamma)`` (e.g. ``AutoTuner.speedup`` or
    a fitted ``SpeedupModel`` closure) at every round's LIVE batch size —
    the paper's speedup-vs-batch curve walked along the measured N(t)
    trajectory instead of sampled at one static B.  Returns per-round
    predictions plus their committed-token-weighted mean, the model-side
    number a measured continuous-vs-AR throughput ratio should be compared
    against (rounds that committed more tokens matter more).

    gamma=0 rounds (the scheduler's in-session SD→AR handoff) are priced
    at exactly 1.0 — they ARE the AR baseline — so ``speedup_fn`` is never
    called with a gamma its SD formula can't express.
    """
    live = np.asarray(live, dtype=np.float64)
    gammas = np.broadcast_to(np.asarray(gammas, dtype=np.float64),
                             live.shape)
    per_round = np.array(
        [1.0 if int(g) == 0 else float(speedup_fn(int(b), int(g)))
         for b, g in zip(live, gammas)],
        dtype=np.float64)
    if per_round.size == 0:
        return {"per_round": per_round, "mean": 0.0, "token_weighted": 0.0}
    committed = (np.ones_like(per_round) if committed is None
                 else np.asarray(committed, dtype=np.float64))
    w = committed / max(committed.sum(), 1e-12)
    return {"per_round": per_round,
            "mean": float(per_round.mean()),
            "token_weighted": float((per_round * w).sum())}


def fault_recovery_summary(steps):
    """Fault/recovery accounting over one continuous stream's StepReports.

    Pure-numpy reduction of the resilience fields the scheduler threads
    through ``StepReport`` (serving/scheduler.py): totals per disruption
    kind, the fraction of rounds disrupted, and the RECOVERY LATENCY of
    every preemption — the number of rounds from a ``preempted > 0``
    boundary until the next boundary that re-admits a requeued request
    (an ``admitted > 0`` round after it).  Benchmarks plot its mean
    against the injected fault rate (benchmarks/fault_sweep.py); a stream
    whose preemptions never re-admit reports latency ``inf`` — visible,
    not silently dropped.

    Parameters
    ----------
    steps : sequence of StepReport
        One stream's per-round reports, in round order.

    Returns
    -------
    dict
        ``{"rounds", "preempted", "faults", "timeouts", "deferred",
        "disrupted_rounds", "disrupted_fraction",
        "recovery_latency_rounds": [..], "mean_recovery_latency"}``.
    """
    pre = np.asarray([s.preempted for s in steps], np.int64)
    fau = np.asarray([s.faults for s in steps], np.int64)
    tim = np.asarray([s.timeouts for s in steps], np.int64)
    def_ = np.asarray([s.deferred for s in steps], np.int64)
    adm = np.asarray([s.admitted for s in steps], np.int64)
    n = len(pre)
    disrupted = (pre > 0) | (fau > 0) | (tim > 0) | (def_ > 0)
    latencies = []
    for i in np.nonzero(pre > 0)[0]:
        after = np.nonzero(adm[i + 1:] > 0)[0]
        latencies.append(float(after[0] + 1) if after.size else float("inf"))
    return {
        "rounds": int(n),
        "preempted": int(pre.sum()),
        "faults": int(fau.sum()),
        "timeouts": int(tim.sum()),
        "deferred": int(def_.sum()),
        "disrupted_rounds": int(disrupted.sum()),
        "disrupted_fraction": float(disrupted.sum() / max(n, 1)),
        "recovery_latency_rounds": latencies,
        "mean_recovery_latency": (float(np.mean(latencies))
                                  if latencies else 0.0),
    }
