"""Port's ``core/analytics.py`` against the reference, CPU.

Mirrors the seven tests of tests/test_analytics.py (the paper's Eqs. 5-11
against Monte-Carlo and their proven monotonicities) on the port's copy,
and holds every port function to the reference's on the same draws: exact
(``==``) for the closed forms, since both are the same numpy expressions.
"""
import numpy as np
import pytest
from _hypothesis_compat import given, settings, st

from repro.core import analytics as ref
from repro.serving.scheduler import StepReport as RefStepReport
from repro_torch.core.analytics import (
    activation_threshold, admission_work, expected_accepted_len,
    expected_activated_experts, fault_recovery_summary,
    mean_tokens_per_expert, occupancy_timeline, predicted_decay_speedup,
    roofline_response, sigma_from_alpha)
from repro_torch.serving.scheduler import StepReport

pytestmark = pytest.mark.tier1


def _same(a, b):
    """Exact equality of two numpy results (scalars or arrays)."""
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@settings(max_examples=25, deadline=None)
@given(st.integers(4, 128), st.integers(1, 8), st.integers(1, 256),
       st.integers(0, 10_000))
def test_activated_experts_matches_simulation(E, K, t, seed):
    """Eq. 8 vs Monte-Carlo of uniform top-K routing; the port's value is
    the reference's exactly."""
    if K > E:
        K = E
    rng = np.random.default_rng(seed)
    trials = 400
    counts = np.zeros(trials)
    for i in range(trials):
        active = set()
        for _ in range(t):
            active.update(rng.choice(E, size=K, replace=False))
        counts[i] = len(active)
    pred = expected_activated_experts(t, E, K)
    _same(pred, ref.expected_activated_experts(t, E, K))
    se = counts.std() / np.sqrt(trials) + 1e-9
    assert abs(counts.mean() - pred) < max(6 * se, 0.05 * E + 1.0)


@settings(max_examples=50, deadline=None)
@given(st.floats(0.01, 0.99), st.floats(0.01, 0.99), st.integers(2, 512))
def test_tokens_per_expert_monotone_in_rho(rho1, rho2, t):
    """Appendix B: T̄_exp(t; rho) increases with rho for t > 1."""
    lo, hi = sorted((rho1, rho2))
    for rho in (lo, hi):
        _same(mean_tokens_per_expert(t, rho),
              ref.mean_tokens_per_expert(t, rho))
    if hi - lo < 1e-6:
        return
    assert mean_tokens_per_expert(t, lo) <= mean_tokens_per_expert(t, hi) + 1e-9


def test_tokens_per_expert_dense_limit():
    assert mean_tokens_per_expert(37, 1.0) == 37
    t = np.arange(0, 300)
    for rho in (1.0, 0.5, 0.125, 0.0625):
        _same(mean_tokens_per_expert(t, rho), ref.mean_tokens_per_expert(t, rho))


@settings(max_examples=50, deadline=None)
@given(st.floats(0.02, 0.9), st.floats(0.5, 0.99))
def test_threshold_saturates(rho, tau):
    """Eq. 9: at T_thres, N(t) >= tau*E; below it, not yet."""
    E = 1000
    K = rho * E
    T = activation_threshold(rho, tau)
    assert T == ref.activation_threshold(rho, tau)
    assert expected_activated_experts(T, E, K) >= tau * E - 1e-6
    if T > 1:
        assert expected_activated_experts(T - 1, E, K) < tau * E + 1e-6


@settings(max_examples=40, deadline=None)
@given(st.floats(10, 400), st.floats(1.001, 2.0))
def test_roofline_response_c1_continuous(knee, s):
    """Eq. 11: G is continuous with continuous first derivative at the knee."""
    eps = 1e-4
    ts = np.array([knee - 2 * eps, knee - eps, knee + eps, knee + 2 * eps])
    _same(roofline_response(ts, knee, s), ref.roofline_response(ts, knee, s))
    below = roofline_response(knee - eps, knee, s)
    above = roofline_response(knee + eps, knee, s)
    assert abs(above - below) < 1e-2 * max(below, 1.0)
    d_below = (roofline_response(knee - eps, knee, s)
               - roofline_response(knee - 2 * eps, knee, s)) / eps
    d_above = (roofline_response(knee + 2 * eps, knee, s)
               - roofline_response(knee + eps, knee, s)) / eps
    assert abs(d_above - d_below) < 2e-2 * max(abs(d_below), 1e-3)


def test_roofline_linear_beyond_knee():
    g1 = roofline_response(300, 100, 1.05)
    g2 = roofline_response(400, 100, 1.05)
    g3 = roofline_response(500, 100, 1.05)
    assert abs((g3 - g2) - (g2 - g1)) < 1e-9
    _same([g1, g2, g3], [ref.roofline_response(t, 100, 1.05)
                         for t in (300, 400, 500)])


@settings(max_examples=30, deadline=None)
@given(st.floats(0.0, 1.0), st.integers(1, 8))
def test_sigma_bounds(alpha, gamma):
    s = sigma_from_alpha(alpha, gamma)
    _same(s, ref.sigma_from_alpha(alpha, gamma))
    _same(expected_accepted_len(alpha, gamma),
          ref.expected_accepted_len(alpha, gamma))
    assert 1 / (gamma + 1) - 1e-9 <= s <= 1.0 + 1e-9


# ----------------------------------------- stream summaries vs reference
def _steps(cls, seed):
    """A random continuous stream's StepReports (live, gamma, committed,
    admissions and resilience fields), the same draws for both classes."""
    rng = np.random.default_rng(seed)
    steps = []
    for i in range(40):
        live = int(rng.integers(0, 9))
        steps.append(cls(i, live, int(rng.choice([0, 2, 4, 8])),
                         bool(rng.integers(0, 2)), int(rng.integers(0, 20)),
                         int(rng.integers(0, 3)), int(rng.integers(0, 3)),
                         float(rng.uniform(0, 0.1)), int(rng.integers(0, 4)),
                         int(rng.integers(0, 200)),
                         preempted=int(rng.integers(0, 2) * rng.integers(0, 3)),
                         faults=int(rng.random() < 0.1),
                         timeouts=int(rng.random() < 0.1),
                         deferred=int(rng.random() < 0.2)))
    return steps


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stream_summaries_match_reference(seed):
    """occupancy_timeline, admission_work, predicted_decay_speedup and
    fault_recovery_summary equal the reference's on the same stream."""
    steps, rsteps = _steps(StepReport, seed), _steps(RefStepReport, seed)
    live = [s.live for s in steps]
    committed = [s.committed for s in steps]
    assert occupancy_timeline(live, committed) == \
        ref.occupancy_timeline(live, committed)
    assert occupancy_timeline([]) == ref.occupancy_timeline([])
    shapes = [(int(t), int(r)) for t, r in
              np.random.default_rng(seed).integers(1, 64, (12, 2))]
    assert admission_work(shapes, 8, 256) == ref.admission_work(shapes, 8, 256)

    def fn(b, g):
        return 1.0 + 0.1 * g / (b + 1)

    gammas = [s.gamma for s in steps]
    mine = predicted_decay_speedup(live, gammas, fn, committed)
    theirs = ref.predicted_decay_speedup(live, gammas, fn, committed)
    _same(mine["per_round"], theirs["per_round"])
    assert (mine["mean"], mine["token_weighted"]) == \
        (theirs["mean"], theirs["token_weighted"])
    assert fault_recovery_summary(steps) == ref.fault_recovery_summary(rsteps)
