"""Port's cost model (``core/simulator.py``, ``core/perf_model.py``,
``core/autotune.py``) against the reference, CPU.

Mirrors the nine tests of tests/test_perf_model.py on the ``V5E`` record,
each also holding the port's numbers to the reference's on the same inputs
(1e-12 relative, or exact where both run the same expressions), and runs
the paper's trends on the port's own ``H100`` record.  ``SpeedupModel.fit``
with the same seed, frame and restarts gives the reference's parameters to
1e-9 relative.
"""
import dataclasses

import numpy as np
import pytest

from _torch_parity import port_config
from repro.configs.registry import draft_for as ref_draft_for
from repro.configs.registry import get_config as ref_get_config
from repro.core import autotune as ref_autotune
from repro.core import perf_model as ref_pm
from repro.core import simulator as ref_sim
from repro_torch.configs.registry import draft_for, get_config
from repro_torch.core.analytics import (expected_activated_experts,
                                        sigma_from_alpha)
from repro_torch.core.autotune import AutoTuner
from repro_torch.core.perf_model import (Measurement, SpeedupModel,
                                         stride_sample)
from repro_torch.core.simulator import H100, V5E, Hardware, Simulator

pytestmark = pytest.mark.tier1

TARGET = get_config("qwen2-57b-a14b")
DRAFT = get_config("qwen2-0.5b")
REF_TARGET = ref_get_config("qwen2-57b-a14b")
REF_DRAFT = ref_get_config("qwen2-0.5b")
RTOL = 1e-12
FIT_RTOL = 1e-9


def _close(a, b, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=rtol, atol=0)


def _frame(sim, target, draft, gammas=(2, 4), Ks=(1, 2, 4, 8, 16, 32),
           alpha=0.8, cls=Measurement, sigma=sigma_from_alpha):
    batches = [1, 2, 4, 8, 12, 16, 20, 24, 28, 32, 40, 48, 56, 64, 80, 100,
               128, 192, 256]
    rows = []
    for K in Ks:
        t = target.with_overrides(num_experts_per_tok=K)
        for g in gammas:
            s = float(sigma(alpha, g))
            for b in batches:
                rows.append(cls(b, g, K, target.num_experts, s,
                                sim.sd_speedup(t, draft, b, g, s)))
    return rows


def _ref_frame(**kw):
    from repro.core.analytics import sigma_from_alpha as ref_sigma
    return _frame(ref_sim.Simulator(), REF_TARGET, REF_DRAFT,
                  cls=ref_pm.Measurement, sigma=ref_sigma, **kw)


def _arrays(rows):
    return tuple(np.array([getattr(r, f) for r in rows]) for f in
                 ("batch", "gamma", "top_k", "num_experts", "sigma",
                  "speedup"))


# ------------------------------------------------------------ the mirrors
def test_ridge_point():
    assert abs(V5E.ridge_point - 197e12 / 819e9) < 1e-6
    assert dataclasses.asdict(V5E) == dataclasses.asdict(ref_sim.V5E)
    assert V5E.ridge_point == ref_sim.V5E.ridge_point


def _trends(sim, target, draft):
    """(peak batch, (lowest, highest) batch of the window) per K, and the
    curves."""
    sigma = float(sigma_from_alpha(0.8, 4))
    batches = [1, 2, 4, 8, 16, 24, 32, 48, 64, 96, 128, 256, 512, 1024, 2048]
    peaks, windows, curves = {}, {}, {}
    for K in (32, 8, 2):
        t = target.with_overrides(num_experts_per_tok=K)
        curve = [sim.sd_speedup(t, draft, b, 4, sigma) for b in batches]
        i = int(np.argmax(curve))
        assert 0 < i < len(batches) - 1, (K, curve)   # interior peak
        thr = curve[i] / np.sqrt(2)
        win = [b for b, s in zip(batches, curve) if s >= thr]
        peaks[K] = batches[i]
        windows[K] = (min(win), max(win))
        curves[K] = curve
    return peaks, windows, curves


def test_simulator_paper_trends():
    """(1) speedup rises then falls with batch; (2) the peak batch moves
    right and the >= peak/sqrt(2) window widens as the MoE gets sparser;
    the curves equal the reference's."""
    peaks, windows, curves = _trends(Simulator(V5E), TARGET, DRAFT)
    span = {K: hi - lo for K, (lo, hi) in windows.items()}
    assert peaks[2] >= peaks[8] >= peaks[32]
    assert span[2] >= span[8]            # batch-range span of the plateau
    sigma = float(sigma_from_alpha(0.8, 4))
    rs = ref_sim.Simulator()
    batches = [1, 2, 4, 8, 16, 24, 32, 48, 64, 96, 128, 256, 512, 1024, 2048]
    for K, curve in curves.items():
        t = REF_TARGET.with_overrides(num_experts_per_tok=K)
        _close(curve, [rs.sd_speedup(t, REF_DRAFT, b, 4, sigma)
                       for b in batches])


def test_target_efficiency_tracks_speedup():
    sim = Simulator(V5E)
    sigma = float(sigma_from_alpha(0.8, 4))
    batches = [4, 16, 64, 256]
    eff = [sim.target_efficiency(TARGET, b, 4) for b in batches]
    spd = [sim.sd_speedup(TARGET, DRAFT, b, 4, sigma) for b in batches]
    assert np.corrcoef(eff, spd)[0, 1] > 0.9
    rs = ref_sim.Simulator()
    _close(eff, [rs.target_efficiency(REF_TARGET, b, 4) for b in batches])
    _close(spd, [rs.sd_speedup(REF_TARGET, REF_DRAFT, b, 4, sigma)
                 for b in batches])


def test_fit_recovers_simulator():
    """The fit recovers the simulator, and the port's fit (same seed, frame
    and restarts) lands on the reference's parameters."""
    rows = _frame(Simulator(V5E), TARGET, DRAFT)
    ref_rows = _ref_frame()
    np.testing.assert_allclose(_arrays(rows)[5], _arrays(ref_rows)[5],
                               rtol=RTOL, atol=0)
    model = SpeedupModel(hw=V5E, engine_semantics=True)
    res = model.fit(stride_sample(rows, 21), TARGET, DRAFT, n_restarts=6)
    assert res["mse"] < 1.0                      # paper's own fits are ~1.5
    B, G, K, E, S, Y = _arrays(rows)
    pred = model.predict(B, G, K, E, S)
    assert np.corrcoef(pred, Y)[0, 1] > 0.7
    ref_model = ref_pm.SpeedupModel(engine_semantics=True)
    ref_res = ref_model.fit(ref_pm.stride_sample(ref_rows, 21), REF_TARGET,
                            REF_DRAFT, n_restarts=6)
    _close(model.params, ref_model.params, FIT_RTOL)
    _close(res["mse"], ref_res["mse"], FIT_RTOL)
    _close(pred, ref_model.predict(B, G, K, E, S), FIT_RTOL)


def test_fit_bounds_respected():
    model = SpeedupModel(hw=V5E)
    rows = stride_sample(_frame(Simulator(V5E), TARGET, DRAFT), 15)
    res = model.fit(rows, TARGET, DRAFT, n_restarts=3)
    p = res["params"]
    lo, hi = model.bounds(TARGET, DRAFT, 1e-3)
    ref_lo, ref_hi = ref_pm.SpeedupModel().bounds(REF_TARGET, REF_DRAFT, 1e-3)
    _close(lo, ref_lo)
    _close(hi, ref_hi)
    x = np.array([p[k] for k in
                  ("bias", "k1", "k2", "k3", "draft_bias", "draft_k",
                   "reject_bias", "reject_k", "lam", "s")])
    assert (x >= lo - 1e-12).all() and (x <= hi + 1e-12).all()
    assert 0.2 <= p["lam"] <= 1.0 and 1.0 <= p["s"] <= 2.0
    ref_model = ref_pm.SpeedupModel()
    ref_model.fit(ref_pm.stride_sample(_ref_frame(), 15), REF_TARGET,
                  REF_DRAFT, n_restarts=3)
    _close(x, ref_model.params, FIT_RTOL)


P = np.array([1.0, 0.5, 2.0, 1.5, 0.1, 0.05, 0.01, 0.001, 0.5, 1.2])


def test_dispatch_cost_gmm_cheaper_than_onehot():
    """T_target under gmm (K-sparse) dispatch is cheaper than onehot
    (E-dense) for E > K, the gap widens with E, and every number equals
    the reference's."""
    model, ref_model = SpeedupModel(hw=V5E), ref_pm.SpeedupModel()
    K, t = 2.0, 40.0
    gaps = []
    for E in (2, 4, 8, 16, 64):
        t_gmm = float(model.target_time(t, K, E, dispatch="gmm", params=P))
        t_onehot = float(model.target_time(t, K, E, dispatch="onehot",
                                           params=P))
        _close([t_gmm, t_onehot],
               [ref_model.target_time(t, K, E, dispatch=d, params=P)
                for d in ("gmm", "onehot")])
        if E == K:
            assert abs(t_gmm - t_onehot) < 1e-9       # dense MoE: same cost
        else:
            assert t_gmm < t_onehot
        gaps.append(t_onehot - t_gmm)
    assert all(b > a for a, b in zip(gaps, gaps[1:]))  # monotone in E
    args = (np.array([8.0]), np.array([4.0]), np.array([2.0]),
            np.array([64.0]), np.array([0.8]))
    sd = {d: SpeedupModel(hw=V5E, dispatch=d).compute_speedup(P, *args)
          for d in ("gmm", "onehot")}
    assert not np.allclose(sd["gmm"], sd["onehot"])
    for d in sd:
        _close(sd[d], ref_pm.SpeedupModel(dispatch=d).compute_speedup(P, *args))


def test_prefetch_overlap_pricing():
    """Draft-phase expert warming discounts only the verify call's k2
    term; onehot is untouched; speedup rises with the hit rate; every
    number equals the reference's."""
    model = SpeedupModel(hw=V5E, dispatch="gmm")
    ref_model = ref_pm.SpeedupModel(dispatch="gmm")
    K, E, t = 2.0, 64.0, 40.0
    hits = (0.0, 0.3, 0.7, 1.0)
    times = [float(model.target_time(t, K, E, params=P, prefetch_hit_rate=h))
             for h in hits]
    _close(times, [ref_model.target_time(t, K, E, params=P,
                                         prefetch_hit_rate=h) for h in hits])
    assert all(b < a for a, b in zip(times, times[1:]))
    expect_gap = P[2] * float(expected_activated_experts(t, E, K))
    assert times[0] - times[-1] == pytest.approx(expect_gap)
    cold = float(model.target_time(t, K, E, params=P, dispatch="onehot",
                                   prefetch_hit_rate=0.0))
    warm = float(model.target_time(t, K, E, params=P, dispatch="onehot",
                                   prefetch_hit_rate=0.9))
    assert cold == warm
    args = (np.array([8.0]), np.array([4.0]), np.array([K]),
            np.array([E]), np.array([0.8]))
    spd = [float(SpeedupModel(hw=V5E, dispatch="gmm", prefetch_hit_rate=h)
                 .compute_speedup(P, *args)[0]) for h in (0.0, 0.5, 1.0)]
    assert spd[0] < spd[1] < spd[2]
    _close(spd, [float(ref_pm.SpeedupModel(dispatch="gmm",
                                           prefetch_hit_rate=h)
                       .compute_speedup(P, *args)[0])
                 for h in (0.0, 0.5, 1.0)])


def test_stride_sample_counts():
    rows = list(range(228))
    for m in (10, 21, 57):
        got = stride_sample(rows, m)
        assert len(got) >= m // 2  # ceil semantics as in Appendix C.2
        assert got == ref_pm.stride_sample(rows, m)


def test_autotuner_prefers_moderate_batch():
    at = AutoTuner(TARGET, DRAFT, alpha=0.8, sim=Simulator(V5E))
    win = at.speedup_window()
    assert win["peak_batch"] > 1
    assert win["peak"] > at.speedup(1, 4)
    g_small, _ = at.best_gamma(2)
    g_mod, _ = at.best_gamma(win["peak_batch"])
    assert g_mod >= g_small                      # more free verification slack
    ref_win = ref_autotune.AutoTuner(REF_TARGET, REF_DRAFT,
                                     alpha=0.8).speedup_window()
    assert (win["peak_batch"], win["window"]) == \
        (ref_win["peak_batch"], ref_win["window"])
    _close(list(win["curve"].values()), list(ref_win["curve"].values()))


# ------------------------------------------------------- the H100 record
def test_h100_ridge_point():
    """Data-sheet peaks: 989 TFLOP/s bf16 over 3.35 TB/s; the port's
    Simulator, SpeedupModel and AutoTuner default to it."""
    assert H100.name == "h100-sxm5-80gb"
    assert abs(H100.ridge_point - 989e12 / 3.35e12) < 1e-6
    assert Simulator().hw is H100 and SpeedupModel().hw is H100
    assert AutoTuner(TARGET, DRAFT).sim.hw is H100
    # the efficiencies are the reference's, not fitted
    assert (H100.compute_eff, H100.mem_eff, H100.op_overhead) == \
        (V5E.compute_eff, V5E.mem_eff, V5E.op_overhead)


def test_h100_simulator_paper_trends():
    """On the H100 record: an interior peak for every K, and the peak and
    the window move right as the MoE gets sparser (both window edges).
    Unlike V5E, the window's batch-range SPAN does not widen from K 8 to
    K 2 on this grid: both upper edges sit at 256 while the lower edge
    moves from 8 to 32 (spans 248 and 224)."""
    peaks, windows, _ = _trends(Simulator(H100), TARGET, DRAFT)
    assert peaks[2] >= peaks[8] >= peaks[32]
    for lo_k, hi_k in ((8, 32), (2, 8)):
        assert windows[lo_k][0] >= windows[hi_k][0]
        assert windows[lo_k][1] >= windows[hi_k][1]
    assert windows == {32: (2, 128), 8: (8, 256), 2: (32, 256)}


# ------------------------------------- every priced path vs the reference
REF_ARCHS = ("qwen2-57b-a14b", "qwen2-0.5b", "qwen2-7b", "mixtral-8x7b",
             "qwen3-moe-30b-a3b", "jamba-v0.1-52b", "minicpm3-4b",
             "xlstm-1.3b", "gemma3-12b", "whisper-base")


@pytest.mark.parametrize("arch", REF_ARCHS)
def test_simulator_prices_match_reference(arch):
    """forward_time, forward_costs (inference and train), sd_round_time,
    reject_time, sd_speedup and target_efficiency on V5E equal the
    reference's for every layer kind (attn, swa, mla, mamba, mlstm, slstm,
    encoder-decoder) — configs the port cannot serve yet are priced from
    the reference's fields."""
    rcfg = ref_get_config(arch)
    cfg = port_config(rcfg)
    rdraft = ref_draft_for(rcfg)
    draft = port_config(rdraft)
    sim, rs = Simulator(V5E), ref_sim.Simulator()
    offload = Simulator(V5E, expert_offload_bw=64e9)
    roff = ref_sim.Simulator(expert_offload_bw=64e9)
    for b in (1, 8, 64):
        for s in (1, 5):
            _close(sim.forward_time(cfg, b, s), rs.forward_time(rcfg, b, s))
            _close(sim.forward_time(cfg, b, s, context_len=4096),
                   rs.forward_time(rcfg, b, s, context_len=4096))
            _close(offload.forward_time(cfg, b, s),
                   roff.forward_time(rcfg, b, s))
            for train in (False, True):
                mine = sim.forward_costs(cfg, b, s, train=train)
                theirs = rs.forward_costs(rcfg, b, s, train=train)
                _close([mine["flops"], mine["bytes"]],
                       [theirs["flops"], theirs["bytes"]])
        for g in (1, 4):
            mine = sim.sd_round_time(cfg, draft, b, g)
            theirs = rs.sd_round_time(rcfg, rdraft, b, g)
            _close([mine[k] for k in sorted(mine)],
                   [theirs[k] for k in sorted(theirs)])
            _close(sim.sd_speedup(cfg, draft, b, g, 0.6),
                   rs.sd_speedup(rcfg, rdraft, b, g, 0.6))
            _close(sim.target_efficiency(cfg, b, g),
                   rs.target_efficiency(rcfg, b, g))
    _close(sim.forward_costs(cfg, 4, 512, context_len=512)["flops"],
           rs.forward_costs(rcfg, 4, 512, context_len=512)["flops"])


def test_serving_prices_match_reference():
    """admission_time, prefix_admission_time, paged_extend_traffic_time
    (kernel and gather), the EP pricing functions and predict_decay equal
    the reference's for one parameter set."""
    model, ref_model = SpeedupModel(hw=V5E, params=P), \
        ref_pm.SpeedupModel(params=P)
    rows, toks = np.array([1, 2, 4, 8]), np.array([16, 64, 256, 1024])
    _close(model.admission_time(rows, toks, 8, 64),
           ref_model.admission_time(rows, toks, 8, 64))
    _close(model.prefix_admission_time(rows, toks, 48, 8, 64),
           ref_model.prefix_admission_time(rows, toks, 48, 8, 64))
    for mode in ("kernel", "gather"):
        _close(model.paged_extend_traffic_time(rows, toks, 32, 64, 4, 128,
                                               n_layers=28, mode=mode),
               ref_model.paged_extend_traffic_time(rows, toks, 32, 64, 4, 128,
                                                   n_layers=28, mode=mode))
    with pytest.raises(ValueError, match="mode must be"):
        model.paged_extend_traffic_time(1, 1, 1, 1, 1, 1, mode="dense")
    for ep in (1, 2, 8):
        _close(model.ep_a2a_time(toks, 8, 3584, ep, n_layers=28,
                                 overlap_time=1e-4),
               ref_model.ep_a2a_time(toks, 8, 3584, ep, n_layers=28,
                                     overlap_time=1e-4))
        _close(model.ep_target_time(toks, 8, 64, ep, 3584, n_moe_layers=28),
               ref_model.ep_target_time(toks, 8, 64, ep, 3584,
                                        n_moe_layers=28))
    live, gammas = [8, 8, 6, 3, 1], [4, 4, 2, 0, 0]
    mine = model.predict_decay(live, gammas, 8, 64, 0.6, committed=[9, 9, 5,
                                                                     3, 1])
    theirs = ref_model.predict_decay(live, gammas, 8, 64, 0.6,
                                     committed=[9, 9, 5, 3, 1])
    _close(mine["per_round"], theirs["per_round"])
    _close([mine["mean"], mine["token_weighted"]],
           [theirs["mean"], theirs["token_weighted"]])


def test_autotuner_plans_match_reference():
    """plan, best_gamma, the alpha EMA and the predict= hook give the
    reference's decisions on V5E."""
    at = AutoTuner(TARGET, DRAFT, alpha=0.7, sim=Simulator(V5E))
    rt = ref_autotune.AutoTuner(REF_TARGET, REF_DRAFT, alpha=0.7)
    assert at.gammas == rt.gammas == (1, 2, 3, 4, 5, 6, 8)
    for obs in (0.0, 0.0, 0.9, 0.1, 0.0):
        for b in (1, 2, 4, 8, 16, 64, 256):
            mine, theirs = at.plan(b), rt.plan(b)
            assert (mine["use_sd"], mine["gamma"]) == \
                (theirs["use_sd"], theirs["gamma"])
            _close(mine["predicted_speedup"], theirs["predicted_speedup"])
        at.update_alpha(obs)
        rt.update_alpha(obs)
        _close(at.alpha, rt.alpha)
    fitted = SpeedupModel(hw=V5E, params=P, engine_semantics=True)
    ref_fitted = ref_pm.SpeedupModel(params=P, engine_semantics=True)
    at.predict, rt.predict = fitted.predict, ref_fitted.predict
    for b in (1, 8, 64):
        _close(at.best_gamma(b)[1], rt.best_gamma(b)[1])
        assert at.best_gamma(b)[0] == rt.best_gamma(b)[0]


def test_h100_plans_for_the_port_configs():
    """On the H100 record, every target the port registers has a speedup
    window and a plan (finite, gamma from the tuner's range)."""
    for arch in ("qwen2-57b-a14b", "qwen2-7b", "mixtral-8x7b",
                 "qwen3-moe-30b-a3b"):
        cfg = get_config(arch)
        at = AutoTuner(cfg, draft_for(cfg), alpha=0.7)
        win = at.speedup_window()
        assert win["window"] is not None and np.isfinite(win["peak"])
        for b in (1, 8, 64):
            plan = at.plan(b)
            assert plan["gamma"] in at.gammas
            assert np.isfinite(plan["predicted_speedup"])
    sim = Simulator()
    assert sim.forward_time(TARGET, 8, 1) < Simulator(V5E).forward_time(
        TARGET, 8, 1)


def test_hardware_record_is_a_copy():
    """The port's Hardware has the reference's fields and defaults."""
    assert [f.name for f in dataclasses.fields(Hardware)] == \
        [f.name for f in dataclasses.fields(ref_sim.Hardware)]
    assert dataclasses.asdict(Hardware()) == \
        dataclasses.asdict(ref_sim.Hardware())
