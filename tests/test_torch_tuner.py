"""Port's AutoTuner in serving, measured target efficiency, and the configs
the cost model prices, against the reference, CPU.

Mirrors tests/test_serving.py::test_tuner_integration_updates_alpha and
::test_measured_target_efficiency_in_range and
tests/test_scheduler.py::test_tuner_replans_live_count_and_hands_off_to_ar.
Beside them, a real AutoTuner priced on the reference's ``V5E`` record on
both sides drives wave and continuous serving through gamma changes and
SD→AR hand-offs: the port plans the reference's gammas round for round,
ends on its alpha (1e-12 relative) and emits its greedy tokens exactly.
Same weights on both sides (``model_pair``), fp32, TF32 off.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from _torch_parity import model_pair, port_config
from repro.configs.base import ModelConfig
from repro.configs.registry import draft_for as ref_draft_for
from repro.configs.registry import get_config as ref_get_config
from repro.core.autotune import AutoTuner as RefAutoTuner
from repro.core.target_efficiency import (
    measure_target_efficiency as ref_measure_target_efficiency)
from repro.core.target_efficiency import (
    predicted_target_efficiency as ref_predicted_target_efficiency)
from repro.core import simulator as ref_sim
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro_torch.configs.registry import draft_for, get_config
from repro_torch.core.autotune import AutoTuner
from repro_torch.core.simulator import H100, V5E, Simulator
from repro_torch.core.target_efficiency import (measure_target_efficiency,
                                                predicted_target_efficiency)
from repro_torch.launch.serve import make_tuner
from repro_torch.serving.engine import ServingEngine

TCFG = ModelConfig("cs-moe", "moe", 2, 128, 4, 2, 256, 512, num_experts=4,
                   num_experts_per_tok=2, dtype="float32")
DCFG = ModelConfig("cs-draft", "dense", 2, 64, 2, 2, 128, 512,
                   dtype="float32")
RTOL = 1e-12


@pytest.fixture(scope="module")
def models():
    jt, jpt, tt, tpt = model_pair(TCFG, seed=0)
    jd, jpd, td, tpd = model_pair(DCFG, seed=1)
    return (jt, jd, jpt, jpd), (tt, td, tpt, tpd)


def _tuners(alpha=0.7):
    """(port, reference) tuners priced on the full qwen2-57b-a14b config
    and its default draft (as the serving CLIs build them), both on V5E."""
    full, rfull = get_config("qwen2-57b-a14b"), ref_get_config(
        "qwen2-57b-a14b")
    return (AutoTuner(full, draft_for(full), alpha=alpha,
                      sim=Simulator(V5E)),
            RefAutoTuner(rfull, ref_draft_for(rfull), alpha=alpha))


# -------------------------------------------------------- test_serving
def test_tuner_integration_updates_alpha(models):
    """Random-weight pair: the observed alpha ~0 drags the port tuner's
    EMA down from 0.9 (on its default H100 record)."""
    _, (t, d, pt, pd) = models
    tuner = AutoTuner(port_config(TCFG), port_config(DCFG), alpha=0.9)
    assert tuner.sim.hw is H100
    eng = ServingEngine(t, d, pt, pd, max_batch=4, tuner=tuner, force_sd=True)
    for _ in range(4):
        eng.submit(np.arange(3, 11), max_new_tokens=6)
    (report,) = eng.run()
    assert tuner.alpha < 0.9
    assert report.plan["gamma"] == report.gamma and report.used_sd
    assert report.tuner_alpha == (0.9, tuner.alpha)


def test_measured_target_efficiency_in_range(models):
    """The port's measurement (CPU: perf_counter around eager extends)
    lands in the reference's range on the same weights and cache, and
    commits nothing to the caller's cache."""
    (jt, _, jpt, _), (t, _, pt, _) = models
    toks = np.random.default_rng(2).integers(0, 512, (4, 16))
    _, jcache = jt.prefill(jpt, toks, jt.init_cache(4, 64))
    _, cache = t.prefill(pt, toks, t.init_cache(4, 64))
    before = [x.clone() for x in (cache["lengths"], cache["layers"][0]["k"])]
    # medians of 5 calls: one call slowed by a busy host cannot move them
    te = measure_target_efficiency(t, pt, cache, gamma=4, iters=5)
    ref = ref_measure_target_efficiency(jt, jpt, jcache, gamma=4, iters=5)
    # distinct verify tokens instead of the reference's token 0
    ver = np.random.default_rng(3).integers(0, 512, (4, 5))
    distinct = measure_target_efficiency(t, pt, cache, gamma=4, iters=5,
                                         tokens=ver)
    for r in (te, ref, distinct):
        assert 0.0 < r["target_efficiency"] <= 1.5   # CPU noise tolerance
        assert r["T_T_1"] > 0 and r["T_T_gamma"] > 0
    assert te.keys() == ref.keys()
    assert torch.equal(before[0], cache["lengths"])
    assert torch.equal(before[1], cache["layers"][0]["k"])


@pytest.mark.parametrize("arch", ["qwen2-57b-a14b", "qwen2-7b",
                                  "mixtral-8x7b", "qwen3-moe-30b-a3b"])
def test_predicted_target_efficiency_matches_reference(arch):
    """The analytic eta_target on V5E equals the reference's; on H100 it
    lies in (0, 1] and falls with gamma."""
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    for b in (1, 8, 64):
        for g in (1, 4):
            mine = predicted_target_efficiency(Simulator(V5E), cfg, b, g)
            theirs = ref_predicted_target_efficiency(ref_sim.Simulator(),
                                                     rcfg, b, g)
            assert mine.keys() == theirs.keys()
            np.testing.assert_allclose(
                [mine[k] for k in mine], [theirs[k] for k in mine],
                rtol=RTOL, atol=0)
        etas = [predicted_target_efficiency(Simulator(), cfg, b, g)
                ["target_efficiency"] for g in (1, 2, 4, 8)]
        assert all(0 < e <= 1 for e in etas)
        assert all(b2 <= a2 for a2, b2 in zip(etas, etas[1:]))


# ------------------------------------------------------ test_scheduler
class _WindowTuner:
    """Stub tuner: SD only while the live batch stays >= 2 slots."""

    alpha = 0.0

    def __init__(self):
        self.planned = []
        self.alphas = []

    def plan(self, batch):
        self.planned.append(batch)
        return {"use_sd": batch >= 2, "gamma": 2, "predicted_speedup": 2.0}

    def update_alpha(self, alpha):
        self.alphas.append(alpha)


def test_tuner_replans_live_count_and_hands_off_to_ar(models):
    """As slots drain, plan(live) sees the decayed N(t) and the stream
    hands off SD→AR mid-flight (gamma 0 rounds, same session), with greedy
    outputs token-identical to the all-SD wave decode and to the
    reference's stream under the same stub."""
    jm, tm = models
    budgets = (4, 12)
    outs = {}
    for name, cls, m in (("port", ServingEngine, tm),
                         ("ref", JaxServingEngine, jm)):
        tuner = _WindowTuner()
        eng = cls(*m, max_batch=2, gamma=2, tuner=tuner,
                  scheduler="continuous")
        uids = [eng.submit(np.arange(3, 9), max_new_tokens=b)
                for b in budgets]
        (report,) = eng.run()
        outs[name] = ([eng.done[u].output for u in uids], report, tuner, eng)
    outputs, report, tuner, eng = outs["port"]
    assert set(tuner.planned) == {1, 2}        # re-planned on live N(t)
    sd_flags = [s.used_sd for s in report.steps]
    assert True in sd_flags and False in sd_flags
    assert all(s.gamma == 0 for s in report.steps if not s.used_sd)
    assert eng.session_constructions == {"model": 1}
    assert set(eng.session_stats()["model"]["keys"]) == {(2, 2, 32),
                                                         (0, 2, 32)}
    ref = ServingEngine(*tm, max_batch=2, gamma=2, force_sd=True)
    ruids = [ref.submit(np.arange(3, 9), max_new_tokens=b) for b in budgets]
    ref.run()
    ref_outputs, ref_report, ref_tuner, _ = outs["ref"]
    assert tuner.planned == ref_tuner.planned
    np.testing.assert_allclose(tuner.alphas, ref_tuner.alphas, rtol=RTOL)
    assert [(s.live, s.gamma, s.used_sd) for s in report.steps] == \
        [(s.live, s.gamma, s.used_sd) for s in ref_report.steps]
    for u, ru, jo in zip(outputs, ruids, ref_outputs):
        np.testing.assert_array_equal(u, ref.done[ru].output)
        np.testing.assert_array_equal(u, jo)


# ------------------------------------- a real tuner, port vs reference
def test_autotuned_waves_match_reference(models):
    """Wave serving under a real AutoTuner: each wave plans gamma at its
    bucket from the alpha the previous waves fed back; the port's plans,
    alphas and greedy tokens are the reference's, and each planned gamma
    is one graph key."""
    jm, tm = models
    prompts = [np.arange(3, 9 + i % 3) for i in range(8)]
    runs = {}
    for name, cls, m, tuner in (("port", ServingEngine, tm, _tuners()[0]),
                                ("ref", JaxServingEngine, jm, _tuners()[1])):
        eng = cls(*m, max_batch=2, tuner=tuner)
        uids = [eng.submit(p, max_new_tokens=6) for p in prompts]
        reports = eng.run()
        runs[name] = (eng, uids, reports, tuner)
    eng, uids, reports, tuner = runs["port"]
    jeng, juids, jreports, jtuner = runs["ref"]
    assert [(r.gamma, r.used_sd, r.bucket) for r in reports] == \
        [(r.gamma, r.used_sd, r.bucket) for r in jreports]
    assert len({r.gamma for r in reports if r.used_sd}) >= 2
    np.testing.assert_allclose(tuner.alpha, jtuner.alpha, rtol=RTOL)
    for r in reports:
        lo, hi = r.tuner_alpha
        assert r.plan["gamma"] == r.gamma and hi < lo
    for u, ju in zip(uids, juids):
        np.testing.assert_array_equal(eng.done[u].output, jeng.done[ju].output)
    keys = eng.session_stats()["model"]["keys"]
    assert sorted({g for g, _, _ in keys}) == sorted(
        {r.gamma for r in reports if r.used_sd})
    assert all(c == 1 for c, _ in keys.values())


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_autotuned_continuous_stream_matches_reference(models, layout):
    """Continuous serving under a real AutoTuner: plan(live) every round,
    gamma changing as alpha decays, then the SD→AR hand-off; the port's
    per-round (N(t), gamma, use_sd), final alpha and greedy tokens are the
    reference's, with one graph key per (gamma, batch, max_seq)."""
    jm, tm = models
    prompts = [np.arange(3, 9 + i) for i in range(5)]
    runs = {}
    for name, cls, m, tuner in (("port", ServingEngine, tm, _tuners()[0]),
                                ("ref", JaxServingEngine, jm, _tuners()[1])):
        eng = cls(*m, max_batch=4, tuner=tuner, scheduler="continuous",
                  kv_layout=layout, page_size=8)
        uids = [eng.submit(p, max_new_tokens=n)
                for p, n in zip(prompts, (6, 12, 8, 16, 10))]
        (report,) = eng.run()
        runs[name] = (eng, uids, report, tuner)
    eng, uids, report, tuner = runs["port"]
    jeng, juids, jreport, jtuner = runs["ref"]
    steps = [(s.live, s.gamma, s.used_sd) for s in report.steps]
    assert steps == [(s.live, s.gamma, s.used_sd) for s in jreport.steps]
    sd_gammas = {g for _, g, sd in steps if sd}
    assert len(sd_gammas) >= 2 and any(not sd for _, _, sd in steps)
    np.testing.assert_allclose(tuner.alpha, jtuner.alpha, rtol=RTOL)
    for u, ju in zip(uids, juids):
        assert eng.done[u].finish_reason == jeng.done[ju].finish_reason
        np.testing.assert_array_equal(eng.done[u].output, jeng.done[ju].output)
    keys = eng.session_stats()["model"]["keys"]
    assert {g for g, _, _ in keys} == sd_gammas | {0}
    assert sum(n for _, n in keys.values()) + len(keys) == len(steps)
    assert eng.session_constructions == {"model": 1}


def test_cli_tuner_prices_the_full_published_config():
    """``make_tuner`` prices the full config and its default draft on the
    port's H100 record, as the reference's CLI prices them on V5E."""
    tuner = make_tuner("qwen2-57b-a14b")
    assert tuner.target == get_config("qwen2-57b-a14b")
    assert tuner.draft == draft_for(get_config("qwen2-57b-a14b"))
    assert tuner.alpha == 0.7 and tuner.sim.hw is H100


# --------------------------------------------------------------- configs
@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ["qwen2-7b", "mixtral-8x7b",
                                  "qwen3-moe-30b-a3b"])
def test_config_matches_reference(arch, reduced):
    """Every field and param_count() of the port's copy equal the
    reference's config, and so does its default draft."""
    cfg = get_config(arch, reduced=reduced)
    rcfg = ref_get_config(arch, reduced=reduced)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
    assert cfg.param_count() == rcfg.param_count()
    assert cfg.active_param_count() == rcfg.active_param_count()
    assert dataclasses.asdict(draft_for(cfg)) == \
        dataclasses.asdict(ref_draft_for(rcfg))
