"""Port's prefetch-aware proposer against the reference, CPU.

Mirrors tests/test_prefetch.py (all but its benchmark dry-run, which is
ROADMAP queue 1 item 6's benchmark scripts): wrapping a drafter with expert
warming never changes tokens; the router probe gives a fixed-shape plan of
top-M experts per MoE layer and ``warm_experts`` gathers exactly those
weights; hit/miss counts flow from ``moe_forward`` through
``Model.extend_with_prefetch``, ``SDStats`` and ``WaveReport`` to
``session_stats()``.  Against the reference on the same weights: the plan's
id sets and masks (compared as sets: ``torch.topk`` promises no order on
ties, and the test inputs keep every top-k margin above 1e-5 so a near-tie
cannot flip), the warmed weights, the hit, actual and predicted counts of
every run, and greedy tokens of waves and of a continuous paged stream that
admits through every path (sliced, prefix-shared, chunked), token for
token.

fp32, TF32 off; both sides route with the "onehot" dispatch (the routing,
and so the counts, do not depend on it; the reference's "gmm" dispatch
runs its Pallas kernel in interpret mode, which would triple the time).
"""
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import CPU, model_pair, port_config
from repro.configs.base import ModelConfig
from repro.core.prefetch import router_probe as jax_router_probe
from repro.core.proposer import make_proposer as jax_make_proposer
from repro.core.spec_decode import SDEngine as JaxSDEngine
from repro.models import moe as jmoe
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro_torch.core.prefetch import PrefetchProposer, router_probe
from repro_torch.core.proposer import make_proposer, registered_proposers
from repro_torch.core.spec_decode import SDEngine, generate_ar
from repro_torch.models import moe as tmoe
from repro_torch.models.convert import _map, _tensor
from repro_torch.serving.engine import ServingEngine

TCFG = ModelConfig("pf-moe", "moe", 2, 128, 4, 2, 256, 512, num_experts=8,
                   num_experts_per_tok=2, dtype="float32")
DCFG = ModelConfig("pf-draft", "dense", 2, 64, 2, 2, 128, 512,
                   dtype="float32")
MARGIN = 1e-5


@pytest.fixture(scope="module")
def setup():
    jt, jpt, tt, tpt = model_pair(TCFG, seed=0)
    jd, jpd, td, tpd = model_pair(DCFG, seed=7)
    prompts = np.random.default_rng(1).integers(0, 512, (2, 8)).astype(
        np.int32)
    return (jt, jd, jpt, jpd), (tt, td, tpt, tpd), prompts


def test_prefetch_registered_and_lazy():
    """Both new kinds are listed, and listing them imports neither."""
    assert {"prefetch", "eagle"} <= set(registered_proposers())
    code = ("import sys; from repro_torch.core.proposer import "
            "registered_proposers as r; assert {'prefetch', 'eagle'} <= "
            "set(r()); assert not {'repro_torch.core.prefetch', "
            "'repro_torch.core.eagle'} & set(sys.modules)")
    subprocess.run([sys.executable, "-c", code], check=True)


def _counts(stats):
    return (stats.prefetch_hits, stats.prefetch_actual,
            stats.prefetch_predicted)


def test_prefetch_greedy_matches_model_and_ar(setup):
    """Warming is observation-only: token-identical to "model" and AR, and
    the reference's tokens and hit, actual and predicted counts."""
    (jt, jd, jpt, jpd), (t, d, pt, pd), prompts = setup
    eng_pf = SDEngine(t, make_proposer("prefetch", t, d), gamma=3)
    out_pf, stats = eng_pf.generate(pt, pd, prompts, 14)
    out_m, _ = SDEngine(t, make_proposer("model", t, d),
                        gamma=3).generate(pt, pd, prompts, 14)
    np.testing.assert_array_equal(out_pf, out_m)
    np.testing.assert_array_equal(out_pf, generate_ar(t, pt, prompts, 14))
    assert stats.prefetch_actual > 0
    assert 0 <= stats.prefetch_hits <= stats.prefetch_actual
    assert stats.prefetch_misses == stats.prefetch_actual - stats.prefetch_hits
    jeng = JaxSDEngine(jt, jax_make_proposer("prefetch", jt, jd), gamma=3)
    ref, jstats = jeng.generate(jpt, jpd, jnp.asarray(prompts), 14)
    np.testing.assert_array_equal(out_pf, np.asarray(ref))
    assert _counts(stats) == _counts(jstats)
    assert eng_pf.prefetch_totals == jeng.prefetch_totals


def _probe_margins(jpt, tokens, K, M):
    """The smallest gap at each top-k cut of the probe, recomputed in
    numpy from the reference's weights: per token between its K-th and
    (K+1)-th router probability, per layer between the M-th and (M+1)-th
    expert score."""
    x = np.asarray(jpt["embed"]["table"])[tokens.reshape(-1)]
    gaps = []
    for router in np.asarray(jpt["layers"][0]["ffn"]["router"]):    # (d, E)
        logits = x.astype(np.float64) @ router
        p = np.exp(logits - logits.max(-1, keepdims=True))
        p /= p.sum(-1, keepdims=True)
        ps = -np.sort(-p, -1)
        gaps.append((ps[:, K - 1] - ps[:, K]).min())
        votes = np.zeros(p.shape[1])
        np.add.at(votes, np.argsort(-p, -1)[:, :K].reshape(-1), 1.0)
        score = -np.sort(-(votes + p.mean(0)))
        if M < len(score):
            gaps.append(score[M - 1] - score[M])
    return min(gaps)


def test_router_probe_plan_and_warm_match_reference(setup):
    (jt, _, jpt, _), (t, d, pt, _), prompts = setup
    cfg = t.cfg
    prop = make_proposer("prefetch", t, d)
    assert isinstance(prop, PrefetchProposer)
    M = prop.top_m
    assert M == min(cfg.num_experts, 2 * cfg.num_experts_per_tok)
    tokens = prompts[:, :4]
    assert _probe_margins(jpt, tokens, cfg.num_experts_per_tok, M) > MARGIN
    plan = router_probe(pt, cfg, torch.from_numpy(tokens), top_m=M)
    jplan = jax_router_probe(jpt, TCFG, jnp.asarray(tokens), top_m=M)
    E = cfg.num_experts
    for l in range(cfg.num_layers):
        slot, period = l % cfg.period, l // cfg.period
        assert plan.masks[l].shape == (E,) and plan.expert_ids[l].shape == (M,)
        assert int(plan.masks[l].sum()) == M
        ids = np.sort(plan.expert_ids[l].numpy())
        np.testing.assert_array_equal(
            ids, np.sort(np.asarray(jplan.expert_ids[slot][period])))
        np.testing.assert_array_equal(plan.masks[l].numpy(),
                                      np.asarray(jplan.masks[slot][period]))
    warmed = tmoe.warm_experts(pt["layers"], cfg, plan)
    jwarmed = jmoe.warm_experts(jpt["layers"], TCFG, jplan)
    assert len(warmed) == cfg.num_layers == len(jwarmed) * cfg.num_periods
    f = cfg.moe_d_ff
    for l, w in enumerate(warmed):
        assert w["w_gate"].shape == (M, cfg.d_model, f)
        assert w["w_down"].shape == (M, f, cfg.d_model)
        ours = np.argsort(plan.expert_ids[l].numpy())
        theirs = np.argsort(np.asarray(jplan.expert_ids[0][l]))
        for k in ("w_gate", "w_up", "w_down"):
            np.testing.assert_array_equal(
                w[k].numpy()[ours], np.asarray(jwarmed[0][k][l])[theirs])
    # in place: the same buffers take another plan's gather
    ptrs = [w["w_up"].data_ptr() for w in warmed]
    other = router_probe(pt, cfg, torch.from_numpy(prompts[:, 4:]), top_m=M)
    tmoe.warm_experts(pt["layers"], cfg, other, out=warmed)
    assert [w["w_up"].data_ptr() for w in warmed] == ptrs
    for l, w in enumerate(warmed):
        np.testing.assert_array_equal(
            w["w_down"].numpy(),
            pt["layers"][l]["ffn"]["w_down"][other.expert_ids[l]].numpy())


def test_hit_stats_exact():
    """moe_forward's prefetch metrics equal a numpy recount and the
    reference's."""
    p = jmoe.init_moe(jax.random.PRNGKey(3), TCFG, jnp.float32)
    tp = _map(jax.device_get(p), lambda a: _tensor(a, CPU))
    x = np.array(jax.random.normal(jax.random.PRNGKey(4),
                                    (1, 6, TCFG.d_model), jnp.float32))
    mask = np.array([True, False] * 4)
    cfg = port_config(TCFG)
    y, m = tmoe.moe_forward(tp, cfg, torch.from_numpy(x), dispatch="gmm",
                            prefetch_mask=torch.from_numpy(mask))
    assert y.shape == x.shape
    _, idx, _ = tmoe.router_topk(tp, cfg, torch.from_numpy(x).reshape(-1, 128))
    actual = np.zeros(TCFG.num_experts, bool)
    actual[idx.numpy().reshape(-1)] = True
    assert int(m["prefetch_actual"]) == actual.sum()
    assert int(m["prefetch_hits"]) == (actual & mask).sum()
    assert int(m["prefetch_predicted"]) == 4
    assert all(v.dtype == torch.int32 for v in m.values())
    _, jm = jmoe.moe_forward(p, TCFG, jnp.asarray(x), dispatch="onehot",
                             prefetch_mask=jnp.asarray(mask))
    for k in ("prefetch_hits", "prefetch_actual", "prefetch_predicted"):
        assert int(m[k]) == int(jm[k])
    s = tmoe.prefetch_hit_stats(torch.from_numpy(mask), idx, 8)
    assert int(s["prefetch_hits"]) == int(m["prefetch_hits"])


def test_wave_report_and_session_stats_aggregate(setup):
    """WaveReport carries hit/miss counts, session_stats() sums them, and
    both equal the reference's wave for wave."""
    jm, tm, _ = setup
    reports = []
    for cls, m in ((ServingEngine, tm), (JaxServingEngine, jm)):
        eng = cls(*m, max_batch=2, gamma=2, force_sd=True,
                  proposer="prefetch")
        for _ in range(4):                                  # 2 waves of 2
            eng.submit(np.arange(3, 9), max_new_tokens=6)
        reports.append((eng, eng.run()))
    (eng, reps), (jeng, jreps) = reports
    assert len(reps) == 2 and all(r.proposer == "prefetch" for r in reps)
    for r, jr in zip(reps, jreps):
        assert r.prefetch_hits + r.prefetch_misses == r.stats.prefetch_actual
        assert 0.0 <= r.prefetch_hit_rate <= 1.0
        assert _counts(r.stats) == _counts(jr.stats)
    assert sum(r.stats.prefetch_actual for r in reps) > 0
    assert eng.session_constructions == {"prefetch": 1}
    agg = eng.session_stats()["prefetch"]["prefetch"]
    assert agg["hits"] == sum(r.prefetch_hits for r in reps)
    assert agg["actual"] == sum(r.stats.prefetch_actual for r in reps)
    assert agg["rounds"] == sum(r.stats.rounds for r in reps)
    assert agg["hit_rate"] == pytest.approx(agg["hits"] / max(agg["actual"], 1))
    assert agg == jeng.session_stats()["prefetch"]["prefetch"]


def test_proposer_opts_reach_the_session(setup):
    """ServingEngine(proposer_opts=...) parameterizes the factory: a warm
    budget of 2 lands on the session's proposer and in the plans."""
    _, tm, _ = setup
    eng = ServingEngine(*tm, max_batch=1, gamma=2, force_sd=True,
                        proposer="prefetch", proposer_opts={"top_m": 2})
    eng.submit(np.arange(3, 9), max_new_tokens=4)
    (report,) = eng.run()
    assert eng._sessions["prefetch"].proposer.top_m == 2
    n_moe = sum(TCFG.moe_pattern) * TCFG.num_periods
    assert report.stats.prefetch_predicted == report.stats.rounds * 2 * n_moe


def test_plain_model_waves_report_zero_prefetch(setup):
    """The accounting does not leak into non-prefetch proposers."""
    _, tm, _ = setup
    eng = ServingEngine(*tm, max_batch=1, gamma=2, force_sd=True,
                        proposer="model")
    eng.submit(np.arange(3, 9), max_new_tokens=4)
    (report,) = eng.run()
    assert report.prefetch_hits == 0 and report.prefetch_misses == 0
    assert report.prefetch_hit_rate == 0.0
    assert eng.session_stats()["model"]["prefetch"]["actual"] == 0


def test_prefetch_continuous_stream_matches_reference(setup):
    """A paged continuous stream with prefix sharing and chunks of 16:
    three requests behind a 20-token shared prefix (the first two admit
    sliced, the third prefix-shared) and a 40-token prompt at round 2
    (chunked) give the reference's tokens, finish reasons, prefix counters
    and prefetch totals."""
    jm, tm, _ = setup
    kw = dict(max_batch=2, gamma=2, force_sd=True, proposer="prefetch",
              scheduler="continuous", kv_layout="paged", page_size=16,
              prefix_sharing=True, prefill_chunk=16)
    engines = [ServingEngine(*tm, **kw), JaxServingEngine(*jm, **kw)]
    base = np.arange(3, 23)
    uids = []
    for eng in engines:
        uids.append([eng.submit(np.concatenate([base, np.arange(30, 34)
                                                + 4 * i]), max_new_tokens=n)
                     for i, n in enumerate((3, 7, 5))])
        uids[-1].append(eng.submit(np.arange(3, 43), max_new_tokens=6,
                                   arrival_round=2))
        eng.run()
    eng, jeng = engines
    for u, ju in zip(*uids):
        assert eng.done[u].finish_reason == jeng.done[ju].finish_reason
        np.testing.assert_array_equal(eng.done[u].output,
                                      np.asarray(jeng.done[ju].output))
    agg = eng.session_stats()["prefetch"]["prefetch"]
    assert agg == jeng.session_stats()["prefetch"]["prefetch"]
    assert agg["actual"] > 0
    assert eng.fault_counters.get("prefix_hits", 0) >= 1
    assert eng.fault_counters == jeng.fault_counters
    assert any(s.chunk_steps for s in eng.reports[-1].steps)
