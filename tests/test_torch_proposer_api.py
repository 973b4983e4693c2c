"""The port's Proposer API: cross-proposer parity, registry, session reuse.

Mirrors tests/test_proposer_api.py on the port, with every kind
parametrised ("model", "eagle", "prefetch", "none"): every proposer runs
through the one ``SDEngine`` loop and is greedy-lossless; the registry is
extensible and fails loudly on unknown kinds; the legacy shims
(``SpecDecoder``, ``EagleSpecDecoder``) ride the engine; ``ServingEngine``
builds each kind's session once across waves, and a tuner-driven gamma
change reuses the rounds a session already captured (``trace_log`` and
``round_keys()``: one capture per (gamma, batch) key, replays after); waves
draw fresh noise; timed rounds record their phases (the warm stage's
too, for "prefetch").  The parity with the reference of each kind lives in
``test_torch_eagle.py``, ``test_torch_prefetch.py`` and
``test_torch_spec_decode.py``.

fp32 on the CPU, random weights from seeded generators.
"""
import numpy as np
import pytest
import torch

from _torch_parity import port_config
from repro.configs.base import ModelConfig
from repro_torch.core.eagle import EagleHead, EagleSpecDecoder
from repro_torch.core.proposer import (ModelProposer, make_proposer,
                                       register_proposer, registered_proposers)
from repro_torch.core.spec_decode import SDEngine, SpecDecoder, generate_ar
from repro_torch.models.model import Model
from repro_torch.serving.engine import ServingEngine

TCFG = port_config(ModelConfig("pp-moe", "moe", 2, 128, 4, 2, 256, 512,
                               num_experts=4, num_experts_per_tok=2,
                               dtype="float32"))
DCFG = port_config(ModelConfig("pp-draft", "dense", 2, 64, 2, 2, 128, 512,
                               dtype="float32"))
KINDS = ["model", "eagle", "prefetch", "none"]


@pytest.fixture(scope="module")
def setup():
    t, d = Model(TCFG, device="cpu"), Model(DCFG, device="cpu")
    pt = t.init(torch.Generator().manual_seed(0))
    pd = d.init(torch.Generator().manual_seed(7))
    head = EagleHead(t)
    pe = head.init(torch.Generator().manual_seed(3))
    prompts = np.random.default_rng(1).integers(0, 512, (2, 8)).astype(
        np.int32)
    drafts = {"model": (d, pd), "eagle": (head, pe), "prefetch": (d, pd),
              "none": (None, None)}
    return t, pt, drafts, prompts


@pytest.mark.parametrize("kind", KINDS)
def test_every_proposer_greedy_matches_ar(setup, kind):
    t, pt, drafts, prompts = setup
    draft, params_p = drafts[kind]
    gamma = 0 if kind == "none" else 3
    eng = SDEngine(t, make_proposer(kind, t, draft), gamma=gamma)
    out, stats = eng.generate(pt, params_p, prompts, 16)
    np.testing.assert_array_equal(out, generate_ar(t, pt, prompts, 16))
    assert stats.rounds >= 1
    if kind == "none":
        # degenerate path: one committed token per row a round, no drafts
        assert stats.draft_events == 0
        assert stats.generated == stats.rounds * prompts.shape[0]
    assert (stats.prefetch_actual > 0) == (kind == "prefetch")


def test_registry_unknown_kind_raises(setup):
    t = setup[0]
    with pytest.raises(KeyError, match="unknown proposer"):
        make_proposer("nope", t)
    assert set(KINDS) <= set(registered_proposers())


def test_registry_is_extensible(setup):
    """A user-registered drafter drops into the same engine loop."""
    t, pt, _, prompts = setup
    register_proposer(
        "selfdraft",
        lambda target, draft, temperature=0.0: ModelProposer(
            target, target, temperature=temperature))
    try:
        assert "selfdraft" in registered_proposers()
        eng = SDEngine(t, make_proposer("selfdraft", t), gamma=3)
        out, stats = eng.generate(pt, pt, prompts, 12)
        np.testing.assert_array_equal(out, generate_ar(t, pt, prompts, 12))
        assert stats.alpha == 1.0          # self-draft accepts everything
        # a self-draft is the target: its forwards are credited once
        assert eng.graphs._models == (t,)
    finally:
        from repro_torch.core import proposer as proposer_mod
        proposer_mod._REGISTRY.pop("selfdraft", None)


def test_shims_still_work(setup):
    """The legacy entry points ride the engine unchanged."""
    t, pt, drafts, prompts = setup
    (d, pd), (head, pe) = drafts["model"], drafts["eagle"]
    out, _ = SpecDecoder(t, d, gamma=2).generate(pt, pd, prompts, 10)
    ar = generate_ar(t, pt, prompts, 10)
    np.testing.assert_array_equal(out, ar)
    out, _ = EagleSpecDecoder(t, head, gamma=2).generate(pt, pe, prompts, 10)
    np.testing.assert_array_equal(out, ar)


@pytest.mark.parametrize("kind", ["model", "eagle", "prefetch"])
def test_gamma_change_reuses_session_and_compiles(setup, kind):
    """One session serves several gammas; a revisited (gamma, batch) shape
    replays its captured round instead of capturing again."""
    t, pt, drafts, prompts = setup
    draft, params_p = drafts[kind]
    eng = SDEngine(t, make_proposer(kind, t, draft))
    rounds = {2: 0, 3: 0}
    for gamma in (2, 3, 2, 3, 2):
        _, stats = eng.generate(pt, params_p, prompts, 8, gamma=gamma,
                                max_seq=64)
        rounds[gamma] += stats.rounds
    assert eng.trace_log == [(2, 2), (3, 2)]
    assert eng.compiled_gammas() == [2, 3]
    assert eng.round_keys() == {(g, 2, 64): (1, n - 1)
                                for g, n in rounds.items()}


class _FixedPlanTuner:
    """Stub tuner driving a per-wave gamma schedule (``alpha``: the port's
    wave report reads it before and after each wave)."""

    alpha = 0.7

    def __init__(self, gammas):
        self.gammas = list(gammas)
        self.alphas = []

    def plan(self, batch):
        return {"use_sd": True, "gamma": self.gammas.pop(0),
                "predicted_speedup": 2.0}

    def update_alpha(self, alpha):
        self.alphas.append(alpha)


@pytest.mark.parametrize("kind", ["model", "eagle", "prefetch"])
def test_serving_sessions_constructed_once_across_waves(setup, kind):
    """Four waves with a tuner-driven gamma change: one session for the
    kind, its two gammas captured once each, alpha fed back every wave."""
    t, pt, drafts, _ = setup
    draft, params_p = drafts[kind]
    tuner = _FixedPlanTuner([2, 3, 2, 2])
    eng = ServingEngine(t, draft, pt, params_p, max_batch=2, tuner=tuner,
                        force_sd=True, proposer=kind)
    for _ in range(8):                          # 4 waves of 2
        eng.submit(np.arange(3, 9), max_new_tokens=6)
    reports = eng.run()
    assert [r.gamma for r in reports] == [2, 3, 2, 2]
    stats = eng.session_stats()
    assert eng.session_constructions == {kind: 1}
    assert stats[kind]["traces"] == [(2, 2), (3, 2)]
    assert stats[kind]["gammas_compiled"] == [2, 3]
    assert stats[kind]["captures"] == 2
    assert stats[kind]["replays"] == sum(r.stats.rounds for r in reports) - 2
    assert len(tuner.alphas) == 4
    assert (stats[kind]["prefetch"]["rounds"] > 0) == (kind == "prefetch")


def test_serving_wave_keys_are_split(setup):
    """Waves must not share noise: identical sampled requests served in
    different waves produce different outputs."""
    t, pt, drafts, _ = setup
    d, pd = drafts["model"]
    eng = ServingEngine(t, d, pt, pd, max_batch=1, gamma=2, temperature=1.0,
                        force_sd=True)
    u1 = eng.submit(np.arange(3, 9), max_new_tokens=12)
    u2 = eng.submit(np.arange(3, 9), max_new_tokens=12)
    eng.run()
    assert not np.array_equal(eng.done[u1].output, eng.done[u2].output)


@pytest.mark.parametrize("kind", ["model", "eagle", "prefetch"])
def test_timed_mode_records_phase_timings(setup, kind):
    t, pt, drafts, prompts = setup
    draft, params_p = drafts[kind]
    eng = SDEngine(t, make_proposer(kind, t, draft), gamma=2)
    out_timed, stats = eng.generate(pt, params_p, prompts, 10, timed=True)
    assert stats.propose_time > 0
    assert stats.verify_time > 0
    assert stats.reject_time > 0
    assert (stats.warm_time > 0) == (kind == "prefetch")
    assert stats.round_time >= (stats.propose_time + stats.verify_time
                                + stats.reject_time) * 0.5
    # timed staging must not change tokens
    out_fused, _ = eng.generate(pt, params_p, prompts, 10)
    np.testing.assert_array_equal(out_timed, out_fused)


def test_wave_report_surfaces_timings(setup):
    t, pt, drafts, _ = setup
    d, pd = drafts["model"]
    eng = ServingEngine(t, d, pt, pd, max_batch=2, gamma=2, force_sd=True,
                        timed=True)
    eng.submit(np.arange(3, 9), max_new_tokens=6)
    (report,) = eng.run()
    assert report.propose_time > 0
    assert report.verify_time > 0
    assert report.reject_time > 0
    assert report.stats.round_time > 0
