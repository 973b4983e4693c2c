"""Port's continuous slot scheduler against the reference, CPU.

Token parity: on the same weights and the same Poisson workload the port's
greedy ``ServingEngine(scheduler="continuous")`` emits the reference's
tokens and finish reasons exactly, dense and paged, with the "model" and
"none" proposers, all-at-once and Poisson arrivals with mixed budgets, and
with an eos id.  Mirrors of tests/test_scheduler.py: continuous ≡ wave at
fixed occupancy, per-slot budgets with refill, replay under a seeded
generator, no new shapes when occupancy changes, eos early exit in both
schedulers, and delayed admission under arrival rounds.

Same weights on both sides (``model_pair``), fp32, TF32 off.
"""
import functools

import numpy as np
import pytest

from _torch_parity import model_pair
from repro.configs.base import ModelConfig
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro.serving.scheduler import submit_poisson as jax_submit_poisson
from repro_torch.core.analytics import occupancy_timeline
from repro_torch.data.pipeline import prompt_batch
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.scheduler import submit_poisson

TCFG = ModelConfig("cs-moe", "moe", 2, 128, 4, 2, 256, 512, num_experts=4,
                   num_experts_per_tok=2, dtype="float32")
DCFG = ModelConfig("cs-draft", "dense", 2, 64, 2, 2, 128, 512,
                   dtype="float32")


@pytest.fixture(scope="module")
def models():
    jt, jpt, tt, tpt = model_pair(TCFG, seed=0)
    jd, jpd, td, tpd = model_pair(DCFG, seed=1)
    return (jt, jd, jpt, jpd), (tt, td, tpt, tpd)


def _engine(cls, m, **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("gamma", 2)
    kw.setdefault("force_sd", True)
    return cls(*m, **kw)


# ------------------------------------------------------- reference parity
WORKLOAD = prompt_batch(TCFG.vocab_size, 7, seed=3, min_len=5, max_len=14)
STREAMS = {                       # (layout, proposer, arrival rate, eos)
    "dense-model-r0": ("dense", "model", 0.0, False),
    "dense-model-poisson": ("dense", "model", 0.5, False),
    "dense-none-poisson": ("dense", "none", 0.5, False),
    "paged-model-r0": ("paged", "model", 0.0, False),
    "paged-model-poisson": ("paged", "model", 0.5, False),
    "paged-none-r0": ("paged", "none", 0.0, False),
    "paged-model-poisson-eos": ("paged", "model", 0.5, True),
    "dense-none-poisson-eos": ("dense", "none", 0.5, True),
}


def _stream(cls, submit, m, layout, proposer, rate, eos_id):
    eng = _engine(cls, m, scheduler="continuous", kv_layout=layout,
                  page_size=8, proposer=proposer, eos_id=eos_id)
    uids = submit(eng, WORKLOAD["tokens"], WORKLOAD["lengths"], rate=rate,
                  max_new_choices=(4, 8, 12), seed=5)
    (report,) = eng.run()
    return eng, uids, report


@pytest.fixture(scope="module")
def jax_stream(models):
    """Reference streams by name, each run once per module."""
    jm, _ = models

    @functools.lru_cache(maxsize=None)
    def get(name):
        layout, proposer, rate, eos = STREAMS[name]
        return _stream(JaxServingEngine, jax_submit_poisson, jm, layout,
                       proposer, rate, _eos_id(get, name) if eos else None)
    return get


def _eos_id(get, name):
    """An eos id that fires mid-stream: the third token of the first
    request of the same stream without eos."""
    base = get(name.rsplit("-", 1)[0])
    eng, uids, _ = base
    return int(eng.done[uids[0]].output[2])


@pytest.mark.parametrize("name", list(STREAMS))
def test_continuous_outputs_match_reference(models, jax_stream, name):
    _, tm = models
    layout, proposer, rate, eos = STREAMS[name]
    jeng, juids, jrep = jax_stream(name)
    eos_id = _eos_id(jax_stream, name) if eos else None
    eng, uids, rep = _stream(ServingEngine, submit_poisson, tm, layout,
                             proposer, rate, eos_id)
    for u, ju in zip(uids, juids):
        r, jr = eng.done[u], jeng.done[ju]
        assert (r.arrival_round, r.max_new_tokens) == \
            (jr.arrival_round, jr.max_new_tokens)
        assert r.finish_reason == jr.finish_reason
        np.testing.assert_array_equal(r.output, jr.output)
    assert rep.tokens_out == jrep.tokens_out
    assert rep.finish_reasons == jrep.finish_reasons
    assert [s.live for s in rep.steps] == [s.live for s in jrep.steps]
    if eos:
        assert rep.finish_reasons.get("eos", 0) >= 1
    if layout == "paged":
        eng._slot_scheduler._alloc.assert_no_leaks()


# ----------------------------------------------- mirrors of test_scheduler
def test_continuous_matches_wave_greedy_fixed_occupancy(models):
    """Pool-sized batch, equal budgets: continuous ≡ wave, token for
    token."""
    _, tm = models
    outs = {}
    for sched in ("wave", "continuous"):
        eng = _engine(ServingEngine, tm, scheduler=sched)
        uids = [eng.submit(np.arange(3, 9), max_new_tokens=8)
                for _ in range(4)]
        (report,) = eng.run()
        outs[sched] = [eng.done[u].output for u in uids]
        assert report.scheduler == sched
        assert report.tokens_out == 4 * 8
        assert all(eng.done[u].finish_reason == "length" for u in uids)
    for a, b in zip(outs["wave"], outs["continuous"]):
        np.testing.assert_array_equal(a, b)


def test_slot_budgets_and_refill(models):
    """More requests than slots, mixed budgets: each request gets exactly
    its own budget and occupancy varies."""
    _, tm = models
    budgets = (4, 12, 6, 9, 5, 7)
    eng = _engine(ServingEngine, tm, max_batch=2, scheduler="continuous")
    uids = [eng.submit(np.arange(3, 9), max_new_tokens=m) for m in budgets]
    (report,) = eng.run()
    assert len(eng.done) == len(budgets)
    assert [len(eng.done[u].output) for u in uids] == list(budgets)
    assert report.tokens_out == sum(budgets)
    assert max(s.live for s in report.steps) == 2
    assert sum(s.admitted for s in report.steps) == len(budgets)
    assert sum(s.retired for s in report.steps) == len(budgets)
    occ = occupancy_timeline([s.live for s in report.steps],
                             [s.committed for s in report.steps])
    assert occ["peak_live"] == 2 and 0 < occ["mean_occupancy"] <= 1


def test_retire_refill_deterministic_under_seeded_generator(models):
    """Sampled decoding: one seed replays the stream exactly (admissions
    and rounds draw from the engine's generator in turn); another seed
    diverges."""
    _, tm = models

    def serve(seed):
        eng = _engine(ServingEngine, tm, max_batch=2, scheduler="continuous",
                      temperature=1.0, seed=seed)
        uids = [eng.submit(np.arange(3, 9), max_new_tokens=m)
                for m in (5, 9, 4, 7)]
        eng.run()
        return [eng.done[u].output for u in uids]

    a, b, c = serve(5), serve(5), serve(6)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert any(not np.array_equal(x, y) for x, y in zip(a, c))


def test_no_new_shape_when_occupancy_changes(models):
    """Retire/refill churn is data: one round shape and one admission
    shape per (prompt bucket, admitted rows) for the whole stream."""
    _, tm = models
    eng = _engine(ServingEngine, tm, max_batch=2, scheduler="continuous")
    for m in (3, 7, 5, 4, 6):
        eng.submit(np.arange(3, 9), max_new_tokens=m)
    (report,) = eng.run()
    assert len({s.live for s in report.steps}) > 1
    stats = eng.session_stats()["model"]
    assert stats["traces"] == [(2, 2)]
    assert stats["admit_traces"] == [(8, 2), (8, 1)]
    assert sum(s.admitted for s in report.steps) == 5


def test_eos_early_exit_both_schedulers(models):
    """finish_reason "eos" and truncation at the first eos, wave and
    continuous alike, and token-identical between them."""
    _, tm = models
    probe = _engine(ServingEngine, tm, max_batch=1)
    u = probe.submit(np.arange(3, 9), max_new_tokens=8)
    probe.run()
    full = probe.done[u].output
    eos = int(full[2])
    cut = int(np.nonzero(full == eos)[0][0]) + 1
    outs = {}
    for sched in ("wave", "continuous"):
        eng = _engine(ServingEngine, tm, max_batch=1, scheduler=sched,
                      eos_id=eos)
        uu = eng.submit(np.arange(3, 9), max_new_tokens=8)
        (report,) = eng.run()
        r = eng.done[uu]
        assert r.finish_reason == "eos"
        assert len(r.output) == cut
        assert report.tokens_out == cut
        outs[sched] = r.output
    np.testing.assert_array_equal(outs["wave"], outs["continuous"])


def test_poisson_arrivals_delay_admission(models):
    """A request stays invisible until its arrival round; the stream idles
    through the gap and still serves everything."""
    _, tm = models
    eng = _engine(ServingEngine, tm, max_batch=2, scheduler="continuous")
    eng.submit(np.arange(3, 9), max_new_tokens=4, arrival_round=0)
    u_late = eng.submit(np.arange(3, 9), max_new_tokens=4, arrival_round=6)
    (report,) = eng.run()
    assert len(eng.done) == 2
    assert len(eng.done[u_late].output) == 4
    assert [s.round_index for s in report.steps
            if s.admitted and s.round_index >= 6]


def test_engine_validates_continuous_options(models):
    """Layout and admission options are checked at construction, as in
    the reference."""
    _, tm = models
    with pytest.raises(ValueError, match="continuous-serving"):
        _engine(ServingEngine, tm, kv_layout="paged")
    with pytest.raises(ValueError, match="paged pool"):
        _engine(ServingEngine, tm, scheduler="continuous",
                kv_layout="paged", admit_mode="full")
    with pytest.raises(ValueError, match="requires kv_layout='paged'"):
        _engine(ServingEngine, tm, scheduler="continuous",
                admission_order="pressure")
    with pytest.raises(ValueError, match="scheduler must be"):
        _engine(ServingEngine, tm, scheduler="slots")


def test_serve_cli_continuous_paged_on_cpu(capsys):
    """The documented CPU command of the continuous paged serve runs and
    prints its N(t) and admission lines."""
    from repro_torch.launch import serve
    reports = serve.main(["--arch", "qwen2-57b-a14b", "--reduced",
                          "--scheduler", "continuous", "--kv-layout",
                          "paged", "--no-autotune", "--device", "cpu",
                          "--requests", "4", "--max-batch", "2",
                          "--max-new", "4", "--arrival-rate", "0.5"])
    out = capsys.readouterr().out
    assert len(reports) == 1 and reports[0].scheduler == "continuous"
    assert "N(t): peak=" in out and "admission:" in out
    assert "admit traces" in out
