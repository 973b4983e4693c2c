"""Port's resilience layer and fault injection against the reference, CPU.

Mirrors tests/test_faults.py: allocator edge cases, the seeded injector's
determinism, workload validation, recoverable preemption, NaN quarantine
that leaves co-batched rows untouched, the degradation ladder's safe stop,
round budgets, admission retry with backoff, and the recovery summary.
Where the reference runs the same stream, the port's tokens, finish
reasons and resilience counters equal its exactly.  Beside them: one
stream that runs prefix sharing, chunked admission and the scripted smoke
injector together through both engines (tokens, finish reasons, counters,
injections and per-round N(t)/gamma equal), and the port's smoke lane
(``python -m repro_torch.serving.faults --device cpu``).

Same weights on both sides (``model_pair``), fp32, TF32 off.
"""
import numpy as np
import pytest

from _torch_parity import model_pair
from repro.configs.base import ModelConfig
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro.serving.faults import Fault as JaxFault
from repro.serving.faults import FaultInjector as JaxFaultInjector
from repro.serving.faults import ResilienceConfig as JaxResilienceConfig
from repro_torch.core.analytics import fault_recovery_summary
from repro_torch.models.model import PageAllocator
from repro_torch.serving import faults
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.faults import Fault, FaultInjector, ResilienceConfig
from repro_torch.serving.scheduler import StepReport, submit_poisson

TCFG = ModelConfig("ft-moe", "moe", 2, 128, 4, 2, 256, 512, num_experts=4,
                   num_experts_per_tok=2, dtype="float32")
DCFG = ModelConfig("ft-draft", "dense", 2, 64, 2, 2, 128, 512,
                   dtype="float32")

PORT = {"engine": ServingEngine, "fault": Fault, "injector": FaultInjector,
        "resilience": ResilienceConfig}
REF = {"engine": JaxServingEngine, "fault": JaxFault,
       "injector": JaxFaultInjector, "resilience": JaxResilienceConfig}


@pytest.fixture(scope="module")
def models():
    jt, jpt, tt, tpt = model_pair(TCFG, seed=0)
    jd, jpd, td, tpd = model_pair(DCFG, seed=1)
    return {id(REF): (jt, jd, jpt, jpd), id(PORT): (tt, td, tpt, tpd)}


def _engine(side, models, **kw):
    kw.setdefault("max_batch", 3)
    kw.setdefault("gamma", 2)
    kw.setdefault("force_sd", True)
    kw.setdefault("scheduler", "continuous")
    return side["engine"](*models[id(side)], **kw)


def _both(run):
    """``run(side)`` on the port and the reference; the reference's streams
    must give the port's tokens, finish reasons and counters."""
    eng, uids = run(PORT)
    jeng, juids = run(REF)
    for u, ju in zip(uids, juids):
        assert eng.done[u].finish_reason == jeng.done[ju].finish_reason
        np.testing.assert_array_equal(np.asarray(eng.done[u].output),
                                      np.asarray(jeng.done[ju].output))
    assert eng.fault_counters == jeng.fault_counters
    return eng, uids


# ------------------------------------------------------ allocator edge cases
def test_allocator_exhaustion_and_reserve_edges():
    a = PageAllocator(2, 8, 4, 4)            # 3 allocatable pages
    assert a.free_fraction() == 1.0
    a.alloc(0, 16)                           # 2 pages
    assert not a.can_alloc(17)
    assert a.free_fraction() == pytest.approx(1 / 3)
    pool, maxp = a.grown_geometry(17)
    assert pool >= 8 and maxp >= 4
    held = a.reserve(1)                      # reserve() is real pressure
    assert not a.can_alloc(8)
    with pytest.raises(ValueError, match="reserve"):
        a.reserve(1)
    with pytest.raises(ValueError, match="not.*reserved|reserved"):
        a.release([99])
    a.release(held)
    with pytest.raises(ValueError, match="not.*reserved"):
        a.release(held)                      # second release = double free
    a.free_row(0)
    a.assert_no_leaks()
    a.alloc(1, 8)
    with pytest.raises(RuntimeError, match="own pages"):
        a.assert_no_leaks()
    a.free.append(a.owned[1][0])
    with pytest.raises(ValueError, match="double free"):
        a.free_row(1)


def test_injector_determinism_and_validation():
    """Same seed → the same script, and the reference's script exactly;
    unknown kinds fail."""
    a = FaultInjector.poisson(0.5, 20, seed=7)
    b = FaultInjector.poisson(0.5, 20, seed=7)
    assert a.faults == b.faults
    assert FaultInjector.poisson(0.5, 20, seed=8).faults != a.faults
    ref = JaxFaultInjector.poisson(0.5, 20, seed=7)
    assert [(f.round, f.kind, f.hold_rounds) for f in a.faults] == \
        [(f.round, f.kind, f.hold_rounds) for f in ref.faults]
    with pytest.raises(ValueError, match="unknown fault kind"):
        Fault(round=0, kind="meteor_strike")


def test_submit_poisson_validation(models):
    eng = _engine(PORT, models)
    prompts = np.arange(12).reshape(2, 6) + 3
    with pytest.raises(ValueError, match="rate"):
        submit_poisson(eng, prompts, [6, 6], rate=-1.0)
    with pytest.raises(ValueError, match="empty workload"):
        submit_poisson(eng, prompts, [], rate=1.0)
    with pytest.raises(ValueError, match="prompt 1 is empty"):
        submit_poisson(eng, prompts, [6, 0], rate=1.0)
    with pytest.raises(ValueError, match="max_new_choices"):
        submit_poisson(eng, prompts, [6, 6], rate=1.0, max_new_choices=())
    assert not eng.queue


# --------------------------------------------------- preemption and requeue
def _three(side, models, capped):
    res = side["resilience"](max_pool_pages=8) if capped else None
    eng = _engine(side, models, kv_layout="paged", page_size=8,
                  resilience=res)
    uids = (eng.submit(np.arange(3, 9), max_new_tokens=16),
            eng.submit(np.arange(4, 10), max_new_tokens=8, arrival_round=1),
            eng.submit(np.arange(5, 11), max_new_tokens=8, arrival_round=2))
    eng.run()
    return eng, uids


def test_preemption_requeues_byte_identical(models):
    """At the pool cap the youngest slot is preempted, requeues with its
    committed tokens and finishes with the uncapped stream's tokens."""
    ref, ru = _three(PORT, models, capped=False)
    eng, uids = _both(lambda side: _three(side, models, capped=True))
    assert eng.fault_counters["preemptions"] >= 1
    assert eng.fault_counters["requeues"] >= 1
    b = eng.done[uids[1]]
    assert b.preempt_count == 1 and b.requeue_round is not None
    assert b.readmit_round is not None and b.readmit_round > b.requeue_round
    for u0, u in zip(ru, uids):
        assert eng.done[u].finish_reason in ("length", "eos")
        np.testing.assert_array_equal(eng.done[u].output, ref.done[u0].output)
    report = eng.reports[-1]
    assert report.finish_reasons.get("length", 0) == 3
    assert sum(s.preempted for s in report.steps) >= 1
    eng._slot_scheduler._alloc.assert_no_leaks()


# ------------------------------------------------------ numerical sentinel
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_nan_quarantine_isolates_co_batched_rows(models, layout):
    """A NaN-poisoned row finishes ``numerical_fault``; its co-batched
    neighbour's tokens equal an uninjected run's, and the faulted tokens
    are excluded from tokens_out (dense as in the reference, and paged)."""
    def run(side, inject):
        inj = side["injector"]([side["fault"](round=2, kind="nan_row",
                                              row=0)]) if inject else None
        eng = _engine(side, models, max_batch=2, fault_injector=inj,
                      kv_layout=layout, page_size=8)
        uids = (eng.submit(np.arange(3, 9), max_new_tokens=12),
                eng.submit(np.arange(4, 10), max_new_tokens=12))
        eng.run()
        return eng, uids

    ref, (_, rb) = run(PORT, False)
    eng, (ua, ub) = _both(lambda side: run(side, True))
    a, b = eng.done[ua], eng.done[ub]
    assert a.finish_reason == "numerical_fault" and len(a.output) < 12
    assert b.finish_reason == "length"
    np.testing.assert_array_equal(b.output, ref.done[rb].output)
    report = eng.reports[-1]
    assert report.tokens_out == len(b.output)
    assert report.tokens_discarded == len(a.output)
    assert sum(s.faults for s in report.steps) == 1
    assert eng.fault_counters["numerical_faults"] == 1


def test_ladder_escalates_to_safe_stop(models):
    def run(side):
        F = side["fault"]
        inj = side["injector"]([F(round=1, kind="nan_row", row=0),
                                F(round=2, kind="nan_row", row=1)])
        eng = _engine(side, models, max_batch=2, fault_injector=inj,
                      resilience=side["resilience"](faulty_rounds_to_ar=1,
                                                    faulty_rounds_to_stop=2))
        uids = [eng.submit(np.arange(3 + i, 9 + i), max_new_tokens=32)
                for i in range(3)]               # the third stays queued
        eng.run()
        return eng, uids

    eng, _ = _both(run)
    reasons = sorted(r.finish_reason for r in eng.done.values())
    assert reasons == ["aborted", "numerical_fault", "numerical_fault"]
    assert eng.fault_counters["aborts"] == 1
    assert eng.fault_counters.get("ar_handoffs", 0) >= 1
    assert not eng.queue


# ------------------------------------------------------- watchdog and retry
def test_round_budget_timeout(models):
    def run(side):
        eng = _engine(side, models, max_batch=2, resilience=side[
            "resilience"](max_rounds_per_request=1))
        uids = (eng.submit(np.arange(3, 9), max_new_tokens=32),
                eng.submit(np.arange(4, 10), max_new_tokens=32))
        eng.run()
        return eng, uids

    eng, _ = _both(run)
    assert [r.finish_reason for r in eng.done.values()] == \
        ["timeout", "timeout"]
    report = eng.reports[-1]
    assert report.tokens_out == 0 and report.tokens_discarded > 0
    assert eng.fault_counters["timeouts"] == 2


def test_admission_retry_backoff_and_exhaustion(models):
    """Failures at rounds 0, 1 and 3 exhaust a budget of 2 retries
    (attempt 1 retries at round 1, attempt 2 at round 3); one failure is
    survived."""
    def run(side, rounds):
        inj = side["injector"]([side["fault"](round=r, kind="admit_fail")
                                for r in rounds])
        eng = _engine(side, models, fault_injector=inj,
                      resilience=side["resilience"](admit_retries=2))
        uids = (eng.submit(np.arange(3, 9), max_new_tokens=4),)
        eng.run()
        return eng, uids

    eng, (uid,) = _both(lambda side: run(side, (0, 1, 3)))
    r = eng.done[uid]
    assert r.finish_reason == "admit_failed"
    assert r.admit_attempts == 3 and len(r.output) == 0
    assert eng.fault_counters["admit_retries"] == 2
    assert eng.fault_counters["admit_failures"] == 1
    eng2, (uid2,) = _both(lambda side: run(side, (0,)))
    assert eng2.done[uid2].finish_reason == "length"
    assert eng2.done[uid2].admit_attempts == 1


# ------------------------------------------------------------- accounting
def test_fault_recovery_summary_reduction():
    """The recovery-latency reduction over the port's StepReports: a
    preemption's latency is the rounds until the next re-admission."""
    def mk(i, **kw):
        return StepReport(i, 1, 2, True, 1, kw.pop("admitted", 0), 0, 0.01,
                          **kw)
    steps = [mk(0, admitted=2), mk(1, preempted=1), mk(2), mk(3, admitted=1),
             mk(4, faults=1), mk(5, deferred=2)]
    s = fault_recovery_summary(steps)
    assert s["rounds"] == 6 and s["preempted"] == 1 and s["faults"] == 1
    assert s["deferred"] == 2
    assert s["recovery_latency_rounds"] == [2.0]
    assert s["mean_recovery_latency"] == 2.0
    assert s["disrupted_rounds"] == 3
    s2 = fault_recovery_summary([mk(0, preempted=1), mk(1)])
    assert s2["recovery_latency_rounds"] == [float("inf")]


# ------------------------------------- sharing + chunking + the smoke script
SYS = np.random.default_rng(5).integers(3, 500, 20)


def _combined(side, models):
    """Pages of 8, a 20-token shared system prompt (2 pages and a boundary
    page), chunks of 16, and the scripted smoke injector (failed admissions
    at round 1, every free page held at rounds 2-4, a NaN row at 6, a slow
    round at 7 with no deadline set): a chunked leader, a sibling
    staggered behind it and admitted in chunks after the failed round, a
    30-token unshared prompt in 2 chunks while the held pages make the pool
    grow, and a sibling at round 2 that forks the leader's pages.  Every
    request is admitted before the NaN row retires, so no later request
    is handed its poisoned pages."""
    rng = np.random.default_rng(11)
    F, Inj = side["fault"], side["injector"]
    inj = Inj([F(round=f.round, kind=f.kind, hold_rounds=f.hold_rounds)
               for f in faults._smoke_injector().faults])
    eng = _engine(side, models, max_batch=4, kv_layout="paged", page_size=8,
                  prefix_sharing=True, prefill_chunk=16, fault_injector=inj)
    spec = [(SYS, 5, 24, 0), (SYS, 3, 16, 0), (None, 30, 12, 0),
            (SYS, 4, 10, 2)]
    uids = []
    for prefix, n, m, arrive in spec:
        tail = rng.integers(3, 500, n)
        p = tail if prefix is None else np.concatenate([prefix, tail])
        uids.append(eng.submit(p.astype(np.int32), max_new_tokens=m,
                               arrival_round=arrive))
    (rep,) = eng.run()
    return eng, uids, inj, rep


def test_sharing_chunking_and_injector_stream_matches_reference(models):
    eng, uids, inj, rep = _combined(PORT, models)
    jeng, juids, jinj, jrep = _combined(REF, models)
    for u, ju in zip(uids, juids):
        assert eng.done[u].finish_reason == jeng.done[ju].finish_reason
        np.testing.assert_array_equal(np.asarray(eng.done[u].output),
                                      np.asarray(jeng.done[ju].output))
    assert eng.fault_counters == jeng.fault_counters
    assert inj.injected == jinj.injected
    assert [(s.live, s.gamma) for s in rep.steps] == \
        [(s.live, s.gamma) for s in jrep.steps]
    assert [(s.admit_rows, s.admit_tokens, s.shared_tokens, s.deferred)
            for s in rep.steps] == \
        [(s.admit_rows, s.admit_tokens, s.shared_tokens, s.deferred)
         for s in jrep.steps]
    st, jst = eng.session_stats()["model"], jeng.session_stats()["model"]
    assert st["chunk_traces"] == jst["chunk_traces"]
    assert st["prefix_traces"] == jst["prefix_traces"]
    fc = eng.fault_counters
    for name in ("prefix_hits", "cow_copies", "numerical_faults",
                 "admit_retries"):
        assert fc.get(name, 0) >= 1, fc
    assert sum(s.chunk_steps for s in rep.steps) == 6   # 3 prompts x 2
    assert st["growths"] and inj.injected["page_exhaustion"] == 1
    assert "numerical_fault" in rep.finish_reasons
    eng._slot_scheduler._alloc.assert_no_leaks()


def test_smoke_lane_on_cpu(capsys):
    assert faults.main(["--device", "cpu"]) == 0
    assert "captured nothing" in capsys.readouterr().out
