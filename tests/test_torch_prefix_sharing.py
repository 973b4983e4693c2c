"""Port's prefix sharing in continuous paged serving against the reference,
CPU.

Mirrors tests/test_prefix_sharing.py (all but its benchmark smoke): the
allocator's fork / copy-on-write / refcount bookkeeping, a shared-prefix
stream that emits the unshared stream's tokens while the target prefills
the common prefix once, preemption of a fork whose leader already retired,
scripted page exhaustion while shared pages are live, pressure-ordered
refills, and the construction-time refusals.  Where the reference runs the
same stream, the port's tokens, finish reasons, prefix/CoW counters and
tail-admission shapes equal its exactly.  Beside them, the port's two
in-place helpers of this path, ``copy_cache_pages`` and
``poison_cache_row``, are held to the reference's functional results
exactly (they copy or set values, no arithmetic).

Same weights on both sides (``model_pair``), fp32, TF32 off.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import model_pair, port_config
from repro.configs.base import ModelConfig
from repro.models.model import copy_cache_pages as jax_copy_cache_pages
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro.serving.faults import FaultInjector as JaxFaultInjector
from repro.serving.faults import Fault as JaxFault
from repro.serving.faults import ResilienceConfig as JaxResilienceConfig
from repro.serving.faults import poison_cache_row as jax_poison_cache_row
from repro_torch.models.model import Model, PageAllocator, copy_cache_pages
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.faults import (Fault, FaultInjector,
                                        ResilienceConfig, poison_cache_row)

TCFG = ModelConfig("pfx-moe", "moe", 2, 128, 4, 2, 256, 512, num_experts=4,
                   num_experts_per_tok=2, dtype="float32")
DCFG = ModelConfig("pfx-draft", "dense", 2, 64, 2, 2, 128, 512,
                   dtype="float32")
SWACFG = ModelConfig("pfx-swa", "dense", 2, 64, 4, 2, 128, 512,
                     layer_pattern=("swa",), sliding_window=6,
                     dtype="float32")

PORT = {"engine": ServingEngine, "faults": (Fault, FaultInjector),
        "resilience": ResilienceConfig}
REF = {"engine": JaxServingEngine, "faults": (JaxFault, JaxFaultInjector),
       "resilience": JaxResilienceConfig}


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


def _same_streams(a, ua, b, ub):
    """Request for request: equal finish reasons and greedy tokens."""
    for x, y in zip(ua, ub):
        assert a.done[x].finish_reason == b.done[y].finish_reason
        np.testing.assert_array_equal(np.asarray(a.done[x].output),
                                      np.asarray(b.done[y].output))


# --------------------------------------------------- allocator fork/CoW/free
def test_fork_cow_refcount_mechanics():
    """fork_prefix bumps refcounts, cow_range detaches exactly the shared
    pages in range, and a page returns to the free list only when its LAST
    reference drops."""
    a = PageAllocator(3, 8, 16, 4)
    a.alloc(0, 30)                            # 4 private pages
    with pytest.raises(ValueError, match="cannot share"):
        a.fork_prefix(2, 1, 8)                # src owns nothing
    assert a.fork_prefix(0, 1, 20) == 3       # 3 pages cover 20 positions
    with pytest.raises(ValueError, match="already owns"):
        a.fork_prefix(0, 1, 8)                # dst must start empty
    assert a.shared_page_count() == 3
    np.testing.assert_array_equal(a.table[1, :3], a.table[0, :3])
    a.extend_row(1, 30)                       # private tail page
    assert a.table[1, 3] != a.table[0, 3]
    pairs = a.cow_range(1, 20, 30)            # only the boundary page
    assert len(pairs) == 1
    src, dst = pairs[0]
    assert src == a.owned[0][2] and a.owned[1][2] == dst and src != dst
    assert a.shared_page_count() == 2
    assert a.cow_range(1, 20, 30) == []       # already private
    follower_pages = list(a.owned[1])
    a.free_row(0)                             # the leader retires first
    assert all(p not in a.free for p in follower_pages)
    assert a.shared_page_count() == 0
    a.free_row(1)
    a.assert_no_leaks()
    a.alloc(0, 8)
    a.fork_prefix(0, 1, 8)
    with pytest.raises(RuntimeError, match="1 of them shared"):
        a.assert_no_leaks()
    a.free_row(1)
    a.free_row(0)
    a.assert_no_leaks()


def test_cow_without_free_pages_raises():
    a = PageAllocator(2, 8, 3, 2)             # 2 allocatable pages
    a.alloc(0, 16)
    a.fork_prefix(0, 1, 16)
    with pytest.raises(ValueError, match="no free page"):
        a.cow_range(1, 0, 16)


def test_double_free_of_shared_page_detected():
    a = PageAllocator(2, 8, 8, 2)
    a.alloc(0, 16)
    a.fork_prefix(0, 1, 16)
    a.free.append(a.owned[1][0])              # corrupt: shared AND free
    with pytest.raises(ValueError, match="double free"):
        a.free_row(1)


# ------------------------------------------------ the path's in-place helpers
def _paged_pair(seed=0):
    """The same random paged cache for both sides: 2 layers, pool of 6
    pages of 4, 2 KV heads of 8; the port's page axis is 0, the
    reference's 1 (leading period axis of one)."""
    rng = np.random.default_rng(seed)
    layers = [{k: rng.standard_normal((6, 4, 2, 8)).astype(np.float32)
               for k in ("k_pages", "v_pages")} for _ in range(2)]
    table = np.array([[1, 2, 0], [3, 2, 5]], np.int32)
    port = {"layers": [{k: torch.from_numpy(v.copy()) for k, v in l.items()}
                       for l in layers],
            "lengths": torch.zeros((2,), dtype=torch.int32),
            "pages": {"table": torch.from_numpy(table.copy())}}
    ref = {"layers": [{k: jnp.asarray(v[None]) for k, v in l.items()}
                      for l in layers],
           "lengths": jnp.zeros((2,), jnp.int32),
           "pages": {"table": jnp.asarray(table)}}
    return port, ref


def test_copy_cache_pages_in_place_matches_reference():
    port, ref = _paged_pair()
    pools = [l["k_pages"] for l in port["layers"]]
    pairs = [(2, 4), (5, 1), (0, 0), (0, 0)]          # pow2-padded pairs
    out = copy_cache_pages(port, pairs)
    want = jax_copy_cache_pages(ref, pairs)
    for lo, lw, pool in zip(out["layers"], want["layers"], pools):
        assert lo["k_pages"] is pool                  # written in place
        for k in ("k_pages", "v_pages"):
            np.testing.assert_array_equal(lo[k].numpy(),
                                          np.asarray(lw[k])[0])
    with pytest.raises(ValueError, match="not a paged cache"):
        copy_cache_pages({"layers": [], "lengths": torch.zeros(1)}, pairs)


@pytest.mark.parametrize("row", [0, 1])
def test_poison_cache_row_in_place_matches_reference(row):
    """Paged: every page the row's table maps but trash page 0, the page
    it shares with the other row included; dense: the whole row."""
    port, ref = _paged_pair()
    pool = port["layers"][0]["v_pages"]
    out = poison_cache_row(port, row)
    want = jax_poison_cache_row(ref, row)
    assert out["layers"][0]["v_pages"] is pool
    for lo, lw in zip(out["layers"], want["layers"]):
        for k in ("k_pages", "v_pages"):
            np.testing.assert_array_equal(lo[k].numpy(),
                                          np.asarray(lw[k])[0])
    assert torch.isnan(pool[2]).all() and torch.isfinite(pool[0]).all()
    dense = {"layers": [{"k": torch.zeros((3, 5, 2, 4))}],
             "lengths": torch.zeros((3,), dtype=torch.int32)}
    poison_cache_row(dense, row)
    nan = torch.isnan(dense["layers"][0]["k"]).flatten(1).all(1)
    assert nan.tolist() == [i == row for i in range(3)]


# --------------------------------------------------------- end-to-end stream
# 20 shared tokens with pages of 8: two whole shared pages and a shared
# BOUNDARY page every follower must copy before its tail prefill
SHARED, TAIL, N_REQ = 20, 4, 3


def _shared_stream(side, models, *, sharing, n=N_REQ, max_new=6, **kw):
    """n requests with one SHARED-token system prompt and distinct
    TAIL-token suffixes, all at round 0 (the stagger path)."""
    kw.setdefault("kv_layout", "paged")
    kw.setdefault("page_size", 8)
    eng = _engine(side, models, prefix_sharing=sharing, seed=3, **kw)
    rng = np.random.default_rng(3)
    sys_toks = rng.integers(3, 500, size=SHARED)
    uids = [eng.submit(
        np.concatenate([sys_toks,
                        rng.integers(3, 500, size=TAIL)]).astype(np.int32),
        max_new_tokens=max_new, arrival_round=0) for _ in range(n)]
    eng.run()
    return eng, uids


@pytest.fixture(scope="module")
def ref_plain(models):
    return _shared_stream(REF, models, sharing=False)


@pytest.fixture(scope="module")
def ref_shared(models):
    return _shared_stream(REF, models, sharing=True)


def test_shared_stream_byte_identical_and_prefilled_once(models, ref_plain,
                                                         ref_shared):
    """The port's shared stream emits the unshared stream's tokens, the
    target prefills the common prefix once (tail-sized admissions), the
    pool drains leak-free, and tokens, counters and tail shapes equal the
    reference's shared stream."""
    plain, pu = _shared_stream(PORT, models, sharing=False)
    share, su = _shared_stream(PORT, models, sharing=True)
    _same_streams(plain, pu, share, su)
    assert all(share.done[u].finish_reason == "length" for u in su)
    fc = share.fault_counters
    assert fc["prefix_hits"] == N_REQ - 1
    assert fc["prefix_shared_tokens"] == (N_REQ - 1) * SHARED
    assert fc["prefix_staggered"] == N_REQ - 1
    assert fc["cow_copies"] == N_REQ - 1
    traces = share.session_stats()["model"]["prefix_traces"]
    assert traces and all(tt < SHARED for tt, _ in traces)
    assert sum(r for _, r in traces) >= N_REQ - 1
    report = share.reports[-1]
    assert sum(s.shared_tokens for s in report.steps) == (N_REQ - 1) * SHARED
    assert sum(s.admit_tokens for s in report.steps) < \
        sum(s.admit_tokens for s in plain.reports[-1].steps)
    share._slot_scheduler._alloc.assert_no_leaks()
    # against the reference, both streams
    for (jeng, ju), (eng, u) in ((ref_plain, (plain, pu)),
                                 (ref_shared, (share, su))):
        _same_streams(jeng, ju, eng, u)
        assert eng.fault_counters == jeng.fault_counters
    jst = ref_shared[0].session_stats()["model"]
    assert traces == jst["prefix_traces"]
    assert [(s.live, s.gamma, s.admit_rows, s.admit_tokens, s.shared_tokens)
            for s in report.steps] == \
        [(s.live, s.gamma, s.admit_rows, s.admit_tokens, s.shared_tokens)
         for s in ref_shared[0].reports[-1].steps]


def _with_late(side, models, **kw):
    """A leader with a short budget and two long-budget followers, then an
    unrelated 50-token prompt at round 4 that needs 8 fresh pages."""
    kw.setdefault("kv_layout", "paged")
    kw.setdefault("page_size", 8)
    eng = _engine(side, models, seed=3, **kw)
    rng = np.random.default_rng(3)
    sys_toks = rng.integers(3, 500, size=SHARED)
    uids = [eng.submit(
        np.concatenate([sys_toks, rng.integers(3, 500, size=TAIL)])
        .astype(np.int32), max_new_tokens=m, arrival_round=0)
        for m in (4, 10, 10)]
    uids.append(eng.submit(rng.integers(3, 500, size=50).astype(np.int32),
                           max_new_tokens=8, arrival_round=4))
    eng.run()
    return eng, uids


def test_preempting_a_fork_never_frees_sibling_pages(models):
    """A pool capped at its initial 16 pages: the late arrival preempts the
    youngest fork after the leader retired (the shared pages live on the
    followers' references alone); every request still finishes with the
    unshared stream's tokens, leak-free, as in the reference."""
    ref, ru = _with_late(PORT, models, prefix_sharing=False)
    eng, uids = _with_late(PORT, models, prefix_sharing=True,
                           resilience=ResilienceConfig(max_pool_pages=16))
    jeng, ju = _with_late(REF, models, prefix_sharing=True,
                          resilience=JaxResilienceConfig(max_pool_pages=16))
    assert eng.fault_counters["prefix_hits"] >= 1
    assert eng.fault_counters["preemptions"] >= 1
    assert eng.fault_counters["requeues"] >= 1
    assert all(eng.done[u].finish_reason in ("length", "eos") for u in uids)
    _same_streams(ref, ru, eng, uids)
    _same_streams(jeng, ju, eng, uids)
    assert eng.fault_counters == jeng.fault_counters
    eng._slot_scheduler._alloc.assert_no_leaks()


def test_injected_page_exhaustion_with_sharing_recovers(models, ref_plain):
    """Scripted page holds while shared pages are live: admissions defer,
    nothing double-frees, and the stream emits the unshared, uninjected
    tokens; the reference under the same script counts the same."""
    runs = {}
    for side in (PORT, REF):
        F, Inj = side["faults"]
        inj = Inj([F(round=1, kind="page_exhaustion", hold_rounds=2)])
        runs[id(side)] = (_shared_stream(side, models, sharing=True,
                                         fault_injector=inj), inj)
    (eng, su), inj = runs[id(PORT)]
    (jeng, ju), jinj = runs[id(REF)]
    assert inj.injected["page_exhaustion"] >= 1
    assert inj.injected == jinj.injected
    _same_streams(ref_plain[0], ref_plain[1], eng, su)
    assert eng.fault_counters == jeng.fault_counters
    eng._slot_scheduler._alloc.assert_no_leaks()


def test_pressure_admission_order_parity(models, ref_shared):
    fifo, fu = _shared_stream(PORT, models, sharing=True)
    pres, qu = _shared_stream(PORT, models, sharing=True,
                              admission_order="pressure")
    _same_streams(fifo, fu, pres, qu)
    _same_streams(ref_shared[0], ref_shared[1], pres, qu)


# ------------------------------------------------------------- construction
def test_misconfiguration_fails_at_construction(models):
    """The reference's refusals, raised by the port's constructor."""
    with pytest.raises(ValueError, match="prefix_sharing"):
        _engine(PORT, models, prefix_sharing=True)           # dense KV
    with pytest.raises(ValueError, match="admission_order"):
        _engine(PORT, models, admission_order="lifo")
    with pytest.raises(ValueError, match="pressure"):
        _engine(PORT, models, admission_order="pressure")    # dense KV
    swa = Model(port_config(SWACFG), device="cpu")
    _, td, _, tpd = models[id(PORT)]
    with pytest.raises(ValueError, match="cannot share"):
        ServingEngine(swa, td, None, tpd, max_batch=3, scheduler="continuous",
                      kv_layout="paged", page_size=8, prefix_sharing=True)
