"""Port's admission paths against the reference, CPU.

Mirrors tests/test_admission.py on the port: the page allocator's
bookkeeping, the two admission primitives (row scatter ≡ row merge), the
sliced admission's shapes (keyed on the admitted rows, bucket reset per
refill), a late request the stream was not sized for (rejected on a dense
cache, admitted by growth on a paged one), watermark backpressure, a
request too large for the pool cap, an SWA target's paged growth (its
capacity floored at the ring width), and chunked prefill (one chunk per
round boundary) against the one-shot admission, dense and paged, with a
growth while a chunked admission is in flight.  Where the reference runs
the same stream, the port's admission and chunk traces, growths and greedy
outputs equal its.  The EAGLE proposer's feature carry goes through the
same admissions: a continuous stream with refills equals its own wave
decode and the reference's stream, and so does a paged stream with prefix
sharing and chunked admission.

Same weights on both sides (``model_pair``), fp32, TF32 off.
"""
import jax
import numpy as np
import pytest
import torch

from _torch_parity import CPU, model_pair
from repro.configs.base import ModelConfig
from repro.core.eagle import EagleHead as JaxEagleHead
from repro.models.model import PageAllocator as JaxPageAllocator
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro_torch.core.eagle import EagleHead
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import (PageAllocator, merge_cache_rows,
                                      scatter_cache_rows)
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.faults import ResilienceConfig

TCFG = ModelConfig("ad-moe", "moe", 2, 128, 4, 2, 256, 512, num_experts=4,
                   num_experts_per_tok=2, dtype="float32")
DCFG = ModelConfig("ad-draft", "dense", 2, 64, 2, 2, 128, 512,
                   dtype="float32")


@pytest.fixture(scope="module")
def models():
    jt, jpt, tt, tpt = model_pair(TCFG, seed=0)
    jd, jpd, td, tpd = model_pair(DCFG, seed=1)
    return (jt, jd, jpt, jpd), (tt, td, tpt, tpd)


def _engine(cls, m, **kw):
    kw.setdefault("max_batch", 2)
    kw.setdefault("gamma", 2)
    kw.setdefault("force_sd", True)
    kw.setdefault("scheduler", "continuous")
    return cls(*m, **kw)


class _MidStreamSubmitter:
    """Stub tuner that injects one LONG request while the stream runs: the
    late submit that stream-start sizing cannot see."""

    gammas = (2,)
    alpha = 0.0

    def __init__(self, engine_ref, at_call=3, prompt_len=40):
        self.engine_ref = engine_ref
        self.at_call = at_call
        self.prompt_len = prompt_len
        self.calls = 0
        self.uid = None

    def plan(self, batch):
        self.calls += 1
        if self.calls == self.at_call and self.uid is None:
            self.uid = self.engine_ref[0].submit(
                np.arange(3, 3 + self.prompt_len), max_new_tokens=6)
        return {"use_sd": True, "gamma": 2, "predicted_speedup": 2.0}

    def update_alpha(self, alpha):
        pass


def _late_long_stream(cls, m, max_new_first=(8, 12), **kw):
    """Two short requests and one long one submitted mid-stream."""
    ref = []
    tuner = _MidStreamSubmitter(ref)
    eng = _engine(cls, m, tuner=tuner, **kw)
    ref.append(eng)
    uids = [eng.submit(np.arange(3, 9), max_new_tokens=max_new_first[0]),
            eng.submit(np.arange(3, 10), max_new_tokens=max_new_first[1])]
    eng.run()
    return eng, uids, tuner.uid


def _refill_stream(cls, m, mode):
    eng = _engine(cls, m, max_batch=4, admit_mode=mode)
    uids = [eng.submit(np.arange(3, 9), max_new_tokens=n)
            for n in (4, 10, 6, 8)]
    uids.append(eng.submit(np.arange(3, 9), max_new_tokens=4,
                           arrival_round=4))
    eng.run()
    return eng, uids


@pytest.fixture(scope="module")
def jax_streams(models):
    """Each reference stream this module compares with, built once."""
    jm, _ = models
    return {
        "sliced": _refill_stream(JaxServingEngine, jm, "sliced"),
        "full": _refill_stream(JaxServingEngine, jm, "full"),
        "paged_late": _late_long_stream(JaxServingEngine, jm,
                                        kv_layout="paged", page_size=8),
    }


# ---------------------------------------------------------------- allocator
def _both_allocators(*args):
    return PageAllocator(*args), JaxPageAllocator(*args)


def test_page_allocator_alloc_free_and_leaks_match_reference():
    ours, theirs = _both_allocators(3, 8, 9, 4)
    for a in (ours, theirs):
        a.alloc(0, 20)                          # 3 pages
        a.alloc(2, 8)                           # 1 page
    np.testing.assert_array_equal(ours.table, theirs.table)
    assert ours.free == theirs.free and ours.free_fraction() == 0.5
    assert ours.can_alloc(32) and not ours.can_alloc(33)
    with pytest.raises(ValueError, match="already owns"):
        ours.alloc(0, 8)
    with pytest.raises(RuntimeError, match="rows still own pages"):
        ours.assert_no_leaks()
    for a in (ours, theirs):
        a.free_row(0)
        a.free_row(1)                           # owns nothing: a no-op
    np.testing.assert_array_equal(ours.table, theirs.table)
    assert ours.free == theirs.free
    ours.free_row(2)
    ours.assert_no_leaks()


def test_page_allocator_double_free_raises():
    a = PageAllocator(2, 8, 5, 2)
    a.alloc(0, 16)
    page = a.owned[0][0]
    a.free.append(page)                         # corrupt the bookkeeping
    with pytest.raises(ValueError, match="double free"):
        a.free_row(0)
    b = PageAllocator(2, 8, 5, 2)
    pages = b.reserve(2)
    b.release(pages)
    with pytest.raises(ValueError, match="not reserved"):
        b.release(pages[:1])


def test_page_allocator_grow_and_geometry_match_reference():
    ours, theirs = _both_allocators(2, 8, 5, 2)
    for a in (ours, theirs):
        a.alloc(0, 16)
    assert ours.grown_geometry(40) == theirs.grown_geometry(40) == (10, 8)
    for a in (ours, theirs):
        a.grow(*a.grown_geometry(40))
        a.alloc(1, 40)
    np.testing.assert_array_equal(ours.table, theirs.table)
    assert ours.table.shape == (2, 8) and ours.pool_pages == 10
    assert sorted(ours.free) == sorted(theirs.free)
    for r in (0, 1):
        ours.free_row(r)
    ours.assert_no_leaks()


def test_page_allocator_fork_extend_cow_match_reference():
    ours, theirs = _both_allocators(2, 4, 9, 4)
    pairs = []
    for a in (ours, theirs):
        a.alloc(0, 12)
        assert a.fork_prefix(0, 1, 8) == 2
        assert a.extend_row(1, 12) == 1
        pairs.append(a.cow_range(1, 6, 12))
        assert a.shared_page_count() == 1
    assert pairs[0] == pairs[1] and len(pairs[0]) == 1
    np.testing.assert_array_equal(ours.table, theirs.table)
    ours.free_row(0)
    ours.free_row(1)
    ours.assert_no_leaks()


# ------------------------------------------------------------- primitives
def test_scatter_cache_rows_matches_merge(models):
    """scatter (compact fresh rows) ≡ merge (full-bucket fresh rows) on a
    dense cache; a padding lane (valid False) scatters nothing."""
    _, (t, _, pt, _) = models
    Bq, max_seq = 4, 32
    toks = np.random.default_rng(0).integers(3, 200, (Bq, 6)).astype(np.int32)
    lengths = np.full((Bq,), 6, np.int32)
    _, live = t.prefill(pt, toks, t.init_cache(Bq, max_seq), lengths=lengths)
    _, fresh_full = t.prefill(pt, toks + 1, t.init_cache(Bq, max_seq),
                              lengths=lengths)
    rows = np.array([1, 3])
    mask = np.zeros((Bq,), bool)
    mask[rows] = True
    # both primitives write in place: scatter into a copy of the live cache
    live_copy = {"layers": [{k: v.clone() for k, v in lo.items()}
                            for lo in live["layers"]],
                 "lengths": live["lengths"].clone()}
    merged = merge_cache_rows(live, fresh_full, mask)
    # the compact prefill carries a pad lane replicating row 1
    lanes = np.array([1, 3, 1])
    _, fresh_rows = t.prefill(pt, toks[lanes] + 1, t.init_cache(3, max_seq),
                              lengths=lengths[lanes])
    scattered = scatter_cache_rows(live_copy, fresh_rows, lanes,
                                   valid=np.array([True, True, False]))
    np.testing.assert_array_equal(merged["lengths"].numpy(),
                                  scattered["lengths"].numpy())
    for lm, ls in zip(merged["layers"], scattered["layers"]):
        for k in lm:
            torch.testing.assert_close(lm[k], ls[k], rtol=0, atol=0)


# ----------------------------------------------------------------- streams
def test_sliced_admit_keyed_on_admitted_rows_like_reference(models,
                                                            jax_streams):
    """A 1-row refill into a pool of 4 runs at rows=1, the full path at
    rows=pool, and both admission trace logs equal the reference's for
    the same stream, as do the greedy outputs."""
    jm, tm = models
    traces = {}
    for mode in ("sliced", "full"):
        eng, uids = _refill_stream(ServingEngine, tm, mode)
        jeng, juids = jax_streams[mode]
        assert len(eng.done) == 5
        traces[mode] = eng.session_stats()["model"]["admit_traces"]
        assert traces[mode] == jeng.session_stats()["model"]["admit_traces"]
        for u, ju in zip(uids, juids):
            np.testing.assert_array_equal(eng.done[u].output,
                                          jeng.done[ju].output)
    assert (8, 4) in traces["sliced"] and (8, 1) in traces["sliced"]
    assert all(r == 4 for _, r in traces["full"])


def test_admission_bucket_resets_per_refill(models):
    """One long prompt does not ratchet the admission bucket: later short
    refills prefill at their own, smaller bucket."""
    _, tm = models
    eng = _engine(ServingEngine, tm)
    eng.submit(np.arange(3, 19), max_new_tokens=4)            # bucket 16
    eng.submit(np.arange(3, 9), max_new_tokens=4)             # bucket 8
    eng.submit(np.arange(3, 9), max_new_tokens=4, arrival_round=3)
    eng.submit(np.arange(3, 9), max_new_tokens=4, arrival_round=5)
    eng.run()
    traces = eng.session_stats()["model"]["admit_traces"]
    assert (16, 2) in traces and (8, 1) in traces
    assert all(t <= 16 for t, _ in traces)


def test_late_oversize_request_rejected_not_fatal(models):
    """Dense stream: a mid-stream request beyond the stream's sizing
    finishes "rejected" with no output; the rest complete."""
    _, tm = models
    eng, uids, late = _late_long_stream(ServingEngine, tm)
    assert late is not None
    assert eng.done[late].finish_reason == "rejected"
    assert len(eng.done[late].output) == 0
    assert all(eng.done[u].finish_reason == "length" for u in uids)
    assert [len(eng.done[u].output) for u in uids] == [8, 12]


def test_paged_session_grows_for_late_long_prompt(models, jax_streams):
    """Paged stream: the same late long request is admitted through pool
    growth (logged) and served; every output equals the reference's paged
    stream, and the short requests' outputs equal the dense stream's."""
    _, tm = models
    dense, d_uids, _ = _late_long_stream(ServingEngine, tm)
    paged, p_uids, late = _late_long_stream(ServingEngine, tm,
                                            kv_layout="paged", page_size=8)
    jeng, j_uids, j_late = jax_streams["paged_late"]
    assert paged.done[late].finish_reason == "length"
    assert len(paged.done[late].output) == 6
    growths = paged.session_stats()["model"]["growths"]
    assert growths and growths == jeng.session_stats()["model"]["growths"]
    for du, pu, ju in zip(d_uids, p_uids, j_uids):
        np.testing.assert_array_equal(dense.done[du].output,
                                      paged.done[pu].output)
        np.testing.assert_array_equal(paged.done[pu].output,
                                      jeng.done[ju].output)
    np.testing.assert_array_equal(paged.done[late].output,
                                  jeng.done[j_late].output)
    assert (paged.session_stats()["model"]["admit_traces"]
            == jeng.session_stats()["model"]["admit_traces"])
    paged._slot_scheduler._alloc.assert_no_leaks()


def test_paged_growth_swa_target():
    """SWA target under paged KV: the logical capacity starts at the full
    ring width (window + pad), so the mid-stream growth for a late long
    request never resizes a live ring; the short requests equal the dense
    stream's, and every request equals the reference's paged stream."""
    swa_cfg = ModelConfig("ad-swa", "dense", 2, 128, 4, 2, 256, 512,
                          layer_pattern=("swa", "attn"), sliding_window=6,
                          dtype="float32")
    jt, jpt, tt, tpt = model_pair(swa_cfg)
    jd, jpd, td, tpd = model_pair(DCFG, seed=1)
    port, ref = (tt, td, tpt, tpd), (jt, jd, jpt, jpd)
    dense, d_uids, _ = _late_long_stream(ServingEngine, port,
                                         max_new_first=(8, 10))
    paged, p_uids, long_uid = _late_long_stream(
        ServingEngine, port, max_new_first=(8, 10), kv_layout="paged",
        page_size=8)
    jpaged, j_uids, j_long = _late_long_stream(
        JaxServingEngine, ref, max_new_first=(8, 10), kv_layout="paged",
        page_size=8)
    assert paged.done[long_uid].finish_reason == "length"
    assert len(paged.done[long_uid].output) == 6
    assert paged.session_stats()["model"]["growths"]
    for du, pu in zip(d_uids, p_uids):
        np.testing.assert_array_equal(dense.done[du].output,
                                      paged.done[pu].output)
    for pu, ju in zip(p_uids + [long_uid], j_uids + [j_long]):
        np.testing.assert_array_equal(paged.done[pu].output,
                                      jpaged.done[ju].output)


def test_watermark_backpressure_defers_then_admits(models):
    """free_page_watermark defers an admission that would drain the pool
    below the watermark while another slot is live, admits it once the
    pool idles, leaks nothing, and changes no greedy output."""
    _, tm = models

    def run(watermarked):
        res = ResilienceConfig(free_page_watermark=0.5,
                               max_pool_pages=8) if watermarked else None
        eng = _engine(ServingEngine, tm, kv_layout="paged", page_size=8,
                      resilience=res)
        ua = eng.submit(np.arange(3, 9), max_new_tokens=16)
        ub = eng.submit(np.arange(4, 10), max_new_tokens=8, arrival_round=1)
        eng.run()
        return eng, (ua, ub)

    ref, (ra, rb) = run(watermarked=False)
    eng, (ua, ub) = run(watermarked=True)
    assert eng.fault_counters["admit_deferred"] >= 1
    assert eng.session_stats()["resilience"]["admit_deferred"] >= 1
    for u_ref, u in ((ra, ua), (rb, ub)):
        assert eng.done[u].finish_reason == "length"
        np.testing.assert_array_equal(eng.done[u].output,
                                      ref.done[u_ref].output)
    assert eng.done[ub].readmit_round is None  # deferral, not preemption
    eng._slot_scheduler._alloc.assert_no_leaks()


def test_oversize_request_at_pool_cap_rejected(models):
    """A request that cannot fit a drained pool at max_pool_pages finishes
    "rejected"; co-streamed work completes and no page leaks."""
    _, tm = models
    eng = _engine(ServingEngine, tm, kv_layout="paged", page_size=8,
                  resilience=ResilienceConfig(max_pool_pages=8))
    ua = eng.submit(np.arange(3, 9), max_new_tokens=8)
    ub = eng.submit(np.arange(3, 9), max_new_tokens=64, arrival_round=1)
    eng.run()
    assert eng.done[ub].finish_reason == "rejected"
    assert len(eng.done[ub].output) == 0
    assert eng.done[ua].finish_reason == "length"
    assert len(eng.done[ua].output) == 8
    eng._slot_scheduler._alloc.assert_no_leaks()


# ------------------------------------------------------------ chunked prefill
def _chunk_stream(cls, m, chunk, layout):
    """16-token prompts in 4-token chunks (paged: pages of 8, and a 40-token
    prompt at round 2 whose admission grows the session while a chunked
    admission is in flight)."""
    eng = _engine(cls, m, prefill_chunk=chunk, kv_layout=layout,
                  page_size=8)
    uids = [eng.submit(np.arange(3, 19), max_new_tokens=n) for n in (6, 9, 5)]
    if layout == "paged":
        uids.append(eng.submit(np.arange(3, 43), max_new_tokens=4,
                               arrival_round=2))
    (report,) = eng.run()
    return eng, uids, report


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_chunked_prefill_matches_one_shot(models, layout):
    """Chunked prefill is greedy token-identical to the one-shot sliced
    admission; its chunk log holds the three stages, each chunk of the
    stream is counted, and tokens, chunk traces and growths equal the
    reference's chunked stream."""
    jm, tm = models
    one, ou, _ = _chunk_stream(ServingEngine, tm, None, layout)
    eng, uids, rep = _chunk_stream(ServingEngine, tm, 4, layout)
    jeng, juids, _ = _chunk_stream(JaxServingEngine, jm, 4, layout)
    for u, ju in zip(uids, juids):
        np.testing.assert_array_equal(one.done[u].output, eng.done[u].output)
        np.testing.assert_array_equal(eng.done[u].output,
                                      np.asarray(jeng.done[ju].output))
        assert eng.done[u].finish_reason == jeng.done[ju].finish_reason
    st, jst = eng.session_stats()["model"], jeng.session_stats()["model"]
    assert {s for s, _, _ in st["chunk_traces"]} == {"first", "mid", "final"}
    assert st["chunk_traces"] == jst["chunk_traces"]
    assert st["growths"] == jst["growths"]
    prompts = [16, 16, 16] + ([40] if layout == "paged" else [])
    assert sum(s.chunk_steps for s in rep.steps) == sum(n // 4
                                                        for n in prompts)
    if layout == "paged":
        assert st["growths"]
        eng._slot_scheduler._alloc.assert_no_leaks()


# ------------------------------------------------------------- eagle carry
@pytest.fixture(scope="module")
def eagle(models):
    """Both targets with an EAGLE head on one set of head weights:
    (target, head, params_t, params_head) for the reference, then the
    port."""
    (jt, _, jpt, _), (tt, _, tpt, _) = models
    jh = JaxEagleHead(jt)
    jph = jh.init(jax.random.PRNGKey(2))
    th = EagleHead(tt)
    return (jt, jh, jpt, jph), (tt, th, tpt,
                                params_from_jax(jax.device_get(jph), th.cfg,
                                                CPU))


def test_eagle_proposer_sliced_admission(eagle):
    """The sliced scatter covers the feature carry: an EAGLE continuous
    stream with refills matches its own wave decode, and the reference's
    continuous stream."""
    jm, tm = eagle
    outs = {}
    for name, cls, m, sched in (("wave", ServingEngine, tm, "wave"),
                                ("port", ServingEngine, tm, "continuous"),
                                ("ref", JaxServingEngine, jm, "continuous")):
        eng = cls(*m, max_batch=2, gamma=2, force_sd=True, proposer="eagle",
                  scheduler=sched)
        uids = [eng.submit(np.arange(3, 9), max_new_tokens=6)
                for _ in range(3)]
        eng.run()
        outs[name] = [np.asarray(eng.done[u].output) for u in uids]
    for a, b, c in zip(outs["wave"], outs["port"], outs["ref"]):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(b, c)


def test_eagle_prefix_shared_chunked_stream_matches_reference(eagle):
    """Paged EAGLE stream, pages of 16, prefix sharing and chunks of 16:
    three requests behind a 20-token shared prefix (tail admissions carry
    the feature at each tail's last position) and a 40-token prompt at
    round 2 (the final chunk carries its last position's feature): the
    reference's tokens, finish reasons, prefix counters and traces."""
    jm, tm = eagle
    engines = [cls(*m, max_batch=2, gamma=2, force_sd=True, proposer="eagle",
                   scheduler="continuous", kv_layout="paged", page_size=16,
                   prefix_sharing=True, prefill_chunk=16)
               for cls, m in ((ServingEngine, tm), (JaxServingEngine, jm))]
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
    assert eng.fault_counters.get("prefix_hits", 0) >= 1
    assert eng.fault_counters == jeng.fault_counters
    st, jst = eng.session_stats()["eagle"], jeng.session_stats()["eagle"]
    for key in ("prefix_traces", "chunk_traces", "admit_traces"):
        assert st[key] == jst[key], key
    eng._slot_scheduler._alloc.assert_no_leaks()
