"""The SD round captured in CUDA graphs, on the card.

Marked ``gpu``: a fixture asks whether a card and ``nvcc`` are there and
skips with the reason when not.  Run on a machine with an NVIDIA GPU:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu_graphs.py

On the reduced qwen2-57b-a14b target and qwen2-0.5b draft in fp32 (TF32
off): greedy outputs from graph replay equal the eager card path's and the
CPU path's token for token, on the wave and the continuous paged paths with
the "model" and "none" proposers; at temperature > 0 every replay draws
fresh numbers from the engine's generator, and rejection sampling replayed
keeps tests/test_rejection.py::test_lossless_distribution's bound; kernel
launches and forwards are credited per replay; warm replays make no host
sync; a repeated shared-prefix stream with chunked admissions captures
nothing and equals eager and CPU, and the fault smoke lane passes.  The
EAGLE and prefetch proposers' rounds replay to the bit of their eager
rounds in bf16 and fp32 (and equal the CPU's in fp32, the prefetch hit
counts too); a replayed prefetch round makes no host sync, its warm stage
is captured once per key into fixed buffers, and ``session_stats()``
carries the session's prefetch totals.  gemma3-12b-reduced (SWA rings
in the session arenas) replays equal to eager and the CPU, wave and
continuous paged.  SD rounds over recurrent states (a Mamba hybrid target,
an mLSTM/sLSTM draft), with a row inactive on every other round, replay
equal to eager and the CPU, states included, with no host sync.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_config
from repro_torch.core.graphs import KERNEL_MODULES, RoundGraphs
from repro_torch.core.proposer import make_proposer
from repro_torch.core.rejection import rejection_sample, sample_from
from repro_torch.core.spec_decode import SDEngine
from repro_torch.data.pipeline import prompt_batch
from repro_torch.models.model import Model
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.scheduler import submit_poisson

pytestmark = pytest.mark.gpu

TARGET = get_config("qwen2-57b-a14b", reduced=True)
DRAFT = get_config("qwen2-0.5b", reduced=True)
PATHS = ["wave/model", "wave/none", "continuous/model", "continuous/none"]


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    from repro_torch.kernels import build
    try:
        build.find_nvcc()
    except RuntimeError as e:
        pytest.skip(str(e))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


@pytest.fixture(scope="module")
def models(cuda):
    """{device: (target, draft, params_t, params_d)}, one set of weights."""
    out = {}
    pt = Model(TARGET, moe_dispatch="gmm", device="cpu").init(
        torch.Generator().manual_seed(0))
    pd = Model(DRAFT, device="cpu").init(torch.Generator().manual_seed(1))
    for dev in ("cpu", "cuda"):
        out[dev] = (Model(TARGET, moe_dispatch="gmm", device=dev),
                    Model(DRAFT, device=dev), _to(pt, dev), _to(pd, dev))
    return out


def _engine(m, kind, sched, **kw):
    t, d, pt, pd = m
    extra = (dict(scheduler="continuous", kv_layout="paged", page_size=16)
             if sched == "continuous" else {})
    return ServingEngine(t, d if kind == "model" else None, pt,
                         pd if kind == "model" else None, max_batch=4,
                         gamma=4, proposer=kind, seed=0, **extra, **kw)


def _serve(eng, sched):
    """One workload: 6 waves' worth of prompts, or a Poisson stream with a
    late long prompt that grows the paged pool.  Returns {uid: tokens}."""
    pb = prompt_batch(TARGET.vocab_size, 6, seed=3, min_len=5, max_len=24)
    if sched == "continuous":
        submit_poisson(eng, pb["tokens"], pb["lengths"], rate=0.5,
                       max_new_choices=(4, 8, 12), seed=0)
        long = np.random.default_rng(0).integers(3, TARGET.vocab_size, 150)
        eng.submit(long, max_new_tokens=8, arrival_round=3)
    else:
        for i in range(6):
            eng.submit(pb["tokens"][i][: int(pb["lengths"][i])],
                       max_new_tokens=12)
    first = len(eng.done)
    eng.run()
    return {u - first: eng.done[u].output for u in sorted(eng.done)
            if u > first}


@pytest.mark.parametrize("path", PATHS)
def test_replay_equals_eager_and_cpu_greedy(models, path):
    """Greedy fp32: graph replay == eager on the card == the CPU path,
    token for token, over two runs of one workload (the second replays
    the first one's graphs and captures nothing)."""
    sched, kind = path.split("/")
    graphs = _engine(models["cuda"], kind, sched)
    runs = [_serve(graphs, sched) for _ in range(2)]
    reports = graphs.reports
    n_first = len(reports) // 2
    assert sum(r.captures for r in reports[:n_first]) >= 1
    assert sum(r.captures for r in reports[n_first:]) == 0
    assert sum(r.replays for r in reports[n_first:]) == \
        sum(r.stats.rounds for r in reports[n_first:])
    eager = _serve(_engine(models["cuda"], kind, sched, cuda_graphs=False),
                   sched)
    cpu = _serve(_engine(models["cpu"], kind, sched), sched)
    for other in (runs[1], eager, cpu):
        assert other.keys() == runs[0].keys()
        for uid, toks in runs[0].items():
            np.testing.assert_array_equal(other[uid], toks)


def _snapshot(state):
    trees = (state.t_cache, state.p_state, state.last_token)
    return [t.clone() for t in _leaves(trees)]


def _restore(state, snap):
    for t, s in zip(_leaves((state.t_cache, state.p_state,
                             state.last_token)), snap):
        t.copy_(s)


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return []


def test_replays_draw_fresh_numbers_at_temperature(models):
    """Temperature 1: two replays from the same session state commit
    different samples, each replay advances the generator by the same
    increment, and an eager draw between replays advances it too."""
    t, d, pt, pd = models["cuda"]
    eng = SDEngine(t, make_proposer("model", t, d, temperature=1.0),
                   gamma=4, temperature=1.0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    prompts = np.random.default_rng(0).integers(
        3, TARGET.vocab_size, (4, 9)).astype(np.int32)
    state = eng.start(pt, pd, prompts, max_seq=64, generator=gen)
    state, _ = eng.round(state, generator=gen)          # captures
    assert eng.graphs.total_captures == 1
    snap = _snapshot(state)
    offsets, results = [], []
    for i in range(2):
        _restore(state, snap)
        off = gen.get_offset()
        state, res = eng.round(state, generator=gen)
        offsets.append(gen.get_offset() - off)
        results.append(res.committed.copy())
        before = gen.get_offset()
        torch.rand((4, 8), generator=gen, device="cuda")  # an eager draw
        assert gen.get_offset() > before
    assert eng.graphs.total_replays == 2
    assert offsets[0] == offsets[1] > 0
    assert not np.array_equal(results[0], results[1])
    with pytest.raises(ValueError, match="generator"):
        eng.round(state, generator=torch.Generator(device="cuda"))


@pytest.mark.parametrize("sched", ["wave", "continuous"])
def test_sampled_serving_replays_with_the_engine_generator(models, sched):
    """Temperature 1 through ServingEngine: the engine's one generator
    drives every round; a second identical workload replays (and, in
    waves, whose shapes do not depend on what is sampled, captures nothing)
    and samples other tokens than the first."""
    eng = _engine(models["cuda"], "model", sched, temperature=1.0)
    runs = [_serve(eng, sched) for _ in range(2)]
    n_first = len(eng.reports) // 2
    if sched == "wave":
        assert sum(r.captures for r in eng.reports[n_first:]) == 0
    assert sum(r.replays for r in eng.reports[n_first:]) > 0
    assert runs[0].keys() == runs[1].keys()
    for run in runs:
        for toks in run.values():
            assert toks.min() >= 0 and toks.max() < TARGET.vocab_size
    assert any(not np.array_equal(runs[0][u], runs[1][u]) for u in runs[0])


@pytest.mark.parametrize("seed,vocab,sharp", [
    (0, 2, 0.5), (1, 3, 1.0), (2, 4, 2.0), (3, 5, 3.0), (4, 6, 1.5),
    (5, 6, 0.7)])
def test_rejection_sampling_lossless_under_replay(cuda, seed, vocab, sharp):
    """Drafts from q0 and rejection sampling captured in one graph and
    replayed 4 times (1000 rows each): the emitted-token marginal equals p0
    within tests/test_rejection.py::test_lossless_distribution's bound at
    N = 4000, and the replays drew different numbers."""
    rng = np.random.default_rng(seed)

    def dist():
        x = rng.standard_normal(vocab) * sharp
        e = np.exp(x - x.max())
        return e / e.sum()

    p0, p1, q0 = dist(), dist(), dist()
    n = 1000
    p = torch.tensor(np.stack([np.stack([p0, p1])] * n), dtype=torch.float32,
                     device=cuda)
    q = torch.tensor(np.stack([q0] * n), dtype=torch.float32,
                     device=cuda)[:, None]
    gen = torch.Generator(device=cuda).manual_seed(seed)
    out = torch.empty((n,), dtype=torch.int64, device=cuda)

    def draw():
        drafts = sample_from(q[:, 0], gen, 1.0)[:, None]
        n_acc, nxt, _ = rejection_sample(p, q, drafts, gen, temperature=1.0)
        out.copy_(torch.where(n_acc > 0, drafts[:, 0], nxt))

    draw()                                        # warm-up
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(gen)
    with torch.cuda.graph(graph):
        draw()
    emitted = []
    for _ in range(4):
        graph.replay()
        emitted.append(out.cpu().numpy().copy())
    assert not all(np.array_equal(emitted[0], e) for e in emitted[1:])
    counts = np.bincount(np.concatenate(emitted), minlength=vocab) / (4 * n)
    assert np.abs(counts - p0).max() < 4.5 * np.sqrt(p0.max() / (4 * n)) + 0.02


def _launches():
    return {k: v for m in KERNEL_MODULES for k, v in m.LAUNCHES.items()}


def _reset(models_):
    for m in KERNEL_MODULES:
        m.reset_launch_counts()
    for model in models_:
        model.forward_count = model.prefill_count = 0


@pytest.mark.parametrize("path", ["wave/model", "continuous/model"])
def test_launches_credited_per_replay(models, path):
    """The same workload counts the same kernel launches and forwards from
    graph replays as eagerly, and each MoE layer's two ragged kernels as
    many times as the target ran forwards."""
    sched, kind = path.split("/")
    m = models["cuda"]
    counts = {}
    for graphs in (True, False):
        eng = _engine(m, kind, sched, cuda_graphs=graphs)
        _serve(eng, sched)                        # warm: every key captured
        _reset(m[:2])
        _serve(eng, sched)
        counts[graphs] = (_launches(), m[0].forward_count,
                          m[0].prefill_count, m[1].forward_count)
        if graphs:
            assert sum(r.replays for r in eng.reports[-2:]) > 0
    assert counts[True] == counts[False]
    launches, fwd = counts[True][0], counts[True][1]
    moe_layers = sum(TARGET.moe_pattern[i % TARGET.period]
                     for i in range(TARGET.num_layers))
    assert launches["ragged_gmm"] == launches["fused_gate_up"] == \
        moe_layers * fwd > 0
    if sched == "continuous":
        assert launches["paged_decode_attention"] > 0


@pytest.mark.parametrize("path", PATHS)
def test_warm_replays_make_no_host_sync(models, path):
    """A second identical wave or stream replays every round under
    torch.cuda.set_sync_debug_mode("error") up to its one readback
    (mirrors the transfer half of tests/test_runtime_guards.py's
    test_warm_sd_session_zero_transfers_one_signature and
    test_warm_continuous_stream_zero_transfers_one_signature)."""
    sched, kind = path.split("/")
    eng = _engine(models["cuda"], kind, sched)
    _serve(eng, sched)
    for sess in eng._sessions.values():
        sess.sync_guard = True
    _serve(eng, sched)
    assert torch.cuda.get_sync_debug_mode() == 0
    stats = eng.session_stats()[kind]
    assert stats["replays"] > 0
    assert sum(r.captures for r in eng.reports[len(eng.reports) // 2:]) == 0


def test_dead_graphs_are_not_freed_inside_a_capture(cuda):
    """A dropped session's graphs wait in reference cycles (an engine and
    its scheduler) for the cycle collector, and a graph torn down inside
    another capture invalidates it.  RoundGraphs collects before it
    captures and holds the collector off: here the key's eager run leaves
    a dead cycle holding a graph, and the collector runs inside the
    capture."""
    import gc

    class Holder:
        pass

    x = torch.ones(8, device=cuda)
    out = torch.zeros(8, device=cuda)
    calls = []

    def stage(_):
        if not calls:                    # the key's eager run
            dead = Holder()
            dead.me, dead.graph = dead, torch.cuda.CUDAGraph()
            with torch.cuda.graph(dead.graph):
                x.mul(2)
        else:                            # inside the capture
            gc.collect()
        calls.append(1)
        out.copy_(x + len(calls))

    graphs = RoundGraphs(cuda, capture=True)
    assert graphs.run(("dead",), [stage])         # eager run, then capture
    out.zero_()
    graphs.run(("dead",), [stage])                # replay
    torch.testing.assert_close(out, x + 2)
    assert graphs.total_captures == 1 and graphs.total_replays == 1


def test_round_graphs_reject_the_cpu(cuda):
    with pytest.raises(ValueError, match="CUDA device"):
        RoundGraphs(torch.device("cpu"), capture=True)


class _CycleTuner:
    """Stub tuner that plans the gammas of ``cycle`` in turn, one per call
    (0: an AR round), whatever the batch."""

    gammas = (2, 4)
    alpha = 0.0

    def __init__(self, cycle=(2, 4, 0, 4)):
        self.cycle = cycle
        self.calls = 0
        self.alphas = []

    def plan(self, batch):
        g = self.cycle[self.calls % len(self.cycle)]
        self.calls += 1
        return {"use_sd": g > 0, "gamma": g or 2, "predicted_speedup": 1.0}

    def update_alpha(self, alpha):
        self.alphas.append(alpha)


def _tuned_stream(m, tuner, **kw):
    """Six requests on a dense pool of 4: {uid: tokens}."""
    t, d, pt, pd = m
    eng = ServingEngine(t, d, pt, pd, max_batch=4, gamma=4, seed=0,
                        tuner=tuner, scheduler="continuous", **kw)
    return eng, _serve(eng, "wave")


def test_tuned_gamma_changes_capture_one_key_per_gamma(models):
    """A stream whose gamma changes every round (2 -> 4 -> 0 -> 4, the 0
    an AR round in the same session) captures one graph key per gamma;
    the second identical stream replays every round and captures nothing;
    greedy fp32 outputs equal the fixed-gamma eager stream's token for
    token."""
    m = models["cuda"]
    tuner = _CycleTuner()
    eng, first = _tuned_stream(m, tuner)
    keys = eng.session_stats()["model"]["keys"]
    assert {g for g, _, _ in keys} == {0, 2, 4}
    assert all(c == 1 for c, _ in keys.values()) and len(keys) == 3
    tuner.calls = 0
    again = _serve(eng, "wave")
    second = eng.reports[-1]
    assert second.captures == 0 and second.replays == second.stats.rounds
    assert [s.gamma for s in second.steps][:4] == [2, 4, 0, 4]
    assert len(tuner.alphas) == sum(1 for s in eng.reports[0].steps
                                    if s.used_sd) + sum(
        1 for s in second.steps if s.used_sd)
    _, fixed = _tuned_stream(m, None, cuda_graphs=False)
    for run in (first, again):
        assert run.keys() == fixed.keys()
        for uid, toks in fixed.items():
            np.testing.assert_array_equal(run[uid], toks)


def test_tuned_waves_switch_sessions_and_capture_once(models):
    """Wave serving under the stub: each wave plans its gamma (2, 4, then
    AR through the "none" session); greedy fp32 outputs equal the CPU
    run's under the same stub."""
    outs = {}
    for dev in ("cuda", "cpu"):
        t, d, pt, pd = models[dev]
        eng = ServingEngine(t, d, pt, pd, max_batch=2, gamma=4, seed=0,
                            tuner=_CycleTuner())
        outs[dev] = _serve(eng, "wave")
        assert [r.gamma for r in eng.reports] == [2, 4, 0]
    stats = eng.session_stats()
    assert set(stats) == {"resilience", "model", "none"}
    for uid, toks in outs["cpu"].items():
        np.testing.assert_array_equal(outs["cuda"][uid], toks)


def test_measured_extend_time_replays_a_graph(models):
    """measure_extend_time on the card: one capture, every timed call a
    replay credited to the launch counts and forward_count, positive
    device times, and the caller's cache untouched."""
    from repro_torch.core.target_efficiency import (measure_extend_time,
                                                    measure_target_efficiency)
    t, _, pt, _ = models["cuda"]
    tok = torch.randint(3, TARGET.vocab_size, (4, 16), device="cuda")
    _, cache = t.prefill(pt, tok, t.init_cache(4, 64))
    snap = cache["layers"][0]["k"].clone()
    _reset([t])
    ms = measure_extend_time(t, pt, cache, 5, iters=3, warmup=2)
    assert ms > 0 and t.forward_count == 1 + 2 + 3
    assert _launches()["fused_gate_up"] == t.forward_count * sum(
        TARGET.moe_pattern[i % TARGET.period] for i in range(TARGET.num_layers))
    assert torch.equal(snap, cache["layers"][0]["k"])
    te = measure_target_efficiency(t, pt, cache, gamma=4, iters=3)
    assert te["T_T_1"] > 0 and te["T_T_gamma"] > 0
    assert 0 < te["target_efficiency"] < 2


# ------------------------------------------- prefix sharing, chunks, faults
def _shared_stream(m, **kw):
    """Three requests behind a 20-token shared prefix (pages of 16: one
    whole shared page and a copied boundary page), all at round 0, and a
    40-token prompt at round 2 in chunks of 16.  Returns {uid: tokens}."""
    eng = kw.pop("engine", None) or ServingEngine(
        *m, max_batch=2, gamma=2, force_sd=True, scheduler="continuous",
        kv_layout="paged", page_size=16, prefix_sharing=True,
        prefill_chunk=16, **kw)
    base = np.arange(3, 23)
    first = len(eng.done)
    for i, n in enumerate((3, 7, 5)):
        eng.submit(np.concatenate([base, np.arange(30, 34) + 4 * i]),
                   max_new_tokens=n)
    eng.submit(np.arange(3, 43), max_new_tokens=6, arrival_round=2)
    eng.run()
    return eng, {u - first: eng.done[u].output for u in sorted(eng.done)
                 if u > first}


def test_paged_kernel_shared_prefix_stream_steady_state(models):
    """On the card: a second identical shared-prefix stream through the
    same engine captures nothing, and both runs, an eager card run and the
    CPU run emit the same greedy tokens (fp32); the prefix path forked and
    copied pages and the paged kernel ran."""
    for m in KERNEL_MODULES:
        m.reset_launch_counts()
    eng, first = _shared_stream(models["cuda"])
    caps = eng.session_stats()["model"]["captures"]
    _, again = _shared_stream(models["cuda"], engine=eng)
    assert eng.session_stats()["model"]["captures"] == caps
    assert eng.fault_counters["prefix_hits"] >= 2
    assert eng.fault_counters["cow_copies"] >= 2
    assert _launches()["paged_decode_attention"] > 0
    _, eager = _shared_stream(models["cuda"], cuda_graphs=False)
    _, cpu = _shared_stream(models["cpu"])
    for name, out in (("again", again), ("eager", eager), ("cpu", cpu)):
        assert out.keys() == first.keys(), name
        for u in first:
            np.testing.assert_array_equal(out[u], first[u], err_msg=name)


def test_fault_smoke_lane_on_the_card(cuda, capsys):
    """``python -m repro_torch.serving.faults``: the scripted stream's
    finish reasons, no leaked page, and no capture on the replay stream."""
    from repro_torch.serving import faults
    assert faults.main([]) == 0
    assert "captured nothing" in capsys.readouterr().out


# ------------------------------------------------------- eagle and prefetch
def _proposer_models(dtype: str, dev: str):
    """The reduced target and draft (or an EAGLE head) in ``dtype`` on
    ``dev``, weights drawn on the CPU from fixed seeds."""
    from repro_torch.core.eagle import EagleHead
    cfg, dcfg = (c.with_overrides(dtype=dtype) for c in (TARGET, DRAFT))
    t = Model(cfg, moe_dispatch="gmm", device=dev)
    d = Model(dcfg, device=dev)
    head = EagleHead(t)
    pt = Model(cfg, moe_dispatch="gmm", device="cpu").init(
        torch.Generator().manual_seed(0))
    pd = Model(dcfg, device="cpu").init(torch.Generator().manual_seed(1))
    ph = EagleHead(Model(cfg, device="cpu")).init(
        torch.Generator().manual_seed(2))
    return t, _to(pt, dev), {"prefetch": (d, _to(pd, dev)),
                             "eagle": (head, _to(ph, dev))}


def _generate(t, pt, drafts, kind, prompts, lengths, **kw):
    draft, params_p = drafts[kind]
    eng = SDEngine(t, make_proposer(kind, t, draft), gamma=4, **kw)
    runs = [eng.generate(pt, params_p, prompts, 12, lengths=lengths)
            for _ in range(2)]
    return eng, runs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["eagle", "prefetch"])
def test_eagle_and_prefetch_rounds_replay_equal_eager(cuda, kind, dtype):
    """Two generations on one session (the second replays every round)
    against the same on an eager session: the same tokens and prefetch
    counts to the bit; in fp32 also the CPU's.  A prefetch key holds four
    stage graphs (propose, warm, verify, finalize), captured once."""
    rng = np.random.default_rng(4)
    prompts = rng.integers(3, TARGET.vocab_size, (4, 10)).astype(np.int32)
    lengths = np.array([10, 6, 8, 7], np.int32)
    t, pt, drafts = _proposer_models(dtype, "cuda")
    eng, runs = _generate(t, pt, drafts, kind, prompts, lengths)
    _, eager = _generate(t, pt, drafts, kind, prompts, lengths,
                         cuda_graphs=False)
    others = [runs[1], eager[0], eager[1]]
    if dtype == "float32":
        others.append(_generate(*_proposer_models(dtype, "cpu"), kind,
                                prompts, lengths)[1][0])
    counts = lambda st: (st.prefetch_hits, st.prefetch_actual,  # noqa: E731
                         st.prefetch_predicted, st.rounds)
    for out, stats in others:
        np.testing.assert_array_equal(out, runs[0][0])
        assert counts(stats) == counts(runs[0][1])
    assert eng.graphs.total_captures == 1
    assert eng.graphs.total_replays == runs[0][1].rounds * 2 - 1
    (rec,) = eng.graphs._captured.values()
    assert len(rec.graphs) == (4 if kind == "prefetch" else 1)
    assert (runs[0][1].prefetch_actual > 0) == (kind == "prefetch")


def test_prefetch_replays_make_no_host_sync_and_warm_in_place(cuda):
    """A replayed prefetch round under sync_guard reaches its readback
    with no host sync; its warm stage writes the same buffers every round,
    and the serving engine's session_stats() carries the totals."""
    t, pt, drafts = _proposer_models("bfloat16", "cuda")
    d, pd = drafts["prefetch"]
    eng = ServingEngine(t, d, pt, pd, max_batch=4, gamma=4, seed=0,
                        proposer="prefetch", force_sd=True)
    _serve(eng, "wave")
    sess = eng._sessions["prefetch"]
    ptrs = [w["w_gate"].data_ptr() for w in sess._warm]
    assert sess.warm_bytes() > 0
    sess.sync_guard = True
    _serve(eng, "wave")
    assert torch.cuda.get_sync_debug_mode() == 0
    assert [w["w_gate"].data_ptr() for w in sess._warm] == ptrs
    second = eng.reports[len(eng.reports) // 2:]
    assert sum(r.captures for r in second) == 0
    assert sum(r.replays for r in second) == sum(r.stats.rounds
                                                 for r in second)
    totals = eng.session_stats()["prefetch"]["prefetch"]
    assert totals["rounds"] == sum(r.stats.rounds for r in eng.reports)
    assert totals["actual"] == sum(r.stats.prefetch_actual
                                   for r in eng.reports) > 0
    assert set(eng.session_stats()) == {"resilience", "prefetch"}


@pytest.mark.parametrize("sched", ["wave", "continuous"])
def test_gemma3_replay_equals_eager_and_cpu_greedy(cuda, sched):
    """gemma3-12b-reduced (SWA rings beside a global layer, window 16) with
    its ``draft_for`` draft, fp32: graph replay == eager on the card == the
    CPU path, token for token.  The rings and their ``pos`` live in the
    session arenas, so a replay reads them in place; prompts of up to 40
    tokens overrun the window, and the continuous paged stream reuses rows."""
    from repro_torch.configs.registry import draft_for
    cfg = get_config("gemma3-12b", reduced=True)
    dcfg = draft_for(cfg)
    pt = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    pd = Model(dcfg, device="cpu").init(torch.Generator().manual_seed(1))
    prompts = [np.random.default_rng(i).integers(3, cfg.vocab_size, n)
               for i, n in enumerate((40, 9, 23, 31, 12))]

    def serve(dev, **kw):
        extra = (dict(scheduler="continuous", kv_layout="paged", page_size=8)
                 if sched == "continuous" else {})
        eng = ServingEngine(Model(cfg, device=dev), Model(dcfg, device=dev),
                            _to(pt, dev), _to(pd, dev), max_batch=2, gamma=4,
                            force_sd=True, seed=0, **extra, **kw)
        uids = [eng.submit(p, max_new_tokens=10) for p in prompts]
        eng.run()
        return eng, [np.asarray(eng.done[u].output) for u in uids]

    graphs, replayed = serve("cuda")
    assert sum(r.replays for r in graphs.reports) >= 1
    for _, other in (serve("cuda", cuda_graphs=False), serve("cpu")):
        for a, b in zip(replayed, other):
            np.testing.assert_array_equal(a, b)


RNN_DRAFT = dict(name="t-rnn-draft", family="ssm", num_layers=2, d_model=64,
                 num_heads=2, num_kv_heads=2, d_ff=0, vocab_size=512,
                 layer_pattern=("mlstm", "slstm"), rope_type="none",
                 dtype="float32")


@pytest.mark.parametrize("pair", ["recurrent-target", "recurrent-draft"])
def test_recurrent_rounds_replay_equal_eager_and_cpu(cuda, pair):
    """fp32 SD rounds over recurrent states: jamba-v0.1-52b-reduced (a
    Mamba and an attention layer, MoE) under its ``draft_for`` draft, and
    a dense target under a 2-layer mLSTM/sLSTM draft.  Six rounds with row
    1 inactive on every other round (it commits 0 tokens and takes the
    last collected step): the committed tokens and every recurrent leaf of
    target and draft after each round are the same from graph replay as
    eagerly on the card (to the bit) and on the CPU (1e-5), and a replayed
    round makes no host sync before its readback."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.configs.registry import draft_for
    from repro_torch.models.transformer import RECURRENT_KINDS, layer_kinds
    if pair == "recurrent-target":
        cfg = get_config("jamba-v0.1-52b", reduced=True)
        dcfg = draft_for(cfg)
    else:
        cfg = ModelConfig("t-dense", "dense", 4, 128, 4, 2, 256, 512,
                          dtype="float32")
        dcfg = ModelConfig(**RNN_DRAFT)
    disp = "gmm" if cfg.num_experts else "onehot"
    pt = Model(cfg, moe_dispatch=disp, device="cpu").init(
        torch.Generator().manual_seed(0))
    pd = Model(dcfg, device="cpu").init(torch.Generator().manual_seed(1))
    prompts = np.random.default_rng(5).integers(3, 512, (3, 12)).astype(
        np.int32)

    def leaves(cache, c):
        return [v.detach().cpu().numpy().copy()
                for slot, (kind, _) in zip(cache["layers"], layer_kinds(c))
                if kind in RECURRENT_KINDS for v in slot.values()]

    def rounds(dev, graphs):
        t = Model(cfg, moe_dispatch=disp, device=dev)
        d = Model(dcfg, device=dev)
        eng = SDEngine(t, make_proposer("model", t, d), gamma=3,
                       cuda_graphs=graphs)
        eng.sync_guard = True           # replayed rounds: no host sync
        state = eng.start(_to(pt, dev), _to(pd, dev), prompts, max_seq=64)
        trace = []
        for r in range(6):
            state, res = eng.round(state, active=np.array([True, r % 2 == 0,
                                                           True]))
            trace.append((res.committed.copy(), res.n_commit.copy(),
                          leaves(state.t_cache, cfg)
                          + leaves(state.p_state["cache"], dcfg)))
        return eng, trace

    eng, replayed = rounds("cuda", None)
    assert eng.graphs.total_replays == 5
    for dev, graphs, tol in (("cuda", False, 0.0), ("cpu", None, 1e-5)):
        _, other = rounds(dev, graphs)
        for (c, n, ls), (c2, n2, ls2) in zip(replayed, other):
            np.testing.assert_array_equal(n, n2)
            for b in range(3):
                np.testing.assert_array_equal(c[b, :n[b]], c2[b, :n2[b]])
            assert len(ls) == len(ls2) > 0
            for a, b in zip(ls, ls2):
                np.testing.assert_allclose(a, b, rtol=tol, atol=tol)
