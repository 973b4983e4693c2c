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
sync.
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
