"""The port's round keys on the CPU: captures happen once per key, and the
arena rounds give the reference's tokens.

Mirrors tests/test_retrace_guard.py with the port's counters in place of
``compile_guard``: on the CPU each round key counts a capture the first time
it runs and a replay every later time (``core/graphs.py``), the same key
logic that captures and replays CUDA graphs on the card.  Steady rounds,
occupancy churn, same-bucket admissions and repeated continuous streams
capture nothing; a new admission bucket traces exactly once.  The arena
round (static buffers, in-place commits) emits the reference's greedy
tokens round for round in fp32, and a second wave of one shape reuses the
first one's arena.  The mirror of
``test_paged_kernel_shared_prefix_stream_steady_state`` waits for prefix
sharing (ROADMAP queue 1 item 7); a repeated paged stream with a pool
growth stands in for its paged half.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import model_pair
from repro.configs.base import ModelConfig
from repro.core.proposer import make_proposer as jax_make_proposer
from repro.core.spec_decode import SDEngine as JaxSDEngine
from repro_torch.core.graphs import RoundGraphs
from repro_torch.core.proposer import ModelProposer, make_proposer
from repro_torch.core.spec_decode import SDEngine
from repro_torch.serving.engine import ServingEngine

TCFG = ModelConfig("rg-moe", "moe", 2, 128, 4, 2, 256, 512, num_experts=4,
                   num_experts_per_tok=2, dtype="float32")
DCFG = ModelConfig("rg-draft", "dense", 2, 64, 2, 2, 128, 512,
                   dtype="float32")


@pytest.fixture(scope="module")
def models():
    jt, jpt, tt, tpt = model_pair(TCFG, seed=0)
    jd, jpd, td, tpd = model_pair(DCFG, seed=1)
    return (jt, jd, jpt, jpd), (tt, td, tpt, tpd)


@pytest.fixture()
def session(models):
    _, (t, d, pt, pd) = models
    eng = SDEngine(t, ModelProposer(t, d), gamma=2)
    prompts = np.tile(np.arange(3, 9), (4, 1)).astype(np.int32)
    state = eng.start(pt, pd, prompts, max_seq=64)
    return eng, state


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _tensors(v)]
    return []


def _counts(eng):
    return eng.graphs.total_captures, eng.graphs.total_replays


def test_steady_state_rounds_never_capture_again(session):
    eng, state = session
    for _ in range(2):                            # the first round captures
        state, _ = eng.round(state)
    traces, (caps, reps) = len(eng.trace_log), _counts(eng)
    for _ in range(5):
        state, _ = eng.round(state)
    assert _counts(eng) == (caps, reps + 5)
    assert caps == 1 and len(eng.trace_log) == traces == 1


def test_occupancy_churn_is_data_not_a_new_key(session):
    """Flipping the active mask between rounds reuses the one captured
    round: active rows are data (the static ``active`` buffer)."""
    eng, state = session
    state, _ = eng.round(state)
    caps, reps = _counts(eng)
    for m in ([1, 1, 0, 0], [1, 0, 1, 1], [0, 1, 0, 1]):
        lengths = state.t_cache["lengths"].clone()
        state, res = eng.round(state, active=np.asarray(m, bool))
        frozen = ~np.asarray(m, bool)
        assert (res.n_commit[frozen] == 0).all()
        np.testing.assert_array_equal(
            state.t_cache["lengths"].numpy()[frozen],
            lengths.numpy()[frozen])
    assert _counts(eng) == (caps, reps + 3)


def test_admissions_within_bucket_capture_nothing(session):
    eng, state = session
    prompts = np.tile(np.arange(3, 9), (1, 1)).astype(np.int32)   # R=1
    lengths = np.array([6])
    state = eng.admit_rows(state, prompts, lengths, np.array([1]))
    state, _ = eng.round(state)
    admits, (caps, reps) = len(eng.admit_trace_log), _counts(eng)
    for row in (2, 3, 0):                         # refills: rows are data
        state = eng.admit_rows(state, prompts, lengths, np.array([row]))
        state, _ = eng.round(state)
    assert len(eng.admit_trace_log) == admits
    assert _counts(eng) == (caps, reps + 3)


def test_new_row_bucket_traces_exactly_once(session):
    eng, state = session
    one = np.tile(np.arange(3, 9), (1, 1)).astype(np.int32)
    state = eng.admit_rows(state, one, np.array([6]), np.array([1]))
    state, _ = eng.round(state)
    admits, (caps, _) = len(eng.admit_trace_log), _counts(eng)
    two = np.tile(np.arange(3, 9), (2, 1)).astype(np.int32)  # new R bucket
    state = eng.admit_rows(state, two, np.array([6, 6]), np.array([0, 1]))
    assert len(eng.admit_trace_log) == admits + 1
    state = eng.admit_rows(state, two, np.array([6, 6]), np.array([2, 3]))
    assert len(eng.admit_trace_log) == admits + 1
    state, _ = eng.round(state)
    assert _counts(eng)[0] == caps                # the round key is unchanged


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_continuous_stream_steady_state(models, layout):
    """A second identical-shape stream through the SAME serving engine
    captures nothing (dense; paged with a pool growth: every geometry of
    the warm stream has its key) and replays every round."""
    _, (t, d, pt, pd) = models
    eng = ServingEngine(t, d, pt, pd, max_batch=2, gamma=2, force_sd=True,
                        scheduler="continuous", kv_layout=layout,
                        page_size=8)
    long = np.arange(3, 40)

    def stream():
        for m in (3, 7, 5):
            eng.submit(np.arange(3, 9), max_new_tokens=m)
        if layout == "paged":
            eng.submit(long, max_new_tokens=4, arrival_round=2)
        (rep,) = eng.run()
        return rep

    warm = stream()
    stats = eng.session_stats()["model"]
    again = stream()
    after = eng.session_stats()["model"]
    assert warm.captures == stats["captures"] >= 1
    assert again.captures == 0 and after["captures"] == stats["captures"]
    assert again.replays == again.stats.rounds > 0
    assert after["traces"] == stats["traces"]
    assert eng.session_constructions == {"model": 1}
    if layout == "paged":
        assert after["growths"] and len(after["growths"]) == \
            2 * len(stats["growths"])
        assert stats["captures"] == 1 + len(stats["growths"])
        # one arena per geometry, none sharing a tensor with another
        arenas = eng._sessions["model"]._arenas.values()
        assert len(arenas) == stats["captures"]
        ids = [id(x) for a in arenas
               for x in _tensors((a.t_cache, a.p_state, a.last_token))]
        assert len(ids) == len(set(ids))


@pytest.mark.parametrize("kind", ["model", "none"])
@pytest.mark.parametrize("timed", [False, True])
def test_arena_rounds_match_reference_token_for_token(models, kind, timed):
    """Greedy fp32: the port's arena round (fused or staged) commits the
    reference's tokens round for round, with the active mask flipping."""
    (jt, jd, jpt, jpd), (t, d, pt, pd) = models
    prompts = np.random.default_rng(3).integers(
        3, TCFG.vocab_size, (4, 7)).astype(np.int32)
    lengths = np.array([7, 4, 6, 5], np.int32)
    gamma = 2 if kind == "model" else 0
    eng = SDEngine(t, make_proposer(kind, t, d if kind == "model" else None),
                   gamma=gamma)
    jeng = JaxSDEngine(jt, jax_make_proposer(kind, jt, jd if kind == "model"
                                             else None), gamma=gamma)
    state = eng.start(pt, pd, prompts, max_seq=64, lengths=lengths)
    jstate = jeng.start(jpt, jpd, jnp.asarray(prompts), max_seq=64,
                        lengths=jnp.asarray(lengths),
                        key=jax.random.PRNGKey(0))
    np.testing.assert_array_equal(state.last_token.numpy(),
                                  np.asarray(jstate.last_token))
    masks = (None, [1, 0, 1, 1], None, [0, 1, 1, 0], None)
    for r, m in enumerate(masks):
        active = None if m is None else np.asarray(m, bool)
        state, res = eng.round(state, active=active, timed=timed)
        jstate, jres = jeng.round(jstate, active=active, timed=timed,
                                  key=jax.random.PRNGKey(10 + r))
        np.testing.assert_array_equal(res.n_commit, jres.n_commit)
        for b in range(4):
            n = int(res.n_commit[b])
            np.testing.assert_array_equal(res.committed[b, :n],
                                          jres.committed[b, :n])
    np.testing.assert_array_equal(state.t_cache["lengths"].numpy(),
                                  np.asarray(jstate.t_cache["lengths"]))
    assert _counts(eng) == (1, len(masks) - 1)
    if timed:
        assert set(res.phase_times) == {"propose", "verify", "reject"}


def test_second_wave_reuses_the_arena(models):
    """Two waves of one shape: the second prefills into the first one's
    tensors (same storage) and replays its round, with the same tokens as
    a fresh engine."""
    _, (t, d, pt, pd) = models
    eng = SDEngine(t, ModelProposer(t, d), gamma=2)
    waves = [np.random.default_rng(s).integers(
        3, TCFG.vocab_size, (2, 6)).astype(np.int32) for s in (0, 1)]
    ptrs, outs = [], []
    for prompts in waves:
        state = eng.start(pt, pd, prompts, max_seq=32)
        ptrs.append([x.data_ptr() for x in (
            state.t_cache["layers"][0]["k"], state.t_cache["lengths"],
            state.p_state["cache"]["layers"][0]["k"], state.last_token)])
        out, _ = eng.generate(pt, pd, prompts, 8, max_seq=32)
        outs.append(out)
    assert ptrs[0] == ptrs[1]
    assert len(eng._arenas) == 1 and eng.graphs.total_captures == 1
    fresh = SDEngine(t, ModelProposer(t, d), gamma=2)
    out, _ = fresh.generate(pt, pd, waves[1], 8, max_seq=32)
    np.testing.assert_array_equal(outs[1], out)


def test_graphs_need_a_card(models):
    """Capture is never asked of the CPU: it raises, nothing falls back."""
    _, (t, d, _, _) = models
    with pytest.raises(ValueError, match="CUDA device"):
        SDEngine(t, ModelProposer(t, d), gamma=2, cuda_graphs=True)
    with pytest.raises(ValueError, match="CUDA device"):
        RoundGraphs(torch.device("cpu"), capture=True)
