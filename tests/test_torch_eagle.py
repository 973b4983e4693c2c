"""Port's EAGLE head and proposer against the reference, CPU.

Mirrors tests/test_eagle.py (greedy losslessness, ragged prompts, the
head's size) and holds the port against the reference on the same weights:
the head's step (logits and predicted feature), the target's hidden-state
passes (``prefill_with_hidden``, ``extend_with_hidden``) and
``EagleSpecDecoder``'s greedy tokens, bit for bit.  The head's config
follows the reference's rule; for ``qwen2-57b-a14b`` (28 query / 4 KV
heads) that rule gives 7 query heads over 2 KV heads, which the
reference's head cannot attend with (``TypeError`` in its GQA reshape), so
the port refuses that head at construction.

fp32, TF32 off; logits and hidden states within rtol = atol = 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import CPU, both, model_pair, port_config, to_np
from repro.configs.base import ModelConfig
from repro.core.eagle import EagleHead as JaxEagleHead
from repro.core.eagle import EagleSpecDecoder as JaxEagleSpecDecoder
from repro.models.model import Model as JaxModel
from repro_torch.configs.registry import get_config
from repro_torch.core.eagle import EagleHead, EagleSpecDecoder, eagle_head_config
from repro_torch.core.proposer import make_proposer
from repro_torch.core.spec_decode import generate_ar
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import Model

TCFG = ModelConfig("eg-moe", "moe", 4, 128, 4, 2, 256, 512, num_experts=4,
                   num_experts_per_tok=2, dtype="float32")
TOL = 1e-5


@pytest.fixture(scope="module")
def pair():
    """(reference target, params, head, head params), then the port's, on
    one set of weights."""
    jm, jp, tm, tp = model_pair(TCFG, seed=0)
    jh = JaxEagleHead(jm)
    jpe = jh.init(jax.random.PRNGKey(3))
    th = EagleHead(tm)
    tpe = params_from_jax(jax.device_get(jpe), th.cfg, CPU)
    return (jm, jp, jh, jpe), (tm, tp, th, tpe)


def _prompts(seed, B, T, lo=0):
    return np.random.default_rng(seed).integers(lo, 512, (B, T)).astype(
        np.int32)


def test_eagle_greedy_lossless(pair):
    """Even an untrained head is lossless; the port's greedy SD tokens
    equal its AR tokens and the reference's EAGLE tokens."""
    (jm, jp, jh, jpe), (tm, tp, th, tpe) = pair
    prompts = _prompts(1, 3, 8)
    out_sd, stats = EagleSpecDecoder(tm, th, gamma=3).generate(
        tp, tpe, prompts, 20)
    np.testing.assert_array_equal(out_sd, generate_ar(tm, tp, prompts, 20))
    ref, ref_stats = JaxEagleSpecDecoder(jm, jh, gamma=3).generate(
        jp, jpe, jnp.asarray(prompts), 20)
    np.testing.assert_array_equal(out_sd, np.asarray(ref))
    assert stats.rounds == ref_stats.rounds >= 1
    assert stats.accept_events == ref_stats.accept_events


def test_eagle_ragged_prompts(pair):
    _, (tm, tp, th, tpe) = pair
    prompts = _prompts(2, 2, 10, lo=3)
    lengths = np.array([5, 10], np.int32)
    out_sd, _ = EagleSpecDecoder(tm, th, gamma=2).generate(
        tp, tpe, prompts, 10, lengths=lengths)
    for b in range(2):
        ref = generate_ar(tm, tp, prompts[b: b + 1, : int(lengths[b])], 10)
        np.testing.assert_array_equal(out_sd[b], ref[0])


def _size(tree):
    if isinstance(tree, dict):
        return sum(_size(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_size(v) for v in tree)
    return tree.numel()


def test_eagle_head_is_small(pair):
    """Paper requirement T_D/T_T << 1: the head is a small fraction of the
    target's parameters."""
    _, (_, tp, _, tpe) = pair
    assert _size(tpe) < 0.45 * _size(tp)


def test_head_config_and_step_match_reference(pair):
    """Three chained steps from a random feature on rows at lengths 3 and
    6: logits and predicted features equal the reference's, and both
    caches advance alike."""
    (jm, jp, jh, jpe), (tm, tp, th, tpe) = pair
    assert dataclasses.asdict(th.cfg) == dataclasses.asdict(
        port_config(jh.cfg))
    assert eagle_head_config(tm.cfg) == th.cfg
    rng = np.random.default_rng(5)
    feat = rng.standard_normal((2, TCFG.d_model)).astype(np.float32)
    tokens = rng.integers(0, 512, (3, 2)).astype(np.int32)
    lengths = np.array([3, 6], np.int32)
    jc = dict(jh.init_cache(2, 16), lengths=jnp.asarray(lengths))
    tc = dict(th.init_cache(2, 16), lengths=torch.from_numpy(lengths))
    jf, tf = both(feat)
    for tok in tokens:
        jl, jf, jc = jh.step(jp, jpe, jf, jnp.asarray(tok), jc)
        tl, tf, tc = th.step(tp, tpe, tf, torch.from_numpy(tok), tc)
        np.testing.assert_allclose(to_np(tl), to_np(jl), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(to_np(tf), to_np(jf), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(tc["lengths"].numpy(),
                                  np.asarray(jc["lengths"]))


def test_hidden_passes_match_reference(pair):
    """prefill_with_hidden's last logits and last hidden state, then
    extend_with_hidden's logits and (B, T, d) hidden states."""
    (jm, jp, _, _), (tm, tp, _, _) = pair
    rng = np.random.default_rng(6)
    toks = rng.integers(0, 512, (3, 9)).astype(np.int32)
    lengths = np.array([9, 4, 7], np.int32)
    ver = rng.integers(0, 512, (3, 4)).astype(np.int32)
    jl, jh_last, jc = jm.prefill_with_hidden(
        jp, jnp.asarray(toks), jm.init_cache(3, 24),
        lengths=jnp.asarray(lengths))
    tl, th_last, tc = tm.prefill_with_hidden(tp, toks, tm.init_cache(3, 24),
                                             lengths=lengths)
    assert th_last.shape == (3, TCFG.d_model)
    for a, b in ((tl, jl), (th_last, jh_last)):
        np.testing.assert_allclose(to_np(a), to_np(b), rtol=TOL, atol=TOL)
    jlog, jhid, _ = jm.extend_with_hidden(jp, jnp.asarray(ver), jc)
    tlog, thid, _ = tm.extend_with_hidden(tp, ver, tc)
    assert thid.shape == (3, 4, TCFG.d_model)
    for a, b in ((tlog, jlog), (thid, jhid)):
        np.testing.assert_allclose(to_np(a), to_np(b), rtol=TOL, atol=TOL)


def test_qwen2_57b_head_counts_are_refused():
    """The head rule gives qwen2-57b-a14b 7 query heads over 2 KV heads.
    The port refuses that head at construction, naming the counts; the
    reference's head step fails on the same counts (its GQA reshape), at
    the real 28/4 head counts with the other widths narrowed.  The tuner
    still prices the head's config on the full target."""
    target = Model(get_config("qwen2-57b-a14b"), moe_dispatch="gmm",
                   device="cpu")
    with pytest.raises(ValueError, match=r"7 query heads over 2 KV heads.*"
                                         r"ROADMAP queue 3"):
        make_proposer("eagle", target)
    jcfg = ModelConfig("q57-heads", "moe", 1, 128, 28, 4, 256, 512,
                       head_dim=16, num_experts=4, num_experts_per_tok=2,
                       qkv_bias=True, dtype="float32")
    jm = JaxModel(jcfg)
    jh = JaxEagleHead(jm)
    assert (jh.cfg.num_heads, jh.cfg.num_kv_heads) == (7, 2)
    key = jax.random.PRNGKey(0)
    with pytest.raises(TypeError, match="cannot reshape"):
        jh.step(jm.init(key), jh.init(key), jnp.zeros((2, 128)),
                jnp.zeros((2,), jnp.int32), jh.init_cache(2, 8))
    from repro_torch.launch.serve import make_tuner
    plan = make_tuner("qwen2-57b-a14b", "eagle").plan(8)
    assert plan["gamma"] >= 0 and plan["predicted_speedup"] > 0
