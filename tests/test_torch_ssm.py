"""Recurrent blocks (Mamba, mLSTM, sLSTM) on the port against the reference,
CPU.

Mirrors ``tests/test_attention_and_cache.py::test_decode_matches_teacher_
forcing[mamba]`` and ``tests/test_spec_decode.py::test_recurrent_draft_
lossless``, and adds:

* each block's forward, final state and collected per-step states against
  ``repro.models.ssm`` from a nonzero state;
* extend(T) + commit(n) equals n single decode steps on a hybrid (Mamba +
  attention + MoE) and an xLSTM stack, for every n, with an inactive row
  (n = 0) taking the last collected step as the reference's index -1 does;
* ``grow_cache_seq`` leaving recurrent leaves as they are;
* the reference's ragged recurrent prefill (ROADMAP queue 3): both packages
  fold the padding into a short row's state.

Same weights on both sides (``model_pair``), fp32, TF32 off.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import CPU, both, model_pair, to_np
from repro.configs.base import ModelConfig
from repro.core.spec_decode import SpecDecoder as JaxSpecDecoder
from repro.core.spec_decode import generate_ar as jax_generate_ar
from repro.models import ssm as jssm
from repro.models.model import grow_cache_seq as jax_grow_cache_seq
from repro_torch.core.spec_decode import SpecDecoder, generate_ar
from repro_torch.models import ssm as tssm
from repro_torch.models.convert import _tensor
from repro_torch.models.model import grow_cache_seq

TOL = 1e-4
BLOCK = {   # one config per recurrent kind, each block's own widths
    "mamba": ModelConfig("c-mamba", "ssm", 2, 64, 4, 4, 128, 256,
                         layer_pattern=("mamba",), rope_type="none",
                         dtype="float32"),
    "mlstm": ModelConfig("c-mlstm", "ssm", 2, 64, 4, 4, 0, 256,
                         layer_pattern=("mlstm",), rope_type="none",
                         dtype="float32"),
    "slstm": ModelConfig("c-slstm", "ssm", 2, 64, 4, 4, 0, 256,
                         layer_pattern=("slstm",), rope_type="none",
                         dtype="float32"),
}
STACKS = {
    "hybrid": ModelConfig("t-hybrid", "hybrid", 4, 64, 4, 2, 128, 256,
                          layer_pattern=("mamba", "attn"),
                          moe_pattern=(True, False), num_experts=4,
                          num_experts_per_tok=2, rope_type="none",
                          dtype="float32"),
    "xlstm": ModelConfig("t-xlstm", "ssm", 2, 64, 4, 4, 0, 256,
                         layer_pattern=("mlstm", "slstm"), rope_type="none",
                         dtype="float32"),
}


@functools.lru_cache(maxsize=None)
def _pair(name: str, seed: int = 0):
    """One weight set per config and seed for the whole module (the
    reference's init is the slow part)."""
    cfg = {**BLOCK, **STACKS}[name]
    return model_pair(cfg, seed=seed,
                      moe_dispatch="gmm" if cfg.num_experts else "onehot")


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(to_np(a), to_np(b), rtol=tol, atol=tol)


def _random_state(kind, cfg, B, rng):
    """The same nonzero recurrent state for both packages (``m`` kept
    moderate: it is a running log-max)."""
    shapes = {k: (v.shape, v.dtype) for k, v in jssm.MAKE_STATE[kind](
        cfg, B, jnp.float32).items()}
    out_j, out_t = {}, {}
    for k, (shape, _) in shapes.items():
        a = rng.standard_normal(shape).astype(np.float32)
        if k in ("n",) and kind == "slstm":
            a = np.abs(a) + 0.5
        out_j[k], out_t[k] = both(a)
    return out_j, out_t


@pytest.mark.parametrize("collect", [False, True])
@pytest.mark.parametrize("kind", sorted(BLOCK))
def test_block_forward_matches_reference(kind, collect):
    """Output, and the final state or every per-step state (T, B, ...),
    from a nonzero state, against ``repro.models.ssm``."""
    cfg = BLOCK[kind]
    rng = np.random.default_rng(3)
    B, T = 2, 5
    jp = jssm.INIT[kind](jax.random.PRNGKey(0), cfg, jnp.float32)
    tp = {k: _tensor(np.asarray(v), CPU) for k, v in jp.items()}
    jx, tx = both(rng.standard_normal((B, T, cfg.d_model)).astype(np.float32))
    js, ts = _random_state(kind, cfg, B, rng)
    keep = {k: v.clone() for k, v in ts.items()}
    jy, jst = jssm.FORWARD[kind](jp, cfg, jx, js, collect_states=collect)
    ty, tst = tssm.FORWARD[kind](tp, cfg, tx, ts, collect_states=collect)
    _close(ty, jy)
    assert set(tst) == set(jst)
    for k in jst:
        assert tuple(tst[k].shape) == tuple(jst[k].shape), k
        assert tst[k].dtype == torch.float32
        _close(tst[k], jst[k])
    for k, v in ts.items():                 # the input state is only read
        assert torch.equal(v, keep[k])


def test_init_shapes_and_dtypes_match_reference():
    """Each block's parameters and state: the reference's names, shapes
    and dtypes, a bf16 model keeping its fp32 leaves fp32."""
    for kind, cfg in BLOCK.items():
        cfg = cfg.with_overrides(dtype="bfloat16")
        jp = jssm.INIT[kind](jax.random.PRNGKey(0), cfg, jnp.bfloat16)
        tp = tssm.INIT[kind](cfg, torch.bfloat16,
                             generator=torch.Generator().manual_seed(0),
                             device=CPU)
        js = jssm.MAKE_STATE[kind](cfg, 3, jnp.bfloat16)
        ts = tssm.MAKE_STATE[kind](cfg, 3, torch.bfloat16, CPU)
        for j, t in ((jp, tp), (js, ts)):
            assert set(j) == set(t), kind
            for k in j:
                assert tuple(t[k].shape) == j[k].shape, (kind, k)
                assert str(t[k].dtype).split(".")[-1] == j[k].dtype.name, \
                    (kind, k)


def test_decode_matches_teacher_forcing_mamba():
    """The ``c-mamba`` case of the reference's test: prefill + single decode
    steps reproduce the cacheless forward's logits, and equal the
    reference's at every step."""
    jm, jp, tm, tp = _pair("mamba")
    B, T0, T1 = 2, 6, 5
    toks = np.random.default_rng(1).integers(0, 256, (B, T0 + T1)).astype(
        np.int32)
    full, _ = tm.forward_train(tp, toks)
    jfull, _ = jm.forward_train(jp, jnp.asarray(toks))
    _close(full, jfull)
    last, cache = tm.prefill(tp, toks[:, :T0], tm.init_cache(B, T0 + T1 + 2))
    jlast, jc = jm.prefill(jp, jnp.asarray(toks[:, :T0]),
                           jm.init_cache(B, T0 + T1 + 2))
    np.testing.assert_allclose(to_np(last), to_np(full[:, T0 - 1]),
                               rtol=2e-4, atol=2e-4)
    _close(last, jlast)
    for t in range(T1):
        lg, cache = tm.decode_step(tp, toks[:, T0 + t], cache)
        jlg, jc = jm.decode_step(jp, jnp.asarray(toks[:, T0 + t]), jc)
        _close(lg, jlg)
        if t + 1 < T1:
            np.testing.assert_allclose(to_np(lg), to_np(full[:, T0 + t]),
                                       rtol=2e-4, atol=2e-4)


def _state_leaves(cache, cfg):
    return [to_np(v).copy() for slot, kind in zip(
        cache["layers"], [cfg.layer_pattern[l % cfg.period]
                          for l in range(cfg.num_layers)])
        if kind in tssm.FORWARD for v in slot.values()]


@pytest.mark.parametrize("stack", sorted(STACKS))
def test_verify_commit_equals_sequential(stack):
    """extend(T) + commit(n) == n single decode steps, for every n in
    1..T, on the next step's logits; a row that commits 0 (inactive) takes
    the last collected step, as the reference's commit does (its index -1
    wraps), so its recurrent leaves equal an extend without collecting,
    and its lengths stay.  One (0, 2) commit is held against the
    reference's."""
    cfg = STACKS[stack]
    jm, jp, tm, tp = _pair(stack)
    B, T0, gamma = 2, 6, 3
    T = gamma + 1
    rng = np.random.default_rng(7)
    toks = rng.integers(0, 256, (B, T0)).astype(np.int32)
    drafts = rng.integers(0, 256, (B, T)).astype(np.int32)
    probe = rng.integers(0, 256, (B,)).astype(np.int32)

    def verify_commit(n_commit):
        _, cache = tm.prefill(tp, toks, tm.init_cache(B, T0 + 16))
        _, pend = tm.extend(tp, drafts, cache, collect=True)
        assert set(pend) == {"layers", "lengths", "collected"}
        cache = tm.commit(pend, torch.from_numpy(n_commit), collected=True)
        assert "collected" not in cache
        np.testing.assert_array_equal(cache["lengths"].numpy(),
                                      T0 + n_commit)
        committed = _state_leaves(cache, cfg)   # decode_step writes in place
        lg, _ = tm.decode_step(tp, probe, cache)
        return committed, lg

    for n in range(1, T + 1):
        n_commit = np.array([n, T + 1 - n], np.int32)
        _, lg = verify_commit(n_commit)
        for b in range(B):                      # one decode step at a time
            _, sc = tm.prefill(tp, toks[b:b + 1], tm.init_cache(1, T0 + 16))
            for t in range(int(n_commit[b])):
                _, sc = tm.decode_step(tp, drafts[b:b + 1, t], sc)
            slg, _ = tm.decode_step(tp, probe[b:b + 1], sc)
            np.testing.assert_allclose(to_np(lg)[b], to_np(slg)[0],
                                       rtol=2e-4, atol=2e-4)
    n_commit = np.array([0, 2], np.int32)
    committed, lg = verify_commit(n_commit)
    _, full = tm.prefill(tp, toks, tm.init_cache(B, T0 + 16))
    _, pend = tm.extend(tp, drafts, full, collect=False)
    for a, b in zip(committed, _state_leaves(pend, cfg)):
        np.testing.assert_allclose(a[0], b[0], rtol=2e-5, atol=2e-5)
    _, jc = jm.prefill(jp, jnp.asarray(toks), jm.init_cache(B, T0 + 16))
    _, jpend = jm.extend(jp, jnp.asarray(drafts), jc, collect=True)
    jc = jm.commit(jpend, jnp.asarray(n_commit), collected=True)
    jlg, _ = jm.decode_step(jp, jnp.asarray(probe), jc)
    _close(lg, jlg)


def test_recurrent_draft_lossless():
    """The reference's test on the port: a 2-layer mLSTM/sLSTM draft over a
    dense target, greedy SD == greedy AR, and both equal the reference's
    SD."""
    tcfg = ModelConfig("t-dense", "dense", 4, 128, 4, 2, 256, 512,
                       dtype="float32")
    dcfg = ModelConfig("t-rnn-draft", "ssm", 2, 64, 2, 2, 0, 512,
                       layer_pattern=("mlstm", "slstm"), rope_type="none",
                       dtype="float32")
    jt, jpt, tt, tpt = model_pair(tcfg)
    jd, jpd, td, tpd = model_pair(dcfg, seed=9)
    prompts = np.random.default_rng(1).integers(0, 512, (2, 8)).astype(
        np.int32)
    sd = SpecDecoder(tt, td, gamma=3, temperature=0.0)
    out_sd, stats = sd.generate(tpt, tpd, prompts, 16)
    out_ar = generate_ar(tt, tpt, prompts, 16)
    np.testing.assert_array_equal(out_sd, out_ar)
    jout, _ = JaxSpecDecoder(jt, jd, gamma=3).generate(
        jpt, jpd, jnp.asarray(prompts), 16)
    np.testing.assert_array_equal(out_sd, np.asarray(jout))
    assert stats.rounds >= 1 and stats.draft_events > 0


def test_hybrid_target_sd_equals_ar_and_reference():
    """A hybrid (Mamba + attention + MoE) target under a dense draft:
    greedy SD == greedy AR == the reference's AR."""
    jm, jp, tm, tp = _pair("hybrid")
    dcfg = ModelConfig("t-draft", "dense", 2, 64, 2, 2, 128, 256,
                       dtype="float32")
    _, _, dm, dp = model_pair(dcfg, seed=7)
    prompts = np.random.default_rng(1).integers(0, 256, (3, 8)).astype(
        np.int32)
    out_sd, _ = SpecDecoder(tm, dm, gamma=3).generate(tp, dp, prompts, 16)
    out_ar = generate_ar(tm, tp, prompts, 16)
    np.testing.assert_array_equal(out_sd, out_ar)
    np.testing.assert_array_equal(
        out_ar, np.asarray(jax_generate_ar(jm, jp, jnp.asarray(prompts), 16)))


def test_grow_cache_seq_leaves_recurrent_leaves():
    """Attention K/V take the new positions; every recurrent leaf is the
    same tensor, as in the reference (no sequence axis)."""
    cfg = STACKS["hybrid"]
    jm, jp, tm, tp = _pair("hybrid")
    toks = np.random.default_rng(2).integers(0, 256, (2, 6)).astype(np.int32)
    _, tc = tm.prefill(tp, toks, tm.init_cache(2, 8))
    _, jc = jm.prefill(jp, jnp.asarray(toks), jm.init_cache(2, 8))
    grown = grow_cache_seq(tc, tm.cfg, 20)
    jgrown = jax_grow_cache_seq(jc, cfg, 21)        # its K/V carry no trash
    for l, kind in enumerate(("mamba", "attn", "mamba", "attn")):
        slot, old = grown["layers"][l], tc["layers"][l]
        if kind == "mamba":
            assert all(slot[k] is old[k] for k in old)
            for k in old:                            # (P, B, ...) vs (B, ...)
                _close(slot[k], jgrown["layers"][0][k][l // 2])
        else:
            assert slot["k"].shape[1] == 21
            assert jgrown["layers"][1]["k"].shape[2] == 21
            torch.testing.assert_close(slot["k"][:, :8], old["k"][:, :8])


def test_ragged_recurrent_prefill_folds_padding_into_state():
    """A fault of the reference that the port keeps (ROADMAP queue 3):
    ``Model.prefill`` runs the recurrent blocks over the whole padded
    bucket, so a row shorter than the bucket carries the padding in its
    state.  Its prefill logits (read at its last real position) equal its
    unpadded prefill's; its first decode step does not, in both packages,
    and the port equals the reference there.  A repair of both flips the
    last assertion."""
    jm, jp, tm, tp = _pair("hybrid")
    T, L = 12, 7
    rng = np.random.default_rng(5)
    toks = rng.integers(3, 256, (2, T)).astype(np.int32)
    toks[0, L:] = 0
    lengths = np.array([L, T], np.int32)
    step = rng.integers(3, 256, (2,)).astype(np.int32)
    last, tc = tm.prefill(tp, toks, tm.init_cache(2, T + 4), lengths=lengths)
    jlast, jc = jm.prefill(jp, jnp.asarray(toks), jm.init_cache(2, T + 4),
                           lengths=jnp.asarray(lengths))
    _close(last, jlast)
    lg, _ = tm.decode_step(tp, step, tc)
    jlg, _ = jm.decode_step(jp, jnp.asarray(step), jc)
    _close(lg, jlg)
    solo_last, sc = tm.prefill(tp, toks[:1, :L], tm.init_cache(1, T + 4))
    _close(last[:1], solo_last)
    solo, _ = tm.decode_step(tp, step[:1], sc)
    gap = np.abs(to_np(lg)[0] - to_np(solo)[0]).max()
    jgap = np.abs(to_np(jlg)[0] - to_np(solo)[0]).max()
    assert gap > 1e-2 and jgap > 1e-2, (gap, jgap)
