"""System invariants on the port (hypothesis): batching never changes
results.

Mirrors tests/test_invariants.py with its hypothesis settings: the forward
pass is batch-order equivariant; padding beyond ``lengths`` cannot leak
through the attention masks or the cache writes; a sequence decodes the
same alone as among batchmates of other prompt lengths (greedy SD through
the ``SpecDecoder`` shim).  Beside them, one case holds ``forward_train``
against the reference on the same weights: logits, the router's
``aux_loss`` and ``expert_counts``.

fp32 on the CPU, TF32 off; the equivariance and padding bounds are the
reference's (2e-4), the reference comparison 1e-5 (counts exact).
"""
import jax.numpy as jnp
import numpy as np
from _hypothesis_compat import given, settings, st

from _torch_parity import model_pair, to_np
from repro.configs.base import ModelConfig
from repro_torch.core.spec_decode import SpecDecoder

CFG = ModelConfig("inv-moe", "moe", 2, 96, 4, 2, 192, 256, num_experts=4,
                  num_experts_per_tok=2, dtype="float32")
DRAFT = ModelConfig("inv-draft", "dense", 2, 48, 2, 2, 96, 256,
                    dtype="float32")

_jmodel, _jparams, _model, _params = model_pair(CFG, seed=0)
_, _, _draft, _dparams = model_pair(DRAFT, seed=5)


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 10_000))
def test_batch_order_equivariance(seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 256, (4, 12))
    perm = rng.permutation(4)
    out1, _ = _model.forward_train(_params, toks)
    out2, _ = _model.forward_train(_params, toks[perm])
    np.testing.assert_allclose(out1[perm].numpy(), out2.numpy(), rtol=2e-4,
                               atol=2e-4)


@settings(max_examples=6, deadline=None)
@given(st.integers(0, 10_000))
def test_padding_beyond_length_is_invisible(seed):
    """Prefill logits at lengths-1 are unchanged by arbitrary pad content."""
    rng = np.random.default_rng(seed)
    B, T = 3, 10
    toks = rng.integers(0, 256, (B, T))
    lengths = np.array([4, 10, 7], np.int32)
    junk = rng.integers(0, 256, (B, T))
    toks2 = np.where(np.arange(T)[None, :] < lengths[:, None], toks, junk)
    out = [_model.prefill(_params, t, _model.init_cache(B, T + 4),
                          lengths=lengths)[0] for t in (toks, toks2)]
    np.testing.assert_allclose(out[0].numpy(), out[1].numpy(), rtol=2e-4,
                               atol=2e-4)


@settings(max_examples=4, deadline=None)
@given(st.integers(0, 10_000))
def test_sequence_independent_of_batchmates(seed):
    """Greedy SD output of a sequence is identical alone and in a batch of
    strangers with different prompt lengths."""
    rng = np.random.default_rng(seed)
    B, T = 3, 9
    toks = rng.integers(3, 256, (B, T)).astype(np.int32)
    lengths = rng.integers(3, T + 1, size=B).astype(np.int32)
    sd = SpecDecoder(_model, _draft, gamma=2, temperature=0.0)
    out_batch, _ = sd.generate(_params, _dparams, toks, 10, lengths=lengths)
    for b in range(B):
        solo, _ = sd.generate(_params, _dparams,
                              toks[b: b + 1, : int(lengths[b])], 10)
        np.testing.assert_array_equal(out_batch[b], solo[0])


def test_forward_train_matches_reference():
    toks = np.random.default_rng(11).integers(0, 256, (4, 12)).astype(
        np.int32)
    logits, metrics = _model.forward_train(_params, toks)
    jlogits, jmetrics = _jmodel.forward_train(_jparams, jnp.asarray(toks))
    assert set(metrics) == {"aux_loss", "expert_counts"}
    np.testing.assert_allclose(to_np(logits), to_np(jlogits), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(metrics["aux_loss"]),
                               float(jmetrics["aux_loss"]), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(metrics["expert_counts"].numpy(),
                                  np.asarray(jmetrics["expert_counts"]))
    # every token routes to K experts in each of the 2 MoE layers
    assert int(metrics["expert_counts"].sum()) == 2 * toks.size * 2
