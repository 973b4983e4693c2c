"""Training every reduced arch, and the recurrent blocks' chunked remat, on
the port against the reference, CPU.

* One train step per arch of ``tests/test_arch_smoke.py``'s ``ALL_ARCHS``
  (the ten assigned families plus ``qwen2-57b-a14b``, ``mixtral-8x7b``,
  ``qwen2-0.5b``; whisper with stub frames, as that test feeds it), from
  the parameters and moments of one reference step, converted: the port's
  ``make_train_step`` equals the reference's jitted one (loss, aux, lr, grad
  norm, expert counts, the moments and every parameter leaf; tolerances in
  ``_torch_parity.assert_step_matches``).  This is ``test_reduced_smoke``'s
  train step, held to the reference's numbers.
* Mamba, mLSTM and sLSTM at T 512 (two ``SCAN_CHUNK`` slices, each under a
  checkpoint): the output and the gradients of the input, the initial state
  and every parameter equal the unchunked loop's (1e-6) and the
  reference's ``jax.grad`` through its chunked scan (1e-4).

fp32, TF32 off.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import CPU, assert_step_matches, both, to_np
from repro.configs.base import ModelConfig
from repro.configs.registry import ASSIGNED, get_config
from repro.models import ssm as jssm
from repro_torch.models import ssm as tssm
from repro_torch.models.convert import _tensor

ALL_ARCHS = list(ASSIGNED) + ["qwen2-57b-a14b", "mixtral-8x7b", "qwen2-0.5b"]


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_train_step_matches_reference(arch):
    """B 2, T 16 of random tokens and labels (the smoke test's shapes),
    lr 1e-3 after one warm-up step."""
    cfg = get_config(arch, reduced=True)
    B, T = 2, 16
    rng = np.random.default_rng(1)
    batch = {
        "tokens": rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32),
        "labels": rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32),
        "mask": np.ones((B, T), np.float32),
    }
    if cfg.is_encoder_decoder:
        batch["encoder_embeds"] = 0.02 * rng.standard_normal(
            (B, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
    assert_step_matches(cfg, batch, dict(learning_rate=1e-3, warmup_steps=1,
                                         total_steps=10))


BLOCK = {
    "mamba": ModelConfig("c-mamba", "ssm", 1, 32, 2, 2, 64, 256,
                         layer_pattern=("mamba",), rope_type="none",
                         ssm_state_dim=8, dtype="float32"),
    "mlstm": ModelConfig("c-mlstm", "ssm", 1, 16, 2, 2, 0, 256,
                         layer_pattern=("mlstm",), rope_type="none",
                         dtype="float32"),
    "slstm": ModelConfig("c-slstm", "ssm", 1, 16, 2, 2, 0, 256,
                         layer_pattern=("slstm",), rope_type="none",
                         dtype="float32"),
}


@pytest.mark.parametrize("kind", sorted(BLOCK))
def test_recurrent_remat_gradients(kind, monkeypatch):
    """T 512 from a nonzero state, loss sum(tanh(y)) + sum of the final
    state: the chunked loop (two checkpointed slices, counted) against
    the same loop unchunked and against the reference."""
    cfg = BLOCK[kind]
    B, T = 2, 2 * tssm.SCAN_CHUNK
    rng = np.random.default_rng(5)
    jp = jssm.INIT[kind](jax.random.PRNGKey(0), cfg, jnp.float32)
    x = rng.standard_normal((B, T, cfg.d_model)).astype(np.float32)
    state = {k: 0.1 * rng.standard_normal(v.shape).astype(np.float32)
             for k, v in jssm.MAKE_STATE[kind](cfg, B, jnp.float32).items()}
    if kind == "slstm":
        state["n"] = np.abs(state["n"]) + 0.5

    def jloss(p, x, s):
        y, fin = jssm.FORWARD[kind](p, cfg, x, s)
        return jnp.sum(jnp.tanh(y)) + sum(jnp.sum(v) for v in fin.values())

    jg = jax.grad(jloss, argnums=(0, 1, 2))(
        jp, jnp.asarray(x), {k: jnp.asarray(v) for k, v in state.items()})

    def port():
        p = {k: _tensor(np.asarray(v), CPU).requires_grad_()
             for k, v in jp.items()}
        tx = torch.from_numpy(x.copy()).requires_grad_()
        ts = {k: torch.from_numpy(v.copy()).requires_grad_()
              for k, v in state.items()}
        y, fin = tssm.FORWARD[kind](p, cfg, tx, ts)
        loss = torch.tanh(y).sum() + sum(v.sum() for v in fin.values())
        loss.backward()
        return y.detach(), ({k: v.grad for k, v in p.items()}, tx.grad,
                            {k: v.grad for k, v in ts.items()})

    slices = []
    ckpt = tssm.checkpoint
    monkeypatch.setattr(tssm, "checkpoint",
                        lambda *a, **kw: slices.append(1) or ckpt(*a, **kw))
    y_c, g_c = port()
    assert len(slices) == 2
    monkeypatch.setattr(tssm, "SCAN_CHUNK", 4 * T)      # one plain loop
    y_u, g_u = port()
    assert len(slices) == 2
    np.testing.assert_allclose(to_np(y_c), to_np(y_u), rtol=1e-6, atol=1e-6)
    (pc, xc, sc), (pu, xu, su), (pj, xj, sj) = g_c, g_u, jg
    pairs = [(xc, xu, xj)] + [(pc[k], pu[k], pj[k]) for k in pj] + \
        [(sc[k], su[k], sj[k]) for k in sj]
    for a, b, r in pairs:
        np.testing.assert_allclose(to_np(a), to_np(b), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(to_np(a), to_np(r), rtol=1e-4, atol=1e-4)
