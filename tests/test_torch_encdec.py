"""Whisper's encoder, cross-attention and encoder-decoder serving on the
port against the reference, CPU.

* the sinusoidal positions (the encoder's table, the decoder's embedding);
* ``Model.encode`` (bidirectional attention over the stub frames, on the
  masked and the chunked branch), the per-layer cross K/V and
  ``cross_attn_forward`` on both its branches;
* prefill and decode with ``encoder_embeds``, and the cache's cross K/V
  written in place and reset by ``init_cache(reuse=...)``;
* a greedy SD wave of ``whisper-base-reduced`` through
  ``SpecDecoder.generate(..., prefill_kwargs={"encoder_embeds": ...})``
  equal to the reference's and to the port's ``generate_ar``;
* the serving engine's and the serve CLI's refusal of an encoder-decoder
  target, where the reference's engine crashes (ROADMAP queue 3).

Same weights on both sides (``model_pair``), fp32, TF32 off.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import both, model_pair, to_np
from repro.configs.registry import draft_for as ref_draft_for
from repro.configs.registry import get_config as ref_get_config
from repro.core.spec_decode import SpecDecoder as JaxSpecDecoder
from repro.models import attention as jattn
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro_torch.core.spec_decode import SpecDecoder, generate_ar
from repro_torch.models import attention as tattn
from repro_torch.serving.engine import ServingEngine

TOL = 1e-4
ARCH = "whisper-base"


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(to_np(a), to_np(b), rtol=tol, atol=tol)


@functools.lru_cache(maxsize=None)
def _pairs():
    cfg = ref_get_config(ARCH, reduced=True)
    return (model_pair(cfg, seed=0), model_pair(ref_draft_for(cfg), seed=7))


def _frames(cfg, B, seed=3, S=None):
    rng = np.random.default_rng(seed)
    S = cfg.encoder_seq_len if S is None else S
    return both(0.5 * rng.standard_normal((B, S, cfg.d_model)).astype(
        np.float32))


def test_sinusoidal_positions_match_reference():
    """The encoder's table and the decoder's embedding-level positions at
    arbitrary (B, T) positions, against the reference's."""
    from repro.models import layers as jlayers
    from repro.models.model import sinusoidal_at as jax_sinusoidal_at
    from repro_torch.models import layers as tlayers
    _close(tlayers.sinusoidal_positions(1500, 512),
           jlayers.sinusoidal_positions(1500, 512))
    pos = np.array([[0, 7, 448], [3, 1023, 4096]], np.int32)
    jp, tp = both(pos)
    _close(tlayers.sinusoidal_at(tp, 128), jax_sinusoidal_at(jp, 128))


def test_encode_and_cross_kvs_match_reference():
    """The encoder output and every decoder layer's cross K/V; the
    reference stacks them over the layers (one period slot)."""
    (jm, jp, tm, tp), _ = _pairs()
    cfg = tm.cfg
    jf, tf = _frames(cfg, 2)
    jenc, tenc = jm.encode(jp, jf), tm.encode(tp, tf)
    assert tenc.shape == (2, cfg.encoder_seq_len, cfg.d_model)
    _close(tenc, jenc)
    jkv, tkv = jm._cross_kvs(jp, jenc), tm._cross_kvs(tp, tenc)
    assert len(jkv) == 1 and len(tkv) == cfg.num_layers
    for l, kv in enumerate(tkv):
        for k in ("k", "v"):
            _close(kv[k], jkv[0][k][l])


def test_encode_chunked_branch_matches_reference():
    """1500 frames, as whisper-base encodes: T * S > 2 097 152 sends the
    bidirectional attention to the chunked online softmax."""
    (jm, jp, tm, tp), _ = _pairs()
    jf, tf = _frames(tm.cfg, 1, S=1500)
    _close(tm.encode(tp, tf), jm.encode(jp, jf))


@pytest.mark.parametrize("T,S", [(5, 16), (1100, 2000)])
def test_cross_attn_forward_both_branches(T, S):
    """The masked product (T * S small) and the chunked branch (T * S >
    2 097 152, chunks of min(1024, S)) against the reference."""
    (jm, jp, tm, tp), _ = _pairs()
    cfg = tm.cfg
    rng = np.random.default_rng(T)
    jx, tx = both(rng.standard_normal((1, T, cfg.d_model)).astype(np.float32))
    jenc, tenc = both(rng.standard_normal((1, S, cfg.d_model)).astype(
        np.float32))
    jl, tl = jp["layers"][0]["cross"], tp["layers"][0]["cross"]
    jl = {k: v[0] for k, v in jl.items()}
    jkv = jattn.cross_attn_prefill_cache(jl, cfg, jenc, jnp.float32)
    tkv = tattn.cross_attn_prefill_cache(tl, cfg, tenc, torch.float32)
    _close(tattn.cross_attn_forward(tl, cfg, tx, tkv),
           jattn.cross_attn_forward(jl, cfg, jx, jkv))


def test_prefill_decode_with_encoder_embeds_match_reference():
    """Teacher-forced logits, prefill and two decode steps with the same
    frames; the cross K/V land in the cache's own tensors, and a reused
    cache is zeroed and refilled in place."""
    (jm, jp, tm, tp), _ = _pairs()
    cfg = tm.cfg
    B, T = 2, 10
    toks = np.random.default_rng(4).integers(3, cfg.vocab_size, (B, T)
                                             ).astype(np.int32)
    jf, tf = _frames(cfg, B)
    jl, _ = jm.forward_train(jp, jnp.asarray(toks), encoder_embeds=jf)
    tl, _ = tm.forward_train(tp, toks, encoder_embeds=tf)
    _close(tl, jl)
    cache = tm.init_cache(B, T + 4)
    cross = [slot["k"] for slot in cache["cross"]]
    last, cache = tm.prefill(tp, toks, cache, encoder_embeds=tf)
    jlast, jc = jm.prefill(jp, jnp.asarray(toks), jm.init_cache(B, T + 4),
                           encoder_embeds=jf)
    _close(last, jlast)
    assert all(s["k"] is c for s, c in zip(cache["cross"], cross))
    tok = np.asarray(jnp.argmax(jlast, -1)).astype(np.int32)
    for _ in range(2):
        lg, cache = tm.decode_step(tp, tok, cache)
        jlg, jc = jm.decode_step(jp, jnp.asarray(tok), jc)
        _close(lg, jlg)
        tok = np.asarray(jnp.argmax(jlg, -1)).astype(np.int32)
    again = tm.init_cache(B, T + 4, reuse=cache)
    assert again is cache and not any(s["k"].any() for s in again["cross"])
    last2, _ = tm.prefill(tp, toks, again, encoder_embeds=tf)
    torch.testing.assert_close(last2, last, rtol=0, atol=0)
    with pytest.raises(ValueError, match="encoder_embeds"):
        tm.prefill(tp, toks, tm.init_cache(B, T + 4))


def test_greedy_sd_wave_equals_reference_and_ar():
    """A greedy SD wave over ``draft_for`` (decoder-only, sinusoidal
    positions, no encoder) with the frames through ``prefill_kwargs``:
    the port's tokens equal the reference's SD and the port's AR."""
    (jm, jp, tm, tp), (jd, jpd, dm, dp) = _pairs()
    cfg = tm.cfg
    prompts = np.random.default_rng(6).integers(
        3, cfg.vocab_size, (3, 8)).astype(np.int32)
    jf, tf = _frames(cfg, 3, seed=8)
    out_sd, stats = SpecDecoder(tm, dm, gamma=4).generate(
        tp, dp, prompts, 12, prefill_kwargs={"encoder_embeds": tf})
    out_ar = generate_ar(tm, tp, prompts, 12,
                         prefill_kwargs={"encoder_embeds": tf})
    jout, _ = JaxSpecDecoder(jm, jd, gamma=4).generate(
        jp, jpd, jnp.asarray(prompts), 12,
        prefill_kwargs={"encoder_embeds": jf})
    np.testing.assert_array_equal(out_sd, np.asarray(jout))
    np.testing.assert_array_equal(out_sd, out_ar)
    assert stats.rounds >= 1


def test_serving_engine_refuses_encoder_decoder():
    """A fault of the reference (ROADMAP queue 3): its ServingEngine passes
    no ``encoder_embeds``, so serving whisper crashes in ``Model.encode``
    with an AttributeError.  The port refuses the target at construction
    with a ValueError naming the queue, from the engine and from the serve
    CLI."""
    (jm, jp, tm, tp), (jd, jpd, dm, dp) = _pairs()
    with pytest.raises(ValueError, match="ROADMAP queue 3"):
        ServingEngine(tm, dm, tp, dp, max_batch=2)
    with pytest.raises(ValueError, match="ROADMAP queue 3"):
        ServingEngine(tm, None, tp, None, proposer="none",
                      scheduler="continuous", kv_layout="paged")
    from repro_torch.launch import serve
    with pytest.raises(ValueError, match="ROADMAP queue 3"):
        serve.main(["--arch", "whisper-base", "--reduced", "--device", "cpu",
                    "--requests", "2", "--no-autotune"])
    jeng = JaxServingEngine(jm, jd, jp, jpd, max_batch=2)
    jeng.submit(np.arange(3, 9, dtype=np.int32), max_new_tokens=2)
    with pytest.raises(AttributeError, match="shape"):
        jeng.run()
