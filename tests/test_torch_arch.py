"""The assigned archs on the port against the reference.

Mirrors ``tests/test_arch_smoke.py`` (``test_reduced_smoke``'s forward,
prefill and decode step; ``test_full_config_matches_assignment``) for
``dbrx-132b`` (layernorm + MoE), ``gemma-7b`` (GeGLU, head dim 256 at full
width, embedding scale), ``gemma3-12b`` (5:1 sliding-window : global, final
logit softcap), ``minicpm3-4b`` (MLA), ``qwen2-vl-2b`` (M-RoPE),
``jamba-v0.1-52b`` (Mamba + attention + MoE, no positions), ``xlstm-1.3b``
(mLSTM + sLSTM) and ``whisper-base`` (encoder-decoder, sinusoidal
positions; frames from the frontend stub), and serves each decoder-only
one through the port's entry points: a wave of greedy SD with the
``"model"`` proposer over ``draft_for(cfg)`` equals the reference's wave and
the port's own AR wave token for token (whisper's wave goes through
``SpecDecoder.generate`` in ``tests/test_torch_encdec.py``: the serving
engine refuses it), jamba's continuous paged stream equals the reference's
request for request, and the serve CLI runs the SWA, MLA and recurrent
archs end to end.  The train step of ``test_reduced_smoke`` is held
against the reference's in ``tests/test_torch_train_archs.py``.

Same weights on both sides (``model_pair``), fp32, TF32 off, 1e-4 on logits.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import both, model_pair, port_config, to_np
from repro.configs.registry import draft_for as ref_draft_for
from repro.configs.registry import get_config as ref_get_config
from repro.models.model import Model as JaxModel
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro_torch.configs.registry import draft_for, get_config
from repro_torch.data.pipeline import prompt_batch
from repro_torch.models.attention import SWA_RING_PAD
from repro_torch.serving.engine import ServingEngine

ARCHS = ["dbrx-132b", "gemma-7b", "gemma3-12b", "minicpm3-4b", "qwen2-vl-2b"]
RECURRENT = ["jamba-v0.1-52b", "xlstm-1.3b"]
ALL = ARCHS + RECURRENT + ["whisper-base"]
TOL = 1e-4


def _dispatch(cfg):
    return "gmm" if cfg.num_experts else "onehot"


@pytest.mark.parametrize("arch", ALL)
def test_reduced_smoke(arch):
    """Forward, prefill and one decode step of the reduced config equal the
    reference's logits (the train step: test_torch_train_archs.py);
    whisper reads 0.02-scaled frames of ``encoder_seq_len``, as the
    reference's smoke test feeds it."""
    cfg = ref_get_config(arch, reduced=True)
    assert cfg.num_layers <= 2 and cfg.d_model <= 512 and cfg.num_experts <= 4
    jm, jp, tm, tp = model_pair(cfg, moe_dispatch=_dispatch(cfg))
    B, T = 2, 16
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    jkw, tkw = {}, {}
    if cfg.is_encoder_decoder:
        frames = 0.02 * rng.standard_normal(
            (B, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
        jkw["encoder_embeds"], tkw["encoder_embeds"] = both(frames)
    jl, _ = jm.forward_train(jp, jnp.asarray(toks), **jkw)
    tl, _ = tm.forward_train(tp, toks, **tkw)
    assert tl.shape == (B, T, cfg.vocab_size)
    np.testing.assert_allclose(to_np(tl), to_np(jl), rtol=TOL, atol=TOL)
    jlast, jc = jm.prefill(jp, jnp.asarray(toks), jm.init_cache(B, T + 4),
                           **jkw)
    tlast, tc = tm.prefill(tp, toks, tm.init_cache(B, T + 4), **tkw)
    np.testing.assert_allclose(to_np(tlast), to_np(jlast), rtol=TOL, atol=TOL)
    tok = np.asarray(jnp.argmax(jlast, -1)).astype(np.int32)
    jd, jc = jm.decode_step(jp, jnp.asarray(tok), jc)
    td, tc = tm.decode_step(tp, tok, tc)
    assert td.shape == (B, cfg.vocab_size) and torch.isfinite(td).all()
    np.testing.assert_allclose(to_np(td), to_np(jd), rtol=TOL, atol=TOL)
    assert int(tc["lengths"][0]) == T + 1 == int(jc["lengths"][0])


@pytest.mark.parametrize("arch", ALL)
def test_full_config_matches_assignment(arch):
    """The port's full and reduced configs are the reference's field for
    field, and carry the assigned hyperparameters."""
    spec = {
        "gemma-7b": (28, 3072, 16, 16, 24576, 256000),
        "minicpm3-4b": (62, 2560, 40, 40, 6400, 73448),
        "qwen2-vl-2b": (28, 1536, 12, 2, 8960, 151936),
        "gemma3-12b": (48, 3840, 16, 8, 15360, 262144),
        "dbrx-132b": (40, 6144, 48, 8, 10752, 100352),
        "whisper-base": (6, 512, 8, 8, 2048, 51865),
        "jamba-v0.1-52b": (32, 4096, 32, 8, 14336, 65536),
        "xlstm-1.3b": (48, 2048, 4, 4, 0, 50304),
    }[arch]
    for reduced in (False, True):
        assert (dataclasses.asdict(get_config(arch, reduced=reduced))
                == dataclasses.asdict(ref_get_config(arch, reduced=reduced)))
    cfg = get_config(arch)
    got = (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
           cfg.d_ff, cfg.vocab_size)
    assert got == spec, (arch, got, spec)
    moe = {"jamba-v0.1-52b": (16, 2), "dbrx-132b": (16, 4)}
    if arch in moe:
        assert (cfg.num_experts, cfg.num_experts_per_tok) == moe[arch]
    assert dataclasses.asdict(draft_for(cfg)) == dataclasses.asdict(
        ref_draft_for(ref_get_config(arch)))


def _prompts(vocab, n=4):
    pb = prompt_batch(vocab, n, seed=5, min_len=5, max_len=14)
    return [pb["tokens"][i][: int(pb["lengths"][i])] for i in range(n)]


@pytest.mark.parametrize("arch", ARCHS + RECURRENT)
def test_greedy_sd_wave_equals_reference_and_ar(arch):
    """One SD wave (the ``"model"`` proposer over ``draft_for(cfg)``) and
    one AR wave: the port's tokens equal the reference's, and SD's equal
    AR's."""
    cfg = ref_get_config(arch, reduced=True)
    dcfg = ref_draft_for(cfg)
    disp = _dispatch(cfg)
    jm, jpt, tm, tpt = model_pair(cfg, seed=0, moe_dispatch=disp)
    jd, jpd, dm, tpd = model_pair(dcfg, seed=7)
    prompts = _prompts(cfg.vocab_size)
    outs = {}
    for force in (True, False):
        jeng = JaxServingEngine(jm, jd, jpt, jpd, max_batch=4, gamma=4,
                                force_sd=force)
        teng = ServingEngine(tm, dm, tpt, tpd, max_batch=4, gamma=4,
                             force_sd=force)
        for p in prompts:
            jeng.submit(p, max_new_tokens=8)
            teng.submit(p, max_new_tokens=8)
        jrep, trep = jeng.run(), teng.run()
        assert [r.used_sd for r in trep] == [r.used_sd for r in jrep] == [force]
        for uid in jeng.done:
            np.testing.assert_array_equal(teng.done[uid].output,
                                          jeng.done[uid].output)
        outs[force] = [np.asarray(teng.done[u].output) for u in sorted(
            teng.done)]
    for a, b in zip(outs[True], outs[False]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", ["gemma3-12b", "minicpm3-4b"] + RECURRENT)
def test_serve_cli_runs_swa_and_mla_on_cpu(arch, capsys):
    """``python -m repro_torch.launch.serve --arch <arch> --reduced --device
    cpu``: waves under the AutoTuner, every request served."""
    from repro_torch.launch import serve
    reports = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                          "--requests", "3", "--max-batch", "2",
                          "--max-new", "4"])
    out = capsys.readouterr().out
    assert len(reports) == 2 and sum(r.batch for r in reports) == 3
    assert "plan: gamma=" in out and "session[model]: constructed 1x" in out


@pytest.mark.parametrize("arch", ALL)
def test_tuner_and_draft_resolve(arch):
    """``make_tuner`` prices the full config over its ``draft_for`` draft;
    its gammas keep an SD verify (gamma + 1 tokens) within a ring's pad."""
    from repro_torch.launch.serve import make_tuner
    tuner = make_tuner(arch)
    assert max(tuner.gammas) + 1 <= SWA_RING_PAD + 1
    d = draft_for(get_config(arch))
    assert d.vocab_size == get_config(arch).vocab_size
    if arch == "gemma3-12b":
        assert (d.num_layers, d.d_model, d.vocab_size) == (4, 512, 262144)
        assert (d.layer_pattern, d.num_experts) == (("attn",), 0)


@pytest.mark.parametrize("chunk", [None, 4])
def test_jamba_continuous_paged_stream_matches_reference(chunk):
    """Five requests of equal length through two paged slots (pages of 8):
    the attention layer's K/V in pages, the Mamba states dense per row and
    scattered whole on admission, a row reused by a later request; with
    ``prefill_chunk`` 4 each prompt is prefilled in three chunks, the
    Mamba states advanced by extend + commit between rounds.  SD
    (model proposer) equals the reference's stream and the port's AR
    stream request for request.  Equal lengths: a ragged bucket folds its
    padding into the recurrent state in both packages (ROADMAP queue 3)."""
    cfg = ref_get_config("jamba-v0.1-52b", reduced=True)
    jt, jpt, tt, tpt = model_pair(cfg, moe_dispatch="gmm")
    jd, jpd, td, tpd = model_pair(ref_draft_for(cfg), seed=1)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(3, cfg.vocab_size, 10).astype(np.int32)
               for _ in range(5)]
    outs = {}
    for key, cls, m, force in (
            ("ref", JaxServingEngine, (jt, jd, jpt, jpd), True),
            ("sd", ServingEngine, (tt, td, tpt, tpd), True),
            ("ar", ServingEngine, (tt, td, tpt, tpd), False)):
        eng = cls(*m, max_batch=2, gamma=3, force_sd=force,
                  scheduler="continuous", kv_layout="paged", page_size=8,
                  prefill_chunk=chunk)
        uids = [eng.submit(p, max_new_tokens=5 + i % 3)
                for i, p in enumerate(prompts)]
        eng.run()
        outs[key] = [np.asarray(eng.done[u].output) for u in uids]
        assert all(eng.done[u].finish_reason == "length" for u in uids)
        traces = [t for st in eng.session_stats().values()
                  for t in st.get("chunk_traces", ())]
        assert bool(traces) == bool(chunk), traces
    for a, b, c in zip(outs["sd"], outs["ref"], outs["ar"]):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
