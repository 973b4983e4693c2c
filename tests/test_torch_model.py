"""Port's Model vs the reference on the same weights: prefill logits and a
gamma+1 extend (an SD verify pass), for the reduced qwen2-57b-a14b target
(gmm dispatch) and the reduced qwen2-0.5b draft, with and without
``use_flash``.  fp32 on the CPU, 1e-4."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import both, model_pair, to_np
from repro.configs.registry import get_config
from repro.models import attention as jattn
from repro_torch.models import attention as tattn

ARCHS = [("qwen2-57b-a14b", "gmm"), ("qwen2-0.5b", "onehot")]


def _prompts(vocab, B=3, T=12, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(3, vocab, size=(B, T)).astype(np.int32)
    lengths = np.array([T, 7, 10][:B], np.int32)
    return toks, lengths


@pytest.mark.parametrize("arch,dispatch", ARCHS)
def test_prefill_and_verify_extend_match_reference(arch, dispatch):
    cfg = get_config(arch, reduced=True)
    jm, jp, tm, tp = model_pair(cfg, moe_dispatch=dispatch)
    toks, lengths = _prompts(cfg.vocab_size)
    max_seq = 32
    jl, jc = jm.prefill(jp, jnp.asarray(toks), jm.init_cache(3, max_seq),
                        lengths=jnp.asarray(lengths))
    tl, tc = tm.prefill(tp, toks, tm.init_cache(3, max_seq), lengths=lengths)
    np.testing.assert_allclose(to_np(tl), to_np(jl), rtol=1e-4, atol=1e-4)
    # gamma=4 verify pass at per-row offsets, then a commit and one decode
    ver = np.random.default_rng(2).integers(3, cfg.vocab_size, (3, 5)).astype(np.int32)
    jv, jpend = jm.extend(jp, jnp.asarray(ver), jc, collect=True)
    tv, tpend = tm.extend(tp, ver, tc, collect=True)
    np.testing.assert_allclose(to_np(tv), to_np(jv), rtol=1e-4, atol=1e-4)
    n_commit = np.array([1, 3, 5], np.int32)
    jc = jm.commit(jpend, jnp.asarray(n_commit), collected=True)
    tc = tm.commit(tpend, torch.from_numpy(n_commit), collected=True)
    np.testing.assert_array_equal(tc["lengths"].numpy(), np.asarray(jc["lengths"]))
    jd, _ = jm.decode_step(jp, jnp.asarray(ver[:, 0]), jc)
    td, _ = tm.decode_step(tp, ver[:, 0], tc)
    np.testing.assert_allclose(to_np(td), to_np(jd), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("T", [128, 256])
@pytest.mark.parametrize("arch,dispatch", ARCHS)
def test_use_flash_prefill_and_extend_match_reference(arch, dispatch, T):
    """``use_flash=True`` on both sides: a T-token prefill takes the flash
    kernel (T >= 128) and the verify and decode extends at max_seq 512 the
    dense decode kernel (the reference's in interpret mode, the port's plain
    versions on the CPU).  ``use_flash`` changes no parameter: the weights
    are the ones ``params_from_jax`` converts for every other test."""
    from repro.models.model import Model as JaxModel
    cfg = get_config(arch, reduced=True)
    _, jp, tm, tp = model_pair(cfg, moe_dispatch=dispatch)
    jm = JaxModel(cfg, moe_dispatch=dispatch, use_flash=True)
    tm.use_flash = True
    rng = np.random.default_rng(T)
    toks = rng.integers(3, cfg.vocab_size, (3, T)).astype(np.int32)
    lengths = np.array([T, T - 40, T - 3], np.int32)
    jl, jc = jm.prefill(jp, jnp.asarray(toks), jm.init_cache(3, 512),
                        lengths=jnp.asarray(lengths))
    tl, tc = tm.prefill(tp, toks, tm.init_cache(3, 512), lengths=lengths)
    np.testing.assert_allclose(to_np(tl), to_np(jl), rtol=1e-4, atol=1e-4)
    ver = rng.integers(3, cfg.vocab_size, (3, 5)).astype(np.int32)
    jv, jpend = jm.extend(jp, jnp.asarray(ver), jc)
    tv, tpend = tm.extend(tp, ver, tc)
    np.testing.assert_allclose(to_np(tv), to_np(jv), rtol=1e-4, atol=1e-4)
    n_commit = np.array([1, 5, 2], np.int32)
    jc = jm.commit(jpend, jnp.asarray(n_commit))
    tc = tm.commit(tpend, torch.from_numpy(n_commit))
    jd, _ = jm.decode_step(jp, jnp.asarray(ver[:, 1]), jc)
    td, _ = tm.decode_step(tp, ver[:, 1], tc)
    np.testing.assert_allclose(to_np(td), to_np(jd), rtol=1e-4, atol=1e-4)


def test_extend_past_capacity_matches_reference():
    """A row that runs past max_seq: the reference drops those writes, the
    port sends them to the trash slot; logits agree either way."""
    cfg = get_config("qwen2-0.5b", reduced=True)
    jm, jp, tm, tp = model_pair(cfg)
    toks, lengths = _prompts(cfg.vocab_size)
    max_seq = 14                      # row 0 (12 tokens) + 5 overflows
    _, jc = jm.prefill(jp, jnp.asarray(toks), jm.init_cache(3, max_seq),
                       lengths=jnp.asarray(lengths))
    _, tc = tm.prefill(tp, toks, tm.init_cache(3, max_seq), lengths=lengths)
    ver = np.full((3, 5), 7, np.int32)
    jv, _ = jm.extend(jp, jnp.asarray(ver), jc)
    tv, _ = tm.extend(tp, ver, tc)
    np.testing.assert_allclose(to_np(tv), to_np(jv), rtol=1e-4, atol=1e-4)


def test_chunked_sdpa_matches_reference_and_dense():
    rng = np.random.default_rng(0)
    B, T, S, Hq, Hkv, D = 2, 5, 40, 4, 2, 16
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, T, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    q_pos = np.array([[30, 31, 32, 33, 34], [3, 4, 5, 6, 7]], np.int32)
    k_pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    (jq, tq), (jk, tk), (jv, tv), (jqp, tqp), (jkp, tkp) = (
        both(a) for a in (q, k, v, q_pos, k_pos))
    out = tattn.chunked_sdpa(tq, tk, tv, tqp, tkp, scale=0.25, chunk=16)
    ref = jattn.chunked_sdpa(jq, jk, jv, jqp, jkp, scale=0.25, chunk=16)
    dense = tattn._sdpa(tq, tk, tv, tattn._causal_mask(tqp, tkp), 0.25)
    np.testing.assert_allclose(to_np(out), to_np(ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(to_np(out), to_np(dense), rtol=1e-5, atol=1e-5)


def test_unported_paths_raise_naming_the_roadmap():
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.faults import FaultInjector
    cfg = get_config("qwen2-0.5b", reduced=True)
    _, _, tm, tp = model_pair(cfg)
    # queue 1 item 7 is ported: the three options construct, and the
    # reference's misconfigurations of them raise ValueError
    for opt in ({"prefix_sharing": True, "kv_layout": "paged"},
                {"prefill_chunk": 4}, {"fault_injector": FaultInjector()}):
        eng = ServingEngine(tm, None, tp, None, proposer="none",
                            scheduler="continuous", **opt)
        assert all(getattr(eng, k) is v for k, v in opt.items())
    for opt, match in (({"prefix_sharing": True, "scheduler": "continuous"},
                        "kv_layout='paged'"),
                       ({"prefill_chunk": 0, "scheduler": "continuous"},
                        ">= 1"),
                       ({"prefill_chunk": 4}, "scheduler='continuous'"),
                       ({"fault_injector": FaultInjector()},
                        "continuous-scheduler features")):
        with pytest.raises(ValueError, match=match):
            ServingEngine(tm, None, tp, None, proposer="none", **opt)
    # queue 1 item 9 is ported: the recurrent and encoder-decoder configs
    # construct, prefill and decode
    from repro_torch.configs.registry import get_config as port_get_config
    from repro_torch.models.model import Model
    for arch in ("jamba-v0.1-52b", "xlstm-1.3b", "whisper-base"):
        c = port_get_config(arch, reduced=True)
        m = Model(c, device="cpu")
        p = m.init(torch.Generator().manual_seed(0))
        kw = ({"encoder_embeds": torch.zeros((1, c.encoder_seq_len,
                                              c.d_model))}
              if c.is_encoder_decoder else {})
        _, cache = m.prefill(p, np.ones((1, 4), np.int32),
                             m.init_cache(1, 8), **kw)
        lg, _ = m.decode_step(p, np.ones((1,), np.int32), cache)
        assert lg.shape == (1, c.vocab_size) and torch.isfinite(lg).all()
    # queue 1 item 11 is ported too: "ep" with no mesh is the one-hot
    # dispatch, as in the reference
    jcfg = port_get_config("jamba-v0.1-52b", reduced=True)
    ep = Model(jcfg, moe_dispatch="ep", device="cpu")
    one = Model(jcfg, moe_dispatch="onehot", device="cpu")
    p = ep.init(torch.Generator().manual_seed(0))
    toks = np.ones((1, 4), np.int32)
    (lg_ep, m_ep), (lg_one, m_one) = (ep.forward_train(p, toks),
                                      one.forward_train(p, toks))
    assert torch.equal(lg_ep, lg_one)
    assert torch.equal(m_ep["expert_counts"], m_one["expert_counts"])
    # use_flash is ported: a 128-token prefill and a verify at max_seq 512
    # run the kernel branches (their plain versions on the CPU)
    tm.use_flash = True
    last, cache = tm.prefill(tp, np.ones((1, 128), np.int32),
                             tm.init_cache(1, 512))
    logits, _ = tm.extend(tp, np.ones((1, 5), np.int32), cache)
    assert logits.shape == (1, 5, cfg.vocab_size)
    assert torch.isfinite(logits).all() and torch.isfinite(last).all()


def test_entry_points_refuse_to_fall_back_to_cpu():
    from repro_torch.models.model import Model
    if torch.cuda.is_available():
        pytest.skip("a card is present: cuda is the default device")
    cfg = get_config("qwen2-0.5b", reduced=True)
    from _torch_parity import port_config
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Model(port_config(cfg))
