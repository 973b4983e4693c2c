"""Sliding-window ("swa"), latent ("mla") and M-RoPE attention on the port
against the reference, CPU.

Mirrors the ``"swa"``/``"mla"`` cases of ``tests/test_attention_and_cache.py``
(decode equals teacher forcing; verify + commit equals sequential decode),
``tests/test_spec_decode.py::test_greedy_sd_equals_greedy_ar[swa|mla]``,
``tests/test_paged_attention.py::test_sd_rounds_token_identical_swa_rows``
and the SWA refusals of ``tests/test_prefix_sharing.py`` (the mirror of
``tests/test_admission.py::test_paged_growth_swa_target`` is in
``tests/test_torch_admission.py``), and adds:

* the window terms: a ``"swa"`` prefill wider than the window equals the
  reference on the flash branch (``use_flash``, T >= 128; the plain version
  on the CPU) and on the chunked branch (T * S > 2 097 152); a ragged
  ``"swa"`` prefill keeps the bucket's tail in every ring, as the reference
  does (ROADMAP queue 3);
* continuous paged streams of ``gemma3-12b`` (rings dense inside a paged
  cache, a row reused after a request longer than its window) and
  ``minicpm3-4b`` (latent pages), request for request;
* ``apply_mrope`` with distinct (t, h, w) ids and an M-RoPE prefill from
  ``inputs_embeds``, and ``params_from_jax`` on MLA stacks;
* the ring's cache utilities: ``grow_cache_seq`` refuses a ring resize as
  the reference does, and ``init_cache(reuse=...)`` resets ``pos`` to -1.

Same weights on both sides (``model_pair``), fp32, TF32 off.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import CPU, both, model_pair, port_config, to_np
from repro.configs.base import ModelConfig
from repro.configs.registry import get_config as ref_get_config
from repro.core.spec_decode import generate_ar as jax_generate_ar
from repro.models import layers as jlayers
from repro.models.model import Model as JaxModel
from repro.models.model import grow_cache_seq as jax_grow_cache_seq
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro_torch.core.proposer import make_proposer
from repro_torch.core.spec_decode import SDEngine, generate_ar
from repro_torch.models import layers as tlayers
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import Model, grow_cache_seq
from repro_torch.serving.engine import ServingEngine

TOL = 1e-4
CFGS = {
    "swa": ModelConfig("c-swa", "dense", 2, 64, 4, 2, 128, 256,
                       layer_pattern=("swa",), sliding_window=6,
                       dtype="float32"),
    "mla": ModelConfig("c-mla", "dense", 2, 64, 4, 4, 128, 256,
                       layer_pattern=("mla",), mla_kv_lora_rank=16,
                       mla_q_lora_rank=0, mla_qk_rope_dim=8,
                       mla_qk_nope_dim=16, mla_v_head_dim=16, head_dim=24,
                       dtype="float32"),
}
MIXED = ModelConfig("pa-swa", "dense", 2, 64, 4, 2, 128, 512,
                    layer_pattern=("attn", "swa"), sliding_window=6,
                    dtype="float32")
DCFG = ModelConfig("swa-draft", "dense", 2, 64, 2, 2, 128, 512,
                   dtype="float32")


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(to_np(a), to_np(b), rtol=tol, atol=tol)


# ------------------------------------------------------ the window terms
@pytest.mark.parametrize("branch,T", [("flash", 256), ("chunked", 1536)])
def test_swa_prefill_wider_than_window_matches_reference(branch, T):
    """gemma3-12b-reduced (window 16): a prefill far wider than the window
    on the flash branch (T 256) or the chunked branch (T 1536: T * T >
    2 097 152), then a verify extend over the ring.  Without the window
    terms every SWA query would attend over the whole prefix."""
    cfg = ref_get_config("gemma3-12b", reduced=True)
    use_flash = branch == "flash"
    _, jp, tm, tp = model_pair(cfg)
    jm = JaxModel(cfg, use_flash=use_flash)
    tm.use_flash = use_flash
    B = 2 if use_flash else 1
    toks = np.random.default_rng(T).integers(
        3, cfg.vocab_size, (B, T)).astype(np.int32)
    jl, _ = jm.forward_train(jp, jnp.asarray(toks))
    tl, _ = tm.forward_train(tp, toks)
    _close(tl, jl)
    jlast, jc = jm.prefill(jp, jnp.asarray(toks), jm.init_cache(B, T + 16))
    tlast, tc = tm.prefill(tp, toks, tm.init_cache(B, T + 16))
    _close(tlast, jlast)
    assert tc["layers"][0]["pos"].shape == (B, 16 + 8)
    np.testing.assert_array_equal(tc["layers"][0]["pos"].numpy(),
                                  np.asarray(jc["layers"][0]["pos"][0]))
    ver = np.full((B, 5), 11, np.int32)
    jv, _ = jm.extend(jp, jnp.asarray(ver), jc)
    tv, _ = tm.extend(tp, ver, tc)
    _close(tv, jv)


def test_ragged_swa_prefill_ring_holds_the_bucket_tail():
    """A fault of the reference that the port keeps (ROADMAP queue 3): a
    ragged "swa" prefill writes the last min(T, W) positions of the padded
    bucket into every ring, not each row's own last W, so a row shorter
    than the bucket loses the start of its window (here row 1, 9 tokens in
    a bucket of 24, attends to itself alone at position 9).  Decode after
    the ragged prefill equals the reference's; the full-length row equals
    its teacher forcing and the short row does not, in both packages.  A
    repair of both flips the last assertion."""
    cfg = CFGS["swa"]                                 # window 6, ring of 14
    jm, jp, tm, tp = model_pair(cfg)
    T, L, T1 = 24, 9, 3
    rng = np.random.default_rng(5)
    prompt = rng.integers(3, 256, (2, T)).astype(np.int32)
    prompt[1, L:] = 0
    lengths = np.array([T, L], np.int32)
    steps = rng.integers(3, 256, (2, T1)).astype(np.int32)
    _, tc = tm.prefill(tp, prompt, tm.init_cache(2, T + T1 + 2),
                       lengths=lengths)
    _, jc = jm.prefill(jp, jnp.asarray(prompt), jm.init_cache(2, T + T1 + 2),
                       lengths=jnp.asarray(lengths))
    got, jgot = [], []
    for t in range(T1):
        lg, tc = tm.decode_step(tp, steps[:, t], tc)
        jlg, jc = jm.decode_step(jp, jnp.asarray(steps[:, t]), jc)
        _close(lg, jlg)
        got.append(to_np(lg))
        jgot.append(to_np(jlg))
    got, jgot = np.stack(got, 1), np.stack(jgot, 1)   # (B, T1, V)
    for b, n in ((0, T), (1, L)):
        seq = np.concatenate([prompt[b, :n], steps[b]])[None]
        tf, _ = tm.forward_train(tp, seq)
        jtf, _ = jm.forward_train(jp, jnp.asarray(seq))
        tf, jtf = to_np(tf)[0, n:n + T1], to_np(jtf)[0, n:n + T1]
        gap, jgap = np.abs(got[b] - tf).max(), np.abs(jgot[b] - jtf).max()
        if b == 0:
            assert gap <= 2e-4 and jgap <= 2e-4, (gap, jgap)
        else:
            assert gap > 1e-2 and jgap > 1e-2, (gap, jgap)


# ------------------------------------------ mirrors of the cache tests
@pytest.mark.parametrize("name", sorted(CFGS))
def test_decode_matches_teacher_forcing(name):
    """Prefill + single decode steps reproduce the forward logits, on the
    port, and equal the reference's decode logits."""
    cfg = CFGS[name]
    jm, jp, tm, tp = model_pair(cfg)
    B, T0, T1 = 2, 6, 5
    toks = np.random.default_rng(1).integers(
        0, 256, (B, T0 + T1)).astype(np.int32)
    full, _ = tm.forward_train(tp, toks)
    last, tc = tm.prefill(tp, toks[:, :T0], tm.init_cache(B, T0 + T1 + 2))
    _, jc = jm.prefill(jp, jnp.asarray(toks[:, :T0]),
                       jm.init_cache(B, T0 + T1 + 2))
    _close(last, full[:, T0 - 1], 2e-4)
    for t in range(T1):
        lg, tc = tm.decode_step(tp, toks[:, T0 + t], tc)
        jlg, jc = jm.decode_step(jp, jnp.asarray(toks[:, T0 + t]), jc)
        _close(lg, jlg)
        if t + 1 < T1:
            _close(lg, full[:, T0 + t], 2e-4)


@pytest.mark.parametrize("seed,gamma", [(0, 1), (3, 3), (7, 4)])
def test_verify_commit_equals_sequential(seed, gamma):
    """SWA: extend(gamma + 1) + commit(n) leaves the ring as n single steps
    would: the next token's logits equal a fresh prefill of the accepted
    prefix, row by row, and the reference's."""
    cfg = CFGS["swa"]
    jm, jp, tm, tp = model_pair(cfg)
    rng = np.random.default_rng(seed)
    B, T0 = 2, 8
    toks = rng.integers(0, 256, (B, T0)).astype(np.int32)
    drafts = rng.integers(0, 256, (B, gamma + 1)).astype(np.int32)
    n_commit = rng.integers(1, gamma + 2, (B,)).astype(np.int32)
    _, tc = tm.prefill(tp, toks, tm.init_cache(B, T0 + 16))
    _, pend = tm.extend(tp, drafts, tc, collect=True)
    tc = tm.commit(pend, torch.from_numpy(n_commit), collected=True)
    _, jc = jm.prefill(jp, jnp.asarray(toks), jm.init_cache(B, T0 + 16))
    _, jpend = jm.extend(jp, jnp.asarray(drafts), jc, collect=True)
    jc = jm.commit(jpend, jnp.asarray(n_commit), collected=True)
    probe = np.full((B, 1), 7, np.int32)
    lg, _ = tm.extend(tp, probe, tc)
    jlg, _ = jm.extend(jp, jnp.asarray(probe), jc)
    _close(lg, jlg)
    for b in range(B):
        prefix = np.concatenate([toks[b], drafts[b, : n_commit[b]]])[None]
        _, c = tm.prefill(tp, prefix, tm.init_cache(1, T0 + 16))
        ref, _ = tm.extend(tp, probe[:1], c)
        _close(lg[b], ref[0], 3e-4)


@pytest.mark.parametrize("name", sorted(CFGS))
def test_greedy_sd_equals_greedy_ar(name):
    """Greedy SD == greedy AR on the port, and == the reference's AR."""
    cfg = CFGS[name]
    jm, jp, tm, tp = model_pair(cfg)
    dcfg = CFGS["swa"] if name == "mla" else CFGS["mla"]  # a 256-vocab draft
    _, _, dm, dp = model_pair(dcfg, seed=7)
    prompts = np.random.default_rng(1).integers(0, 256, (3, 8)).astype(
        np.int32)
    eng = SDEngine(tm, make_proposer("model", tm, dm), gamma=3)
    out_sd, stats = eng.generate(tp, dp, prompts, 20)
    out_ar = generate_ar(tm, tp, prompts, 20)
    np.testing.assert_array_equal(out_sd, out_ar)
    np.testing.assert_array_equal(
        out_ar, np.asarray(jax_generate_ar(jm, jp, jnp.asarray(prompts), 20)))
    assert stats.rounds >= 1 and stats.generated >= 3 * (20 - 1)


# ----------------------------------------------- paged: rings stay dense
PS, POOL_MP = 8, 4                                    # max_seq = 32


def _swa_trace(tm, tp, dm, dp, *, paged_attention, paged, gamma=2,
               rounds=4):
    from repro_torch.models.model import PageAllocator
    tm.paged_attention = paged_attention
    eng = SDEngine(tm, make_proposer("model", tm, dm), gamma=gamma)
    prompts = np.random.default_rng(4).integers(3, 512, (2, 6)).astype(
        np.int32)
    max_seq = POOL_MP * PS
    if paged:
        alloc = PageAllocator(2, PS, 2 * POOL_MP + 1, POOL_MP)
        for b in range(2):
            alloc.alloc(b, max_seq)
        state = eng.start(tp, dp, prompts, max_seq=max_seq,
                          cache_opts={"paged": True, "page_size": PS,
                                      "pool_pages": alloc.pool_pages},
                          page_table=alloc.table)
    else:
        state = eng.start(tp, dp, prompts, max_seq=max_seq)
    trace = [state.last_token.numpy().copy()]
    for _ in range(rounds):
        state, res = eng.round(state, gamma=gamma)
        for b in range(2):
            trace.append(res.committed[b, : res.n_commit[b]].copy())
    tm.paged_attention = "kernel"
    return trace


def test_sd_rounds_token_identical_swa_rows():
    """Mixed attn + swa: the SWA layers keep dense ring rows inside a paged
    cache (they never enter the kernel), the attn layers take the kernel
    path (its plain version here); tokens equal the gather path's and a
    dense cache's."""
    _, _, tm, tp = model_pair(MIXED)
    _, _, dm, dp = model_pair(DCFG, seed=1)
    kernel = _swa_trace(tm, tp, dm, dp, paged_attention="kernel", paged=True)
    gather = _swa_trace(tm, tp, dm, dp, paged_attention="gather", paged=True)
    dense = _swa_trace(tm, tp, dm, dp, paged_attention="kernel", paged=False)
    for a, b, c in zip(kernel, gather, dense):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_swa_refusals_match_reference():
    """prefix_sharing cannot fork a ring ("cannot share"), and a chunk wider
    than SWA_RING_PAD + 1 would evict in-window entries: both engines
    refuse both at construction."""
    jt, jpt, tt, tpt = model_pair(MIXED)
    jd, jpd, td, tpd = model_pair(DCFG, seed=1)
    for cls, m in ((ServingEngine, (tt, td, tpt, tpd)),
                   (JaxServingEngine, (jt, jd, jpt, jpd))):
        with pytest.raises(ValueError, match="cannot share"):
            cls(*m, scheduler="continuous", kv_layout="paged", page_size=8,
                prefix_sharing=True)
        with pytest.raises(ValueError, match="SWA_RING_PAD"):
            cls(*m, scheduler="continuous", prefill_chunk=10)
        cls(*m, scheduler="continuous", prefill_chunk=9)


# ------------------------------------- continuous paged, reduced archs
@pytest.mark.parametrize("arch", ["gemma3-12b", "minicpm3-4b"])
def test_continuous_paged_stream_matches_reference(arch):
    """Five requests through two paged slots, SD with the model proposer:
    the first prompt (40 tokens) is longer than gemma3-reduced's window
    (16), and its row is reused by a later request; every output equals
    the reference's stream and the port's AR stream."""
    cfg = ref_get_config(arch, reduced=True)
    jt, jpt, tt, tpt = model_pair(cfg)
    jd, jpd, td, tpd = model_pair(DCFG, seed=1)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(3, 512, n).astype(np.int32)
               for n in (40, 9, 12, 30, 7)]
    outs = {}
    for key, cls, m, force in (
            ("ref", JaxServingEngine, (jt, jd, jpt, jpd), True),
            ("sd", ServingEngine, (tt, td, tpt, tpd), True),
            ("ar", ServingEngine, (tt, td, tpt, tpd), False)):
        eng = cls(*m, max_batch=2, gamma=3, force_sd=force,
                  scheduler="continuous", kv_layout="paged", page_size=8)
        uids = [eng.submit(p, max_new_tokens=6 + i % 3)
                for i, p in enumerate(prompts)]
        eng.run()
        outs[key] = [np.asarray(eng.done[u].output) for u in uids]
        assert all(eng.done[u].finish_reason == "length" for u in uids)
    for a, b, c in zip(outs["sd"], outs["ref"], outs["ar"]):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


# --------------------------------------------------------------- M-RoPE
def test_apply_mrope_matches_reference_with_distinct_ids():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 64)).astype(np.float32)
    pos = rng.integers(0, 50, (2, 5, 3)).astype(np.int32)
    (jx, tx), (jpos, tpos) = both(x), both(pos)
    out = tlayers.apply_mrope(tx, tpos, 1e6, (8, 12, 12))
    _close(out, jlayers.apply_mrope(jx, jpos, 1e6, (8, 12, 12)), 1e-5)
    # three equal ids are 1-D RoPE
    same = np.repeat(pos[..., :1], 3, -1)
    _close(tlayers.apply_mrope(tx, torch.from_numpy(same), 1e6, (8, 12, 12)),
           tlayers.apply_rope(tx, torch.from_numpy(pos[..., 0]), 1e6), 1e-5)
    with pytest.raises(ValueError, match="sum"):
        tlayers.apply_mrope(tx, tpos, 1e6, (8, 12, 8))


def test_mrope_prefill_from_inputs_embeds_matches_reference():
    """qwen2-vl-2b-reduced: a prefill from stub patch embeddings with
    distinct (t, h, w) ids, then a text extend."""
    cfg = ref_get_config("qwen2-vl-2b", reduced=True)
    jm, jp, tm, tp = model_pair(cfg)
    rng = np.random.default_rng(3)
    B, T = 2, 12
    emb = (0.02 * rng.standard_normal((B, T, cfg.d_model))).astype(np.float32)
    mpos = np.stack([np.broadcast_to(np.arange(T), (B, T)),
                     rng.integers(0, 4, (B, T)), rng.integers(0, 4, (B, T))],
                    -1).astype(np.int32)
    toks = np.zeros((B, T), np.int32)
    jl, jc = jm.prefill(jp, jnp.asarray(toks), jm.init_cache(B, T + 8),
                        inputs_embeds=jnp.asarray(emb),
                        mrope_positions=jnp.asarray(mpos))
    tl, tc = tm.prefill(tp, toks, tm.init_cache(B, T + 8),
                        inputs_embeds=torch.from_numpy(emb),
                        mrope_positions=torch.from_numpy(mpos))
    _close(tl, jl)
    jf, _ = jm.forward_train(jp, None, inputs_embeds=jnp.asarray(emb),
                             mrope_positions=jnp.asarray(mpos))
    tf, _ = tm.forward_train(tp, None, inputs_embeds=torch.from_numpy(emb),
                             mrope_positions=torch.from_numpy(mpos))
    _close(tf, jf)
    ver = rng.integers(3, cfg.vocab_size, (B, 4)).astype(np.int32)
    jv, _ = jm.extend(jp, jnp.asarray(ver), jc)
    tv, _ = tm.extend(tp, ver, tc)
    _close(tv, jv)


# ------------------------------------------------------------------ MLA
@pytest.mark.parametrize("q_rank", [0, 48])
def test_params_from_jax_on_mla_stack(q_rank):
    """``params_from_jax`` is generic over leaves: an MLA stack's latent
    projections and norms carry across as they are, layer by layer, and the
    converted model's logits equal the reference's."""
    cfg = ref_get_config("minicpm3-4b", reduced=True).with_overrides(
        mla_q_lora_rank=q_rank)
    jm = JaxModel(cfg)
    jp = jax.device_get(jm.init(jax.random.PRNGKey(4)))
    tp = params_from_jax(jp, port_config(cfg), CPU)
    want = {"w_dkv", "w_uk", "w_uv", "wo", "kv_norm"} | (
        {"w_dq", "w_uq", "q_norm"} if q_rank else {"wq"})
    for l, layer in enumerate(tp["layers"]):
        assert set(layer["mixer"]) == want
        for k in want:
            np.testing.assert_array_equal(
                layer["mixer"][k].numpy(),
                np.asarray(jp["layers"][l % cfg.period]["mixer"][k])[
                    l // cfg.period])
    toks = np.arange(3, 15, dtype=np.int32)[None]
    jl, _ = jm.forward_train(jp, jnp.asarray(toks))
    tl, _ = Model(port_config(cfg), device="cpu").forward_train(tp, toks)
    _close(tl, jl)


# ------------------------------------------------ ring cache utilities
def test_ring_cache_grow_refusal_and_reuse_reset():
    cfg = ref_get_config("gemma3-12b", reduced=True)
    _, _, tm, tp = model_pair(cfg)
    jm = JaxModel(cfg)
    # a ring narrower than window + pad cannot grow: both refuse
    small = tm.init_cache(2, 20)
    assert small["layers"][0]["k"].shape[1] == 20
    with pytest.raises(NotImplementedError, match="ring resize"):
        grow_cache_seq(small, tm.cfg, 64)
    with pytest.raises(NotImplementedError, match="ring resize"):
        jax_grow_cache_seq(jm.init_cache(2, 20), cfg, 64)
    # at full width the ring is kept and the attn layer grows
    full = tm.init_cache(2, 32)
    grown = grow_cache_seq(full, tm.cfg, 64)
    assert grown["layers"][0]["k"] is full["layers"][0]["k"]
    assert grown["layers"][1]["k"].shape[1] == 64 + 1
    # a reused cache starts over: every ring slot empty (pos -1)
    toks = np.arange(3, 30, dtype=np.int32)[None].repeat(2, 0)
    _, c = tm.prefill(tp, toks, full)
    assert (c["layers"][0]["pos"] >= 0).all()
    again = tm.init_cache(2, 32, reuse=c)
    assert again is c and (again["layers"][0]["pos"] == -1).all()
    assert not again["layers"][1]["k"].any()
