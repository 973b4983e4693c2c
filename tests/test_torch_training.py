"""Training on the port against the reference, CPU.

Mirrors all eight tests of ``tests/test_training.py`` (the loss falling over
30 steps, the chunked loss against the dense one, AdamW toward a minimum,
clipping, the schedule's shape, the checkpoint round trip and its
structure-mismatch ``ValueError``, the pipeline's determinism and host
substreams, the workload classes) and
``tests/test_attention_and_cache.py::test_chunked_gradients_match_naive``,
and adds:

* ``packed_batches`` bit-equal to the reference's, the schedule, the clip
  and one AdamW update equal to the reference's on the same inputs;
* the checkpoint round trip bit for bit with a bf16 leaf (stored as its
  uint16 bits);
* ``chunked_sdpa``'s recompute backward against autograd through the naive
  attention and against the reference's ``custom_vjp``, with window,
  softcap, a ragged last chunk, invalid slots and the bidirectional form;
* per-layer remat: the same loss and gradients as without it;
* one train step on ``tr-moe`` from converted parameters and moments equal
  to the reference's jitted ``make_train_step`` (loss, aux, lr, grad norm,
  the moments and every parameter leaf);
* every kernel wrapper refusing an input that requires grad, and
  ``Model(moe_dispatch="gmm")`` / ``Model(use_flash=True)`` refusing to
  train, as the reference refuses;
* the launcher on the CPU, its checkpoint restored bit for bit.

fp32, TF32 off; each tolerance is stated where it is used.
"""
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (CPU, assert_step_matches, both, model_pair,
                           port_config, to_np)
from repro.configs.base import ModelConfig
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.data.pipeline import packed_batches as jax_packed_batches
from repro.models.attention import chunked_sdpa as jax_chunked_sdpa
from repro.models.model import Model as JaxModel
from repro.training import optimizer as jopt
from repro.training.train_loop import chunked_lm_loss as jax_chunked_lm_loss
from repro_torch.configs.base import TrainConfig
from repro_torch.data.pipeline import packed_batches, prompt_batch, synthetic_text
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.decode_attention.paged import paged_decode_attention
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.gmm.gmm import gmm_capacity
from repro_torch.kernels.gmm.ragged import (fused_gate_up, ragged_gmm,
                                            ragged_moe_ffn)
from repro_torch.launch import train as train_cli
from repro_torch.models.attention import _causal_mask, _sdpa, chunked_sdpa
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import Model
from repro_torch.training.checkpoint import (latest_checkpoint,
                                             restore_checkpoint,
                                             save_checkpoint)
from repro_torch.training.optimizer import (adamw_update, clip_by_global_norm,
                                            cosine_schedule, init_adam)
from repro_torch.training.train_loop import (chunked_lm_loss,
                                             init_train_state, lm_loss,
                                             make_train_step)
from repro_torch.training.tree import tree_items, tree_leaves, tree_map

CFG = ModelConfig("tr-moe", "moe", 2, 128, 4, 2, 256, 512, num_experts=4,
                  num_experts_per_tok=2, dtype="float32",
                  router_aux_loss_coef=0.01)
TCFG = port_config(CFG)


def _gen(seed: int = 0) -> torch.Generator:
    return torch.Generator(CPU).manual_seed(seed)


# ---------------------------------------------------------------- mirrors

def test_loss_decreases():
    """30 steps on tr-moe: the last loss is below the first by > 0.5."""
    model = Model(TCFG, remat=True, device="cpu")
    params, opt = init_train_state(model, _gen())
    step = make_train_step(model, TrainConfig(
        learning_rate=3e-3, total_steps=30, warmup_steps=2))
    it = packed_batches(CFG.vocab_size, 8, 64, kind="code")
    losses = []
    for _ in range(30):
        params, opt, m = step(params, opt, next(it))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5, losses[::6]
    assert np.isfinite(losses).all()


def test_chunked_loss_equals_dense_loss():
    """chunked_lm_loss equals the dense loss to 1e-5 (relative) for chunks
    8, 16, 48 and the padded 20, and equals the reference's chunked loss on
    the same hidden states and weights to 1e-5."""
    jm, jp, tm, tp = model_pair(CFG)
    B, T = 2, 48
    rng = np.random.default_rng(1)
    toks = rng.integers(0, 512, (B, T))
    jl, tl = both(rng.integers(0, 512, (B, T)))
    hidden, _ = tm.forward_hidden(tp, toks)
    dense = lm_loss(tm._head(tp, hidden), tl)
    for chunk in (8, 16, 48, 20):
        ch = chunked_lm_loss(tm, tp, hidden, tl, None, chunk=chunk)
        np.testing.assert_allclose(float(ch), float(dense), rtol=1e-5)
    jh, _ = jm.forward_hidden(jp, jnp.asarray(toks))
    ref = jax_chunked_lm_loss(jm, jp, jh, jl, None, chunk=20)
    np.testing.assert_allclose(float(chunked_lm_loss(tm, tp, hidden, tl,
                                                     None, chunk=20)),
                               float(ref), rtol=1e-5)


def test_adamw_moves_toward_minimum():
    params = {"w": torch.tensor([10.0, -4.0])}
    opt = init_adam(params)
    cfg = TrainConfig(learning_rate=0.5, weight_decay=0.0, warmup_steps=0,
                      total_steps=100)
    for _ in range(60):
        grads = {"w": 2 * params["w"]}
        params, opt, m = adamw_update(params, grads, opt, cfg)
    assert float(params["w"].abs().max()) < 1.0


def test_grad_clip():
    g = {"a": torch.full((4,), 100.0)}
    clipped, norm = clip_by_global_norm(g, 1.0)
    assert abs(float(torch.linalg.norm(clipped["a"])) - 1.0) < 1e-5
    assert float(norm) > 100
    assert torch.equal(g["a"], torch.full((4,), 100.0))   # not written


def test_cosine_schedule_shape():
    cfg = TrainConfig(learning_rate=1e-3, warmup_steps=10, total_steps=100)
    lr5, lr10, lr100 = (float(cosine_schedule(torch.tensor(s), cfg))
                        for s in (5, 10, 100))
    assert lr5 < lr10
    assert abs(lr10 - cfg.learning_rate) < 1e-9
    assert lr100 < 0.2 * cfg.learning_rate


def test_checkpoint_roundtrip_and_mismatch():
    """Params and AdamState, plus a bf16 leaf, restore bit for bit into the
    template's dtypes; a structure mismatch raises ValueError."""
    model = Model(TCFG, device="cpu")
    params, opt = init_train_state(model, _gen())
    opt = opt._replace(step=torch.tensor(7, dtype=torch.int32))
    bf = torch.randn((3, 5), generator=_gen(1)).to(torch.bfloat16)
    tree = {"params": params, "opt": opt, "extra": {"bf16": bf}}
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, 3, tree, {"arch": CFG.name})
        path = latest_checkpoint(d)
        restored, manifest = restore_checkpoint(path, tree)
        assert manifest["step"] == 3
        assert manifest["metadata"] == {"arch": CFG.name}
        assert manifest["dtypes"]["extra/bf16"] == "bfloat16"
        assert type(restored["opt"]) is type(opt)
        for (ka, a), (kb, b) in zip(tree_items(restored), tree_items(tree)):
            assert ka == kb and a.dtype == b.dtype and torch.equal(a, b), ka
        with pytest.raises(ValueError):
            restore_checkpoint(path, {"params": params})


def test_pipeline_determinism_and_shapes():
    it1 = packed_batches(512, 4, 32, kind="chat", seed=1)
    it2 = packed_batches(512, 4, 32, kind="chat", seed=1)
    b1, b2 = next(it1), next(it2)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    assert b1["tokens"].shape == (4, 32)
    # labels are tokens shifted by one within the packed stream
    np.testing.assert_array_equal(b1["tokens"].reshape(-1)[1:],
                                  b1["labels"].reshape(-1)[:-1])
    # host sharding gives disjoint streams
    h0 = next(packed_batches(512, 2, 16, host_id=0, num_hosts=2))
    h1 = next(packed_batches(512, 2, 16, host_id=1, num_hosts=2))
    assert not np.array_equal(h0["tokens"], h1["tokens"])


def test_workload_classes_differ():
    code = synthetic_text("code", 0)
    chat = synthetic_text("chat", 0)
    assert "def " in code or "for " in code or "class " in code
    assert "def " not in chat
    pb = prompt_batch(512, 5, kind="code", seed=3)
    assert (pb["lengths"] >= 16).all()


# ------------------------------------------------- against the reference

@pytest.mark.parametrize("kw", [
    dict(vocab_size=512, batch=4, seq_len=32, kind="chat", seed=1),
    dict(vocab_size=151936, batch=3, seq_len=300, kind="code", seed=0),
    dict(vocab_size=512, batch=2, seq_len=16, kind="code", seed=2,
         host_id=1, num_hosts=2),
])
def test_packed_batches_bit_equal_to_reference(kw):
    """Five consecutive batches: tokens, labels and mask bit for bit, in
    the reference's dtypes."""
    it, jit_ = packed_batches(**kw), jax_packed_batches(**kw)
    for _ in range(5):
        a, b = next(it), next(jit_)
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k])


def test_optimizer_pieces_match_reference():
    """The schedule at every step 0..120 (fp32, 5e-7 relative: a few ulps
    of torch's and XLA's cos), the clip
    (1e-6) and one AdamW update on the same params, grads and nonzero
    moments (1e-6 relative on params and moments) equal the reference's."""
    cfg = dict(learning_rate=2e-3, warmup_steps=10, total_steps=100)
    for s in range(121):
        np.testing.assert_allclose(
            float(cosine_schedule(torch.tensor(s, dtype=torch.int32),
                                  TrainConfig(**cfg))),
            float(jopt.cosine_schedule(jnp.asarray(s, jnp.int32),
                                       JaxTrainConfig(**cfg))), rtol=5e-7)
    rng = np.random.default_rng(0)
    arrs = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in (("a", (3, 4)), ("b", (5,)))}
    grads = {k: (3 * rng.standard_normal(v.shape)).astype(np.float32)
             for k, v in arrs.items()}
    mu = {k: 0.1 * rng.standard_normal(v.shape).astype(np.float32)
          for k, v in arrs.items()}
    nu = {k: np.abs(0.1 * rng.standard_normal(v.shape)).astype(np.float32)
          for k, v in arrs.items()}
    t = lambda tree: {k: torch.from_numpy(v.copy()) for k, v in tree.items()}
    j = lambda tree: {k: jnp.asarray(v) for k, v in tree.items()}
    tc, jc = clip_by_global_norm(t(grads), 1.0), jopt.clip_by_global_norm(
        j(grads), 1.0)
    np.testing.assert_allclose(float(tc[1]), float(jc[1]), rtol=1e-6)
    for k in arrs:
        np.testing.assert_allclose(to_np(tc[0][k]), np.asarray(jc[0][k]),
                                   rtol=1e-6, atol=1e-7)
    cfg = dict(learning_rate=1e-2, warmup_steps=2, total_steps=20)
    tp, tstate, tm = adamw_update(
        t(arrs), t(grads), init_adam(t(arrs))._replace(
            step=torch.tensor(4, dtype=torch.int32), mu=t(mu), nu=t(nu)),
        TrainConfig(**cfg))
    jp, jstate, jm = jopt.adamw_update(
        j(arrs), j(grads), jopt.AdamState(jnp.asarray(4, jnp.int32), j(mu),
                                          j(nu)), JaxTrainConfig(**cfg))
    assert int(tstate.step) == int(jstate.step) == 5
    np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=5e-7)
    for k in arrs:
        for a, b in ((tp[k], jp[k]), (tstate.mu[k], jstate.mu[k]),
                     (tstate.nu[k], jstate.nu[k])):
            np.testing.assert_allclose(to_np(a), np.asarray(b), rtol=1e-6,
                                       atol=1e-8)


CHUNK_CASES = {
    # the reference test: window 8, softcap 4, chunks of 8
    "window_cap": dict(B=1, T=32, Hq=2, Hkv=1, D=8, window=8, cap=4.0,
                       chunk=8, causal=True, invalid=0),
    # GQA, a ragged last chunk, no window or cap
    "ragged": dict(B=2, T=40, Hq=4, Hkv=2, D=8, window=0, cap=0.0,
                   chunk=12, causal=True, invalid=0),
    # bidirectional (the encoder), softcap, invalid key slots (k_pos -1)
    "bidir_invalid": dict(B=2, T=24, Hq=2, Hkv=2, D=4, window=0, cap=3.0,
                          chunk=7, causal=False, invalid=5),
}


@pytest.mark.parametrize("case", sorted(CHUNK_CASES))
def test_chunked_gradients_match_naive(case):
    """Gradients of sum(tanh(attention)) w.r.t. q, k, v: the port's
    recompute backward equals autograd through the port's naive attention
    and the reference's custom_vjp, rtol=atol=1e-4 (the reference test's);
    the forward equals both to 1e-5."""
    c = CHUNK_CASES[case]
    B, T = c["B"], c["T"]
    rng = np.random.default_rng(1)
    arrs = [rng.standard_normal((B, T, h, c["D"])).astype(np.float32)
            for h in (c["Hq"], c["Hkv"], c["Hkv"])]
    pos = np.broadcast_to(np.arange(T)[None], (B, T)).astype(np.int32)
    kpos = pos.copy()
    if c["invalid"]:
        kpos[:, -c["invalid"]:] = -1
    kw = dict(scale=0.3, window=c["window"], logit_cap=c["cap"],
              chunk=c["chunk"], causal=c["causal"])

    def port(fn):
        q, k, v = (torch.from_numpy(a.copy()).requires_grad_() for a in arrs)
        out = fn(q, k, v, torch.from_numpy(pos), torch.from_numpy(kpos))
        torch.tanh(out).sum().backward()
        return out.detach(), [t.grad for t in (q, k, v)]

    def naive(q, k, v, qp, kp):
        mask = (_causal_mask(qp, kp, c["window"]) if c["causal"] else
                (kp[:, None, :] >= 0)[:, None].expand(B, 1, T, T))
        return _sdpa(q, k, v, mask, 0.3, c["cap"])

    out_c, g_c = port(lambda *a: chunked_sdpa(*a, **kw))
    out_n, g_n = port(naive)

    def jax_loss(q, k, v):
        return jnp.sum(jnp.tanh(jax_chunked_sdpa(q, k, v, jnp.asarray(pos),
                                                 jnp.asarray(kpos), **kw)))

    g_j = jax.grad(jax_loss, argnums=(0, 1, 2))(*map(jnp.asarray, arrs))
    np.testing.assert_allclose(to_np(out_c), to_np(out_n), rtol=1e-5,
                               atol=1e-5)
    for a, b, r in zip(g_c, g_n, g_j):
        np.testing.assert_allclose(to_np(a), to_np(b), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(to_np(a), np.asarray(r), rtol=1e-4,
                                   atol=1e-4)


def test_attend_takes_the_chunked_backward_at_long_prefill(monkeypatch):
    """A sliding-window, softcapped GQA prefill of T 1536 (T*S > 2,097,152:
    attend's chunked branch) runs the recompute backward once, and its
    input gradient equals the one through the naive attention put in the
    branch's place, 1e-4."""
    from repro_torch.models import attention as attn
    cfg = port_config(ModelConfig(
        "t-long", "dense", 1, 32, 2, 1, 64, 300, head_dim=16,
        layer_pattern=("swa",), sliding_window=700, attn_logit_softcap=20.0,
        dtype="float32"))
    p = attn.init_gqa(cfg, torch.float32, generator=_gen(), device=CPU)
    T = 1536
    x0 = torch.randn((1, T, 32), generator=_gen(2))
    pos = torch.arange(T)[None]

    def grad_of():
        x = x0.clone().requires_grad_()
        out, _ = attn.gqa_forward(p, cfg, x, pos, kind="swa")
        torch.tanh(out).sum().backward()
        return x.grad

    calls = []
    apply = attn._ChunkedSDPA.apply
    monkeypatch.setattr(attn._ChunkedSDPA, "apply",
                        lambda *a: calls.append(1) or apply(*a))
    g_chunked = grad_of()
    assert calls == [1]
    monkeypatch.setattr(
        attn, "chunked_sdpa",
        lambda q, k, v, qp, kp, *, scale, window, logit_cap, causal: _sdpa(
            q, k, v, _causal_mask(qp, kp, window), scale, logit_cap))
    g_naive = grad_of()
    np.testing.assert_allclose(to_np(g_chunked), to_np(g_naive), rtol=1e-4,
                               atol=1e-4)


def test_remat_gives_the_same_loss_and_gradients(monkeypatch):
    """Model(remat=True) runs each layer under a checkpoint (counted): the
    same loss and gradients as remat=False (1e-6).  Without grad (serving)
    it checkpoints nothing."""
    from repro_torch.models import transformer as tfm
    _, _, _, tp = model_pair(CFG)
    toks = np.random.default_rng(0).integers(0, 512, (2, 32))
    layers = []
    ckpt = tfm.checkpoint
    monkeypatch.setattr(tfm, "checkpoint",
                        lambda *a, **kw: layers.append(1) or ckpt(*a, **kw))
    grads = []
    for remat in (False, True):
        m = Model(TCFG, remat=remat, device="cpu")
        live = [p.detach().requires_grad_() for p in tree_leaves(tp)]
        it = iter(live)
        tree = tree_map(lambda _: next(it), tp)
        h, met = m.forward_hidden(tree, toks)
        loss = lm_loss(m._head(tree, h), torch.from_numpy(toks)) \
            + met["aux_loss"]
        grads.append((float(loss.detach()),
                      torch.autograd.grad(loss, live)))
        assert len(layers) == (CFG.num_layers if remat else 0)
    assert abs(grads[0][0] - grads[1][0]) < 1e-6
    for a, b in zip(grads[0][1], grads[1][1]):
        np.testing.assert_allclose(to_np(a), to_np(b), rtol=1e-6, atol=1e-7)
    m.forward_hidden(tp, toks)
    assert len(layers) == CFG.num_layers


def test_train_step_matches_reference():
    """tr-moe, B 2, T 64 of packed code batches."""
    batch = next(jax_packed_batches(CFG.vocab_size, 2, 64, kind="code"))
    assert_step_matches(CFG, batch, dict(learning_rate=3e-3,
                                          warmup_steps=1, total_steps=30))


# --------------------------------------------------- kernels under autograd

def _wrapper_calls():
    g = _gen(0)
    r = lambda *s: torch.randn(s, generator=g)
    sizes = torch.tensor([3, 1], dtype=torch.int32)
    lengths = torch.tensor([4], dtype=torch.int32)
    table = torch.tensor([[0, 1]], dtype=torch.int32)
    return {
        "ragged_gmm": lambda req: ragged_gmm(r(4, 8).requires_grad_(req),
                                             r(2, 8, 16), sizes),
        "fused_gate_up": lambda req: fused_gate_up(
            r(4, 8), r(2, 8, 16).requires_grad_(req), r(2, 8, 16), sizes),
        "ragged_moe_ffn": lambda req: ragged_moe_ffn(
            r(4, 8), r(2, 8, 16), r(2, 8, 16),
            r(2, 16, 8).requires_grad_(req), sizes),
        "gmm_capacity": lambda req: gmm_capacity(
            r(2, 4, 8).requires_grad_(req), r(2, 8, 16)),
        "flash_attention": lambda req: flash_attention(
            r(1, 128, 2, 16).requires_grad_(req), r(1, 128, 1, 16),
            r(1, 128, 1, 16)),
        "decode_attention": lambda req: decode_attention(
            r(1, 2, 2, 16), r(1, 8, 1, 16).requires_grad_(req),
            r(1, 8, 1, 16), lengths),
        "paged_decode_attention": lambda req: paged_decode_attention(
            r(1, 2, 2, 16), r(3, 4, 1, 16), r(3, 4, 1, 16).requires_grad_(req),
            lengths, table),
    }


@pytest.mark.parametrize("name", sorted(_wrapper_calls()))
def test_kernel_wrappers_refuse_autograd(name):
    """With grad on and an input requiring grad each wrapper raises,
    naming the reference's refusal and the way to train; under no_grad the
    same call runs (serving), and without grad-requiring inputs too."""
    call = _wrapper_calls()[name]
    with pytest.raises(RuntimeError, match="onehot.*use_flash"):
        call(True)
    with torch.no_grad():
        assert torch.isfinite(call(True)).all()
    assert torch.isfinite(call(False)).all()


@pytest.mark.parametrize("route", ["gmm", "use_flash"])
def test_models_on_kernel_routes_refuse_to_train(route):
    """Gradients through Model(moe_dispatch="gmm") or Model(use_flash=True)
    raise in both packages (the reference: NotImplementedError /
    AssertionError from its Pallas kernels; the port: RuntimeError from
    the wrapper); the same forward under no_grad runs."""
    kw = ({"moe_dispatch": "gmm"} if route == "gmm" else {"use_flash": True})
    toks = np.random.default_rng(0).integers(0, 512, (1, 128))
    jm = JaxModel(CFG, **kw)
    jp = jm.init(jax.random.PRNGKey(0))

    def jloss(p):
        h, _ = jm.forward_hidden(p, jnp.asarray(toks))
        return jnp.sum(h)

    with pytest.raises((NotImplementedError, AssertionError)):
        jax.grad(jloss)(jp)
    tm = Model(TCFG, device="cpu", **kw)
    tp = params_from_jax(jax.device_get(jp), TCFG, CPU)
    leaves = tree_leaves(tp)
    for p in leaves:
        p.requires_grad_()
    with pytest.raises(RuntimeError, match="the kernels have no backward"):
        tm.forward_hidden(tp, toks)
    with torch.no_grad():
        h, _ = tm.forward_hidden(tp, toks)
    assert torch.isfinite(h).all()


# ----------------------------------------------------------------- launcher

def test_launcher_on_cpu_and_its_checkpoint(capsys):
    """``launch/train.py`` on a reduced config: the reference's log lines,
    finite falling losses, and a checkpoint that restores bit for bit."""
    with tempfile.TemporaryDirectory() as d:
        res = train_cli.main(["--arch", "qwen2-57b-a14b", "--reduced",
                              "--steps", "6", "--batch", "2", "--seq", "32",
                              "--log-every", "3", "--ckpt-dir", d,
                              "--device", "cpu"])
        out = capsys.readouterr().out
        assert out.startswith("arch=qwen2-57b-a14b")
        assert sum(l.startswith("step ") for l in out.splitlines()) == 3
        assert np.isfinite(res["losses"]).all()
        assert res["losses"][-1] < res["losses"][0]
        restored, manifest = restore_checkpoint(
            latest_checkpoint(d), {"params": res["params"], "opt": res["opt"]})
        assert manifest["step"] == 6
        for (k, a), (_, b) in zip(
                tree_items(restored),
                tree_items({"params": res["params"], "opt": res["opt"]})):
            assert torch.equal(a, b), k


def test_launcher_defaults_to_the_card():
    """Without --device the launcher asks for cuda and stops without one."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--arch", "qwen2-0.5b", "--reduced", "--steps", "1"])
