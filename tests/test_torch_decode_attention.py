"""Port's dense decode/verify attention (plain path on the CPU) vs the
reference.

Kernel level: the port's plain version (what the wrapper runs for CPU
tensors, and what the CUDA kernel is held against on the card) equals the
reference's Pallas kernel in interpret mode and its jnp oracle, mirroring
tests/test_kernels.py::test_decode_attention_sweep (3e-5) and
test_decode_attention_bf16 (4e-2), plus the serve models' grouping g = 7.
Layer level: ``gqa_forward`` extends with ``use_flash`` against the
reference's, on a cache of logical capacity 512 with one row whose
positions pass it: the reference drops those writes, the port sends them to
its trash slot, and the kernel path reads neither.  fp32, TF32 off.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import both, port_config, to_np
from repro.configs.registry import get_config
from repro.kernels.decode_attention import decode_attention as jdec
from repro.kernels.decode_attention import ops as jops
from repro.kernels.decode_attention import ref as jref
from repro.models import attention as jattn
from repro_torch.kernels.decode_attention import ops as tops
from repro_torch.kernels.decode_attention import ref as tref
from repro_torch.models import attention as tattn

TOL = {"float32": 3e-5, "bfloat16": 4e-2}


def _case(B, Hq, Hkv, T, S, D, seed, dtype):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hq, T, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    return both(q, dtype), both(k, dtype), both(v, dtype)


def _close(a, b, tol):
    np.testing.assert_allclose(to_np(a), to_np(b), rtol=tol, atol=tol)


@pytest.mark.parametrize("T", [1, 4, 5])
@pytest.mark.parametrize("g", [1, 2, 4, 7])
def test_decode_attention_sweep_matches_reference(T, g):
    B, Hkv, S, D = 3, 2, 1024, 64
    (jq, tq), (jk, tk), (jv, tv) = _case(B, Hkv * g, Hkv, T, S, D, 10 * g + T,
                                         "float32")
    jl, tl = both(np.array([17, 512, 1024 - T], np.int32))
    ref = jdec.decode_attention_bhtd(jq, jk, jv, jl, interpret=True)
    _close(tref.decode_attention_ref(tq, tk, tv, tl), ref, TOL["float32"])
    _close(tref.decode_attention_ref(tq, tk, tv, tl),
           jref.decode_attention_ref(jq, jk, jv, jl), TOL["float32"])
    # the (B, T, H, D) wrapper the model calls, on transposed views
    out = tops.decode_attention(tq.transpose(1, 2), tk.transpose(1, 2),
                                tv.transpose(1, 2), tl)
    assert out.shape == (B, T, Hkv * g, D)
    _close(out, jops.decode_attention(jq.transpose(0, 2, 1, 3),
                                      jk.transpose(0, 2, 1, 3),
                                      jv.transpose(0, 2, 1, 3), jl,
                                      interpret=True), TOL["float32"])


def test_decode_attention_bf16_matches_reference():
    B, Hq, Hkv, T, S, D = 2, 4, 2, 3, 512, 128
    (jq, tq), (jk, tk), (jv, tv) = _case(B, Hq, Hkv, T, S, D, 1, "bfloat16")
    jl, tl = both(np.array([100, 509], np.int32))
    out = tref.decode_attention_ref(tq, tk, tv, tl)
    assert out.dtype == torch.bfloat16
    _close(out, jdec.decode_attention_bhtd(jq, jk, jv, jl, interpret=True),
           TOL["bfloat16"])


def _attn_params(cfg, seed):
    rng = np.random.default_rng(seed)
    d, hd = cfg.d_model, cfg.head_dim
    shapes = {"wq": (d, cfg.num_heads * hd), "wk": (d, cfg.num_kv_heads * hd),
              "wv": (d, cfg.num_kv_heads * hd), "wo": (cfg.num_heads * hd, d)}
    if cfg.qkv_bias:
        shapes.update(bq=(cfg.num_heads * hd,), bk=(cfg.num_kv_heads * hd,),
                      bv=(cfg.num_kv_heads * hd,))
    arrs = {n: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
            for n, s in shapes.items()}
    return ({n: jnp.asarray(a) for n, a in arrs.items()},
            {n: torch.from_numpy(a) for n, a in arrs.items()})


@pytest.mark.parametrize("T", [1, 5])
def test_gqa_extend_with_use_flash_matches_reference(T):
    """A verify (T 5) and a decode (T 1) extend through the dense kernel
    branch (S = 512, no cap).  Row 2 sits at 510: its positions 512.. pass
    the cache; the port's trash slot holds noise, which must not show."""
    cfg = get_config("qwen2-57b-a14b", reduced=True)
    tcfg = port_config(cfg)
    jp, tp = _attn_params(cfg, 0)
    B, S, Hkv, D = 3, 512, cfg.num_kv_heads, cfg.head_dim
    rng = np.random.default_rng(1)
    kc = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    vc = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    trash = rng.standard_normal((B, 1, Hkv, D)).astype(np.float32) * 1e3
    jcache = {"k": jnp.asarray(kc), "v": jnp.asarray(vc)}
    tcache = {"k": torch.from_numpy(np.concatenate([kc, trash], 1)),
              "v": torch.from_numpy(np.concatenate([vc, -trash], 1))}
    x = rng.standard_normal((B, T, cfg.d_model)).astype(np.float32)
    lengths = np.array([37, 300, 510], np.int64)
    pos = lengths[:, None] + np.arange(T)[None, :]
    jout, jc = jattn.gqa_forward(jp, cfg, jnp.asarray(x), jnp.asarray(pos),
                                 cache=jcache, mode="extend", use_flash=True)
    calls = []
    real = tattn.decode_attention

    def spy(*a, **kw):
        calls.append(a[1].shape)
        return real(*a, **kw)

    tattn.decode_attention = spy
    try:
        tout, tc = tattn.gqa_forward(tp, tcfg, torch.from_numpy(x),
                                     torch.from_numpy(pos), cache=tcache,
                                     mode="extend", use_flash=True)
    finally:
        tattn.decode_attention = real
    assert calls == [(B, S, Hkv, D)]          # the kernel branch, trash excluded
    _close(tout, jout, 1e-4)
    # the written K/V (K after RoPE, computed in another order: 1e-5)
    _close(tc["k"][:, :S], jc["k"], 1e-5)
    _close(tc["v"][:, :S], jc["v"], 1e-5)


def test_gqa_extend_below_512_or_capped_takes_the_plain_branch():
    """The reference's dense kernel branch needs S >= 512 and no logit cap;
    below it the port attends as without ``use_flash``."""
    cfg = get_config("qwen2-57b-a14b", reduced=True)
    _, tp = _attn_params(cfg, 0)
    B, Hkv, D = 2, cfg.num_kv_heads, cfg.head_dim
    called = []
    real = tattn.decode_attention
    tattn.decode_attention = lambda *a, **kw: called.append(1) or real(*a, **kw)
    try:
        for S, cap in ((256, 0.0), (512, 30.0)):
            c = port_config(cfg)
            c = c.with_overrides(attn_logit_softcap=cap)
            cache = {"k": torch.zeros((B, S + 1, Hkv, D)),
                     "v": torch.zeros((B, S + 1, Hkv, D))}
            x = torch.randn((B, 2, cfg.d_model))
            pos = torch.tensor([[3, 4], [7, 8]])
            a, _ = tattn.gqa_forward(tp, c, x, pos, cache=dict(cache),
                                     mode="extend", use_flash=True)
            cache = {n: t.clone() for n, t in cache.items()}
            b, _ = tattn.gqa_forward(tp, c, x, pos, cache=cache,
                                     mode="extend", use_flash=False)
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    finally:
        tattn.decode_attention = real
    assert called == []
