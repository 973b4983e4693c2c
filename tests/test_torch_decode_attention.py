"""Port's dense decode/verify attention (plain path on the CPU) vs the
reference.

Kernel level: the port's plain version (what the wrapper runs for CPU
tensors, and what the CUDA kernel is held against on the card) equals the
reference's Pallas kernel in interpret mode and its jnp oracle, mirroring
tests/test_kernels.py::test_decode_attention_sweep (3e-5) and
test_decode_attention_bf16 (4e-2), plus the serve models' grouping g = 7.
Split-KV: the plain split version (per-range partials merged as the card's
combine kernel merges them) equals the reference's kernel at 1, 2 and 5
splits (3e-5), and the Python mirror of the host split planner covers every
key of every row exactly once and leaves a split that starts past a row's
last key empty.
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


@pytest.mark.parametrize("T", [1, 5])
@pytest.mark.parametrize("splits", [1, 2, 5])
def test_split_plain_matches_reference(splits, T):
    """S 640 (10 chunks of 64) cut into 1, 2 and 5 ranges: a row whose keys
    fit the first range, one that spans several, and one whose last query
    sits at S - 1 (the reference pads S to its 512-key block with zero keys,
    which a query past S would see); fp32 at the reference's 3e-5."""
    B, Hkv, g, S, D = 3, 2, 4, 640, 64
    (jq, tq), (jk, tk), (jv, tv) = _case(B, Hkv * g, Hkv, T, S, D,
                                         100 * splits + T, "float32")
    jl, tl = both(np.array([20, 333, S - T], np.int32))
    ref = jdec.decode_attention_bhtd(jq, jk, jv, jl, interpret=True)
    out = tref.decode_attention_split_plain(
        tq.transpose(1, 2), tk.transpose(1, 2), tv.transpose(1, 2), tl,
        splits=splits)
    _close(out.transpose(1, 2), ref, TOL["float32"])


@pytest.mark.parametrize("B,Hkv,S,sms,min_chunks", [
    (8, 4, 512, 132, tref.DENSE_MIN_CHUNKS),     # target verify: one split
    (8, 4, 8192, 132, tref.DENSE_MIN_CHUNKS),    # long context: 4 splits
    (8, 2, 512, 132, tref.DENSE_MIN_CHUNKS),     # the draft's heads
    (1, 1, 8192, 132, tref.DENSE_MIN_CHUNKS),    # one pair: 16 splits
    (8, 4, 8256, 132, tref.PAGED_MIN_CHUNKS),    # the paged long context
    (3, 2, 1000, 132, 2),                        # a ragged last chunk
    (2, 2, 64, 132, tref.DENSE_MIN_CHUNKS)])     # one chunk
def test_split_planner_covers_every_key_once(B, Hkv, S, sms, min_chunks):
    cps, splits = tref.split_plan(B, Hkv, S, sms, min_chunks=min_chunks)
    n_chunks = -(-S // tref.CHUNK)
    assert (splits - 1) * cps < n_chunks <= splits * cps
    assert splits == 1 or (cps >= min_chunks
                           and splits <= sms // (B * Hkv))
    for T in (1, 5):
        for length in sorted({0, 1, 63, 64, S // 3, S // 2, S - T, S - 1}):
            if length < 0:
                continue
            last = min(length + T - 1, S - 1)
            seen = np.zeros(S + tref.CHUNK, np.int64)
            for k0, n in tref.split_chunks(length, T, S, cps, splits):
                if k0 > last:
                    assert n == 0           # its block returns at once
                    continue
                assert n >= 1
                seen[k0:k0 + n * tref.CHUNK] += 1
                # only the row's last chunk reaches past its last key
                assert k0 + (n - 1) * tref.CHUNK <= last
            assert (seen[:last + 1] == 1).all()
            assert (seen[last + tref.CHUNK:] == 0).all()


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


@pytest.mark.parametrize("cap", [0.0, 30.0])
@pytest.mark.parametrize("blocks", [2, 4])
@pytest.mark.parametrize("T", [1, 5])
def test_partial_blocks_merge_into_the_whole_call(T, blocks, cap):
    """Kernel 4's partial entry over a cache split along its sequence: the
    plain partials of 2 and 4 key blocks (each at its global offset), merged
    by their log-sum-exp (``collectives.lse_combine``), equal the whole
    plain call and the reference's Pallas kernel (3e-5).  Row 0 sits at
    position 17, so every block past the first holds no key it sees (lse
    -inf, output 0) and merges in as nothing."""
    from repro_torch.distributed.collectives import lse_combine
    B, Hkv, g, S, D = 3, 2, 4, 512, 64
    (jq, tq), (jk, tk), (jv, tv) = _case(B, Hkv * g, Hkv, T, S, D,
                                         100 + T + blocks, "float32")
    jl, tl = both(np.array([17, 300, S - T], np.int32))
    q, k, v = (x.transpose(1, 2) for x in (tq, tk, tv))
    whole = tref.decode_attention_plain(q, k, v, tl, logit_cap=cap)
    n = S // blocks
    parts = [tops.decode_attention_partial(q, k[:, i * n:(i + 1) * n],
                                           v[:, i * n:(i + 1) * n], tl,
                                           k_lo=i * n, logit_cap=cap)
             for i in range(blocks)]
    outs = torch.stack([o for o, _ in parts])
    lses = torch.stack([l for _, l in parts])
    assert torch.isinf(lses[1:, 0]).all() and not outs[1:, 0].any()
    assert torch.isfinite(lses[0]).all()
    merged = lse_combine(outs, lses)
    _close(merged, whole, TOL["float32"])
    if cap == 0.0:
        ref = jdec.decode_attention_bhtd(jq, jk, jv, jl, interpret=True)
        _close(merged.transpose(1, 2), ref, TOL["float32"])


def test_partial_row_that_sees_no_key_merges_to_zero():
    """A row no block shows a key (every block past its position): each
    partial is 0 with lse -inf, and the merge is 0, not NaN."""
    from repro_torch.distributed.collectives import lse_combine
    B, Hkv, T, S, D = 1, 1, 1, 128, 32
    (_, tq), (_, tk), (_, tv) = _case(B, 2, Hkv, T, S, D, 7, "float32")
    q, k, v = (x.transpose(1, 2) for x in (tq, tk, tv))
    parts = [tops.decode_attention_partial(q, k[:, i * 64:(i + 1) * 64],
                                           v[:, i * 64:(i + 1) * 64],
                                           torch.tensor([-1], dtype=torch.int32),
                                           k_lo=i * 64) for i in range(2)]
    outs = torch.stack([o for o, _ in parts])
    lses = torch.stack([l for _, l in parts])
    assert torch.isneginf(lses).all()
    merged = lse_combine(outs, lses)
    assert torch.equal(merged, torch.zeros_like(merged))
