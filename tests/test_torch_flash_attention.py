"""Port's flash attention (plain path on the CPU) vs the reference.

The port's plain version is what the wrapper runs for CPU tensors and what
the CUDA kernel is held against on the card.  It is compared with the
reference's Pallas kernel in interpret mode, as the reference's own tests
run it (tests/test_kernels.py::test_flash_attention_sweep and
test_flash_non_causal), and with the reference's jnp oracle.  Tolerances
are the reference's: 2e-5 in fp32, 3e-2 in bf16 (rtol and atol).

The bf16 kernel's persistent schedule (mirrored on the host by
``flash_attention.schedule``) runs each (query tile, head, sequence) item
exactly once, heaviest first within each block, and no block carries more
causal chunks than the mean plus one item's, at head dims up to 128 and at
256 (gemma), which takes 128-query items at every T.  Head dim 256 is
also held against the reference (the plain version the card's body is held
against)."""
import numpy as np
import pytest
import torch

from _torch_parity import both, to_np
from repro.kernels.flash_attention import flash_attention as jflash
from repro.kernels.flash_attention import ops as jops
from repro.kernels.flash_attention import ref as jref
from repro_torch.kernels.flash_attention import flash_attention as tflash
from repro_torch.kernels.flash_attention import ops as tops

TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _qkv(shape_q, shape_kv, seed, dtype):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal(shape_q).astype(np.float32)
    k = rng.standard_normal(shape_kv).astype(np.float32)
    v = rng.standard_normal(shape_kv).astype(np.float32)
    return both(q, dtype), both(k, dtype), both(v, dtype)


def _close(a, b, tol):
    np.testing.assert_allclose(to_np(a), to_np(b), rtol=tol, atol=tol)


@pytest.mark.parametrize("T,window,cap", [(256, 0, 0.0), (256, 100, 0.0),
                                          (512, 0, 30.0), (128, 64, 20.0)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_sweep_matches_reference(T, window, cap, dtype):
    B, Hq, Hkv, D = 2, 4, 2, 64
    (jq, tq), (jk, tk), (jv, tv) = _qkv((B, Hq, T, D), (B, Hkv, T, D), T, dtype)
    out = tflash.flash_attention_bhtd(tq, tk, tv, causal=True, window=window,
                                      logit_cap=cap)
    assert out.dtype == tq.dtype and out.shape == (B, Hq, T, D)
    _close(out, jflash.flash_attention_bhtd(jq, jk, jv, causal=True,
                                            window=window, logit_cap=cap,
                                            interpret=True), TOL[dtype])
    _close(out, jref.flash_attention_ref(jq, jk, jv, causal=True,
                                         window=window, logit_cap=cap),
           TOL[dtype])


@pytest.mark.parametrize("T,window,cap", [(256, 0, 0.0), (256, 100, 0.0),
                                          (128, 64, 30.0)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_head_dim_256_matches_reference(T, window, cap, dtype):
    """Head dim 256 (gemma-7b, gemma3-12b; the TMA + wgmma body on the
    card) at a 2:1 grouping like gemma3's 16/8, with a window that crosses
    key blocks and a tanh cap: the plain version ≡ the reference's
    interpret-mode kernel ≡ its oracle."""
    B, Hq, Hkv, D = 1, 2, 1, 256
    (jq, tq), (jk, tk), (jv, tv) = _qkv((B, Hq, T, D), (B, Hkv, T, D),
                                        T + window + 256, dtype)
    out = tflash.flash_attention_bhtd(tq, tk, tv, causal=True, window=window,
                                      logit_cap=cap)
    assert out.dtype == tq.dtype and out.shape == (B, Hq, T, D)
    _close(out, jflash.flash_attention_bhtd(jq, jk, jv, causal=True,
                                            window=window, logit_cap=cap,
                                            interpret=True), TOL[dtype])
    _close(out, jref.flash_attention_ref(jq, jk, jv, causal=True,
                                         window=window, logit_cap=cap),
           TOL[dtype])


def test_flash_non_causal_matches_reference():
    B, H, T, D = 1, 2, 256, 32
    (jq, tq), (jk, tk), (jv, tv) = _qkv((B, H, T, D), (B, H, T, D), 3,
                                        "float32")
    out = tflash.flash_attention_bhtd(tq, tk, tv, causal=False)
    _close(out, jflash.flash_attention_bhtd(jq, jk, jv, causal=False,
                                            interpret=True), TOL["float32"])
    _close(out, jref.flash_attention_ref(jq, jk, jv, causal=False),
           TOL["float32"])


def test_flash_gqa_seven_heads_per_kv_head_in_model_layout():
    """The serve target's grouping (g = 7, head dim 128) through the
    (B, T, H, D) wrapper the model calls."""
    B, T, Hq, Hkv, D = 1, 128, 7, 1, 128
    (jq, tq), (jk, tk), (jv, tv) = _qkv((B, T, Hq, D), (B, T, Hkv, D), 7,
                                        "float32")
    out = tops.flash_attention(tq, tk, tv, causal=True)
    assert out.shape == (B, T, Hq, D)
    _close(out, jops.flash_attention(jq, jk, jv, causal=True, interpret=True),
           TOL["float32"])


@pytest.mark.parametrize("T,S", [(192, 192), (128, 160), (64, 96)])
def test_flash_refuses_what_the_reference_asserts(T, S):
    """The reference asserts T % min(128, T) == 0 and S % min(128, S) == 0;
    the port raises a ValueError for the same calls (both layouts), and
    accepts the shapes the reference accepts."""
    q = torch.zeros((1, 2, T, 32))
    kv = torch.zeros((1, 2, S, 32))
    refused = T % min(128, T) or S % min(128, S)
    if refused:
        with pytest.raises(AssertionError):
            jflash.flash_attention_bhtd(q.numpy(), kv.numpy(), kv.numpy(),
                                        causal=False, interpret=True)
        with pytest.raises(ValueError, match="multiples"):
            tflash.flash_attention_bhtd(q, kv, kv, causal=False)
        with pytest.raises(ValueError, match="multiples"):
            tops.flash_attention(q.transpose(1, 2), kv.transpose(1, 2),
                                 kv.transpose(1, 2), causal=False)
    else:
        out = tflash.flash_attention_bhtd(q, kv, kv, causal=False)
        assert out.shape == q.shape


def _schedule_case(T, B, Hq, sms, head_dim=128):
    """A case keeps the id it had before head dims were a parameter; head
    dim 256 (128-query items at every T) adds "-d256"."""
    return pytest.param(T, B, Hq, sms, head_dim, id=f"{T}-{B}-{Hq}-{sms}" + (
        "-d256" if head_dim == 256 else ""))


@pytest.mark.parametrize("T,B,Hq,sms,head_dim", [
    _schedule_case(256, 8, 28, 132), _schedule_case(256, 8, 14, 132),
    _schedule_case(4096, 1, 28, 132), _schedule_case(512, 2, 28, 132),
    _schedule_case(128, 1, 2, 132), _schedule_case(384, 3, 7, 16),
    _schedule_case(1024, 2, 28, 132),
    # head dim 256 at gemma3-12b's 16 query heads: the short prefill (B 8,
    # T 256), wave-gemma3's bucket (B 2, T 2048), one tile; and 16 SMs
    _schedule_case(256, 8, 16, 132, 256),
    _schedule_case(2048, 2, 16, 132, 256),
    _schedule_case(64, 2, 16, 132, 256), _schedule_case(384, 3, 7, 16, 256)])
def test_flash_persistent_schedule_runs_each_item_once_heaviest_first(
        T, B, Hq, sms, head_dim):
    blocks = tflash.schedule(T, B, Hq, sms, head_dim)
    # 64-query items, two blocks an SM, up to NARROW_MAX_T below head dim
    # 256; else 128-query items, one block an SM
    narrow = T <= tflash.NARROW_MAX_T and head_dim < 256
    assert tflash.consumers(T, head_dim) == (1 if narrow else 2)
    n_qt = -(-T // (64 if narrow else 128))
    items = [it for blk in blocks for it in blk]
    assert len(blocks) == min(n_qt * B * Hq, (2 if narrow else 1) * sms)
    assert sorted(items) == sorted((qt, h, b) for qt in range(n_qt)
                                   for h in range(Hq) for b in range(B))
    for blk in blocks:
        assert [qt for qt, _, _ in blk] == sorted(
            (qt for qt, _, _ in blk), reverse=True)
    # causal: query tile qt reads qt + 1 chunks (as many keys as rows)
    loads = [sum(qt + 1 for qt, _, _ in blk) for blk in blocks]
    assert max(loads) <= sum(loads) / len(loads) + n_qt


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "sm90"),
                                         (torch.float32, "f32")])
def test_flash_route_by_dtype(dtype, route):
    """The launcher runs the TMA + wgmma body for bf16 and the CUDA-core
    fp32 body for fp32 at every head dim; the wrapper names them by the
    launcher's codes (0 and 1)."""
    assert tflash._ROUTES[tflash.attention_launch.DTYPES[dtype]] == route
