"""Port's flash attention (plain path on the CPU) vs the reference.

The port's plain version is what the wrapper runs for CPU tensors and what
the CUDA kernel is held against on the card.  It is compared with the
reference's Pallas kernel in interpret mode, as the reference's own tests
run it (tests/test_kernels.py::test_flash_attention_sweep and
test_flash_non_causal), and with the reference's jnp oracle.  Tolerances
are the reference's: 2e-5 in fp32, 3e-2 in bf16 (rtol and atol)."""
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
