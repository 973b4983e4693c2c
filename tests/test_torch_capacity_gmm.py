"""Port's capacity-binned grouped matmul and the MoE FFN built on it (plain
path on the CPU) vs the reference.

The reference runs its Pallas kernel in interpret mode, as its own tests do
(tests/test_kernels.py, tests/test_ragged_gmm.py), and its jnp oracles.
Inputs are made with numpy from a seed.  Tolerances are the reference's:
1e-5 (fp32) and 2e-2 (bf16) for the kernel, 1e-4 for the whole FFN,
2e-4 for ``gmm_legacy`` against the ragged path."""
import numpy as np
import pytest
import torch

from _torch_parity import both, to_np
from repro.kernels.gmm import gmm as jgmm
from repro.kernels.gmm import ops as jops
from repro.kernels.gmm import ref as jref
from repro_torch.kernels.gmm import gmm as tgmm
from repro_torch.kernels.gmm import ops as tops
from repro_torch.kernels.gmm import ref as tref


def _close(a, b, tol):
    np.testing.assert_allclose(to_np(a), to_np(b), rtol=tol, atol=tol)


@pytest.mark.parametrize("E,C,D,F", [(2, 128, 256, 128), (4, 256, 512, 384),
                                     (1, 128, 1024, 256), (8, 128, 128, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gmm_capacity_matches_reference(E, C, D, F, dtype):
    """Weights scaled by 1/sqrt(D), as in the port's other gmm tests, so the
    outputs are O(1): at unit weights they reach ~|32| (D = 1024), and two
    fp32 sums taken in different orders (torch's einsum, XLA's dot) differ
    by ~1e-4 there, which the reference's 1e-5 meets only when both sides
    are XLA's."""
    rng = np.random.default_rng(E + C)
    (jx, tx) = both(rng.standard_normal((E, C, D)).astype(np.float32), dtype)
    (jw, tw) = both((rng.standard_normal((E, D, F)) / np.sqrt(D)
                     ).astype(np.float32), dtype)
    out = tgmm.gmm_capacity(tx, tw)
    assert out.dtype == tx.dtype and out.shape == (E, C, F)
    tol = 1e-5 if dtype == "float32" else 2e-2
    _close(out, jgmm.gmm_capacity(jx, jw, interpret=True), tol)
    _close(out, jref.gmm_capacity_ref(jx, jw), tol)


def _ffn_case(N, D, F, E, K, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, D)).astype(np.float32)
    wg = (rng.standard_normal((E, D, F)) / np.sqrt(D)).astype(np.float32)
    wu = (rng.standard_normal((E, D, F)) / np.sqrt(D)).astype(np.float32)
    wd = (rng.standard_normal((E, F, D)) / np.sqrt(F)).astype(np.float32)
    logits = rng.standard_normal((N, E))
    p = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    idx = np.argsort(-p, axis=-1, kind="stable")[:, :K].astype(np.int32)
    w = np.take_along_axis(p, idx, -1)
    w = (w / w.sum(-1, keepdims=True)).astype(np.float32)
    return [both(a) for a in (x, wg, wu, wd, w, idx)]


@pytest.mark.parametrize("activation", ["silu", "gelu"])
def test_moe_ffn_gmm_matches_reference_and_onehot(activation):
    """With ample capacity nothing drops: the capacity FFN equals the
    reference's and the exact one-hot FFN."""
    N, D, F, E, K = 64, 32, 48, 4, 2
    pairs = _ffn_case(N, D, F, E, K, 2)
    (jx, wg, wu, wd, w, idx) = (p[0] for p in pairs)
    (tx, tg, tu, td, tw, ti) = (p[1] for p in pairs)
    cap = tops.expert_capacity(N, K, E, capacity_factor=8.0)
    assert cap == jops.expert_capacity(N, K, E, capacity_factor=8.0)
    out, dropped = tops.moe_ffn_gmm(tx, tg, tu, td, tw, ti, capacity=cap,
                                    activation=activation,
                                    return_dropped=True)
    assert int(dropped) == 0
    _close(out, jops.moe_ffn_gmm(jx, wg, wu, wd, w, idx, capacity=cap,
                                 activation=activation, interpret=True), 1e-4)
    _close(out, jref.moe_ffn_ref(jx, wg, wu, wd, w, idx, activation), 1e-4)
    _close(tref.moe_ffn_ref(tx, tg, tu, td, tw, ti, activation),
           jref.moe_ffn_ref(jx, wg, wu, wd, w, idx, activation), 1e-4)


def test_dispatch_capacity_drops_in_slot_order():
    """Overflowing pairs are dropped deterministically in rank order, the
    bins and slots equal the reference's."""
    x = np.arange(24, dtype=np.float32).reshape(6, 4)
    idx = np.array([[0], [1], [0], [0], [0], [0]], np.int32)
    (jx, tx), (ji, ti) = both(x), both(idx)
    bins, slot, kept = tref.dispatch_ref(tx, ti, num_experts=2, capacity=4)
    jbins, jslot, jkept = jref.dispatch_ref(jx, ji, 2, 4)
    assert int(kept.sum()) == 5
    np.testing.assert_array_equal(slot.numpy(), np.asarray(jslot))
    np.testing.assert_array_equal(kept.numpy(), np.asarray(jkept))
    np.testing.assert_array_equal(bins.numpy(), np.asarray(jbins))
    np.testing.assert_array_equal(slot[:, 0].numpy(), [0, 0, 1, 2, 3, -1])


def test_moe_ffn_gmm_counts_dropped_tokens():
    """All tokens on one expert: capacity 4 drops 2 (the reference's test),
    capacity 128 drops none and equals the exact FFN; both outputs equal
    the reference's."""
    N, D, F, E = 6, 32, 48, 2
    rng = np.random.default_rng(3)
    arrs = [rng.standard_normal((N, D)),
            rng.standard_normal((E, D, F)) / np.sqrt(D),
            rng.standard_normal((E, D, F)) / np.sqrt(D),
            rng.standard_normal((E, F, D)) / np.sqrt(F),
            np.ones((N, 1))]
    pairs = [both(a.astype(np.float32)) for a in arrs] \
        + [both(np.zeros((N, 1), np.int32))]
    j, t = [p[0] for p in pairs], [p[1] for p in pairs]
    for cap, n_drop in ((4, 2), (128, 0)):
        y, dropped = tops.moe_ffn_gmm(*t, capacity=cap, return_dropped=True)
        jy, jd = jops.moe_ffn_gmm(*j, capacity=cap, interpret=True,
                                  return_dropped=True)
        assert int(dropped) == int(jd) == n_drop
        assert dropped.dtype == torch.int32
        _close(y, jy, 1e-4)
    _close(y, jref.moe_ffn_ref(*j), 1e-4)


def _sorted_case(sizes, D, F, seed=0):
    rng = np.random.default_rng(seed)
    E, N = len(sizes), int(sum(sizes))
    xs = rng.standard_normal((N, D)).astype(np.float32)
    w = (rng.standard_normal((E, D, F)) / np.sqrt(D)).astype(np.float32)
    return both(np.asarray(sizes, np.int32)), both(xs), both(w)


def test_gmm_legacy_matches_ragged():
    (js, ts), (jx, tx), (jw, tw) = _sorted_case(
        [37, 0, 1, 129, 0, 77, 13, 200], D=64, F=128)
    out = tops.gmm_legacy(tx, tw, ts)
    _close(out, tops.gmm(tx, tw, ts), 2e-4)
    _close(out, jops.gmm_legacy(jx, jw, js, interpret=True), 2e-4)


def test_gmm_legacy_capacity_hint():
    """A capacity bound >= the largest group shrinks the bins and stays
    exact."""
    (js, ts), (jx, tx), (jw, tw) = _sorted_case([5, 0, 11], D=64, F=128)
    out = tops.gmm_legacy(tx, tw, ts, capacity=16)
    _close(out, tref.ragged_gmm_ref(tx, tw, ts), 2e-4)
    _close(out, jref.ragged_gmm_ref(jx, jw, js), 2e-4)


@pytest.mark.parametrize("sizes,total", [([200, 3, 40], None),
                                         ([5, 0, 11], 20)])
def test_gmm_legacy_overflow_gives_what_the_reference_gives(sizes, total):
    """The documented silent overflow: a group past the 128-row bin has its
    extra rows dropped by the scatter and reads slot 127 back; rows past the
    sum of the group sizes read expert E-1's bin.  The port returns the
    reference's rows, wrong ones included."""
    (js, ts), (jx, tx), (jw, tw) = _sorted_case(sizes, D=32, F=64, seed=4)
    if total is not None:                         # rows the groups do not cover
        rng = np.random.default_rng(5)
        extra = rng.standard_normal((total - sum(sizes), 32)).astype(np.float32)
        (jx, tx) = both(np.concatenate([np.asarray(jx), extra]))
    out = tops.gmm_legacy(tx, tw, ts, capacity=1)
    ref = jops.gmm_legacy(jx, jw, js, capacity=1, interpret=True)
    _close(out, ref, 2e-4)
    if total is None:                            # the overflow is really wrong
        assert not np.allclose(to_np(out)[128:200],
                               to_np(tref.ragged_gmm_ref(tx, tw, ts))[128:200])


def _operands(E, C, D, F, dtype, offset=0):
    """(x, w) of the given shapes without the memory: broadcast views of one
    row, x's base moved by ``offset`` elements."""
    dt = getattr(torch, dtype)
    x = torch.empty((D + offset,), dtype=dt)[offset:].expand(E, C, D)
    w = torch.empty((F,), dtype=dt).expand(E, D, F)
    return x, w


@pytest.mark.parametrize("dtype,E,C,D,F,offset,route", [
    ("float32", 2, 4, 32, 48, 0, "simt"),          # fp32: the parity path
    ("float32", 64, 128, 3584, 2560, 0, "simt"),
    ("bfloat16", 2, 4, 32, 48, 0, "sm90"),         # the reference's C = 4
    ("bfloat16", 3, 100, 72, 40, 0, "sm90"),       # ragged C and F
    ("bfloat16", 1, 512, 64, 384, 0, "sm90"),
    ("bfloat16", 2, 4, 36, 48, 0, "wmma"),         # D pitch 72 bytes
    ("bfloat16", 2, 4, 32, 44, 0, "wmma"),         # F pitch 88 bytes
    ("bfloat16", 2, 4, 32, 48, 1, "wmma"),         # x base off 16 bytes
])
def test_gmm_capacity_route(dtype, E, C, D, F, offset, route):
    """bf16 takes the TMA + wgmma kernel whenever TMA can address x and w,
    the WMMA kernel otherwise; fp32 the CUDA-core kernel."""
    x, w = _operands(E, C, D, F, dtype, offset)
    assert tgmm._route(x, w) == route


def test_every_model_shape_routes_to_sm90():
    """The full-width expert FFN's capacity products (gate/up D -> F, down
    F -> D) at the SD-verify and prefill capacities, and the reduced
    model's, all take the TMA + wgmma kernel in bf16."""
    from repro_torch.configs.registry import get_config
    for name, reduced in (("qwen2-57b-a14b", False), ("qwen2-57b-a14b", True)):
        cfg = get_config(name, reduced=reduced)
        E, K = cfg.num_experts, cfg.num_experts_per_tok
        D, F = cfg.d_model, cfg.moe_d_ff
        for n_tokens in (8, 40, 2048):
            C = tops.expert_capacity(n_tokens, K, E)
            for din, dout in ((D, F), (F, D)):
                assert tgmm._route(*_operands(E, C, din, dout, "bfloat16")) \
                    == "sm90", (name, reduced, C, din, dout)
