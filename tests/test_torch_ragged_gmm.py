"""Port's ragged grouped matmul (plain path on the CPU) vs the reference.

The reference runs its Pallas kernels in interpret mode, as its own tests do
(tests/test_ragged_gmm.py), and its ref.py oracles.  Tolerances: 1e-4 in
fp32 (summation order only); 3e-2 in bf16 (bf16 inputs, fp32 accumulation,
one bf16 rounding of the output), the reference's own bound."""
import numpy as np
import pytest
import torch

from _torch_parity import both, to_np
from repro.kernels.gmm import ragged as jr
from repro.kernels.gmm import ref as jref
from repro_torch.kernels.gmm import ragged as tr

# empty experts / fully-imbalanced / unaligned group sizes / single expert
GROUP_CASES = [
    [5, 0, 11],
    [0, 0, 310, 0],
    [37, 0, 1, 129, 0, 77, 13, 200],
    [256],
]
TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def _case(sizes, D, F, seed=0):
    rng = np.random.default_rng(seed)
    E, N = len(sizes), int(sum(sizes))
    xs = rng.standard_normal((N, D)).astype(np.float32)
    wg = (rng.standard_normal((E, D, F)) / np.sqrt(D)).astype(np.float32)
    wu = (rng.standard_normal((E, D, F)) / np.sqrt(D)).astype(np.float32)
    return np.asarray(sizes, np.int32), xs, wg, wu


def _close(a, b, tol):
    np.testing.assert_allclose(to_np(a), to_np(b), rtol=tol, atol=tol)


@pytest.mark.parametrize("sizes", GROUP_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ragged_gmm_matches_reference(sizes, dtype):
    sizes, xs, w, _ = _case(sizes, D=64, F=128)
    (jx, tx), (jw, tw), (js, ts) = both(xs, dtype), both(w, dtype), both(sizes)
    out = tr.ragged_gmm(tx, tw, ts)
    assert out.dtype == tx.dtype and out.shape == (xs.shape[0], 128)
    _close(out, jr.ragged_gmm(jx, jw, js, interpret=True), TOL[dtype])
    _close(out, jref.ragged_gmm_ref(jx, jw, js), TOL[dtype])


@pytest.mark.parametrize("sizes", GROUP_CASES)
@pytest.mark.parametrize("activation", ["silu", "gelu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_gate_up_matches_reference(sizes, activation, dtype):
    sizes, xs, wg, wu = _case(sizes, D=64, F=96)
    (jx, tx), (jg, tg), (ju, tu) = both(xs, dtype), both(wg, dtype), both(wu, dtype)
    js, ts = both(sizes)
    out = tr.fused_gate_up(tx, tg, tu, ts, activation=activation)
    _close(out, jr.fused_gate_up(jx, jg, ju, js, activation=activation,
                                 interpret=True), TOL[dtype])
    _close(out, jref.fused_gate_up_ref(jx, jg, ju, js, activation), TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ragged_moe_ffn_matches_reference(dtype):
    sizes, xs, wg, wu = _case([37, 0, 1, 129, 0, 77, 13, 200], D=64, F=96)
    wd = (np.random.default_rng(9).standard_normal((len(sizes), 96, 64))
          / np.sqrt(96)).astype(np.float32)
    (jx, tx), (jg, tg), (ju, tu), (jd, td) = (both(a, dtype)
                                              for a in (xs, wg, wu, wd))
    js, ts = both(sizes)
    out = tr.ragged_moe_ffn(tx, tg, tu, td, ts)
    tol = 2e-4 if dtype == "float32" else TOL[dtype]
    _close(out, jr.ragged_moe_ffn(jx, jg, ju, jd, js, interpret=True), tol)
    _close(out, jref.ragged_moe_ffn_ref(jx, jg, ju, jd, js), tol)


@pytest.mark.parametrize("sizes", GROUP_CASES + [[0] * 5 + [128] + [0] * 2])
@pytest.mark.parametrize("bm", [16, 64])
def test_group_metadata_matches_reference(sizes, bm):
    """Same visit list as the reference at equal bm: num_visits, offsets,
    and the (expert, m-tile) of every visit, padding included."""
    sizes = np.asarray(sizes, np.int32)
    n_pad = -(-int(sizes.sum()) // bm) * bm
    js, ts = both(sizes)
    jm = jr.make_group_metadata(js, n_pad, bm)
    tm = tr.make_group_metadata(ts, n_pad, bm)
    for j, t in zip(jm, tm):
        assert t.dtype == torch.int32
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_visits_scale_with_routed_rows_not_capacity_bins():
    E, bm = 64, 128
    sizes = np.zeros(E, np.int32)
    sizes[3], sizes[40] = 200, 56                  # N=256 on 2 of 64 experts
    meta = tr.make_group_metadata(torch.from_numpy(sizes), 256, bm)
    # expert 3 rows [0,200) -> tiles {0,1}; expert 40 rows [200,256) -> {1}
    assert int(meta.num_visits[0]) == 3
    empty = np.zeros(8, np.int32)
    empty[2] = 128                                 # 7 empty experts: 0 visits
    assert int(tr.make_group_metadata(torch.from_numpy(empty), 128,
                                      bm).num_visits[0]) == 1


def test_row_tile_follows_rows_per_expert():
    """Verify-sized routing (320 rows on 64 experts) takes 16-row tiles,
    prefill-sized (4096 rows) 64-row tiles."""
    assert tr._row_tile(320, 64) == 16
    assert tr._row_tile(4096, 64) == 64
