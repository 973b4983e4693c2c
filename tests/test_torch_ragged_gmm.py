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


# groups covering fewer rows than xs holds (sum(sizes) < N), as in an
# expert-parallel receive buffer: (sizes, N)
TRAILING_CASES = [([5, 0, 11], 24), ([37, 0, 1, 129, 0, 77, 13, 200], 480),
                  ([0, 0, 0], 8), ([64, 0], 100)]


@pytest.mark.parametrize("sizes,n", TRAILING_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_trailing_rows_past_the_groups(sizes, n, dtype):
    """sum(group_sizes) <= N: the plain versions equal the reference's
    ragged_moe_ffn (interpret mode) and its oracles on the real rows and
    zero the rows past the groups, on each of the three products."""
    rng = np.random.default_rng(len(sizes) + n)
    E, D, F, real = len(sizes), 64, 96, int(sum(sizes))
    xs = rng.standard_normal((n, D)).astype(np.float32)
    wg, wu = ((rng.standard_normal((E, D, F)) / np.sqrt(D)).astype(np.float32)
              for _ in range(2))
    wd = (rng.standard_normal((E, F, D)) / np.sqrt(F)).astype(np.float32)
    (jx, tx), (jg, tg), (ju, tu), (jd, td) = (both(a, dtype)
                                              for a in (xs, wg, wu, wd))
    js, ts = both(np.asarray(sizes, np.int32))
    tol = 2e-4 if dtype == "float32" else TOL[dtype]
    y = tr.ragged_moe_ffn(tx, tg, tu, td, ts)
    h = tr.fused_gate_up(tx, tg, tu, ts)
    z = tr.ragged_gmm(tx, tg, ts)
    assert y.shape == (n, D) and h.shape == (n, F) and z.shape == (n, F)
    for out in (y, h, z):
        assert not out[real:].any()
    _close(y[:real], jr.ragged_moe_ffn(jx, jg, ju, jd, js,
                                       interpret=True)[:real], tol)
    _close(h[:real], jref.fused_gate_up_ref(jx, jg, ju, js)[:real],
           TOL[dtype])
    _close(z[:real], jref.ragged_gmm_ref(jx, jg, js)[:real], TOL[dtype])


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


@pytest.mark.parametrize("bm", [16, 64, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bm_changes_nothing_against_reference(bm, dtype):
    """``bm`` is the reference's row tile: the reference's kernel at that
    tile (interpret mode) and the port's call with it give the same
    expert FFN, and the port's call equals its call without it."""
    sizes, xs, wg, wu = _case([37, 0, 1, 129, 0, 77, 13, 200], D=64, F=96)
    wd = (np.random.default_rng(5).standard_normal((len(sizes), 96, 64))
          / np.sqrt(96)).astype(np.float32)
    (jx, tx), (jg, tg), (ju, tu), (jd, td) = (both(a, dtype)
                                              for a in (xs, wg, wu, wd))
    js, ts = both(sizes)
    out = tr.ragged_moe_ffn(tx, tg, tu, td, ts, bm=bm)
    assert torch.equal(out, tr.ragged_moe_ffn(tx, tg, tu, td, ts))
    tol = 2e-4 if dtype == "float32" else TOL[dtype]
    _close(out, jr.ragged_moe_ffn(jx, jg, ju, jd, js, bm=bm,
                                  interpret=True), tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_many_experts_match_reference(dtype):
    """600 experts (more than one launch window of the bf16 body), most
    empty, at narrow widths: the plain versions against the reference's
    oracles."""
    rng = np.random.default_rng(600)
    E, D, F = 600, 16, 24
    sizes = np.zeros(E, np.int32)
    hit = rng.choice(E, 90, replace=False)
    sizes[hit] = rng.integers(1, 9, 90)
    N = int(sizes.sum())
    xs = rng.standard_normal((N, D)).astype(np.float32)
    wg, wu = ((rng.standard_normal((E, D, F)) / np.sqrt(D)).astype(np.float32)
              for _ in range(2))
    (jx, tx), (jg, tg), (ju, tu) = both(xs, dtype), both(wg, dtype), both(wu, dtype)
    js, ts = both(sizes)
    _close(tr.ragged_gmm(tx, tg, ts), jref.ragged_gmm_ref(jx, jg, js),
           TOL[dtype])
    _close(tr.fused_gate_up(tx, tg, tu, ts, activation="gelu"),
           jref.fused_gate_up_ref(jx, jg, ju, js, "gelu"), TOL[dtype])


# serve-like routings (top-8 of 64 experts) besides GROUP_CASES
def _routed(tokens, seed, E=64, K=8):
    rng = np.random.default_rng(seed)
    idx = np.argsort(rng.standard_normal((tokens, E)), -1)[:, :K]
    return np.bincount(idx.reshape(-1), minlength=E).astype(np.int32)


CHUNK_CASES = GROUP_CASES + [[0] * 5 + [128] + [0] * 2, _routed(40, 0).tolist(),
                             _routed(8, 1).tolist(), _routed(512, 2).tolist()]


@pytest.mark.parametrize("sizes", CHUNK_CASES)
@pytest.mark.parametrize("bm", [64, 128])
def test_expert_chunks_match_numpy_count(sizes, bm):
    """The TMA kernel's work list: sum(ceil(size / bm)) chunks over the
    non-empty experts, expert-major, each starting bm rows after the last
    within its expert and ending at the next chunk or the expert's end, so
    the chunks tile every routed row exactly once."""
    sizes = np.asarray(sizes, np.int64)
    chunks = tr.expert_chunks(torch.from_numpy(sizes.astype(np.int32)), bm)
    assert chunks.shape == (int((-(-sizes // bm)).sum()), 3)
    offs = np.concatenate([[0], np.cumsum(sizes)])
    want = [(e, offs[e] + c * bm, min(offs[e] + (c + 1) * bm, offs[e + 1]))
            for e in range(len(sizes)) if sizes[e]
            for c in range(-(-int(sizes[e]) // bm))]
    np.testing.assert_array_equal(chunks.numpy(), np.asarray(want).reshape(-1, 3))
    covered = np.zeros(int(sizes.sum()), np.int32)
    for _, lo, hi in want:
        covered[lo:hi] += 1
    assert (covered == 1).all()


@pytest.mark.parametrize("sizes", CHUNK_CASES)
@pytest.mark.parametrize("bm", [16, 64])
def test_expert_chunks_never_exceed_visits(sizes, bm):
    """At one row tile, an expert's chunks are never more than the
    row-tile-aligned visits make_group_metadata gives it (each visit reads
    the expert's weights once), and fewer wherever an expert's rows cross a
    tile boundary they would fit in."""
    sizes = np.asarray(sizes, np.int32)
    n_pad = -(-int(sizes.sum()) // bm) * bm
    meta = tr.make_group_metadata(torch.from_numpy(sizes), n_pad, bm)
    n_chunks = len(tr.expert_chunks(torch.from_numpy(sizes), bm))
    assert n_chunks <= int(meta.num_visits[0])
    offs = np.concatenate([[0], np.cumsum(sizes.astype(np.int64))])
    crossing = sum(1 for e in range(len(sizes)) if sizes[e] and
                   (offs[e + 1] - 1) // bm - offs[e] // bm + 1
                   > -(-int(sizes[e]) // bm))
    assert int(meta.num_visits[0]) - n_chunks == crossing


@pytest.mark.parametrize("dtype,K,F,bm,route,tma", [
    (torch.float32, 64, 96, None, "simt90", True),
    (torch.float32, 70, 96, None, "simt90", False),   # row pitch of 280 bytes
    (torch.bfloat16, 64, 96, None, "sm90", True),
    (torch.bfloat16, 64, 96, 64, "sm90", True),
    (torch.bfloat16, 64, 96, 128, "sm90", True),     # the reference's default
    (torch.bfloat16, 64, 96, 16, "sm90", True),      # bm picks no body
    (torch.bfloat16, 36, 96, None, "sm90", False),   # row pitch of 72 bytes
    (torch.bfloat16, 64, 100, None, "sm90", False),  # F not a multiple of 8
])
def test_route_picks_the_down_kernel(dtype, K, F, bm, route, tma):
    """``_route``'s dispatch (the launchers report what they ran on the
    card; the CPU runs neither): one body per element type, the bf16
    body's producer by TMA where TMA can address x and the weight."""
    xs = torch.zeros((10, K), dtype=dtype)
    w = torch.zeros((3, K, F), dtype=dtype)
    assert tr._route(xs, w, bm) == route
    assert tr._tma_ok(xs, w) == tma


def _offset_by_one(shape, dtype):
    """A contiguous view one element past a 16-byte aligned base."""
    n = int(np.prod(shape))
    return torch.zeros(n + 1, dtype=dtype)[1:].view(shape)


@pytest.mark.parametrize("dtype,K,F,bm,up_offset,route,tma", [
    (torch.float32, 64, 96, None, False, "simt90", True),
    (torch.float32, 64, 96, None, True, "simt90", False),
    (torch.bfloat16, 64, 96, None, False, "sm90", True),
    (torch.bfloat16, 64, 96, 64, False, "sm90", True),
    (torch.bfloat16, 64, 96, 16, False, "sm90", True),   # bm picks no body
    (torch.bfloat16, 64, 96, 128, False, "sm90", True),  # the reference's default
    (torch.bfloat16, 36, 96, None, False, "sm90", False),  # row pitch of 72 bytes
    (torch.bfloat16, 64, 100, None, False, "sm90", False),  # F not a multiple of 8
    (torch.bfloat16, 64, 96, None, True, "sm90", False),  # w_up alone misaligned
])
def test_route_picks_the_fused_kernel(dtype, K, F, bm, up_offset, route, tma):
    """``_route`` over both weights of the fused gate/up product, and
    whether TMA addresses x, w_gate and w_up, each checked on its own."""
    xs = torch.zeros((10, K), dtype=dtype)
    wg = torch.zeros((3, K, F), dtype=dtype)
    wu = (_offset_by_one((3, K, F), dtype) if up_offset
          else torch.zeros((3, K, F), dtype=dtype))
    assert wg.data_ptr() % 16 == 0
    assert (wu.data_ptr() % 16 != 0) == up_offset
    assert tr._route(xs, (wg, wu), bm) == route
    assert tr._tma_ok(xs, (wg, wu)) == tma
    # the gate weight alone: only the misaligned w_up kept TMA off
    assert tr._route(xs, wg, bm) == route
    assert tr._tma_ok(xs, wg) == (True if up_offset else tma)


@pytest.mark.parametrize("bm", [None, 16, 64, 128])
@pytest.mark.parametrize("E", [3, 600])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("x_offset", [False, True])
def test_route_ignores_bm_experts_and_alignment(bm, E, dtype, x_offset):
    """Every bf16 call takes sm90 and every fp32 call simt90, whatever the
    row tile the caller names, the number of experts (600 is two windows
    of the bf16 body) and x's base (one element off 16 bytes: the bf16
    producer then stages)."""
    xs = (_offset_by_one((10, 64), dtype) if x_offset
          else torch.zeros((10, 64), dtype=dtype))
    w = torch.zeros((E, 64, 96), dtype=dtype)
    assert tr._route(xs, w, bm) == ("simt90" if dtype == torch.float32
                                    else "sm90")
    assert tr._tma_ok(xs, w) == (not x_offset)
