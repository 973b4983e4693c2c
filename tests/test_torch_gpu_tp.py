"""Tensor parallelism on the card: kernel 4's partial entry and the TP
collectives inside a CUDA graph.

Marked ``gpu``: each test asks a fixture whether a card and ``nvcc`` are
there and skips with the reason when not.  Run on a machine with an
NVIDIA GPU:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu_tp.py

The partial entry (``decode_attention_partial``: one key block of a cache
split along its sequence) is held against its plain version on every body
(sm90 for bf16 at head dims 64 and 128, WMMA at 256, the CUDA cores in
fp32) at kernel 4's tolerances (4e-2 in bf16, 3e-5 in fp32), and its
blocks merged by log-sum-exp against the whole call.  The collectives run
on a NCCL world of one (the mesh starts it): captured in a CUDA graph and
replayed on new inputs, they equal the eager calls bit for bit.
"""
import pytest
import torch

from repro_torch.distributed import collectives as col
from repro_torch.kernels.decode_attention import ops
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_partial_plain, decode_attention_plain)

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 3e-5, torch.bfloat16: 4e-2}


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    from repro_torch.kernels import build
    try:
        build.find_nvcc()
    except RuntimeError as e:
        pytest.skip(str(e))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def mesh(cuda):
    from repro_torch.launch.mesh import make_ep_mesh
    return make_ep_mesh(1)


def _close(got, want, tol):
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype,D,Hq,Hkv,route", [
    (torch.bfloat16, 128, 28, 4, "sm90"), (torch.bfloat16, 64, 14, 2, "sm90"),
    (torch.bfloat16, 256, 16, 8, "sm90"), (torch.float32, 128, 28, 4, "simt")])
@pytest.mark.parametrize("blocks", [2, 4])
def test_partial_entry_matches_plain_and_merges(cuda, dtype, D, Hq, Hkv,
                                                route, blocks):
    g = torch.Generator(device=cuda).manual_seed(D + blocks)
    B, T, S = 4, 5, 1024
    q = torch.randn((B, T, Hq, D), generator=g, device=cuda).to(dtype)
    k, v = (torch.randn((B, S, Hkv, D), generator=g, device=cuda).to(dtype)
            for _ in range(2))
    # row 0 sees only the first block; row 3 reaches the last key
    lengths = torch.tensor([17, 300, 700, S - T], dtype=torch.int32,
                           device=cuda)
    n = S // blocks
    outs, lses = [], []
    for i in range(blocks):
        kb, vb = k[:, i * n:(i + 1) * n], v[:, i * n:(i + 1) * n]
        out, lse = ops.decode_attention_partial(q, kb, vb, lengths,
                                                k_lo=i * n)
        assert ops.LAST_ROUTE["decode_attention_partial"] == route
        p_out, p_lse = decode_attention_partial_plain(q, kb, vb, lengths,
                                                      k_lo=i * n)
        torch.cuda.synchronize()
        _close(out, p_out, TOL[dtype])
        assert torch.equal(torch.isinf(lse), torch.isinf(p_lse))
        fin = torch.isfinite(p_lse)
        _close(lse[fin], p_lse[fin], TOL[dtype])
        outs.append(out)
        lses.append(lse)
    assert torch.isinf(lses[-1][0]).all() and not outs[-1][0].any()
    merged = col.lse_combine(torch.stack(outs), torch.stack(lses))
    _close(merged, decode_attention_plain(q, k, v, lengths), TOL[dtype])


def test_partial_entry_captures_in_a_graph(cuda):
    """The partial entry's scratch and merge live on the current stream:
    a captured call replays to the eager call's bits."""
    g = torch.Generator(device=cuda).manual_seed(3)
    B, T, S, n = 8, 5, 8192, 2048
    q = torch.randn((B, T, 28, 128), generator=g, device=cuda).bfloat16()
    k, v = (torch.randn((B, n, 4, 128), generator=g, device=cuda).bfloat16()
            for _ in range(2))
    lengths = torch.full((B,), 8100, dtype=torch.int32, device=cuda)
    eager = ops.decode_attention_partial(q, k, v, lengths, k_lo=2048)
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ops.decode_attention_partial(q, k, v, lengths, k_lo=2048)
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        out, lse = ops.decode_attention_partial(q, k, v, lengths, k_lo=2048)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager[0]) and torch.equal(lse, eager[1])


def test_tp_collectives_captured_equal_eager(mesh):
    """*f*'s and *g*'s all-reduce, the all-gather of ``gather`` and the
    partials' merge, through NCCL on a world of one, captured in one CUDA
    graph and replayed on new inputs: the eager calls' bits."""
    import torch.distributed as dist
    grp = dist.group.WORLD
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((8, 5, 256), generator=g, device=dev)
    o = torch.randn((8, 5, 7, 64), generator=g, device=dev)
    lse = torch.randn((8, 5, 7), generator=g, device=dev)

    def ops_():
        return (col._all_reduce(x, grp), col._gather_dim(x, 2, grp, 1),
                col._reduce_scatter(x, 0, grp, 1),
                col.lse_combine(col._gather_dim(o, 0, grp, 1)[None],
                                col._gather_dim(lse, 0, grp, 1)[None]))

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ops_()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = ops_()
    for seed in (1, 2):
        gen = torch.Generator(device=dev).manual_seed(seed)
        for t in (x, o, lse):
            t.copy_(torch.randn(t.shape, generator=gen, device=dev))
        graph.replay()
        eager = ops_()
        torch.cuda.synchronize()
        for a, b in zip(captured, eager):
            assert torch.equal(a, b)


@pytest.mark.parametrize("dtype,D,Hq,Hkv", [
    (torch.bfloat16, 128, 28, 4), (torch.bfloat16, 256, 16, 8),
    (torch.float32, 128, 28, 4)])
def test_partial_entry_block_past_every_row_is_zero(cuda, dtype, D, Hq, Hkv):
    """A block that holds no key any row sees (every row before it): its
    output is exactly 0 and its lse -inf on every body, with shared memory
    full of a previous call's values (a block that runs no key chunk must
    still order its initialisation before its output)."""
    g = torch.Generator(device=cuda).manual_seed(D)
    B, T, n = 8, 5, 512
    q = torch.randn((B, T, Hq, D), generator=g, device=cuda).to(dtype)
    k, v = (torch.randn((B, n, Hkv, D), generator=g, device=cuda).to(dtype)
            for _ in range(2))
    seen = torch.full((B,), n - T, dtype=torch.int32, device=cuda)
    before = torch.full((B,), 100, dtype=torch.int32, device=cuda)
    for _ in range(20):
        ops.decode_attention_partial(q, k, v, seen, k_lo=0)  # dirty smem
        out, lse = ops.decode_attention_partial(q, k, v, before, k_lo=4096)
        torch.cuda.synchronize()
        assert torch.equal(out, torch.zeros_like(out))
        assert torch.isneginf(lse).all()
