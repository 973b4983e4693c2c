"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: each test asks a fixture whether a card and ``nvcc`` are
there and skips with the reason when not (the decision is never made at
import time, so every xdist worker collects the same tests).  Run on a
machine with an NVIDIA GPU:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu_kernels.py

Tolerances of the ragged kernels: 1e-4 in fp32; in bf16 the reference's
3e-2 bound (rtol and atol, tests/test_ragged_gmm.py): both sides accumulate
in fp32 in different orders and round once to bf16, so they differ by at
most one bf16 ulp.  The paged, dense decode, flash and capacity kernels are
held at the reference's own bounds, stated beside their tests.  The last
cases hold kernels 1-2 at jamba-v0.1-52b's routing (16 experts of 4096 x
14336, top-2) and kernels 4-5 at whisper-base's, jamba-v0.1-52b's and
the drafts' heads.
"""
import pytest
import torch

from repro_torch.kernels.gmm import ragged
from repro_torch.kernels.gmm.ref import (fused_gate_up_ref, ragged_gmm_ref,
                                         ragged_moe_ffn_ref)

pytestmark = pytest.mark.gpu

GROUP_CASES = [
    [5, 0, 11],
    [0, 0, 310, 0],
    [37, 0, 1, 129, 0, 77, 13, 200],
    [256],
]
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


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
    return torch.device("cuda")


def _case(sizes, D, F, dtype, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    E, N = len(sizes), int(sum(sizes))
    xs = torch.randn((N, D), generator=g, device=dev).to(dtype)
    ws = [(torch.randn((E, D, F), generator=g, device=dev) / D ** 0.5).to(dtype)
          for _ in range(2)]
    return torch.tensor(sizes, dtype=torch.int32, device=dev), xs, ws


def _close(out, ref, dtype):
    tol = TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("sizes", GROUP_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bm", [None, 16, 64, 128])
def test_ragged_gmm_kernel_matches_plain(cuda, sizes, dtype, bm):
    """fp32 runs the CUDA-core body (simt90), bf16 the TMA + wgmma body
    with its TMA producer, whatever row tile ``bm`` names (the reference's
    argument; 128 is its default)."""
    sizes, xs, (w, _) = _case(sizes, 64, 96, dtype, cuda)
    before = ragged.LAUNCHES["ragged_gmm"]
    out = ragged.ragged_gmm(xs, w, sizes, bm=bm)
    torch.cuda.synchronize()
    assert ragged.LAUNCHES["ragged_gmm"] == before + 1
    fp32 = dtype == torch.float32
    assert ragged.LAST_ROUTE["ragged_gmm"] == ("simt90" if fp32 else "sm90")
    assert ragged.LAST_PRODUCER["ragged_gmm"] == (None if fp32 else "tma")
    _close(out, ragged_gmm_ref(xs, w, sizes), dtype)


def _offset(t: torch.Tensor, elems: int) -> torch.Tensor:
    """A contiguous copy of t whose base lies ``elems`` elements past a
    16-byte boundary."""
    buf = torch.empty((t.numel() + elems,), dtype=t.dtype, device=t.device)
    buf[elems:].copy_(t.reshape(-1))
    return buf[elems:].view(t.shape)


# operands TMA cannot address: (what, K, F) -- x, the weight (w_gate of the
# fused product) or w_up alone one element off 16 bytes; K 36 (x's row
# pitch 72 bytes); F 100 (the weights' and the output's pitch 200 bytes);
# several K steps and column tiles (K 256, 200; F 320, 256), the operands
# TMA can address still loaded by TMA beside the staged one.
STAGED_CASES = [("x", 64, 96), ("w", 64, 96), ("w_up", 64, 96),
                ("none", 36, 96), ("none", 64, 100), ("x", 256, 192),
                ("w", 256, 320), ("w_up", 200, 256)]


def _unaligned(what, xs, ws):
    if what == "x":
        return _offset(xs, 1), ws
    if what == "w":
        return xs, [_offset(ws[0], 1), ws[1]]
    if what == "w_up":
        return xs, [ws[0], _offset(ws[1], 1)]
    return xs, ws


@pytest.mark.parametrize("sizes", GROUP_CASES)
@pytest.mark.parametrize("what,K,F", STAGED_CASES)
@pytest.mark.parametrize("product", ["down", "silu", "gelu"])
def test_ragged_staged_producer_matches_plain(cuda, sizes, what, K, F,
                                              product):
    """bf16 operands TMA cannot address run the sm90 body with its staged
    producer (cp.async into the swizzled tiles; 2-byte offsets through
    aligned words), held at the bf16 bound."""
    sizes, xs, ws = _case(sizes, K, F, torch.bfloat16, cuda, seed=K + F)
    xs, ws = _unaligned(what, xs, ws)
    name = "ragged_gmm" if product == "down" else "fused_gate_up"
    if product == "down":
        out = ragged.ragged_gmm(xs, ws[0], sizes)
        ref = ragged_gmm_ref(xs, ws[0], sizes)
    else:
        out = ragged.fused_gate_up(xs, ws[0], ws[1], sizes,
                                   activation=product)
        ref = fused_gate_up_ref(xs, ws[0], ws[1], sizes, product)
    torch.cuda.synchronize()
    assert ragged.LAST_ROUTE[name] == "sm90"
    assert ragged.LAST_PRODUCER[name] == (
        "tma" if what == "w_up" and product == "down" else "staged")
    _close(out, ref, torch.bfloat16)


# fp32 operands: aligned; x's row pitch 280 bytes (K 70); x 4 bytes off
# 16; the weights 4 bytes off; F 100 (pitch 400 bytes: 16-byte pieces of
# the output and weights aligned only every fourth row)
F32_CASES = [("none", 64, 96), ("none", 70, 96), ("x", 64, 96),
             ("w", 64, 96), ("w_up", 64, 96), ("none", 64, 100),
             ("none", 70, 130)]


@pytest.mark.parametrize("sizes", GROUP_CASES)
@pytest.mark.parametrize("what,K,F", F32_CASES)
@pytest.mark.parametrize("product", ["down", "silu", "gelu"])
def test_ragged_fp32_body_matches_plain(cuda, sizes, what, K, F, product):
    """Every fp32 call runs the simt90 body (16-byte copies where aligned,
    4-byte ones otherwise), at 1e-4 with TF32 off."""
    sizes, xs, ws = _case(sizes, K, F, torch.float32, cuda, seed=K * F)
    xs, ws = _unaligned(what, xs, ws)
    name = "ragged_gmm" if product == "down" else "fused_gate_up"
    if product == "down":
        out = ragged.ragged_gmm(xs, ws[0], sizes)
        ref = ragged_gmm_ref(xs, ws[0], sizes)
    else:
        out = ragged.fused_gate_up(xs, ws[0], ws[1], sizes,
                                   activation=product)
        ref = fused_gate_up_ref(xs, ws[0], ws[1], sizes, product)
    torch.cuda.synchronize()
    assert ragged.LAST_ROUTE[name] == "simt90"
    _close(out, ref, torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [0, 1])
def test_ragged_many_experts(cuda, dtype, offset):
    """600 experts, most empty: the bf16 body launches once per window of
    512 experts (the second launch sums the rows before its window), fp32
    once; both products match the plain versions."""
    g = torch.Generator(device=cuda).manual_seed(600 + offset)
    E, D, F = 600, 64, 96
    sizes = torch.zeros((E,), dtype=torch.int32, device=cuda)
    hit = torch.randperm(E, generator=g, device=cuda)[:120]
    sizes[hit] = torch.randint(1, 80, (120,), generator=g, device=cuda,
                               dtype=torch.int32)
    sizes[E - 1] = 70                          # rows in the last window
    N = int(sizes.sum())
    xs = torch.randn((N, D), generator=g, device=cuda).to(dtype)
    wg, wu = ((torch.randn((E, D, F), generator=g, device=cuda) / D ** 0.5)
              .to(dtype) for _ in range(2))
    if offset:
        xs = _offset(xs, offset)
    windows = -(-E // 512) if dtype == torch.bfloat16 else 1
    before = dict(ragged.LAUNCHES)
    z = ragged.ragged_gmm(xs, wg, sizes)
    h = ragged.fused_gate_up(xs, wg, wu, sizes)
    torch.cuda.synchronize()
    assert {k: ragged.LAUNCHES[k] - before[k] for k in before} == {
        "fused_gate_up": windows, "ragged_gmm": windows}
    assert ragged.LAST_ROUTE["ragged_gmm"] == (
        "sm90" if dtype == torch.bfloat16 else "simt90")
    _close(z, ragged_gmm_ref(xs, wg, sizes), dtype)
    _close(h, fused_gate_up_ref(xs, wg, wu, sizes), dtype)


@pytest.mark.parametrize("sizes", GROUP_CASES + [[0] * 5 + [129] + [0] * 2])
@pytest.mark.parametrize("bm", [None, 64])
def test_ragged_gmm_sm90_kernel_matches_plain(cuda, sizes, bm):
    """The bf16 TMA + wgmma down kernel on expert-aligned 64-row chunks:
    experts with more rows than a chunk (310, 200, 256, 129), empty
    experts, groups starting at unaligned rows, one expert; F 136 is one
    and a ragged column tile."""
    sizes, xs, (w, _) = _case(sizes, 128, 136, torch.bfloat16, cuda,
                              seed=len(sizes))
    assert ragged._route(xs, w, bm) == "sm90"
    before = ragged.LAUNCHES["ragged_gmm"]
    out = ragged.ragged_gmm(xs, w, sizes, bm=bm)
    torch.cuda.synchronize()
    assert ragged.LAUNCHES["ragged_gmm"] == before + 1
    assert ragged.LAST_ROUTE["ragged_gmm"] == "sm90"
    _close(out, ragged_gmm_ref(xs, w, sizes), torch.bfloat16)


@pytest.mark.parametrize("tokens", [40, 8, 512])
def test_ragged_gmm_sm90_at_serving_widths(cuda, tokens):
    """The down projection of qwen2-57b-a14b (F 2560 -> D 3584, 64 experts,
    top-8) at the SD verify (320 rows), AR verify (64) and prefill (4096)
    row counts, with no host sync; the expert-chunk list is never longer
    than the fused kernel's visit list."""
    g = torch.Generator(device=cuda).manual_seed(tokens)
    E, K, D, F = 64, 8, 3584, 2560
    idx = torch.randn((tokens, E), generator=g, device=cuda).topk(K, -1).indices
    sizes = torch.bincount(idx.reshape(-1), minlength=E).to(torch.int32)
    h = torch.randn((tokens * K, F), generator=g, device=cuda).bfloat16()
    wd = (torch.randn((E, F, D), generator=g, device=cuda) / F ** 0.5
          ).bfloat16()
    ragged.ragged_gmm(h, wd, sizes)                  # build + load first
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = ragged.ragged_gmm(h, wd, sizes)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert ragged.LAST_ROUTE["ragged_gmm"] == "sm90"
    _close(out, ragged_gmm_ref(h, wd, sizes), torch.bfloat16)
    bm = ragged.sm90_chunk_rows()
    n_chunks = len(ragged.expert_chunks(sizes, bm))
    assert bm == 64 and n_chunks == int(((sizes + bm - 1) // bm).sum())
    meta = ragged.make_group_metadata(sizes, -(-h.shape[0] // bm) * bm, bm)
    assert n_chunks <= int(meta.num_visits[0])


@pytest.mark.parametrize("sizes", GROUP_CASES)
@pytest.mark.parametrize("activation", ["silu", "gelu"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_gate_up_kernel_matches_plain(cuda, sizes, activation, dtype):
    sizes, xs, (wg, wu) = _case(sizes, 64, 128, dtype, cuda)
    out = ragged.fused_gate_up(xs, wg, wu, sizes, activation=activation)
    torch.cuda.synchronize()
    _close(out, fused_gate_up_ref(xs, wg, wu, sizes, activation), dtype)


@pytest.mark.parametrize("sizes", [[0, 1, 129, 0, 200, 37, 0],
                                   [0, 5, 0, 64, 65, 0, 3, 0]])
@pytest.mark.parametrize("activation", ["silu", "gelu"])
@pytest.mark.parametrize("K,F", [(128, 136), (72, 200)])
def test_fused_gate_up_sm90_kernel_matches_plain(cuda, sizes, activation, K,
                                                 F):
    """The bf16 TMA + wgmma fused kernel on expert-aligned 64-row chunks:
    empty experts first and last, a 1-row expert, experts of 65, 129 and
    200 rows (several chunks); F 136 and 200 end in a ragged column tile,
    K 72 in a K tail past one 64-deep stage."""
    sizes, xs, (wg, wu) = _case(sizes, K, F, torch.bfloat16, cuda,
                                seed=len(sizes) + K)
    assert ragged._route(xs, (wg, wu)) == "sm90"
    before = ragged.LAUNCHES["fused_gate_up"]
    out = ragged.fused_gate_up(xs, wg, wu, sizes, activation=activation)
    torch.cuda.synchronize()
    assert ragged.LAUNCHES["fused_gate_up"] == before + 1
    assert ragged.LAST_ROUTE["fused_gate_up"] == "sm90"
    _close(out, fused_gate_up_ref(xs, wg, wu, sizes, activation),
           torch.bfloat16)


@pytest.mark.parametrize("tokens", [40, 8, 512])
def test_fused_gate_up_sm90_at_serving_widths(cuda, tokens):
    """The gate/up product of qwen2-57b-a14b (D 3584 -> F 2560, 64 experts,
    top-8) at the SD verify (320 rows), AR verify (64) and prefill (4096)
    row counts, with no host sync."""
    g = torch.Generator(device=cuda).manual_seed(tokens)
    E, K, D, F = 64, 8, 3584, 2560
    idx = torch.randn((tokens, E), generator=g, device=cuda).topk(K, -1).indices
    sizes = torch.bincount(idx.reshape(-1), minlength=E).to(torch.int32)
    xs = torch.randn((tokens * K, D), generator=g, device=cuda).bfloat16()
    wg, wu = ((torch.randn((E, D, F), generator=g, device=cuda) / D ** 0.5
               ).bfloat16() for _ in range(2))
    ragged.fused_gate_up(xs, wg, wu, sizes)          # build + load first
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = ragged.fused_gate_up(xs, wg, wu, sizes)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert ragged.LAST_ROUTE["fused_gate_up"] == "sm90"
    _close(out, fused_gate_up_ref(xs, wg, wu, sizes), torch.bfloat16)


def _ffn_weights(E, D, F, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    wg, wu = ((torch.randn((E, D, F), generator=g, device=dev) / D ** 0.5
               ).bfloat16() for _ in range(2))
    wd = (torch.randn((E, F, D), generator=g, device=dev) / F ** 0.5
          ).bfloat16()
    return wg, wu, wd


def test_moe_ffn_sm90_builds_no_visit_list(cuda, monkeypatch):
    """On the bf16 sm90 route ragged_moe_ffn is its two launches and no
    visit list (make_group_metadata raises here)."""
    sizes, xs, _ = _case([37, 0, 1, 129, 0, 77, 13, 200], 128, 136,
                         torch.bfloat16, cuda)
    wg, wu, wd = _ffn_weights(len(sizes), 128, 136, cuda, seed=3)

    def refuse(*args, **kwargs):
        raise AssertionError("visit list built on the sm90 route")

    monkeypatch.setattr(ragged, "make_group_metadata", refuse)
    before = dict(ragged.LAUNCHES)
    out = ragged.ragged_moe_ffn(xs, wg, wu, wd, sizes)
    torch.cuda.synchronize()
    assert {k: ragged.LAUNCHES[k] - before[k] for k in before} == {
        "fused_gate_up": 1, "ragged_gmm": 1}
    assert ragged.LAST_ROUTE == {"fused_gate_up": "sm90", "ragged_gmm": "sm90"}
    _close(out, ragged_moe_ffn_ref(xs, wg, wu, wd, sizes), torch.bfloat16)


def test_moe_ffn_sm90_graph_replays_read_new_routing(cuda):
    """ragged_moe_ffn captured once in a CUDA graph, then replayed after new
    routing and rows are written into the same group_sizes and xs buffers:
    each replay matches the plain version on its routing, so both kernels
    read the routing on the device at every replay."""
    E, N, D, F = 8, 320, 128, 136
    wg, wu, wd = _ffn_weights(E, D, F, cuda, seed=4)
    g = torch.Generator(device=cuda).manual_seed(5)
    sizes = torch.zeros((E,), dtype=torch.int32, device=cuda)
    xs = torch.empty((N, D), dtype=torch.bfloat16, device=cuda)

    def route(counts):
        sizes.copy_(torch.tensor(counts, dtype=torch.int32))
        xs.copy_(torch.randn((N, D), generator=g, device=cuda))

    route([40] * E)
    ragged.ragged_moe_ffn(xs, wg, wu, wd, sizes)     # build + load first
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ragged.ragged_moe_ffn(xs, wg, wu, wd, sizes)
    for counts in ([40] * E, [0, 0, 200, 0, 0, 120, 0, 0],
                   [1, 0, 63, 65, 0, 0, 0, 191], [0] * (E - 1) + [N]):
        route(counts)
        graph.replay()
        torch.cuda.synchronize()
        _close(out, ragged_moe_ffn_ref(xs, wg, wu, wd, sizes), torch.bfloat16)


@pytest.mark.parametrize("rows,dtype", [(320, torch.bfloat16),
                                        (4096, torch.bfloat16),
                                        (320, torch.float32)])
def test_moe_ffn_kernels_at_serving_widths(cuda, rows, dtype):
    """Full published widths (D=3584, F=2560) with top-8-of-64 routing, at a
    verify (320 rows) and a prefill (4096 rows) row count; 8 experts keep
    the weights small."""
    g = torch.Generator(device=cuda).manual_seed(rows)
    E, D, F = 8, 3584, 2560
    sizes = torch.bincount(torch.randint(0, E, (rows,), generator=g,
                                         device=cuda), minlength=E).to(torch.int32)
    xs = torch.randn((rows, D), generator=g, device=cuda).to(dtype)
    wg, wu = ((torch.randn((E, D, F), generator=g, device=cuda) / D ** 0.5)
              .to(dtype) for _ in range(2))
    wd = (torch.randn((E, F, D), generator=g, device=cuda) / F ** 0.5).to(dtype)
    out = ragged.ragged_moe_ffn(xs, wg, wu, wd, sizes)
    torch.cuda.synchronize()
    _close(out, ragged_moe_ffn_ref(xs, wg, wu, wd, sizes), dtype)


def test_moe_ffn_kernels_at_ar_verify_shape(cuda):
    """The AR verify pass at B=8: 8 tokens x top-8 of 64 experts is 64 rows,
    about one per expert, so nearly every 16-row tile straddles several
    experts.  Full published widths, bf16."""
    g = torch.Generator(device=cuda).manual_seed(8)
    E, K, D, F = 64, 8, 3584, 2560
    idx = torch.randn((8, E), generator=g, device=cuda).topk(K, -1).indices
    sizes = torch.bincount(idx.reshape(-1), minlength=E).to(torch.int32)
    xs = torch.randn((8 * K, D), generator=g, device=cuda).to(torch.bfloat16)
    wg, wu = ((torch.randn((E, D, F), generator=g, device=cuda) / D ** 0.5)
              .to(torch.bfloat16) for _ in range(2))
    wd = (torch.randn((E, F, D), generator=g, device=cuda) / F ** 0.5
          ).to(torch.bfloat16)
    out = ragged.ragged_moe_ffn(xs, wg, wu, wd, sizes)
    torch.cuda.synchronize()
    _close(out, ragged_moe_ffn_ref(xs, wg, wu, wd, sizes), torch.bfloat16)


def test_moe_layer_never_syncs_on_routing(cuda):
    """The gmm dispatch reads no routing value on the host."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import moe
    cfg = get_config("qwen2-57b-a14b", reduced=True)
    gen = torch.Generator(device=cuda).manual_seed(0)
    p = moe.init_moe(cfg, torch.float32, generator=gen, device=cuda)
    x = torch.randn((2, 5, cfg.d_model), generator=gen, device=cuda)
    moe.moe_forward(p, cfg, x, dispatch="gmm")      # build + load first
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y, _ = moe.moe_forward(p, cfg, x, dispatch="gmm")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    ref, _ = moe.moe_forward(p, cfg, x, dispatch="onehot")
    torch.testing.assert_close(y, ref, rtol=2e-4, atol=2e-4)


def test_moe_layer_bf16_on_card_matches_cpu(cuda):
    """The bf16 gmm dispatch on the card (kernels, a fixed-order sum of each
    token's K rows) against the same layer on the CPU (plain loop,
    sequential index_add_).  Bound: the reference's bf16 3e-2 (rtol and
    atol) — each side rounds h and the expert outputs to bf16; the CPU also
    rounds every one of the K adds, the card sums them in fp32 and rounds
    once."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import moe
    cfg = get_config("qwen2-57b-a14b", reduced=True).with_overrides(
        dtype="bfloat16")
    gen = torch.Generator().manual_seed(1)
    p = moe.init_moe(cfg, torch.bfloat16, generator=gen, device="cpu")
    x = torch.randn((4, 5, cfg.d_model), generator=gen).to(torch.bfloat16)
    on_card, _ = moe.moe_forward(_to(p, cuda), cfg, x.to(cuda),
                                 dispatch="gmm")
    on_cpu, _ = moe.moe_forward(p, cfg, x, dispatch="gmm")
    torch.testing.assert_close(on_card.cpu().float(), on_cpu.float(),
                               rtol=3e-2, atol=3e-2)


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


# ----------------------------------------------- paged decode/verify attention
# bf16 2e-2 and fp32 2e-5 (rtol and atol): the reference's bounds
# (src/repro/kernels/decode_attention/decode_attention.py:288 in fp32); both
# sides accumulate in fp32 in different orders, bf16 rounds the output once.
PAGED_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# bf16 on the split-KV body, besides PAGED_TOL: every element within 5e-2 x
# the rms of its output row (chip_smoke.PAGED_ROW_TOL).  At ~8k keys |out|
# ~ 0.011, below 2e-2; a dropped split or a stale 64-key chunk put the worst
# element at 1.6-2.6 x its row's rms, a sound kernel stays at <= 0.025 x.
PAGED_ROW_TOL = 5e-2


def _paged_case(dev, dtype, *, B, Hq, Hkv, D, T, ps, MP, seed=0,
                lengths=None):
    """Noise in every physical page (trash page 0 included), a permuted
    table and ragged lengths, as tests/test_paged_attention.py builds them
    (or the given lengths)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    NP = B * MP + 1
    kp = torch.randn((NP, ps, Hkv, D), generator=g, device=dev).to(dtype)
    vp = torch.randn((NP, ps, Hkv, D), generator=g, device=dev).to(dtype)
    table = (torch.randperm(NP - 1, generator=g, device=dev) + 1
             ).reshape(B, MP).to(torch.int32)
    if lengths is None:
        lengths = torch.randint(0, MP * ps - T + 1, (B,), generator=g,
                                device=dev).to(torch.int32)
    else:
        lengths = torch.tensor(lengths, dtype=torch.int32, device=dev)
    q = torch.randn((B, T, Hq, D), generator=g, device=dev).to(dtype)
    return q, kp, vp, lengths, table


# lengths of a 4096-key table: one live split (5, 200) and many (1234, 4000)
SPLIT_LENGTHS = [5, 200, 1234, 4096 - 8]


@pytest.mark.parametrize("ps", [8, 16, 64, 24, 12])
@pytest.mark.parametrize("T", [1, 5, 8])
@pytest.mark.parametrize("Hq,Hkv", [(28, 4), (8, 2)])
@pytest.mark.parametrize("D", [64, 128])
def test_paged_sm90_kernel_matches_plain(cuda, ps, T, Hq, Hkv, D):
    """The bf16 split-KV TMA + wgmma body: pages of 8, 16 and 64, of 24
    (TMA boxes of 8 rows) and of 12 (chunks staged by cp.async), T 1, 5 and
    8 at g 7 and 4, head dims 64 and 128, over a 4096-key table with rows
    that have one live split and rows that have many (combined)."""
    from repro_torch.kernels.decode_attention import paged
    from repro_torch.kernels.decode_attention.ref import \
        paged_decode_attention_plain
    case = _paged_case(cuda, torch.bfloat16, B=4, Hq=Hq, Hkv=Hkv, D=D, T=T,
                       ps=ps, MP=-(-4096 // ps), seed=ps + T + D,
                       lengths=SPLIT_LENGTHS)
    before = paged.LAUNCHES["paged_decode_attention"]
    out = paged.paged_decode_attention(*case)
    torch.cuda.synchronize()
    assert paged.LAUNCHES["paged_decode_attention"] == before + 1
    assert paged.LAST_ROUTE["paged_decode_attention"] == "sm90"
    ref = paged_decode_attention_plain(*case)
    tol = PAGED_TOL[torch.bfloat16]
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    _assert_rows_close(out, ref, PAGED_ROW_TOL)


@pytest.mark.parametrize("ps", [8, 16, 64, 24, 12, 7])
def test_paged_sm90_kernel_ignores_poisoned_stale_and_trash_pages(cuda, ps):
    """bf16: NaN in every position past length + T - 1 (the rest of the
    last page, the pages beyond) and in the trash page: the split-KV body's
    output must not move by one bit, split by split and combined, whether
    TMA boxes (pages of 8, 16, 64, 24) or cp.async (12, 7) fill its ring."""
    from repro_torch.kernels.decode_attention import paged
    q, kp, vp, lengths, table = _paged_case(
        cuda, torch.bfloat16, B=4, Hq=28, Hkv=4, D=128, T=5, ps=ps,
        MP=-(-4096 // ps), seed=ps, lengths=SPLIT_LENGTHS)
    before = paged.paged_decode_attention(q, kp, vp, lengths, table)
    pk, pv = kp.clone(), vp.clone()
    pk[0], pv[0] = float("nan"), float("inf")
    for b, n in enumerate(SPLIT_LENGTHS):
        first_dead = n + 5
        for lp in range(table.shape[1]):
            lo = max(0, first_dead - lp * ps)
            if lo < ps:
                page = int(table[b, lp])
                pk[page, lo:], pv[page, lo:] = float("nan"), float("nan")
    after = paged.paged_decode_attention(q, pk, pv, lengths, table)
    assert paged.LAST_ROUTE["paged_decode_attention"] == "sm90"
    assert torch.isfinite(after).all()
    torch.testing.assert_close(after, before, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [32, 64, 128, 256])
@pytest.mark.parametrize("T,ps,cap", [(1, 16, 0.0), (5, 64, 0.0),
                                      (8, 8, 30.0), (3, 64, 30.0),
                                      (5, 48, 0.0), (5, 20, 30.0)])
def test_paged_attention_kernel_matches_plain(cuda, dtype, D, T, ps, cap):
    from repro_torch.kernels.decode_attention import paged
    from repro_torch.kernels.decode_attention.ref import \
        paged_decode_attention_plain
    case = _paged_case(cuda, dtype, B=3, Hq=28, Hkv=4, D=D, T=T, ps=ps,
                       MP=5, seed=D + T)
    before = paged.LAUNCHES["paged_decode_attention"]
    out = paged.paged_decode_attention(*case, logit_cap=cap)
    torch.cuda.synchronize()
    assert paged.LAUNCHES["paged_decode_attention"] == before + 1
    # bf16 runs the split-KV TMA + wgmma body at every head dim (32 to 256)
    # and page size, fp32 the split-KV CUDA-core body
    assert paged.LAST_ROUTE["paged_decode_attention"] == (
        "sm90" if dtype == torch.bfloat16 else "f32")
    ref = paged_decode_attention_plain(*case, logit_cap=cap)
    tol = PAGED_TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    if dtype == torch.bfloat16:
        _assert_rows_close(out, ref, PAGED_ROW_TOL)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_paged_attention_kernel_long_context_and_no_sync(cuda, dtype):
    """~8k cached positions at the serve widths, with the device never
    waiting on the host for lengths or the table.  A typical |out| there is
    ~0.02, near the bf16 bound, so fp32 holds the split-KV CUDA-core body
    (several splits and the fp32 combine) at 2e-5 and bf16 (the TMA +
    wgmma body) is also held at PAGED_ROW_TOL x each row's rms."""
    from repro_torch.kernels.decode_attention import paged
    from repro_torch.kernels.decode_attention.ref import \
        paged_decode_attention_plain
    case = _paged_case(cuda, dtype, B=2, Hq=28, Hkv=4, D=128, T=5,
                       ps=64, MP=130, seed=3)
    paged.paged_decode_attention(*case)               # build + load first
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = paged.paged_decode_attention(*case)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    ref = paged_decode_attention_plain(*case)
    tol = PAGED_TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    assert paged.LAST_ROUTE["paged_decode_attention"] == (
        "sm90" if dtype == torch.bfloat16 else "f32")
    if dtype == torch.bfloat16:
        _assert_rows_close(out, ref, PAGED_ROW_TOL)


@pytest.mark.parametrize("ps", [16, 64, 24])
@pytest.mark.parametrize("T,Hq,Hkv,D", [(5, 28, 4, 128), (1, 28, 4, 128),
                                        (5, 16, 8, 256), (8, 8, 2, 64),
                                        (5, 4, 2, 32)])
def test_paged_f32_kernel_long_table(cuda, ps, T, Hq, Hkv, D):
    """The fp32 split-KV CUDA-core body over a long table (4096 keys and
    up): pages of 16 and 64, and of 24, which tile no 64-key chunk and take
    the same body, rows with one live split and rows with many (the
    fp32 combine), at the target's, gemma3's, a draft's and the reduced
    draft's heads (of 32), at the
    reference's 2e-5; then NaN past every row's last key and in the trash
    page must not move the output by one bit."""
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attention import paged
    from repro_torch.kernels.decode_attention.ref import \
        paged_decode_attention_plain
    MP = -(-4096 // ps)
    q, kp, vp, lengths, table = _paged_case(
        cuda, torch.float32, B=4, Hq=Hq, Hkv=Hkv, D=D, T=T, ps=ps,
        MP=MP, seed=ps + T + D, lengths=SPLIT_LENGTHS)
    out = paged.paged_decode_attention(q, kp, vp, lengths, table)
    torch.cuda.synchronize()
    assert paged.LAST_ROUTE["paged_decode_attention"] == "f32"
    assert build.load(paged.SOURCE).paged_decode_attention_scratch_bytes(
        1, D, 4, T, Hq, Hkv, ps, MP) > 0
    ref = paged_decode_attention_plain(q, kp, vp, lengths, table)
    tol = PAGED_TOL[torch.float32]
    torch.testing.assert_close(out, ref, rtol=tol, atol=tol)
    pk, pv = kp.clone(), vp.clone()
    pk[0], pv[0] = float("nan"), float("inf")
    for b, n in enumerate(SPLIT_LENGTHS):
        first_dead = n + T
        for lp in range(table.shape[1]):
            lo = max(0, first_dead - lp * ps)
            if lo < ps:
                page = int(table[b, lp])
                pk[page, lo:], pv[page, lo:] = float("nan"), float("nan")
    after = paged.paged_decode_attention(q, pk, pv, lengths, table)
    assert torch.isfinite(after).all()
    torch.testing.assert_close(after, out, rtol=0, atol=0)


@pytest.mark.parametrize("ps", [12, 24, 48])
@pytest.mark.parametrize("D", [64, 128, 256])
def test_paged_odd_page_sizes_take_the_sm90_body(cuda, ps, D):
    """Pages that tile no 64-key chunk: bf16 takes the split-KV TMA + wgmma
    body at every head dim (boxes of gcd(ps, 64) rows, 8 on pages of 24, 16
    on pages of 48; on pages of 12 the chunks staged by cp.async), gemma3's
    16 / 8 heads at 256 on pages of 48 included, where the old body refused
    the call; held at PAGED_TOL and PAGED_ROW_TOL over a table of ~1600
    keys (one split and several)."""
    from repro_torch.kernels.decode_attention import paged
    from repro_torch.kernels.decode_attention.ref import \
        paged_decode_attention_plain
    Hq, Hkv = (16, 8) if D == 256 else (28, 4)
    case = _paged_case(cuda, torch.bfloat16, B=4, Hq=Hq, Hkv=Hkv, D=D, T=5,
                       ps=ps, MP=-(-1650 // ps), seed=ps + D,
                       lengths=[3, 700, 1100, 1640])
    out = paged.paged_decode_attention(*case)
    torch.cuda.synchronize()
    assert paged.LAST_ROUTE["paged_decode_attention"] == "sm90"
    ref = paged_decode_attention_plain(*case)
    tol = PAGED_TOL[torch.bfloat16]
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    _assert_rows_close(out, ref, PAGED_ROW_TOL)


def test_paged_gather_refused_on_cuda(cuda):
    """On the card the paged verify path runs the kernel: the gather
    cross-check is refused at construction and in the layer itself."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import attention
    from repro_torch.models.model import Model
    cfg = get_config("qwen2-57b-a14b", reduced=True)
    with pytest.raises(ValueError, match="CPU cross-check"):
        Model(cfg, paged_attention="gather", device="cuda")
    m = Model(cfg, device="cuda")
    p = m.init(torch.Generator(device=cuda).manual_seed(0))["layers"][0]
    cache = attention.make_attn_cache(cfg, 2, 32, "attn", m.dtype, cuda,
                                      paged=True, page_size=16)
    table = torch.arange(1, 5, dtype=torch.int32, device=cuda).reshape(2, 2)
    x = torch.randn((2, 5, cfg.d_model), device=cuda).to(m.dtype)
    pos = torch.arange(5, device=cuda)[None].expand(2, 5)
    with pytest.raises(ValueError, match="CPU cross-check"):
        attention.gqa_forward(p["mixer"], cfg, x, pos, cache=cache,
                              mode="extend", page_table=table,
                              paged_attention="gather")


def test_paged_attention_kernel_masks_stale_pages(cuda):
    """Poison every position past length + T - 1 and the trash page: the
    kernel's output must not move."""
    from repro_torch.kernels.decode_attention import paged
    q, kp, vp, lengths, table = _paged_case(
        cuda, torch.float32, B=3, Hq=8, Hkv=2, D=64, T=2, ps=8, MP=4, seed=9)
    before = paged.paged_decode_attention(q, kp, vp, lengths, table)
    pk, pv = kp.clone(), vp.clone()
    pk[0], pv[0] = 1e3, -1e3
    for b in range(3):
        first_dead = int(lengths[b]) + 2
        for lp in range(4):
            lo = max(0, first_dead - lp * 8)
            if lo < 8:
                page = int(table[b, lp])
                pk[page, lo:], pv[page, lo:] = 1e3, -1e3
    after = paged.paged_decode_attention(q, pk, pv, lengths, table)
    torch.testing.assert_close(after, before, rtol=2e-5, atol=2e-5)


# ------------------------------------------------- flash prefill attention
# the reference's bounds (tests/test_kernels.py): fp32 2e-5, bf16 3e-2 for
# flash; fp32 3e-5, bf16 4e-2 for dense decode; both sides accumulate in
# fp32, the kernel's bf16 path also rounds P to bf16 before the PV product.
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
DECODE_TOL = {torch.float32: 3e-5, torch.bfloat16: 4e-2}
# bf16 flash, besides FLASH_TOL: every element within 5e-2 x the rms of its
# output row (chip_smoke.FLASH_ROW_TOL).  Late rows of a long prefill are
# ~1/sqrt(t + 1), below 3e-2; a stale or skipped 128-key chunk moves them by
# ~18 % of their rms, one bf16 rounding of a row's largest element ~3 %.
FLASH_ROW_TOL = 5e-2


def _assert_rows_close(out, ref, bound=FLASH_ROW_TOL):
    ref = ref.float()
    rms = ref.square().mean(-1, keepdim=True).sqrt()
    worst = ((out.float() - ref).abs() / rms).max().item()
    assert worst <= bound, (
        f"an element is {worst:.3g} x the rms of its row from the plain "
        f"version (bound {bound})")


def _randn(dev, shape, dtype, g):
    return torch.randn(shape, generator=g, device=dev).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,window,cap", [(256, 0, 0.0), (256, 100, 0.0),
                                          (512, 0, 30.0), (128, 64, 20.0)])
def test_flash_kernel_matches_plain(cuda, dtype, T, window, cap):
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    g = torch.Generator(device=cuda).manual_seed(T + window)
    q = _randn(cuda, (2, 4, T, 64), dtype, g)
    k, v = (_randn(cuda, (2, 2, T, 64), dtype, g) for _ in range(2))
    before = fa.LAUNCHES["flash_attention"]
    out = fa.flash_attention_bhtd(q, k, v, causal=True, window=window,
                                  logit_cap=cap)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == before + 1
    ref = flash_attention_ref(q, k, v, causal=True, window=window,
                              logit_cap=cap)
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Hq,Hkv,D,T", [(2, 2, 32, 256), (7, 1, 128, 128),
                                        (14, 2, 64, 256), (28, 4, 128, 384)])
def test_flash_kernel_model_layout_and_non_causal(cuda, dtype, Hq, Hkv, D, T):
    """The (B, T, H, D) wrapper the model calls, read in place, causal and
    not, at the serve models' groupings (g = 7, head dims 64 and 128)."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain
    g = torch.Generator(device=cuda).manual_seed(Hq * D)
    q = _randn(cuda, (2, T, Hq, D), dtype, g)
    k, v = (_randn(cuda, (2, T, Hkv, D), dtype, g) for _ in range(2))
    tol = FLASH_TOL[dtype]
    for causal in (True, False):
        out = ops.flash_attention(q, k, v, causal=causal)
        # the kernel the launcher reports it ran
        assert fa.LAST_ROUTE["flash_attention"] == (
            "sm90" if dtype == torch.bfloat16 else "f32")
        ref = flash_attention_plain(q, k, v, causal=causal)
        torch.testing.assert_close(out.float(), ref.float(), rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("T", [64, 128, 256, 4096])
@pytest.mark.parametrize("D", [32, 64, 128])
def test_flash_sm90_kernel_matches_plain(cuda, T, D):
    """The bf16 TMA + wgmma kernel in the model's (B, T, H, D) layout with
    B > 1: T below one 128-query tile (zero fill, masked stores), one tile,
    several, and a long prefill, at every head dim it is built for."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain
    g = torch.Generator(device=cuda).manual_seed(T + D)
    B = 2 if T < 4096 else 1
    q = _randn(cuda, (B, T, 4, D), torch.bfloat16, g)
    k, v = (_randn(cuda, (B, T, 2, D), torch.bfloat16, g) for _ in range(2))
    before = fa.LAUNCHES["flash_attention"]
    out = ops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == before + 1
    assert fa.LAST_ROUTE["flash_attention"] == "sm90"
    ref = flash_attention_plain(q, k, v)
    tol = FLASH_TOL[torch.bfloat16]
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    _assert_rows_close(out, ref)


@pytest.mark.parametrize("causal,window,cap", [(True, 256, 30.0),
                                               (True, 100, 0.0),
                                               (False, 0, 20.0)])
def test_flash_sm90_kernel_gqa7_window_cap_non_causal(cuda, causal, window,
                                                      cap):
    """Seven query heads per KV head, B 3, windows that start blocks past
    key 0 and cross chunk edges, the tanh cap, and every key (non-causal)."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain
    g = torch.Generator(device=cuda).manual_seed(window + int(cap))
    q = _randn(cuda, (3, 512, 14, 128), torch.bfloat16, g)
    k, v = (_randn(cuda, (3, 512, 2, 128), torch.bfloat16, g)
            for _ in range(2))
    kw = dict(causal=causal, window=window, logit_cap=cap)
    out = ops.flash_attention(q, k, v, **kw)
    ref = flash_attention_plain(q, k, v, **kw)
    tol = FLASH_TOL[torch.bfloat16]
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    _assert_rows_close(out, ref)


# ------------------------------------------------ dense decode/verify attention
@pytest.mark.parametrize("T", [1, 4, 5])
@pytest.mark.parametrize("g", [1, 2, 4, 7])
def test_decode_kernel_matches_plain(cuda, T, g):
    from repro_torch.kernels.decode_attention import ops
    from repro_torch.kernels.decode_attention.ref import decode_attention_plain
    gen = torch.Generator(device=cuda).manual_seed(10 * g + T)
    B, Hkv, S, D = 3, 2, 1024, 64
    q = _randn(cuda, (B, T, Hkv * g, D), torch.float32, gen)
    k, v = (_randn(cuda, (B, S, Hkv, D), torch.float32, gen) for _ in range(2))
    lengths = torch.tensor([17, 512, 1024 - T], dtype=torch.int32, device=cuda)
    before = ops.LAUNCHES["decode_attention"]
    out = ops.decode_attention(q, k, v, lengths)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["decode_attention"] == before + 1
    ref = decode_attention_plain(q, k, v, lengths)
    tol = DECODE_TOL[torch.float32]
    torch.testing.assert_close(out, ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Hq,Hkv,D,T", [(4, 2, 128, 3), (28, 4, 128, 5),
                                        (14, 2, 64, 1), (4, 2, 32, 5)])
def test_decode_kernel_on_the_cache_layout_with_trash_slot(cuda, dtype, Hq,
                                                           Hkv, D, T):
    """The model's (B, S+1, Hkv, D) cache sliced to S, read in place; slot S
    holds huge values and row 2's positions pass S: neither shows."""
    from repro_torch.kernels.decode_attention import ops
    from repro_torch.kernels.decode_attention.ref import decode_attention_plain
    gen = torch.Generator(device=cuda).manual_seed(Hq + D + T)
    B, S = 3, 512
    q = _randn(cuda, (B, T, Hq, D), dtype, gen)
    kc, vc = (_randn(cuda, (B, S + 1, Hkv, D), dtype, gen) for _ in range(2))
    kc[:, S], vc[:, S] = 1e3, -1e3
    lengths = torch.tensor([129, 290, S - 2], dtype=torch.int32, device=cuda)
    out = ops.decode_attention(q, kc[:, :S], vc[:, :S], lengths)
    ref = decode_attention_plain(q, kc[:, :S], vc[:, :S], lengths)
    tol = DECODE_TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


def test_decode_kernel_never_syncs(cuda):
    """A verify at the serve widths with the device never waiting on the
    host: lengths stay on the device."""
    from repro_torch.kernels.decode_attention import ops
    from repro_torch.kernels.decode_attention.ref import decode_attention_plain
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = _randn(cuda, (8, 5, 28, 128), torch.bfloat16, gen)
    k, v = (_randn(cuda, (8, 512, 4, 128), torch.bfloat16, gen)
            for _ in range(2))
    lengths = torch.randint(129, 291, (8,), generator=gen, device=cuda
                            ).to(torch.int32)
    ops.decode_attention(q, k, v, lengths)           # build + load first
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = ops.decode_attention(q, k, v, lengths)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    ref = decode_attention_plain(q, k, v, lengths)
    torch.testing.assert_close(out.float(), ref.float(), rtol=4e-2, atol=4e-2)


def test_decode_kernel_matches_plain_at_sd_verify(cuda):
    """The dense decode kernel, whose body the flash kernel no longer
    shares, at the serve SD verify (B 8, T 5, 28/4 heads of 128, S 512,
    lengths 129-290) in bf16 at the reference's 4e-2."""
    from repro_torch.kernels.decode_attention import ops
    from repro_torch.kernels.decode_attention.ref import decode_attention_plain
    gen = torch.Generator(device=cuda).manual_seed(5)
    q = _randn(cuda, (8, 5, 28, 128), torch.bfloat16, gen)
    kc, vc = (_randn(cuda, (8, 513, 4, 128), torch.bfloat16, gen)
              for _ in range(2))
    lengths = torch.randint(129, 291, (8,), generator=gen, device=cuda
                            ).to(torch.int32)
    before = ops.LAUNCHES["decode_attention"]
    out = ops.decode_attention(q, kc[:, :512], vc[:, :512], lengths)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["decode_attention"] == before + 1
    ref = decode_attention_plain(q, kc[:, :512], vc[:, :512], lengths)
    tol = DECODE_TOL[torch.bfloat16]
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


# bf16 dense decode on the split-KV body, besides DECODE_TOL: every element
# within 5e-2 x the rms of its output row (chip_smoke.DECODE_ROW_TOL).  At
# 8k keys |out| ~ 0.011, below 4e-2; a dropped split or a stale 64-key chunk
# moves an element by more than the row's rms (kernel_variants.py mutants).
DECODE_ROW_TOL = 5e-2


def _decode_case(dev, *, B, T, Hq, Hkv, D, S, lengths, seed=0):
    """q and the model's (B, S+1, Hkv, D) cache sliced to S, bf16, noise
    everywhere (the trash slot S included)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = _randn(dev, (B, T, Hq, D), torch.bfloat16, gen)
    kc, vc = (_randn(dev, (B, S + 1, Hkv, D), torch.bfloat16, gen)
              for _ in range(2))
    lengths = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, kc, vc, lengths


@pytest.mark.parametrize("S", [512, 8192])
@pytest.mark.parametrize("g", [1, 2, 4, 7])
@pytest.mark.parametrize("T", [1, 2, 5])
@pytest.mark.parametrize("D", [32, 64, 128, 256])
def test_decode_sm90_kernel_matches_plain(cuda, D, T, g, S):
    """The bf16 split-KV TMA + wgmma body of the dense decode kernel on the
    cache layout, at every head dim it takes, T 1, 2, 5 and g 1, 2, 4, 7: at S 512
    one split, at S 8192 several, with rows whose keys fit split 0, rows
    that span every split and a row whose queries run past S."""
    from repro_torch.kernels.decode_attention import ops
    from repro_torch.kernels.decode_attention.ref import decode_attention_plain
    lengths = [5, S // 2 - 3, S - T - 1, S - 2][:4]
    q, kc, vc, lengths = _decode_case(cuda, B=4, T=T, Hq=2 * g, Hkv=2, D=D,
                                      S=S, lengths=lengths, seed=D + T + g)
    k, v = kc[:, :S], vc[:, :S]
    before = ops.LAUNCHES["decode_attention"]
    out = ops.decode_attention(q, k, v, lengths)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["decode_attention"] == before + 1
    assert ops.LAST_ROUTE["decode_attention"] == "sm90"
    ref = decode_attention_plain(q, k, v, lengths)
    tol = DECODE_TOL[torch.bfloat16]
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    _assert_rows_close(out, ref, DECODE_ROW_TOL)


@pytest.mark.parametrize("S", [512, 8192])
@pytest.mark.parametrize("D,Hq,Hkv", [(128, 28, 4), (256, 16, 8)])
def test_decode_sm90_kernel_ignores_poisoned_stale_keys_and_trash_slot(
        cuda, S, D, Hq, Hkv):
    """bf16: NaN and Inf in every cache position past length + T - 1 and in
    the trash slot S: the split-KV body's output must not move by one bit,
    with one split and with several combined (the target's heads of 128
    and gemma3-12b's of 256)."""
    from repro_torch.kernels.decode_attention import ops
    T = 5
    lens = [3, 200, S // 2 + 7, S - 2]
    q, kc, vc, lengths = _decode_case(cuda, B=4, T=T, Hq=Hq, Hkv=Hkv, D=D,
                                      S=S, lengths=lens, seed=S)
    before = ops.decode_attention(q, kc[:, :S], vc[:, :S], lengths)
    pk, pv = kc.clone(), vc.clone()
    for b, n in enumerate(lens):
        pk[b, n + T:], pv[b, n + T:] = float("nan"), float("inf")
    pk[:, S], pv[:, S] = float("inf"), float("nan")
    after = ops.decode_attention(q, pk[:, :S], pv[:, :S], lengths)
    assert ops.LAST_ROUTE["decode_attention"] == "sm90"
    assert torch.isfinite(after).all()
    torch.testing.assert_close(after, before, rtol=0, atol=0)


@pytest.mark.parametrize("dtype,D,g,T,route", [
    (torch.bfloat16, 128, 7, 5, "sm90"), (torch.bfloat16, 64, 7, 1, "sm90"),
    (torch.bfloat16, 64, 8, 8, "sm90"), (torch.bfloat16, 32, 7, 5, "sm90"),
    (torch.bfloat16, 128, 7, 10, "sm90"), (torch.bfloat16, 256, 2, 5, "sm90"),
    (torch.bfloat16, 256, 1, 1, "sm90"), (torch.bfloat16, 256, 2, 33, "sm90"),
    (torch.bfloat16, 32, 2, 40, "sm90"),
    (torch.float32, 128, 7, 5, "f32"), (torch.float32, 64, 2, 1, "f32"),
    (torch.float32, 32, 2, 5, "f32")])
def test_decode_kernel_routes_are_what_the_launcher_reports(cuda, dtype, D,
                                                            g, T, route):
    """bf16 at every head dim, 32 to 256, takes the split-KV TMA + wgmma
    body at any g * T (row tiles past 64 rows), fp32 the split-KV CUDA-core
    body: each as the launcher reports it, each against the plain
    version."""
    from repro_torch.kernels.decode_attention import ops
    from repro_torch.kernels.decode_attention.ref import decode_attention_plain
    gen = torch.Generator(device=cuda).manual_seed(D + g + T)
    B, Hkv, S = 2, 2, 1024
    q = _randn(cuda, (B, T, Hkv * g, D), dtype, gen)
    k, v = (_randn(cuda, (B, S, Hkv, D), dtype, gen) for _ in range(2))
    lengths = torch.tensor([40, 1000 - T], dtype=torch.int32, device=cuda)
    out = ops.decode_attention(q, k, v, lengths)
    assert ops.LAST_ROUTE["decode_attention"] == route
    ref = decode_attention_plain(q, k, v, lengths)
    tol = DECODE_TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


def test_decode_sm90_kernel_with_combine_never_syncs(cuda):
    """The long-context case (several splits, the combine kernel and its
    scratch from torch's allocator) with the device never waiting on the
    host."""
    from repro_torch.kernels.decode_attention import ops
    from repro_torch.kernels.decode_attention.ref import decode_attention_plain
    S = 8192
    q, kc, vc, lengths = _decode_case(cuda, B=8, T=5, Hq=28, Hkv=4, D=128,
                                      S=S, lengths=[8000 + 20 * b
                                                    for b in range(8)],
                                      seed=11)
    k, v = kc[:, :S], vc[:, :S]
    ops.decode_attention(q, k, v, lengths)           # build + load first
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = ops.decode_attention(q, k, v, lengths)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert ops.LAST_ROUTE["decode_attention"] == "sm90"
    ref = decode_attention_plain(q, k, v, lengths)
    tol = DECODE_TOL[torch.bfloat16]
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    _assert_rows_close(out, ref, DECODE_ROW_TOL)


# (g, T) of more than 64 query rows a KV head: 65 (g 13 at gamma 4), 70
# (qwen2-57b-a14b's g 7 at gamma 9), 119 (gamma 16), 231 (gamma 32)
WIDE_ROWS = [(13, 5), (7, 10), (7, 17), (7, 33)]
WIDE_ROUTE = {torch.bfloat16: "sm90", torch.float32: "f32"}


@pytest.mark.parametrize("S", [512, 8192])
@pytest.mark.parametrize("g,T", WIDE_ROWS)
@pytest.mark.parametrize("D", [128, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_row_tiles_match_plain(cuda, dtype, D, g, T, S):
    """More than 64 query rows a KV head, cut into row tiles: the bf16 TMA
    + wgmma body and the fp32 CUDA-core body on the cache layout, at one
    split (S 512) and several (S 8192), with a row at length 0, one whose
    last query sits at S - 1, one whose queries run past S and one in the
    middle; bf16 also at DECODE_ROW_TOL x each row's rms."""
    from repro_torch.kernels.decode_attention import ops
    from repro_torch.kernels.decode_attention.ref import decode_attention_plain
    lens = [0, S - T, S - 2, S // 2 + 3]
    gen = torch.Generator(device=cuda).manual_seed(D + g + T + S)
    q = _randn(cuda, (4, T, 2 * g, D), dtype, gen)
    kc, vc = (_randn(cuda, (4, S + 1, 2, D), dtype, gen) for _ in range(2))
    kc[:, S], vc[:, S] = 1e3, -1e3
    k, v = kc[:, :S], vc[:, :S]
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    before = ops.LAUNCHES["decode_attention"]
    out = ops.decode_attention(q, k, v, lengths)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["decode_attention"] == before + 1
    assert ops.LAST_ROUTE["decode_attention"] == WIDE_ROUTE[dtype]
    ref = decode_attention_plain(q, k, v, lengths)
    tol = DECODE_TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    if dtype == torch.bfloat16:
        _assert_rows_close(out, ref, DECODE_ROW_TOL)


@pytest.mark.parametrize("D", [32, 64, 128, 256])
@pytest.mark.parametrize("T,g", [(1, 7), (5, 7), (5, 2), (9, 1)])
@pytest.mark.parametrize("S", [512, 8192])
def test_decode_f32_kernel_matches_plain(cuda, D, T, g, S):
    """The fp32 split-KV CUDA-core body at every head dim it takes, with
    AR steps and verifies of 7 to 35 rows a KV head (key groups of 8, 4, 2
    and 1 warps), at one split and several (the fp32 combine), on the cache
    layout with a poisoned trash slot, at the reference's 3e-5; then NaN and
    Inf past every row's last key must not move the output by one bit."""
    from repro_torch.kernels.decode_attention import ops
    from repro_torch.kernels.decode_attention.ref import decode_attention_plain
    gen = torch.Generator(device=cuda).manual_seed(D + T + g + S)
    lens = [5, S // 2 - 3, S - T - 1, S - 2]
    q = _randn(cuda, (4, T, 2 * g, D), torch.float32, gen)
    kc, vc = (_randn(cuda, (4, S + 1, 2, D), torch.float32, gen)
              for _ in range(2))
    kc[:, S], vc[:, S] = 1e3, -1e3
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    out = ops.decode_attention(q, kc[:, :S], vc[:, :S], lengths)
    torch.cuda.synchronize()
    assert ops.LAST_ROUTE["decode_attention"] == "f32"
    ref = decode_attention_plain(q, kc[:, :S], vc[:, :S], lengths)
    tol = DECODE_TOL[torch.float32]
    torch.testing.assert_close(out, ref, rtol=tol, atol=tol)
    pk, pv = kc.clone(), vc.clone()
    for b, n in enumerate(lens):
        pk[b, n + T:], pv[b, n + T:] = float("nan"), float("inf")
    after = ops.decode_attention(q, pk[:, :S], pv[:, :S], lengths)
    assert torch.isfinite(after).all()
    torch.testing.assert_close(after, out, rtol=0, atol=0)


@pytest.mark.parametrize("dtype,D,g,T", [
    (torch.bfloat16, 128, 7, 10), (torch.bfloat16, 256, 2, 33),
    (torch.float32, 128, 7, 5), (torch.float32, 128, 7, 10),
    (torch.float32, 256, 2, 5), (torch.bfloat16, 32, 2, 5),
    (torch.float32, 32, 2, 5)])
@pytest.mark.parametrize("blocks", [2, 4])
def test_partial_entry_on_row_tiles_and_fp32(cuda, dtype, D, g, T, blocks):
    """Kernel 4's partial entry where g * T > 64 (row tiles), in fp32
    (the CUDA-core body's partials, its lse from the fp32 combine) and at
    head dim 32 (the split-KV bodies there too, lse from the combine): each
    block against its plain version (the lse -inf exactly where the plain
    one's is), the blocks merged by log-sum-exp against the whole plain
    call."""
    from repro_torch.distributed.collectives import lse_combine
    from repro_torch.kernels.decode_attention import ops
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_partial_plain, decode_attention_plain)
    gen = torch.Generator(device=cuda).manual_seed(D + g + T + blocks)
    B, S = 4, 2048
    q = _randn(cuda, (B, T, 2 * g, D), dtype, gen)
    k, v = (_randn(cuda, (B, S, 2, D), dtype, gen) for _ in range(2))
    lengths = torch.tensor([17, 700, 1300, S - T], dtype=torch.int32,
                           device=cuda)
    n = S // blocks
    outs, lses = [], []
    tol = DECODE_TOL[dtype]
    for i in range(blocks):
        kb, vb = k[:, i * n:(i + 1) * n], v[:, i * n:(i + 1) * n]
        out, lse = ops.decode_attention_partial(q, kb, vb, lengths,
                                                k_lo=i * n)
        assert ops.LAST_ROUTE["decode_attention_partial"] == WIDE_ROUTE[dtype]
        p_out, p_lse = decode_attention_partial_plain(q, kb, vb, lengths,
                                                      k_lo=i * n)
        torch.cuda.synchronize()
        torch.testing.assert_close(out.float(), p_out.float(), rtol=tol,
                                   atol=tol)
        assert torch.equal(torch.isinf(lse), torch.isinf(p_lse))
        fin = torch.isfinite(p_lse)
        torch.testing.assert_close(lse[fin], p_lse[fin], rtol=tol, atol=tol)
        outs.append(out)
        lses.append(lse)
    merged = lse_combine(torch.stack(outs), torch.stack(lses))
    torch.testing.assert_close(
        merged.float(), decode_attention_plain(q, k, v, lengths).float(),
        rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype,T", [(torch.bfloat16, 10), (torch.float32, 5),
                                     (torch.float32, 10)])
def test_decode_row_tiles_and_f32_capture_without_sync(cuda, dtype, T):
    """The new routes in a CUDA graph: a row-tiled bf16 verify (70 rows)
    and fp32 verifies at 8k keys (several splits, the combine, scratch from
    torch's allocator), captured with the device never waiting on the host
    and replayed on new inputs to the eager call's bits."""
    from repro_torch.kernels.decode_attention import ops
    gen = torch.Generator(device=cuda).manual_seed(T)
    B, S = 8, 8192
    q = _randn(cuda, (B, T, 28, 128), dtype, gen)
    k, v = (_randn(cuda, (B, S, 4, 128), dtype, gen) for _ in range(2))
    lengths = torch.randint(7900, S - T, (B,), generator=gen, device=cuda
                            ).to(torch.int32)
    ops.decode_attention(q, k, v, lengths)           # build + load first
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ops.decode_attention(q, k, v, lengths)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.cuda.graph(graph):
            out = ops.decode_attention(q, k, v, lengths)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert ops.LAST_ROUTE["decode_attention"] == WIDE_ROUTE[dtype]
    q.copy_(_randn(cuda, q.shape, dtype, gen))
    lengths.copy_(torch.randint(7000, S - T, (B,), generator=gen,
                                device=cuda).to(torch.int32))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, ops.decode_attention(q, k, v, lengths))


@pytest.mark.parametrize("causal,window,cap", [(True, 300, 30.0),
                                               (False, 0, 20.0)])
def test_flash_sm90_wide_items_window_cap_non_causal(cuda, causal, window,
                                                     cap):
    """Past NARROW_MAX_T queries the kernel runs 128-query items on two
    consumer warpgroups: a window that starts items past key 0 and crosses
    chunk edges, the tanh cap, and every key (non-causal), at g 7."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain
    T = 2 * fa.NARROW_MAX_T
    g = torch.Generator(device=cuda).manual_seed(window + int(cap) + T)
    q = _randn(cuda, (2, T, 14, 128), torch.bfloat16, g)
    k, v = (_randn(cuda, (2, T, 2, 128), torch.bfloat16, g) for _ in range(2))
    kw = dict(causal=causal, window=window, logit_cap=cap)
    out = ops.flash_attention(q, k, v, **kw)
    assert fa.LAST_ROUTE["flash_attention"] == "sm90"
    ref = flash_attention_plain(q, k, v, **kw)
    tol = FLASH_TOL[torch.bfloat16]
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    _assert_rows_close(out, ref)


@pytest.mark.parametrize("B,T,Hq,Hkv,D", [(8, 256, 28, 4, 128),
                                          (8, 256, 14, 2, 64),
                                          (3, 384, 7, 1, 32)])
def test_flash_sm90_persistent_grid_at_short_prefills(cuda, B, T, Hq, Hkv,
                                                      D):
    """The persistent bf16 kernel at the serve prefills (8 prompts of 256
    tokens at the target's and the draft's heads: 64-query items, two
    blocks an SM), where every block runs several items and the ring and
    both Q buffers turn over many times."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain
    g = torch.Generator(device=cuda).manual_seed(B * T + D)
    q = _randn(cuda, (B, T, Hq, D), torch.bfloat16, g)
    k, v = (_randn(cuda, (B, T, Hkv, D), torch.bfloat16, g) for _ in range(2))
    out = ops.flash_attention(q, k, v)
    assert fa.LAST_ROUTE["flash_attention"] == "sm90"
    ref = flash_attention_plain(q, k, v)
    tol = FLASH_TOL[torch.bfloat16]
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    _assert_rows_close(out, ref)


def test_attention_wrappers_raise_on_unsupported_head_dim(cuda):
    """No fallback: a head dim the kernels are not built for raises on the
    card instead of taking the plain version."""
    from repro_torch.kernels.decode_attention import ops as dec
    from repro_torch.kernels.flash_attention import ops as fl
    q = torch.zeros((1, 128, 2, 96), device=cuda)
    kv = torch.zeros((1, 128, 2, 96), device=cuda)
    from repro_torch.kernels.flash_attention import flash_attention as fa
    before = (fa.LAUNCHES["flash_attention"], dec.LAUNCHES["decode_attention"])
    with pytest.raises(ValueError, match="head dims"):
        fl.flash_attention(q, kv, kv)
    with pytest.raises(ValueError, match="head dims"):
        dec.decode_attention(q[:, :5], kv, kv,
                             torch.zeros((1,), dtype=torch.int32, device=cuda))
    assert (fa.LAUNCHES["flash_attention"],
            dec.LAUNCHES["decode_attention"]) == before


# ------------------------------------- head dim 256 (gemma-7b, gemma3-12b)
# flash: TMA + wgmma in bf16, flash_f32.cuh's CUDA cores in fp32; dense
# decode: TMA + wgmma in bf16, decode_f32.cuh's CUDA cores in fp32
D256_ROUTE = {torch.bfloat16: "sm90", torch.float32: "f32"}
DECODE_D256_ROUTE = {torch.bfloat16: "sm90", torch.float32: "f32"}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("Hq,Hkv", [(16, 8), (16, 16)])
@pytest.mark.parametrize("T,window", [(256, 1024), (256, 0), (2048, 1024),
                                      (2048, 0)])
def test_flash_kernel_head_dim_256(cuda, dtype, Hq, Hkv, T, window):
    """gemma3-12b's 16/8 heads and gemma-7b's 16/16 at head dim 256, with
    gemma3's window 1024 and without: the TMA + wgmma body in bf16 (the
    narrow shape at T 256, the wide one at 2048), the fp32 CUDA-core body
    in fp32, as the launcher reports it."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain
    g = torch.Generator(device=cuda).manual_seed(T + window + Hkv)
    B = 2 if T <= 256 else 1
    q = _randn(cuda, (B, T, Hq, 256), dtype, g)
    k, v = (_randn(cuda, (B, T, Hkv, 256), dtype, g) for _ in range(2))
    before = fa.LAUNCHES["flash_attention"]
    out = ops.flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == before + 1
    assert fa.LAST_ROUTE["flash_attention"] == D256_ROUTE[dtype]
    ref = flash_attention_plain(q, k, v, window=window)
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    if dtype == torch.bfloat16:
        _assert_rows_close(out, ref)


# ------------------------------------------------- kernel 5's fp32 body
@pytest.mark.parametrize("D", [32, 64, 128, 256])
@pytest.mark.parametrize("T,window,cap", [(100, 0, 0.0), (40, 0, 0.0),
                                          (384, 0, 0.0), (384, 100, 0.0),
                                          (256, 0, 30.0), (128, 70, 20.0)])
def test_flash_f32_kernel_matches_plain(cuda, D, T, window, cap):
    """The fp32 CUDA-core body at every head dim: T not a multiple of its
    64-row tile (100, 40: one partial tile), several tiles, a window, a
    tanh cap, GQA 4 over 2; the (B, H, T, D) wrapper's strided views."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    g = torch.Generator(device=cuda).manual_seed(T + window + D)
    q = _randn(cuda, (2, 4, T, D), torch.float32, g)
    k, v = (_randn(cuda, (2, 2, T, D), torch.float32, g) for _ in range(2))
    before = fa.LAUNCHES["flash_attention"]
    out = fa.flash_attention_bhtd(q, k, v, causal=True, window=window,
                                  logit_cap=cap)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == before + 1
    assert fa.LAST_ROUTE["flash_attention"] == "f32"
    ref = flash_attention_ref(q, k, v, causal=True, window=window,
                              logit_cap=cap)
    tol = FLASH_TOL[torch.float32]
    torch.testing.assert_close(out, ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("D", [32, 64, 128, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_f32_kernel_on_packed_model_layout(cuda, D, causal):
    """The fp32 body on (B, T, H, D) views of one packed qkv tensor (row
    pitch (Hq + 2 Hkv) D, q, k, v at head offsets), read in place, causal
    and not, at g 7 and a T of one and a half row tiles."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain
    g = torch.Generator(device=cuda).manual_seed(D + causal)
    B, T, Hq, Hkv = 2, 96, 7, 1
    qkv = _randn(cuda, (B, T, Hq + 2 * Hkv, D), torch.float32, g)
    q, k, v = qkv[:, :, :Hq], qkv[:, :, Hq:Hq + Hkv], qkv[:, :, Hq + Hkv:]
    out = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.LAST_ROUTE["flash_attention"] == "f32"
    ref = flash_attention_plain(q, k, v, causal=causal)
    tol = FLASH_TOL[torch.float32]
    torch.testing.assert_close(out, ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("Hq,Hkv", [(16, 8), (16, 16)])
@pytest.mark.parametrize("T,S", [(1, 1024), (5, 2048), (9, 4096)])
def test_decode_kernel_head_dim_256(cuda, dtype, Hq, Hkv, T, S):
    """The dense decode/verify kernel at head dim 256 (AR, gamma 4 and
    gamma 8 verifies; g = 2 and 1) on the model's cache layout with a
    poisoned trash slot: the split-KV TMA + wgmma body in bf16, the
    split-KV CUDA-core body in fp32."""
    from repro_torch.kernels.decode_attention import ops
    from repro_torch.kernels.decode_attention.ref import decode_attention_plain
    gen = torch.Generator(device=cuda).manual_seed(T + S + Hkv)
    B = 3
    q = _randn(cuda, (B, T, Hq, 256), dtype, gen)
    kc, vc = (_randn(cuda, (B, S + 1, Hkv, 256), dtype, gen) for _ in range(2))
    kc[:, S], vc[:, S] = 1e3, -1e3
    lengths = torch.tensor([0, S // 2, S - T], dtype=torch.int32, device=cuda)
    before = ops.LAUNCHES["decode_attention"]
    out = ops.decode_attention(q, kc[:, :S], vc[:, :S], lengths)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["decode_attention"] == before + 1
    assert ops.LAST_ROUTE["decode_attention"] == DECODE_D256_ROUTE[dtype]
    ref = decode_attention_plain(q, kc[:, :S], vc[:, :S], lengths)
    tol = DECODE_TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    if dtype == torch.bfloat16:
        _assert_rows_close(out, ref, DECODE_ROW_TOL)


@pytest.mark.parametrize("T,window,cap", [(2048, 1000, 0.0), (2048, 0, 0.0),
                                          (64, 0, 0.0), (1024, 200, 30.0)])
def test_flash_sm90_head_dim_256_edges(cuda, T, window, cap):
    """The bf16 TMA + wgmma body at gemma3-12b's 16/8 heads of 256: a
    window edge that crosses 64-key chunks (1000, 200) at T 2048 and 1024
    (the wide shape, one Q buffer), the global T 2048, one 64-query tile
    (T 64, the narrow shape), and a tanh cap before the window mask."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain
    g = torch.Generator(device=cuda).manual_seed(T + window)
    B = 2
    q = _randn(cuda, (B, T, 16, 256), torch.bfloat16, g)
    k, v = (_randn(cuda, (B, T, 8, 256), torch.bfloat16, g) for _ in range(2))
    out = ops.flash_attention(q, k, v, window=window, logit_cap=cap)
    torch.cuda.synchronize()
    assert fa.LAST_ROUTE["flash_attention"] == "sm90"
    ref = flash_attention_plain(q, k, v, window=window, logit_cap=cap)
    tol = FLASH_TOL[torch.bfloat16]
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    _assert_rows_close(out, ref)


# gemma3's continuous paged lengths: ragged 1100-1640 cached positions
GEMMA_LENGTHS = [1100, 1163, 1230, 1299, 1380, 1455, 1533, 1640]


@pytest.mark.parametrize("ps", [16, 64])
@pytest.mark.parametrize("T", [1, 5])
def test_paged_sm90_head_dim_256_gemma3(cuda, ps, T):
    """The bf16 split-KV body at gemma3-12b's 16/8 heads of 256, pages of
    16 and 64, ragged lengths of 1100-1640: several splits a row and the
    combine, held against the plain version; then NaN in every position
    past length + T - 1 (the last chunk of a row runs past it into them,
    and the pages beyond) and in the trash page must not move the output
    by one bit."""
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attention import paged
    from repro_torch.kernels.decode_attention.ref import \
        paged_decode_attention_plain
    B, Hq, Hkv, D = len(GEMMA_LENGTHS), 16, 8, 256
    MP = -(-(max(GEMMA_LENGTHS) + T) // ps) + 1
    q, kp, vp, lengths, table = _paged_case(
        cuda, torch.bfloat16, B=B, Hq=Hq, Hkv=Hkv, D=D, T=T, ps=ps, MP=MP,
        seed=ps + T, lengths=GEMMA_LENGTHS)
    out = paged.paged_decode_attention(q, kp, vp, lengths, table)
    torch.cuda.synchronize()
    assert paged.LAST_ROUTE["paged_decode_attention"] == "sm90"
    # several splits: the partials need scratch, merged by the combine
    assert build.load(paged.SOURCE).paged_decode_attention_scratch_bytes(
        0, D, B, T, Hq, Hkv, ps, MP) > 0
    ref = paged_decode_attention_plain(q, kp, vp, lengths, table)
    tol = PAGED_TOL[torch.bfloat16]
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    _assert_rows_close(out, ref, PAGED_ROW_TOL)
    pk, pv = kp.clone(), vp.clone()
    pk[0], pv[0] = float("nan"), float("inf")
    for b, n in enumerate(GEMMA_LENGTHS):
        first_dead = n + T
        for lp in range(MP):
            lo = max(0, first_dead - lp * ps)
            if lo < ps:
                page = int(table[b, lp])
                pk[page, lo:], pv[page, lo:] = float("nan"), float("nan")
    after = paged.paged_decode_attention(q, pk, pv, lengths, table)
    assert torch.isfinite(after).all()
    torch.testing.assert_close(after, out, rtol=0, atol=0)


def test_head_dim_256_folds_at_most_32_heads(cuda):
    """At head dim 256 a row tile holds 64 query rows: 64 query heads a KV
    head run one position a tile in both dtypes, 65 are refused on the card,
    not sent to the plain version."""
    from repro_torch.kernels.decode_attention import ops
    from repro_torch.kernels.decode_attention.ref import decode_attention_plain
    gen = torch.Generator(device=cuda).manual_seed(64)
    lengths = torch.tensor([300], dtype=torch.int32, device=cuda)
    for dtype, route in ((torch.bfloat16, "sm90"), (torch.float32, "f32")):
        q = _randn(cuda, (1, 2, 64, 256), dtype, gen)
        k, v = (_randn(cuda, (1, 512, 1, 256), dtype, gen) for _ in range(2))
        out = ops.decode_attention(q, k, v, lengths)
        assert ops.LAST_ROUTE["decode_attention"] == route
        tol = DECODE_TOL[dtype]
        torch.testing.assert_close(out.float(), decode_attention_plain(
            q, k, v, lengths).float(), rtol=tol, atol=tol)
    q = torch.zeros((1, 1, 65, 256), device=cuda)
    kv = torch.zeros((1, 512, 1, 256), device=cuda)
    before = ops.LAUNCHES["decode_attention"]
    with pytest.raises(ValueError, match="64 rows at head dim 256"):
        ops.decode_attention(q, kv, kv,
                             torch.zeros((1,), dtype=torch.int32, device=cuda))
    assert ops.LAUNCHES["decode_attention"] == before


# ----------------------------------------------- capacity-binned grouped matmul
# the reference's bounds (tests/test_kernels.py): fp32 1e-5, bf16 2e-2;
# weights scaled by 1/sqrt(D) so the outputs are O(1)
GMM_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("E,C,D,F", [(2, 128, 256, 128), (4, 256, 512, 384),
                                     (1, 128, 1024, 256), (8, 128, 128, 128),
                                     (2, 4, 32, 48), (3, 100, 72, 40)])
def test_gmm_capacity_kernel_matches_plain(cuda, dtype, E, C, D, F):
    from repro_torch.kernels.gmm import gmm
    from repro_torch.kernels.gmm.ref import gmm_capacity_ref
    gen = torch.Generator(device=cuda).manual_seed(E + C + D)
    x = _randn(cuda, (E, C, D), dtype, gen)
    w = (torch.randn((E, D, F), generator=gen, device=cuda) / D ** 0.5
         ).to(dtype)
    before = gmm.LAUNCHES["gmm_capacity"]
    out = gmm.gmm_capacity(x, w)
    torch.cuda.synchronize()
    assert gmm.LAUNCHES["gmm_capacity"] == before + 1
    tol = GMM_TOL[dtype]
    torch.testing.assert_close(out.float(), gmm_capacity_ref(x, w).float(),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("C", [4, 16, 100, 128, 512])
def test_gmm_capacity_sm90_kernel_matches_plain(cuda, C):
    """The bf16 TMA + wgmma kernel: bins below one 64-row warpgroup tile
    (one consumer warpgroup), ragged C, one and four 128-row tiles, E 1,
    F = 384 (three 128-column tiles; a ragged F is in the next test)."""
    from repro_torch.kernels.gmm import gmm
    from repro_torch.kernels.gmm.ref import gmm_capacity_ref
    gen = torch.Generator(device=cuda).manual_seed(C)
    x = _randn(cuda, (1, C, 256), torch.bfloat16, gen)
    w = (torch.randn((1, 256, 384), generator=gen, device=cuda) / 16.0
         ).to(torch.bfloat16)
    assert gmm._route(x, w) == "sm90"
    before = gmm.LAUNCHES["gmm_capacity"]
    out = gmm.gmm_capacity(x, w)
    torch.cuda.synchronize()
    assert gmm.LAUNCHES["gmm_capacity"] == before + 1
    tol = GMM_TOL[torch.bfloat16]
    torch.testing.assert_close(out.float(), gmm_capacity_ref(x, w).float(),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype,E,C,D,F,route,producer", [
    (torch.bfloat16, 2, 100, 36, 40, "sm90", "staged"),  # D pitch 72 bytes
    (torch.bfloat16, 2, 64, 64, 200, "sm90", "tma"),     # F ragged, not a tile
    (torch.float32, 2, 100, 72, 40, "simt90", None),
    (torch.float32, 2, 100, 70, 40, "simt90", None),     # D pitch 280 bytes
])
def test_gmm_capacity_routes_match_plain(cuda, dtype, E, C, D, F, route,
                                         producer):
    """A bf16 shape TMA cannot address runs the TMA + wgmma body with its
    staged producer; fp32 takes the cp.async CUDA-core body, with 16-byte
    copies where they are aligned and 4-byte ones otherwise; each matches
    the plain version at its bound and the wrapper reports the route and
    producer it launched."""
    from repro_torch.kernels.gmm import gmm
    from repro_torch.kernels.gmm.ref import gmm_capacity_ref
    gen = torch.Generator(device=cuda).manual_seed(D + F)
    x = _randn(cuda, (E, C, D), dtype, gen)
    w = (torch.randn((E, D, F), generator=gen, device=cuda) / D ** 0.5
         ).to(dtype)
    assert gmm._route(x, w) == route and gmm._producer(x, w) == producer
    out = gmm.gmm_capacity(x, w)
    assert gmm.LAST_ROUTE["gmm_capacity"] == route
    assert gmm.LAST_PRODUCER["gmm_capacity"] == producer
    tol = GMM_TOL[dtype]
    torch.testing.assert_close(out.float(), gmm_capacity_ref(x, w).float(),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("C", [1, 40, 128, 512])
@pytest.mark.parametrize("K,F", [(72, 200), (256, 384), (3584, 132)])
def test_gmm_capacity_simt90_kernel_matches_plain(cuda, C, K, F):
    """The fp32 cp.async CUDA-core kernel: one row of a bin, a 64-row tile
    holding 40, one and four 128-row tiles; K not a multiple of its 16-deep
    stages, F not a multiple of its 128 columns; three experts, so a bin
    that read past C would take the next expert's rows."""
    from repro_torch.kernels.gmm import gmm
    from repro_torch.kernels.gmm.ref import gmm_capacity_ref
    gen = torch.Generator(device=cuda).manual_seed(C + K + F)
    x = _randn(cuda, (3, C, K), torch.float32, gen)
    w = torch.randn((3, K, F), generator=gen, device=cuda) / K ** 0.5
    assert gmm._route(x, w) == "simt90"
    before = gmm.LAUNCHES["gmm_capacity"]
    out = gmm.gmm_capacity(x, w)
    torch.cuda.synchronize()
    assert gmm.LAUNCHES["gmm_capacity"] == before + 1
    assert gmm.LAST_ROUTE["gmm_capacity"] == "simt90"
    tol = GMM_TOL[torch.float32]
    torch.testing.assert_close(out, gmm_capacity_ref(x, w), rtol=tol,
                               atol=tol)


def _off_one(t):
    """The same values, the base one element past a 16-byte boundary."""
    buf = torch.empty((t.numel() + 1,), dtype=t.dtype, device=t.device)
    buf[1:].copy_(t.reshape(-1))
    return buf[1:].view(t.shape)


@pytest.mark.parametrize("which", ["x", "w"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gmm_capacity_unaligned_fp32_takes_simt90(cuda, dtype, which):
    """An operand whose base is one element off 16 bytes keeps the body of
    its dtype: fp32 the cp.async CUDA-core body (its 4-byte copies), bf16
    the TMA + wgmma body with its staged producer, chosen before the
    launch and reported by it."""
    from repro_torch.kernels.gmm import gmm
    from repro_torch.kernels.gmm.ref import gmm_capacity_ref
    gen = torch.Generator(device=cuda).manual_seed(7)
    E, C, K, F = 2, 40, 64, 96
    x = _randn(cuda, (E, C, K), dtype, gen)
    w = (torch.randn((E, K, F), generator=gen, device=cuda) / K ** 0.5
         ).to(dtype)
    if which == "x":
        x = _off_one(x)
    else:
        w = _off_one(w)
    assert (x.data_ptr() % 16 != 0) == (which == "x")
    assert (w.data_ptr() % 16 != 0) == (which == "w")
    want = ("simt90", None) if dtype == torch.float32 else ("sm90", "staged")
    assert (gmm._route(x, w), gmm._producer(x, w)) == want
    out = gmm.gmm_capacity(x, w)
    torch.cuda.synchronize()
    assert (gmm.LAST_ROUTE["gmm_capacity"],
            gmm.LAST_PRODUCER["gmm_capacity"]) == want
    tol = GMM_TOL[dtype]
    torch.testing.assert_close(out.float(), gmm_capacity_ref(x, w).float(),
                               rtol=tol, atol=tol)


# operands TMA (bf16) or 16-byte copies (fp32) cannot take: (which operand
# is one element off its base, K, F).  bf16: x off 2 bytes (w by TMA), w
# off 2 bytes (x by TMA), a D pitch of 72 bytes, an F pitch of 90 bytes
# (bf16 pairs of out unaligned), K < 8; fp32 likewise at 4 bytes, 72 and
# 180 bytes, K < 4.  K 200: a last K tile of 8; F 328: a last column tile
# of 72 (one box of 8 columns, at BN 256 two boxes of zeros)
UNALIGNED_GMM = {torch.bfloat16: [("x", 200, 328), ("w", 200, 328),
                                  (None, 36, 328), (None, 200, 45),
                                  (None, 5, 328)],
                 torch.float32: [("x", 200, 328), ("w", 200, 328),
                                 (None, 18, 328), (None, 200, 45),
                                 (None, 3, 328)]}


def _unaligned_case(dev, dtype, C, which, K, F, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = _randn(dev, (3, C, K), dtype, gen)
    w = (torch.randn((3, K, F), generator=gen, device=dev) / K ** 0.5
         ).to(dtype)
    return (_off_one(x) if which == "x" else x,
            _off_one(w) if which == "w" else w)


@pytest.mark.parametrize("C", [1, 40, 128, 512])
@pytest.mark.parametrize("which,K,F", UNALIGNED_GMM[torch.bfloat16])
def test_gmm_capacity_staged_matches_plain(cuda, C, which, K, F):
    """The bf16 body's staged producer on every tile (C 1 and 40: one
    consumer warpgroup; 128: two; 512: two at 256 columns), each operand
    TMA cannot address staged by hand beside the other's TMA loads; three
    experts, so a bin that read past C would take the next expert's
    rows."""
    from repro_torch.kernels.gmm import gmm
    from repro_torch.kernels.gmm.ref import gmm_capacity_ref
    x, w = _unaligned_case(cuda, torch.bfloat16, C, which, K, F, C + K + F)
    assert (gmm._route(x, w), gmm._producer(x, w)) == ("sm90", "staged")
    before = gmm.LAUNCHES["gmm_capacity"]
    out = gmm.gmm_capacity(x, w)
    torch.cuda.synchronize()
    assert gmm.LAUNCHES["gmm_capacity"] == before + 1
    assert gmm.LAST_PRODUCER["gmm_capacity"] == "staged"
    tol = GMM_TOL[torch.bfloat16]
    torch.testing.assert_close(out.float(), gmm_capacity_ref(x, w).float(),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("C", [1, 40, 128, 512])
@pytest.mark.parametrize("which,K,F", UNALIGNED_GMM[torch.float32])
def test_gmm_capacity_simt90_4byte_matches_plain(cuda, C, which, K, F):
    """The fp32 body's 4-byte copies at both row tiles (64 rows up to C 64,
    128 above), on operands whose 16-byte pieces are not aligned."""
    from repro_torch.kernels.gmm import gmm
    from repro_torch.kernels.gmm.ref import gmm_capacity_ref
    x, w = _unaligned_case(cuda, torch.float32, C, which, K, F, C + K + F)
    assert gmm._route(x, w) == "simt90"
    out = gmm.gmm_capacity(x, w)
    torch.cuda.synchronize()
    assert gmm.LAST_ROUTE["gmm_capacity"] == "simt90"
    tol = GMM_TOL[torch.float32]
    torch.testing.assert_close(out, gmm_capacity_ref(x, w), rtol=tol,
                               atol=tol)


def test_capacity_ops_launch_counts_and_parity(cuda):
    """moe_ffn_gmm is 3 launches and equals the one-hot FFN with ample
    capacity (no drops); gmm_legacy is 1 launch and equals the ragged
    kernel."""
    from repro_torch.kernels.gmm import gmm, ops
    from repro_torch.kernels.gmm.ref import moe_ffn_ref
    gen = torch.Generator(device=cuda).manual_seed(2)
    N, D, F, E, K = 64, 32, 48, 4, 2
    x = _randn(cuda, (N, D), torch.float32, gen)
    wg, wu = ((torch.randn((E, D, F), generator=gen, device=cuda) / D ** 0.5)
              for _ in range(2))
    wd = torch.randn((E, F, D), generator=gen, device=cuda) / F ** 0.5
    w, idx = torch.softmax(torch.randn((N, E), generator=gen, device=cuda),
                           -1).topk(K, -1)
    w = w / w.sum(-1, keepdim=True)
    before = gmm.LAUNCHES["gmm_capacity"]
    y, dropped = ops.moe_ffn_gmm(x, wg, wu, wd, w, idx,
                                 capacity=ops.expert_capacity(N, K, E, 8.0),
                                 return_dropped=True)
    torch.cuda.synchronize()
    assert gmm.LAUNCHES["gmm_capacity"] == before + 3 and int(dropped) == 0
    torch.testing.assert_close(y, moe_ffn_ref(x, wg, wu, wd, w, idx),
                               rtol=1e-4, atol=1e-4)
    sizes = torch.tensor([37, 0, 1, 129, 0, 77, 13, 200], dtype=torch.int32,
                         device=cuda)
    xs = _randn(cuda, (int(sizes.sum()), 64), torch.float32, gen)
    w8 = torch.randn((8, 64, 128), generator=gen, device=cuda) / 8.0
    before = gmm.LAUNCHES["gmm_capacity"]
    out = ops.gmm_legacy(xs, w8, sizes)
    assert gmm.LAUNCHES["gmm_capacity"] == before + 1
    torch.testing.assert_close(out, ops.gmm(xs, w8, sizes), rtol=2e-4,
                               atol=2e-4)


# ------------------------- the recurrent and encoder-decoder archs' shapes
@pytest.mark.parametrize("tokens", [40, 8, 512])
def test_ragged_kernels_at_jamba_routing(cuda, tokens):
    """Kernels 1 and 2 at jamba-v0.1-52b's experts (16 of 4096 x 14336,
    top-2) for the SD verify (B 8 x 5 tokens), AR verify (8) and a prefill
    (512) routing, bf16, through the TMA + wgmma route."""
    g = torch.Generator(device=cuda).manual_seed(tokens + 16)
    E, K, D, F = 16, 2, 4096, 14336
    idx = torch.randn((tokens, E), generator=g, device=cuda).topk(K, -1).indices
    sizes = torch.bincount(idx.reshape(-1), minlength=E).to(torch.int32)
    N = tokens * K
    xs = torch.randn((N, D), generator=g, device=cuda).bfloat16()
    wg, wu = ((torch.randn((E, D, F), generator=g, device=cuda) / D ** 0.5
               ).bfloat16() for _ in range(2))
    wd = (torch.randn((E, F, D), generator=g, device=cuda) / F ** 0.5
          ).bfloat16()
    h = ragged.fused_gate_up(xs, wg, wu, sizes)
    assert ragged.LAST_ROUTE["fused_gate_up"] == "sm90"
    h_ref = fused_gate_up_ref(xs, wg, wu, sizes)
    _close(h, h_ref, torch.bfloat16)
    y = ragged.ragged_gmm(h_ref, wd, sizes)
    assert ragged.LAST_ROUTE["ragged_gmm"] == "sm90"
    _close(y, ragged_gmm_ref(h_ref, wd, sizes), torch.bfloat16)


# the phase 8-9 paths' heads at kernels 4 and 5: whisper-base's decoder
# self-attention, jamba-v0.1-52b's attention layer, the draft_for drafts
PATH_HEADS = {"whisper": (8, 8, 64), "jamba": (32, 8, 128),
              "draft": (8, 2, 64)}


@pytest.mark.parametrize("T", [1, 5])
@pytest.mark.parametrize("heads", sorted(PATH_HEADS))
def test_decode_kernel_at_path_heads(cuda, heads, T):
    """Kernel 4 at the heads of PATH_HEADS on the cache layout at max_seq
    512 (the capacity of the bucket-256 paths), bf16, split-KV body."""
    from repro_torch.kernels.decode_attention import ops
    from repro_torch.kernels.decode_attention.ref import decode_attention_plain
    Hq, Hkv, D = PATH_HEADS[heads]
    S = 512
    q, kc, vc, lengths = _decode_case(cuda, B=8, T=T, Hq=Hq, Hkv=Hkv, D=D,
                                      S=S, lengths=[129, 150, 200, 233, 256,
                                                    260, 290, 140],
                                      seed=T + Hq + D)
    k, v = kc[:, :S], vc[:, :S]
    out = ops.decode_attention(q, k, v, lengths)
    assert ops.LAST_ROUTE["decode_attention"] == "sm90"
    ref = decode_attention_plain(q, k, v, lengths)
    tol = DECODE_TOL[torch.bfloat16]
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    _assert_rows_close(out, ref, DECODE_ROW_TOL)


@pytest.mark.parametrize("heads", sorted(PATH_HEADS))
def test_flash_kernel_at_path_heads(cuda, heads):
    """Kernel 5 at the heads of PATH_HEADS: a 256-token causal prefill of 8
    prompts (the bucket of the phase 8-9 flash paths), bf16."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain
    Hq, Hkv, D = PATH_HEADS[heads]
    g = torch.Generator(device=cuda).manual_seed(256 + Hq + D)
    q = _randn(cuda, (8, 256, Hq, D), torch.bfloat16, g)
    k, v = (_randn(cuda, (8, 256, Hkv, D), torch.bfloat16, g)
            for _ in range(2))
    out = ops.flash_attention(q, k, v)
    assert fa.LAST_ROUTE["flash_attention"] == "sm90"
    ref = flash_attention_plain(q, k, v)
    tol = FLASH_TOL[torch.bfloat16]
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    _assert_rows_close(out, ref)
