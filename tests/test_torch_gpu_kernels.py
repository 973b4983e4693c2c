"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: each test asks a fixture whether a card and ``nvcc`` are
there and skips with the reason when not (the decision is never made at
import time, so every xdist worker collects the same tests).  Run on a
machine with an NVIDIA GPU:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu_kernels.py

Tolerances: 1e-4 in fp32; in bf16 the reference's 3e-2 bound (rtol and atol,
tests/test_ragged_gmm.py): both sides accumulate in fp32 in different orders
and round once to bf16, so they differ by at most one bf16 ulp.
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
@pytest.mark.parametrize("bm", [16, 64])
def test_ragged_gmm_kernel_matches_plain(cuda, sizes, dtype, bm):
    sizes, xs, (w, _) = _case(sizes, 64, 96, dtype, cuda)
    before = ragged.LAUNCHES["ragged_gmm"]
    out = ragged.ragged_gmm(xs, w, sizes, bm=bm)
    torch.cuda.synchronize()
    assert ragged.LAUNCHES["ragged_gmm"] == before + 1
    _close(out, ragged_gmm_ref(xs, w, sizes), dtype)


@pytest.mark.parametrize("sizes", GROUP_CASES)
@pytest.mark.parametrize("activation", ["silu", "gelu"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_gate_up_kernel_matches_plain(cuda, sizes, activation, dtype):
    sizes, xs, (wg, wu) = _case(sizes, 64, 128, dtype, cuda)
    out = ragged.fused_gate_up(xs, wg, wu, sizes, activation=activation)
    torch.cuda.synchronize()
    _close(out, fused_gate_up_ref(xs, wg, wu, sizes, activation), dtype)


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
        y = moe.moe_forward(p, cfg, x, dispatch="gmm")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    ref = moe.moe_forward(p, cfg, x, dispatch="onehot")
    torch.testing.assert_close(y, ref, rtol=2e-4, atol=2e-4)


def test_moe_layer_bf16_on_card_matches_cpu(cuda):
    """The bf16 gmm dispatch on the card (kernels, atomic index_add_) against
    the same layer on the CPU (plain loop, sequential index_add_).  Bound:
    the reference's bf16 3e-2 (rtol and atol) — each side rounds h, the
    expert outputs and every one of the K adds to bf16, in another order."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import moe
    cfg = get_config("qwen2-57b-a14b", reduced=True).with_overrides(
        dtype="bfloat16")
    gen = torch.Generator().manual_seed(1)
    p = moe.init_moe(cfg, torch.bfloat16, generator=gen, device="cpu")
    x = torch.randn((4, 5, cfg.d_model), generator=gen).to(torch.bfloat16)
    on_card = moe.moe_forward(_to(p, cuda), cfg, x.to(cuda), dispatch="gmm")
    on_cpu = moe.moe_forward(p, cfg, x, dispatch="gmm")
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


def _paged_case(dev, dtype, *, B, Hq, Hkv, D, T, ps, MP, seed=0):
    """Noise in every physical page (trash page 0 included), a permuted
    table and ragged lengths, as tests/test_paged_attention.py builds them."""
    g = torch.Generator(device=dev).manual_seed(seed)
    NP = B * MP + 1
    kp = torch.randn((NP, ps, Hkv, D), generator=g, device=dev).to(dtype)
    vp = torch.randn((NP, ps, Hkv, D), generator=g, device=dev).to(dtype)
    table = (torch.randperm(NP - 1, generator=g, device=dev) + 1
             ).reshape(B, MP).to(torch.int32)
    lengths = torch.randint(0, MP * ps - T + 1, (B,), generator=g,
                            device=dev).to(torch.int32)
    q = torch.randn((B, T, Hq, D), generator=g, device=dev).to(dtype)
    return q, kp, vp, lengths, table


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("T,ps,cap", [(1, 16, 0.0), (5, 64, 0.0),
                                      (8, 8, 30.0), (3, 64, 30.0)])
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
    ref = paged_decode_attention_plain(*case, logit_cap=cap)
    tol = PAGED_TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_paged_attention_kernel_long_context_and_no_sync(cuda, dtype):
    """~8k cached positions at the serve widths, with the device never
    waiting on the host for lengths or the table.  A typical |out| there is
    ~0.02, near the bf16 bound, so fp32 holds the page walk at 2e-5."""
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
