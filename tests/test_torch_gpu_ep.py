"""Expert parallelism, the ragged kernels' trailing rows and the transfer
guard on the card.

Marked ``gpu``: each test asks a fixture whether a card and ``nvcc`` are
there and skips with the reason when not.  Run on a machine with an
NVIDIA GPU:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu_ep.py

The expert-parallel tests run on a NCCL world of one in this process (the
mesh starts it); the multi-rank NCCL test needs two cards and skips
otherwise.  Kernel tolerances as in tests/test_torch_gpu_kernels.py: 1e-4
in fp32, 3e-2 in bf16.
"""
import os
import tempfile

import numpy as np
import pytest
import torch

from repro_torch.kernels.gmm import ragged
from repro_torch.kernels.gmm.ref import (fused_gate_up_ref, ragged_gmm_ref,
                                         ragged_moe_ffn_ref)

pytestmark = pytest.mark.gpu

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
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# -------------------------------------------- kernels 1-2, trailing rows
# (sizes, N): the groups cover fewer rows than xs holds
TRAILING = [([5, 0, 11], 24), ([37, 0, 1, 129, 0, 77, 13, 200], 600),
            ([64, 0], 100), ([0, 0, 0], 40)]


@pytest.mark.parametrize("sizes,n", TRAILING)
@pytest.mark.parametrize("dtype,bm,x_offset,route", [
    (torch.bfloat16, None, 0, "sm90"), (torch.bfloat16, 16, 0, "sm90"),
    (torch.bfloat16, 128, 1, "sm90"),             # the staged producer
    (torch.float32, None, 0, "simt90"), (torch.float32, 16, 1, "simt90")])
def test_trailing_rows_on_every_route(cuda, sizes, n, dtype, bm, x_offset,
                                      route):
    """sum(group_sizes) < N on each body (and the bf16 body's staged
    producer, x one element off 16 bytes), whatever ``bm``: the real rows
    equal the plain version's, and NaN in the rows past the groups reaches
    no real row (no item is launched for them, nothing reads them into a
    stored row)."""
    g = torch.Generator(device=cuda).manual_seed(len(sizes) + n)
    E, D, F, real = len(sizes), 128, 256, int(sum(sizes))
    xs = torch.randn((n, D), generator=g, device=cuda).to(dtype)
    xs[real:] = float("nan")
    if x_offset:
        buf = torch.empty((xs.numel() + x_offset,), dtype=dtype, device=cuda)
        buf[x_offset:].copy_(xs.reshape(-1))
        xs = buf[x_offset:].view(xs.shape)
    wg, wu = ((torch.randn((E, D, F), generator=g, device=cuda)
               / D ** 0.5).to(dtype) for _ in range(2))
    wd = (torch.randn((E, F, D), generator=g, device=cuda) / F ** 0.5).to(dtype)
    sizes_t = torch.tensor(sizes, dtype=torch.int32, device=cuda)
    h = ragged.fused_gate_up(xs, wg, wu, sizes_t, bm=bm)
    assert ragged.LAST_ROUTE["fused_gate_up"] == route
    z = ragged.ragged_gmm(xs, wg, sizes_t, bm=bm)
    assert ragged.LAST_ROUTE["ragged_gmm"] == route
    y = ragged.ragged_moe_ffn(xs, wg, wu, wd, sizes_t, bm=bm)
    torch.cuda.synchronize()
    xr = xs[:real].cpu()
    sc = sizes_t.cpu()
    for out, ref in ((h, fused_gate_up_ref(xr, wg.cpu(), wu.cpu(), sc)),
                     (z, ragged_gmm_ref(xr, wg.cpu(), sc)),
                     (y, ragged_moe_ffn_ref(xr, wg.cpu(), wu.cpu(),
                                            wd.cpu(), sc))):
        got = out[:real].float().cpu()
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, ref.float(), rtol=TOL[dtype],
                                   atol=TOL[dtype])


# --------------------------------------------------------- transfer_guard
def test_transfer_guard_counts_implicit_syncs(cuda):
    from repro_torch.analysis import transfer_guard
    x = torch.ones((4,), device=cuda)
    with transfer_guard() as g:
        (x + 1).sum().item()                      # a read the host waits on
    assert g.count >= 1
    assert any("synchronizing" in ln for ln in g.lines)
    assert torch.cuda.get_sync_debug_mode() == 0


def test_transfer_guard_clean_region_counts_zero(cuda):
    """Device work and the engine's explicit crossings count nothing."""
    from repro_torch.analysis import transfer_guard
    from repro_torch.device import host_crossing
    x = torch.arange(4, dtype=torch.float32, device=cuda)
    pinned = torch.empty((4,), pin_memory=True)
    with transfer_guard() as g:
        y = x * 2 + 1                             # device-resident
        pinned.copy_(y, non_blocking=True)        # async into pinned memory
        with host_crossing():                     # an explicit readback
            host = y.cpu().numpy()
    assert g.count == 0, g.lines
    assert g.lines == [] and host.tolist() == [1.0, 3.0, 5.0, 7.0]


def test_transfer_guard_count_is_live_then_frozen(cuda):
    from repro_torch.analysis import transfer_guard
    x = torch.ones((2,), device=cuda)
    with transfer_guard() as g:
        assert g.count == 0
        x.cpu()
        live = g.count
        assert live >= 1                          # visible while still open
        with transfer_guard() as inner:           # guards nest
            x.cpu()
        assert inner.count >= 1 and g.count > live
        live = g.count
    x.cpu()
    assert g.count == live                        # frozen at exit


def test_transfer_guard_disallow_raises_at_site(cuda):
    from repro_torch.analysis import transfer_guard
    x = torch.ones((3,), device=cuda)
    with pytest.raises(RuntimeError, match="synchronizing"):
        with transfer_guard("disallow"):
            x.sum().item()
    assert torch.cuda.get_sync_debug_mode() == 0


# ----------------------------------------------- EP on a NCCL world of one
@pytest.fixture(scope="module")
def mesh(cuda):
    from repro_torch.launch.mesh import make_ep_mesh
    return make_ep_mesh(1)


@pytest.fixture(scope="module")
def ep_models(mesh):
    """The reduced qwen2-57b-a14b under "ep" on the mesh and under "gmm",
    with its reduced draft; one set of weights."""
    from repro_torch.configs.registry import draft_for, get_config
    from repro_torch.models.model import Model
    cfg = get_config("qwen2-57b-a14b", reduced=True)
    dcfg = draft_for(cfg).with_overrides(
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=2, d_ff=256,
        dtype="float32")
    t_ep = Model(cfg, moe_dispatch="ep", mesh=mesh)
    t_gmm = Model(cfg, moe_dispatch="gmm")
    d = Model(dcfg)
    gen = torch.Generator(device="cuda")
    return (t_ep, t_gmm, d, t_ep.init(gen.manual_seed(0)),
            d.init(gen.manual_seed(1)))


def _session(ep_models, target, graphs: bool):
    from repro_torch.core.proposer import make_proposer
    from repro_torch.core.spec_decode import SDEngine
    _, _, d, _, _ = ep_models
    return SDEngine(target, make_proposer("model", target, d), gamma=4,
                    cuda_graphs=graphs)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def test_captured_ep_round_equals_eager_bit_for_bit(ep_models):
    """At ep 1 the all-to-all runs on NCCL inside the round; the captured
    round replays to the same bits as the eager round (every cache leaf
    after every round), and each replay credits its EP calls."""
    from repro_torch.distributed import collectives
    t_ep, t_gmm, d, pt, pd = ep_models
    prompts = np.random.default_rng(0).integers(3, 200, (4, 12))
    runs = {}
    for graphs in (True, False):
        eng = _session(ep_models, t_ep, graphs)
        state = eng.start(pt, pd, prompts, max_seq=64)
        caches, tokens = [], []
        for _ in range(4):
            collectives.reset_ep_calls()
            state, res = eng.round(state)
            assert collectives.EP_CALLS["moe_ep_forward"] == \
                sum(t_ep.cfg.moe_pattern[l % t_ep.cfg.period]
                    for l in range(t_ep.cfg.num_layers))
            caches.append([t.clone() for t in _leaves(state.t_cache)])
            tokens.append(res.committed.copy())
        runs[graphs] = (caches, tokens)
        if graphs:
            assert eng.graphs.total_replays == 3
    for (ca, ta), (cb, tb) in zip(zip(*runs[True]), zip(*runs[False])):
        np.testing.assert_array_equal(ta, tb)
        assert all(torch.equal(a, b) for a, b in zip(ca, cb))


def test_ep_serving_matches_gmm_and_warm_guards_count_nothing(ep_models,
                                                             mesh):
    """A wave and a continuous paged stream at ep 1 serve the gmm engine's
    greedy tokens (fp32); the same workload again on the warm engine runs
    no new round key, no implicit host sync and one input signature a
    round key."""
    from repro_torch.analysis import (compile_guard, sharding_guard,
                                      transfer_guard)
    from repro_torch.serving.engine import ServingEngine
    t_ep, t_gmm, d, pt, pd = ep_models
    prompts = [np.random.default_rng(i).integers(3, 200, 5 + 3 * i)
               for i in range(6)]
    for sched in ("wave", "continuous"):
        kw = (dict(scheduler="continuous", kv_layout="paged", page_size=16)
              if sched == "continuous" else {})
        outs = {}
        for target in (t_gmm, t_ep):
            eng = ServingEngine(target, d, pt, pd, max_batch=4, gamma=4,
                                seed=0, mesh=mesh if target is t_ep else None,
                                **kw)

            def serve():
                first = max(eng.done, default=0)
                for i, p in enumerate(prompts):
                    eng.submit(p, max_new_tokens=8 + i)
                eng.run()
                return [eng.done[u].output.tolist() for u in sorted(eng.done)
                        if u > first]

            outs[target.moe_dispatch] = serve()
        assert outs["ep"] == outs["gmm"], sched
        assert eng.reports[-1].ep["per_shard_load"]
        with compile_guard() as cg, transfer_guard() as tg, \
                sharding_guard(eng) as sg:
            again = serve()
        assert again == outs["ep"]
        assert cg.count == 0, sched
        assert tg.count == 0, (sched, tg.lines[:5])
        assert sg.programs > 0 and sg.ok, sg.render()


# ------------------------------------------------ EP across two cards
def _nccl_rank(rank: int, world: int, path: str, out: str) -> None:
    import torch.distributed as dist
    from repro_torch.configs.base import ModelConfig
    from repro_torch.distributed import collectives
    from repro_torch.launch.mesh import make_ep_mesh
    from repro_torch.models.moe import init_moe, moe_forward
    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", store=dist.FileStore(path, world),
                            rank=rank, world_size=world)
    try:
        mesh = make_ep_mesh(world)
        cfg = ModelConfig("ep", "moe", 2, 64, 4, 2, 128, 256, num_experts=8,
                          num_experts_per_tok=2, moe_d_ff=128,
                          dtype="float32", num_shared_experts=1)
        p = init_moe(cfg, torch.float32,
                     generator=torch.Generator().manual_seed(0), device="cpu")
        p = {k: ({kk: vv.cuda() for kk, vv in v.items()}
                 if isinstance(v, dict) else v.cuda()) for k, v in p.items()}
        x = torch.randn((2, 7, 64), generator=torch.Generator().manual_seed(1)
                        ).cuda()
        y = collectives.moe_ep_forward(p, cfg, x, mesh=mesh)
        y_gmm, _ = moe_forward(p, cfg, x, dispatch="gmm")
        torch.save({"y": y.cpu(), "gmm": y_gmm.cpu()}, f"{out}{rank}.pt")
    finally:
        dist.destroy_process_group()


def test_nccl_ep_dispatch_across_two_cards(cuda):
    """Two ranks on two cards over NCCL: each rank's EP output equals the
    gmm dispatch (skips with fewer than two cards)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards (torch.cuda.device_count() < 2)")
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "y")
        mp.start_processes(_nccl_rank, args=(2, os.path.join(tmp, "store"),
                                             out),
                           nprocs=2, join=True, start_method="spawn")
        for r in range(2):
            res = torch.load(f"{out}{r}.pt")
            torch.testing.assert_close(res["y"], res["gmm"], rtol=3e-4,
                                       atol=3e-4)
