"""Worlds of gloo ranks for the expert-parallel tests of the port.

``run_world(world, cases, tmp)`` spawns ``world`` CPU processes that join
one gloo process group through a ``FileStore`` under ``tmp`` (no TCP
port), run every case in order on every rank (each case builds its own
mesh with ``launch/mesh.make_ep_mesh``) and return, per rank, a dict of
each case's result.  The inputs come from ``tmp/inputs.pkl``, which the
test wrote with numpy.  Nothing here imports JAX: a spawned rank imports
this module and the port only.
"""
import os
import pickle
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

TIMEOUT_S = 300


def run_world(world: int, cases, tmp: str) -> list:
    """Run ``cases`` ([(name, case function name, kwargs)]) on every rank
    of a world of ``world`` ranks; returns one {name: result} per rank."""
    ctx = mp.start_processes(_rank_main, args=(world, cases, tmp),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + TIMEOUT_S
    try:
        while not ctx.join(timeout=2):
            if time.monotonic() > deadline:
                raise TimeoutError(f"world of {world} ranks did not finish "
                                   f"in {TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    out = []
    for r in range(world):
        with open(os.path.join(tmp, f"world{world}_rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _rank_main(rank: int, world: int, cases, tmp: str) -> None:
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(tmp, f"store{world}"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        with open(os.path.join(tmp, "inputs.pkl"), "rb") as f:
            inputs = pickle.load(f)
        out = {name: CASES[fn](inputs, **kw) for name, fn, kw in cases}
        with open(os.path.join(tmp, f"world{world}_rank{rank}.pkl"),
                  "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------------ helpers
def _cfg(d: dict):
    from repro_torch.configs.base import ModelConfig
    return ModelConfig(**d)


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_t(v) for v in tree]
    return torch.from_numpy(np.array(tree))


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def _mesh(ep: int, data: int = 1):
    from repro_torch.launch.mesh import make_ep_mesh
    return make_ep_mesh(ep, data_degree=data, device="cpu")


def _layer(params: dict, mesh, sharded: bool) -> dict:
    """A MoE layer's params as this rank holds them: its expert block
    (``shard_params``), or whole (the dispatch slices it)."""
    from repro_torch.distributed.sharding import shard_params
    return shard_params({"ffn": params}, mesh)["ffn"] if sharded else params


# -------------------------------------------------------------------- cases
def dispatch(inputs, *, key: str, ep: int, data: int = 1,
             capacity_factor=None, layout=None, sharded: bool = True):
    """moe_ep_forward on inputs[key] = (cfg, params, x) at one mesh, and
    moe_forward(dispatch="ep")'s expert counts; with the number of EP
    calls that dispatched."""
    from repro_torch.distributed import collectives
    from repro_torch.models.moe import moe_forward
    cfg_d, params, x = inputs[key]
    cfg, mesh = _cfg(cfg_d), _mesh(ep, data)
    p = _layer(_t(params), mesh, sharded)
    x = torch.from_numpy(x)
    before = collectives.EP_CALLS["moe_ep_forward"]
    y = collectives.moe_ep_forward(p, cfg, x, mesh=mesh, layout=layout,
                                   capacity_factor=capacity_factor)
    y2, m = moe_forward(p, cfg, x, dispatch="ep", mesh=mesh,
                        mesh_layout=layout, return_metrics=True)
    return {"y": _np(y), "y_moe_forward": _np(y2),
            "expert_counts": _np(m["expert_counts"]),
            "ep_calls": collectives.EP_CALLS["moe_ep_forward"] - before,
            "w_gate_rows": p["w_gate"].shape[0]}


def shard(inputs, *, key: str, ep: int, data: int = 1, layout: str = "tp"):
    """Which expert block each leaf of a 2-layer params tree kept."""
    from repro_torch.distributed.sharding import shard_params
    _, params, _ = inputs[key]
    mesh = _mesh(ep, data)
    tree = {"layers": [{"ffn": _t(params)}, {"ffn": _t(params)}],
            "embed": {"table": torch.zeros((4, 2))}}
    out = shard_params(tree, mesh, layout=layout)
    return {"rank_in_model": mesh.get_local_rank("model"),
            "leaves": {f"{l}/{k}": _np(v) for l, layer in
                       enumerate(out["layers"]) for k, v in
                       layer["ffn"].items() if k != "shared"},
            "embed_is_same": out["embed"]["table"] is tree["embed"]["table"]}


def warm(inputs, *, ep: int, sharded: bool):
    """warm_experts under a mesh: this rank's buffers, per layer."""
    from repro_torch.models.moe import PrefetchPlan, warm_experts
    cfg_d, layers, ids = inputs["warm"]
    cfg, mesh = _cfg(cfg_d), _mesh(ep)
    lp = [{"ffn": _layer(_t(p), mesh, sharded)} for p in layers]
    plan = PrefetchPlan(
        masks=tuple(torch.zeros((cfg.num_experts,), dtype=torch.bool)
                    for _ in layers),
        expert_ids=tuple(torch.from_numpy(i) for i in ids))
    out = warm_experts(lp, cfg, plan, mesh=mesh)
    out = warm_experts(lp, cfg, plan, mesh=mesh, out=out)   # in place again
    return [{k: _np(v) for k, v in layer.items()} for layer in out]


def _models(inputs, mesh):
    from repro_torch.models.convert import params_from_jax
    from repro_torch.models.model import Model
    tcfg, dcfg = _cfg(inputs["tcfg"]), _cfg(inputs["dcfg"])
    t = Model(tcfg, moe_dispatch="ep", mesh=mesh, device="cpu")
    d = Model(dcfg, device="cpu")
    pt = params_from_jax(inputs["pt"], tcfg, "cpu")
    pd = params_from_jax(inputs["pd"], dcfg, "cpu")
    return t, d, pt, pd


def sd_rounds(inputs, *, ep: int):
    """Greedy SD rounds at gamma 4 and 0 on an ep mesh (the reference's
    test_sd_rounds_token_identical_on_1xN_mesh)."""
    from repro_torch.core.proposer import make_proposer
    from repro_torch.core.spec_decode import SDEngine
    from repro_torch.distributed.sharding import shard_params
    mesh = _mesh(ep)
    t, d, pt, pd = _models(inputs, mesh)
    pt = shard_params(pt, mesh)
    eng = SDEngine(t, make_proposer("model", t, d), gamma=4)
    prompts = (np.arange(24).reshape(4, 6) % 250 + 1).astype(np.int32)
    state = eng.start(pt, pd, prompts, max_seq=64)
    rows = [state.last_token.tolist()]
    for g in (4, 0, 4, 4, 0):
        state, res = eng.round(state, gamma=g)
        rows.append((res.n_commit.tolist(),
                     [res.committed[b, :res.n_commit[b]].tolist()
                      for b in range(4)]))
    return {"rows": rows, "engine_mesh": eng.mesh is mesh,
            "expert_rows": pt["layers"][0]["ffn"]["w_gate"].shape[0]}


def stream(inputs, *, ep: int):
    """The continuous paged stream with admission and page-pressure
    preemption (the reference's test_continuous_stream_parity_preemption_
    and_zero_retrace), then the same stream warm under compile_guard and
    sharding_guard."""
    from repro_torch.analysis import compile_guard, sharding_guard
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.faults import ResilienceConfig
    mesh = _mesh(ep)
    t, d, pt, pd = _models(inputs, mesh)
    eng = ServingEngine(t, d, pt, pd, max_batch=3, gamma=2, force_sd=True,
                        scheduler="continuous", kv_layout="paged",
                        page_size=8, seed=0,
                        resilience=ResilienceConfig(max_pool_pages=8),
                        mesh=mesh)

    def run():
        ua = eng.submit(np.arange(3, 9), max_new_tokens=16)
        ub = eng.submit(np.arange(4, 10), max_new_tokens=8, arrival_round=1)
        uc = eng.submit(np.arange(5, 11), max_new_tokens=8, arrival_round=2)
        eng.run()
        return [eng.done[u].output.tolist() for u in (ua, ub, uc)]

    first = run()
    preempted = eng.fault_counters.get("preemptions", 0)
    eng._slot_scheduler._alloc.assert_no_leaks()
    rep = eng.reports[-1].ep
    with compile_guard() as cg, sharding_guard(eng) as sg:
        again = run()
    return {"first": first, "again": again, "preemptions": preempted,
            "ep": rep, "compile_count": cg.count, "sharding_ok": sg.ok,
            "sharding_programs": sg.programs, "render": sg.render(),
            "expert_rows": eng.params_t["layers"][0]["ffn"]["w_gate"].shape[0]}


CASES = {"dispatch": dispatch, "shard": shard, "warm": warm,
         "sd_rounds": sd_rounds, "stream": stream}
