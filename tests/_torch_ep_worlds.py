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
    return join_world(start_world(world, cases, tmp))


def start_world(world: int, cases, tmp: str):
    """``run_world`` without waiting: the handle ``join_world`` takes, so
    the caller can compute while the ranks run."""
    ctx = mp.start_processes(_rank_main, args=(world, cases, tmp),
                             nprocs=world, join=False, start_method="spawn")
    return ctx, world, tmp


def join_world(handle) -> list:
    ctx, world, tmp = handle
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


def _layer(params: dict, mesh, sharded: bool):
    """A MoE layer's params as this rank holds them, and their resolved
    placement: its blocks (``shard_params``: the experts, and under "tp"
    the shared expert's columns and rows), or whole (None: the dispatch
    slices the experts)."""
    from repro_torch.distributed import sharding as sh
    if not sharded:
        return params, None
    tree = {"ffn": params}
    specs = sh.resolve_tree(sh.param_placement(tree, mesh),
                            sh.mesh_dims(mesh))
    return sh.shard_params(tree, mesh)["ffn"], specs["ffn"]


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
    p, specs = _layer(_t(params), mesh, sharded)
    shard = collectives.Shard(mesh, layout or "tp", params=specs)
    x = torch.from_numpy(x)
    before = collectives.EP_CALLS["moe_ep_forward"]
    y = collectives.moe_ep_forward(p, cfg, x, mesh=mesh, layout=layout,
                                   capacity_factor=capacity_factor,
                                   shard=shard)
    y2, m = moe_forward(p, cfg, x, dispatch="ep", mesh=mesh,
                        mesh_layout=layout, return_metrics=True, shard=shard)
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
            "embed": {"table": torch.arange(8.0).reshape(4, 2)}}
    out = shard_params(tree, mesh, layout=layout)
    return {"rank_in_model": mesh.get_local_rank("model"),
            "leaves": {f"{l}/{k}": _np(v) for l, layer in
                       enumerate(out["layers"]) for k, v in
                       layer["ffn"].items() if k != "shared"},
            "embed": _np(out["embed"]["table"]),
            "embed_is_same": out["embed"]["table"] is tree["embed"]["table"]}


def warm(inputs, *, ep: int, sharded: bool):
    """warm_experts under a mesh: this rank's buffers, per layer."""
    from repro_torch.models.moe import PrefetchPlan, warm_experts
    cfg_d, layers, ids = inputs["warm"]
    cfg, mesh = _cfg(cfg_d), _mesh(ep)
    lp = [{"ffn": _layer(_t(p), mesh, sharded)[0]} for p in layers]
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
    mesh = _mesh(ep)
    t, d, pt, pd = _models(inputs, mesh)
    pt = t.place(pt)
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


# ------------------------------------------------- tensor-parallel cases
def _shapes(tree) -> dict:
    from repro_torch.training.tree import tree_items
    return {p: tuple(v.shape) for p, v in tree_items(tree)}


def _cache_shapes(cache: dict) -> dict:
    """A placed cache's leaf shapes and, under ``"placement"``, the rows
    of the batch its ``CachePlacement`` says this rank holds."""
    cache = dict(cache)
    return dict(_shapes({k: v for k, v in cache.items()
                         if k != "placement"}),
                placement=cache["placement"].rows)


def tp_shapes(inputs, *, ep: int, data: int = 1):
    """Every leaf's shape on this rank, for every reduced arch: params as
    ``shard_params`` places them (serving fsdp=False, training fsdp=True)
    under both layouts, the moments of the training placement, and the
    dense and paged caches ``Model.init_cache(placed=True)`` allocates
    under a mesh (meta tensors: shapes only)."""
    from repro_torch.distributed.sharding import mesh_coords, shard_params
    from repro_torch.models.model import Model
    from repro_torch.training.optimizer import init_adam
    mesh = _mesh(ep, data)
    out = {"coords": mesh_coords(mesh)}
    for name, cfg_d in inputs["archs"]:
        cfg = _cfg(cfg_d)
        whole = Model(cfg, device="meta").init(torch.Generator())
        for layout in ("tp", "fsdp"):
            m = Model(cfg, device="meta", mesh=mesh, mesh_layout=layout)
            for fsdp in (False, True):
                placed = shard_params(whole, mesh, fsdp=fsdp, layout=layout)
                out[name, layout, "params", fsdp] = _shapes(placed)
            out[name, layout, "mu"] = _shapes(init_adam(placed).mu)
            B, S = inputs["cache_bs"]
            out[name, layout, "cache"] = _cache_shapes(
                m.init_cache(B, S, placed=True))
            if not cfg.is_encoder_decoder:
                out[name, layout, "paged"] = _cache_shapes(
                    m.init_cache(B, S, paged=True, page_size=16,
                                 placed=True))
    return out


def _tp_models(inputs, mesh, layout: str):
    """The reduced target (EP dispatch) and its draft on ``mesh`` with
    every leaf placed as ``ServingEngine`` places them (``Model.place``)."""
    from repro_torch.models.convert import params_from_jax
    from repro_torch.models.model import Model
    tcfg, dcfg = _cfg(inputs["tcfg"]), _cfg(inputs["dcfg"])
    t = Model(tcfg, moe_dispatch="ep", mesh=mesh, mesh_layout=layout,
              device="cpu")
    d = Model(dcfg, mesh=mesh, mesh_layout=layout, device="cpu")
    pt = t.place(params_from_jax(inputs["pt"], tcfg, "cpu"))
    pd = d.place(params_from_jax(inputs["pd"], dcfg, "cpu"))
    return t, d, pt, pd


def tp_serve(inputs, *, ep: int, data: int = 1, layout: str = "tp",
             rounds: bool = True, stream: bool = True, stream_batch: int = 3):
    """Under full placement: the verify step's fp32 logits (a prefill and
    one gamma-4 verify through ``serving/serve_step``), greedy SD rounds
    at gamma 4 and 0 (``SDEngine``) and the continuous paged stream
    (``ServingEngine`` with a pool of ``stream_batch`` slots: 4 splits its
    rows over a data axis of 2), with the leaf shapes they ran on."""
    from repro_torch.core.proposer import make_proposer
    from repro_torch.core.spec_decode import SDEngine
    from repro_torch.serving import serve_step
    mesh = _mesh(ep, data)
    t, d, pt, pd = _tp_models(inputs, mesh, layout)
    from repro_torch.distributed.sharding import mesh_coords
    out = {"coords": mesh_coords(mesh),
           "wq": tuple(pt["layers"][0]["mixer"]["wq"].shape),
           "embed": tuple(pt["embed"]["table"].shape)}
    prompts, tail = inputs["verify"]
    cache = t.init_cache(prompts.shape[0], inputs["max_seq"], placed=True)
    out["cache_k"] = tuple(cache["layers"][0]["k"].shape)
    last, cache = serve_step.make_prefill_step(t)(pt, prompts, cache)
    logits, cache = serve_step.make_verify_step(t, 4)(
        pt, torch.from_numpy(tail), torch.full((prompts.shape[0],), 3,
                                               dtype=torch.int32), cache)
    dec, cache = serve_step.make_decode_step(t)(
        pt, torch.from_numpy(tail[:, 0]), cache)
    out.update(prefill=_np(last), verify=_np(logits), decode=_np(dec),
               lengths=_np(cache["lengths"]))
    if rounds:
        eng = SDEngine(t, make_proposer("model", t, d), gamma=4)
        state = eng.start(pt, pd, inputs["prompts"],
                          max_seq=inputs["max_seq"])
        rows = [state.last_token.tolist()]
        for g in (4, 0, 4, 4, 0):
            state, res = eng.round(state, gamma=g)
            rows.append((res.n_commit.tolist(),
                         [res.committed[b, :res.n_commit[b]].tolist()
                          for b in range(len(inputs["prompts"]))]))
        out["rows"] = rows
        # the session places the target's cache only, as the reference
        dc = state.p_state["cache"]
        out["draft_cache_whole"] = (
            "placement" in state.t_cache and "placement" not in dc
            and dc["layers"][0]["k"].shape[2] == d.cfg.num_kv_heads)
    if stream:
        # the engine places both models' params itself
        from repro_torch.models.convert import params_from_jax
        from repro_torch.models.model import Model
        from repro_torch.serving.engine import ServingEngine
        from repro_torch.serving.faults import ResilienceConfig
        t = Model(_cfg(inputs["tcfg"]), moe_dispatch="ep", device="cpu")
        d = Model(_cfg(inputs["dcfg"]), device="cpu")
        eng = ServingEngine(
            t, d, params_from_jax(inputs["pt"], t.cfg, "cpu"),
            params_from_jax(inputs["pd"], d.cfg, "cpu"),
            max_batch=stream_batch,
            gamma=2, force_sd=True, scheduler="continuous",
            kv_layout="paged", page_size=8, seed=0,
            resilience=ResilienceConfig(max_pool_pages=8), mesh=mesh,
            mesh_layout=layout)
        ua = eng.submit(np.arange(3, 9), max_new_tokens=16)
        ub = eng.submit(np.arange(4, 10), max_new_tokens=8, arrival_round=1)
        uc = eng.submit(np.arange(5, 11), max_new_tokens=8, arrival_round=2)
        eng.run()
        out["stream"] = [eng.done[u].output.tolist() for u in (ua, ub, uc)]
        out["stream_embed"] = tuple(eng.params_t["embed"]["table"].shape)
    return out


def tp_arch_steps(inputs, *, ep: int, data: int = 1, layout: str = "tp"):
    """Every arch of ``inputs["arch_steps"]`` placed on the mesh: a
    prefill, a gamma-4 verify and a decode step through
    ``serving/serve_step`` on a placed cache; the fp32 logits of each."""
    from repro_torch.models.convert import params_from_jax
    from repro_torch.models.model import Model
    from repro_torch.serving import serve_step
    mesh = _mesh(ep, data)
    out = {}
    for name, cfg_d, jparams, (tokens, tail, frames) in inputs["arch_steps"]:
        cfg = _cfg(cfg_d)
        m = Model(cfg, mesh=mesh, mesh_layout=layout, device="cpu")
        p = m.place(params_from_jax(jparams, cfg, "cpu"))
        kw = {} if frames is None else {"encoder_embeds": frames}
        cache = m.init_cache(tokens.shape[0], inputs["arch_max_seq"],
                             placed=True)
        last, cache = serve_step.make_prefill_step(m)(p, tokens, cache, **kw)
        logits, cache = serve_step.make_verify_step(m, 4)(
            p, torch.from_numpy(tail), torch.full((tokens.shape[0],), 3,
                                                  dtype=torch.int32), cache)
        dec, cache = serve_step.make_decode_step(m)(
            p, torch.from_numpy(tail[:, 0]), cache)
        out[name] = {"prefill": _np(last), "verify": _np(logits),
                     "decode": _np(dec)}
    return out


def tp_train(inputs, *, ep: int, data: int, layout: str):
    """One sharded train step (fsdp=True) from the reference's params and
    moments after its first step: this rank's blocks of the updated params
    and moments, and the step's metrics."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.distributed.sharding import (param_placement,
                                                  shard_opt_state)
    from repro_torch.models.model import Model
    from repro_torch.training.train_loop import make_train_step
    from repro_torch.training.tree import tree_items
    mesh = _mesh(ep, data)
    cfg = _cfg(inputs["train_cfg"])
    params, opt = inputs["train_state"]
    params, opt = _t(params), _t(opt)
    from repro_torch.training.optimizer import AdamState
    opt = AdamState(step=opt[0], mu=opt[1], nu=opt[2])
    model = Model(cfg, remat=True, device="cpu", mesh=mesh,
                  mesh_layout=layout)
    placement = param_placement(params, mesh, fsdp=True, layout=layout)
    pp = model.place(params, fsdp=True)
    po = shard_opt_state(opt, placement, mesh)
    batch = {k: torch.from_numpy(v) for k, v in inputs["train_batch"].items()}
    pp, po, met = make_train_step(model, TrainConfig(
        **inputs["train_kw"]))(pp, po, batch)
    return {"params": {k: _np(v) for k, v in tree_items(pp)},
            "mu": {k: _np(v) for k, v in tree_items(po.mu)},
            "nu": {k: _np(v) for k, v in tree_items(po.nu)},
            "step": int(po.step),
            "metrics": {k: _np(v) for k, v in met.items()}}


CASES = {"dispatch": dispatch, "shard": shard, "warm": warm,
         "sd_rounds": sd_rounds, "stream": stream, "tp_shapes": tp_shapes,
         "tp_serve": tp_serve, "tp_arch_steps": tp_arch_steps,
         "tp_train": tp_train}
