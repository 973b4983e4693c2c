"""One run of one cell: set-up, the measured window, the traced stretch and
the check of what the window served.

Set-up makes the weights on the device from the seed, builds the program's
models and its ``ServingEngine``, and serves the first group of a warm-up
unit of the cell's own traffic (every round key and prompt bucket the
window can meet; its outputs cut to ``warm_tokens`` where the mix gives
it, which a stream's round key and page pool do not depend on; a stream's
later admissions of a few rows run eagerly and first meet their shapes in
the window), plus, in a traced run, a short unit in the timed mode.  The window then serves whole units through ``ServingEngine.run()``
until ``seconds`` have passed; the unit in flight at that moment finishes
inside the window, and rates and tails are taken over the window's elapsed time
and all of its requests.  A traced run then serves one more unit under
``torch.profiler`` and one in the timed mode, for the per-layer metrics.
Last, with the program's state freed, the reference judges a sample of the
window's requests (``check.py``).
"""
from __future__ import annotations

import gc
import sys
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from perfbench.harness import (cells, check, costs, drafts,
                               traffic as traffic_mod)
from perfbench.harness.weights import Weights, eagle_shapes, model_shapes

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules (``sys.modules`` by default) whose top-level name is
    JAX's or the JAX package's, compared whole."""
    names = list(sys.modules if modules is None else modules)
    return sorted({m.split(".")[0] for m in names
                   if m.split(".")[0] in FORBIDDEN})


def _port_config(spec: dict, name: str, dtype: str):
    from repro_torch.configs.base import ModelConfig
    shared = 0
    if spec["shared_ff"]:
        if spec["shared_ff"] % spec["expert_ff"]:
            raise ValueError(f"{name}: shared expert width "
                             f"{spec['shared_ff']} is not a whole number of "
                             f"experts of {spec['expert_ff']}")
        shared = spec["shared_ff"] // spec["expert_ff"]
    return ModelConfig(
        name=name, family="moe" if spec["experts"] else "dense",
        num_layers=spec["layers"], d_model=spec["d"],
        num_heads=spec["heads"], num_kv_heads=spec["kv_heads"],
        head_dim=spec["head_dim"],
        d_ff=spec["expert_ff"] if spec["experts"] else spec["ff"],
        vocab_size=spec["vocab"], num_experts=spec["experts"],
        num_experts_per_tok=spec["top_k"],
        moe_d_ff=spec["expert_ff"] if spec["experts"] else 0,
        num_shared_experts=shared, qkv_bias=spec["qkv_bias"],
        rope_theta=spec["theta"], norm_eps=spec["eps"],
        tie_embeddings=spec["tie"], dtype=dtype, source=name)


@dataclass
class System:
    """The program under test and the benchmark's weights."""
    spec: dict
    weights: Weights
    engine: object
    speculate: bool
    recorder: Optional[drafts.Recorder] = None


def build(cell: cells.Cell, seed: int, device: str) -> System:
    """The weights from ``seed`` and the program's engine over them."""
    import torch
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import ServingEngine

    if torch.device(device).type == "cuda":
        # every kernel library at once (one nvcc each) where not yet built
        from repro_torch.kernels import build as kernel_build
        kernel_build.build_all(sorted(
            (cell.root / "src" / "repro_torch" / "kernels").rglob("csrc/*.cu")))
    cfg, tr = cell.config, cell.traffic
    spec, dspec = cells.target_spec(cfg), cells.draft_spec(cfg)
    serving = cfg.get("serving", {})
    dtype = cfg.get("torch_dtype", "bfloat16")
    tdtype = getattr(torch, dtype)
    speculate = bool(tr["speculate"]) and dspec is not None
    shapes = {"target": model_shapes(spec)}
    if speculate and dspec["kind"] == "model":
        shapes["draft"] = model_shapes(dspec)
    elif speculate:
        shapes["draft"] = eagle_shapes(spec, dspec)
    weights = Weights(shapes, seed, device, dtype=tdtype)
    kw = dict(use_flash=bool(serving.get("use_flash", True)), device=device)
    target = Model(_port_config(spec, cell.config_name, dtype),
                   moe_dispatch=serving.get("moe_dispatch", "gmm"), **kw)
    draft, kind = None, "none"
    if speculate and dspec["kind"] == "model":
        draft = Model(_port_config(dspec, cfg["draft"]["name"], dtype), **kw)
        kind = "model"
    elif speculate:
        from repro_torch.core.eagle import EagleHead
        draft = EagleHead(target)
        hc = draft.cfg
        got = (hc.num_heads, hc.num_kv_heads, hc.head_dim, hc.d_ff,
               hc.num_layers)
        want = (dspec["heads"], dspec["kv_heads"], dspec["head_dim"],
                dspec["ff"], dspec["layers"])
        if got != want:
            raise ValueError(f"the program's EAGLE head is {got} (heads, KV "
                             f"heads, head size, FFN, layers); the "
                             f"configuration states {want}")
        kind = "eagle"
    engine = ServingEngine(
        target, draft, weights["target"],
        weights["draft"] if speculate else None,
        max_batch=int(tr["max_batch"]),
        **({"gamma": int(tr["gamma"])} if speculate else {}),
        temperature=0.0, proposer=kind, seed=int(seed) % (1 << 63),
        scheduler=tr["scheduler"], kv_layout=tr.get("kv_layout", "dense"),
        page_size=int(tr.get("page_size", 64)))
    # the drafts the timed path proposes, for the check; installed before
    # the first round, so that every captured round holds the copy
    recorder = drafts.Recorder(engine._session(kind)) if speculate else None
    return System(spec=spec, weights=weights, engine=engine,
                  speculate=speculate, recorder=recorder)


@dataclass
class UnitResult:
    requests: list                     # the program's finished Requests
    prompts: List[int]
    reports: list
    seconds: float
    rounds: list                       # drafts.Round of each round served


def serve(system: System, reqs: List[traffic_mod.Request]) -> UnitResult:
    """Submit one unit at once and serve it to its end."""
    eng = system.engine
    rec = system.recorder
    if rec is not None:
        rec.rounds = []
    t0 = time.perf_counter()
    uids = [eng.submit(r.prompt, max_new_tokens=r.max_new) for r in reqs]
    reports = eng.run()
    dt = time.perf_counter() - t0
    return UnitResult([eng.done[u] for u in uids],
                      [len(r.prompt) for r in reqs], reports, dt,
                      rec.rounds if rec is not None else [])


def warm_group(traffic: dict, seed: int, vocab: int, cap) -> list:
    """The first group of the warm-up unit, every stratum once, with its
    outputs cut to ``cap`` tokens (None: as drawn)."""
    warm = traffic_mod.unit(traffic, seed, -1, vocab)[: int(traffic["strata"])]
    if cap:
        for r in warm:
            r.max_new = min(r.max_new, int(cap))
    return warm


def session_graphs(system: System) -> list:
    return [s.graphs for s in system.engine._sessions.values()]


def capture_seconds(system: System) -> float:
    return sum(sum(g.capture_seconds.values()) for g in session_graphs(system))


@dataclass
class Forward:
    """One target forward of a unit: its rows, and, where a forward of
    that many rows may leave experts idle, the (request, position) of each
    row's token when the window served it (None: not known)."""
    rows: int
    tokens: Optional[List[Tuple[int, int]]] = None
    all_active: bool = True


def forwards(spec: dict, unit: UnitResult) -> List[Forward]:
    """Every target forward the unit ran, from the scheduler's reports: a
    wave prefills its padded batch at its padded prompt bucket and verifies
    ``bucket * (gamma + 1)`` rows a round; a stream opens its pool with
    one-token fillers, prefills each boundary's admissions
    (``admit_tokens``) and verifies ``pool * (gamma + 1)`` rows a round.
    Without drafting, a wave's round r decodes served token r of each row
    at position prompt + r."""
    out: List[Forward] = []

    def fwd(rows, tokens=None):
        many = costs.expected_idle(rows, spec) < costs.ALL_ACTIVE_IDLE
        out.append(Forward(rows, None if many else tokens, many))

    first = 0
    for rep in unit.reports:
        if rep.scheduler == "wave":
            idx = list(range(first, first + rep.batch))
            first += rep.batch
            T = 1
            while T < max(unit.prompts[i] for i in idx):
                T *= 2
            fwd(rep.bucket * T)
            rows = [idx[b % len(idx)] for b in range(rep.bucket)]
            for r in range(rep.stats.rounds):
                fwd(rep.bucket * (rep.gamma + 1),
                    [(i, unit.prompts[i] + r) for i in rows]
                    if rep.gamma == 0 else None)
        else:
            fwd(rep.bucket, [(len(unit.requests), 0)] * rep.bucket)
            for s in rep.steps:
                if s.admit_tokens:
                    fwd(s.admit_tokens)
                if s.live:
                    fwd(rep.bucket * (s.gamma + 1))
    return out


def active_experts(spec: dict, fw: List[Forward], routes) -> Optional[list]:
    """(rows, active experts of each layer) of every forward: every expert
    where the rows make that near certain, else the distinct experts the
    reference routes the forward's tokens to (``routes[layer][request]``,
    (L, top_k), for each request a forward names); None when a forward's
    tokens are not known."""
    out = []
    for f in fw:
        if f.all_active:
            out.append((f.rows, None))
            continue
        if f.tokens is None or routes is None:
            return None
        out.append((f.rows, [
            len({int(e) for i, p in f.tokens for e in layer[i][p]})
            for layer in routes]))
    return out


@dataclass
class Context:
    """What the per-layer readers read (``perfbench/metrics``)."""
    cell: cells.Cell
    spec: dict
    speculate: bool
    window_units: List[UnitResult]
    window_s: float
    window_captures: int
    setup_capture_s: float
    memory_peak_bytes: int
    trace: object = None               # trace.Trace of the profiled unit
    traced_unit: Optional[UnitResult] = None
    traced_forwards: Optional[list] = None  # (rows, active) a forward
    timed_unit: Optional[UnitResult] = None

    @property
    def window_reports(self) -> list:
        return [r for u in self.window_units for r in u.reports]

    @property
    def window_requests(self) -> list:
        return [r for u in self.window_units for r in u.requests]


def end_to_end(requests, window_s: float, setup_s: float) -> dict:
    """The end-to-end metrics of a window: the output tokens of cleanly
    finished requests over its elapsed time; the 90th percentile over all
    its requests of finished_at - submitted_at (the program's host clock),
    None with fewer than 100 requests (fewer than ten beyond it); the set-up
    time."""
    clean = [r for r in requests if r.finish_reason in ("length", "eos")]
    lat = [r.finished_at - r.submitted_at for r in requests
           if r.finished_at is not None]
    return {"tokens_per_s": sum(len(r.output) for r in clean) / window_s,
            "request_p90_s": costs.percentile(lat, 90)
            if len(lat) >= 100 else None,
            "setup_s": setup_s}


def run(cell: cells.Cell, seed: int, seconds: float, trace: bool,
        device: str = "cuda", limits: Optional[dict] = None,
        t_start: Optional[float] = None, log=print,
        sample: int = check.SAMPLE) -> dict:
    """One run; returns the result line's object (its ``check`` last)."""
    import torch
    t_start = time.perf_counter() if t_start is None else t_start
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    tr = cell.traffic
    spec = cells.target_spec(cell.config)
    vocab = spec["vocab"]
    system = build(cell, seed, device)

    # ---- set-up: a group of the cell's own traffic warms every shape
    serve(system, warm_group(tr, seed, vocab, tr.get("warm_tokens")))
    setup_capture_s = capture_seconds(system)
    if trace:
        # the timed mode's stage graphs
        system.engine.timed = True
        serve(system,
              warm_group(tr, seed, vocab, tr.get("timed_warm_tokens")))
        system.engine.timed = False
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start

    # ---- the window: whole units until `seconds` have passed
    caps0 = sum(g.total_captures for g in session_graphs(system))
    units: List[UnitResult] = []
    k = 0
    t0 = time.perf_counter()
    while True:
        units.append(serve(system, traffic_mod.unit(tr, seed, k, vocab)))
        k += 1
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    window_captures = sum(g.total_captures
                          for g in session_graphs(system)) - caps0
    peak = int(torch.cuda.max_memory_allocated()) if on_card else 0

    ctx = Context(cell=cell, spec=spec, speculate=system.speculate,
                  window_units=units, window_s=window_s,
                  window_captures=window_captures,
                  setup_capture_s=setup_capture_s, memory_peak_bytes=peak)
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(0) if on_card
                   else "cpu",
                   "count": 1, "memory_peak_bytes": peak}
    breakdown = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        from perfbench.harness.trace import record
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if on_card else [])
        with profile(activities=acts) as prof:
            with record_function("perfbench.unit"):
                ctx.traced_unit = serve(
                    system, traffic_mod.unit(tr, seed, k, vocab))
        ctx.trace = record(prof)
        del prof
        system.engine.timed = True
        ctx.timed_unit = serve(system,
                               traffic_mod.unit(tr, seed, k + 1, vocab))
        system.engine.timed = False
        device_info["busy_s"] = ctx.trace.busy_s
        device_info["window_s"] = ctx.trace.window_s
        breakdown = ctx.trace.breakdown()

    # ---- the program's state freed: the check, then the metrics
    requests = ctx.window_requests
    clean = [(r, u) for u in units for r in u.requests
             if r.finish_reason in ("length", "eos")]
    attempted = len(requests)
    failed = attempted - len(clean)
    short = sum(1 for r, _ in clean if len(r.output) != r.max_new_tokens)
    picked = check.pick(clean, seed, sample, request=lambda it: it[0])
    seqs = [(np.asarray(r.prompt), np.asarray(r.output)) for r, _ in picked]
    drafter = None
    if system.speculate:
        drafter = check.drafter_inputs(
            cells.draft_spec(cell.config),
            {"target": system.weights["target"],
             "draft": system.weights["draft"]},
            check.find_traces([u.rounds for _, u in picked], seqs), seed)
    weights = system.weights
    del system
    gc.collect()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    verdict = check.judge(spec, weights["target"], seqs, limits or {},
                          failed=failed, short=short, drafter=drafter)
    verdict["attempted"] = attempted
    if trace and spec["experts"]:
        from repro_torch.data.tokenizer import PAD
        fw = forwards(spec, ctx.traced_unit)
        seqs = [np.concatenate([r.prompt, r.output])
                for r in ctx.traced_unit.requests] + [np.array([PAD])]
        # the reference routes only the requests a forward names
        named = sorted({i for f in fw if f.tokens for i, _ in f.tokens})
        routes = None
        if named:
            got = check.routes(spec, weights["target"],
                               [seqs[i] for i in named])
            routes = [dict(zip(named, layer)) for layer in got]
        ctx.traced_forwards = active_experts(spec, fw, routes)
    metrics: Dict[str, dict] = {}
    if trace:
        for m in cell.per_layer:
            value = cells.metric_reader(m["name"], cell.root).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
    else:
        e2e = end_to_end(requests, ctx.window_s, setup_s)
        for m in cell.end_to_end:
            if e2e.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": float(e2e[m["name"]]),
                                      "unit": m["unit"]}
        log(f"window: {len(ctx.window_units)} units, {attempted} requests, "
            f"{ctx.window_s:.3f} s, {window_captures} captures")
    return {"metrics": metrics, "device": device_info,
            "breakdown": breakdown, "verdict": verdict}
