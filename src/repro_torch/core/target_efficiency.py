"""Target efficiency — the paper's systemic metric (Sec. 3.1).

    eta_target(B, gamma) = T_T(B, 1) / T_T(B, gamma + 1)

It isolates how the TARGET model's architecture and the workload's shape
set SD speedup, apart from the draft's acceptance rate.  Two ways to get
it, as in ``repro.core.target_efficiency``:

  * ``measure_target_efficiency`` — time the target's ``extend`` of 1 and
    of gamma + 1 tokens per row.  On the card each extend is one CUDA
    graph replay timed with CUDA events (device time, no host launch
    cost); on the CPU, ``perf_counter`` around eager calls (trends only).
  * ``predicted_target_efficiency`` — the analytic simulator
    (``core/simulator.py``, the ``H100`` record by default).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core.graphs import RoundGraphs
from repro_torch.models.model import Model


def _clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone(v) for v in tree)
    return tree


def measure_extend_time(model: Model, params, cache: dict, n_tokens: int,
                        iters: int = 5, warmup: int = 2,
                        tokens=None) -> float:
    """Median seconds of one ``extend`` of ``n_tokens`` per row: of token 0
    everywhere, as the reference times it, or of the first ``n_tokens``
    columns of ``tokens`` (B, >= n_tokens), so an MoE target routes each
    position as distinct verify tokens would.

    Runs on a clone of ``cache``: ``extend`` writes K/V in place at
    ``lengths .. lengths + n_tokens - 1`` of the clone and nothing is
    committed (``lengths`` stays), so every call sees the same state and
    the caller's cache is never written.  On a CUDA model the extend runs
    once eagerly (the warm-up), is captured in a CUDA graph
    (``RoundGraphs``; a failed capture raises) and the graph is replayed
    ``warmup + iters`` times, each replay timed with CUDA events.  Each
    replay credits the kernels' launch counts and ``forward_count``, as a
    replayed round does.  On the CPU each eager call is timed with
    ``perf_counter``."""
    work = _clone(cache)
    B = int(work["lengths"].shape[0])
    if tokens is None:
        tokens = torch.zeros((B, n_tokens), dtype=torch.int64)
    tokens = torch.as_tensor(tokens)[:, :n_tokens].to(
        device=model.device, dtype=torch.int64)
    on_card = model.device.type == "cuda"
    graphs = RoundGraphs(model.device, capture=on_card, models=(model,))
    key = ("extend", B, n_tokens)
    stages = [lambda _: model.extend(params, tokens, work)[0]]
    graphs.run(key, stages)                   # eager warm-up, then capture
    times = []
    for i in range(warmup + iters):
        if on_card:
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            graphs.run(key, stages)
            end.record()
            end.synchronize()
            t = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            graphs.run(key, stages)
            t = time.perf_counter() - t0
        if i >= warmup:
            times.append(t)
    return float(np.median(times))


def measure_target_efficiency(model: Model, params, cache: dict, gamma: int,
                              iters: int = 5, tokens=None) -> dict:
    """Measured T_T(B, 1), T_T(B, gamma + 1) in seconds and their ratio,
    under the reference's keys; ``tokens`` as in ``measure_extend_time``."""
    t1 = measure_extend_time(model, params, cache, 1, iters, tokens=tokens)
    tg = measure_extend_time(model, params, cache, gamma + 1, iters,
                             tokens=tokens)
    return {"T_T_1": t1, "T_T_gamma": tg, "target_efficiency": t1 / tg}


def predicted_target_efficiency(sim, arch_cfg, batch: int, gamma: int) -> dict:
    """Analytic target efficiency from the simulator (core/simulator.py)."""
    t1 = sim.forward_time(arch_cfg, batch, 1)
    tg = sim.forward_time(arch_cfg, batch, gamma + 1)
    return {"T_T_1": t1, "T_T_gamma": tg, "target_efficiency": t1 / tg}
