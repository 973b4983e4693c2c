"""Dry-run: count one step of every (arch x input shape x H100 mesh)
combination on the ``meta`` device, allocating nothing and computing
nothing.

Port of ``repro.launch.dryrun``.  The reference lowers and compiles each
step for a TPU pod with placeholder host devices and reads XLA's memory
and cost analyses and the collectives of its partitioned HLO.  Torch
compiles nothing: here rank 0's step runs on its own blocks, as meta
tensors, over a ``launch/mesh.CensusMesh`` (axis sizes alone, no process
group), and ``launch/costs.StepCounter`` counts what runs:

  * meshes of H100s: ``"1x8"`` one HGX node of 8 cards over NVLink
    (``{"data": 1, "model": 8}``), ``"4x8"`` (``--multi-node``) four such
    nodes, the data axis across InfiniBand (``{"data": 4, "model": 8}``);
  * resident bytes per rank: the weights, the cache, the optimizer state
    (train) and the batch, placed by the port's rules
    (``distributed/sharding``: ``param_spec`` through ``Model.place``,
    ``cache_spec`` through ``shard_cache``, ``batch_spec``,
    ``local_shape``) under ``--layout``, ``--kv-mode`` and
    ``--fsdp-min-size``, as in the reference;
  * FLOPs per rank: ``torch.utils.flop_counter``'s formulas over rank 0's
    step (``serving/serve_step``: prefill, AR decode, SD verify with
    ``--gamma``; ``training/train_loop.make_train_step``);
  * bytes per rank: every operation's operands and results, once each.
    This is an UNFUSED count: each operation is taken to read its inputs
    from device memory and write its outputs there, which the card's
    kernels avoid wherever they fuse (attention, the expert FFN);
  * the transient peak: the most bytes live at once over the step beyond
    the resident ones; ``peak_bytes`` is resident + transient;
  * the collective census: every collective the step issues, by kind, its
    operand bytes on this rank, ``in_loop`` (issued by a layer of the
    stack) and ``outside``, and by mesh axis.  ``in_loop`` is one
    period's (the reference counts its scan body once), so ``in_loop x
    num_periods + outside`` is the step's ``total``.

A recurrence's steps are counted by one step repeated (``models/ssm.py``),
so a 32k-token prefill of a recurrent arch takes seconds.

``--moe-dispatch`` is ``onehot`` (the reference's default), ``gmm`` or
``ep``.  ``gmm`` and ``ep`` size their expert groups from the routing,
which the meta device does not hold: their ragged products are counted on
a stated uniform routing (``launch/costs.stated_group_sizes``: every
expert receives floor(R/E) of the R routed rows, the first R mod E one
more), and the record says so (``knobs["routing"]: "uniform"``).  Under
``ep`` the all-to-all census counts the padded slot buffers the dispatch
sends (drop-free: N_loc·K slots a destination), not
``core/perf_model.ep_a2a_bytes``'s mean.  Under either, a step under
autograd (``train_4k`` of a MoE arch) stops at the kernels' refusal, as
in the reference.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-7b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-node --out results/dryrun.jsonl

One JSON line per combination (the reference's keys where they carry over),
on stdout and, with ``--out``, appended to that file; ``real_tensors``
counts the step's results off the meta device (0: nothing was
allocated).  Imports the port alone; the counts never touch a device.
"""
from __future__ import annotations

import argparse
import json
import math
import time
from typing import Optional

import torch

from repro_torch.configs.base import INPUT_SHAPES, TrainConfig
from repro_torch.configs.registry import registered
from repro_torch.distributed import collectives as col
from repro_torch.distributed import sharding as sh
from repro_torch.launch.costs import StepCounter
from repro_torch.launch.mesh import CensusMesh
from repro_torch.launch.specs import arch_for_shape, input_specs
from repro_torch.models.model import Model
from repro_torch.serving.serve_step import (make_decode_step,
                                            make_prefill_step,
                                            make_verify_step)
from repro_torch.training.optimizer import init_adam
from repro_torch.training.train_loop import make_train_step

MESHES = {"1x8": {"data": 1, "model": 8}, "4x8": {"data": 4, "model": 8}}
DISPATCHES = ("onehot", "gmm", "ep")


def _batch_bytes(batch: dict, mesh, layout: str) -> int:
    """The bytes of the rows of a whole batch that rank 0 holds
    (``sharding.batch_spec``)."""
    dims = sh.mesh_dims(mesh)
    total = 0
    for t in batch.values():
        spec = sh.batch_spec(mesh, tuple(t.shape), layout)
        total += (math.prod(sh.local_shape(tuple(t.shape), spec, dims))
                  * t.element_size())
    return total


def count_combo(arch: str, shape_name: str, *, multi_node: bool = False,
                gamma: int = 0, moe_dispatch: str = "onehot",
                fsdp_min_size: int = 0, kv_mode: str = "auto",
                layout: str = "tp", remat: Optional[bool] = None,
                extra_overrides: Optional[dict] = None,
                dims: Optional[dict] = None) -> dict:
    """Count rank 0's step of one combination; the record (module
    docstring).  ``dims`` replaces the named mesh (a smaller one, for the
    tests)."""
    if moe_dispatch not in DISPATCHES:
        raise ValueError(
            f"--moe-dispatch {moe_dispatch!r}: the dry-run counts "
            f"{DISPATCHES}")
    shape = INPUT_SHAPES[shape_name]
    cfg = arch_for_shape(arch, shape, gamma)
    if extra_overrides:
        cfg = cfg.with_overrides(**extra_overrides)
    dims = dict(MESHES["4x8" if multi_node else "1x8"] if dims is None
                else dims)
    mesh = CensusMesh(dims)
    train = shape.kind == "train"
    model = Model(cfg, moe_dispatch=moe_dispatch,
                  remat=train if remat is None else remat, device="meta",
                  mesh=mesh, mesh_layout=layout)
    params = model.place(model.init(torch.Generator()), fsdp=train,
                         fsdp_min_size=fsdp_min_size)
    specs = input_specs(cfg, shape, model, gamma)
    counter = StepCounter()
    resident = {"params": counter.pin(params)}
    ep_calls = col.EP_CALLS["moe_ep_forward"]
    t0 = time.time()
    if train:
        opt = init_adam(params)
        batch = specs["batch"]
        resident["opt_state"] = counter.pin(opt)
        counter.pin(batch)           # whole; the step takes rank 0's rows
        resident["batch"] = _batch_bytes(batch, mesh, layout)
        step = make_train_step(model, TrainConfig())
        with counter:
            out = step(params, opt, batch)
    else:
        cache = sh.shard_cache(specs["cache"], mesh, kv_mode=kv_mode)
        del specs["cache"]
        resident["cache"] = counter.pin(cache)
        counter.pin(specs)
        resident["batch"] = _batch_bytes(specs, mesh, layout)
        with counter:
            if shape.kind == "prefill":
                kw = ({"encoder_embeds": specs["encoder_embeds"]}
                      if cfg.is_encoder_decoder else {})
                out = make_prefill_step(model)(params, specs["tokens"], cache,
                                               lengths=specs["lengths"], **kw)
            elif gamma > 0:
                out = make_verify_step(model, gamma)(
                    params, specs["tokens"], specs["n_commit"], cache)
            else:
                out = make_decode_step(model)(params, specs["token"], cache)
    t_count = time.time() - t0
    argument = sum(resident.values())
    coll = dict(counter.collectives)
    coll["in_loop"] = coll["in_loop"] / cfg.num_periods
    knobs = {"moe_dispatch": moe_dispatch, "kv_mode": kv_mode,
             "fsdp_min_size": fsdp_min_size, "layout": layout}
    if (moe_dispatch == "ep" and any(cfg.moe_pattern)
            and col.EP_CALLS["moe_ep_forward"] == ep_calls):
        # the experts do not divide over "model": moe_ep_forward ran onehot
        knobs["dispatch_ran"] = "onehot"
    elif moe_dispatch != "onehot":
        knobs["routing"] = "uniform"
    return {
        "arch": arch, "config": cfg.name, "shape": shape_name,
        "mesh": "x".join(str(n) for n in dims.values()),
        "devices": math.prod(dims.values()), "gamma": gamma,
        "params": int(cfg.param_count()),
        "active_params": int(cfg.active_param_count()),
        "flops_per_device": float(counter.flops),
        "bytes_per_device": float(counter.bytes),
        "collective_bytes_per_device": coll,
        "collective_bytes_by_axis": dict(counter.collectives_by_axis),
        "memory": {
            "argument_bytes": argument,
            "resident_bytes": resident,
            "output_bytes": counter.new_bytes(out),
            "temp_bytes": counter.allocated,
            "transient_peak_bytes": counter.peak,
            "peak_bytes": argument + counter.peak,
        },
        "real_tensors": counter.real,
        "count_s": round(t_count, 2),
        "knobs": knobs,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES))
    ap.add_argument("--all", action="store_true",
                    help="every registered arch x every input shape")
    ap.add_argument("--multi-node", action="store_true",
                    help='the "4x8" mesh (4 nodes of 8) instead of "1x8"')
    ap.add_argument("--gamma", type=int, default=0,
                    help=">0 counts the SD verify step instead of AR decode")
    ap.add_argument("--moe-dispatch", default="onehot")
    ap.add_argument("--fsdp-min-size", type=int, default=0)
    ap.add_argument("--kv-mode", default="auto",
                    choices=["auto", "seq", "heads"])
    ap.add_argument("--layout", default="tp", choices=["tp", "fsdp"])
    ap.add_argument("--out", default=None, help="append JSONL here")
    args = ap.parse_args(argv)
    if args.all:
        combos = [(a, s) for a in registered() for s in INPUT_SHAPES]
    elif args.arch and args.shape:
        combos = [(args.arch, args.shape)]
    else:
        ap.error("give --arch and --shape, or --all")
    if args.moe_dispatch not in DISPATCHES:
        ap.error(f"--moe-dispatch must be one of {DISPATCHES}")
    for arch, shape in combos:
        try:
            res = count_combo(arch, shape, multi_node=args.multi_node,
                              gamma=args.gamma,
                              moe_dispatch=args.moe_dispatch,
                              fsdp_min_size=args.fsdp_min_size,
                              kv_mode=args.kv_mode, layout=args.layout)
            res["status"] = "ok"
        except Exception as e:  # noqa: BLE001 — report, don't abort the sweep
            res = {"arch": arch, "shape": shape,
                   "mesh": "4x8" if args.multi_node else "1x8",
                   "status": "fail", "error": f"{type(e).__name__}: {e}"}
        line = json.dumps(res)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
