#!/usr/bin/env python3
"""The readings a cell's correctness limits are set from, on the card, at the
cell's own sizes: for each seed, the numbers a run compares, ``gap_p90``
and, where the cell drafts, ``draft_gap_p90``, of the program and of the
control (the reference in float8 e4m3 put in the program's place: at each
position of the same prompts, served tokens and drafts, the gap of the
token it puts first).

    python3 perfbench/calibrate.py --workload NAME --seeds 11,12,13

One process: the cell is built and warmed once, then for each seed the
weights are drawn again in place (the captured graphs keep reading them),
one unit of the seed's traffic is served, and the same number of requests
as a run checks is sampled and judged both ways (``check.py``).  ``--layers`` and
``--dtype`` read a witness at another depth or in float32 (not the
cell's: the program and the reference then agree or not on their own).  Prints one
JSON line a seed and a summary line: for each number, the largest program
reading (the limit's lower end) and the smallest control reading (its
upper end).
Benchmark runs never run the control.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def summary(gaps) -> dict:
    """Per request: the widest gap, where it lies (position among the
    served tokens), and the share of tokens that are not the reference's
    argmax; and the same over all."""
    import torch
    gaps = [g for g in gaps if g is not None and g.numel()]
    if not gaps:
        return {}
    every = torch.cat(gaps)
    return {"widest": [float(g.max()) for g in gaps],
            "at": [int(g.argmax()) for g in gaps],
            "off_share": [float((g > 0).float().mean()) for g in gaps],
            "all_off_share": float((every > 0).float().mean()),
            "all_p90": float(every.quantile(0.9)),
            "tokens": int(every.numel())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--layers", type=int, default=None,
                    help="a witness at another depth (not the cell's)")
    ap.add_argument("--dtype", default=None,
                    help="a witness in another dtype, e.g. float32")
    args = ap.parse_args(argv)
    os.environ["USE_FLAX"] = "0"
    here = Path(__file__).resolve().parent
    sys.path[:] = [p for p in sys.path if p and Path(p).resolve() != here]
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 3
    from perfbench.harness import cells, check, runner, traffic

    cell = cells.resolve(args.workload, ROOT)
    if args.layers:
        cell.config["num_hidden_layers"] = args.layers
    if args.dtype:
        cell.config["torch_dtype"] = args.dtype
    seeds = [int(s) for s in args.seeds.split(",")]
    spec = cells.target_spec(cell.config)
    tr = cell.traffic
    t0 = time.perf_counter()
    system = runner.build(cell, seeds[0], "cuda")
    runner.serve(system, runner.warm_group(tr, seeds[0], spec["vocab"],
                                           tr.get("warm_tokens")))
    print(f"calibrate: {cell.name} built and warmed in "
          f"{time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
    names = ["gap_p90"] + (["draft_gap_p90"] if system.speculate else [])
    program = {n: [] for n in names}
    control = {n: [] for n in names}
    for seed in seeds:
        system.weights.refill(seed)
        unit = runner.serve(system, traffic.unit(tr, seed, 0, spec["vocab"]))
        reqs = unit.requests
        clean = [r for r in reqs if r.finish_reason in ("length", "eos")]
        picked = check.pick(clean, seed)
        sample = [(np.asarray(r.prompt), np.asarray(r.output))
                  for r in picked]
        drafter = None
        if system.speculate:
            drafter = check.drafter_inputs(
                cells.draft_spec(cell.config),
                {"target": system.weights["target"],
                 "draft": system.weights["draft"]},
                check.find_traces([unit.rounds] * len(sample), sample), seed)
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        gp, dp = check.reference_gaps(spec, system.weights["target"], sample,
                                      drafter=drafter)
        t2 = time.perf_counter()
        gc, dc = check.reference_gaps(spec, system.weights["target"], sample,
                                      precision="fp8", drafter=drafter)
        line = {"seed": seed, "requests": len(reqs), "clean": len(clean),
                "reference_s": t2 - t1, "unit_s": unit.seconds}
        for n, (p, c) in zip(names, [(gp, gc), (dp, dc)]):
            program[n].append(check.gap_p90(p))
            control[n].append(check.gap_p90(c))
            line[n] = {"program": program[n][-1], "control": control[n][-1],
                       "program_summary": summary(p),
                       "control_summary": summary(c)}
        print(json.dumps(line), flush=True)
    print(json.dumps({"workload": cell.name, "seeds": seeds,
                      "layers": cell.config["num_hidden_layers"],
                      "dtype": cell.config.get("torch_dtype"),
                      **{n: {"program_max": max(program[n]),
                             "control_min": min(control[n]),
                             "program": program[n], "control": control[n]}
                         for n in names}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
