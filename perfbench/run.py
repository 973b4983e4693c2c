#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA port (``src/repro_torch``): one run of
one cell on this machine's card.

    python3 perfbench/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout.  The cell, its configuration, traffic mix and
metrics are found by name through ``BENCHMARK.json``; the correctness limits
of the cell are ``perfbench/limits/<cell>.json``.  Prints progress and, as
its last lines on standard error, each number checked beside its limit;
the last line of standard output is the result as one JSON object.  With
``--trace 0`` the metrics are the cell's end-to-end ones, with ``--trace
1`` its per-layer ones, with the trace's ``breakdown``.

Exits non-zero and prints no result without a CUDA card (or with fewer
than the cell asks for), outside a checkout holding the port, or when JAX
or the JAX package got loaded.  Kernel libraries are built into the
checkout's ``build/`` on the first run and found there after it.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card_power() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        log(f"perfbench: no src/repro_torch under {ROOT}: run it from a "
            "checkout of the repository")
        return 2
    # the kernels' caches at fixed places inside the checkout; a library
    # that would pull JAX in through transformers is told not to
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    # this file's folder holds data folders (configs, metrics, ...) that
    # must not shadow a module of the same name
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path if p and Path(p).resolve() != Path(here)]
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from perfbench.harness import cells, runner

    cell = cells.resolve(args.workload, ROOT)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"perfbench: {cell.name} needs {cell.chips} CUDA card(s); "
            f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    path = ROOT / "perfbench" / "limits" / f"{cell.name}.json"
    limits = json.loads(path.read_text()) if path.is_file() else {}
    power = card_power()
    log(f"perfbench: {cell.name} seed {args.seed} trace {args.trace} on "
        f"{power}")
    res = runner.run(cell, args.seed, args.seconds, bool(args.trace),
                     device="cuda", limits=limits, t_start=T_START, log=log)
    bad = runner.forbidden_modules()
    if bad:
        log(f"perfbench: the process loaded {bad}: the port must not load "
            "JAX or the JAX package")
        return 4
    verdict = res["verdict"]
    log(f"widest gap of each sampled request (not compared): "
        f"{verdict['widest_gaps']}; {verdict['tokens_judged']} tokens and "
        f"{verdict['drafts_judged']} drafts judged")
    log(f"card: {power}")
    for name, c in verdict["checks"].items():
        log(f"check {name} {c['value']} limit {c['limit']}")
    device = dict(res["device"], power=power)
    line = {"correct": verdict["correct"], "attempted": verdict["attempted"],
            "failed": verdict["failed"], "metrics": res["metrics"],
            "device": device}
    if res["breakdown"] is not None:
        line["breakdown"] = res["breakdown"]
    line["check"] = verdict["checks"]
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
