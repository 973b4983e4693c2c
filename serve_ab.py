#!/usr/bin/env python3
"""Run chip_smoke.py's serve phase for one or more source trees in turns, so
that the fixed-gamma serve lines of two versions are compared in one run on
one card.

    python3 serve_ab.py ROOT [ROOT ...] [--repeat N] [--seed S]

Each ROOT is a directory holding ``chip_smoke.py`` and ``src/repro_torch``:
this checkout (``.``) or another commit unpacked with ``git archive`` into
an ignored directory of it, e.g. the parent:

    mkdir -p build/parent && git archive HEAD~1 | tar -x -C build/parent
    python3 serve_ab.py build/parent . --repeat 2

The trees run in the order given, then in reverse (A B B A for two trees),
``--repeat`` times, each in a process of its own that loads ROOT's own
``chip_smoke.py``, builds ROOT's kernels (``build_kernels``) and runs its
``serve_phase`` alone: the full-width 4-layer target and full draft, the
wave, continuous paged and wave-flash workloads, each served twice on one
engine.  Every ``serve ... tok/s`` line and propose share that phase prints
is kept under its path, mode and proposer; the last line is a JSON object
of the median of each (tree, line) over all its runs.  Needs an NVIDIA GPU.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

# "serve wave (graphs, again): proposer=model B=8/8 gamma=4 ... 247.65 tok/s"
TOK_S = re.compile(r"^serve (?P<path>[\w-]+(?: paged)?) \((?P<mode>[^)]+)\): "
                   r"proposer=(?P<proposer>\w+) .*? (?P<tps>[\d.]+) tok/s")
# "serve[wave/model] (graphs): propose share of the timed round 0.803"
SHARE = re.compile(r"^serve\[(?P<path>[^\]]+)\] \((?P<mode>\w+)\): propose "
                   r"share of the timed round (?P<share>[\d.]+)")


def child(root: Path, seed: int) -> None:
    """ROOT's build_kernels() and serve_phase(seed), in this process."""
    sys.path.insert(0, str(root / "src"))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_under_test", root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    smoke.build_kernels()
    smoke.serve_phase(seed)


def parse(text: str) -> dict:
    """{line key: [values]} of one serve phase's output."""
    got: dict = {}
    for line in text.splitlines():
        m = TOK_S.match(line)
        if m:
            key = f"{m['path']} ({m['mode']}) {m['proposer']} tok/s"
            got.setdefault(key, []).append(float(m["tps"]))
        m = SHARE.match(line)
        if m:
            key = f"{m['path']} ({m['mode']}) propose share"
            got.setdefault(key, []).append(float(m["share"]))
    return got


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="*", type=Path)
    ap.add_argument("--repeat", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--child", type=Path, default=None)
    args = ap.parse_args()
    if args.child is not None:
        child(args.child.resolve(), args.seed)
        return 0
    if not args.roots:
        ap.error("name at least one ROOT")
    roots = [r.resolve() for r in args.roots]
    order = (roots + roots[::-1]) * args.repeat
    runs: dict = {str(r): {} for r in roots}
    for i, root in enumerate(order):
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--child",
             str(root), "--seed", str(args.seed)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], sep="\n",
                  file=sys.stderr)
            raise SystemExit(f"serve_ab: run {i} ({root}) failed with code "
                             f"{proc.returncode}")
        got = parse(proc.stdout)
        if not got:
            raise SystemExit(f"serve_ab: run {i} ({root}) printed no serve "
                             "line")
        for key, vals in got.items():
            runs[str(root)].setdefault(key, []).extend(vals)
            print(f"run {i} {root}: {key} {vals}", flush=True)
    medians = {root: {key: statistics.median(vals)
                      for key, vals in sorted(per.items())}
               for root, per in runs.items()}
    print(json.dumps({"medians": medians}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
