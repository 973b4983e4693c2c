#!/usr/bin/env python3
"""Run chip_smoke.py's serve phase for one or more source trees in turns, so
that the fixed-gamma serve lines of two versions are compared in one run on
one card.

    python3 serve_ab.py ROOT [ROOT ...] [--repeat N] [--seed S]
                        [--prefix | --full | --tokens | --arch PATH[,PATH ...]]

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

``--prefix`` also runs ROOT's ``prefix_faults_phase`` on the served target
after the serve phase (the continuous-prefix and continuous-faults lines).
``--full`` runs each ROOT's whole ``chip_smoke.py`` instead (from ROOT, so
every phase before the serve phase runs before it as it does there) and
keeps, besides the serve lines, the tok/s line of every later path
("continuous-prefix/model (again): ... tok/s", "tuner continuous (again):
... tok/s", ...).
``--tokens`` runs this checkout's ``serve_phase`` and ``ep_phase`` on each
ROOT's ``src/repro_torch`` and kernels (wave, continuous, wave-flash and
wave-ep, SD and AR) and reports, beside the tok/s lines, in how many
requests every run of every tree emits the same greedy tokens (each path
logs a digest of them).
``--arch`` runs the named ARCH_PATHS of this checkout's ``chip_smoke.py``
(``arch_serve_phase``, e.g. ``wave-gemma3,continuous-gemma3,wave-gemma7b``)
on each ROOT's ``src/repro_torch`` and kernels, keeps every wave's tok/s
line and each path's digests of its greedy tokens, and reports in how
many requests every run of every tree agrees.  The routes each launch took
are logged, not held: each tree's own chip_smoke.py holds its routes.
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
# "continuous-prefix/model (again): 94.86 tok/s ...", "tuner continuous
# (again): 193.91 tok/s ...", "wave-eagle/eagle (graphs, again): ... tok/s"
PATH_TOK_S = re.compile(r"^(?P<path>(?:tuner )?[\w-]+(?:/\w+)?) "
                        r"\((?P<mode>[^)]+)\): (?:.*? )?(?P<tps>[\d.]+) tok/s")
# "wave-gemma3/model: tokens digest 0123456789abcdef (requests 01234567 ...)"
DIGEST = re.compile(r"^(?P<path>[\w-]+/\w+): tokens digest (?P<digest>\w+) "
                    r"\(requests (?P<requests>[\w ]+)\)$")


def arch_child(root: Path, seed: int, paths) -> None:
    """This checkout's arch_serve_phase(seed, paths) on ROOT's port and
    kernels, in this process."""
    sys.path.insert(0, str(root / "src"))
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import chip_smoke
    from repro_torch.kernels import build
    build.build_all(tuple(m.SOURCE for m in chip_smoke._counted_modules()))

    def log_routes(path: str, paged: bool) -> None:
        tallies = [m.ROUTE_LAUNCHES for m in chip_smoke._counted_modules()
                   if hasattr(m, "ROUTE_LAUNCHES")]
        chip_smoke.log(f"{path}: launches by (route, head dim) " + "; ".join(
            str(dict(sorted(t.items()))) for t in tallies))
    chip_smoke._check_head_dim_256_routes = log_routes
    chip_smoke.arch_serve_phase(seed, paths=paths)


def tokens_child(root: Path, seed: int) -> None:
    """This checkout's serve_phase and ep_phase on ROOT's port and kernels,
    in this process."""
    sys.path.insert(0, str(root / "src"))
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import chip_smoke
    from repro_torch.kernels import build
    build.build_all(tuple(m.SOURCE for m in chip_smoke._counted_modules()))
    _, served = chip_smoke.serve_phase(seed)
    chip_smoke.ep_phase(seed, served)


def child(root: Path, seed: int, prefix: bool) -> None:
    """ROOT's build_kernels() and serve_phase(seed), then with ``prefix``
    its prefix_faults_phase, in this process."""
    sys.path.insert(0, str(root / "src"))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_under_test", root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    smoke.build_kernels()
    _, served = smoke.serve_phase(seed)
    if prefix:
        smoke.prefix_faults_phase(seed, served)


def parse(text: str) -> dict:
    """{line key: [values]} of one run's output."""
    got: dict = {}
    for line in text.splitlines():
        m = TOK_S.match(line)
        if m:
            key = f"{m['path']} ({m['mode']}) {m['proposer']} tok/s"
            got.setdefault(key, []).append(float(m["tps"]))
            continue
        m = SHARE.match(line)
        if m:
            key = f"{m['path']} ({m['mode']}) propose share"
            got.setdefault(key, []).append(float(m["share"]))
            continue
        m = PATH_TOK_S.match(line)
        if m and not line.startswith("serve "):
            key = f"{m['path']} ({m['mode']}) tok/s"
            got.setdefault(key, []).append(float(m["tps"]))
            continue
        m = DIGEST.match(line)
        if m:
            got.setdefault(f"{m['path']} digest", []).append(m["requests"])
    return got


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="*", type=Path)
    ap.add_argument("--repeat", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--child", type=Path, default=None)
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--prefix", action="store_true",
                      help="also run each ROOT's prefix_faults_phase")
    mode.add_argument("--full", action="store_true",
                      help="run each ROOT's whole chip_smoke.py")
    mode.add_argument("--tokens", action="store_true",
                      help="this checkout's serve and EP phases on each "
                           "ROOT, greedy tokens compared")
    mode.add_argument("--arch", default=None,
                      help="comma-separated ARCH_PATHS of this checkout's "
                           "chip_smoke.py to run on each ROOT")
    args = ap.parse_args()
    if args.child is not None:
        if args.arch:
            arch_child(args.child.resolve(), args.seed, args.arch.split(","))
        elif args.tokens:
            tokens_child(args.child.resolve(), args.seed)
        else:
            child(args.child.resolve(), args.seed, args.prefix)
        return 0
    if not args.roots:
        ap.error("name at least one ROOT")
    roots = [r.resolve() for r in args.roots]
    order = (roots + roots[::-1]) * args.repeat
    runs: dict = {str(r): {} for r in roots}
    for i, root in enumerate(order):
        cmd = ([sys.executable, "chip_smoke.py", "--seed", str(args.seed)]
               if args.full else
               [sys.executable, str(Path(__file__).resolve()), "--child",
                str(root), "--seed", str(args.seed)]
               + (["--prefix"] if args.prefix else [])
               + (["--tokens"] if args.tokens else [])
               + (["--arch", args.arch] if args.arch else []))
        proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True)
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
                      for key, vals in sorted(per.items())
                      if not key.endswith(" digest")}
               for root, per in runs.items()}
    # per path, the requests whose greedy tokens are equal in every run of
    # every tree (a run's digests list the requests in order)
    equal = {}
    for key in sorted({k for per in runs.values() for k in per
                       if k.endswith(" digest")}):
        seen = [d.split() for per in runs.values() for d in per.get(key, [])]
        n = min(len(d) for d in seen)
        same = sum(len({d[i] for d in seen}) == 1 for i in range(n))
        equal[key.replace(" digest", "")] = f"{same}/{n} requests"
    print(json.dumps({"medians": medians, "tokens_equal": equal}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
