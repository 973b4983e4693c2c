"""CLI: ``python -m repro_torch.analysis [paths...]``.

Exit status: 0 when every finding is waived or baselined, 1 when there
are new findings.  With no paths it analyzes the port and its drivers
(:data:`DEFAULT_ROOTS`, from the repository root).  ``--update-baseline``
rewrites the baseline from the current findings (each entry then needs
its justification); ``--json`` prints the report with per-pass counts.
"""
from __future__ import annotations

import argparse
import glob
import os
import sys

from repro_torch.analysis import (analyze_paths, load_baseline, ratchet,
                                  write_baseline)

#: the port's package and every driver the port's PRs added
DEFAULT_ROOTS = ("src/repro_torch", "examples/*_torch.py", "chip_smoke.py",
                 "kernel_ab.py", "kernel_variants.py", "serve_ab.py",
                 "round_profile.py", "train_profile.py",
                 "scripts/dryrun_moe_table.py",
                 "scripts/tp_placement_bytes.py")
BASELINE = "scripts/lint_torch_baseline.txt"


def default_paths(repo_root: str = ".") -> list:
    """:data:`DEFAULT_ROOTS` that exist under ``repo_root``, globs
    expanded."""
    out = []
    for pattern in DEFAULT_ROOTS:
        out += sorted(glob.glob(os.path.join(repo_root, pattern)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Capture / graph-key / launch-contract / collective / "
                    "generator / in-place analyzer of the port.")
    ap.add_argument("paths", nargs="*",
                    help="files or directories (default: the port and its "
                         "drivers)")
    ap.add_argument("--baseline", default=BASELINE,
                    help="ratchet baseline file")
    ap.add_argument("--no-baseline", action="store_true",
                    help="report every finding, ignoring the baseline")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline from current findings")
    ap.add_argument("--json", action="store_true",
                    help="print the report as JSON")
    args = ap.parse_args(argv)

    paths = args.paths or default_paths()
    if not paths:
        ap.error("none of the default roots is here: run from the "
                 "repository's root or name the paths")
    findings = analyze_paths(paths)
    if args.update_baseline:
        write_baseline(args.baseline, findings)
        print(f"wrote {len(findings)} entr(ies) to {args.baseline}")
        return 0
    baseline = {} if args.no_baseline else load_baseline(args.baseline)
    report = ratchet(findings, baseline)
    print(report.as_json() if args.json else report.render())
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
