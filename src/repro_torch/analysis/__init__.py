"""Static analysis and runtime guards of the port.

Six source-level passes (the analyzed code is never imported; no card,
no ``torch``), counterparts of ``repro.analysis``'s, aimed at the port's
own hazards:

* :mod:`repro_torch.analysis.capture_lint`: host syncs and host-state
  mutation inside CUDA-graph captured stages (T1xx);
* :mod:`repro_torch.analysis.graph_keys`: what a captured round reads
  against its graph key (K2xx);
* :mod:`repro_torch.analysis.launch_lint`: ``ctypes`` bindings against
  their ``extern "C"`` declarations (P3xx);
* :mod:`repro_torch.analysis.collective_lint`: process groups, host data
  in captured stages, cache placement rules, process globals (S4xx);
* :mod:`repro_torch.analysis.generator_lint`: explicit
  ``torch.Generator``s and graph-registered draws (R5xx);
* :mod:`repro_torch.analysis.inplace_lint`: stale aliases after in-place
  writes (D6xx);

and the three runtime guards of :mod:`repro_torch.analysis.runtime`
(``compile_guard``, ``transfer_guard``, ``sharding_guard``), which import
``torch`` and are loaded on first use.

Run the analyzer with ``python -m repro_torch.analysis`` (its default
roots are the port and its drivers, against
``scripts/lint_torch_baseline.txt``); docs/analysis_torch.md lists the
codes, the capture-root model and how to add a root.
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence

from repro_torch.analysis import (capture_lint, collective_lint,
                                  generator_lint, graph_keys, inplace_lint,
                                  launch_lint)
from repro_torch.analysis._astutil import Project
from repro_torch.analysis.findings import (CODES, PASSES, Finding, Report,
                                           apply_waivers, load_baseline,
                                           parse_waivers, pass_of, ratchet,
                                           write_baseline)

_RUNTIME = ("compile_guard", "CompileGuard", "compile_count",
            "transfer_guard", "TransferGuard", "available",
            "sharding_guard", "ShardingGuard")

__all__ = ["CODES", "PASSES", "Finding", "Report", "analyze_paths",
           "pass_of", "load_baseline", "ratchet", "write_baseline",
           *_RUNTIME]


def __getattr__(name: str):
    """The runtime guards, imported (with ``torch``) on first use."""
    if name in _RUNTIME:
        from repro_torch.analysis import runtime
        return getattr(runtime, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def analyze_paths(paths: Sequence[str], repo_root: Optional[str] = None
                  ) -> List[Finding]:
    """Run the six passes over ``paths`` (files or directories) and return
    the findings with inline waivers applied, sorted by location.
    ``repo_root`` anchors the repo-relative paths (default: the current
    directory)."""
    root = os.path.abspath(repo_root or os.getcwd())
    project = Project(list(paths), root)
    findings: List[Finding] = []
    for mod in (capture_lint, graph_keys, launch_lint, collective_lint,
                generator_lint, inplace_lint):
        findings += mod.run(project)
    waivers = {mod.rel: parse_waivers(mod.source)
               for mod in project.modules.values()}
    kept = apply_waivers(findings, waivers)
    kept.sort(key=lambda f: (f.path, f.line, f.code))
    return kept
