"""Collective and host-boundary lint: process groups, host data, globals.

Counterpart of ``repro.analysis.sharding_lint``.  The port's mesh is a
``DeviceMesh`` over ``torch.distributed`` process groups, and its
collectives are issued by the helpers of ``distributed/collectives.py``,
each on the group its ``Shard`` names, captured in the round graphs with
fixed shapes.  None of that is checked until a run on several cards:

========  ===========================================================
 S401     a ``torch.distributed`` collective without an explicit
          ``group=``: it runs on the default (world) group, whatever
          axis of the mesh the caller meant.
 S403     host data (``torch.tensor`` / ``as_tensor`` / ``from_numpy``
          / ``asarray`` of a value that is no device tensor) becomes a
          tensor inside a captured stage: the copy is made at capture
          and replayed as a constant, instead of being written into a
          static buffer before the round (``StaticIO.set_active``).
 S404     a paged cache-pool leaf (``*_pages``) built by a cache
          constructor, or a literal ``cache_spec(path)``, that matches
          no explicit ``cache_spec`` rule of ``distributed/sharding.py``
          (it would fall through to the batch rule).
 S405     ``torch.set_default_device`` / ``set_default_dtype`` outside
          the launchers: process-global state every later allocation
          reads.
 S406     a ``torch.distributed`` collective issued outside
          ``distributed/collectives.py``, whose helpers record the
          census of the dry-run and pass their group explicitly.
========  ===========================================================

S403 rides on the capture pass's dataflow (what is a device value, what
a captured stage reaches); the rest is per call site.
"""
from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set

from repro_torch.analysis._astutil import ModuleInfo, Project, dotted_name
from repro_torch.analysis.capture_lint import (analysis, scope_nodes,
                                               scopes_of)
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.registry import (COLLECTIVE_MODULES,
                                           GLOBAL_STATE_MODULES)

_COLLECTIVES = frozenset({
    "all_reduce", "all_gather", "all_gather_into_tensor",
    "all_gather_single", "all_to_all", "all_to_all_single",
    "reduce_scatter", "reduce_scatter_tensor", "broadcast", "reduce",
    "gather", "scatter", "barrier", "send", "recv", "isend", "irecv",
    "all_gather_object", "broadcast_object_list", "monitored_barrier",
})
_GLOBAL_SETTERS = frozenset({"set_default_device", "set_default_dtype",
                             "set_default_tensor_type"})


def _full_name(expr: ast.expr, imports: Dict[str, str]) -> str:
    """``dist.all_reduce`` -> ``torch.distributed.all_reduce`` through the
    module's import aliases."""
    name = dotted_name(expr) or ""
    head, _, rest = name.partition(".")
    target = imports.get(head)
    if target is None:
        return name
    return f"{target}.{rest}" if rest else target


class CollectiveLint:
    """One run of the collective pass over a :class:`Project`."""

    def __init__(self, project: Project):
        self.project = project
        self.findings: Set[Finding] = set()

    def _emit(self, mod: ModuleInfo, line: int, code: str, msg: str) -> None:
        self.findings.add(Finding(mod.rel, line, code, msg))

    def run(self) -> List[Finding]:
        for mod in self.project.modules.values():
            self._calls(mod)
        self._cache_spec_rules()
        self.findings |= set(analysis(self.project).host_findings)
        return sorted(self.findings, key=lambda f: (f.path, f.line, f.code))

    # ---------------------------------------------------- S401/S405/S406
    def _collective(self, call: ast.Call, imports: Dict[str, str],
                    aliases: Dict[str, str]) -> Optional[str]:
        name = _full_name(call.func, imports)
        if name.startswith("torch.distributed.") and \
                name.rsplit(".", 1)[-1] in _COLLECTIVES:
            return name.rsplit(".", 1)[-1]
        if isinstance(call.func, ast.Name):
            return aliases.get(call.func.id)
        return None

    def _calls(self, mod: ModuleInfo) -> None:
        allowed = any(mod.rel.endswith(m) for m in COLLECTIVE_MODULES)
        launcher = any(mod.rel.endswith(m) for m in GLOBAL_STATE_MODULES)
        for scope, roots in scopes_of(mod):
            # ``fn = getattr(dist, ...) or dist.all_gather_into_tensor``
            aliases: Dict[str, str] = {}
            for node in scope_nodes(mod, roots):
                if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                        and isinstance(node.targets[0], ast.Name):
                    for sub in ast.walk(node.value):
                        if isinstance(sub, ast.Attribute):
                            name = _full_name(sub, mod.imports)
                            if name.startswith("torch.distributed.") and \
                                    sub.attr in _COLLECTIVES:
                                aliases[node.targets[0].id] = sub.attr
            for node in scope_nodes(mod, roots):
                if not isinstance(node, ast.Call):
                    continue
                coll = self._collective(node, mod.imports, aliases)
                if coll is not None:
                    if not any(kw.arg == "group" for kw in node.keywords):
                        self._emit(mod, node.lineno, "S401",
                                   f"`{coll}` without group=: it runs on "
                                   "the default world group")
                    if not allowed:
                        self._emit(mod, node.lineno, "S406",
                                   f"`{coll}` issued outside "
                                   "distributed/collectives.py's helpers")
                    continue
                name = _full_name(node.func, mod.imports)
                if not launcher and name.startswith("torch.") and \
                        name.rsplit(".", 1)[-1] in _GLOBAL_SETTERS:
                    self._emit(mod, node.lineno, "S405",
                               f"`{name}` sets process-global state "
                               "outside the launchers")

    # ---------------------------------------------------------------- S404
    def _cache_spec_patterns(self) -> Optional[List[str]]:
        for mod in self.project.modules.values():
            fi = mod.functions.get("cache_spec")
            if fi is None:
                continue
            pats: List[str] = []
            for node in ast.walk(fi.node):
                if isinstance(node, ast.Call):
                    dn = dotted_name(node.func)
                    if dn and dn.endswith("search") and node.args \
                            and isinstance(node.args[0], ast.Constant) \
                            and isinstance(node.args[0].value, str):
                        pats.append(node.args[0].value)
            return pats
        return None

    def _cache_spec_rules(self) -> None:
        patterns = self._cache_spec_patterns()
        if patterns is None:
            return
        covered = lambda leaf: any(re.search(p, leaf) for p in patterns)
        for mod in self.project.modules.values():
            if mod.rel.endswith("distributed/sharding.py"):
                continue
            for fi in mod.functions.values():
                if "cache" not in fi.name.lower():
                    continue
                for node in ast.walk(fi.node):
                    if not isinstance(node, ast.Dict):
                        continue
                    for key in node.keys:
                        if isinstance(key, ast.Constant) \
                                and isinstance(key.value, str) \
                                and key.value.endswith("_pages") \
                                and not covered(key.value):
                            self._emit(mod, key.lineno, "S404",
                                       f"paged pool leaf {key.value!r} "
                                       "matches no cache_spec rule: it "
                                       "would fall through to the batch "
                                       "rule")
            for node in ast.walk(mod.tree):
                if isinstance(node, ast.Call) and (dotted_name(node.func)
                                                   or "").rsplit(".", 1)[
                        -1] == "cache_spec" and node.args \
                        and isinstance(node.args[0], ast.Constant) \
                        and isinstance(node.args[0].value, str):
                    path = node.args[0].value
                    if "pages" in path and not covered(path):
                        self._emit(mod, node.lineno, "S404",
                                   f"cache_spec({path!r}) matches no paged "
                                   "placement rule")


def run(project: Project) -> List[Finding]:
    """Entry point used by the driver: every collective finding."""
    return CollectiveLint(project).run()
