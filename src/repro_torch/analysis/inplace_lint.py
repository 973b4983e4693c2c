"""In-place reuse lint: a stale alias read after its buffer was written.

Counterpart of ``repro.analysis.donation_lint``.  The reference donates
buffers to a jitted call and must not read them after; the port writes
its buffers in place instead (the arenas of ``core/spec_decode.py``, the
static buffers of ``core/graphs.py``, the caches' K/V pools, the warm
buffers), because a CUDA graph reads and writes fixed addresses.  The
hazard moves with it: a view or alias taken from a buffer before an
in-place write into that buffer sees the new values, not the ones it
was taken for.

========  ===========================================================
 D601     a name that aliases part of a buffer (a slice or view of it,
          a leaf of its tree, the tensor itself under another name) is
          read after an in-place write into that buffer in the same
          function, without being rebound in between.
========  ===========================================================

An in-place write is a tensor method ending in ``_`` (``copy_``,
``index_copy_``, ``fill_``, ``masked_fill_``...), an ``out=`` argument,
a subscript store, or ``_copy_into(dst, src)`` (every leaf of ``dst``).
Aliases carry a path from their root name: attributes and string keys
name distinct parts of a tree, index subscripts and view methods
overlap anything.  A write affects the aliases whose path overlaps the
written one and does not contain it: reading the buffer that was
written, or a container holding it, is what the write was for.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis._astutil import FuncInfo, ModuleInfo, Project
from repro_torch.analysis.capture_lint import own_walk
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.registry import STATIC_RESULT_ATTRS

_VIEWS = frozenset({
    "view", "view_as", "reshape", "transpose", "t", "permute", "narrow",
    "select", "expand", "expand_as", "unsqueeze", "squeeze", "flatten",
    "unflatten", "as_strided", "detach", "diagonal", "movedim", "chunk",
    "split", "unbind", "swapaxes", "contiguous", "T", "mT",
})
_COPY_TREE = ("_copy_into",)
_ANY = "*"

Path = Tuple[str, ...]


def _path(expr: ast.expr) -> Optional[Tuple[str, Path]]:
    """(root name, path) of an alias-making expression, or None."""
    if isinstance(expr, ast.Name):
        return expr.id, ()
    if isinstance(expr, ast.Attribute):
        if expr.attr in STATIC_RESULT_ATTRS:      # metadata, no alias
            return None
        inner = _path(expr.value)
        return None if inner is None else (inner[0], inner[1] + (expr.attr,))
    if isinstance(expr, ast.Subscript):
        inner = _path(expr.value)
        if inner is None:
            return None
        key = expr.slice
        part = key.value if isinstance(key, ast.Constant) and isinstance(
            key.value, str) else _ANY
        return inner[0], inner[1] + (part,)
    if isinstance(expr, ast.Call) and isinstance(expr.func, ast.Attribute) \
            and expr.func.attr in _VIEWS:
        inner = _path(expr.func.value)
        return None if inner is None else (inner[0], inner[1] + (_ANY,))
    return None


def _overlap(a: Path, b: Path) -> bool:
    for x, y in zip(a, b):
        if x != y and _ANY not in (x, y):
            return False
    return True


def _contains(outer: Path, inner: Path) -> bool:
    """True when ``outer`` is ``inner`` or a container of it."""
    return len(outer) <= len(inner) and all(
        x == y for x, y in zip(outer, inner))


class InplaceLint:
    """One run of the in-place pass over a :class:`Project`."""

    def __init__(self, project: Project):
        self.project = project
        self.findings: Set[Finding] = set()

    def run(self) -> List[Finding]:
        for mod in self.project.modules.values():
            for fi in mod.functions.values():
                self._function(mod, fi)
                for cands in fi.local_funcs.values():
                    for inner in cands:
                        if inner.qualname not in mod.functions:
                            self._function(mod, inner)
        return sorted(self.findings, key=lambda f: (f.path, f.line, f.code))

    def _function(self, mod: ModuleInfo, fi: FuncInfo) -> None:
        # statement-ordered events: (line, col, kind, name, payload)
        aliases: Dict[str, Tuple[str, Path, int]] = {}
        events: List[Tuple[int, int, str, object]] = []
        for node in own_walk(fi.body()):
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                tgt, val = node.targets[0], node.value
                pairs = []
                if isinstance(tgt, ast.Name):
                    pairs = [(tgt, val)]
                elif isinstance(tgt, ast.Tuple) and isinstance(
                        val, ast.Tuple) and len(tgt.elts) == len(val.elts):
                    pairs = list(zip(tgt.elts, val.elts))
                for t, v in pairs:
                    if isinstance(t, ast.Name):
                        events.append((node.lineno, node.end_col_offset or 0,
                                       "bind", (t.id, _path(v))))
                if isinstance(tgt, ast.Subscript):
                    p = _path(tgt)
                    if p is not None:
                        events.append((node.lineno, 0, "write",
                                       (p, tgt.lineno)))
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign, ast.For)):
                target = node.target
                if isinstance(target, ast.Name):
                    events.append((node.lineno, 0, "bind", (target.id, None)))
            elif isinstance(node, ast.Call):
                for p in self._writes(node):
                    events.append((node.lineno, node.col_offset, "write",
                                   (p, node.lineno)))
            elif isinstance(node, ast.Name) and isinstance(node.ctx,
                                                           ast.Load):
                events.append((node.lineno, node.col_offset, "read",
                               node.id))
        events.sort(key=lambda e: (e[0], e[2] != "read", e[1]))
        stale: Dict[str, int] = {}
        for line, _, kind, payload in events:
            if kind == "bind":
                name, p = payload
                stale.pop(name, None)
                if p is not None and p[0] != name:
                    aliases[name] = (p[0], p[1], line)
                else:
                    aliases.pop(name, None)
            elif kind == "write":
                (root, wpath), at = payload
                wname = root
                base = aliases.get(root)
                if base is not None:          # written through an alias
                    root, wpath = base[0], base[1] + wpath
                for name, (r, apath, made) in aliases.items():
                    if r == root and name != wname and made < at \
                            and _overlap(apath, wpath) \
                            and not _contains(apath, wpath):
                        stale[name] = at
            elif kind == "read" and payload in stale:
                at = stale.pop(payload)
                if line > at:
                    self.findings.add(Finding(
                        mod.rel, line, "D601",
                        f"`{payload}` aliases a buffer written in place at "
                        f"line {at} and is read after it"))

    @staticmethod
    def _writes(call: ast.Call) -> List[Tuple[str, Path]]:
        out = []
        if isinstance(call.func, ast.Attribute) \
                and call.func.attr.endswith("_") \
                and not call.func.attr.startswith("_"):
            p = _path(call.func.value)
            if p is not None:
                out.append(p)
        for kw in call.keywords:
            if kw.arg == "out":
                p = _path(kw.value)
                if p is not None:
                    out.append(p)
        if isinstance(call.func, ast.Name) and call.func.id in _COPY_TREE \
                and call.args:
            dst = call.args[0]
            for e in (dst.elts if isinstance(dst, (ast.Tuple, ast.List))
                      else [dst]):
                p = _path(e)
                if p is not None:
                    out.append(p)
        return out


def run(project: Project) -> List[Finding]:
    """Entry point used by the driver: every in-place finding."""
    return InplaceLint(project).run()
