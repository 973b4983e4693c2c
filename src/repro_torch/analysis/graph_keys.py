"""Graph-key audit: what a captured round reads against what its key holds.

Counterpart of ``repro.analysis.cache_keys``.  ``RoundGraphs.run(key,
stages)`` captures the stages on a key's first run and replays the
captured graphs on every later run of the key: whatever the stage
closures read at capture is baked into the graphs.  A value that can
change between two runs of one key without changing the key is the
failure mode: the graphs captured for one value are replayed for the
other, silently.  For every ``RoundGraphs.run`` site whose graph set
outlives the call (``self.<attr> = RoundGraphs(...)``; a set built in
the calling function lives for that call only), the pass resolves the
key's dataflow and cross-checks the stage builder:

========  ===========================================================
 K201     an argument of the stage builder (``stages =
          self._round_stages(state, io, gamma, ...)``) depends on a
          value that is neither in the key, derived from it, nor handed
          to the same ``run`` call (``generator=``, which ``run`` holds
          to the captured one).
 K202     such a parameter shapes a tensor or branches inside the
          builder or its stages.
 K204     a stage closure, or a method of the same class it calls,
          reads a builder-scope value or a ``self.<attr>`` that the key
          does not hold.
 K205     a cache's ``.get(k)`` and its store ``[k2] = ...`` use
          different key expressions in one function.
========  ===========================================================

Dependencies are flow-insensitive unions over a function's assignments,
traced back to its parameters and ``self`` attributes; a value assigned
from an expression that reads the key itself counts as derived from the
key.  Methods of the class are code, not state, and are followed rather
than flagged.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis._astutil import (FuncInfo, ModuleInfo, Project,
                                           assigned_names, dotted_name)
from repro_torch.analysis.capture_lint import (StageSite, _builder_functions,
                                               _enclosing_class, own_walk,
                                               scopes_of, stage_sites)
from repro_torch.analysis.findings import Finding

_SHAPE_CALLS = frozenset({"zeros", "ones", "empty", "full", "arange",
                          "reshape", "view", "expand", "new_zeros",
                          "new_empty", "new_full", "new_ones", "randn",
                          "rand", "randint"})


def _reads(expr: ast.AST) -> Set[str]:
    """Names and ``self.<attr>`` tokens an expression reads."""
    out: Set[str] = set()
    for node in ast.walk(expr):
        if isinstance(node, ast.Attribute) and isinstance(node.value,
                                                          ast.Name) \
                and node.value.id == "self":
            out.add(f"self.{node.attr}")
        elif isinstance(node, ast.Name) and node.id != "self" \
                and isinstance(node.ctx, ast.Load):
            out.add(node.id)
    return out


def _handed(expr: ast.expr) -> Set[str]:
    """The names an argument hands over: a conditional's branches, not
    its test."""
    if isinstance(expr, ast.IfExp):
        return _handed(expr.body) | _handed(expr.orelse)
    return _reads(expr)


class _Deps:
    """Flow-insensitive dependencies of one function's names."""

    def __init__(self, fi: FuncInfo):
        self.params = set(fi.params())
        self.raw: Dict[str, Set[str]] = {}
        for node in own_walk(fi.body()):
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    for n in assigned_names(t):
                        self.raw.setdefault(n, set()).update(
                            _reads(node.value))
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)) \
                    and node.value is not None:
                for n in assigned_names(node.target):
                    self.raw.setdefault(n, set()).update(
                        _reads(node.value) | {n})
            elif isinstance(node, ast.For):
                for n in assigned_names(node.target):
                    self.raw.setdefault(n, set()).update(_reads(node.iter))
            elif isinstance(node, ast.NamedExpr):
                for n in assigned_names(node.target):
                    self.raw.setdefault(n, set()).update(_reads(node.value))

    def resolve(self, tokens: Set[str]) -> Set[str]:
        """Tokens traced back to parameters, ``self`` attributes and
        names from outer scopes; a local keeps its own name too, so a
        local assigned from the key stays recognisable."""
        out: Set[str] = set()
        seen: Set[str] = set()
        stack = list(tokens)
        while stack:
            t = stack.pop()
            if t in seen:
                continue
            seen.add(t)
            out.add(t)
            if t in self.raw:
                stack.extend(self.raw[t])
        return out


class GraphKeyAudit:
    """One run of the graph-key pass over a :class:`Project`."""

    def __init__(self, project: Project):
        self.project = project
        self.findings: Set[Finding] = set()

    def run(self) -> List[Finding]:
        for site in stage_sites(self.project):
            if site.scope is not None and self._lives_long(site):
                self._audit_site(site)
        for mod in self.project.modules.values():
            for scope, roots in scopes_of(mod):
                if scope is not None:
                    self._get_vs_store(mod, scope)
        return sorted(self.findings, key=lambda f: (f.path, f.line, f.code))

    def _emit(self, mod: ModuleInfo, line: int, code: str, msg: str) -> None:
        self.findings.add(Finding(mod.rel, line, code, msg))

    @staticmethod
    def _lives_long(site: StageSite) -> bool:
        """A graph set held by the object (``self.<attr>``) outlives the
        call; one built in the calling function does not."""
        recv = site.call.func.value
        return isinstance(recv, ast.Attribute) and isinstance(
            recv.value, ast.Name) and recv.value.id == "self"

    # ---------------------------------------------------------- the site
    def _methods(self, mod: ModuleInfo, scope: FuncInfo) -> Set[str]:
        cls = _enclosing_class(mod, scope)
        return set(cls.methods) if cls is not None else set()

    def _self_reads(self, mod: ModuleInfo, fi: FuncInfo, methods: Set[str],
                    seen: Set[int]) -> List[Tuple[str, int, FuncInfo]]:
        """(attr, line, function) of every ``self.<attr>`` a function
        reads, following calls of the class's own methods and nested
        defs."""
        if id(fi.node) in seen:
            return []
        seen.add(id(fi.node))
        out: List[Tuple[str, int, FuncInfo]] = []
        for node in ast.walk(fi.node):
            if isinstance(node, ast.Attribute) and isinstance(
                    node.value, ast.Name) and node.value.id == "self" \
                    and isinstance(node.ctx, ast.Load):
                if node.attr in methods:
                    cls = _enclosing_class(mod, fi)
                    callee = cls.methods.get(node.attr) if cls else None
                    if callee is not None:
                        out += self._self_reads(mod, callee, methods, seen)
                else:
                    out.append((node.attr, node.lineno, fi))
        return out

    def _key_tokens(self, site: StageSite, deps: _Deps,
                    methods: Set[str]) -> Tuple[Set[str], Set[str]]:
        """(what the key holds, the key's local names)."""
        key = site.key
        if key is None:
            return set(), set()
        tokens = deps.resolve(_reads(key))
        key_names = {t for t in _reads(key) if t in deps.raw}
        # the self attributes a key method reads (``self.round_key``)
        calls = [key] + [v for n in key_names for v in self._assigned(
            site.scope, n)]
        for expr in calls:
            for node in ast.walk(expr):
                if isinstance(node, ast.Call) and isinstance(
                        node.func, ast.Attribute) and isinstance(
                        node.func.value, ast.Name) \
                        and node.func.value.id == "self" \
                        and node.func.attr in methods:
                    cls = _enclosing_class(site.module, site.scope)
                    m = cls.methods[node.func.attr]
                    tokens |= {f"self.{a}" for a, _, _ in self._self_reads(
                        site.module, m, methods, set())}
        return tokens, key_names

    @staticmethod
    def _assigned(fi: FuncInfo, name: str) -> List[ast.expr]:
        return [node.value for node in own_walk(fi.body())
                if isinstance(node, ast.Assign) and any(
                    name in assigned_names(t) for t in node.targets)]

    def _covered(self, tokens: Set[str], key_tokens: Set[str],
                 key_names: Set[str], deps: _Deps,
                 methods: Set[str]) -> Set[str]:
        """The state tokens of ``tokens`` the key does not cover (empty
        when derived from the key)."""
        if tokens & key_names:
            return set()
        missing = set()
        for t in tokens:
            if t in key_tokens:
                continue
            if t.startswith("self."):
                if t[5:] not in methods:
                    missing.add(t)
            elif t in deps.params and t != "self":
                missing.add(t)
        return missing

    def _audit_site(self, site: StageSite) -> None:
        mod, scope = site.module, site.scope
        deps = _Deps(scope)
        methods = self._methods(mod, scope)
        key_tokens, key_names = self._key_tokens(site, deps, methods)
        # what the run call itself is handed (``generator=``), and holds
        # to what it captured; a conditional's test is not handed over
        for v in [k.value for k in site.call.keywords if k.arg != "stages"]:
            key_tokens |= deps.resolve(_handed(v))
        for call, builder in self._builder_calls(site):
            self._audit_builder(site, deps, methods, key_tokens, key_names,
                                call, builder)

    def _builder_calls(self, site: StageSite
                       ) -> List[Tuple[ast.Call, FuncInfo]]:
        expr = site.call.args[1] if len(site.call.args) > 1 else next(
            (k.value for k in site.call.keywords if k.arg == "stages"), None)
        exprs = [expr]
        if isinstance(expr, ast.Name):
            exprs = self._assigned(site.scope, expr.id)
        out = []
        for e in exprs:
            if not isinstance(e, ast.Call):
                continue
            targets: List[FuncInfo] = []
            if isinstance(e.func, ast.Attribute):
                targets = self.project.resolve_attr_call(
                    e.func.value, e.func.attr, site.module)
            elif isinstance(e.func, ast.Name):
                targets = self.project.resolve_name(e.func.id, site.module,
                                                    site.scope)
            out += [(e, t) for t in targets
                    if self.project.returned_functions(t)]
        return out

    def _audit_builder(self, site, deps, methods, key_tokens, key_names,
                       call: ast.Call, builder: FuncInfo) -> None:
        mod = site.module
        params = builder.params()
        if isinstance(call.func, ast.Attribute) and params[:1] == ["self"]:
            params = params[1:]
        args: Dict[str, ast.expr] = dict(zip(params, call.args))
        args.update({k.arg: k.value for k in call.keywords if k.arg})
        loose: Set[str] = set()
        for p, a in args.items():
            miss = self._covered(deps.resolve(_reads(a)), key_tokens,
                                 key_names, deps, methods)
            if miss:
                loose.add(p)
                self._emit(mod, call.lineno, "K201",
                           f"`{builder.name}` parameter `{p}` (argument "
                           f"`{ast.unparse(a)}`) depends on "
                           f"{', '.join(sorted(miss))}, not in the round "
                           f"key `{ast.unparse(site.key)}`")
        stages = _builder_functions(self.project, call, mod, site.scope)
        self._audit_shapes(mod, builder, stages, loose)
        bdeps = _Deps(builder)
        reported: Set[Tuple[int, str]] = set()
        for st in stages:
            for node in ast.walk(st.node):
                if isinstance(node, ast.Name) and isinstance(
                        node.ctx, ast.Load) and node.id in bdeps.raw \
                        and node.id not in bdeps.params:
                    for t in bdeps.resolve({node.id}):
                        if t.startswith("self.") and t[5:] not in methods \
                                and t not in key_tokens \
                                and (id(st.node), t) not in reported:
                            reported.add((id(st.node), t))
                            self._emit(mod, node.lineno, "K204",
                                       f"stage `{st.name}` reads "
                                       f"`{node.id}` from {t}, which the "
                                       "round key does not hold")
            for attr, line, fi in self._self_reads(mod, st, methods, set()):
                tok = f"self.{attr}"
                if tok in key_tokens or (id(fi.node), tok) in reported:
                    continue
                reported.add((id(fi.node), tok))
                self._emit(fi.module, line, "K204",
                           f"`{fi.name}` (run by a captured stage) reads "
                           f"`{tok}`, which the round key does not hold")

    def _audit_shapes(self, mod: ModuleInfo, builder: FuncInfo,
                      stages: List[FuncInfo], loose: Set[str]) -> None:
        """K202: a loose builder parameter in a branch or a shape."""
        if not loose:
            return
        bdeps = _Deps(builder)
        tainted = {n for n in bdeps.raw if bdeps.resolve({n}) & loose}
        tainted |= loose
        for fi in [builder] + stages:
            for node in ast.walk(fi.node):
                used: Optional[ast.AST] = None
                if isinstance(node, (ast.If, ast.While, ast.IfExp)):
                    used = node.test
                elif isinstance(node, ast.Call):
                    name = dotted_name(node.func) or ""
                    attr = name.rsplit(".", 1)[-1] if name else (
                        node.func.attr if isinstance(node.func,
                                                     ast.Attribute) else "")
                    if attr in _SHAPE_CALLS or name == "range":
                        used = ast.Tuple(elts=list(node.args), ctx=ast.Load())
                if used is None:
                    continue
                hit = sorted(_reads(used) & tainted)
                if hit:
                    self._emit(mod, node.lineno, "K202",
                               f"`{hit[0]}` shapes or branches a captured "
                               "stage but the round key does not hold it")

    # ------------------------------------------------------------- K205
    def _get_vs_store(self, mod: ModuleInfo, fi: FuncInfo) -> None:
        """A memo: ``v = self._c.get(k)`` then, when ``v`` is None,
        ``v = self._c[k2] = ...``: ``k`` and ``k2`` must be one
        expression."""
        gets: Dict[Tuple[str, str], ast.expr] = {}
        for node in own_walk(fi.body()):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and isinstance(node.value, ast.Call) \
                    and isinstance(node.value.func, ast.Attribute) \
                    and node.value.func.attr == "get" and node.value.args:
                gets[(ast.unparse(node.value.func.value),
                      node.targets[0].id)] = node.value.args[0]
        for node in own_walk(fi.body()):
            if not isinstance(node, ast.If) or not (
                    isinstance(node.test, ast.Compare)
                    and isinstance(node.test.left, ast.Name)
                    and isinstance(node.test.ops[0], ast.Is)):
                continue
            memo = node.test.left.id
            for sub in own_walk(node.body):
                if not isinstance(sub, ast.Assign):
                    continue
                for t in sub.targets:
                    if not isinstance(t, ast.Subscript):
                        continue
                    cache = ast.unparse(t.value)
                    key = gets.get((cache, memo))
                    if key is not None and ast.unparse(key) != ast.unparse(
                            t.slice):
                        self._emit(mod, sub.lineno, "K205",
                                   f"`{cache}` is read with .get("
                                   f"{ast.unparse(key)}) but stored under "
                                   f"[{ast.unparse(t.slice)}]")


def run(project: Project) -> List[Finding]:
    """Entry point used by the driver: every graph-key finding."""
    return GraphKeyAudit(project).run()
