"""Capture-safety lint: device-tensor dataflow through CUDA-graph captures.

Counterpart of ``repro.analysis.tracer_lint``.  A round of the port runs
from CUDA graphs (``core/graphs.py``): each stage callable handed to
``RoundGraphs.run`` runs as Python once, at its key's first run and its
capture, and is replayed after with no Python at all.  What a stage does
on the host therefore happens once: a branch on a device value is taken
for the value it had at capture, a host sync breaks the capture, and a
counter bumped there is never bumped again.  The pass walks every
function reachable from a capture root and flags:

========  ===========================================================
 T101     Python ``if`` (or ternary / comprehension filter) on a device
          tensor: a host sync, and the branch is fixed at capture.
 T102     Python ``while`` on a device tensor.
 T103     ``int()``/``float()``/``bool()`` of a device tensor.
 T104     host sync: ``.item()``/``.tolist()``/``.cpu()``/``.numpy()``/
          ``np.asarray`` of a device tensor.
 T105     f-string / ``str.format`` / ``print`` / logging of a device
          tensor.
 T106     mutation of host state (a captured list or dict, a ``self``
          attribute, a module global): it runs at capture, never on
          replay.
 T107     ``assert`` on a device tensor.
 T108     ``range()`` bound by a device tensor.
========  ===========================================================

Roots (docs/analysis_torch.md): every stage callable handed to
``RoundGraphs.run`` (a list literal, a name bound to one, or the list a
builder such as ``SDEngine._round_stages`` returns), the body of every
``with torch.cuda.graph(...)``, and ``registry.KNOWN_ENTRY_POINTS``.  A
stage's parameter (the previous stage's output) holds device tensors; so
does the result of any ``torch.*`` call but the metadata ones and of any
method of a device tensor; ``.shape``/``.device``/``.dim()``/``len()``/
``is None`` are host values.  Calls that resolve to project functions are
followed with the call site's device arguments.  Values a stage closes
over are taken as host values, so the pass under-reports there rather
than guess.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis._astutil import (FuncInfo, ModuleInfo, Project,
                                           assigned_names, dotted_name)
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.registry import (ALWAYS_STATIC_PARAMS,
                                           HOST_NAMES, HOST_TENSOR_FACTORIES,
                                           KNOWN_ENTRY_POINTS,
                                           STATIC_RESULT_ATTRS,
                                           STATIC_RESULT_CALLS,
                                           STATIC_RESULT_METHODS,
                                           lookup_entry)

_GRAPH_CTX = ("torch.cuda.graph", "cuda.graph")
_GRAPHS_CLASS = ("RoundGraphs", "graphs.RoundGraphs")
_PARTIAL_NAMES = ("functools.partial", "partial")
_MUTATORS = frozenset({
    "append", "extend", "add", "insert", "update", "pop", "popleft",
    "remove", "clear", "setdefault", "appendleft", "discard", "write",
})
_SYNC_METHODS = frozenset({"item", "tolist", "cpu", "numpy"})
_LOG_METHODS = frozenset({"debug", "info", "warning", "error", "exception",
                          "critical", "log"})
_HOST_OWNERS = frozenset({"self", "cls"})
_MAX_DEPTH = 16
_MAX_CANDIDATES = 10
_MAX_ANALYSES = 6000


# --------------------------------------------------------------- root sites
@dataclass
class StageSite:
    """One ``RoundGraphs.run(key, stages, generator=...)`` call."""
    module: ModuleInfo
    scope: Optional[FuncInfo]
    call: ast.Call
    key: Optional[ast.expr]
    stages: List[FuncInfo] = field(default_factory=list)
    generator: Optional[ast.expr] = None


def own_walk(roots: Sequence[ast.AST]):
    """Walk nodes without descending into nested function/lambda bodies
    (those belong to the inner scope and are walked on their own)."""
    stack: List[ast.AST] = list(roots)
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(node))


def scopes_of(mod: ModuleInfo) -> List[Tuple[Optional[FuncInfo],
                                              List[ast.AST]]]:
    """(scope, statements) for the module body and every function; each
    node is visited once, from its innermost scope."""
    memo = getattr(mod, "_scopes", None)
    if memo is None:
        memo = [(None, list(mod.tree.body))]
        memo += [(fi, list(fi.body())) for fi in mod.functions.values()]
        memo += [(fi, list(fi.body())) for fi in _lambdas(mod)]
        mod._scopes = memo
    return memo


def scope_nodes(mod: ModuleInfo, roots: List[ast.AST]) -> List[ast.AST]:
    """``own_walk(roots)`` of one of ``scopes_of(mod)``, kept."""
    memo = mod.__dict__.setdefault("_nodes", {})
    nodes = memo.get(id(roots))
    if nodes is None:
        nodes = memo[id(roots)] = list(own_walk(roots))
    return nodes


def _lambdas(mod: ModuleInfo) -> List[FuncInfo]:
    """Every lambda of the module not bound to a name, as a FuncInfo with
    its lexical parent (the innermost enclosing def)."""
    bound = {id(fi.node) for fi in mod.functions.values()}
    for fi in mod.functions.values():
        for cands in fi.local_funcs.values():
            bound.update(id(c.node) for c in cands)
    out: List[FuncInfo] = []

    def visit(node: ast.AST, owner: Optional[FuncInfo]) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                inner = _func_for_node(mod, child) or owner
                visit(child, inner)
            elif isinstance(child, ast.Lambda):
                fi = FuncInfo(child, mod,
                              f"{owner.qualname if owner else ''}.<lambda>",
                              owner)
                if id(child) not in bound:
                    out.append(fi)
                visit(child, fi)
            else:
                visit(child, owner)
    visit(mod.tree, None)
    return out


def _func_for_node(mod: ModuleInfo, node: ast.AST) -> Optional[FuncInfo]:
    index = getattr(mod, "_by_node", None)
    if index is None:
        index = {}
        for fi in mod.functions.values():
            for cands in fi.local_funcs.values():
                for c in cands:
                    index.setdefault(id(c.node), c)
        for fi in mod.functions.values():
            index[id(fi.node)] = fi
        mod._by_node = index
    return index.get(id(node))


def _enclosing_class(mod: ModuleInfo, fi: Optional[FuncInfo]):
    while fi is not None and fi.parent is not None:
        fi = fi.parent
    if fi is None or "." not in fi.qualname:
        return None
    return mod.classes.get(fi.qualname.split(".")[0])


def _is_graphs_ctor(value: ast.expr) -> bool:
    return (isinstance(value, ast.Call)
            and dotted_name(value.func) in _GRAPHS_CLASS)


def _is_round_graphs(recv: ast.expr, mod: ModuleInfo,
                     scope: Optional[FuncInfo]) -> bool:
    """True when ``recv`` was assigned from ``RoundGraphs(...)``: a name
    in this or an enclosing scope, or ``self.<attr>`` in the class."""
    if isinstance(recv, ast.Name):
        s = scope
        while s is not None:
            for node in ast.walk(s.node):
                if isinstance(node, ast.Assign) and _is_graphs_ctor(
                        node.value) and any(
                        recv.id in assigned_names(t) for t in node.targets):
                    return True
            s = s.parent
        for node in mod.tree.body:
            if isinstance(node, ast.Assign) and _is_graphs_ctor(node.value) \
                    and any(recv.id in assigned_names(t)
                            for t in node.targets):
                return True
        return False
    if isinstance(recv, ast.Attribute) and isinstance(recv.value, ast.Name) \
            and recv.value.id == "self":
        cls = _enclosing_class(mod, scope)
        if cls is None:
            return False
        for node in ast.walk(cls.node):
            if isinstance(node, ast.Assign) and _is_graphs_ctor(node.value):
                for t in node.targets:
                    if isinstance(t, ast.Attribute) and t.attr == recv.attr \
                            and isinstance(t.value, ast.Name) \
                            and t.value.id == "self":
                        return True
    return False


def resolve_funcexpr(project: Project, expr: ast.expr, mod: ModuleInfo,
                     scope: Optional[FuncInfo]
                     ) -> List[Tuple[FuncInfo, Tuple[str, ...]]]:
    """Function candidates for an expression, with the parameter names a
    ``functools.partial`` binds (host values)."""
    if isinstance(expr, ast.Lambda):
        return [(FuncInfo(expr, mod,
                          f"{scope.qualname if scope else ''}.<lambda>",
                          scope), ())]
    if isinstance(expr, ast.Name):
        cands = project.resolve_name(expr.id, mod, scope)
        if cands:
            return [(c, ()) for c in cands]
        return _resolve_local_assign(project, expr.id, mod, scope)
    if isinstance(expr, ast.Call):
        if dotted_name(expr.func) in _PARTIAL_NAMES and expr.args:
            out = []
            for fi, bound in resolve_funcexpr(project, expr.args[0], mod,
                                              scope):
                extra = [kw.arg for kw in expr.keywords if kw.arg]
                extra += fi.positional_params()[: len(expr.args) - 1]
                out.append((fi, bound + tuple(extra)))
            return out
        return [(c, ()) for c in _builder_functions(project, expr, mod,
                                                    scope)]
    if isinstance(expr, ast.Attribute):
        cands = project.resolve_attr_call(expr.value, expr.attr, mod)
        return [(c, ()) for c in cands[:_MAX_CANDIDATES]]
    return []


def _builder_functions(project: Project, call: ast.Call, mod: ModuleInfo,
                       scope: Optional[FuncInfo]) -> List[FuncInfo]:
    """Every function a builder call returns, at any return position."""
    targets: List[FuncInfo] = []
    if isinstance(call.func, ast.Name):
        targets = project.resolve_name(call.func.id, mod, scope)
    elif isinstance(call.func, ast.Attribute):
        targets = project.resolve_attr_call(call.func.value, call.func.attr,
                                            mod)
    out: List[FuncInfo] = []
    for t in targets[:_MAX_CANDIDATES]:
        for pos in project.returned_functions(t):
            out.extend(c for c in pos if c not in out)
    return out


def _resolve_local_assign(project: Project, name: str, mod: ModuleInfo,
                          scope: Optional[FuncInfo]
                          ) -> List[Tuple[FuncInfo, Tuple[str, ...]]]:
    """Follow ``name = partial(...)`` / ``name = other`` / ``name =
    builder(...)`` in the enclosing scopes."""
    out: List[Tuple[FuncInfo, Tuple[str, ...]]] = []
    s = scope
    while s is not None and not out:
        for node in ast.walk(s.node):
            if isinstance(node, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == name
                    for t in node.targets) and not isinstance(
                    node.value, (ast.List, ast.Tuple)):
                out.extend(resolve_funcexpr(project, node.value, mod, s))
        s = s.parent
    return out


def stage_list(project: Project, expr: Optional[ast.expr], mod: ModuleInfo,
               scope: Optional[FuncInfo]) -> List[FuncInfo]:
    """The stage callables an expression handed to ``RoundGraphs.run``
    stands for: a list literal, a name bound to one, or a builder call."""
    if expr is None:
        return []
    if isinstance(expr, (ast.List, ast.Tuple)):
        out: List[FuncInfo] = []
        for e in expr.elts:
            out.extend(fi for fi, _ in resolve_funcexpr(project, e, mod,
                                                        scope))
        return out
    if isinstance(expr, ast.Call):
        return _builder_functions(project, expr, mod, scope)
    if isinstance(expr, ast.Name):
        s = scope
        while s is not None:
            for node in ast.walk(s.node):
                if isinstance(node, ast.Assign) and any(
                        isinstance(t, ast.Name) and t.id == expr.id
                        for t in node.targets):
                    return stage_list(project, node.value, mod, s)
            s = s.parent
    return []


def stage_sites(project: Project) -> List[StageSite]:
    """Every ``RoundGraphs.run`` call of the project with its stages."""
    memo = getattr(project, "_stage_sites", None)
    if memo is not None:
        return memo
    sites: List[StageSite] = []
    project._stage_sites = sites
    for mod in project.modules.values():
        for scope, roots in scopes_of(mod):
            for node in scope_nodes(mod, roots):
                if not (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr == "run"
                        and _is_round_graphs(node.func.value, mod, scope)):
                    continue
                kw = {k.arg: k.value for k in node.keywords if k.arg}
                key = node.args[0] if node.args else kw.get("key")
                stages = node.args[1] if len(node.args) > 1 \
                    else kw.get("stages")
                sites.append(StageSite(
                    mod, scope, node, key,
                    stage_list(project, stages, mod, scope),
                    kw.get("generator")))
    return sites


def graph_bodies(project: Project
                 ) -> List[Tuple[ModuleInfo, Optional[FuncInfo], ast.With]]:
    """Every ``with torch.cuda.graph(...)`` block of the project."""
    out = []
    for mod in project.modules.values():
        for scope, roots in scopes_of(mod):
            for node in scope_nodes(mod, roots):
                if isinstance(node, ast.With) and any(
                        isinstance(it.context_expr, ast.Call)
                        and dotted_name(it.context_expr.func) in _GRAPH_CTX
                        for it in node.items):
                    out.append((mod, scope, node))
    return out


def body_func(mod: ModuleInfo, scope: Optional[FuncInfo],
              block: ast.With) -> FuncInfo:
    """A ``with`` block's body as a parameterless function in ``scope``."""
    node = ast.FunctionDef(name="<graph>", args=ast.arguments(
        posonlyargs=[], args=[], vararg=None, kwonlyargs=[], kw_defaults=[],
        kwarg=None, defaults=[]), body=block.body, decorator_list=[],
        returns=None, type_comment=None, type_params=[])
    node.lineno = block.lineno
    return FuncInfo(node, mod,
                    f"{scope.qualname if scope else ''}.<graph>", scope)


# -------------------------------------------------------------------- lint
class CaptureLint:
    """One run of the capture-safety pass over a :class:`Project`."""

    def __init__(self, project: Project):
        self.project = project
        self.findings: Set[Finding] = set()
        # S403 (collective_lint): host data made a tensor in a stage
        self.host_findings: Set[Finding] = set()
        self._memo: Dict[Tuple, bool] = {}
        self._active: Set[Tuple] = set()
        self._n_analyses = 0

    def run(self) -> List[Finding]:
        for site in stage_sites(self.project):
            for fi in site.stages:
                self._analyze_entry(fi, static=())
        for mod, scope, block in graph_bodies(self.project):
            self._analyze(body_func(mod, scope, block), frozenset(), {}, 0)
        for entry in KNOWN_ENTRY_POINTS:
            for mod in self.project.modules.values():
                if not mod.rel.endswith(entry.module):
                    continue
                fi = mod.functions.get(entry.qualname)
                if fi is not None:
                    self._analyze_entry(fi, static=entry.static)
        return sorted(self.findings, key=lambda f: (f.path, f.line, f.code))

    def _analyze_entry(self, fi: FuncInfo, static: Sequence[str]) -> None:
        statics = set(static) | ALWAYS_STATIC_PARAMS
        reg = lookup_entry(fi.module.rel, fi.qualname)
        if reg is not None:
            statics |= set(reg.static)
        traced = frozenset(p for p in fi.params()
                           if p not in statics and p not in HOST_NAMES)
        self._analyze(fi, traced, {}, 0)

    def _analyze(self, fi: FuncInfo, traced: FrozenSet[str],
                 closure: Dict[str, bool], depth: int) -> bool:
        """Run the dataflow over one function; returns whether its result
        is a device value.  Memoized on (function, device params, device
        closure names)."""
        key = (id(fi.node), traced,
               frozenset(k for k, v in closure.items() if v))
        if key in self._memo:
            return self._memo[key]
        if key in self._active or depth > _MAX_DEPTH \
                or self._n_analyses > _MAX_ANALYSES:
            return bool(traced)
        self._active.add(key)
        self._n_analyses += 1
        result = _Walker(self, fi, traced, closure, depth).walk()
        self._active.discard(key)
        self._memo[key] = result
        return result

    def emit(self, fi: FuncInfo, node: ast.AST, code: str,
             message: str) -> None:
        line = getattr(node, "lineno", fi.line)
        self.findings.add(Finding(fi.module.rel, line, code, message))


class _Walker:
    """Device-value dataflow over one function, with the checks."""

    def __init__(self, lint: CaptureLint, fi: FuncInfo,
                 traced_params: FrozenSet[str], closure: Dict[str, bool],
                 depth: int):
        self.lint = lint
        self.fi = fi
        self.closure = closure
        self.depth = depth
        self.bound: Set[str] = set(fi.params())
        self._collect_bound(fi.body())
        self.traced: Set[str] = set(traced_params)
        self.mutable_free: Set[str] = set()
        self.returns_traced = False

    def _collect_bound(self, body: Sequence[ast.stmt]) -> None:
        for stmt in body:
            for node in ast.walk(stmt):
                if isinstance(node, ast.Assign):
                    for t in node.targets:
                        self.bound.update(assigned_names(t))
                elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                    self.bound.update(assigned_names(node.target))
                elif isinstance(node, (ast.For, ast.comprehension)):
                    self.bound.update(assigned_names(node.target))
                elif isinstance(node, ast.With):
                    for item in node.items:
                        if item.optional_vars is not None:
                            self.bound.update(
                                assigned_names(item.optional_vars))
                elif isinstance(node, (ast.FunctionDef,
                                       ast.AsyncFunctionDef)):
                    self.bound.add(node.name)
                elif isinstance(node, ast.NamedExpr):
                    self.bound.update(assigned_names(node.target))

    def _snapshot_closure(self) -> Dict[str, bool]:
        env = dict(self.closure)
        for name in self.bound:
            env[name] = name in self.traced
        return env

    # ----------------------------------------------------------- statements
    def walk(self) -> bool:
        self._visit_body(self.fi.body())
        return self.returns_traced

    def _visit_body(self, body: Sequence[ast.stmt]) -> None:
        for stmt in body:
            self._visit(stmt)

    def _visit(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, ast.Assign):
            t = self.is_traced(stmt.value)
            for tgt in stmt.targets:
                self._bind(tgt, t)
        elif isinstance(stmt, ast.AnnAssign):
            t = self.is_traced(stmt.value) if stmt.value is not None else False
            self._bind(stmt.target, t)
        elif isinstance(stmt, ast.AugAssign):
            t = self.is_traced(stmt.value)
            if isinstance(stmt.target, ast.Name):
                self._bind(stmt.target, t or stmt.target.id in self.traced)
            else:
                self._bind(stmt.target, t)
        elif isinstance(stmt, ast.If):
            if self.is_traced(stmt.test):
                self._emit(stmt, "T101", "Python `if` on device value "
                           f"`{_src(stmt.test)}` in a captured stage")
            self._visit_body(stmt.body)
            self._visit_body(stmt.orelse)
        elif isinstance(stmt, ast.While):
            if self.is_traced(stmt.test):
                self._emit(stmt, "T102", "Python `while` on device value "
                           f"`{_src(stmt.test)}` in a captured stage")
            for _ in range(2):
                self._visit_body(stmt.body)
            self._visit_body(stmt.orelse)
        elif isinstance(stmt, ast.For):
            self._bind_iter(stmt.target, stmt.iter)
            for _ in range(2):
                self._visit_body(stmt.body)
            self._visit_body(stmt.orelse)
        elif isinstance(stmt, ast.Return):
            if stmt.value is not None and self.is_traced(stmt.value):
                self.returns_traced = True
        elif isinstance(stmt, ast.Expr):
            self.is_traced(stmt.value)
        elif isinstance(stmt, ast.Assert):
            if self.is_traced(stmt.test):
                self._emit(stmt, "T107", "assert on device value "
                           f"`{_src(stmt.test)}` in a captured stage")
            if stmt.msg is not None:
                self.is_traced(stmt.msg)
        elif isinstance(stmt, (ast.Global, ast.Nonlocal)):
            self.mutable_free.update(stmt.names)
        elif isinstance(stmt, ast.With):
            for item in stmt.items:
                self.is_traced(item.context_expr)
                if item.optional_vars is not None:
                    self._bind(item.optional_vars, False)
            self._visit_body(stmt.body)
        elif isinstance(stmt, ast.Try):
            self._visit_body(stmt.body)
            for h in stmt.handlers:
                self._visit_body(h.body)
            self._visit_body(stmt.orelse)
            self._visit_body(stmt.finalbody)
        elif isinstance(stmt, ast.Raise):
            if stmt.exc is not None:
                self.is_traced(stmt.exc)

    def _bind_iter(self, target: ast.expr, it: ast.expr) -> None:
        """Bind a loop target: the keys of ``d.items()`` and the index of
        ``enumerate(...)`` are host values."""
        if isinstance(target, ast.Tuple) and isinstance(
                it, (ast.Tuple, ast.List)) and it.elts and all(
                isinstance(row, ast.Tuple)
                and len(row.elts) == len(target.elts) for row in it.elts):
            for j, e in enumerate(target.elts):      # a literal table
                self._bind(e, any([self.is_traced(row.elts[j])
                                   for row in it.elts]))
            return
        traced = self.is_traced(it)
        if isinstance(target, ast.Tuple) and len(target.elts) == 2 \
                and isinstance(it, ast.Call) and (
                    dotted_name(it.func) == "enumerate"
                    or (isinstance(it.func, ast.Attribute)
                        and it.func.attr == "items")):
            self._bind(target.elts[0], False)
            self._bind(target.elts[1], traced)
            return
        self._bind(target, traced)

    def _bind(self, target: ast.expr, traced: bool) -> None:
        if isinstance(target, ast.Name):
            if traced and target.id not in HOST_NAMES:
                self.traced.add(target.id)
            else:
                self.traced.discard(target.id)
            return
        if isinstance(target, (ast.Tuple, ast.List)):
            for e in target.elts:
                self._bind(e, traced)
            return
        if isinstance(target, ast.Starred):
            self._bind(target.value, traced)
            return
        # a store into an attribute or a subscript: host state when the
        # base is captured host state or ``self``.  A subscript store of a
        # device value may be a tensor write (replayed): not flagged.
        base = _base_name(target)
        if base is not None and self._is_host_state(base) and (
                isinstance(target, ast.Attribute) or not traced):
            self._emit(target, "T106", f"mutation of host state "
                       f"`{_src(target)}` in a captured stage (runs at "
                       "capture, never on replay)")
        if isinstance(target, (ast.Subscript, ast.Attribute)):
            self.is_traced(target.value)

    def _is_host_state(self, name: str) -> bool:
        if name in self.traced:
            return False
        if name in self.mutable_free or name in _HOST_OWNERS:
            return True
        if name in self.bound:
            return False
        return not self.closure.get(name, False)

    # ---------------------------------------------------------- expressions
    def is_traced(self, expr: Optional[ast.expr]) -> bool:
        if expr is None or isinstance(expr, (ast.Constant, ast.Lambda)):
            return False
        if isinstance(expr, ast.Name):
            if expr.id in HOST_NAMES:
                return False
            if expr.id in self.traced:
                return True
            if expr.id in self.bound:
                return False
            return self.closure.get(expr.id, False)
        if isinstance(expr, ast.Attribute):
            base = self.is_traced(expr.value)
            return False if expr.attr in STATIC_RESULT_ATTRS else base
        if isinstance(expr, ast.Subscript):
            return self.is_traced(expr.value) | self.is_traced(expr.slice)
        if isinstance(expr, ast.Slice):
            return any([self.is_traced(e)
                        for e in (expr.lower, expr.upper, expr.step)])
        if isinstance(expr, ast.BinOp):
            return self.is_traced(expr.left) | self.is_traced(expr.right)
        if isinstance(expr, ast.UnaryOp):
            return self.is_traced(expr.operand)
        if isinstance(expr, ast.BoolOp):
            return any([self.is_traced(v) for v in expr.values])
        if isinstance(expr, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in expr.ops):
                self.is_traced(expr.left)
                return False
            if all(isinstance(op, (ast.In, ast.NotIn)) for op in expr.ops) \
                    and isinstance(expr.left, ast.Constant) \
                    and isinstance(expr.left.value, str):
                return False                   # `"key" in tensor_dict`
            return any([self.is_traced(expr.left)]
                       + [self.is_traced(c) for c in expr.comparators])
        if isinstance(expr, ast.Call):
            return self._handle_call(expr)
        if isinstance(expr, ast.IfExp):
            if self.is_traced(expr.test):
                self._emit(expr, "T101", "conditional expression on device "
                           f"value `{_src(expr.test)}` in a captured stage")
            return self.is_traced(expr.body) | self.is_traced(expr.orelse)
        if isinstance(expr, (ast.Tuple, ast.List, ast.Set)):
            return any([self.is_traced(e) for e in expr.elts])
        if isinstance(expr, ast.Dict):
            return any([self.is_traced(v) for v in expr.values]
                       + [self.is_traced(k) for k in expr.keys
                          if k is not None])
        if isinstance(expr, ast.JoinedStr):
            for v in expr.values:
                if isinstance(v, ast.FormattedValue) \
                        and self.is_traced(v.value):
                    self._emit(v, "T105", "f-string of device value "
                               f"`{_src(v.value)}` in a captured stage")
            return False
        if isinstance(expr, (ast.Starred, ast.FormattedValue, ast.Await)):
            return self.is_traced(expr.value)
        if isinstance(expr, ast.NamedExpr):
            t = self.is_traced(expr.value)
            self._bind(expr.target, t)
            return t
        if isinstance(expr, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                             ast.DictComp)):
            return self._handle_comp(expr)
        return False

    def _handle_comp(self, expr) -> bool:
        for gen in expr.generators:
            self._bind_iter(gen.target, gen.iter)
            for cond in gen.ifs:
                if self.is_traced(cond):
                    self._emit(cond, "T101", "comprehension filter on "
                               f"device value `{_src(cond)}` in a captured "
                               "stage")
        if isinstance(expr, ast.DictComp):
            return self.is_traced(expr.key) | self.is_traced(expr.value)
        return self.is_traced(expr.elt)

    # ---------------------------------------------------------------- calls
    def _handle_call(self, call: ast.Call) -> bool:
        name = dotted_name(call.func) or ""
        arg_traced = [self.is_traced(a) for a in call.args]
        kw_traced = {kw.arg: self.is_traced(kw.value)
                     for kw in call.keywords}
        any_arg = any(arg_traced) or any(kw_traced.values())
        first = call.args[0] if call.args else call.func

        if name in ("int", "float", "bool", "complex") and any_arg:
            self._emit(call, "T103", f"{name}() of device value "
                       f"`{_src(first)}` in a captured stage")
            return False
        if name in ("np.asarray", "np.array", "numpy.asarray",
                    "numpy.array") and any_arg:
            self._emit(call, "T104", f"{name}() host sync of device value "
                       f"`{_src(first)}` in a captured stage")
            return False
        if name in HOST_TENSOR_FACTORIES and call.args \
                and self._host_data(call.args[0]):
            self.lint.host_findings.add(Finding(
                self.fi.module.rel, call.lineno, "S403",
                f"{name}() of host data `{_src(call.args[0])}` in a "
                "captured stage: copied at capture, replayed as a constant"))
            return True
        if name == "print" and any_arg:
            self._emit(call, "T105", "print() of a device value in a "
                       "captured stage")
            return False
        if name == "range" and any_arg:
            self._emit(call, "T108", "range() bound by device value "
                       f"`{_src(first)}` in a captured stage")
            return False
        if isinstance(call.func, ast.Attribute):
            recv_traced = self.is_traced(call.func.value)
            attr = call.func.attr
            if attr in _SYNC_METHODS and recv_traced:
                self._emit(call, "T104", f".{attr}() host sync of device "
                           f"value `{_src(call.func.value)}` in a captured "
                           "stage")
                return False
            if attr in STATIC_RESULT_METHODS:
                return False
            if attr == "format" and any_arg:
                self._emit(call, "T105", "str.format of a device value in "
                           "a captured stage")
                return False
            if attr in _LOG_METHODS and any_arg \
                    and _base_name(call.func) in ("logging", "logger",
                                                  "log", "LOG"):
                self._emit(call, "T105", "logging of a device value in a "
                           "captured stage")
                return False
            if attr in _MUTATORS \
                    and attr not in self.lint.project.methods_by_name:
                base = _base_name(call.func)
                if base is not None and self._is_host_state(base):
                    self._emit(call, "T106", "mutation of host state "
                               f"`{_src(call.func.value)}.{attr}(...)` in "
                               "a captured stage (runs at capture, never "
                               "on replay)")
                return recv_traced or any_arg
        if name in STATIC_RESULT_CALLS:
            return False
        resolved = self._resolve_and_recurse(call, arg_traced, kw_traced)
        if resolved is not None:
            return resolved
        if name.startswith("torch.") and not name.startswith(
                ("torch.cuda.", "torch.backends.", "torch.distributed.")):
            return True                         # computed on the device
        recv = (self.is_traced(call.func.value)
                if isinstance(call.func, ast.Attribute) else False)
        return any_arg or recv

    def _host_data(self, expr: ast.expr) -> bool:
        """True when ``expr`` is known to be host data: a literal, a
        ``np.*``/``math.*`` result, arithmetic over those.  A name or a
        parameter may hold a device tensor and is not guessed at."""
        if isinstance(expr, ast.Constant):
            return True
        if isinstance(expr, (ast.List, ast.Tuple, ast.Set)):
            return not any([self.is_traced(e) for e in expr.elts])
        if isinstance(expr, ast.BinOp):
            return self._host_data(expr.left) and self._host_data(expr.right)
        if isinstance(expr, ast.UnaryOp):
            return self._host_data(expr.operand)
        if isinstance(expr, ast.Call):
            name = dotted_name(expr.func) or ""
            return name.startswith(("np.", "numpy.", "math.")) or name in (
                "list", "tuple", "range", "int", "float", "len")
        return False

    def _resolve_and_recurse(self, call: ast.Call, arg_traced: List[bool],
                             kw_traced: Dict[Optional[str], bool]
                             ) -> Optional[bool]:
        cands: List[FuncInfo] = []
        method = False
        if isinstance(call.func, ast.Name):
            cands = self.lint.project.resolve_name(
                call.func.id, self.fi.module, self.fi)
        elif isinstance(call.func, ast.Attribute):
            cands = self.lint.project.resolve_attr_call(
                call.func.value, call.func.attr, self.fi.module)
            method = True
        if not cands:
            return None
        result = False
        for fi in cands[:_MAX_CANDIDATES]:
            params = fi.params()
            if method and params[:1] == ["self"]:
                params = params[1:]
            traced = set()
            for i, t in enumerate(arg_traced):
                if t and i < len(params):
                    traced.add(params[i])
            for k, t in kw_traced.items():
                if t and k in params:
                    traced.add(k)
            closure = (self._snapshot_closure()
                       if fi.module is self.fi.module else {})
            result |= self.lint._analyze(fi, frozenset(traced), closure,
                                         self.depth + 1)
        return result

    def _emit(self, node: ast.AST, code: str, message: str) -> None:
        self.lint.emit(self.fi, node, code, message)


def _base_name(expr: ast.expr) -> Optional[str]:
    while isinstance(expr, (ast.Attribute, ast.Subscript)):
        expr = expr.value
    if isinstance(expr, ast.Name):
        return expr.id
    return None


def _src(expr: ast.AST) -> str:
    try:
        text = ast.unparse(expr)
    except Exception:                            # pragma: no cover
        return "<expr>"
    return text if len(text) <= 40 else text[:37] + "..."


def analysis(project: Project) -> CaptureLint:
    """The pass's run over ``project``, made once and shared with the
    collective pass (S403 rides on this dataflow)."""
    done = getattr(project, "_capture_lint", None)
    if done is None:
        done = CaptureLint(project)
        done.run()
        project._capture_lint = done
    return done


def run(project: Project) -> List[Finding]:
    """Entry point used by the driver: every capture-safety finding."""
    return sorted(analysis(project).findings,
                  key=lambda f: (f.path, f.line, f.code))
