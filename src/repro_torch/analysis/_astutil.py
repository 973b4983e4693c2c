"""Shared AST machinery for the analysis passes.

Port of ``repro.analysis._astutil``.  Everything here is source-level:
modules are parsed, never imported, so the analyzer runs in a second,
needs no card and no ``torch``, and can read fixture files whose code
would fail at run time.

* :class:`Project` parses every ``*.py`` under the given roots once and
  indexes functions (nested defs and ``name = lambda`` bindings too),
  classes and their methods, and import aliases.
* :class:`FuncInfo` is one function-like definition with its lexical
  parent, so closures resolve the way Python scoping does.
* The resolvers are candidate-set based: a call that may reach two
  definitions resolves to both, and anything that cannot be resolved
  (dynamic dispatch, ``getattr``) resolves to nothing; passes then stay
  intra-procedural rather than guess.
"""
from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Union

FuncNode = Union[ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda]


@dataclass
class FuncInfo:
    """One function definition (def or bound lambda) in its lexical scope."""
    node: FuncNode
    module: "ModuleInfo"
    qualname: str
    parent: Optional["FuncInfo"] = None
    # bare name -> nested defs / `name = lambda` bindings in THIS body
    local_funcs: Dict[str, List["FuncInfo"]] = field(default_factory=dict)

    @property
    def name(self) -> str:
        return self.qualname.rsplit(".", 1)[-1]

    @property
    def line(self) -> int:
        return self.node.lineno

    def params(self) -> List[str]:
        a = self.node.args
        names = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
        if a.vararg:
            names.append(a.vararg.arg)
        if a.kwarg:
            names.append(a.kwarg.arg)
        return names

    def positional_params(self) -> List[str]:
        a = self.node.args
        return [p.arg for p in a.posonlyargs + a.args]

    def param_defaults(self) -> Dict[str, ast.expr]:
        """name -> default expression (positional and kw-only)."""
        a = self.node.args
        out: Dict[str, ast.expr] = {}
        pos = a.posonlyargs + a.args
        for p, d in zip(pos[len(pos) - len(a.defaults):], a.defaults):
            out[p.arg] = d
        for p, d in zip(a.kwonlyargs, a.kw_defaults):
            if d is not None:
                out[p.arg] = d
        return out

    def body(self) -> List[ast.stmt]:
        if isinstance(self.node, ast.Lambda):
            return [ast.Expr(self.node.body)]
        return self.node.body


@dataclass
class ClassInfo:
    name: str
    node: ast.ClassDef
    module: "ModuleInfo"
    methods: Dict[str, FuncInfo] = field(default_factory=dict)


class ModuleInfo:
    """Parsed module: tree + function/class/import indexes."""

    def __init__(self, path: str, rel: str, source: str):
        self.path = path
        self.rel = rel                       # repo-relative, for findings
        self.source = source
        self.tree = ast.parse(source, filename=path)
        self.imports: Dict[str, str] = {}    # alias -> dotted target
        self.functions: Dict[str, FuncInfo] = {}   # qualname -> info
        self.top_funcs: Dict[str, List[FuncInfo]] = {}
        self.classes: Dict[str, ClassInfo] = {}
        self._index()

    # ------------------------------------------------------------- indexing
    def _index(self) -> None:
        for node in self.tree.body:
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.imports[a.asname or a.name.split(".")[0]] = a.name
            elif isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    self.imports[a.asname or a.name] = \
                        f"{node.module}.{a.name}"
        for node in self.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._add_func(node, None, node.name)
            elif isinstance(node, ast.ClassDef):
                ci = ClassInfo(node.name, node, self)
                self.classes[node.name] = ci
                for item in node.body:
                    if isinstance(item, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                        fi = self._add_func(item, None,
                                            f"{node.name}.{item.name}")
                        ci.methods[item.name] = fi
        # module-level `name = lambda` bindings
        for node in self.tree.body:
            if (isinstance(node, ast.Assign)
                    and isinstance(node.value, ast.Lambda)
                    and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)):
                name = node.targets[0].id
                fi = FuncInfo(node.value, self, name)
                self.top_funcs.setdefault(name, []).append(fi)
                self.functions.setdefault(name, fi)

    def _add_func(self, node, parent: Optional[FuncInfo],
                  qualname: str) -> FuncInfo:
        fi = FuncInfo(node, self, qualname, parent)
        self.functions[qualname] = fi
        if parent is None:
            self.top_funcs.setdefault(node.name, []).append(fi)
        else:
            parent.local_funcs.setdefault(node.name, []).append(fi)
        self._index_nested(node, fi)
        return fi

    def _index_nested(self, node: ast.AST, owner: FuncInfo) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._add_func(child, owner,
                               f"{owner.qualname}.{child.name}")
            elif (isinstance(child, ast.Assign)
                    and isinstance(child.value, ast.Lambda)
                    and len(child.targets) == 1
                    and isinstance(child.targets[0], ast.Name)):
                name = child.targets[0].id
                fi = FuncInfo(child.value, self,
                              f"{owner.qualname}.{name}", owner)
                owner.local_funcs.setdefault(name, []).append(fi)
            elif not isinstance(child, ast.ClassDef):
                self._index_nested(child, owner)


class Project:
    """All parsed modules under the analysis roots, with repo-wide indexes."""

    def __init__(self, roots: Sequence[str], repo_root: str):
        from repro_torch.analysis.registry import KNOWN_ENTRY_POINTS
        self.repo_root = os.path.abspath(repo_root)
        self.modules: Dict[str, ModuleInfo] = {}     # rel path -> info
        self.methods_by_name: Dict[str, List[FuncInfo]] = {}
        #: method names that resolve project-wide (protocol dispatch the
        #: registry vouches for); everything else resolves same-module only
        self.registry_method_names = frozenset(
            e.qualname.split(".")[1] for e in KNOWN_ENTRY_POINTS
            if "." in e.qualname)
        for root in roots:
            root = os.path.abspath(root)
            if os.path.isfile(root):
                self._load(root)
                continue
            for dirpath, dirnames, filenames in os.walk(root):
                dirnames[:] = [d for d in dirnames
                               if d not in ("__pycache__", ".git")]
                for fn in sorted(filenames):
                    if fn.endswith(".py"):
                        self._load(os.path.join(dirpath, fn))
        for mod in self.modules.values():
            for ci in mod.classes.values():
                for name, fi in ci.methods.items():
                    self.methods_by_name.setdefault(name, []).append(fi)

    def _load(self, path: str) -> None:
        rel = os.path.relpath(path, self.repo_root)
        with open(path) as fh:
            source = fh.read()
        try:
            self.modules[rel] = ModuleInfo(path, rel, source)
        except SyntaxError as exc:                     # pragma: no cover
            raise SyntaxError(f"{rel}: {exc}") from exc

    # ----------------------------------------------------------- resolution
    def module_for_dotted(self, dotted: str) -> Optional[ModuleInfo]:
        """Map an import target like ``repro_torch.kernels.gmm.ragged`` to a parsed
        module (only modules inside the analysis roots resolve)."""
        rel = dotted.replace(".", os.sep) + ".py"
        for known in self.modules:
            if known.endswith(rel):
                return self.modules[known]
        return None

    def resolve_name(self, name: str, mod: ModuleInfo,
                     scope: Optional[FuncInfo]) -> List[FuncInfo]:
        """Candidates for a bare ``name`` referenced from ``scope``."""
        s = scope
        while s is not None:
            if name in s.local_funcs:
                return list(s.local_funcs[name])
            s = s.parent
        if name in mod.top_funcs:
            return list(mod.top_funcs[name])
        target = mod.imports.get(name)
        if target and "." in target:
            owner, attr = target.rsplit(".", 1)
            owned = self.module_for_dotted(owner)
            if owned and attr in owned.top_funcs:
                return list(owned.top_funcs[attr])
        return []

    def resolve_attr_call(self, value: ast.expr, attr: str,
                          mod: ModuleInfo) -> List[FuncInfo]:
        """Candidates for ``value.attr(...)``.

        * ``module_alias.attr`` resolves through the import map;
        * anything else falls back to *method-name* resolution, scoped to
          keep candidate sets honest: methods named in the registry's
          ``KNOWN_ENTRY_POINTS`` (the protocol-dispatched surface:
          ``extend``, ``propose``, ``commit`` …) resolve project-wide;
          any other method name resolves only to classes defined in the
          *calling* module.  Dunder and list/dict-builtin-ish names are
          skipped to avoid resolving ``list.append`` and friends.
        """
        if isinstance(value, ast.Name):
            target = mod.imports.get(value.id)
            if target:
                owned = self.module_for_dotted(target)
                if owned:
                    if attr in owned.top_funcs:
                        return list(owned.top_funcs[attr])
                    return []                 # external module: unresolvable
        if attr.startswith("__"):
            return []
        cands = self.methods_by_name.get(attr, [])
        if attr in self.registry_method_names:
            return list(cands)
        if attr in _BUILTIN_METHODS:
            return []
        return [c for c in cands if c.module is mod]

    def returned_functions(self, fi: FuncInfo
                           ) -> List[List[FuncInfo]]:
        """Per-return-position candidates when ``fi`` returns local
        functions: ``return propose, verify, finalize``, a list of stages
        ``return [propose, verify]`` or ``return fn``.  Empty when the
        return value is not function-shaped."""
        shapes: List[List[List[FuncInfo]]] = []
        for node in ast.walk(fi.node):
            if not isinstance(node, ast.Return) or node.value is None:
                continue
            elts = (node.value.elts
                    if isinstance(node.value, (ast.Tuple, ast.List))
                    else [node.value])
            pos: List[List[FuncInfo]] = []
            for e in elts:
                if isinstance(e, ast.Name):
                    pos.append(self.resolve_name(e.id, fi.module, fi))
                elif isinstance(e, ast.Lambda):
                    pos.append([FuncInfo(e, fi.module,
                                         f"{fi.qualname}.<lambda>", fi)])
                else:
                    pos.append([])
            shapes.append(pos)
        if not shapes:
            return []
        width = max(len(s) for s in shapes)
        merged: List[List[FuncInfo]] = [[] for _ in range(width)]
        for s in shapes:
            for i, cands in enumerate(s):
                for c in cands:
                    if c not in merged[i]:
                        merged[i].append(c)
        return merged


_BUILTIN_METHODS = frozenset({
    "append", "extend", "add", "pop", "popleft", "update", "get", "items",
    "keys", "values", "remove", "clear", "insert", "setdefault", "join",
    "split", "strip", "format", "sum", "mean", "min", "max", "reshape",
    "astype", "copy", "sort", "startswith", "endswith",
})


# -------------------------------------------------------------- const eval
def const_eval(expr: Optional[ast.expr],
               env: Dict[str, object]) -> Optional[object]:
    """Best-effort static evaluation: ints/strs/bools/tuples through
    arithmetic, names via ``env``.  Returns None when any leaf is unknown —
    callers treat None as "symbolic, skip the numeric check"."""
    if expr is None:
        return None
    if isinstance(expr, ast.Constant):
        return expr.value
    if isinstance(expr, ast.Name):
        return env.get(expr.id)
    if isinstance(expr, ast.Tuple):
        vals = [const_eval(e, env) for e in expr.elts]
        return None if any(v is None for v in vals) else tuple(vals)
    if isinstance(expr, ast.UnaryOp) and isinstance(expr.op, ast.USub):
        v = const_eval(expr.operand, env)
        return None if not isinstance(v, (int, float)) else -v
    if isinstance(expr, ast.BinOp):
        lhs = const_eval(expr.left, env)
        rhs = const_eval(expr.right, env)
        if not (isinstance(lhs, (int, float))
                and isinstance(rhs, (int, float))):
            return None
        try:
            if isinstance(expr.op, ast.Add):
                return lhs + rhs
            if isinstance(expr.op, ast.Sub):
                return lhs - rhs
            if isinstance(expr.op, ast.Mult):
                return lhs * rhs
            if isinstance(expr.op, ast.FloorDiv):
                return lhs // rhs
            if isinstance(expr.op, ast.Div):
                return lhs / rhs
            if isinstance(expr.op, ast.Mod):
                return lhs % rhs
            if isinstance(expr.op, ast.Pow):
                return lhs ** rhs
        except (ZeroDivisionError, OverflowError, ValueError):
            return None
    if isinstance(expr, ast.Call) and isinstance(expr.func, ast.Name) \
            and expr.func.id in ("min", "max") and expr.args:
        vals = [const_eval(a, env) for a in expr.args]
        if all(isinstance(v, (int, float)) for v in vals):
            return (min if expr.func.id == "min" else max)(vals)
    return None


def dotted_name(expr: ast.expr) -> Optional[str]:
    if isinstance(expr, ast.Name):
        return expr.id
    if isinstance(expr, ast.Attribute):
        base = dotted_name(expr.value)
        return f"{base}.{expr.attr}" if base else None
    return None


def assigned_names(target: ast.expr) -> List[str]:
    if isinstance(target, ast.Name):
        return [target.id]
    if isinstance(target, (ast.Tuple, ast.List)):
        out: List[str] = []
        for e in target.elts:
            out.extend(assigned_names(e))
        return out
    if isinstance(target, ast.Starred):
        return assigned_names(target.value)
    return []
