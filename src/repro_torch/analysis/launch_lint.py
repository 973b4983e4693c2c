"""Launch-contract lint: ``ctypes`` bindings against their ``extern "C"``.

Counterpart of ``repro.analysis.pallas_lint``.  Every kernel of the port
is a shared library with a plain C interface, loaded with ``ctypes``
(``kernels/build.py``), and every binding's ``argtypes`` list is typed by
hand against a C signature that nothing else compares it with.  A
dropped or mistyped argument is no error: it is memory corruption on the
card.  The pass finds each library a module loads (``build.load(SOURCE)``
with ``SOURCE = Path(__file__).resolve().parent / "csrc" / "x.cu"``, the
module's own or an imported module's, directly, through a local or
through a helper such as ``_lib()`` that returns it), parses the
``extern "C"`` declarations of that source and of the headers it
includes, and checks every ``lib.<sym>.argtypes`` / ``.restype`` /
``lib.<sym>(...)`` site:

========  ===========================================================
 P302     ``argtypes`` has another length than the C parameter list.
 P306     an ``argtypes`` position of another kind than its C
          parameter (pointer, ``int``, ``long long``, ``float``,
          ``double``; a typed ``POINTER`` must point at the C type).
 P307     ``restype`` differs from the C return type, or a C return
          other than ``int`` has no ``restype`` (ctypes reads an int).
 P308     a call passes another number of arguments than ``argtypes``
          (or, without ``argtypes``, than the C declaration) holds.
 P309     a symbol that no ``extern "C"`` declaration of the library's
          source exports.
========  ===========================================================

What does not resolve statically (a library chosen at run time, an
``argtypes`` list built in a loop, a call through ``*args`` of unknown
length) is skipped, never guessed.  :func:`bound_symbols` gives the
(source, symbol) pairs the tree binds, which ``chip_smoke.py`` holds
against the libraries ``build.py`` built.
"""
from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis._astutil import (FuncInfo, ModuleInfo, Project,
                                           dotted_name)
from repro_torch.analysis.capture_lint import (own_walk, scope_nodes,
                                               scopes_of)
from repro_torch.analysis.findings import Finding

_LOADERS = ("build.load", "load")
_LIB_ATTRS = frozenset({"argtypes", "restype", "errcheck"})

# ctypes spelling -> kind
_CTYPES = {
    "c_void_p": "ptr", "c_char_p": "ptr", "c_int": "int", "c_int32": "int",
    "c_uint": "uint", "c_uint32": "uint", "c_longlong": "longlong",
    "c_int64": "longlong", "c_ulonglong": "ulonglong",
    "c_uint64": "ulonglong", "c_size_t": "ulonglong", "c_long": "longlong",
    "c_float": "float", "c_double": "double", "c_bool": "bool",
    "c_char": "char",
}
# C spelling -> kind (after dropping const and whitespace)
_C_TYPES = {
    "int": "int", "int32_t": "int", "unsigned": "uint", "unsignedint": "uint",
    "uint32_t": "uint", "longlong": "longlong", "int64_t": "longlong",
    "long": "longlong", "unsignedlonglong": "ulonglong",
    "uint64_t": "ulonglong", "size_t": "ulonglong", "float": "float",
    "double": "double", "bool": "bool", "char": "char", "void": "void",
}


# --------------------------------------------------------------- C side
@dataclass(frozen=True)
class CDecl:
    """One ``extern "C"`` function: return kind and parameter kinds
    (``"ptr:<pointee>"`` for pointers)."""
    name: str
    ret: str
    params: Tuple[str, ...]
    line: int


_COMMENT_RE = re.compile(r"//[^\n]*|/\*.*?\*/", re.S)
_DECL_RE = re.compile(
    r'extern\s+"C"\s+(?:__host__\s+)?(?P<ret>[A-Za-z_][\w\s]*?[\w\s\*]*?)'
    r'\s*(?P<name>[A-Za-z_]\w*)\s*\((?P<params>[^)]*)\)')
_INCLUDE_RE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


def _c_kind(text: str) -> str:
    text = re.sub(r"\b(const|volatile|restrict|__restrict__)\b", "", text)
    stars = text.count("*")
    base = re.sub(r"[\s\*]", "", text)
    kind = _C_TYPES.get(base, base)
    return f"ptr:{kind}" if stars else kind


def parse_c_decls(source: str) -> Dict[str, CDecl]:
    """``extern "C"`` declarations of one C/CUDA source text."""
    # blank comments out, keeping line numbers
    text = _COMMENT_RE.sub(lambda m: re.sub(r"[^\n]", " ", m.group(0)),
                           source)
    out: Dict[str, CDecl] = {}
    for m in _DECL_RE.finditer(text):
        raw = m.group("params").strip()
        params: List[str] = []
        if raw and raw != "void":
            for p in raw.split(","):
                p = p.strip()
                # drop the parameter's name (the last identifier), if any
                typ = re.sub(r"[A-Za-z_]\w*\s*$", "", p) \
                    if re.search(r"[\w\*]\s+[A-Za-z_]\w*$|\*\s*[A-Za-z_]\w*$",
                                 p) else p
                params.append(_c_kind(typ))
        out[m.group("name")] = CDecl(m.group("name"),
                                     _c_kind(m.group("ret")), tuple(params),
                                     text.count("\n", 0, m.start()) + 1)
    return out


def library_decls(path: str, seen: Optional[Set[str]] = None
                  ) -> Dict[str, CDecl]:
    """Declarations of a source and, recursively, of every header it
    includes with quotes (what its library exports)."""
    seen = set() if seen is None else seen
    path = os.path.realpath(path)
    if path in seen or not os.path.isfile(path):
        return {}
    seen.add(path)
    with open(path) as fh:
        text = fh.read()
    out = parse_c_decls(text)
    for inc in _INCLUDE_RE.findall(text):
        for k, v in library_decls(os.path.join(os.path.dirname(path), inc),
                                  seen).items():
            out.setdefault(k, v)
    return out


# ----------------------------------------------------------- Python side
def _path_value(expr: ast.expr, mod: ModuleInfo) -> Optional[str]:
    """Evaluate ``Path(__file__).resolve().parent / "csrc" / "x.cu"``."""
    if isinstance(expr, ast.BinOp) and isinstance(expr.op, ast.Div):
        base = _path_value(expr.left, mod)
        if base is None:
            return None
        if isinstance(expr.right, ast.Constant) \
                and isinstance(expr.right.value, str):
            return os.path.join(base, expr.right.value)
        return None
    if isinstance(expr, ast.Attribute) and expr.attr == "parent":
        inner = _path_value(expr.value, mod)
        return None if inner is None else os.path.dirname(inner)
    if isinstance(expr, ast.Call) and isinstance(expr.func, ast.Attribute) \
            and expr.func.attr in ("resolve", "absolute"):
        return _path_value(expr.func.value, mod)
    if isinstance(expr, ast.Call) and dotted_name(expr.func) in (
            "Path", "pathlib.Path") and len(expr.args) == 1 \
            and isinstance(expr.args[0], ast.Name) \
            and expr.args[0].id == "__file__":
        return os.path.realpath(mod.path)
    return None


def module_source(mod: ModuleInfo) -> Optional[str]:
    """The module's ``SOURCE = Path(...) / ...`` as an absolute path."""
    for node in mod.tree.body:
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            if any(isinstance(t, ast.Name) and t.id == "SOURCE"
                   for t in targets) and node.value is not None:
                return _path_value(node.value, mod)
    return None


@dataclass
class _Binding:
    """What the sites of one (library, symbol) declare."""
    argtypes: Optional[List[Optional[str]]] = None
    argtypes_at: Tuple[str, int] = ("", 0)
    restype: Optional[str] = None
    restype_set: bool = False
    calls: List[Tuple[str, int, Optional[int]]] = field(default_factory=list)
    reads: List[Tuple[str, int]] = field(default_factory=list)


class LaunchLint:
    """One run of the launch-contract pass over a :class:`Project`."""

    def __init__(self, project: Project):
        self.project = project
        self.findings: Set[Finding] = set()
        self.bindings: Dict[Tuple[str, str], _Binding] = {}
        self._decls: Dict[str, Dict[str, CDecl]] = {}
        self._import_memo: Dict[int, Dict[str, str]] = {}
        self._assign_memo: Dict[int, Dict[str, List[ast.expr]]] = {}
        self._lib_memo: Dict[Tuple[int, int], Optional[str]] = {}

    # ------------------------------------------------------- resolution
    def _imports(self, mod: ModuleInfo, scope: Optional[FuncInfo]
                 ) -> Dict[str, str]:
        memo = self._import_memo.get(id(scope or mod))
        if memo is not None:
            return memo
        out = self._import_memo[id(scope or mod)] = dict(mod.imports)
        s = scope
        while s is not None:
            for node in ast.walk(s.node):
                if isinstance(node, ast.ImportFrom) and node.module:
                    for a in node.names:
                        out[a.asname or a.name] = f"{node.module}.{a.name}"
                elif isinstance(node, ast.Import):
                    for a in node.names:
                        out[a.asname or a.name.split(".")[0]] = a.name
            s = s.parent
        return out

    def _source_expr(self, expr: ast.expr, mod: ModuleInfo,
                     scope: Optional[FuncInfo]) -> Optional[str]:
        """The path a ``build.load`` argument names: ``SOURCE`` of this
        module or ``alias.SOURCE`` of an imported one."""
        if isinstance(expr, ast.Name) and expr.id == "SOURCE":
            return module_source(mod)
        if isinstance(expr, ast.Attribute) and expr.attr == "SOURCE" \
                and isinstance(expr.value, ast.Name):
            target = self._imports(mod, scope).get(expr.value.id)
            other = self.project.module_for_dotted(target) if target else None
            return module_source(other) if other is not None else None
        return None

    def _lib_of(self, expr: ast.expr, mod: ModuleInfo,
                scope: Optional[FuncInfo], depth: int = 0) -> Optional[str]:
        """The source whose library ``expr`` evaluates to, or None."""
        key = (id(expr), id(scope))
        if key not in self._lib_memo:
            self._lib_memo[key] = None          # a cycle resolves to None
            self._lib_memo[key] = self._lib_of_uncached(expr, mod, scope,
                                                        depth)
        return self._lib_memo[key]

    def _lib_of_uncached(self, expr: ast.expr, mod: ModuleInfo,
                         scope: Optional[FuncInfo], depth: int
                         ) -> Optional[str]:
        if depth > 4:
            return None
        if isinstance(expr, ast.Call) and dotted_name(expr.func) in _LOADERS \
                and len(expr.args) == 1:
            return self._source_expr(expr.args[0], mod, scope)
        if isinstance(expr, ast.Call) and isinstance(expr.func, ast.Name) \
                and not expr.args:
            for fi in self.project.resolve_name(expr.func.id, mod, scope):
                for node in ast.walk(fi.node):
                    if isinstance(node, ast.Return) and node.value is not None:
                        src = self._lib_of(node.value, fi.module, fi,
                                           depth + 1)
                        if src:
                            return src
            return None
        if isinstance(expr, ast.Name) and scope is not None:
            s = scope
            while s is not None:
                for value in self._assigns(s).get(expr.id, ()):
                    src = self._lib_of(value, mod, s, depth + 1)
                    if src:
                        return src
                s = s.parent
        return None

    def _assigns(self, scope: FuncInfo) -> Dict[str, List[ast.expr]]:
        """name -> values of its plain ``name = value`` assignments."""
        memo = self._assign_memo.get(id(scope.node))
        if memo is None:
            memo = self._assign_memo[id(scope.node)] = {}
            for node in own_walk(scope.body()):
                if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                        and isinstance(node.targets[0], ast.Name):
                    memo.setdefault(node.targets[0].id, []).append(
                        node.value)
        return memo

    def _symbol_of(self, expr: ast.expr, mod: ModuleInfo,
                   scope: Optional[FuncInfo],
                   loops: Dict[str, List[ast.expr]]
                   ) -> List[Tuple[str, str]]:
        """(source, symbol) pairs ``expr`` stands for: ``lib.sym``, or a
        loop name over a tuple of them."""
        if isinstance(expr, ast.Attribute) and not expr.attr.startswith("_"):
            src = self._lib_of(expr.value, mod, scope)
            return [(src, expr.attr)] if src else []
        if isinstance(expr, ast.Name) and expr.id in loops:
            out = []
            for e in loops[expr.id]:
                out += self._symbol_of(e, mod, scope, {})
            return out
        return []

    # ------------------------------------------------------------ kinds
    def _kind(self, expr: ast.expr, aliases: Dict[str, ast.expr]
              ) -> Optional[str]:
        if isinstance(expr, ast.Name) and expr.id in aliases:
            return self._kind(aliases[expr.id], {})
        name = dotted_name(expr) or ""
        short = name.rsplit(".", 1)[-1]
        if short in _CTYPES:
            return _CTYPES[short]
        if isinstance(expr, ast.Call) and (dotted_name(expr.func) or ""
                                           ).endswith("POINTER") \
                and expr.args:
            inner = self._kind(expr.args[0], aliases)
            return None if inner is None else f"ptr:{inner}"
        if isinstance(expr, ast.Constant) and expr.value is None:
            return "void"
        return None

    def _kinds(self, expr: ast.expr, aliases: Dict[str, ast.expr]
               ) -> Optional[List[Optional[str]]]:
        if isinstance(expr, (ast.List, ast.Tuple)):
            return [self._kind(e, aliases) for e in expr.elts]
        if isinstance(expr, ast.BinOp) and isinstance(expr.op, ast.Mult):
            for seq, n in ((expr.left, expr.right), (expr.right, expr.left)):
                if isinstance(n, ast.Constant) and isinstance(n.value, int):
                    inner = self._kinds(seq, aliases)
                    return None if inner is None else inner * n.value
            return None
        if isinstance(expr, ast.BinOp) and isinstance(expr.op, ast.Add):
            a = self._kinds(expr.left, aliases)
            b = self._kinds(expr.right, aliases)
            return None if a is None or b is None else a + b
        return None

    @staticmethod
    def _aliases(scope_roots: Sequence[ast.AST]) -> Dict[str, ast.expr]:
        """``p, i = ctypes.c_void_p, ctypes.c_int`` and ``st =
        ctypes.POINTER(...)`` bindings of one scope."""
        out: Dict[str, ast.expr] = {}
        for node in own_walk(scope_roots):
            if not isinstance(node, ast.Assign) or len(node.targets) != 1:
                continue
            t, v = node.targets[0], node.value
            if isinstance(t, ast.Name):
                out[t.id] = v
            elif isinstance(t, ast.Tuple) and isinstance(v, ast.Tuple) \
                    and len(t.elts) == len(v.elts):
                for a, b in zip(t.elts, v.elts):
                    if isinstance(a, ast.Name):
                        out[a.id] = b
        return out

    # ------------------------------------------------------------ sites
    def _scan(self, mod: ModuleInfo, scope: Optional[FuncInfo],
              roots: List[ast.AST]) -> None:
        aliases = self._aliases(roots)
        loops: Dict[str, List[ast.expr]] = {}
        tuples: Dict[str, int] = {}
        for node in scope_nodes(mod, roots):
            if isinstance(node, ast.For) and isinstance(node.target,
                                                        ast.Name) \
                    and isinstance(node.iter, (ast.Tuple, ast.List)):
                loops[node.target.id] = list(node.iter.elts)
            elif isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and isinstance(node.value, ast.Tuple) and not any(
                        isinstance(e, ast.Starred) for e in node.value.elts):
                tuples[node.targets[0].id] = len(node.value.elts)
        for node in scope_nodes(mod, roots):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Attribute) \
                    and node.targets[0].attr in ("argtypes", "restype"):
                tgt = node.targets[0]
                for src, sym in self._symbol_of(tgt.value, mod, scope, loops):
                    b = self.bindings.setdefault((src, sym), _Binding())
                    if tgt.attr == "argtypes":
                        b.argtypes = self._kinds(node.value, aliases)
                        b.argtypes_at = (mod.rel, node.lineno)
                    else:
                        b.restype = self._kind(node.value, aliases)
                        b.restype_set = True
                        b.reads.append((mod.rel, node.lineno))
            elif isinstance(node, ast.Call) and isinstance(node.func,
                                                           ast.Attribute):
                for src, sym in self._symbol_of(node.func, mod, scope, {}):
                    n: Optional[int] = 0
                    for a in node.args:
                        if isinstance(a, ast.Starred):
                            k = tuples.get(a.value.id) if isinstance(
                                a.value, ast.Name) else None
                            n = None if n is None or k is None else n + k
                        elif n is not None:
                            n += 1
                    if node.keywords:
                        n = None
                    self.bindings.setdefault((src, sym), _Binding()
                                             ).calls.append(
                        (mod.rel, node.lineno, n))
            elif isinstance(node, ast.Attribute) and isinstance(
                    node.ctx, ast.Load) and node.attr not in _LIB_ATTRS:
                for src, sym in self._symbol_of(node, mod, scope, {}):
                    self.bindings.setdefault((src, sym), _Binding()
                                             ).reads.append(
                        (mod.rel, node.lineno))

    def collect(self) -> Dict[Tuple[str, str], _Binding]:
        for mod in self.project.modules.values():
            for scope, roots in scopes_of(mod):
                self._scan(mod, scope, roots)
        return self.bindings

    def decls(self, src: str) -> Dict[str, CDecl]:
        if src not in self._decls:
            self._decls[src] = library_decls(src)
        return self._decls[src]

    def run(self) -> List[Finding]:
        self.collect()
        for (src, sym), b in sorted(self.bindings.items()):
            self._check(src, sym, b)
        return sorted(self.findings, key=lambda f: (f.path, f.line, f.code))

    def _emit(self, at: Tuple[str, int], code: str, msg: str) -> None:
        self.findings.add(Finding(at[0], at[1], code, msg))

    def _check(self, src: str, sym: str, b: _Binding) -> None:
        lib = os.path.basename(src)
        sites = ([b.argtypes_at] if b.argtypes is not None else []) \
            + [(p, ln) for p, ln, _ in b.calls] + b.reads
        decl = self.decls(src).get(sym)
        if decl is None:
            for at in sorted(set(sites)):
                self._emit(at, "P309", f"`{sym}` is exported by no extern "
                           f"\"C\" declaration of {lib}")
            return
        if b.argtypes is not None:
            at = b.argtypes_at
            if len(b.argtypes) != len(decl.params):
                self._emit(at, "P302", f"`{sym}.argtypes` has "
                           f"{len(b.argtypes)} entries, {lib}:{decl.line} "
                           f"declares {len(decl.params)} parameters")
            else:
                for i, (py, c) in enumerate(zip(b.argtypes, decl.params)):
                    if py is not None and not _agrees(py, c):
                        self._emit(at, "P306", f"`{sym}.argtypes[{i}]` is "
                                   f"{py}, {lib}:{decl.line} declares {c}")
        if b.restype_set:
            if b.restype is not None and not _agrees(
                    b.restype, decl.ret) and not (
                    b.restype == "void" and decl.ret == "void"):
                at = next(iter(b.reads), b.argtypes_at)
                self._emit(at, "P307", f"`{sym}.restype` is {b.restype}, "
                           f"{lib}:{decl.line} returns {decl.ret}")
        elif decl.ret not in ("int", "void"):
            for at in sorted(set(sites))[:1]:
                self._emit(at, "P307", f"`{sym}` returns {decl.ret} "
                           f"({lib}:{decl.line}) but has no restype: "
                           "ctypes reads an int")
        want = len(b.argtypes) if b.argtypes is not None \
            else len(decl.params)
        for path, line, n in b.calls:
            if n is not None and n != want:
                self._emit((path, line), "P308", f"`{sym}` called with {n} "
                           f"arguments, it takes {want}")


def _agrees(py: str, c: str) -> bool:
    """A ctypes kind against a C kind: ``c_void_p`` takes any pointer, a
    typed ``POINTER`` only its own pointee (or ``void*``)."""
    if py == c:
        return True
    if py == "ptr" and c.startswith("ptr:"):
        return True
    if py.startswith("ptr:") and c == "ptr:void":
        return True
    return False


def bound_symbols(project: Project) -> Dict[str, Set[str]]:
    """source path -> every symbol the tree binds or calls in its
    library (what each library built from the source must export)."""
    out: Dict[str, Set[str]] = {}
    for (src, sym) in LaunchLint(project).collect():
        out.setdefault(src, set()).add(sym)
    return out


def run(project: Project) -> List[Finding]:
    """Entry point used by the driver: every launch-contract finding."""
    return LaunchLint(project).run()
