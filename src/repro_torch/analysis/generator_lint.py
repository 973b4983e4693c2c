"""Generator-hygiene lint: explicit ``torch.Generator``s through the port.

Counterpart of ``repro.analysis.prng_lint``.  The port's rule is that
every random draw names its generator (a seeded ``torch.Generator``
handed down from the entry point), so a run is reproducible from its
seed and two engines never share a stream.  A CUDA graph adds its own
hazard: a replay draws fresh numbers only from a generator registered
with the graph (``CUDAGraph.register_generator_state``); any other draw
is baked into the capture and repeats on every replay.

========  ===========================================================
 R502     a ``torch.Generator`` is created or seeded and never drawn
          from: no call is handed it, nothing stores or returns it.
 R503     a captured stage draws from a generator the graph does not
          register: a ``with torch.cuda.graph(g)`` block in a scope
          holding a generator with no ``g.register_generator_state``,
          or a ``RoundGraphs.run`` whose stages read a generator but
          which is not handed it (``generator=``).
 R504     ``manual_seed`` with a loop-invariant seed inside a loop:
          every iteration starts the same stream.
 R505     a random draw (``torch.rand*``, ``randint``, ``randperm``,
          ``multinomial``, ``bernoulli``, ``normal``, ``poisson``, a
          tensor's ``uniform_``/``normal_``/``exponential_``/
          ``bernoulli_``/``random_``...) without ``generator=``: it draws
          from the global RNG.
========  ===========================================================

A name is a generator when it is bound to ``torch.Generator(...)`` (or
its ``manual_seed``) or is named ``generator``, ``gen``, ``rng`` or
``*_generator``.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Set

from repro_torch.analysis._astutil import (ModuleInfo, Project,
                                           assigned_names, dotted_name)
from repro_torch.analysis.capture_lint import (graph_bodies, own_walk,
                                               scope_nodes, scopes_of,
                                               stage_sites)
from repro_torch.analysis.findings import Finding

_DRAWS = frozenset({
    "rand", "randn", "randint", "randperm", "multinomial", "bernoulli",
    "normal", "poisson", "rand_like", "randn_like", "randint_like",
})
_TENSOR_DRAWS = frozenset({
    "uniform_", "normal_", "exponential_", "bernoulli_", "random_",
    "cauchy_", "log_normal_", "geometric_", "multinomial", "bernoulli",
})


def _is_generator_name(name: str) -> bool:
    return name in ("generator", "gen", "rng") or name.endswith(
        ("_generator", "_gen"))


def _is_generator_ctor(expr: ast.expr) -> bool:
    """``torch.Generator(...)`` or ``torch.Generator(...).manual_seed(s)``."""
    if isinstance(expr, ast.Call) and isinstance(expr.func, ast.Attribute) \
            and expr.func.attr == "manual_seed":
        return _is_generator_ctor(expr.func.value)
    return isinstance(expr, ast.Call) and (dotted_name(expr.func) or ""
                                           ).endswith("Generator")


class GeneratorLint:
    """One run of the generator pass over a :class:`Project`."""

    def __init__(self, project: Project):
        self.project = project
        self.findings: Set[Finding] = set()

    def _emit(self, mod: ModuleInfo, line: int, code: str, msg: str) -> None:
        self.findings.add(Finding(mod.rel, line, code, msg))

    def run(self) -> List[Finding]:
        for mod in self.project.modules.values():
            for scope, roots in scopes_of(mod):
                self._draws(mod, roots)
                self._unused(mod, roots)
                self._loop_seeds(mod, roots)
        self._graphs()
        return sorted(self.findings, key=lambda f: (f.path, f.line, f.code))

    # ---------------------------------------------------------------- R505
    def _draws(self, mod: ModuleInfo, roots: List[ast.AST]) -> None:
        for node in scope_nodes(mod, roots):
            if not isinstance(node, ast.Call) or any(
                    kw.arg == "generator" for kw in node.keywords):
                continue
            name = dotted_name(node.func) or ""
            head = name.split(".", 1)[0]
            target = mod.imports.get(head, head)
            full = f"{target}.{name.split('.', 1)[1]}" if "." in name \
                else target
            if full.startswith("torch.") and full.count(".") == 1 \
                    and full[6:] in _DRAWS:
                self._emit(mod, node.lineno, "R505",
                           f"`{name}` draws from the global RNG (no "
                           "generator=)")
            elif isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _TENSOR_DRAWS \
                    and not name.startswith(("torch.", "np.", "numpy.")):
                self._emit(mod, node.lineno, "R505",
                           f"`.{node.func.attr}()` draws from the global RNG "
                           "(no generator=)")

    # ---------------------------------------------------------------- R502
    def _unused(self, mod: ModuleInfo, roots: List[ast.AST]) -> None:
        made: Dict[str, int] = {}
        for node in scope_nodes(mod, roots):
            if isinstance(node, ast.Expr) and _is_generator_ctor(node.value):
                self._emit(mod, node.lineno, "R502",
                           "a torch.Generator made and dropped")
            elif isinstance(node, ast.Assign) and _is_generator_ctor(
                    node.value):
                for t in node.targets:
                    for n in assigned_names(t):
                        made.setdefault(n, node.lineno)
        if not made:
            return
        # a bare ``g.manual_seed(s)`` statement seeds, it does not draw
        seeded_only: Dict[str, int] = {}
        for node in scope_nodes(mod, roots):
            if isinstance(node, ast.Expr) and isinstance(node.value,
                                                         ast.Call) \
                    and isinstance(node.value.func, ast.Attribute) \
                    and node.value.func.attr == "manual_seed" \
                    and isinstance(node.value.func.value, ast.Name):
                seeded_only[node.value.func.value.id] = \
                    seeded_only.get(node.value.func.value.id, 0) + 1
        loads: Dict[str, int] = {}
        for node in scope_nodes(mod, roots):
            if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
                loads[node.id] = loads.get(node.id, 0) + 1
        # names read by nested functions count as used
        for node in scope_nodes(mod, roots):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                for sub in ast.walk(node):
                    if isinstance(sub, ast.Name):
                        loads[sub.id] = loads.get(sub.id, 0) + 1
        for name, line in made.items():
            if loads.get(name, 0) <= seeded_only.get(name, 0):
                self._emit(mod, line, "R502",
                           f"generator `{name}` is made and never drawn "
                           "from")

    # ---------------------------------------------------------------- R504
    def _loop_seeds(self, mod: ModuleInfo, roots: List[ast.AST]) -> None:
        for loop in scope_nodes(mod, roots):
            if not isinstance(loop, (ast.For, ast.While)):
                continue
            varying: Set[str] = set()
            if isinstance(loop, ast.For):
                varying.update(assigned_names(loop.target))
            for node in own_walk(loop.body):
                if isinstance(node, ast.Assign):
                    for t in node.targets:
                        varying.update(assigned_names(t))
                elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                    varying.update(assigned_names(node.target))
                elif isinstance(node, (ast.For, ast.comprehension)):
                    varying.update(assigned_names(node.target))
            for node in own_walk(loop.body):
                if isinstance(node, ast.Call) and isinstance(
                        node.func, ast.Attribute) \
                        and node.func.attr == "manual_seed" and node.args:
                    seed = node.args[0]
                    reads = {n.id for n in ast.walk(seed)
                             if isinstance(n, ast.Name)}
                    if not reads & varying:
                        self._emit(mod, node.lineno, "R504",
                                   f"manual_seed({ast.unparse(seed)}) "
                                   "inside a loop does not change with it: "
                                   "every iteration starts the same stream")

    # ---------------------------------------------------------------- R503
    def _graphs(self) -> None:
        for mod, scope, block in graph_bodies(self.project):
            if scope is None:
                continue
            gens = [p for p in scope.params() if _is_generator_name(p)]
            gens += [n for node in own_walk(scope.body())
                     if isinstance(node, ast.Assign)
                     and _is_generator_ctor(node.value)
                     for t in node.targets for n in assigned_names(t)]
            if not gens:
                continue
            graph = next((dotted_name(it.context_expr.args[0])
                          for it in block.items
                          if isinstance(it.context_expr, ast.Call)
                          and it.context_expr.args), None)
            registered = any(
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "register_generator_state"
                and dotted_name(node.func.value) == graph
                for node in own_walk(scope.body()))
            if not registered:
                self._emit(mod, block.lineno, "R503",
                           f"graph `{graph}` is captured with generator "
                           f"`{gens[0]}` in scope but never registers it "
                           "(register_generator_state): its draws are "
                           "baked into the capture")
        for site in stage_sites(self.project):
            if site.generator is not None:
                continue
            for st in site.stages:
                hit = next((n.id for n in ast.walk(st.node)
                            if isinstance(n, ast.Name)
                            and _is_generator_name(n.id)), None)
                if hit is not None:
                    self._emit(site.module, site.call.lineno, "R503",
                               f"stage `{st.name}` reads generator `{hit}` "
                               "but the run is not handed it (generator=)")
                    break


def run(project: Project) -> List[Finding]:
    """Entry point used by the driver: every generator finding."""
    return GeneratorLint(project).run()
