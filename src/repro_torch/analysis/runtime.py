"""Runtime guards: first runs, host syncs, round-input signatures.

Port of ``repro.analysis.runtime``.  The reference proves three serving
invariants over a region with jax's own hooks; the port proves the same
over its own machinery:

* :func:`compile_guard`: zero new programs on a warm stream.  A program
  here is a round key's graph set (captured on the card on its first round,
  its first eager run on the CPU), an admission shape's first run, or a
  kernel library built or loaded (``core/graphs.FIRST_RUNS``,
  ``kernels/build.LOADS``); the reference counts XLA compilations.
* :func:`transfer_guard`: zero implicit host<->device synchronisations,
  through ``torch.cuda.set_sync_debug_mode``: "warn" counted for
  ``level="log"``, "error" (raises at the site) for ``"disallow"``.  The
  engine's explicit crossings (a round's one readback, the admissions,
  the reports) lift the mode for their own call (``device.host_crossing``),
  as explicit ``device_put``/``np.asarray`` crossings are free under the
  reference's guard.  Without a card there is nothing to watch, and the
  guard raises rather than count 0 (:func:`available`).
* :func:`sharding_guard`: each round key of an engine sees ONE signature,
  (shape, dtype, device, stride) of every tensor its round reads: the
  params, the session state copied into the key's static buffers, the
  active mask.  A second signature under one key is a replay reading
  buffers laid out otherwise than the ones it captured (the reference's
  second sharding signature, a silent retrace there).

All three share the reference's contract::

    with compile_guard() as guard:
        run_more_rounds(...)          # same shapes as warmup
    assert guard.count == 0

``count`` is live inside the region and frozen at exit; guards nest.
"""
from __future__ import annotations

import contextlib
import dataclasses
import re
import threading
import warnings
from typing import Dict, Iterator, List, Optional, Tuple

import torch

from repro_torch.core import graphs
from repro_torch.device import sync_debug_mode
from repro_torch.kernels import build

_lock = threading.Lock()


# ---------------------------------------------------------------------------
# compile guard
# ---------------------------------------------------------------------------

def compile_count() -> int:
    """New round keys, admission shapes and kernel libraries so far."""
    return sum(graphs.FIRST_RUNS.values()) + build.LOADS["libraries"]


class CompileGuard:
    """Handle yielded by :func:`compile_guard`: ``count`` is live while the
    region runs and frozen at exit."""

    def __init__(self) -> None:
        self._start = compile_count()
        self._frozen: Optional[int] = None

    @property
    def count(self) -> int:
        if self._frozen is not None:
            return self._frozen
        return compile_count() - self._start


@contextlib.contextmanager
def compile_guard() -> Iterator[CompileGuard]:
    """Count first runs of round keys and admission shapes, and kernel
    library loads, inside the ``with`` region."""
    guard = CompileGuard()
    try:
        yield guard
    finally:
        guard._frozen = compile_count() - guard._start


# ---------------------------------------------------------------------------
# transfer guard
# ---------------------------------------------------------------------------

# c10's warn_or_error_on_sync message
_SYNC_RE = re.compile(r"called a synchronizing CUDA operation")
_events: List[str] = []          # every sync warning seen under a guard
_depth = 0
_installed: Optional[tuple] = None   # (catch_warnings, previous mode)


TRANSFER_GUARD_NEEDS_CUDA = (
    "transfer_guard needs a CUDA device: it watches torch.cuda's host "
    "synchronisations, and a guard over no card would count 0")


def available() -> bool:
    """True when there is a card whose synchronisations can be watched
    (the counterpart of the reference's ``compilation_events_available``)."""
    return torch.cuda.is_available()


class TransferGuard:
    """Handle yielded by :func:`transfer_guard`: ``count`` is the number of
    implicit host syncs in the region, ``lines`` their messages; both live
    while it runs and frozen at exit."""

    def __init__(self) -> None:
        self._start = len(_events)
        self._frozen: Optional[List[str]] = None

    @property
    def lines(self) -> List[str]:
        if self._frozen is not None:
            return self._frozen
        with _lock:
            return list(_events[self._start:])

    @property
    def count(self) -> int:
        return len(self.lines)


def _install() -> None:
    """Outermost guard: sync debug mode "warn", and every sync warning
    recorded (each one: the filter says "always"), the others passed on."""
    global _installed
    catcher = warnings.catch_warnings()
    catcher.__enter__()
    warnings.filterwarnings("always", message=".*" + _SYNC_RE.pattern)
    shown = warnings.showwarning

    def show(message, category, filename, lineno, file=None, line=None):
        text = str(message)
        if _SYNC_RE.search(text):
            with _lock:
                _events.append(f"{filename}:{lineno}: {text}")
        else:
            shown(message, category, filename, lineno, file, line)

    warnings.showwarning = show
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("warn")
    _installed = (catcher, prev)


def _uninstall() -> None:
    global _installed
    catcher, prev = _installed
    torch.cuda.set_sync_debug_mode(prev)
    catcher.__exit__(None, None, None)
    _installed = None


@contextlib.contextmanager
def transfer_guard(level: str = "log") -> Iterator[TransferGuard]:
    """Count implicit host<->device synchronisations inside the region
    (``level="log"``), or raise at the first one (``"disallow"``: sync
    debug mode "error", the traceback at the offending call).  Needs a
    CUDA device: without one it raises, never counting 0 over nothing."""
    global _depth
    if level not in ("log", "disallow"):
        raise ValueError(f"transfer_guard level must be 'log' or "
                         f"'disallow', got {level!r}")
    if not available():
        raise RuntimeError(TRANSFER_GUARD_NEEDS_CUDA)
    if level == "disallow":
        guard = TransferGuard()
        guard._frozen = []
        with sync_debug_mode("error"):
            yield guard
        return
    if _depth == 0:
        _install()
    _depth += 1
    guard = TransferGuard()
    try:
        yield guard
    finally:
        guard._frozen = guard.lines
        _depth -= 1
        if _depth == 0:
            _uninstall()


# ---------------------------------------------------------------------------
# round-input signature guard
# ---------------------------------------------------------------------------

def _leaves(tree) -> Iterator[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name))


def _device(t: torch.Tensor) -> str:
    """``cuda`` and ``cuda:<current>`` are one device."""
    d = t.device
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return str(d)


def _signature(tree) -> tuple:
    """(shape, dtype, device, stride) of every tensor leaf.  A size-1
    dimension's stride moves no element, so it is left out: two layouts
    that differ only there are one layout."""
    return tuple(
        (tuple(t.shape), str(t.dtype), _device(t),
         tuple(s if n != 1 else None for n, s in zip(t.shape, t.stride())))
        for t in _leaves(tree))


class ShardingGuard:
    """Handle yielded by :func:`sharding_guard`.  ``programs`` counts the
    round keys that ran in the region, ``violations`` lists ``(key,
    signatures)`` for keys that saw more than one, ``ok`` is True when
    there are none."""

    def __init__(self) -> None:
        self._sigs: Dict[str, Dict[tuple, None]] = {}

    def _record(self, label: str, sig: tuple) -> None:
        with _lock:
            self._sigs.setdefault(label, {}).setdefault(sig, None)

    @property
    def programs(self) -> int:
        return len(self._sigs)

    @property
    def violations(self) -> List[Tuple[str, List[tuple]]]:
        return [(label, list(sigs)) for label, sigs in sorted(
            self._sigs.items()) if len(sigs) > 1]

    @property
    def ok(self) -> bool:
        return not self.violations

    def render(self) -> str:
        if self.ok:
            return (f"sharding_guard: {self.programs} round key(s), "
                    f"one input signature each")
        lines = []
        for label, sigs in self.violations:
            lines.append(f"{label}: {len(sigs)} input signatures:")
            lines.extend(f"  {s}" for s in sigs)
        return "\n".join(lines)


def _wrap_round(guard: ShardingGuard, name: str, eng):
    original = eng.round

    def recorded(state, *, gamma=None, active=None, timed=False, **kw):
        key = eng.round_key(state, gamma, timed)
        guard._record(f"{name}{key!r}", _signature(
            (state, None if active is None else torch.as_tensor(active))))
        return original(state, gamma=gamma, active=active, timed=timed,
                        **kw)

    return recorded


@contextlib.contextmanager
def sharding_guard(*engines) -> Iterator[ShardingGuard]:
    """One input signature per round key over the region.

    Takes ``SDEngine``s, or ``ServingEngine``s whose live sessions are
    resolved at entry, and wraps each session's ``round`` with a recorder
    of its key and of the signature of what the round reads::

        with sharding_guard(engine) as guard:
            engine.run()                   # warm stream
        assert guard.ok and guard.programs > 0

    The originals are restored on exit."""
    guard = ShardingGuard()
    targets = []
    for eng in engines:
        if hasattr(eng, "_sessions"):            # ServingEngine
            targets.extend(eng._sessions.items())
        else:
            targets.append((type(eng).__name__, eng))
    wrapped = []
    for name, eng in targets:
        had = "round" in vars(eng)
        wrapped.append((eng, had, eng.round))
        eng.round = _wrap_round(guard, name, eng)
    try:
        yield guard
    finally:
        for eng, had, original in wrapped:
            if had:
                eng.round = original
            else:
                del eng.round
