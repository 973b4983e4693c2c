"""Counting a step on the ``meta`` device: its FLOPs, the bytes its
operations move, its peak of live bytes and its collectives, without
allocating or computing anything (``launch/dryrun.py``).

``StepCounter`` is a ``TorchDispatchMode``: every aten operation dispatched
while it is active is run (on meta tensors that only computes shapes) and
counted.

* FLOPs by ``torch.utils.flop_counter``'s registry, the formulas and the
  decomposition rule of ``FlopCounterMode`` (the same total on the same
  step; tests/test_torch_dryrun.py holds that).
* Bytes: every operation reads each tensor operand once and writes each
  result once, views and allocations move nothing.  An unfused count: the
  kernels of the card fuse much of it, and re-read what does not fit.
* Live bytes: each result that is a new storage is live from its operation
  until the last tensor on it is freed; the storages of the tensors handed
  to ``pin`` (params, optimizer state, cache, batch: the resident bytes)
  are never counted.  ``peak`` is the most live at once over the step.
* Collectives: ``distributed/collectives.py`` records each collective it
  issues over a ``launch/mesh.CensusMesh`` (``record_collective``): its
  operand bytes on this rank, by kind, by mesh axis, and ``in_loop``
  (issued by a layer of the stack) or ``outside``.
* Kernels: a kernel wrapper that launches nothing on the meta device (the
  ragged expert products, ``kernels/gmm/ragged.py``) records its own
  FLOPs and bytes (``record_kernel``).

Stated routing.  The ragged expert products' work follows the routing's
group sizes, which a meta tensor does not hold.  ``stated_group_sizes``
stands a uniform routing in for them on the meta device (every expert
receives floor(R/E) of the R routed rows, the first R mod E one more),
and the dry-run's record names it (``knobs["routing"]``).

``repeat(n)`` counts every operation inside it n times in every active
counter: ``models/ssm.py`` runs one step of a recurrence whose steps all
cost the same and stands it for all of them, so a 32k-step prefill is
counted without 32k steps of dispatch.  Live bytes are not repeated.
"""
from __future__ import annotations

import contextlib
import weakref
from typing import Dict, Iterable, List

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)
from torch.utils.flop_counter import flop_registry

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")

# metadata queries: no operation, nothing to count
_QUERIES = {torch.ops.aten.is_contiguous.default,
            torch.ops.aten.is_contiguous.memory_format,
            torch.ops.aten.is_strides_like_format.default,
            torch.ops.aten.is_non_overlapping_and_dense.default,
            torch.ops.aten.size.default, torch.ops.aten.sym_size.default,
            torch.ops.aten.stride.default, torch.ops.aten.sym_stride.default,
            torch.ops.aten.storage_offset.default,
            torch.ops.aten.sym_storage_offset.default,
            torch.ops.aten.numel.default, torch.ops.aten.sym_numel.default,
            torch.ops.aten.dim.default, torch.ops.prim.layout.default,
            torch.ops.prim.device.default}
# allocations: a new storage, no bytes moved
_ALLOCS = {torch.ops.aten.empty.memory_format, torch.ops.aten.empty_like.default,
           torch.ops.aten.empty_strided.default,
           torch.ops.aten.new_empty.default,
           torch.ops.aten.new_empty_strided.default}

# the counters entered, innermost last (a dispatch mode is process-wide)
_ACTIVE: List["StepCounter"] = []


def tensors(tree) -> Iterable[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tensors(v)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class StepCounter(TorchDispatchMode):
    """The costs of what runs inside ``with StepCounter() as c:`` (module
    docstring): ``flops``, ``bytes``, ``peak`` (live bytes beyond the
    pinned ones), ``allocated`` (the bytes of every new storage, summed),
    ``collectives`` {kind: bytes, "in_loop", "outside", "total"},
    ``collectives_by_axis`` {axis or "a+b": bytes} and ``real``, the
    results on a device other than meta but numbers wrapped as 0-dim CPU
    tensors (0: nothing was allocated)."""

    def __init__(self) -> None:
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self.allocated = 0
        self.real = 0
        self.collectives: Dict[str, int] = {k: 0 for k in KINDS}
        self.collectives.update(in_loop=0, outside=0, total=0)
        self.collectives_by_axis: Dict[str, int] = {}
        self.weight = 1
        self._depth = 0
        self._pinned: set = set()
        self._storages: Dict[int, list] = {}   # key: [bytes, tensors on it]

    def pin(self, tree) -> int:
        """Exclude the storages of every tensor of ``tree`` (resident
        inputs) from the live bytes; returns their bytes, each storage
        once."""
        total = 0
        for t in tensors(tree):
            k = _key(t)
            if k not in self._pinned:
                self._pinned.add(k)
                total += t.untyped_storage().nbytes()
        return total

    def new_bytes(self, tree) -> int:
        """Bytes of the storages of ``tree`` that are not pinned (a step's
        results that are not its inputs), each once."""
        seen, total = set(self._pinned), 0
        for t in tensors(tree):
            k = _key(t)
            if k not in seen:
                seen.add(k)
                total += t.untyped_storage().nbytes()
        return total

    def __enter__(self):
        # entered again around a decomposition: active once
        self._depth += 1
        if self._depth == 1:
            _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        self._depth -= 1
        if self._depth == 0:
            _ACTIVE.remove(self)
        return super().__exit__(*exc)

    # -------------------------------------------------------------- live
    def _release(self, key: int) -> None:
        entry = self._storages.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self.live -= entry[0]
            del self._storages[key]

    def _track(self, t: torch.Tensor) -> None:
        k = _key(t)
        if k in self._pinned:
            return
        entry = self._storages.get(k)
        if entry is None:
            entry = self._storages[k] = [t.untyped_storage().nbytes(), 0]
            self.live += entry[0]
            self.allocated += self.weight * entry[0]
            self.peak = max(self.peak, self.live)
        entry[1] += 1
        weakref.finalize(t, self._release, k)

    # --------------------------------------------------------- dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _QUERIES:
            return func(*args, **kwargs)
        # a composite operation counts as what it decomposes into
        with self:
            r = func.decompose(*args, **kwargs)
        if r is not NotImplemented:
            return r
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        if packet in flop_registry:
            self.flops += self.weight * int(
                flop_registry[packet](*args, **kwargs, out_val=out))
        outs = list(tensors(out))
        if not func.is_view and func not in _ALLOCS:
            moved = sum(_nbytes(t) for t in tensors((args, kwargs)))
            moved += sum(_nbytes(t) for t in outs)
            self.bytes += self.weight * moved
        for t in outs:
            # a 0-dim CPU scalar is a number wrapped for an operation
            self.real += t.device.type != "meta" and t.dim() > 0
            self._track(t)
        return out

    # ------------------------------------------------------ collectives
    def record(self, kind: str, nbytes: int, axes, in_loop: bool) -> None:
        n = self.weight * int(nbytes)
        self.collectives[kind] += n
        self.collectives["in_loop" if in_loop else "outside"] += n
        self.collectives["total"] += n
        name = "+".join(axes)
        self.collectives_by_axis[name] = (
            self.collectives_by_axis.get(name, 0) + n)


def record_collective(kind: str, nbytes: int, axes, in_loop: bool) -> None:
    """Record one collective (operand bytes on this rank) in every active
    counter."""
    for c in _ACTIVE:
        c.record(kind, nbytes, tuple(axes), in_loop)


def record_kernel(flops: int, nbytes: int) -> None:
    """Record one kernel's FLOPs and the bytes it moves in every active
    counter (a wrapper that launches nothing on the meta device)."""
    for c in _ACTIVE:
        c.flops += c.weight * int(flops)
        c.bytes += c.weight * int(nbytes)


def stated_group_sizes(sizes: torch.Tensor, rows: int) -> torch.Tensor:
    """The group sizes a ragged kernel runs on: ``sizes`` itself off the
    meta device; on it, the stated uniform routing of ``rows`` routed rows
    over ``sizes.numel()`` experts (module docstring), a real int32 CPU
    tensor made outside every counter (no operation of the step)."""
    if not sizes.is_meta:
        return sizes
    n = sizes.numel()
    with _disable_current_modes():
        out = torch.full((n,), rows // n, dtype=torch.int32)
        out[:rows % n] += 1
    return out


@contextlib.contextmanager
def repeat(n: int):
    """Count every operation and collective inside ``n`` times."""
    for c in _ACTIVE:
        c.weight *= n
    try:
        yield
    finally:
        for c in _ACTIVE:
            c.weight //= n
