"""CUDA graphs for the SD round: one captured graph set per shape key.

The port's counterpart of the reference's jitted round
(``repro.core.spec_decode.SDEngine._round_fn``, one ``jax.jit`` of the
whole propose/verify/reject/commit round per gamma, and ``_staged_jits``,
its stage programs for ``timed=True`` and for prefetch-aware proposers,
whose warm stage runs between propose and verify).  A round is given to
:meth:`RoundGraphs.run` as a list of stage callables over static buffers:
each stage reads the session's tensors (the arena of
``core/spec_decode.py``: caches, lengths, block table, last token) and the
round's :class:`StaticIO` (the ``active`` mask in, the packed results out),
writes them in place, and hands its intermediates to the next stage.

Keys.  A key is (stage, gamma, batch, max_seq, cache geometry); the caller
builds it.  The first time a key runs, its stages run eagerly on the
current stream (the round's real work, and the warm-up that loads the
kernels' libraries, opts them into their shared memory and creates the
cuBLAS workspaces), and then each stage is captured into one
``torch.cuda.CUDAGraph`` on the set's capture stream, every key of the set
in one memory pool (``torch.cuda.graph_pool_handle()``).  Every later run of
the key replays the stage graphs on the current stream.  ``captures`` and
``replays`` count both per key, as the reference's ``trace_log`` counts
traces; a capture that fails raises, and nothing falls back to eager.

A generator the round draws from (temperature > 0) is registered with each
graph (``CUDAGraph.register_generator_state``), so every replay draws fresh
numbers from the generator's current offset and advances it, and eager
draws between replays (prefill, admission) never repeat them.  A replay
must be given the generator its graphs were captured with.

Launch crediting.  The kernel wrappers count launches in Python
(``LAUNCHES`` of each wrapper module) and ``Model`` counts its forwards
(``forward_count``, ``prefill_count``); a replay runs no Python.  So each
capture reads every counter before and after, takes the difference back
(a capture launches nothing), and adds it on every replay: after any run,
the counters hold what an eager run would have counted.

``FIRST_RUNS`` counts, over every session, the round keys run for the
first time (a capture on the card) and the admission shapes the engine
ran for the first time (``SDEngine._log_shape``): ``analysis/runtime.py``'s
``compile_guard`` reads it.  ``collectives.EP_CALLS`` is credited per
replay like the kernels' launch counts.

On the CPU there are no graphs.  The caller chose the CPU (or
``capture=False`` on the card, for A/B runs): the same stages run eagerly
on the same static buffers every time, and the same key logic counts a
capture the first time a key runs and a replay every later time.
"""
from __future__ import annotations

import gc
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import host_crossing
from repro_torch.distributed import collectives
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.decode_attention import paged
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.gmm import gmm, ragged

KERNEL_MODULES = (ragged, paged, decode_ops, flash_attention, gmm)
# the counters a replay credits: each kernel's launches, and the
# expert-parallel dispatches
_COUNTERS = tuple(m.LAUNCHES for m in KERNEL_MODULES) + (collectives.EP_CALLS,)
# first runs of a round key and of an admission shape, over every session
FIRST_RUNS = {"round_keys": 0, "admission_shapes": 0}
_MODEL_COUNTERS = ("forward_count", "prefill_count")

Stage = Callable[[object], object]


class StaticIO:
    """The static buffers of one round key besides the arena: the
    ``active`` mask (B,) with its pinned host staging buffer, and the
    round's results packed into one int32 tensor [committed (width + 1) |
    n_commit | n_accept | finite | prefetch hits, actual, predicted (a
    prefetch round only, the same on every row)] with its pinned host
    copy, so a round reads back with one device-to-host copy."""

    PF_KEYS = ("hits", "actual", "predicted")

    def __init__(self, batch: int, device: torch.device):
        self.device = device
        self.active = torch.ones((batch,), dtype=torch.bool, device=device)
        pin = device.type == "cuda"
        self._active_host = torch.ones((batch,), dtype=torch.bool,
                                       pin_memory=pin)
        self.out: Optional[torch.Tensor] = None
        self._out_host: Optional[torch.Tensor] = None
        self._n_pf = 0

    def set_active(self, active) -> None:
        """Copy the host mask in (None: every row) without a host sync:
        pinned staging and a copy on the current stream.  The previous
        round's readback already waited for the last copy from it."""
        if active is None:
            self.active.fill_(True)
            return
        self._active_host.numpy()[:] = np.asarray(active, bool)
        self.active.copy_(self._active_host, non_blocking=True)

    def publish(self, committed, n_commit, n_accept, finite,
                pf: Optional[Dict[str, torch.Tensor]] = None) -> None:
        """Inside the round: pack the results (and a prefetch round's
        device counts ``pf``) into ``out``, allocated by the key's first,
        eager run, so graphs write the same buffer."""
        cols = [committed.to(torch.int32), n_commit.to(torch.int32)[:, None],
                n_accept.to(torch.int32)[:, None],
                finite.to(torch.int32)[:, None]]
        if pf is not None:
            counts = torch.stack([pf[k] for k in self.PF_KEYS]).to(torch.int32)
            cols.append(counts[None, :].expand(committed.shape[0], -1))
        packed = torch.cat(cols, 1)
        if self.out is None:
            # lint: allow[T106] allocated by the key's first, eager run
            self._n_pf = 0 if pf is None else len(self.PF_KEYS)
            # lint: allow[T106] allocated by the key's first, eager run
            self.out = torch.empty_like(packed)
            if self.device.type == "cuda":
                # lint: allow[T106] allocated by the key's first, eager run
                self._out_host = torch.empty(packed.shape, dtype=torch.int32,
                                             pin_memory=True)
        self.out.copy_(packed)

    def read(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray,
                            Optional[Dict[str, int]]]:
        """The round's one readback: (committed, n_commit, n_accept,
        finite, prefetch counts or None) as new host values.  On the card
        this is the round's only host sync, an explicit crossing
        (``device.host_crossing``)."""
        if self._out_host is not None:
            self._out_host.copy_(self.out, non_blocking=True)
            with host_crossing():
                torch.cuda.current_stream().synchronize()
            packed = self._out_host.numpy()
        else:
            packed = self.out.numpy()
        w = packed.shape[1] - 3 - self._n_pf
        pf = (dict(zip(self.PF_KEYS, map(int, packed[0, w + 3:])))
              if self._n_pf else None)
        return (packed[:, :w].copy(), packed[:, w].copy(),
                packed[:, w + 1].copy(), packed[:, w + 2].astype(bool), pf)


@dataclass
class _Captured:
    """One key's stage graphs, what each capture allocated (kept alive: the
    next stage's graph reads it) and each stage's counter credit."""
    graphs: List[torch.cuda.CUDAGraph] = field(default_factory=list)
    outputs: List[object] = field(default_factory=list)
    credits: List[List[int]] = field(default_factory=list)
    generator: Optional[torch.Generator] = None


class RoundGraphs:
    """The captured rounds of one session, keyed by shape (module
    docstring).  ``models`` are the models whose forward counters a replay
    credits (the target and the draft)."""

    def __init__(self, device: torch.device, *, capture: bool,
                 models: Sequence = ()):
        if capture and device.type != "cuda":
            raise ValueError("CUDA graphs need a CUDA device; on the CPU "
                             "rounds run eagerly (capture=False)")
        self.device = device
        self.capture = capture
        self.captures: Dict[tuple, int] = {}
        self.replays: Dict[tuple, int] = {}
        self.capture_seconds: Dict[tuple, float] = {}
        self._models = tuple(models)
        self._captured: Dict[tuple, _Captured] = {}
        self._pool = None
        self._stream: Optional[torch.cuda.Stream] = None

    # ------------------------------------------------------------- counters
    @property
    def total_captures(self) -> int:
        return sum(self.captures.values())

    @property
    def total_replays(self) -> int:
        return sum(self.replays.values())

    def _slots(self):
        slots = [(c, name) for c in _COUNTERS for name in c]
        return slots + [(model, attr) for model in self._models
                        for attr in _MODEL_COUNTERS]

    @staticmethod
    def _read(slots) -> List[int]:
        return [c[k] if isinstance(c, dict) else getattr(c, k)
                for c, k in slots]

    @staticmethod
    def _add(slots, deltas: Sequence[int]) -> None:
        for (c, k), n in zip(slots, deltas):
            if not n:
                continue
            if isinstance(c, dict):
                c[k] += n
            else:
                setattr(c, k, getattr(c, k) + n)

    def pool_bytes(self) -> int:
        """Bytes the card holds in the set's graph pool (its segments in
        ``torch.cuda.memory_snapshot()``); 0 before the first capture."""
        if self._pool is None:
            return 0
        pool = tuple(self._pool)
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg["segment_pool_id"]) == pool)

    # ------------------------------------------------------------------ run
    def run(self, key: tuple, stages: Sequence[Stage], *,
            generator: Optional[torch.Generator] = None,
            after_stage: Optional[Callable[[int], None]] = None) -> bool:
        """Run one round of ``key``: its stages in order, each fed the
        previous one's return value (None for the first), eagerly or from
        the key's graphs.  ``after_stage(i)`` runs after stage i either way
        (the caller's timing sync).  Returns True when this run was the
        key's first (its capture)."""
        after = after_stage or (lambda i: None)
        first = key not in self.captures
        if first:
            FIRST_RUNS["round_keys"] += 1
            out = None
            for i, stage in enumerate(stages):
                out = stage(out)
                after(i)
            if self.capture:
                self._capture(key, stages, generator)
            self.captures[key] = 1
            self.replays[key] = 0
            return True
        if not self.capture:
            self.replays[key] += 1
            out = None
            for i, stage in enumerate(stages):
                out = stage(out)
                after(i)
            return False
        rec = self._captured[key]
        if generator is not rec.generator:
            raise ValueError(
                "a captured round draws from the generator it was captured "
                "with; pass that generator (the engine's own)")
        self.replays[key] += 1
        slots = self._slots()
        for i, graph in enumerate(rec.graphs):
            graph.replay()
            self._add(slots, rec.credits[i])
            after(i)
        return False

    def _capture(self, key: tuple, stages: Sequence[Stage],
                 generator: Optional[torch.Generator]) -> None:
        """Capture each stage into its own graph (the key's eager run just
        warmed them up).  Nothing runs on the card here: the counters'
        capture-time increments are taken back and kept as the credit."""
        t0 = time.perf_counter()
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(device=self.device)
        rec = _Captured(generator=generator)
        slots = self._slots()
        out = None
        # a dropped session's graphs and pinned buffers wait in reference
        # cycles for the cycle collector; torn down inside a capture they
        # would invalidate it, so collect them now and hold the collector
        # off until the capture ends
        gc.collect()
        # the key's eager run just freed its intermediates (a recurrent
        # verify's collected states: ~28 GB at xlstm-1.3b's width and B 8);
        # hand the cached blocks back so the graph pool can take them
        torch.cuda.empty_cache()
        collecting = gc.isenabled()
        gc.disable()
        try:
            for stage in stages:
                graph = torch.cuda.CUDAGraph()
                if generator is not None:
                    graph.register_generator_state(generator)
                before = self._read(slots)
                with torch.cuda.graph(graph, pool=self._pool,
                                      stream=self._stream):
                    out = stage(out)
                credit = [b - a for a, b in zip(before, self._read(slots))]
                self._add(slots, [-n for n in credit])
                rec.graphs.append(graph)
                rec.outputs.append(out)
                rec.credits.append(credit)
        finally:
            if collecting:
                gc.enable()
        self._captured[key] = rec
        self.capture_seconds[key] = time.perf_counter() - t0
