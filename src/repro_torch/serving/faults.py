"""Numerical sentinel, resilience knobs and deterministic fault injection of
the SD serving loop (port of ``repro.serving.faults``).

  * ``logits_finite`` — the per-row NUMERICAL SENTINEL the verify stage runs
    on its raw logits every round (core/spec_decode.py).
  * ``poison_cache_row`` / ``FaultInjector`` — a seeded, scripted injector
    the continuous scheduler consults at fixed hook points (page pressure,
    NaN KV, slow rounds, admission failure), so fault handling is tested
    with deterministic replays.
  * ``ResilienceConfig`` — the knobs of the degradation ladder consumed by
    ``serving/scheduler.ContinuousScheduler``.

``python -m repro_torch.serving.faults [--device cuda|cpu]`` is the smoke
lane: a seeded injector stream (page exhaustion, a NaN row, a slow round, an
admission failure) must finish with the expected finish reasons and no
leaked page, and the same stream run again on the warm engine must capture
no round graph (the fault paths are data, not new round keys).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.model import _PAGED_LEAF_PAIRS


def logits_finite(logits: torch.Tensor) -> torch.Tensor:
    """Per-row finite check on raw verify logits: (B, W, V) → (B,) bool.

    A row is healthy iff EVERY logit it produced this round is finite.  It
    must read the raw logits, not probabilities: the greedy
    ``probs_from_logits`` path is ``one_hot(argmax)``, and argmax over an
    all-NaN row still returns a valid index."""
    return torch.isfinite(logits).reshape(logits.shape[0], -1).all(-1)


def poison_cache_row(t_cache: dict, row: int) -> dict:
    """Set one row's target KV to NaN, in place, and return the cache.

    Fault-injection helper (never on the serving path): the next verify
    over that row then produces non-finite logits.  Dense leaves take the
    whole row; paged leaves take every physical page the row's block table
    maps (trash page 0 excluded), pages shared with a sibling included.
    The tensors are written where they are, because the session's round
    graphs read them there.  Co-batched rows are unaffected: attention is
    per row and MoE routing per token."""
    pages = t_cache.get("pages")
    pids = None
    if pages is not None:
        trow = pages["table"][row].cpu().numpy()
        ids = np.unique(trow[trow > 0])
        pids = torch.as_tensor(ids, dtype=torch.int64,
                               device=pages["table"].device)
    paged_keys = {k for k, _ in _PAGED_LEAF_PAIRS}
    for slot in t_cache["layers"]:
        for k, leaf in slot.items():
            if not leaf.is_floating_point():
                continue
            if k in paged_keys:
                if pids is not None and pids.numel():
                    leaf[pids] = float("nan")
            else:
                leaf[row] = float("nan")
    return t_cache


@dataclass
class ResilienceConfig:
    """Knobs of the continuous scheduler's degradation ladder.  The defaults
    change nothing about a healthy stream.

    ``round_deadline_s``
        Per-round wall-clock deadline; a slower round counts as faulty
        toward the ladder (it is not killed).
    ``max_rounds_per_request``
        Per-request round budget; past it the request finishes
        ``"timeout"``.
    ``free_page_watermark``
        Defer an admission that would leave the paged pool's free fraction
        below this, unless the pool is idle.
    ``max_pool_pages``
        Hard cap on page-pool growth; at the cap, page pressure preempts
        the youngest non-protected slot (recompute requeue).
    ``admit_retries`` / ``admit_backoff_rounds``
        Bounded retry for transient admission failures: attempt ``i``
        requeues ``backoff * 2**(i-1)`` rounds out; past the budget the
        request finishes ``"admit_failed"``.
    ``faulty_rounds_to_ar`` / ``faulty_rounds_to_stop``
        This many CONSECUTIVE faulty rounds (numerical fault, deadline
        overrun, acceptance collapse) force gamma=0 rounds; this many stop
        the stream safely (everything in flight finishes ``"aborted"``).
    ``collapse_alpha``
        An SD round whose acceptance falls below this counts as faulty
        (0 disables).
    ``stall_rounds``
        This many consecutive rounds with admissible work and no progress
        trigger the safe stop.
    """
    round_deadline_s: Optional[float] = None
    max_rounds_per_request: Optional[int] = None
    free_page_watermark: float = 0.0
    max_pool_pages: Optional[int] = None
    admit_retries: int = 3
    admit_backoff_rounds: int = 1
    faulty_rounds_to_ar: int = 2
    faulty_rounds_to_stop: int = 8
    collapse_alpha: float = 0.0
    stall_rounds: int = 512


@dataclass(frozen=True)
class Fault:
    """One scripted fault: ``kind`` fires at decode round ``round``.

    ``"nan_row"``
        NaN-poison the KV of pool row ``row`` (default: the first active
        row) before the round decodes; the sentinel quarantines it.
    ``"page_exhaustion"``
        Reserve ``pages`` free pages (default: all of them) from the
        ``PageAllocator`` for ``hold_rounds`` rounds: admissions see real
        page pressure (watermark deferral, preemption).
    ``"slow_round"``
        Sleep ``delay_s`` inside the round's wall-clock window: the round
        deadline sees an overrun.
    ``"admit_fail"``
        Every admission attempted this round fails transiently: the
        retry-with-backoff path requeues it.
    """
    round: int
    kind: str
    row: Optional[int] = None
    pages: Optional[int] = None
    hold_rounds: int = 1
    delay_s: float = 0.0

    KINDS = ("nan_row", "page_exhaustion", "slow_round", "admit_fail")

    def __post_init__(self):
        if self.kind not in self.KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"one of {self.KINDS}")


class FaultInjector:
    """Seeded, deterministic fault script for one continuous stream.

    The scheduler consults it at fixed hook points each round
    (``page_service`` → ``admission_fails`` → ``nan_rows`` →
    ``slow_delay``); faults fire exactly at their scripted round, so a fault
    stream replays exactly.  ``injected`` counts fires per kind.  Held
    pages carry state: build a fresh injector per stream."""

    def __init__(self, faults=(), *, seed: int = 0):
        self.faults: Tuple[Fault, ...] = tuple(
            sorted(faults, key=lambda f: (f.round, f.kind)))
        self.seed = seed
        self.injected: Dict[str, int] = {k: 0 for k in Fault.KINDS}
        self._held: List[Tuple[int, List[int]]] = []   # (release_round, pages)

    @classmethod
    def poisson(cls, rate: float, n_rounds: int, *, seed: int = 0,
                kinds: Tuple[str, ...] = ("nan_row", "page_exhaustion")
                ) -> "FaultInjector":
        """A script from a Bernoulli(rate)-per-round draw, derived once
        from the seed (the same draws as the reference)."""
        rng = np.random.default_rng(seed)
        faults = []
        for r in range(n_rounds):
            if rng.random() < rate:
                kind = str(rng.choice(kinds))
                faults.append(Fault(round=r, kind=kind, hold_rounds=2))
        return cls(faults, seed=seed)

    def _due(self, round_idx: int, kind: str) -> List[Fault]:
        return [f for f in self.faults
                if f.round == round_idx and f.kind == kind]

    # ------------------------------------------------------------- hooks
    def page_service(self, round_idx: int, alloc) -> None:
        """Round-start hook: release expired page holds, then reserve the
        holds scripted for this round from the allocator's free list."""
        still = []
        for release_at, pages in self._held:
            if round_idx >= release_at:
                alloc.release(pages)
            else:
                still.append((release_at, pages))
        self._held = still
        for f in self._due(round_idx, "page_exhaustion"):
            n = len(alloc.free) if f.pages is None \
                else min(f.pages, len(alloc.free))
            if n:
                self._held.append((round_idx + max(f.hold_rounds, 1),
                                   alloc.reserve(n)))
                self.injected["page_exhaustion"] += 1

    def release_all(self, alloc) -> None:
        """End-of-stream hook: return every held page, so the no-leak check
        holds unconditionally."""
        for _, pages in self._held:
            alloc.release(pages)
        self._held = []

    def admission_fails(self, round_idx: int) -> bool:
        """True iff admissions this round are scripted to fail."""
        due = self._due(round_idx, "admit_fail")
        if due:
            self.injected["admit_fail"] += len(due)
        return bool(due)

    def nan_rows(self, round_idx: int) -> List[Fault]:
        """The NaN-poison faults of this round (the scheduler resolves
        ``row=None`` to the first active row)."""
        due = self._due(round_idx, "nan_row")
        self.injected["nan_row"] += len(due)
        return due

    def slow_delay(self, round_idx: int) -> float:
        """Seconds of scripted stall inside this round (0.0 if healthy)."""
        total = sum(f.delay_s for f in self._due(round_idx, "slow_round"))
        if total:
            self.injected["slow_round"] += 1
        return total


# --------------------------------------------------------------------------
# smoke lane: a seeded fault stream, then the same stream with no capture
# --------------------------------------------------------------------------

def _smoke_injector() -> FaultInjector:
    return FaultInjector([
        Fault(round=2, kind="page_exhaustion", hold_rounds=3),
        Fault(round=6, kind="nan_row"),
        Fault(round=7, kind="slow_round", delay_s=0.03),
        Fault(round=1, kind="admit_fail"),
    ], seed=0)


def _smoke_engine(device: str, seed: int = 0):
    """The reduced qwen2-57b-a14b target (head dim 64, which the paged
    kernel takes) and the reduced qwen2-0.5b draft in fp32, pages of 8 and
    a pool capped at 16 pages.  The ladder's thresholds lie far above what
    the script reaches: an AR hand-off in the first run would give the two
    runs different round keys."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import ServingEngine
    t = Model(get_config("qwen2-57b-a14b", reduced=True), moe_dispatch="gmm",
              device=device)
    d = Model(get_config("qwen2-0.5b", reduced=True), device=device)
    gen = torch.Generator(device=t.device)
    pt = t.init(gen.manual_seed(seed))
    pd = d.init(gen.manual_seed(seed + 1))
    return ServingEngine(
        t, d, pt, pd, max_batch=3, gamma=2, force_sd=True,
        scheduler="continuous", kv_layout="paged", page_size=8,
        resilience=ResilienceConfig(round_deadline_s=0.02,
                                    max_pool_pages=16,
                                    faulty_rounds_to_ar=64,
                                    faulty_rounds_to_stop=128))


def _smoke_submit(eng) -> None:
    # budgets long enough that slots are still live when the round-6 NaN
    # and round-7 slow faults fire, even if every draft is accepted
    eng.submit(np.arange(3, 9), max_new_tokens=24)
    eng.submit(np.arange(4, 10), max_new_tokens=16, arrival_round=0)
    eng.submit(np.arange(5, 11), max_new_tokens=16, arrival_round=1)
    eng.submit(np.arange(6, 12), max_new_tokens=12, arrival_round=4)


def _smoke_stream(eng):
    eng.fault_injector = _smoke_injector()
    _smoke_submit(eng)
    reports = eng.run()
    reasons = sorted(r.finish_reason for r in eng.done.values())
    assert "numerical_fault" in reasons, reasons
    assert all(rr in ("length", "eos", "numerical_fault")
               for rr in reasons), reasons
    inj = eng.fault_injector
    assert inj.injected["page_exhaustion"] >= 1, inj.injected
    assert inj.injected["slow_round"] >= 1, inj.injected
    assert inj.injected["admit_fail"] >= 1, inj.injected
    for name in ("slow_rounds", "preemptions", "requeues", "admit_retries"):
        assert eng.fault_counters.get(name, 0) >= 1, eng.fault_counters
    eng._slot_scheduler._alloc.assert_no_leaks()
    eng.done.clear()
    return reports


def main(argv=None) -> int:
    """The scripted stream finishes with the expected finish reasons and no
    leaked page, and the same stream again on the warm engine captures no
    round graph (on the CPU: runs no round key for the first time)."""
    import argparse
    ap = argparse.ArgumentParser(description=main.__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    eng = _smoke_engine(args.device)
    _smoke_stream(eng)                       # first run: captures every key
    graphs = eng._sessions["model"].graphs
    caps = dict(graphs.captures)
    replays = graphs.total_replays
    _smoke_stream(eng)
    if dict(graphs.captures) != caps:
        raise SystemExit(
            f"fault smoke: the replay stream captured "
            f"{graphs.total_captures - sum(caps.values())} round keys; "
            "fault handling must be data, not new round keys")
    if graphs.total_replays <= replays:
        raise SystemExit("fault smoke: the replay stream replayed no round")
    print(f"fault smoke ({args.device}): OK (expected finish reasons, no "
          f"leaked page, the replay stream captured nothing: "
          f"{sum(caps.values())} captures, "
          f"{graphs.total_replays - replays} replays)")
    print(f"fault smoke counters: {dict(eng.fault_counters)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
