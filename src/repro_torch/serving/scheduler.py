"""Continuous-batching slot scheduler: round-level SD with in-flight admission.

Port of ``repro.serving.scheduler``.  The paper's claim is that SD speedup
for a sparse MoE is a function of the LIVE batch size N(t); this scheduler
operates it rather than measuring it:

  * a fixed pool of ``max_batch`` KV-cache slots is decoded round by round
    through the session API (``SDEngine.start``/``round``/``admit_rows``),
  * a slot RETIRES the moment its request finishes (per-slot
    ``max_new_tokens``, optional ``eos_id``); its row goes inactive through
    the round's ``active`` mask,
  * freed slots are REFILLED between rounds: queued requests, visible from
    their ``arrival_round`` on, prefill into the retired rows through a
    row-sliced admission (``admit_mode="sliced"``) or a full-pool one
    (``"full"``, dense only),
  * with ``kv_layout="paged"`` the target cache is block-table paged: a
    late long request GROWS the session (``_make_room``/``_grow``), and
    under a ``max_pool_pages`` cap page pressure PREEMPTS the youngest
    slot (recompute requeue); dense streams REJECT a request they were not
    sized for and keep serving,
  * resilience: the numerical sentinel quarantines non-finite rows,
    per-request round budgets, the free-page watermark, the faulty-round
    ladder (forced AR, then a safe stop) and the stall watchdog.

With a tuner (``engine.tuner``) every round re-plans {use_sd, gamma} on
the live slot count, ``plan(live)``; a round planned without SD runs with
gamma 0 in the same session (the SD→AR hand-off), the stream's caches are
sized for the largest gamma the tuner can plan, and the round's acceptance
rate, read back with its results, goes to ``update_alpha``.  Each gamma is
its own round key, captured on its first round.

  * long prompts optionally prefill in CHUNKS (``prefill_chunk``), one
    chunk per round boundary (``SDEngine.admit_chunk``), so one long
    admission does not stall the round it lands in,
  * with ``prefix_sharing=True`` (paged only) an admission whose prompt
    shares at least a page of prefix with a LIVE slot's prompt forks that
    slot's prefix pages (refcounted, the boundary page copied on write:
    ``PageAllocator.fork_prefix``/``cow_range``, ``copy_cache_pages``) and
    target-prefills only its tail (``SDEngine.admit_rows_prefix``);
    same-round siblings are staggered one round so the first becomes the
    leader,
  * a ``FaultInjector`` (``serving/faults.py``) scripts page exhaustion,
    NaN rows, slow rounds and admission failures at fixed rounds.

Every write these make into the session (table forks, copy-on-write page
copies, NaN poison, the final scatter of a chunked admission) goes into
the session's tensors in place before the next round, because the round
graphs read them there.

The engine's generator replaces the reference's key splits: each admission
and round draws from it in turn.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.spec_decode import (PendingAdmission, SDStats,
                                          SessionState)
from repro_torch.data.tokenizer import PAD
from repro_torch.device import host_crossing
from repro_torch.models.attention import SWA_RING_PAD
from repro_torch.models.model import (PageAllocator, copy_cache_pages,
                                      grow_cache_seq)
from repro_torch.serving.faults import poison_cache_row
from repro_torch.serving.engine import WaveReport, _pow2_at_least

if TYPE_CHECKING:                                    # avoid runtime cycle
    from repro_torch.serving.engine import Request, ServingEngine


def submit_poisson(engine: "ServingEngine", prompts, lengths, *,
                   rate: float, max_new_choices=(8, 16, 32),
                   seed: int = 0) -> List[int]:
    """Submit a Poisson-arrival, mixed-length workload to an engine.

    The unit of time is the decode ROUND: request i arrives at
    ``cumsum(Exp(1/rate))`` rounds (``rate`` = mean arrivals per round;
    ``rate <= 0`` submits everything at round 0) with a ``max_new_tokens``
    drawn uniformly from ``max_new_choices``, from a numpy generator seeded
    with ``seed`` (the same draws as the reference).  Returns the uids in
    arrival order."""
    rate = float(rate)
    if not np.isfinite(rate) or rate < 0:
        raise ValueError(
            f"arrival rate must be a finite value >= 0, got {rate!r} "
            "(rate=0 submits the whole workload at round 0; a positive "
            "rate is mean arrivals per decode round)")
    if len(lengths) == 0:
        raise ValueError("submit_poisson: empty workload (no lengths)")
    if len(prompts) < len(lengths):
        raise ValueError(
            f"submit_poisson: {len(prompts)} prompts for {len(lengths)} "
            "lengths — every length needs a prompt row")
    if not max_new_choices:
        raise ValueError("submit_poisson: max_new_choices must be "
                         "non-empty")
    for i in range(len(lengths)):
        if int(lengths[i]) < 1:
            raise ValueError(
                f"submit_poisson: prompt {i} is empty (length "
                f"{int(lengths[i])}); prefill needs >= 1 token — drop it "
                "from the workload instead")
    rng = np.random.default_rng(seed)
    t, uids = 0.0, []
    for i in range(len(lengths)):
        if rate > 0:
            t += rng.exponential(1.0 / rate)
        uids.append(engine.submit(
            np.asarray(prompts[i][: int(lengths[i])]),
            max_new_tokens=int(rng.choice(max_new_choices)),
            arrival_round=int(t)))
    return uids


@dataclass
class SlotState:
    """One KV-cache row of the continuous pool.  ``active`` rows advance in
    SD rounds; inactive rows are padding awaiting admission.  ``tokens``
    holds the request's generated ids (the admission prefill's sample
    first); ``admit_seq`` is the stream-global admission number that
    preemption picks its victim by (youngest first, oldest protected)."""
    index: int
    request: Optional["Request"] = None
    active: bool = False
    n_out: int = 0
    tokens: List[int] = field(default_factory=list)
    admit_seq: int = -1


@dataclass
class StepReport:
    """One SD round of a continuous stream.

    ``live`` is the active-slot count the round decoded (N(t)),
    ``committed`` the tokens credited to requests this round,
    ``admitted``/``retired`` the slot churn at this round's boundary, and
    ``admit_rows``/``admit_tokens`` the rows and row-tokens the boundary's
    admission prefills processed.  Resilience fields (zero on a healthy
    round): slots ``preempted`` for page pressure, rows quarantined by the
    numerical sentinel (``faults``), requests over their round budget
    (``timeouts``), admissions ``deferred`` by backpressure, a transient
    admission failure or a prefix-sharing stagger.  ``shared_tokens``
    counts the prompt tokens this boundary's admissions did not prefill
    because prefix sharing mapped them to a sibling's pages, and
    ``chunk_steps`` the chunks of chunked admissions advanced at it (their
    rows and tokens are in ``admit_rows``/``admit_tokens``)."""
    round_index: int
    live: int
    gamma: int
    used_sd: bool
    committed: int
    admitted: int
    retired: int
    round_time: float
    admit_rows: int = 0
    admit_tokens: int = 0
    preempted: int = 0
    faults: int = 0
    timeouts: int = 0
    deferred: int = 0
    shared_tokens: int = 0
    chunk_steps: int = 0


@dataclass
class _Chunking:
    """A slot reserved by an in-flight chunked admission."""
    slot: SlotState
    request: "Request"
    pa: PendingAdmission


class ContinuousScheduler:
    """Round-level slot scheduler over one persistent decoding session.

    Owns the slot pool, the round loop and the admission policy (sliced or
    full, paged growth, preemption); the engine supplies sessions, the
    generator, layout knobs and the request queue.  ``run_stream()`` drains
    the queue and returns one aggregated ``WaveReport`` with per-round
    ``StepReport``s in ``.steps``.
    """

    def __init__(self, engine: "ServingEngine", *,
                 slots: Optional[int] = None):
        self.engine = engine
        self.pool = slots if slots is not None else engine.max_batch
        self._alloc: Optional[PageAllocator] = None
        self._admit_seq = 0                  # stream-global admission order
        self._hiwater: dict = {}             # uid -> max tokens ever committed
        self._consec_faulty = 0
        self._consec_stall = 0
        self._forced_ar = False

    # ------------------------------------------------------------- admission
    def _pop_admissible(self, round_idx: int) -> Optional["Request"]:
        """Pop the first queued request visible at this round, scanning past
        deferred ones.  With ``admission_order="pressure"`` and a free page
        fraction below half, the smallest-footprint admissible request goes
        first instead."""
        q = self.engine.queue
        pressured = (self.engine.admission_order == "pressure"
                     and self._alloc is not None
                     and self._alloc.free_fraction() < 0.5)
        best = None                           # (pages, queue index)
        for i, r in enumerate(q):
            if r.arrival_round <= round_idx:
                if not pressured:
                    del q[i]
                    return r
                key = (self._alloc.pages_for(self._need(r)), i)
                if best is None or key < best:
                    best = key
        if best is None:
            return None
        r = q[best[1]]
        del q[best[1]]
        return r

    def _has_admissible(self, round_idx: int) -> bool:
        return any(r.arrival_round <= round_idx for r in self.engine.queue)

    def _need(self, r: "Request") -> int:
        """Cache positions request ``r`` can touch over its lifetime (a
        re-admission's resumed tokens count against the same budget)."""
        return len(r.prompt) + r.max_new_tokens + self._g_max + 2

    def _admit_toks(self, r: "Request") -> np.ndarray:
        """What a (re-)admission prefills: the prompt, plus after a
        preemption the already-committed tokens (recompute prefill)."""
        if r.resume_tokens:
            return np.concatenate([np.asarray(r.prompt, np.int32),
                                   np.asarray(r.resume_tokens, np.int32)])
        return np.asarray(r.prompt, np.int32)

    def _count(self, name: str, n: int = 1) -> None:
        c = self.engine.fault_counters
        c[name] = c.get(name, 0) + n

    # -------------------------------------------------------- prefix sharing
    @staticmethod
    def _common_prefix(a, b) -> int:
        n = min(len(a), len(b))
        if n == 0:
            return 0
        neq = np.nonzero(np.asarray(a[:n]) != np.asarray(b[:n]))[0]
        return int(neq[0]) if neq.size else n

    def _find_leader(self, slots: List[SlotState], r: "Request"
                     ) -> Tuple[Optional[SlotState], int]:
        """The ACTIVE slot whose prompt shares the longest common prefix
        with ``r``'s, or (None, 0).  The share is capped at
        ``len(r.prompt) - 1`` (the tail keeps a token, whose logit samples
        the first output) and must reach a whole page, or nothing is
        shared."""
        best, best_len = None, 0
        for s in slots:
            if not s.active or s.request is None:
                continue
            share = min(self._common_prefix(s.request.prompt, r.prompt),
                        len(r.prompt) - 1)
            if share > best_len:
                best, best_len = s, share
        if best_len < self.engine.page_size:
            return None, 0
        return best, best_len

    def _should_stagger(self, r: "Request", batch_in, prefix_in, landed,
                        chunking) -> bool:
        """True when no ACTIVE leader exists but a sibling admitted at this
        boundary shares at least a page of prompt prefix with ``r``: one
        round later ``r`` forks the sibling's pages instead of prefilling
        the prefix twice.  Each uid staggers at most once."""
        if r.uid in self._staggered:
            return False
        ps = self.engine.page_size
        siblings = [q for _, q in batch_in] \
            + [q for _, q, _ in prefix_in] \
            + [q for _, q in landed] \
            + [c.request for c in chunking]
        return any(min(self._common_prefix(q.prompt, r.prompt),
                       len(r.prompt) - 1) >= ps for q in siblings)

    def _bucket(self, n: int) -> int:
        return _pow2_at_least(n) if self.engine.bucket_batches else n

    def _swa_capacity_floor(self) -> int:
        """The least paged logical capacity at which every SWA ring of the
        target and the draft has its full width (window + pad) from round
        0: a growth cannot resize a live ring (``pos % w`` would remap its
        entries), so a paged session never starts below it."""
        floor = 0
        for m in (self.engine.target, self.engine.draft):
            cfg = getattr(m, "cfg", None)
            if cfg is not None and "swa" in cfg.layer_pattern:
                floor = max(floor, cfg.sliding_window + SWA_RING_PAD)
        return floor

    @host_crossing()
    def _open_session(self, sess, max_seq: int) -> SessionState:
        """Open the pool with 1-token fillers; every real request enters
        through the admission path."""
        eng = self.engine
        B = self.pool
        toks = np.full((B, 1), PAD, np.int32)
        cache_opts, table = None, None
        if self._alloc is not None:
            cache_opts = {"paged": True, "page_size": eng.page_size,
                          "pool_pages": self._alloc.pool_pages}
            table = self._alloc.table
        params_d = None if eng.proposer_kind == "none" else eng.params_d
        return sess.start(eng.params_t, params_d, toks, max_seq=max_seq,
                          lengths=np.ones((B,), np.int32),
                          generator=eng._next_generator(),
                          cache_opts=cache_opts, page_table=table)

    @host_crossing()
    def _sync_table(self, state: SessionState) -> SessionState:
        """Push the allocator's host table into the session's table in
        place (a copy: the allocator keeps mutating its array; in place:
        the session's round graphs read that tensor).  A growth has already
        given the session a table of the allocator's new shape."""
        rows = self.engine.target.row_block(state.t_cache)
        state.t_cache["pages"]["table"].copy_(
            torch.from_numpy(self._alloc.table[rows or slice(None)]))
        return state

    def _grow(self, sess, state: SessionState, pool_pages: int,
              max_pages: int) -> SessionState:
        """Adopt a grown paged geometry: pad the session's pool and logical
        capacity, mirror it in the allocator, and pad the compact caches of
        in-flight chunked admissions so their final scatter still matches
        the grown session."""
        alloc = self._alloc
        new_cap = max_pages * alloc.page_size
        state = sess.grow_session(state, new_cap, pool_pages=pool_pages,
                                  max_pages=max_pages)
        alloc.grow(pool_pages, max_pages)
        for c in self._chunking:
            if c.pa.t_cache is not None:
                c.pa.t_cache = grow_cache_seq(c.pa.t_cache,
                                              self.engine.target.cfg, new_cap)
        return self._sync_table(state)

    def _headroom_ok(self, need_pages: int, live: int) -> bool:
        """Watermark backpressure: would admitting ``need_pages`` leave the
        free fraction above the watermark?  Always true on an idle pool."""
        wm = self.engine.resilience.free_page_watermark
        if wm <= 0 or live == 0:
            return True
        alloc = self._alloc
        left = len(alloc.free) - need_pages
        return left / max(alloc.pool_pages - 1, 1) >= wm

    def _preempt_victim(self, slots: List[SlotState],
                        incoming: "Request") -> Optional[SlotState]:
        """The youngest active slot, never the oldest one, and none when the
        incoming request was itself preempted."""
        if incoming.preempt_count > 0:
            return None
        cands = [s for s in slots if s.active and s.request is not None]
        if len(cands) < 2:
            return None
        cands.sort(key=lambda s: s.admit_seq)
        return cands[-1]

    def _preempt(self, slot: SlotState, round_idx: int) -> None:
        """Evict one active slot under page pressure: its pages return to
        the pool and the request requeues with its committed tokens, which
        its re-admission recompute-prefills."""
        r = slot.request
        r.resume_tokens = list(slot.tokens)
        r.preempt_count += 1
        r.requeue_round = round_idx
        r.arrival_round = round_idx + 1      # not re-admissible this round
        self._hiwater[r.uid] = max(self._hiwater.get(r.uid, 0),
                                   len(slot.tokens))
        slot.request = None
        slot.active = False
        slot.tokens = []
        self._alloc.free_row(slot.index)     # table row -> trash page 0
        self._table_dirty = True
        self.engine.queue.append(r)
        self._count("preemptions")
        self._round_preempted += 1

    def _make_room(self, sess, state: SessionState, r: "Request",
                   round_idx: int, live: int, slots: List[SlotState],
                   fresh_pages: Optional[int] = None
                   ) -> Tuple[SessionState, str]:
        """Make the paged pool able to admit ``r``: ``"ok"`` (caller
        allocs), ``"defer"`` (transient pressure) or ``"impossible"`` (it
        cannot fit a drained pool at ``max_pool_pages``).  Under pressure:
        grow (pow2) while the cap allows, then preempt, then defer.
        ``fresh_pages`` (a prefix-shared admission) is what the admission
        draws from the free list: its private tail and the copy-on-write
        boundary page; the logical capacity is still checked against the
        full footprint."""
        alloc = self._alloc
        cap = self.engine.resilience.max_pool_pages
        need = self._need(r)
        need_pages = alloc.pages_for(need)
        fresh = need_pages if fresh_pages is None else fresh_pages
        if cap is not None and need_pages > cap - 1:
            return state, "impossible"
        while True:
            if (need > state.max_seq or need_pages > alloc.max_pages
                    or fresh > len(alloc.free)):
                pool_pages, max_pages = alloc.grown_geometry(need)
                if cap is not None and pool_pages > cap:
                    victim = self._preempt_victim(slots, r)
                    if victim is None:
                        return state, "defer"
                    self._preempt(victim, round_idx)
                    continue
                state = self._grow(sess, state, pool_pages, max_pages)
                continue
            if not self._headroom_ok(fresh, live):
                pool_pages = alloc.pool_pages * 2
                if cap is not None and pool_pages > cap:
                    return state, "defer"    # watermark backpressure
                state = self._grow(sess, state, pool_pages, alloc.max_pages)
                continue
            return state, "ok"

    def _finish_request(self, r: "Request", reason: str) -> None:
        """Finish a request that holds no slot (rejected, admit_failed, or
        aborted from the queue), keeping a preempted one's committed
        tokens as partial output."""
        if r.finish_reason is not None:
            raise RuntimeError(
                f"request {r.uid} already finished "
                f"{r.finish_reason!r}; refusing to overwrite with "
                f"{reason!r} — every request finishes exactly once")
        r.output = np.asarray(list(r.resume_tokens or []), np.int32)
        r.finish_reason = reason
        r.finished_at = time.perf_counter()
        self.engine.done[r.uid] = r
        self._finished.append(r)

    def _admit_batch(self, sess, state: SessionState,
                     batch_in: List[Tuple[SlotState, "Request"]]
                     ) -> Tuple[SessionState, int, int]:
        """One admission prefill for this round's refills: sliced (only the
        admitted rows, pow2 row bucket with replicated pad lanes, prompt
        bucket from this batch alone) or full (the whole pool, fillers
        discarded by the mask).  Returns (state, rows, row-tokens)."""
        eng = self.engine
        seqs = [self._admit_toks(r) for _, r in batch_in]
        Tp = self._bucket(max(len(t) for t in seqs))
        gen = eng._next_generator()
        if eng.admit_mode == "full":
            B = self.pool
            toks = np.full((B, Tp), PAD, np.int32)
            lengths = np.ones((B,), np.int32)
            mask = np.zeros((B,), bool)
            for (s, _), t in zip(batch_in, seqs):
                toks[s.index, : len(t)] = t
                lengths[s.index] = len(t)
                mask[s.index] = True
            state = sess.admit(state, toks, lengths, mask, generator=gen)
            return state, B, B * Tp
        R = min(self._bucket(len(batch_in)), self.pool)
        toks = np.full((R, Tp), PAD, np.int32)
        lengths = np.ones((R,), np.int32)
        rows = np.zeros((R,), np.int32)
        valid = np.zeros((R,), bool)
        for i in range(R):
            s, _ = batch_in[i % len(batch_in)]     # pad lanes replicate
            t = seqs[i % len(batch_in)]
            toks[i, : len(t)] = t
            lengths[i] = len(t)
            rows[i] = s.index
            valid[i] = i < len(batch_in)
        state = sess.admit_rows(state, toks, lengths, rows, valid=valid,
                                generator=gen)
        return state, R, R * Tp

    def _admit_batch_prefix(self, sess, state: SessionState,
                            batch_in: List[Tuple[SlotState, "Request", int]]
                            ) -> Tuple[SessionState, int, int]:
        """One TAIL-ONLY admission prefill for this round's prefix-shared
        refills (``SDEngine.admit_rows_prefix``): the allocator already
        forked each row's table onto its leader's prefix pages and the
        boundary page was copied, so the target extends only
        ``prompt[share:]`` at offset ``share``; the proposer prefills the
        full prompt.  Pad lanes replicate real rows (identical writes to
        the same pages) and are dropped.  Returns (state, rows, row-tokens)
        of the TARGET's tail work."""
        tails = [np.asarray(r.prompt[sl:], np.int32) for _, r, sl in batch_in]
        proms = [np.asarray(r.prompt, np.int32) for _, r, _ in batch_in]
        Tt = self._bucket(max(len(t) for t in tails))
        Tp = self._bucket(max(len(p) for p in proms))
        R = min(self._bucket(len(batch_in)), self.pool)
        tail_toks = np.full((R, Tt), PAD, np.int32)
        prom_toks = np.full((R, Tp), PAD, np.int32)
        tail_start = np.zeros((R,), np.int32)
        tail_len = np.ones((R,), np.int32)
        lengths = np.ones((R,), np.int32)
        rows = np.zeros((R,), np.int32)
        valid = np.zeros((R,), bool)
        for i in range(R):
            s, r, sl = batch_in[i % len(batch_in)]
            t, p = tails[i % len(batch_in)], proms[i % len(batch_in)]
            tail_toks[i, : len(t)] = t
            prom_toks[i, : len(p)] = p
            tail_start[i], tail_len[i], lengths[i] = sl, len(t), len(p)
            rows[i] = s.index
            valid[i] = i < len(batch_in)
        state = sess.admit_rows_prefix(state, tail_toks, tail_start, tail_len,
                                       prom_toks, lengths, rows, valid=valid,
                                       generator=self.engine._next_generator())
        return state, R, R * Tt

    # ------------------------------------------------------------ completion
    def _append(self, slot: SlotState, tokens: List[int]) -> int:
        """Credit round tokens to a slot and retire it on budget or eos;
        returns the tokens credited (overshoot past either is dropped)."""
        r = slot.request
        eos = self.engine.eos_id
        credited = 0
        for t in tokens:
            if slot.n_out >= r.max_new_tokens:
                break
            slot.tokens.append(int(t))
            slot.n_out += 1
            credited += 1
            if eos is not None and int(t) == eos:
                self._finish(slot, "eos")
                return credited
        if slot.n_out >= r.max_new_tokens:
            self._finish(slot, "length")
        return credited

    def _finish(self, slot: SlotState, reason: str) -> None:
        r = slot.request
        if r.finish_reason is not None:
            raise RuntimeError(
                f"request {r.uid} already finished {r.finish_reason!r}; "
                f"refusing to overwrite with {reason!r} — every request "
                "finishes exactly once")
        if len(slot.tokens) < self._hiwater.get(r.uid, 0):
            raise RuntimeError(
                f"request {r.uid} finishing with {len(slot.tokens)} "
                f"tokens < high-water {self._hiwater[r.uid]} — committed "
                "tokens went BACKWARD across a requeue")
        r.output = np.asarray(slot.tokens, np.int32)
        r.finish_reason = reason
        r.finished_at = time.perf_counter()
        self.engine.done[r.uid] = r
        self._finished.append(r)
        slot.request = None
        slot.active = False
        slot.tokens = []
        self._retired_rows.append(slot.index)

    # ------------------------------------------------------------------ loop
    def _size_stream(self, pending) -> int:
        """The stream's initial capacity (and, paged, its allocator).

        Paged: sized on what is visible at round 0; later arrivals grow the
        session.  Dense: sized once for the longest known request; a later
        over-long submit is rejected, never fatal."""
        eng = self.engine
        if eng.kv_layout == "paged":
            ps = eng.page_size
            visible = [r for r in pending if r.arrival_round <= 0] \
                or pending[:1]
            cap = max(self._bucket(max(self._need(r) for r in visible)),
                      self._swa_capacity_floor())
            max_seq = -(-cap // ps) * ps
            pool_pages = 1 + sum(-(-self._need(r) // ps)
                                 for r in visible[: self.pool])
            self._alloc = PageAllocator(self.pool, ps,
                                        _pow2_at_least(pool_pages),
                                        max_seq // ps)
            return max_seq
        self._alloc = None
        max_seq = self._bucket(max(len(r.prompt) for r in pending)) \
            + max(r.max_new_tokens for r in pending) + self._g_max + 2
        return _pow2_at_least(max_seq) if eng.bucket_batches else max_seq

    def _advance_chunks(self, sess, state: SessionState):
        """Advance every in-flight chunked admission by one chunk.  Returns
        (state, landed, rows, row-tokens, chunk steps)."""
        landed: List[Tuple[SlotState, "Request"]] = []
        rows_n = toks_n = 0
        steps = len(self._chunking)
        for c in list(self._chunking):
            R, C = c.pa.prompts.shape[0], c.pa.chunk
            rows_n += R
            toks_n += R * min(C, c.pa.remaining)
            state, pa = sess.admit_chunk(state, c.pa)
            if pa is None:
                self._chunking.remove(c)
                landed.append((c.slot, c.request))
            else:
                c.pa = pa
        return state, landed, rows_n, toks_n, steps

    @host_crossing()
    def _admit_boundary(self, sess, state: SessionState, slots, round_idx,
                        max_seq: int):
        """Retire/refill at one round boundary.

        First every in-flight chunked admission advances one chunk.  Then
        every admissible request takes a free slot (or, when the injector
        fails this round's admissions, is retried with backoff): rejected
        (dense) or made room for (paged) where the stream was not sized
        for it; with prefix sharing, forked onto a live leader's prefix
        pages, or staggered a round behind a same-boundary sibling; a
        prompt longer than ``prefill_chunk`` opens a chunked admission.
        One table upload, one bucketed copy of the copy-on-write pages, one
        tail admission and one sliced admission follow.  Returns (state,
        landed, deferred, admit rows, admit row-tokens, shared tokens,
        chunk steps)."""
        eng = self.engine
        paged = self._alloc is not None
        prefix_ok = paged and eng.prefix_sharing
        inj = eng.fault_injector
        state, landed, rows_n, toks_n, chunk_steps = \
            self._advance_chunks(sess, state)
        batch_in: List[Tuple[SlotState, "Request"]] = []
        prefix_in: List[Tuple[SlotState, "Request", int]] = []
        cow_pairs: List[Tuple[int, int]] = []
        # slots of in-flight and just-landed chunked admissions are taken
        claimed = {c.slot.index for c in self._chunking} \
            | {s.index for s, _ in landed}
        deferred = shared = 0
        live_now = sum(1 for s in slots if s.active)
        # a scripted transient admission failure retries everything
        # admissible this round with backoff, and admits nothing
        failing = inj is not None and inj.admission_fails(round_idx)
        if failing:
            deferred += self._defer_admissible(round_idx)
        while not failing:
            free = [s for s in slots
                    if not s.active and s.index not in claimed]
            if not free:
                break
            r = self._pop_admissible(round_idx)
            if r is None:
                break
            if not paged and self._need(r) > max_seq:
                self._finish_request(r, "rejected")
                continue
            # prefix sharing: fork a live sibling's prompt pages.  A
            # re-admission never shares (its resumed stream diverges), and
            # a tail longer than the prefill chunk takes the chunked path
            leader, share_len = None, 0
            if prefix_ok and not r.resume_tokens:
                leader, share_len = self._find_leader(slots, r)
                if (leader is not None and eng.prefill_chunk
                        and len(r.prompt) - share_len > eng.prefill_chunk):
                    leader, share_len = None, 0
                if leader is None and self._should_stagger(
                        r, batch_in, prefix_in, landed, self._chunking):
                    r.arrival_round = round_idx + 1
                    eng.queue.append(r)
                    self._staggered.add(r.uid)
                    deferred += 1
                    self._count("prefix_staggered")
                    continue
            if paged:
                while True:
                    fresh = None
                    if leader is not None:
                        # private tail pages + the copy-on-write boundary
                        # page; the fork itself draws nothing
                        fresh = (self._alloc.pages_for(self._need(r))
                                 - share_len // self._alloc.page_size)
                    state, verdict = self._make_room(
                        sess, state, r, round_idx, live_now, slots,
                        fresh_pages=fresh)
                    if leader is not None and not leader.active:
                        # _make_room preempted the leader: its pages are
                        # gone, so re-budget unshared
                        leader, share_len = None, 0
                        continue
                    break
                if verdict == "impossible":
                    self._finish_request(r, "rejected")
                    continue
                if verdict == "defer":
                    # backpressure applies to the whole boundary
                    r.arrival_round = round_idx + 1
                    eng.queue.append(r)
                    deferred += 1
                    self._count("admit_deferred")
                    break
                # a preemption inside _make_room may have freed a slot
                free = [s for s in slots
                        if not s.active and s.index not in claimed]
                row = free[0].index
                if leader is not None:
                    self._alloc.fork_prefix(leader.index, row, share_len)
                    self._alloc.extend_row(row, self._need(r))
                    pairs = self._alloc.cow_range(row, share_len,
                                                  self._need(r))
                    cow_pairs.extend(pairs)
                    shared += share_len
                    self._count("prefix_hits")
                    self._count("prefix_shared_tokens", share_len)
                    self._count("cow_copies", len(pairs))
                else:
                    self._alloc.alloc(row, self._need(r))
                self._table_dirty = True
            s = free[0]
            claimed.add(s.index)
            s.admit_seq = self._admit_seq
            self._admit_seq += 1
            if leader is not None:
                prefix_in.append((s, r, share_len))
                continue
            toks = self._admit_toks(r)
            if eng.prefill_chunk and len(toks) > eng.prefill_chunk:
                self._chunking.append(_Chunking(s, r, sess.begin_admit_chunked(
                    toks[None, :], np.array([len(toks)], np.int32),
                    np.array([s.index], np.int32), chunk=eng.prefill_chunk,
                    generator=eng._next_generator())))
                continue
            batch_in.append((s, r))
        if self._table_dirty:
            # one table upload covers every page assignment, fork and
            # preemption of this boundary, before the copies and admissions
            # write through it and before the next round: a freed victim's
            # row must point at trash page 0, or its frozen lane would
            # write into pages the pool has re-issued
            state = self._sync_table(state)
        if cow_pairs:
            # one bucketed copy detaches every copy-on-write page of this
            # boundary; (0, 0) trash self-copies pad it to a power of two
            n = _pow2_at_least(len(cow_pairs)) if eng.bucket_batches \
                else len(cow_pairs)
            copy_cache_pages(state.t_cache,
                             cow_pairs + [(0, 0)] * (n - len(cow_pairs)))
        if prefix_in:
            state, rn, tn = self._admit_batch_prefix(sess, state, prefix_in)
            rows_n += rn
            toks_n += tn
            landed.extend((s, r) for s, r, _ in prefix_in)
        if batch_in:
            state, rn, tn = self._admit_batch(sess, state, batch_in)
            rows_n += rn
            toks_n += tn
            landed.extend(batch_in)
        return state, landed, deferred, rows_n, toks_n, shared, chunk_steps

    def run_stream(self) -> Optional[WaveReport]:
        """Serve the queued stream to completion; one aggregated report.

        Per round: (1) the injector's page holds, then advance chunked
        admissions and retire/refill (``_admit_boundary``); (2) plan gamma
        on the live slot count (``tuner.plan(live)`` when a tuner is set),
        with the SD→AR handoff as a gamma=0 round in the same session;
        (3) the injector's NaN rows and slow delay, then one SD round with
        the active mask; (4) credit tokens per slot,
        quarantine non-finite rows, apply round budgets, free retired
        rows' pages; (5) the degradation ladder and the stall watchdog.
        Returns ``None`` on an empty queue."""
        eng = self.engine
        if not eng.queue:
            return None
        kind = eng.proposer_kind
        sess = eng._session(kind)
        pending = list(eng.queue)
        # the cache must hold every plannable gamma's verify overshoot
        g_cands = [eng.gamma]
        if eng.tuner is not None:
            g_cands += [int(g) for g in getattr(eng.tuner, "gammas", ())]
        self._g_max = g_max = max(g_cands)
        max_seq = self._size_stream(pending)

        slots = [SlotState(i) for i in range(self.pool)]
        state = self._open_session(sess, max_seq)
        stats = SDStats()
        steps: List[StepReport] = []
        self._finished: List["Request"] = []
        self._retired_rows: List[int] = []
        self._chunking: List[_Chunking] = []
        self._staggered = set()              # uids prefix-staggered once
        rescfg = eng.resilience
        inj = eng.fault_injector
        self._consec_faulty = 0              # ladder state is per-stream
        self._consec_stall = 0
        self._forced_ar = False
        used_sd_any = False
        aborted = False
        first_gamma: Optional[int] = None
        round_idx = 0
        t_start = time.perf_counter()
        while True:
            admit_credited, n_retired = 0, 0
            faults_n, timeouts_n = 0, 0
            self._round_preempted = 0
            self._table_dirty = False
            had_admissible = self._has_admissible(round_idx)
            if inj is not None and self._alloc is not None:
                # scripted page holds: release expired, apply due ones
                inj.page_service(round_idx, self._alloc)
            (state, landed, deferred_n, admit_rows_n, admit_tokens,
             shared_n, chunk_n) = self._admit_boundary(
                sess, state, slots, round_idx, max_seq)
            if landed:
                with host_crossing():
                    first = state.last_token.cpu().numpy()
                for s, r in landed:
                    s.request, s.active = r, True
                    resume = list(r.resume_tokens or [])
                    # a re-admission resumes the committed stream: its
                    # recompute prefill already holds these tokens' KV
                    s.n_out, s.tokens = len(resume), resume
                    if resume:
                        r.readmit_round = round_idx
                        r.resume_tokens = None
                        self._count("requeues")
                    # the admission prefill's sample is the first token
                    admit_credited += self._append(s, [int(first[s.index])])
            n_retired = sum(1 for s, r in landed if not s.active)

            active_mask = np.array([s.active for s in slots], bool)
            live = int(active_mask.sum())
            if live == 0:
                if landed or admit_rows_n:
                    # every admitted slot finished on its prefill token:
                    # record the churn so steps never undercount
                    steps.append(StepReport(round_idx, 0, 0, False,
                                            admit_credited, len(landed),
                                            n_retired, 0.0, admit_rows_n,
                                            admit_tokens,
                                            preempted=self._round_preempted,
                                            deferred=deferred_n,
                                            shared_tokens=shared_n,
                                            chunk_steps=chunk_n))
                self._free_retired()
                if not eng.queue and not self._chunking:
                    break
                if self._note_stall(had_admissible,
                                    landed or admit_rows_n or n_retired):
                    aborted = True
                    self._abort(slots)
                    break
                round_idx += 1                  # idle: awaiting arrivals
                continue

            # ---- re-plan on the LIVE slot count (the paper's N(t))
            gamma, use_sd = eng.gamma, True
            if eng.tuner is not None:
                plan = eng.tuner.plan(live)
                gamma, use_sd = plan["gamma"], plan["use_sd"]
            if eng.force_sd is not None:
                use_sd = eng.force_sd
            if kind == "none" or self._forced_ar:
                # the ladder's first rung forces AR until a healthy round,
                # over force_sd too
                use_sd = False
            if not use_sd:
                gamma = 0                       # in-session SD→AR handoff
            if gamma > g_max:
                raise ValueError(
                    f"tuner planned gamma={gamma} > g_max={g_max} the "
                    "stream was sized for; expose the tuner's range via a "
                    "'gammas' attribute")
            if first_gamma is None:
                first_gamma = gamma
            used_sd_any |= use_sd

            # ---- scripted pre-round faults (tests; no injector in serving)
            t_r0 = time.perf_counter()
            if inj is not None:
                for f in inj.nan_rows(round_idx):
                    row = f.row if f.row is not None else next(
                        (s.index for s in slots if s.active), None)
                    if row is not None:
                        with host_crossing():
                            poison_cache_row(
                                state.t_cache, row,
                                self.engine.target.row_block(state.t_cache),
                                table=None if self._alloc is None
                                else self._alloc.table)
                delay = inj.slow_delay(round_idx)
                if delay:
                    time.sleep(delay)

            # ---- one SD round over the pool, retired rows masked out
            state, res = sess.round(state, gamma=gamma,
                                    generator=eng._next_generator(),
                                    active=active_mask, timed=eng.timed)
            round_wall = time.perf_counter() - t_r0

            # ---- numerical sentinel: non-finite rows committed nothing
            # this round; retire them before crediting
            if res.finite is not None and not bool(np.all(res.finite)):
                for s in slots:
                    if s.active and not bool(res.finite[s.index]):
                        self._count("numerical_faults")
                        self._finish(s, "numerical_fault")
                        faults_n += 1
                        n_retired += 1
            credited = 0
            for s in slots:
                if not s.active:
                    continue
                n = int(res.n_commit[s.index])
                credited += self._append(s, list(res.committed[s.index, :n]))
                if not s.active:
                    n_retired += 1
            # ---- per-request round budgets
            for s in slots:
                if not s.active:
                    continue
                s.request.rounds_used += 1
                if (rescfg.max_rounds_per_request is not None
                        and s.request.rounds_used
                        >= rescfg.max_rounds_per_request):
                    self._count("timeouts")
                    self._finish(s, "timeout")
                    timeouts_n += 1
                    n_retired += 1
            self._free_retired()

            # live-weighted accounting: masked lanes commit nothing
            stats.absorb_round(res, live)
            alpha_round = (float(res.n_accept.sum()) / (res.width * live)
                           if (use_sd and res.width and live) else None)
            if alpha_round is not None and eng.tuner is not None:
                eng.tuner.update_alpha(alpha_round)
            steps.append(StepReport(round_idx, live, gamma, use_sd,
                                    admit_credited + credited,
                                    len(landed), n_retired,
                                    res.round_time, admit_rows_n,
                                    admit_tokens,
                                    preempted=self._round_preempted,
                                    faults=faults_n, timeouts=timeouts_n,
                                    deferred=deferred_n,
                                    shared_tokens=shared_n,
                                    chunk_steps=chunk_n))

            # ---- degradation ladder: healthy → forced AR → safe stop
            slow = (rescfg.round_deadline_s is not None
                    and round_wall > rescfg.round_deadline_s)
            if slow:
                self._count("slow_rounds")
            collapsed = (rescfg.collapse_alpha > 0
                         and alpha_round is not None
                         and alpha_round < rescfg.collapse_alpha)
            if faults_n or slow or collapsed:
                self._consec_faulty += 1
                if (not self._forced_ar and self._consec_faulty
                        >= rescfg.faulty_rounds_to_ar):
                    self._forced_ar = True
                    self._count("ar_handoffs")
                if self._consec_faulty >= rescfg.faulty_rounds_to_stop:
                    aborted = True
                    self._abort(slots)
                    break
            else:
                self._consec_faulty = 0
                self._forced_ar = False
            if self._note_stall(had_admissible,
                                admit_credited + credited or landed
                                or n_retired or admit_rows_n):
                aborted = True
                self._abort(slots)
                break
            round_idx += 1

        if inj is not None and self._alloc is not None:
            inj.release_all(self._alloc)
        self._check_invariants()
        sess.accumulate_prefetch_totals(stats)
        wall = time.perf_counter() - t_start
        clean = ("length", "eos")
        n_tokens = sum(len(r.output) for r in self._finished
                       if r.finish_reason in clean)
        discarded = sum(len(r.output) for r in self._finished
                        if r.finish_reason not in clean)
        reasons: dict = {}
        for r in self._finished:
            reasons[r.finish_reason] = reasons.get(r.finish_reason, 0) + 1
        if aborted:
            self._count("aborts")
        return WaveReport(
            batch=len(self._finished),
            gamma=first_gamma if first_gamma is not None else 0,
            used_sd=used_sd_any, stats=stats, wall_time=wall,
            tokens_out=n_tokens, proposer=kind, bucket=self.pool,
            moe_dispatch=eng.moe_dispatch, scheduler="continuous",
            steps=steps, tokens_discarded=discarded,
            finish_reasons=reasons)

    # ------------------------------------------------------------ resilience
    def _defer_admissible(self, round_idx: int) -> int:
        """Bounded retry with backoff for a transiently failing admission
        round: attempt ``i`` pushes a request ``backoff * 2**(i-1)`` rounds
        out; past ``admit_retries`` it finishes ``admit_failed``."""
        eng = self.engine
        rescfg = eng.resilience
        deferred = 0
        while True:
            r = self._pop_admissible(round_idx)
            if r is None:
                return deferred
            r.admit_attempts += 1
            if r.admit_attempts > rescfg.admit_retries:
                self._count("admit_failures")
                self._finish_request(r, "admit_failed")
                continue
            backoff = max(1, rescfg.admit_backoff_rounds
                          * 2 ** (r.admit_attempts - 1))
            r.arrival_round = round_idx + backoff
            eng.queue.append(r)
            self._count("admit_retries")
            deferred += 1

    def _note_stall(self, had_admissible: bool, progress) -> bool:
        """Stall watchdog: True once ``stall_rounds`` consecutive rounds had
        admissible work and nothing landed, committed or retired."""
        if had_admissible and not progress:
            self._consec_stall += 1
        else:
            self._consec_stall = 0
        if self._consec_stall >= self.engine.resilience.stall_rounds:
            self._count("stalls")
            return True
        return False

    def _abort(self, slots: List[SlotState]) -> None:
        """Stream-level safe stop: every in-flight (chunked admissions
        included) and queued request finishes ``"aborted"`` (partial output
        kept) and every page returns to the pool, so the engine stays
        serviceable."""
        for c in self._chunking:
            if self._alloc is not None:
                self._alloc.free_row(c.slot.index)
            self._finish_request(c.request, "aborted")
        self._chunking.clear()
        for s in slots:
            if s.active:
                self._finish(s, "aborted")
        while self.engine.queue:
            self._finish_request(self.engine.queue.popleft(), "aborted")
        self._free_retired()

    def _check_invariants(self) -> None:
        """End of stream: every request left with a finish_reason, and
        (paged) no page leaked."""
        for r in self._finished:
            if r.finish_reason is None:
                raise RuntimeError(
                    f"request {r.uid} left the stream without a "
                    "finish_reason")
        if self._alloc is not None:
            self._alloc.assert_no_leaks()

    def _free_retired(self) -> None:
        """Return retired rows' pages to the pool (paged layout)."""
        if self._alloc is not None:
            for row in self._retired_rows:
                self._alloc.free_row(row)
        self._retired_rows.clear()
