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

Every round would consult ``tuner.plan(live)``; the AutoTuner is not
ported, so ``engine.tuner`` is None and gamma stays fixed.  Prefix sharing,
chunked prefill and fault injection wait for later slices (the engine's
constructor refuses them).

The engine's generator replaces the reference's key splits: each admission
and round draws from it in turn.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.spec_decode import SDStats, SessionState
from repro_torch.data.tokenizer import PAD
from repro_torch.models.model import PageAllocator
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
    (``timeouts``), admissions ``deferred`` by backpressure."""
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

    def _bucket(self, n: int) -> int:
        return _pow2_at_least(n) if self.engine.bucket_batches else n

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

    def _sync_table(self, state: SessionState) -> SessionState:
        """Push the allocator's host table into the session's table in
        place (a copy: the allocator keeps mutating its array; in place:
        the session's round graphs read that tensor).  A growth has already
        given the session a table of the allocator's new shape."""
        state.t_cache["pages"]["table"].copy_(
            torch.from_numpy(self._alloc.table))
        return state

    def _grow(self, sess, state: SessionState, pool_pages: int,
              max_pages: int) -> SessionState:
        """Adopt a grown paged geometry: pad the session's pool and logical
        capacity and mirror it in the allocator."""
        alloc = self._alloc
        state = sess.grow_session(state, max_pages * alloc.page_size,
                                  pool_pages=pool_pages, max_pages=max_pages)
        alloc.grow(pool_pages, max_pages)
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
                   round_idx: int, live: int, slots: List[SlotState]
                   ) -> Tuple[SessionState, str]:
        """Make the paged pool able to admit ``r``: ``"ok"`` (caller
        allocs), ``"defer"`` (transient pressure) or ``"impossible"`` (it
        cannot fit a drained pool at ``max_pool_pages``).  Under pressure:
        grow (pow2) while the cap allows, then preempt, then defer."""
        alloc = self._alloc
        cap = self.engine.resilience.max_pool_pages
        need = self._need(r)
        need_pages = alloc.pages_for(need)
        if cap is not None and need_pages > cap - 1:
            return state, "impossible"
        while True:
            if (need > state.max_seq or need_pages > alloc.max_pages
                    or need_pages > len(alloc.free)):
                pool_pages, max_pages = alloc.grown_geometry(need)
                if cap is not None and pool_pages > cap:
                    victim = self._preempt_victim(slots, r)
                    if victim is None:
                        return state, "defer"
                    self._preempt(victim, round_idx)
                    continue
                state = self._grow(sess, state, pool_pages, max_pages)
                continue
            if not self._headroom_ok(need_pages, live):
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
            cap = self._bucket(max(self._need(r) for r in visible))
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

    def _admit_boundary(self, sess, state: SessionState, slots, round_idx,
                        max_seq: int):
        """Retire/refill at one round boundary: admit every admissible
        request into a free slot with one prefill, rejecting (dense) or
        making room for (paged) what the stream was not sized for.
        Returns (state, landed, deferred, admit_rows, admit_tokens)."""
        eng = self.engine
        paged = self._alloc is not None
        batch_in: List[Tuple[SlotState, "Request"]] = []
        claimed = set()
        deferred = 0
        live_now = sum(1 for s in slots if s.active)
        while True:
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
            if paged:
                state, verdict = self._make_room(sess, state, r, round_idx,
                                                 live_now, slots)
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
                self._alloc.alloc(free[0].index, self._need(r))
                self._table_dirty = True
            s = free[0]
            claimed.add(s.index)
            s.admit_seq = self._admit_seq
            self._admit_seq += 1
            batch_in.append((s, r))
        if self._table_dirty:
            # one table upload covers every page assignment and preemption
            # of this boundary, before the admission scatter writes through
            # it and before the next round: a freed victim's row must point
            # at trash page 0, or its frozen lane would write into pages the
            # pool has re-issued
            state = self._sync_table(state)
        rows_n = toks_n = 0
        if batch_in:
            state, rows_n, toks_n = self._admit_batch(sess, state, batch_in)
        return state, batch_in, deferred, rows_n, toks_n

    def run_stream(self) -> Optional[WaveReport]:
        """Serve the queued stream to completion; one aggregated report.

        Per round: (1) retire/refill (``_admit_boundary``); (2) plan gamma
        on the live slot count (``tuner.plan(live)`` when a tuner is set),
        with the SD→AR handoff as a gamma=0 round in the same session;
        (3) one SD round with the active mask; (4) credit tokens per slot,
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
        rescfg = eng.resilience
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
            state, landed, deferred_n, admit_rows_n, admit_tokens = \
                self._admit_boundary(sess, state, slots, round_idx,
                                     max_seq)
            if landed:
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
                                            deferred=deferred_n))
                self._free_retired()
                if not eng.queue:
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
                # the ladder's first rung forces AR until a healthy round
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

            # ---- one SD round over the pool, retired rows masked out
            t_r0 = time.perf_counter()
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
                                    deferred=deferred_n))

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

        self._check_invariants()
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
        """Stream-level safe stop: every in-flight and queued request
        finishes ``"aborted"`` (partial output kept) and every page returns
        to the pool, so the engine stays serviceable."""
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
