"""Batched speculative-decoding engine (the paper's serving mechanism).

Port of ``repro.core.spec_decode`` (wave-mode session API).  One SD round
(Sec. 3.1), generic over any registered Proposer:

  1. PROPOSE  — ``proposer.propose`` emits g <= gamma draft tokens per
     sequence with their draft distributions.
  2. VERIFY   — the target processes [last_token, d_1..d_g] (g+1 tokens) in
     ONE forward, yielding g+1 next-token distributions.
  3. REJECT   — batched rejection sampling accepts a per-sequence prefix of
     the drafts and emits one extra token.  n_commit = n_accept + 1.
  4. COMMIT   — target cache commit + ``proposer.commit``.

The AR baseline is the degenerate g=0 instance of the same loop (the
"none" proposer), so SD and AR timings come from identical machinery.

Session API (the continuous-batching seam): ``start`` opens a batch
(optionally with a paged target cache and a pre-assigned block table),
``round`` advances it with an ``active`` mask, ``admit`` (full pool) and
``admit_rows`` (only the admitted rows, scattered into the live session)
prefill new requests into retired rows between rounds, and
``grow_session`` raises a paged session's capacity.

The reference jits one fused round per gamma (and three stage programs for
``timed=True``) and logs every trace.  This port captures them in CUDA
graphs (``core/graphs.py``): one graph set per key (stage, gamma, batch,
max_seq, cache geometry), captured the first time the key runs and
replayed every later round.  ``trace_log`` gets (gamma, batch) for each
capture, and ``admit_trace_log`` each (prompt bucket, rows) the first time
an admission runs with a new shape (cache geometry included); admissions,
prefills and growth stay eager.  A replayed round copies its host inputs
into static buffers, replays with no host sync, and reads its results back
with one device-to-host copy.  ``cuda_graphs=False`` runs the same rounds
eagerly on the card (A/B runs); on the CPU they always run eagerly.

Arenas.  A graph reads and writes fixed addresses, so a session's tensors
(target and draft caches with their lengths, the block table, the last
token) live in an arena per (batch, max_seq, cache geometry) that the
engine keeps for its lifetime: ``start`` resets and prefills into the
arena of its shape, so the second wave of a shape replays the first one's
graphs, ``grow_session`` moves a paged session into the arena of its new
geometry, and the admissions write into the arena in place.  A
``SessionState`` therefore aliases its arena: a round or a later ``start``
of the same shape changes what an older state holds, so callers keep only
the newest state, and a state whose tensors are not its arena's is copied
into the arena by the next round.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, replace
from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.core.graphs import RoundGraphs, StaticIO
from repro_torch.core.proposer import Proposer, make_proposer
from repro_torch.core.rejection import probs_from_logits, rejection_sample, sample_from
from repro_torch.models.model import (Model, grow_cache_pages, merge_cache_rows,
                                      scatter_cache_rows)
from repro_torch.serving.faults import logits_finite


@dataclass
class SDStats:
    rounds: int = 0
    generated: int = 0                      # total committed tokens (all seqs)
    max_possible: int = 0                   # rounds * (gamma+1) * B_live
    accept_events: int = 0                  # accepted draft tokens
    draft_events: int = 0                   # proposed draft tokens
    round_time: float = 0.0                 # wall time across all rounds
    propose_time: float = 0.0               # per-phase (timed=True only)
    verify_time: float = 0.0
    reject_time: float = 0.0

    @property
    def sigma(self) -> float:               # paper's σ (Eq. 5 empirical)
        return self.generated / max(self.max_possible, 1)

    @property
    def alpha(self) -> float:               # empirical acceptance rate
        return self.accept_events / max(self.draft_events, 1)

    def absorb_round(self, res: "RoundResult", live: int) -> None:
        """Fold one RoundResult into the aggregate; ``live`` is the number
        of rows the round was asked to advance."""
        self.rounds += 1
        self.round_time += res.round_time
        if res.phase_times:
            self.propose_time += res.phase_times.get("propose", 0.0)
            self.verify_time += res.phase_times.get("verify", 0.0)
            self.reject_time += res.phase_times.get("reject", 0.0)
        self.generated += int(res.n_commit.sum())
        self.max_possible += (res.gamma + 1) * live
        self.accept_events += int(res.n_accept.sum())
        self.draft_events += res.width * live


@dataclass
class SessionState:
    """One live decoding batch: everything a round reads and writes.
    ``last_token`` (B,) is the most recently committed token per row (after
    ``start`` the prefill-sampled first generated token).  Its tensors are
    the engine's arena for its shape (module docstring): a later round or
    ``start`` of that shape overwrites them, so keep only the newest
    state."""
    params: dict
    t_cache: dict
    p_state: Any
    last_token: torch.Tensor
    max_seq: int

    @property
    def batch(self) -> int:
        return int(self.last_token.shape[0])


@dataclass
class RoundResult:
    """Host-side outcome of one SD round.  ``committed`` is (B, width+1);
    per row only the first ``n_commit[b]`` entries are real.  ``finite``
    (B,) is the numerical sentinel's verdict on the raw verify logits: a
    False row committed nothing this round."""
    committed: np.ndarray
    n_commit: np.ndarray
    n_accept: np.ndarray
    width: int
    gamma: int
    round_time: float
    phase_times: Optional[Dict[str, float]] = None
    finite: Optional[np.ndarray] = None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _on(x, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A host value as a NEW tensor on ``device`` (never a view of the
    caller's numpy buffer, which the scheduler keeps mutating); a tensor
    is only moved and cast."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.tensor(np.asarray(x), dtype=dtype, device=device)


def _cache_geometry(t_cache: dict) -> tuple:
    """Shapes of one layer's cache leaves and of the block table: what a
    growth changes, and what the reference's jit would retrace on."""
    pages = t_cache.get("pages")
    return (tuple(tuple(v.shape) for v in t_cache["layers"][0].values()),
            None if pages is None else tuple(pages["table"].shape))


def _copy_into(dst, src) -> None:
    """Copy every tensor leaf of ``src`` into the same leaf of ``dst`` (same
    structure and shapes), skipping leaves that already are ``dst``'s."""
    if isinstance(dst, torch.Tensor):
        if src is not dst:
            dst.copy_(src)
    elif isinstance(dst, dict):
        if dst.keys() != src.keys():
            raise ValueError(f"session tree keys {sorted(src)} != arena's "
                             f"{sorted(dst)}")
        for k in dst:
            _copy_into(dst[k], src[k])
    elif isinstance(dst, (list, tuple)):
        if len(dst) != len(src):
            raise ValueError("session tree does not match its arena")
        for d, s in zip(dst, src):
            _copy_into(d, s)
    elif not (dst is None and src is None):
        raise ValueError("session tree does not match its arena")


def _claim(tree, owned: Set[int]):
    """``tree`` with every tensor leaf that ``owned`` (ids) already holds
    cloned, so no two leaves of the arenas share a tensor (a target and a
    draft prefill share their ``lengths``); adds the returned leaves' ids
    to ``owned``."""
    if isinstance(tree, torch.Tensor):
        if id(tree) in owned:
            tree = tree.clone()
        owned.add(id(tree))
        return tree
    if isinstance(tree, dict):
        return {k: _claim(v, owned) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_claim(v, owned) for v in tree)
    return tree


@dataclass
class _Arena:
    """The session tensors of one (batch, max_seq, cache geometry)."""
    t_cache: dict
    p_state: Any
    last_token: torch.Tensor


class SDEngine:
    """One persistent decoding session: a target model + one Proposer.

    ``cuda_graphs`` (default: True on a CUDA device) captures each round
    key once and replays it; False runs rounds eagerly on the card, for
    A/B runs.  On the CPU rounds always run eagerly.  ``sync_guard`` runs
    every replayed untimed round, up to its readback, under
    ``torch.cuda.set_sync_debug_mode("error")``, so a host sync there
    raises."""

    def __init__(self, target: Model, proposer: Proposer, *,
                 gamma: int = 4, temperature: float = 0.0,
                 cuda_graphs: Optional[bool] = None):
        self.target = target
        self.proposer = proposer
        self.gamma = gamma
        self.temperature = temperature
        if cuda_graphs is None:
            cuda_graphs = target.device.type == "cuda"
        models = [target] + ([proposer.draft]
                             if getattr(proposer, "draft", None) else [])
        self.graphs = RoundGraphs(target.device, capture=cuda_graphs,
                                  models=models)
        self.sync_guard = False
        self.trace_log: List[Tuple[int, int]] = []       # (gamma, B) per capture
        # (T_prompt, rows) per new admission shape: the full path logs the
        # pool, the sliced path the admitted-row bucket
        self.admit_trace_log: List[Tuple[int, int]] = []
        self.growth_log: List[Tuple[int, Optional[int]]] = []
        self._shapes: Set[tuple] = set()
        self._arenas: Dict[tuple, _Arena] = {}
        self._owned: Set[int] = set()        # ids of the arenas' tensors
        self._io: Dict[tuple, StaticIO] = {}

    def compiled_gammas(self) -> List[int]:
        """Gammas this session has captured a round for."""
        return sorted({g for g, _ in self.trace_log})

    # ----------------------------------------------------------- round pieces
    def _verify(self, params_t, t_cache, last_token, drafts):
        verify_tokens = torch.cat([last_token[:, None], drafts], 1)
        logits, pend = self.target.extend(params_t, verify_tokens, t_cache,
                                          collect=True)
        # the sentinel reads RAW logits: argmax of an all-NaN row is valid
        return probs_from_logits(logits, self.temperature), pend, \
            logits_finite(logits)

    def _finalize(self, params, pend, p_state, base_len, p_dist, q_dist,
                  drafts, last_token, active, finite, generator):
        B, g = drafts.shape
        n_accept, next_token, _ = rejection_sample(
            p_dist, q_dist, drafts, generator, self.temperature)
        # inactive rows and non-finite rows commit nothing: lengths stay
        # frozen and last_token is carried over
        ok = active & finite
        n_accept = torch.where(ok, n_accept, torch.zeros_like(n_accept))
        n_commit = torch.where(ok, n_accept + 1, torch.zeros_like(n_accept))
        t_cache = self.target.commit(pend, n_commit, collected=True)
        verify_tokens = torch.cat([last_token[:, None], drafts], 1)
        p_state = self.proposer.commit(
            params, p_state, base_len=base_len, n_accept=n_accept,
            n_commit=n_commit, verify_tokens=verify_tokens, hidden=None)
        slot = torch.arange(g + 1, device=drafts.device)[None, :]
        drafts_pad = torch.cat([drafts, drafts.new_zeros((B, 1))], 1)
        committed = torch.where(slot < n_accept[:, None], drafts_pad,
                                next_token[:, None])             # (B, g+1)
        new_last = torch.where(ok, next_token, last_token)
        return t_cache, p_state, new_last, committed, n_commit, n_accept

    def _round_stages(self, state: SessionState, io: StaticIO, gamma: int,
                      generator, staged: bool) -> list:
        """The round over ``state``'s arena as stage callables: one fused
        stage, or (``staged``) propose, verify and finalize, each handing
        its intermediates to the next.  Finalize writes the new lengths and
        last token into the arena and the results into ``io``."""
        params, t_cache, p_state = state.params, state.t_cache, state.p_state
        last = state.last_token

        def propose(_):
            return self.proposer.propose(params, p_state, last, gamma,
                                         generator)

        def verify(prev):
            drafts = prev[0]
            return prev + self._verify(params["target"], t_cache, last,
                                       drafts)

        def finalize(prev):
            drafts, q_dist, p_work, p_dist, pend, finite = prev
            t_new, p_new, new_last, committed, n_commit, n_acc = \
                self._finalize(params, pend, p_work, t_cache["lengths"],
                               p_dist, q_dist, drafts, last, io.active,
                               finite, generator)
            io.publish(committed, n_commit, n_acc, finite)
            _copy_into((t_cache, p_state, last), (t_new, p_new, new_last))

        if not staged:
            return [lambda _: finalize(verify(propose(None)))]
        if self.proposer.kind == "none":
            # zero-width drafts launch nothing: no propose graph to capture
            return [lambda _: verify(propose(None)), finalize]
        return [propose, verify, finalize]

    def _log_shape(self, log: list, entry: tuple, key: tuple) -> None:
        """Append ``entry`` to ``log`` the first time ``key`` runs."""
        if key not in self._shapes:
            self._shapes.add(key)
            log.append(entry)

    # ---------------------------------------------------------------- arenas
    def _adopt(self, akey: tuple, t_cache: dict, p_state, last_token
               ) -> _Arena:
        """The arena of ``akey`` holding these session tensors: copied into
        it where they are not its own, or, for a new key, these tensors
        become the arena (clones of any an arena already holds)."""
        arena = self._arenas.get(akey)
        if arena is None:
            arena = self._arenas[akey] = _Arena(
                *_claim((t_cache, p_state, last_token), self._owned))
        else:
            _copy_into((arena.t_cache, arena.p_state, arena.last_token),
                       (t_cache, p_state, last_token))
        return arena

    def _arena_key(self, batch: int, max_seq: int, t_cache: dict) -> tuple:
        return (batch, max_seq, _cache_geometry(t_cache))

    # --------------------------------------------------------------- prefill
    def _fresh_prefill(self, params, prompts, lengths, max_seq, *,
                       cache_opts: Optional[dict] = None, page_table=None,
                       reuse: Optional[_Arena] = None):
        """Prefill a batch into caches (fresh, or ``reuse``'s reset in
        place) and proposer state; returns (t_cache, p_state, last_logits).
        Behind ``start`` and the admissions (compact or full, dense)."""
        dev = self.target.device
        prompts = _on(prompts, torch.int64, dev)
        if lengths is not None:
            lengths = _on(lengths, torch.int32, dev)
        t_cache = self.target.init_cache(
            prompts.shape[0], max_seq, **(cache_opts or {}),
            reuse=None if reuse is None else reuse.t_cache)
        if page_table is not None:
            t_cache["pages"]["table"].copy_(_on(page_table, torch.int32, dev))
        last_l, t_cache = self.target.prefill(params["target"], prompts,
                                              t_cache, lengths=lengths)
        p_state = self.proposer.init_state(
            params, prompts, max_seq, lengths=lengths,
            reuse=None if reuse is None else reuse.p_state)
        return t_cache, p_state, last_l

    # --------------------------------------------------------------- session
    def start(self, params_t, params_p, prompts, *, max_seq: int,
              lengths=None, generator: Optional[torch.Generator] = None,
              cache_opts: Optional[dict] = None, page_table=None
              ) -> SessionState:
        """Open a decoding batch: prefill into the arena of its shape (reset
        in place; allocated the first time) → ``SessionState``.
        ``max_seq`` is the static capacity of a dense session, and only the
        initial logical capacity of a paged one (``grow_session`` raises
        it).  ``cache_opts`` goes to ``Model.init_cache`` (e.g.
        ``{"paged": True, "page_size": 64, "pool_pages": N}``);
        ``page_table`` pre-assigns a paged cache's block table (a
        ``PageAllocator``'s) so the prefill lands in the rows' pages.
        Proposer caches stay dense."""
        params = {"target": params_t, "draft": params_p}
        B = int(np.shape(prompts)[0])
        akey = self._arena_key(B, max_seq, self.target.init_cache(
            B, max_seq, **(cache_opts or {}), device="meta"))
        t_cache, p_state, last_l = self._fresh_prefill(
            params, prompts, lengths, max_seq, cache_opts=cache_opts,
            page_table=page_table, reuse=self._arenas.get(akey))
        last = sample_from(probs_from_logits(last_l, self.temperature),
                           generator, self.temperature)
        arena = self._adopt(akey, t_cache, p_state, last)
        return SessionState(params=params, t_cache=arena.t_cache,
                            p_state=arena.p_state,
                            last_token=arena.last_token, max_seq=max_seq)

    def round(self, state: SessionState, *, gamma: Optional[int] = None,
              generator: Optional[torch.Generator] = None, active=None,
              timed: bool = False) -> Tuple[SessionState, RoundResult]:
        """Run ONE propose/verify/reject/commit round on a live session.

        ``active`` (B,) bool: inactive rows commit 0 tokens.  The round is
        the graph set of its key (fused; ``timed``: the propose, verify and
        finalize stages with a device sync between them to fill
        ``phase_times``), captured on the key's first round and replayed
        after.  Host inputs go into static buffers first; the results come
        back with one device-to-host copy at the end, the round's one host
        sync when untimed.  The returned state aliases the arena."""
        gamma = self.gamma if gamma is None else gamma
        if generator is None and self.temperature > 0.0:
            raise ValueError("round() needs a generator at temperature>0")
        B = state.batch
        akey = self._arena_key(B, state.max_seq, state.t_cache)
        key = ("staged" if timed else "round", gamma) + akey
        io = self._io.get(key)
        if io is None:
            io = self._io[key] = StaticIO(B, self.target.device)
        phases: Dict[str, float] = {}
        names = (["propose", "verify", "reject"]
                 if self.proposer.kind != "none" else ["verify", "reject"])
        t_round = time.perf_counter()
        t_phase = [t_round]

        def after_stage(i):
            _sync(self.target.device)
            now = time.perf_counter()
            phases[names[i]] = now - t_phase[0]
            t_phase[0] = now

        warm = key in self.graphs.captures
        with self._guarded(warm and not timed):
            arena = self._adopt(akey, state.t_cache, state.p_state,
                                state.last_token)
            state = replace(state, t_cache=arena.t_cache,
                            p_state=arena.p_state,
                            last_token=arena.last_token)
            io.set_active(active)
            stages = self._round_stages(state, io, gamma, generator, timed)
            if self.graphs.run(key, stages,
                               generator=None if self.temperature <= 0.0
                               else generator,
                               after_stage=after_stage if timed else None):
                self.trace_log.append((gamma, B))
        committed, n_commit, n_acc, finite = io.read()
        round_time = time.perf_counter() - t_round
        if timed:
            phases.setdefault("propose", 0.0)
        result = RoundResult(
            committed=committed, n_commit=n_commit, n_accept=n_acc,
            width=committed.shape[1] - 1, gamma=gamma, round_time=round_time,
            phase_times=phases if timed else None, finite=finite)
        return state, result

    @contextmanager
    def _guarded(self, on: bool):
        """``sync_guard``'s region: sync debug mode "error" on the card."""
        if not (on and self.sync_guard and self.target.device.type == "cuda"):
            yield
            return
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(prev)

    # -------------------------------------------------------------- admission
    def admit(self, state: SessionState, prompts, lengths, admit_mask, *,
              generator: Optional[torch.Generator] = None) -> SessionState:
        """Full-pool admission: prefill the whole (B, T_prompt) bucket into
        fresh caches and copy the rows where ``admit_mask`` is True into
        the live session in place (``merge_cache_rows`` +
        ``Proposer.merge_state``); the other rows' prefill is discarded.
        Dense sessions only."""
        B, Tp = np.shape(prompts)
        if B != state.batch:
            raise ValueError(f"admit batch {B} != session batch "
                             f"{state.batch}")
        self._log_shape(self.admit_trace_log, (Tp, B),
                        ("admit", B, Tp, state.max_seq,
                         _cache_geometry(state.t_cache)))
        fresh_t, fresh_p, last_l = self._fresh_prefill(
            state.params, prompts, lengths, state.max_seq)
        first = sample_from(probs_from_logits(last_l, self.temperature),
                            generator, self.temperature)
        mask = np.asarray(admit_mask, bool)
        t_cache = merge_cache_rows(state.t_cache, fresh_t, mask)
        p_state = self.proposer.merge_state(state.p_state, fresh_p, mask)
        last_token = torch.where(
            torch.as_tensor(mask, device=self.target.device), first,
            state.last_token)
        return replace(state, t_cache=t_cache, p_state=p_state,
                       last_token=last_token)

    def _scatter_admitted(self, state: SessionState, fresh, rows, valid,
                          generator, Tp: int) -> SessionState:
        """Scatter a compact fresh (cache, p_state, last_logits) into the
        live session in place; pad lanes (``valid`` False) are dropped on
        the host."""
        fresh_t, fresh_p, last_l = fresh
        first = sample_from(probs_from_logits(last_l, self.temperature),
                            generator, self.temperature)
        t_cache = scatter_cache_rows(state.t_cache, fresh_t, rows,
                                     valid=valid, n_prompt=Tp)
        p_state = self.proposer.scatter_state(state.p_state, fresh_p, rows,
                                              valid=valid)
        keep = np.nonzero(valid)[0]
        dev = self.target.device
        last_token = state.last_token
        last_token[torch.as_tensor(np.asarray(rows)[keep], device=dev)] = \
            first[torch.as_tensor(keep, device=dev)]
        return replace(state, t_cache=t_cache, p_state=p_state,
                       last_token=last_token)

    def admit_rows(self, state: SessionState, prompts, lengths, rows, *,
                   valid=None, generator: Optional[torch.Generator] = None
                   ) -> SessionState:
        """Row-SLICED admission: prefill only the R admitted rows.

        ``prompts`` (R, T_prompt) holds the admitted requests (row-count
        bucketed; pad lanes replicate real ones and carry ``valid`` False),
        ``rows`` (R,) the pool row each lands in.  The fresh prefill runs
        at (R, T_prompt) into a dense cache of the session's logical
        capacity and is scattered into the live session, dense or paged
        (a paged session's table must already map the rows)."""
        R, Tp = np.shape(prompts)
        if generator is None and self.temperature > 0.0:
            raise ValueError("admit_rows() needs a generator at "
                             "temperature>0")
        valid = (np.ones((R,), bool) if valid is None
                 else np.asarray(valid, bool))
        self._log_shape(self.admit_trace_log, (Tp, R),
                        ("admit_rows", R, Tp, state.max_seq,
                         _cache_geometry(state.t_cache)))
        fresh = self._fresh_prefill(state.params, prompts, lengths,
                                    state.max_seq)
        return self._scatter_admitted(state, fresh, rows, valid, generator,
                                      Tp)

    # ---------------------------------------------------------------- growth
    def grow_session(self, state: SessionState, new_max_seq: int, *,
                     pool_pages: Optional[int] = None,
                     max_pages: Optional[int] = None) -> SessionState:
        """Raise a PAGED session's logical capacity to ``new_max_seq``: pad
        the target's page pool and block table (``grow_cache_pages``) and
        the proposer's dense caches (``Proposer.grow_state``), so a late
        long request admits instead of raising.  The grown session moves
        into the arena of its new geometry.  Logged in ``growth_log``."""
        t_cache = state.t_cache
        if t_cache.get("pages") is None:
            raise ValueError("grow_session: dense sessions are statically "
                             "sized; use a paged session (kv_layout='paged')")
        if pool_pages is not None:
            t_cache = grow_cache_pages(t_cache, pool_pages, max_pages)
        p_state = self.proposer.grow_state(state.p_state, new_max_seq)
        self.growth_log.append((new_max_seq, pool_pages))
        arena = self._adopt(
            self._arena_key(state.batch, new_max_seq, t_cache), t_cache,
            p_state, state.last_token)
        return replace(state, t_cache=arena.t_cache, p_state=arena.p_state,
                       last_token=arena.last_token, max_seq=new_max_seq)

    # -------------------------------------------------------------- generate
    def generate(self, params_t, params_p, prompts, max_new_tokens: int, *,
                 gamma: Optional[int] = None, max_seq: Optional[int] = None,
                 lengths=None, generator: Optional[torch.Generator] = None,
                 timed: bool = False) -> Tuple[np.ndarray, SDStats]:
        """Run SD rounds until every sequence has >= max_new_tokens."""
        B, Tp = prompts.shape
        gamma = self.gamma if gamma is None else gamma
        if max_seq is None:
            max_seq = Tp + max_new_tokens + gamma + 2
        state = self.start(params_t, params_p, prompts, max_seq=max_seq,
                           lengths=lengths, generator=generator)
        out = np.zeros((B, max_new_tokens + gamma + 1), np.int32)
        n_out = np.zeros((B,), np.int32)
        # the first sampled token (from prefill) counts as generated
        out[:, 0] = state.last_token.cpu().numpy()
        n_out += 1
        stats = SDStats()
        while int(n_out.min()) < max_new_tokens:
            state, res = self.round(state, gamma=gamma, generator=generator,
                                    timed=timed)
            if res.finite is not None and not bool(np.all(res.finite)):
                # wave mode has no quarantine path: a non-finite row would
                # commit nothing forever and the loop would never end
                bad = np.where(~np.asarray(res.finite))[0].tolist()
                raise RuntimeError(
                    f"non-finite verify logits in wave-mode rows {bad}; "
                    "use the continuous scheduler for quarantine")
            for b in range(B):
                n = int(res.n_commit[b])
                w = min(n, out.shape[1] - n_out[b])
                out[b, n_out[b]: n_out[b] + w] = res.committed[b, :w]
                n_out[b] += w
            stats.absorb_round(res, B)
        return out[:, :max_new_tokens], stats


def _ar_session(model: Model, temperature: float) -> SDEngine:
    """One persistent "none" session per (model, temperature), kept on the
    model instance so it shares the model's lifetime."""
    per_model = getattr(model, "_ar_sessions", None)
    if per_model is None:
        per_model = model._ar_sessions = {}
    eng = per_model.get(temperature)
    if eng is None:
        eng = SDEngine(model,
                       make_proposer("none", model, temperature=temperature),
                       gamma=0, temperature=temperature)
        per_model[temperature] = eng
    return eng


def generate_ar(model: Model, params, prompts, max_new_tokens: int, *,
                temperature: float = 0.0, lengths=None,
                generator: Optional[torch.Generator] = None) -> np.ndarray:
    """Plain autoregressive baseline — the gamma=0 / "none" path."""
    out, _ = _ar_session(model, temperature).generate(
        params, None, prompts, max_new_tokens, lengths=lengths,
        generator=generator)
    return out
