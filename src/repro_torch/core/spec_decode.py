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

Proposers that read the target's features (``needs_hidden``: the EAGLE
head) get the verify pass's hidden states in ``commit`` and the prefill's
last hidden state in ``init_state``.  Prefetch-aware proposers
(``provides_prefetch``) always run staged, as the reference refuses its
fused round for them: propose (with the router probe), WARM (the plan's
experts' weights gathered into the engine's fixed warm buffers,
``models/moe.warm_experts``), verify through
``Model.extend_with_prefetch`` (hit, actual and predicted expert counts
on the device), finalize; the counts come back with the round's one
readback and add up in ``SDStats`` and ``prefetch_totals``.

Session API (the continuous-batching seam): ``start`` opens a batch
(optionally with a paged target cache and a pre-assigned block table),
``round`` advances it with an ``active`` mask, ``admit`` (full pool) and
``admit_rows`` (only the admitted rows, scattered into the live session)
prefill new requests into retired rows between rounds,
``admit_rows_prefix`` prefills only the unshared tails of rows whose block
tables already point at a sibling's prefix pages,
``begin_admit_chunked``/``admit_chunk`` prefill a long prompt one chunk per
round boundary, and ``grow_session`` raises a paged session's capacity.

The reference jits one fused round per gamma (and three stage programs for
``timed=True``, four with the warm stage) and logs every trace.  This port
captures them in CUDA graphs (``core/graphs.py``): one graph set per key
(stage, gamma, batch, max_seq, cache geometry), captured the first time the
key runs and replayed every later round.  ``trace_log`` gets (gamma, batch) for each
capture, and ``admit_trace_log`` each (prompt bucket, rows) the first time
an admission runs with a new shape (cache geometry included);
``prefix_trace_log`` (tail bucket, rows) and ``chunk_trace_log`` (stage,
chunk, rows) do the same for the prefix-shared and chunked admissions.
Admissions, prefills and growth stay eager.  A replayed round copies its
host inputs into static buffers, replays with no host sync, and reads its
results back with one device-to-host copy.  ``cuda_graphs=False`` runs the
same rounds eagerly on the card (A/B runs); on the CPU they always run
eagerly.

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

Recurrent targets and drafts (Mamba, xLSTM): verify collects each layer's
per-step states and ``Model.commit`` copies the accepted step into the
live state in place; a recurrent draft re-runs the verify tokens from a
copy of its pre-round state (``core/proposer.ModelProposer``).  A retired
(inactive) row's recurrent state is garbage until re-admission scatters a
fresh one.  An encoder-decoder target (whisper) reads ``encoder_embeds``
through ``prefill_kwargs`` (``start``, ``generate``, ``generate_ar``); its
cross K/V are written by the prefill into the arena's cache and read in
place by every round.  The draft gets none.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, replace
from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.core.graphs import FIRST_RUNS, RoundGraphs, StaticIO
from repro_torch.core.proposer import Proposer, make_proposer
from repro_torch.core.rejection import probs_from_logits, rejection_sample, sample_from
from repro_torch.device import host_crossing, sync_debug_mode
from repro_torch.models.model import (Model, grow_cache_pages, merge_cache_rows,
                                      scatter_cache_rows)
from repro_torch.models.moe import warm_experts
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
    # expert-prefetch accounting (prefetch-aware proposers only), summed
    # over rounds and MoE layers: hits = activated AND warmed
    prefetch_hits: int = 0
    prefetch_actual: int = 0                # experts the verify passes hit
    prefetch_predicted: int = 0             # experts the plans warmed
    warm_time: float = 0.0                  # warm stage (timed=True only)

    @property
    def sigma(self) -> float:               # paper's σ (Eq. 5 empirical)
        return self.generated / max(self.max_possible, 1)

    @property
    def alpha(self) -> float:               # empirical acceptance rate
        return self.accept_events / max(self.draft_events, 1)

    @property
    def prefetch_misses(self) -> int:       # activated but NOT warmed
        return self.prefetch_actual - self.prefetch_hits

    @property
    def prefetch_hit_rate(self) -> float:   # P(activated expert was warm)
        return self.prefetch_hits / max(self.prefetch_actual, 1)

    def absorb_round(self, res: "RoundResult", live: int) -> None:
        """Fold one RoundResult into the aggregate; ``live`` is the number
        of rows the round was asked to advance."""
        self.rounds += 1
        self.round_time += res.round_time
        if res.phase_times:
            self.propose_time += res.phase_times.get("propose", 0.0)
            self.verify_time += res.phase_times.get("verify", 0.0)
            self.reject_time += res.phase_times.get("reject", 0.0)
            self.warm_time += res.phase_times.get("warm", 0.0)
        self.generated += int(res.n_commit.sum())
        self.max_possible += (res.gamma + 1) * live
        self.accept_events += int(res.n_accept.sum())
        self.draft_events += res.width * live
        if res.pf is not None:
            self.prefetch_hits += res.pf["hits"]
            self.prefetch_actual += res.pf["actual"]
            self.prefetch_predicted += res.pf["predicted"]


@dataclass
class PendingAdmission:
    """A chunked sliced admission in flight (``begin_admit_chunked``).
    ``t_cache`` is the compact dense target cache under construction (None
    until the first chunk ran), ``consumed`` the prompt tokens prefilled so
    far.  The rows join the live session when ``admit_chunk`` returns None
    for the pending half."""
    prompts: np.ndarray                  # (R, Tp) host-side
    lengths: np.ndarray                  # (R,) true prompt lengths (equal)
    rows: np.ndarray                     # (R,) destination pool rows
    chunk: int
    generator: Optional[torch.Generator] = None
    t_cache: Optional[dict] = None
    consumed: int = 0

    @property
    def remaining(self) -> int:
        return int(self.lengths[0]) - self.consumed


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
    False row committed nothing this round.  ``pf`` holds the round's
    prefetch ``hits``/``actual``/``predicted`` counts (prefetch-aware
    proposers, else None)."""
    committed: np.ndarray
    n_commit: np.ndarray
    n_accept: np.ndarray
    width: int
    gamma: int
    round_time: float
    phase_times: Optional[Dict[str, float]] = None
    finite: Optional[np.ndarray] = None
    pf: Optional[Dict[str, int]] = None


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
    """Shapes of every distinct layer cache (a ring, a page pool, a latent
    pool) and of the block table: what a growth changes, and what the
    reference's jit would retrace on."""
    pages = t_cache.get("pages")
    slots = dict.fromkeys(tuple((k, tuple(v.shape)) for k, v in slot.items())
                          for slot in t_cache["layers"])
    return (tuple(slots),
            None if pages is None else tuple(pages["table"].shape))


def _compact_opts(t_cache: dict) -> dict:
    """``init_cache`` options of a compact admission cache for a live
    cache, under a mesh: its rows whole over ``"data"`` (the scatter
    takes, on each rank, the admitted rows it holds), and, scattered into
    a page pool, its sequence whole, as the pool's."""
    return {"kv_mode": "heads" if t_cache.get("pages") is not None
            else "auto", "split_batch": False}


def _copy_into(dst, src) -> None:
    """Copy every tensor leaf of ``src`` into the same leaf of ``dst`` (same
    structure and shapes), skipping leaves that already are ``dst``'s."""
    if isinstance(dst, torch.Tensor):
        if src is not dst:
            dst.copy_(src)
    elif isinstance(dst, dict):
        if dst.keys() != src.keys():
            raise ValueError(f"session tree keys {sorted(src.keys())} != "
                             f"arena's {sorted(dst.keys())}")
        for k in dst:
            _copy_into(dst[k], src[k])
    elif isinstance(dst, (list, tuple)):
        if len(dst) != len(src):
            raise ValueError("session tree does not match its arena")
        for d, s in zip(dst, src):
            _copy_into(d, s)
    # lint: allow[T101] only host leaves (None, placement records) get here
    elif dst != src:         # None, or a cache's placement record
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


def _provides_prefetch(proposer) -> bool:
    return getattr(proposer, "provides_prefetch", False)


def _counted_models(target: Model, proposer) -> List[Model]:
    """The models whose forward counters a replay credits, each once: the
    target and the proposer's draft ``Model``, if it has one.  An EAGLE
    head is no ``Model``; its steps count no forwards."""
    d = getattr(proposer, "draft", None)
    return [target] + ([d] if isinstance(d, Model) and d is not target
                       else [])


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
    raises; the readback, the admissions and the prefill are explicit
    crossings (``device.host_crossing``).

    ``mesh``/``mesh_layout`` default to the target's (one mesh a session);
    under expert parallelism the prefetch warm gathers each rank's own
    experts only (``models/moe.warm_experts``).  The target allocates its
    session cache as this rank's blocks (``Model.init_cache(placed=True)``),
    once an arena; admissions and growth keep them; the draft's stays
    whole, as the reference places the target's session cache only."""

    def __init__(self, target: Model, proposer: Proposer, *,
                 gamma: int = 4, temperature: float = 0.0,
                 cuda_graphs: Optional[bool] = None, mesh=None,
                 mesh_layout: Optional[str] = None):
        if mesh is None and getattr(target, "mesh", None) is not None:
            mesh = target.mesh
            if mesh_layout is None:
                mesh_layout = target.mesh_layout
        if mesh is not None:
            from repro_torch.distributed.constraints import resolve_mesh
            mesh, mesh_layout = resolve_mesh(mesh, mesh_layout)
        self.mesh = mesh
        self.mesh_layout = mesh_layout
        self.target = target
        self.proposer = proposer
        self.gamma = gamma
        self.temperature = temperature
        if cuda_graphs is None:
            cuda_graphs = target.device.type == "cuda"
        self.graphs = RoundGraphs(target.device, capture=cuda_graphs,
                                  models=_counted_models(target, proposer))
        self.sync_guard = False
        self.trace_log: List[Tuple[int, int]] = []       # (gamma, B) per capture
        # (T_prompt, rows) per new admission shape: the full path logs the
        # pool, the sliced path the admitted-row bucket
        self.admit_trace_log: List[Tuple[int, int]] = []
        self.prefix_trace_log: List[Tuple[int, int]] = []  # (T_tail, rows)
        self.chunk_trace_log: List[Tuple[str, int, int]] = []  # (stage, C, R)
        self.growth_log: List[Tuple[int, Optional[int]]] = []
        self._shapes: Set[tuple] = set()
        self._arenas: Dict[tuple, _Arena] = {}
        self._owned: Set[int] = set()        # ids of the arenas' tensors
        self._io: Dict[tuple, StaticIO] = {}
        # the warm stage's buffers (prefetch-aware proposers): allocated by
        # the first warm, then written in place by every round
        self._warm: Optional[List[dict]] = None
        # session-lifetime expert-prefetch totals, summed over every
        # generation and stream this session served
        self.prefetch_totals: Dict[str, int] = {
            "hits": 0, "actual": 0, "predicted": 0, "rounds": 0}

    def accumulate_prefetch_totals(self, stats: SDStats) -> None:
        """Fold one generation's or stream's prefetch counts into the
        session totals (a no-op for other proposers)."""
        if _provides_prefetch(self.proposer):
            self.prefetch_totals["hits"] += stats.prefetch_hits
            self.prefetch_totals["actual"] += stats.prefetch_actual
            self.prefetch_totals["predicted"] += stats.prefetch_predicted
            self.prefetch_totals["rounds"] += stats.rounds

    def warm_bytes(self) -> int:
        """Bytes of the warm stage's buffers (0 before the first warm)."""
        return sum(t.numel() * t.element_size() for layer in self._warm or ()
                   for t in layer.values())

    def compiled_gammas(self) -> List[int]:
        """Gammas this session has captured a round for."""
        return sorted({g for g, _ in self.trace_log})

    def round_keys(self) -> Dict[tuple, Tuple[int, int]]:
        """(gamma, batch, max_seq) -> (captures, replays) of the round keys
        that ran, summed over the fused and timed stages and over cache
        geometries."""
        keys: Dict[tuple, Tuple[int, int]] = {}
        for key, n in self.graphs.captures.items():
            _, gamma, batch, max_seq, _ = key       # round()'s key layout
            c, r = keys.get((gamma, batch, max_seq), (0, 0))
            keys[(gamma, batch, max_seq)] = (c + n,
                                             r + self.graphs.replays[key])
        return keys

    # ----------------------------------------------------------- round pieces
    def _verify(self, params_t, t_cache, last_token, drafts, plan=None):
        """The verify forward → (p_dist, hidden or None, pending cache,
        prefetch counts or None, finite).  ``plan``: a prefetch round's
        ``PrefetchPlan``, scored by ``Model.extend_with_prefetch``."""
        verify_tokens = torch.cat([last_token[:, None], drafts], 1)
        pf = None
        if plan is not None:
            # lint: allow[K204] the target is fixed per engine
            logits, hidden, pend, pf = self.target.extend_with_prefetch(
                params_t, verify_tokens, t_cache, plan, collect=True)
        else:
            logits, hidden, pend = self.target.extend_with_hidden(
                params_t, verify_tokens, t_cache, collect=True)
        if not self.proposer.needs_hidden:
            hidden = None
        # the sentinel reads RAW logits: argmax of an all-NaN row is valid
        # lint: allow[K204] temperature is fixed per engine
        return (probs_from_logits(logits, self.temperature), hidden, pend,
                pf, logits_finite(logits))

    def _warm_experts(self, params_t, plan) -> None:
        """The warm stage: the plan's experts' weights into the engine's
        warm buffers (allocated by the first call, written in place after,
        so captured rounds write the same addresses)."""
        # lint: allow[T106,K204] first warm allocates; target fixed per engine
        self._warm = warm_experts(params_t["layers"], self.target.cfg, plan,
              # lint: allow[K204] mesh fixed per engine; warm buffers stay put
                                  out=self._warm, mesh=self.mesh)

    def _finalize(self, params, pend, p_state, base_len, p_dist, q_dist,
                  drafts, hidden, last_token, active, finite, generator):
        B, g = drafts.shape
        n_accept, next_token, _ = rejection_sample(
            # lint: allow[K204] temperature is fixed per engine
            p_dist, q_dist, drafts, generator, self.temperature)
        # inactive rows and non-finite rows commit nothing: lengths stay
        # frozen and last_token is carried over
        ok = active & finite
        n_accept = torch.where(ok, n_accept, torch.zeros_like(n_accept))
        n_commit = torch.where(ok, n_accept + 1, torch.zeros_like(n_accept))
        # lint: allow[K204] the target is fixed per engine
        t_cache = self.target.commit(pend, n_commit, collected=True)
        verify_tokens = torch.cat([last_token[:, None], drafts], 1)
        p_state = self.proposer.commit(
            params, p_state, base_len=base_len, n_accept=n_accept,
            n_commit=n_commit, verify_tokens=verify_tokens, hidden=hidden)
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
        its intermediates to the next, with the warm stage between propose
        and verify for a prefetch-aware proposer.  Finalize writes the new
        lengths and last token into the arena and the results into
        ``io``."""
        params, t_cache, p_state = state.params, state.t_cache, state.p_state
        last = state.last_token
        prefetch = _provides_prefetch(self.proposer)

        def propose(_):
            return self.proposer.propose(params, p_state, last, gamma,
                                         generator)

        def warm(prev):
            self._warm_experts(params["target"], prev[2]["plan"])
            return prev

        def verify(prev):
            drafts, _, p_work = prev
            return prev + self._verify(params["target"], t_cache, last,
                                       drafts,
                                       p_work["plan"] if prefetch else None)

        def finalize(prev):
            drafts, q_dist, p_work, p_dist, hidden, pend, pf, finite = prev
            t_new, p_new, new_last, committed, n_commit, n_acc = \
                self._finalize(params, pend, p_work,
                           # lint: allow[K204] the target is fixed per engine
                               self.target.cache_lengths(t_cache),
                               p_dist, q_dist, drafts, hidden, last,
                               io.active, finite, generator)
            io.publish(committed, n_commit, n_acc, finite, pf)
            _copy_into((t_cache, p_state, last), (t_new, p_new, new_last))

        if not staged:
            return [lambda _: finalize(verify(propose(None)))]
        if self.proposer.kind == "none":
            # zero-width drafts launch nothing: no propose graph to capture
            return [lambda _: verify(propose(None)), finalize]
        if prefetch:
            return [propose, warm, verify, finalize]
        return [propose, verify, finalize]

    def _log_shape(self, log: list, entry: tuple, key: tuple) -> None:
        """Append ``entry`` to ``log`` the first time ``key`` runs."""
        if key not in self._shapes:
            self._shapes.add(key)
            log.append(entry)
            FIRST_RUNS["admission_shapes"] += 1

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
                       reuse: Optional[_Arena] = None,
                       prefill_kwargs: Optional[dict] = None):
        """Prefill a batch into caches (fresh, or ``reuse``'s reset in
        place) and proposer state; returns (t_cache, p_state, last_logits).
        Behind ``start`` and the admissions (compact or full, dense).  A
        ``needs_hidden`` proposer starts from the prefill's last hidden
        state.  ``prefill_kwargs`` go to the target's prefill only (an
        encoder-decoder's ``encoder_embeds``)."""
        dev = self.target.device
        prompts = _on(prompts, torch.int64, dev)
        if lengths is not None:
            lengths = _on(lengths, torch.int32, dev)
        t_cache = self.target.init_cache(
            prompts.shape[0], max_seq, placed=True, **(cache_opts or {}),
            reuse=None if reuse is None else reuse.t_cache)
        if page_table is not None:
            rows = self.target.row_block(t_cache)
            if rows is not None:      # the rows this rank's table holds
                page_table = page_table[rows]
            t_cache["pages"]["table"].copy_(_on(page_table, torch.int32, dev))
        last_l, last_h, t_cache = self.target.prefill_with_hidden(
            params["target"], prompts, t_cache, lengths=lengths,
            **(prefill_kwargs or {}))
        p_state = self.proposer.init_state(
            params, prompts, max_seq, lengths=lengths,
            reuse=None if reuse is None else reuse.p_state,
            last_hidden=last_h if self.proposer.needs_hidden else None)
        return t_cache, p_state, last_l

    # --------------------------------------------------------------- session
    @host_crossing()
    def start(self, params_t, params_p, prompts, *, max_seq: int,
              lengths=None, generator: Optional[torch.Generator] = None,
              cache_opts: Optional[dict] = None, page_table=None,
              prefill_kwargs: Optional[dict] = None) -> SessionState:
        """Open a decoding batch: prefill into the arena of its shape (reset
        in place; allocated the first time) → ``SessionState``.
        ``max_seq`` is the static capacity of a dense session, and only the
        initial logical capacity of a paged one (``grow_session`` raises
        it).  ``cache_opts`` goes to ``Model.init_cache`` (e.g.
        ``{"paged": True, "page_size": 64, "pool_pages": N}``);
        ``page_table`` pre-assigns a paged cache's block table (a
        ``PageAllocator``'s) so the prefill lands in the rows' pages.
        ``prefill_kwargs`` go to the target's prefill (``encoder_embeds``).
        Proposer caches stay dense."""
        params = {"target": params_t, "draft": params_p}
        B = int(np.shape(prompts)[0])
        akey = self._arena_key(B, max_seq, self.target.init_cache(
            B, max_seq, placed=True, **(cache_opts or {}), device="meta"))
        t_cache, p_state, last_l = self._fresh_prefill(
            params, prompts, lengths, max_seq, cache_opts=cache_opts,
            page_table=page_table, reuse=self._arenas.get(akey),
            prefill_kwargs=prefill_kwargs)
        last = sample_from(probs_from_logits(last_l, self.temperature),
                           generator, self.temperature)
        arena = self._adopt(akey, t_cache, p_state, last)
        return SessionState(params=params, t_cache=arena.t_cache,
                            p_state=arena.p_state,
                            last_token=arena.last_token, max_seq=max_seq)

    def round_key(self, state: SessionState, gamma: Optional[int] = None,
                  timed: bool = False) -> tuple:
        """The key of the graph set a round of ``state`` runs: (stage,
        gamma, batch, max_seq, cache geometry)."""
        gamma = self.gamma if gamma is None else gamma
        staged = timed or _provides_prefetch(self.proposer)
        return (("staged" if staged else "round", gamma)
                + self._arena_key(state.batch, state.max_seq, state.t_cache))

    def round(self, state: SessionState, *, gamma: Optional[int] = None,
              generator: Optional[torch.Generator] = None, active=None,
              timed: bool = False) -> Tuple[SessionState, RoundResult]:
        """Run ONE propose/verify/reject/commit round on a live session.

        ``active`` (B,) bool: inactive rows commit 0 tokens.  The round is
        the graph set of its key (fused; staged: the propose, verify and
        finalize stages, with the warm stage before verify for a
        prefetch-aware proposer, which always runs staged; ``timed``
        syncs the device after each stage to fill ``phase_times``),
        captured on the key's first round and replayed after.  Host inputs go into static buffers first; the results come
        back with one device-to-host copy at the end, the round's one host
        sync when untimed.  The returned state aliases the arena."""
        gamma = self.gamma if gamma is None else gamma
        if generator is None and self.temperature > 0.0:
            raise ValueError("round() needs a generator at temperature>0")
        B = state.batch
        key = self.round_key(state, gamma, timed)
        akey = key[2:]
        prefetch = _provides_prefetch(self.proposer)
        staged = timed or prefetch
        io = self._io.get(key)
        if io is None:
            io = self._io[key] = StaticIO(B, self.target.device)
        phases: Dict[str, float] = {}
        names = (["verify", "reject"] if self.proposer.kind == "none" else
                 ["propose", "warm", "verify", "reject"] if prefetch else
                 ["propose", "verify", "reject"])
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
            stages = self._round_stages(state, io, gamma, generator, staged)
            if self.graphs.run(key, stages,
                               generator=None if self.temperature <= 0.0
                               else generator,
                               after_stage=after_stage if timed else None):
                self.trace_log.append((gamma, B))
        committed, n_commit, n_acc, finite, pf = io.read()
        round_time = time.perf_counter() - t_round
        if timed:
            phases.setdefault("propose", 0.0)
        result = RoundResult(
            committed=committed, n_commit=n_commit, n_accept=n_acc,
            width=committed.shape[1] - 1, gamma=gamma, round_time=round_time,
            phase_times=phases if timed else None, finite=finite, pf=pf)
        return state, result

    @contextmanager
    def _guarded(self, on: bool):
        """``sync_guard``'s region: sync debug mode "error" on the card."""
        if not (on and self.sync_guard and self.target.device.type == "cuda"):
            yield
            return
        with sync_debug_mode("error"):
            yield

    # -------------------------------------------------------------- admission
    @host_crossing()
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
        t_cache = merge_cache_rows(state.t_cache, fresh_t, mask,
                                   self.target.row_block(state.t_cache))
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
        live = state.t_cache
        t_cache = scatter_cache_rows(live, fresh_t, rows,
                                     row_block=self.target.row_block(live),
                                     table=None if live.get("pages") is None
                                     else self.target.whole_rows(
                                         live, live["pages"]["table"]),
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

    @host_crossing()
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
                                    state.max_seq,
                                    cache_opts=_compact_opts(state.t_cache))
        return self._scatter_admitted(state, fresh, rows, valid, generator,
                                      Tp)

    @host_crossing()
    def admit_rows_prefix(self, state: SessionState, tails, tail_start,
                          tail_len, prompts, lengths, rows, *, valid=None,
                          generator: Optional[torch.Generator] = None
                          ) -> SessionState:
        """Prefix-SHARED sliced admission: target-prefill only the tails.

        For a PAGED session whose allocator already mapped each admitted
        row's table onto a sibling's prefix pages (``fork_prefix``, private
        ``extend_row`` pages, the copy-on-write boundary copied).  The
        target extends only ``tails`` (R, T_tail) at offset ``tail_start``
        over an R-row view of the live cache (the pool tensors themselves
        and the rows' slice of the block table), so the tail K/V land in the
        rows' private pages and the tail queries attend across the shared
        prefix in the same forward: tails of at most PAGED_KERNEL_MAX_T
        tokens through the paged kernel, longer ones over the gathered view.
        The proposer builds its state over the full ``prompts`` (R, T_p).
        Lengths, proposer rows and first tokens are written into the live
        session in place; pad lanes (``valid`` False) replicate real rows
        and are dropped.  Every target layer must be pool-backed
        (full attention or MLA): a SWA ring or a recurrent state is dense
        per row, and a tail extend cannot rebuild it."""
        tails = np.asarray(tails)
        prompts = np.asarray(prompts)
        R, Tt = tails.shape
        Tp = prompts.shape[1]
        if state.t_cache.get("pages") is None:
            raise ValueError("admit_rows_prefix needs a paged session")
        bad = [k for k in self.target.cfg.layer_pattern
               if k not in ("attn", "mla")]
        if bad:
            raise ValueError(
                f"admit_rows_prefix requires pool-backed layers only; "
                f"target has {sorted(set(bad))} (fall back to admit_rows)")
        if generator is None and self.temperature > 0.0:
            raise ValueError("admit_rows_prefix() needs a generator at "
                             "temperature>0")
        valid = (np.ones((R,), bool) if valid is None
                 else np.asarray(valid, bool))
        self._log_shape(self.prefix_trace_log, (Tt, R),
                        ("prefix", R, Tt, Tp, state.max_seq,
                         _cache_geometry(state.t_cache)))
        dev = self.target.device
        t_cache = state.t_cache
        rows_t = torch.as_tensor(np.asarray(rows, np.int64), device=dev)
        # every rank extends every admitted row over its own whole pool
        table = self.target.whole_rows(t_cache, t_cache["pages"]["table"])
        compact = {"layers": t_cache["layers"],
                   "lengths": _on(tail_start, torch.int32, dev),
                   "pages": {"table": table[rows_t]}}
        logits, hidden, _ = self.target.extend_with_hidden(
            state.params["target"], tails, compact)
        idx = _on(np.asarray(tail_len, np.int64) - 1, torch.int64, dev)
        at = torch.arange(R, device=dev)
        last_l = logits[at, idx]
        lengths = _on(lengths, torch.int32, dev)
        fresh_p = self.proposer.init_state(
            state.params, _on(prompts, torch.int64, dev), state.max_seq,
            lengths=lengths,
            last_hidden=hidden[at, idx] if self.proposer.needs_hidden
            else None)
        first = sample_from(probs_from_logits(last_l, self.temperature),
                            generator, self.temperature)
        p_state = self.proposer.scatter_state(state.p_state, fresh_p, rows,
                                              valid=valid)
        # the live lengths jump to the full prompt, shared prefix included;
        # pad lanes (valid False) are dropped on the host
        keep = np.nonzero(valid)[0]
        dst = torch.as_tensor(np.asarray(rows, np.int64)[keep], device=dev)
        src = torch.as_tensor(keep, device=dev)
        block = self.target.row_block(t_cache)
        mine = keep
        if block is not None:         # the lengths of the rows held here
            r = np.asarray(rows, np.int64)[keep]
            mine = keep[(r >= block.start) & (r < block.stop)]
        t_cache["lengths"][torch.as_tensor(
            np.asarray(rows, np.int64)[mine] - (block.start if block else 0),
            device=dev)] = lengths[torch.as_tensor(mine, device=dev)]
        state.last_token[dst] = first[src]
        return replace(state, p_state=p_state)

    # ----------------------------------------------------- chunked admission
    def begin_admit_chunked(self, prompts, lengths, rows, *, chunk: int,
                            generator: Optional[torch.Generator] = None
                            ) -> PendingAdmission:
        """Open a chunked sliced admission: ``admit_chunk`` then prefills
        ``chunk`` tokens per call (one per round boundary), so one long
        admission does not stall the round it lands in.  The compact cache
        attends only to its own written positions, so chunked and one-shot
        prefills give the same tokens.  The rows stay out of the live
        session until the final chunk.  One chunked admission holds
        prompts of EQUAL length, and a target with SWA layers takes chunks
        of at most SWA_RING_PAD + 1 (a wider chunk evicts ring entries still
        inside earlier chunk queries' windows): the serving engine checks
        both."""
        prompts = np.asarray(prompts)
        lengths = np.asarray(lengths, np.int32)
        if len(set(int(x) for x in lengths)) != 1:
            raise ValueError("chunked admission requires equal prompt "
                             "lengths; admit long prompts one at a time")
        if int(lengths[0]) <= chunk:
            raise ValueError("prompt fits one chunk; use admit_rows")
        if generator is None and self.temperature > 0.0:
            raise ValueError("begin_admit_chunked() needs a generator at "
                             "temperature>0")
        return PendingAdmission(prompts=prompts, lengths=lengths,
                                rows=np.asarray(rows, np.int32),
                                chunk=int(chunk), generator=generator)

    @host_crossing()
    def admit_chunk(self, state: SessionState, pa: PendingAdmission
                    ) -> Tuple[SessionState, Optional[PendingAdmission]]:
        """Advance a chunked admission by ONE chunk, eagerly.

        ``first`` prefills a compact dense cache of the session's logical
        capacity, ``mid`` extends and commits it; neither touches the live
        session.  ``final`` extends and commits the last chunk, builds the
        proposer state over the full prompt, samples the first tokens and
        scatters everything into the live session in place, as
        ``admit_rows`` does.  Returns ``(state, pending)``; ``pending`` is
        None once the rows are live."""
        R, Tp = pa.prompts.shape
        C, done, total = pa.chunk, pa.consumed, int(pa.lengths[0])
        take = min(C, total - done)
        toks = np.zeros((R, C), np.int32)
        toks[:, :take] = pa.prompts[:, done:done + take]
        dev = self.target.device
        n_row = torch.full((R,), take, dtype=torch.int32, device=dev)
        params_t = state.params["target"]
        if done == 0:
            self._log_shape(self.chunk_trace_log, ("first", C, R),
                            ("chunk", "first", R, C, state.max_seq))
            fresh_t = self.target.init_cache(
                R, state.max_seq, placed=True, **_compact_opts(state.t_cache))
            _, fresh_t = self.target.prefill(
                params_t, toks, fresh_t,
                lengths=_on(np.minimum(pa.lengths, C), torch.int32, dev))
            return state, replace(pa, t_cache=fresh_t, consumed=take)
        if done + take < total:
            self._log_shape(self.chunk_trace_log, ("mid", C, R),
                            ("chunk", "mid", R, C,
                             _cache_geometry(pa.t_cache)))
            _, pend = self.target.extend(params_t, toks, pa.t_cache,
                                         collect=True)
            fresh_t = self.target.commit(pend, n_row, collected=True)
            return state, replace(pa, t_cache=fresh_t, consumed=done + take)
        self._log_shape(self.chunk_trace_log, ("final", C, R),
                        ("chunk", "final", R, C, Tp, state.max_seq,
                         _cache_geometry(pa.t_cache),
                         _cache_geometry(state.t_cache)))
        logits, hidden, pend = self.target.extend_with_hidden(
            params_t, toks, pa.t_cache, collect=True)
        fresh_t = self.target.commit(pend, n_row, collected=True)
        fresh_p = self.proposer.init_state(
            state.params, _on(pa.prompts, torch.int64, dev), state.max_seq,
            lengths=_on(pa.lengths, torch.int32, dev),
            last_hidden=hidden[:, take - 1] if self.proposer.needs_hidden
            else None)
        state = self._scatter_admitted(
            state, (fresh_t, fresh_p, logits[:, take - 1]), pa.rows,
            np.ones((R,), bool), pa.generator, Tp)
        return state, None

    # ---------------------------------------------------------------- growth
    @host_crossing()
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
                 prefill_kwargs: Optional[dict] = None,
                 timed: bool = False) -> Tuple[np.ndarray, SDStats]:
        """Run SD rounds until every sequence has >= max_new_tokens.
        ``prefill_kwargs`` go to the target's prefill (an encoder-decoder's
        ``encoder_embeds``)."""
        B, Tp = prompts.shape
        gamma = self.gamma if gamma is None else gamma
        if max_seq is None:
            max_seq = Tp + max_new_tokens + gamma + 2
        state = self.start(params_t, params_p, prompts, max_seq=max_seq,
                           lengths=lengths, generator=generator,
                           prefill_kwargs=prefill_kwargs)
        out = np.zeros((B, max_new_tokens + gamma + 1), np.int32)
        n_out = np.zeros((B,), np.int32)
        # the first sampled token (from prefill) counts as generated
        with host_crossing():
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
        self.accumulate_prefetch_totals(stats)
        return out[:, :max_new_tokens], stats


class SpecDecoder(SDEngine):
    """Legacy shim: target + draft *model* pair == ``SDEngine("model")``.

    Prefer ``SDEngine(target, make_proposer("model", target, draft))``."""

    def __init__(self, target: Model, draft: Model, gamma: int = 4,
                 temperature: float = 0.0):
        super().__init__(
            target,
            make_proposer("model", target, draft, temperature=temperature),
            gamma=gamma, temperature=temperature)
        self.draft = draft


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
                generator: Optional[torch.Generator] = None,
                prefill_kwargs: Optional[dict] = None) -> np.ndarray:
    """Plain autoregressive baseline — the gamma=0 / "none" path."""
    out, _ = _ar_session(model, temperature).generate(
        params, None, prompts, max_new_tokens, lengths=lengths,
        generator=generator, prefill_kwargs=prefill_kwargs)
    return out
