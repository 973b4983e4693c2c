"""Serving engine: request queue → batched speculative decoding → completions.

Port of ``repro.serving.engine`` with both schedulers:

  * ``scheduler="wave"`` — admit up to ``max_batch`` requests per
    generation wave (static batch per wave, continuous across waves) and
    run SD rounds until EVERY sequence in the wave is done.  Finished rows
    ride along as padding until the slowest request completes.
  * ``scheduler="continuous"`` — a fixed pool of ``max_batch`` KV-cache
    slots decoded round by round (``serving/scheduler.py``): slots retire
    the moment their request finishes, freed slots are refilled between
    rounds, and the target cache may be dense or paged
    (``kv_layout="paged"``, grown on demand).  Long prompts may prefill in
    chunks (``prefill_chunk``), a paged stream may share common prompt
    prefixes between rows (``prefix_sharing``), and a ``fault_injector``
    (``serving/faults.py``) scripts faults for tests.

The engine holds ONE persistent decoding session (``SDEngine``) per
proposer kind, reused across waves and streams.  Wave batches are padded
to power-of-two buckets with round-robin replicas of real requests, and
cache lengths are bucketed too, as in the reference.  With a ``tuner``
(``core/autotune.AutoTuner``) every wave plans {use_sd, gamma} at its
padded bucket and feeds the wave's acceptance rate back; the continuous
scheduler re-plans on the live slot count every round.  Each gamma that
runs is its own round key, captured once (``core/graphs.py``).

With ``mesh=`` (a ``launch/mesh.make_ep_mesh`` mesh; an ``"ep"`` target)
every rank serves the same stream: the engine threads the mesh to the
target, the draft and each session, keeps the rank's expert block of the
target's params (``distributed/sharding.shard_params``) and reports each
wave's per-rank expert load (``WaveReport.ep``).
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.autotune import AutoTuner
from repro_torch.core.proposer import make_proposer
from repro_torch.core.spec_decode import SDEngine, SDStats
from repro_torch.data.tokenizer import PAD
from repro_torch.device import host_crossing
from repro_torch.distributed.collectives import ep_load_report
from repro_torch.distributed.constraints import resolve_mesh
from repro_torch.distributed.sharding import shard_params
from repro_torch.launch.mesh import mesh_dims
from repro_torch.models.attention import SWA_RING_PAD
from repro_torch.models.model import Model
from repro_torch.serving.faults import ResilienceConfig
from repro_torch.serving.sampling import SamplingParams

@dataclass
class Request:
    uid: int
    prompt: np.ndarray                   # (T,) token ids
    max_new_tokens: int = 64
    temperature: float = 0.0
    output: Optional[np.ndarray] = None
    submitted_at: float = field(default_factory=time.perf_counter)
    finished_at: Optional[float] = None
    sampling: Optional[SamplingParams] = None
    # "length" | "eos" | "rejected" | "numerical_fault" | "timeout" |
    # "admit_failed" | "aborted"
    finish_reason: Optional[str] = None
    arrival_round: int = 0               # continuous mode: visible from here
    # ---- continuous-mode resilience traceability ----
    preempt_count: int = 0               # times page pressure evicted us
    requeue_round: Optional[int] = None  # round of the last preemption
    readmit_round: Optional[int] = None  # round of the last re-admission
    resume_tokens: Optional[List[int]] = None  # committed tokens to replay
    rounds_used: int = 0                 # decode rounds spent on this slot
    admit_attempts: int = 0              # transient admission failures seen


def finish_output(tokens: np.ndarray, eos_id: Optional[int]):
    """Truncate a generated stream at the first ``eos_id`` (inclusive).
    Returns ``(tokens, reason)``: "eos" if an eos fired, else "length"."""
    tokens = np.asarray(tokens)
    if eos_id is not None:
        hits = np.nonzero(tokens == eos_id)[0]
        if hits.size:
            return tokens[: int(hits[0]) + 1], "eos"
    return tokens, "length"


@dataclass
class WaveReport:
    batch: int
    gamma: int
    used_sd: bool
    stats: Optional[SDStats]
    wall_time: float
    tokens_out: int
    proposer: str = "model"
    bucket: int = 0                       # padded batch actually decoded
    moe_dispatch: str = "onehot"          # target's decode dispatch mode
    scheduler: str = "wave"               # "wave" | "continuous"
    steps: Optional[list] = None          # continuous: per-round StepReports
    # continuous: committed tokens of requests that did not finish cleanly
    # (excluded from tokens_out)
    tokens_discarded: int = 0
    finish_reasons: Optional[Dict[str, int]] = None  # reason -> count
    # round keys captured and rounds replayed during this wave / stream
    captures: int = 0
    replays: int = 0
    # wave mode with a tuner: its plan at the bucket, and (an AutoTuner)
    # its alpha before and after the wave's feedback
    plan: Optional[dict] = None
    tuner_alpha: Optional[Tuple[float, float]] = None
    # an "ep" engine on a mesh: the finished outputs' per-rank expert
    # loads, their imbalance (max/mean) and the modeled per-rank
    # all-to-all volume (distributed.collectives.ep_load_report)
    ep: Optional[dict] = None

    @property
    def tokens_per_second(self) -> float:
        return self.tokens_out / max(self.wall_time, 1e-9)

    @property
    def propose_time(self) -> float:
        return self.stats.propose_time if self.stats else 0.0

    @property
    def verify_time(self) -> float:
        return self.stats.verify_time if self.stats else 0.0

    @property
    def reject_time(self) -> float:
        return self.stats.reject_time if self.stats else 0.0

    @property
    def warm_time(self) -> float:
        return self.stats.warm_time if self.stats else 0.0

    # expert-prefetch accounting (prefetch-aware waves; zero otherwise)
    @property
    def prefetch_hits(self) -> int:
        return self.stats.prefetch_hits if self.stats else 0

    @property
    def prefetch_misses(self) -> int:
        return self.stats.prefetch_misses if self.stats else 0

    @property
    def prefetch_hit_rate(self) -> float:
        return self.stats.prefetch_hit_rate if self.stats else 0.0


def _pow2_at_least(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


class ServingEngine:
    def __init__(
        self,
        target: Model,
        draft=None,                         # Model | EagleHead | None
        params_t=None,
        params_d=None,
        *,
        max_batch: int = 32,
        tuner: Optional[AutoTuner] = None,
        gamma: int = 4,
        temperature: float = 0.0,
        force_sd: Optional[bool] = None,
        proposer: str = "model",            # registered proposer kind
        proposer_opts: Optional[dict] = None,  # extra factory kwargs for it
        seed: int = 0,
        timed: bool = False,
        bucket_batches: bool = True,
        scheduler: str = "wave",            # "wave" | "continuous"
        eos_id: Optional[int] = None,       # early-exit token (both modes)
        kv_layout: str = "dense",           # "dense" | "paged" (continuous)
        page_size: int = 64,                # paged: positions per KV page
        prefill_chunk: Optional[int] = None,
        admit_mode: str = "sliced",         # "sliced" | "full"
        prefix_sharing: bool = False,
        admission_order: str = "fifo",      # "fifo" | "pressure" refill order
        resilience: Optional[ResilienceConfig] = None,
        fault_injector=None,
        cuda_graphs: Optional[bool] = None,  # None: capture on a card
        mesh=None,                          # DeviceMesh: sharded serving
        mesh_layout: Optional[str] = None,  # "tp" | "fsdp" (with mesh)
    ):
        if target.cfg.is_encoder_decoder:
            # the reference's engine passes no encoder_embeds and crashes in
            # Model.encode; serve such a target through SDEngine.generate /
            # generate_ar with prefill_kwargs={"encoder_embeds": ...}
            raise ValueError(
                f"ServingEngine cannot serve the encoder-decoder "
                f"{target.cfg.name}: requests carry no encoder frames "
                "(ROADMAP queue 3); use SpecDecoder.generate or generate_ar "
                "with prefill_kwargs={'encoder_embeds': ...}")
        if scheduler not in ("wave", "continuous"):
            raise ValueError(f"scheduler must be 'wave' or 'continuous', "
                             f"got {scheduler!r}")
        if kv_layout not in ("dense", "paged"):
            raise ValueError(f"kv_layout must be 'dense' or 'paged', "
                             f"got {kv_layout!r}")
        if admit_mode not in ("sliced", "full"):
            raise ValueError(f"admit_mode must be 'sliced' or 'full', "
                             f"got {admit_mode!r}")
        if kv_layout == "paged":
            if scheduler != "continuous":
                raise ValueError("kv_layout='paged' is a continuous-serving "
                                 "layout; wave decoding sizes caches per "
                                 "wave already")
            if admit_mode == "full":
                raise ValueError("admit_mode='full' merges same-shape "
                                 "caches and cannot address a paged pool; "
                                 "use the sliced path with paged KV")
        if admission_order not in ("fifo", "pressure"):
            raise ValueError(f"admission_order must be 'fifo' or "
                             f"'pressure', got {admission_order!r}")
        if admission_order == "pressure" and kv_layout != "paged":
            raise ValueError("admission_order='pressure' orders refills by "
                             "page footprint; it requires kv_layout='paged'")
        if prefix_sharing:
            if kv_layout != "paged":
                raise ValueError(
                    "prefix_sharing maps common prompt prefixes to shared "
                    "KV pages; it requires kv_layout='paged' (continuous "
                    "scheduler)")
            bad = [k for k in target.cfg.layer_pattern
                   if k not in ("attn", "mla")]
            if bad:
                raise ValueError(
                    f"prefix_sharing forks block-table pages; target layer "
                    f"kinds {sorted(set(bad))} keep dense per-row state "
                    "(SWA rings / recurrent columns) that a table fork "
                    "cannot share — serve this model without sharing")
        if prefill_chunk is not None:
            if prefill_chunk < 1:
                raise ValueError(f"prefill_chunk must be >= 1, got "
                                 f"{prefill_chunk}")
            if scheduler != "continuous":
                raise ValueError("prefill_chunk interleaves with decode "
                                 "rounds; it requires scheduler="
                                 "'continuous'")
            if (any(k == "swa" for k in target.cfg.layer_pattern)
                    and prefill_chunk > SWA_RING_PAD + 1):
                raise ValueError(
                    f"prefill_chunk={prefill_chunk} > SWA_RING_PAD+1="
                    f"{SWA_RING_PAD + 1}: a larger chunk evicts ring "
                    "entries still inside earlier chunk queries' windows")
        if resilience is None:
            resilience = ResilienceConfig()
        if (resilience.round_deadline_s is not None
                or resilience.max_rounds_per_request is not None
                or fault_injector is not None) and scheduler != "continuous":
            raise ValueError(
                "resilience deadlines and fault injection are continuous-"
                "scheduler features (wave mode has no per-round requeue "
                "path); use scheduler='continuous'")
        # expert-parallel serving: the mesh is threaded explicitly to the
        # target's and the draft's MoE layers and to every session, and
        # each rank keeps its own experts' weights
        if mesh is not None:
            mesh, mesh_layout = resolve_mesh(mesh, mesh_layout)
            if "model" not in mesh_dims(mesh):
                raise ValueError(
                    f"ServingEngine(mesh=...) needs a 'model' axis for the "
                    f"expert dimension; got axes {tuple(mesh_dims(mesh))} "
                    "(launch/mesh.make_ep_mesh builds a ('data','model') "
                    "mesh)")
            for m in (target, draft):
                if isinstance(m, Model) and m.mesh is None:
                    m.mesh, m.mesh_layout = mesh, mesh_layout
            if params_t is not None:
                params_t = shard_params(params_t, mesh, layout=mesh_layout)
            if params_d is not None:
                params_d = shard_params(params_d, mesh, layout=mesh_layout)
        self.mesh = mesh
        self.mesh_layout = mesh_layout
        self.proposer_kind = proposer
        self.proposer_opts = dict(proposer_opts or {})
        self.target, self.draft = target, draft
        self.params_t, self.params_d = params_t, params_d
        self.max_batch = max_batch
        self.gamma = gamma
        self.temperature = temperature
        self.force_sd = force_sd
        self.timed = timed
        self.bucket_batches = bucket_batches
        self.scheduler = scheduler
        self.eos_id = eos_id
        self.kv_layout = kv_layout
        self.page_size = page_size
        self.prefill_chunk = prefill_chunk
        self.prefix_sharing = prefix_sharing
        self.admit_mode = admit_mode
        self.admission_order = admission_order
        self.resilience = resilience
        # a FaultInjector (tests); may be reassigned between streams
        self.fault_injector = fault_injector
        self.cuda_graphs = cuda_graphs
        self.tuner = tuner
        # fault/preemption/recovery counters, filled by the continuous
        # scheduler and surfaced via session_stats()["resilience"]
        self.fault_counters: Dict[str, int] = {}
        self.queue: Deque[Request] = deque()
        self.done: Dict[int, Request] = {}
        self.reports: List[WaveReport] = []
        self._uid = 0
        # one root generator on the target's device; every wave draws from
        # it in turn, so waves never reuse noise
        self._generator = torch.Generator(device=target.device).manual_seed(seed)
        # persistent decoding sessions, one per proposer kind — constructed
        # exactly once and reused for every wave
        self._sessions: Dict[str, SDEngine] = {}
        self.session_constructions: Dict[str, int] = {}
        self._slot_scheduler = None         # lazy ContinuousScheduler

    # ----------------------------------------------------------------- queue
    def submit(self, prompt: np.ndarray, max_new_tokens: int = 64, *,
               sampling: Optional[SamplingParams] = None,
               arrival_round: int = 0) -> int:
        """Queue one request; returns its uid (key into ``self.done``).

        ``temperature`` must equal the engine's and ``top_k``/``top_p`` must
        be off: batched rejection sampling shares one distribution policy
        across the batch, so a mismatch raises.  ``arrival_round``
        (continuous mode) makes the request admissible only from that
        decode round on; wave mode ignores it."""
        sp = sampling if sampling is not None else SamplingParams(
            temperature=self.temperature, max_new_tokens=max_new_tokens)
        if sp.temperature != self.temperature:
            raise ValueError(
                f"per-request temperature {sp.temperature} != engine "
                f"temperature {self.temperature}: batched rejection sampling "
                "shares one temperature across the batch")
        if sp.top_k > 0 or sp.top_p < 1.0:
            raise ValueError(
                "top_k/top_p are not supported on the speculative-decoding "
                "path (rejection sampling needs the full distributions)")
        self._uid += 1
        self.queue.append(Request(self._uid, np.asarray(prompt, np.int32),
                                  sp.max_new_tokens, sp.temperature,
                                  sampling=sp, arrival_round=arrival_round))
        return self._uid

    def _admit(self) -> List[Request]:
        wave = []
        while self.queue and len(wave) < self.max_batch:
            wave.append(self.queue.popleft())
        return wave

    @property
    def moe_dispatch(self) -> str:
        return getattr(self.target, "moe_dispatch", "onehot")

    def _ep_telemetry(self, outputs) -> Optional[dict]:
        """``WaveReport.ep`` over the finished outputs; None unless this is
        an "ep" engine on a mesh."""
        if self.mesh is None or self.moe_dispatch != "ep":
            return None
        toks = [np.asarray(o).reshape(-1) for o in outputs if o is not None]
        toks = np.concatenate(toks) if toks else np.zeros((0,), np.int32)
        with host_crossing():
            return ep_load_report(self.params_t, self.target.cfg, toks,
                                  mesh_dims(self.mesh)["model"])

    # -------------------------------------------------------------- sessions
    def _session(self, kind: str) -> SDEngine:
        """The long-lived decoding session for one proposer kind."""
        sess = self._sessions.get(kind)
        if sess is None:
            # the factory options are the configured kind's, never the
            # "none" session's
            opts = self.proposer_opts if kind == self.proposer_kind else {}
            prop = make_proposer(kind, self.target,
                                 None if kind == "none" else self.draft,
                                 temperature=self.temperature, **opts)
            sess = SDEngine(self.target, prop, gamma=self.gamma,
                            temperature=self.temperature,
                            cuda_graphs=self.cuda_graphs, mesh=self.mesh,
                            mesh_layout=self.mesh_layout)
            self._sessions[kind] = sess
            self.session_constructions[kind] = \
                self.session_constructions.get(kind, 0) + 1
        return sess

    def session_stats(self) -> Dict[str, dict]:
        """Per-proposer-kind session health: ``constructions`` (1 per kind:
        waves reuse sessions), ``gammas_compiled``, ``traces`` (each
        (gamma, batch) the session captured a round key for), ``captures``
        and ``replays`` (round keys captured, rounds replayed; on the CPU
        the first and the later eager runs of a key), ``admit_traces``
        (each (prompt bucket, rows) admission shape), ``growths``
        ((new_max_seq, pool_pages) per paged growth) and ``keys``
        (``SDEngine.round_keys``: (gamma, batch, max_seq) -> (captures,
        replays)), ``prefix_traces`` (each (tail bucket, rows) shape of a
        prefix-shared admission), ``chunk_traces`` (each (stage, chunk,
        rows) shape of a chunked admission) and ``prefetch`` (the session's
        expert-warm totals ``{"hits", "actual", "predicted", "rounds",
        "hit_rate"}``, all 0 unless the kind warms experts).  Plus one
        non-kind entry, ``"resilience"``: the continuous scheduler's
        fault/preemption/recovery counters (empty for a healthy stream)."""
        out: Dict[str, dict] = {"resilience": dict(self.fault_counters)}
        for kind, sess in self._sessions.items():
            totals = dict(sess.prefetch_totals)
            totals["hit_rate"] = totals["hits"] / max(totals["actual"], 1)
            out[kind] = {
                "constructions": self.session_constructions.get(kind, 0),
                "gammas_compiled": sess.compiled_gammas(),
                "traces": list(sess.trace_log),
                "captures": sess.graphs.total_captures,
                "replays": sess.graphs.total_replays,
                "admit_traces": list(sess.admit_trace_log),
                "prefix_traces": list(sess.prefix_trace_log),
                "chunk_traces": list(sess.chunk_trace_log),
                "growths": list(sess.growth_log),
                "keys": sess.round_keys(),
                "prefetch": totals,
            }
        return out

    def _next_generator(self) -> torch.Generator:
        """The engine's root generator: every wave, round and admission
        draws from it in turn, so none reuses another's noise."""
        return self._generator

    # ------------------------------------------------------------------ wave
    def _bucket(self, B: int) -> int:
        if not self.bucket_batches:
            return B
        return min(_pow2_at_least(B), self.max_batch)

    def _pad_prompts(self, wave: List[Request], rows: int):
        """Pad the wave to ``rows`` sequences (bucket) x pow2 prompt length.
        Pad rows replicate real requests round-robin and are discarded
        after decode."""
        T = max(len(r.prompt) for r in wave)
        if self.bucket_batches:
            T = _pow2_at_least(T)
        toks = np.full((rows, T), PAD, np.int32)
        lengths = np.zeros((rows,), np.int32)
        for i in range(rows):
            r = wave[i % len(wave)]
            toks[i, : len(r.prompt)] = r.prompt
            lengths[i] = len(r.prompt)
        return toks, lengths

    def step(self) -> Optional[WaveReport]:
        """Admit and decode one generation wave; returns its report, or
        ``None`` if the queue was empty.  With a tuner, {use_sd, gamma}
        is planned at the padded bucket (the batch that runs), and the
        wave's alpha goes back to it when the wave drafted.
        ``tokens_out`` counts only real generated tokens (per-request
        ``max_new_tokens`` and eos)."""
        wave = self._admit()
        if not wave:
            return None
        B = len(wave)
        bucket = self._bucket(B)
        gamma, use_sd, plan, alpha_in = self.gamma, True, None, None
        if self.tuner is not None:
            plan = self.tuner.plan(bucket)
            alpha_in = self.tuner.alpha
            gamma, use_sd = plan["gamma"], plan["use_sd"]
        if self.force_sd is not None:
            use_sd = self.force_sd
        if self.proposer_kind == "none":
            use_sd = False
        kind = self.proposer_kind if use_sd else "none"
        if not use_sd:
            gamma = 0
        sess = self._session(kind)
        max_new = max(r.max_new_tokens for r in wave)
        toks, lengths = self._pad_prompts(wave, bucket)
        # bucket the cache length too, as the reference does for its jit cache
        max_seq = toks.shape[1] + max_new + gamma + 2
        if self.bucket_batches:
            max_seq = _pow2_at_least(max_seq)

        graphs = sess.graphs
        before = (graphs.total_captures, graphs.total_replays)
        t0 = time.perf_counter()
        out, stats = sess.generate(
            self.params_t, None if kind == "none" else self.params_d,
            toks, max_new, gamma=gamma, max_seq=max_seq, lengths=lengths,
            generator=self._next_generator(), timed=self.timed)
        if use_sd and self.tuner is not None and stats.draft_events:
            self.tuner.update_alpha(stats.alpha)
        wall = time.perf_counter() - t0

        n_tokens = 0
        for i, r in enumerate(wave):                 # pad rows fall off here
            r.output, r.finish_reason = finish_output(
                out[i, : r.max_new_tokens], self.eos_id)
            r.finished_at = time.perf_counter()
            n_tokens += len(r.output)
            self.done[r.uid] = r
        report = WaveReport(B, gamma, use_sd, stats, wall, n_tokens,
                            proposer=kind, bucket=bucket,
                            moe_dispatch=self.moe_dispatch,
                            captures=graphs.total_captures - before[0],
                            replays=graphs.total_replays - before[1],
                            plan=plan,
                            tuner_alpha=None if alpha_in is None
                            else (alpha_in, self.tuner.alpha),
                            ep=self._ep_telemetry([r.output for r in wave]))
        self.reports.append(report)
        return report

    # ------------------------------------------------------------ continuous
    def step_continuous(self) -> Optional[WaveReport]:
        """Serve the queued stream (arrivals included) through the
        continuous slot scheduler; one aggregated report whose ``steps``
        are the per-round StepReports, or ``None`` on an empty queue."""
        from repro_torch.serving.scheduler import ContinuousScheduler
        if self._slot_scheduler is None:
            self._slot_scheduler = ContinuousScheduler(self)
        graphs = self._session(self.proposer_kind).graphs
        before = (graphs.total_captures, graphs.total_replays)
        done_before = set(self.done)
        report = self._slot_scheduler.run_stream()
        if report is not None:
            report.captures = graphs.total_captures - before[0]
            report.replays = graphs.total_replays - before[1]
            report.ep = self._ep_telemetry(
                [r.output for uid, r in self.done.items()
                 if uid not in done_before])
            self.reports.append(report)
        return report

    def run(self) -> List[WaveReport]:
        """Drain the queue under the configured scheduler."""
        step = self.step_continuous if self.scheduler == "continuous" \
            else self.step
        reports = []
        while self.queue:
            r = step()
            if r:
                reports.append(r)
        return reports
