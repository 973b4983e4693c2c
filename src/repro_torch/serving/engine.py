"""Serving engine: request queue → batched speculative decoding → completions.

Port of ``repro.serving.engine`` with the ``"wave"`` scheduler: admit up to
``max_batch`` requests per generation wave (static batch per wave,
continuous across waves) and run SD rounds until EVERY sequence in the wave
is done.  Finished rows ride along as padding until the slowest request
completes.

The engine holds ONE persistent decoding session (``SDEngine``) per
proposer kind, reused across waves.  Batches are padded to power-of-two
buckets with round-robin replicas of real requests, and cache lengths are
bucketed too, as in the reference.

Not ported yet: the AutoTuner (ROADMAP queue 1 item 5, next slice) and the
continuous scheduler with paged KV (queue 1 item 7).
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.proposer import make_proposer
from repro_torch.core.spec_decode import SDEngine, SDStats
from repro_torch.data.tokenizer import PAD
from repro_torch.models.model import Model
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
    finish_reason: Optional[str] = None  # "length" | "eos"


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
    scheduler: str = "wave"

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


def _pow2_at_least(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


class ServingEngine:
    def __init__(
        self,
        target: Model,
        draft: Optional[Model] = None,
        params_t=None,
        params_d=None,
        *,
        max_batch: int = 32,
        gamma: int = 4,
        temperature: float = 0.0,
        force_sd: Optional[bool] = None,
        proposer: str = "model",            # registered proposer kind
        seed: int = 0,
        timed: bool = False,
        bucket_batches: bool = True,
        scheduler: str = "wave",
        eos_id: Optional[int] = None,
    ):
        if scheduler != "wave":
            raise NotImplementedError(
                f"scheduler {scheduler!r}: the continuous scheduler is ROADMAP "
                "queue 1 item 7; this slice serves 'wave'")
        self.proposer_kind = proposer
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

    # ----------------------------------------------------------------- queue
    def submit(self, prompt: np.ndarray, max_new_tokens: int = 64, *,
               sampling: Optional[SamplingParams] = None) -> int:
        """Queue one request; returns its uid (key into ``self.done``).

        ``temperature`` must equal the engine's and ``top_k``/``top_p`` must
        be off: batched rejection sampling shares one distribution policy
        across the batch, so a mismatch raises."""
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
                                  sampling=sp))
        return self._uid

    def _admit(self) -> List[Request]:
        wave = []
        while self.queue and len(wave) < self.max_batch:
            wave.append(self.queue.popleft())
        return wave

    @property
    def moe_dispatch(self) -> str:
        return getattr(self.target, "moe_dispatch", "onehot")

    # -------------------------------------------------------------- sessions
    def _session(self, kind: str) -> SDEngine:
        """The long-lived decoding session for one proposer kind."""
        sess = self._sessions.get(kind)
        if sess is None:
            prop = make_proposer(kind, self.target,
                                 None if kind == "none" else self.draft,
                                 temperature=self.temperature)
            sess = SDEngine(self.target, prop, gamma=self.gamma,
                            temperature=self.temperature)
            self._sessions[kind] = sess
            self.session_constructions[kind] = \
                self.session_constructions.get(kind, 0) + 1
        return sess

    def session_stats(self) -> Dict[str, dict]:
        """Per-proposer-kind session health: ``constructions`` (1 per kind:
        waves reuse sessions), ``gammas_compiled`` and ``traces`` (each
        (gamma, batch) the session first ran with a new shape)."""
        return {kind: {"constructions": self.session_constructions.get(kind, 0),
                       "gammas_compiled": sess.compiled_gammas(),
                       "traces": list(sess.trace_log)}
                for kind, sess in self._sessions.items()}

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
        ``None`` if the queue was empty.  ``tokens_out`` counts only real
        generated tokens (per-request ``max_new_tokens`` and eos)."""
        wave = self._admit()
        if not wave:
            return None
        B = len(wave)
        bucket = self._bucket(B)
        use_sd = True if self.force_sd is None else self.force_sd
        if self.proposer_kind == "none":
            use_sd = False
        kind = self.proposer_kind if use_sd else "none"
        gamma = self.gamma if use_sd else 0
        sess = self._session(kind)
        max_new = max(r.max_new_tokens for r in wave)
        toks, lengths = self._pad_prompts(wave, bucket)
        # bucket the cache length too, as the reference does for its jit cache
        max_seq = toks.shape[1] + max_new + gamma + 2
        if self.bucket_batches:
            max_seq = _pow2_at_least(max_seq)

        t0 = time.perf_counter()
        out, stats = sess.generate(
            self.params_t, None if kind == "none" else self.params_d,
            toks, max_new, gamma=gamma, max_seq=max_seq, lengths=lengths,
            generator=self._generator, timed=self.timed)
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
                            moe_dispatch=self.moe_dispatch)
        self.reports.append(report)
        return report

    def run(self) -> List[WaveReport]:
        """Drain the queue, one wave at a time."""
        reports = []
        while self.queue:
            r = self.step()
            if r:
                reports.append(r)
        return reports
