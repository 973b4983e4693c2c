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

The reference jits one fused round per gamma and logs every retrace.  This
port runs eagerly: a round is the same four steps with no host sync until
the round's results are read, and ``trace_log`` records each (gamma, batch)
the first time it runs with a new shape, where the reference would trace.
CUDA graphs are later work.  Admission (continuous batching) is a later
slice.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, replace
from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.core.proposer import Proposer, make_proposer
from repro_torch.core.rejection import probs_from_logits, rejection_sample, sample_from
from repro_torch.models.model import Model
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
    ``start`` the prefill-sampled first generated token)."""
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


class SDEngine:
    """One persistent decoding session: a target model + one Proposer."""

    def __init__(self, target: Model, proposer: Proposer, *,
                 gamma: int = 4, temperature: float = 0.0):
        self.target = target
        self.proposer = proposer
        self.gamma = gamma
        self.temperature = temperature
        self.trace_log: List[Tuple[int, int]] = []       # (gamma, B) per new shape
        self._shapes: Set[Tuple[int, int, int]] = set()

    def compiled_gammas(self) -> List[int]:
        """Gammas this session has run a round for."""
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

    # --------------------------------------------------------------- prefill
    def prefill(self, params_t, params_p, prompts, max_seq: int, *,
                lengths=None, generator: Optional[torch.Generator] = None):
        """Prefill target + proposer; returns (t_cache, p_state, last_token)."""
        dev = self.target.device
        params = {"target": params_t, "draft": params_p}
        prompts = torch.as_tensor(prompts, dtype=torch.int64, device=dev)
        if lengths is not None:
            lengths = torch.as_tensor(lengths, dtype=torch.int32, device=dev)
        t_cache = self.target.init_cache(prompts.shape[0], max_seq)
        last_l, t_cache = self.target.prefill(params_t, prompts, t_cache,
                                              lengths=lengths)
        p_state = self.proposer.init_state(params, prompts, max_seq,
                                           lengths=lengths)
        p = probs_from_logits(last_l, self.temperature)
        return t_cache, p_state, sample_from(p, generator, self.temperature)

    # --------------------------------------------------------------- session
    def start(self, params_t, params_p, prompts, *, max_seq: int,
              lengths=None, generator: Optional[torch.Generator] = None
              ) -> SessionState:
        """Open a decoding batch: prefill + cache alloc → ``SessionState``."""
        t_cache, p_state, last_token = self.prefill(
            params_t, params_p, prompts, max_seq, lengths=lengths,
            generator=generator)
        return SessionState(params={"target": params_t, "draft": params_p},
                            t_cache=t_cache, p_state=p_state,
                            last_token=last_token, max_seq=max_seq)

    def round(self, state: SessionState, *, gamma: Optional[int] = None,
              generator: Optional[torch.Generator] = None, active=None,
              timed: bool = False) -> Tuple[SessionState, RoundResult]:
        """Run ONE propose/verify/reject/commit round on a live session.

        ``active`` (B,) bool: inactive rows commit 0 tokens.  ``timed``
        synchronises the device between phases to fill ``phase_times``;
        otherwise the round runs without a host sync until its results
        are read at the end."""
        gamma = self.gamma if gamma is None else gamma
        if generator is None and self.temperature > 0.0:
            raise ValueError("round() needs a generator at temperature>0")
        dev = self.target.device
        B = state.batch
        shape = (gamma, B, state.max_seq)
        if shape not in self._shapes:
            self._shapes.add(shape)
            self.trace_log.append((gamma, B))
        active = (torch.ones((B,), dtype=torch.bool, device=dev)
                  if active is None else
                  torch.as_tensor(np.asarray(active, bool), device=dev))
        params = state.params
        phases: Dict[str, float] = {}
        t_round = time.perf_counter()
        base_len = state.t_cache["lengths"]
        t0 = time.perf_counter()
        drafts, q_dist, p_work = self.proposer.propose(
            params, state.p_state, state.last_token, gamma, generator)
        if timed:
            _sync(dev)
            phases["propose"] = time.perf_counter() - t0
            t0 = time.perf_counter()
        p_dist, pend, finite = self._verify(params["target"], state.t_cache,
                                            state.last_token, drafts)
        if timed:
            _sync(dev)
            phases["verify"] = time.perf_counter() - t0
            t0 = time.perf_counter()
        t_cache, p_state, last_token, committed, n_commit, n_acc = \
            self._finalize(params, pend, p_work, base_len, p_dist, q_dist,
                           drafts, state.last_token, active, finite,
                           generator)
        if timed:
            _sync(dev)
            phases["reject"] = time.perf_counter() - t0
        committed = committed.cpu().numpy()            # device sync
        n_commit_np = n_commit.cpu().numpy()
        round_time = time.perf_counter() - t_round
        new_state = replace(state, t_cache=t_cache, p_state=p_state,
                            last_token=last_token)
        result = RoundResult(
            committed=committed, n_commit=n_commit_np,
            n_accept=n_acc.cpu().numpy(), width=committed.shape[1] - 1,
            gamma=gamma, round_time=round_time,
            phase_times=phases if timed else None,
            finite=finite.cpu().numpy())
        return new_state, result

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
