"""Proposer API — the drafting seam of the SD engine.

Port of ``repro.core.proposer`` for the drafters this slice serves:
``"model"`` (a small attention draft model, the paper's configuration) and
``"none"`` (zero drafts: the AR baseline).  ``params`` is always the dict
``{"target": params_t, "draft": params_p}``.

  * ``init_state(params, prompts, max_seq, *, lengths, reuse)`` → state
    (the draft cache), built once per generation after the target prefill;
    ``reuse`` is a state of the same shape to reset and fill in place.
  * ``propose(params, state, last_token, gamma, generator)`` →
    ``(drafts (B, g), q_dist (B, g, V), work_state)`` with g <= gamma.
  * ``commit(params, state, *, base_len, n_accept, n_commit,
    verify_tokens, hidden)`` → state reconciled to the accepted prefix.

Continuous-batching hooks:

  * ``merge_state(old, new, mask)`` — full-pool admission merge;
  * ``scatter_state(old, new, rows, *, valid)`` — sliced admission scatter;
  * ``grow_state(state, new_max_seq)`` — pad on paged-session growth.

The ``eagle``/``prefetch`` drafters are later slices.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Protocol, Tuple, runtime_checkable

import torch

from repro_torch.core.rejection import probs_from_logits, sample_from
from repro_torch.models.model import (grow_cache_seq, merge_cache_rows,
                                      scatter_cache_rows)


def stack_drafts(ds, qs, batch: int, vocab: int, device):
    """Stack per-step draft tokens/distributions into (B, g) / (B, g, V),
    handling the zero-step (g=0) case."""
    drafts = (torch.stack(ds, dim=1) if ds
              else torch.zeros((batch, 0), dtype=torch.int32, device=device))
    q_dist = (torch.stack(qs, dim=1) if qs
              else torch.zeros((batch, 0, vocab), dtype=torch.float32,
                               device=device))
    return drafts, q_dist


@runtime_checkable
class Proposer(Protocol):
    """Structural protocol every drafter implements (see module docstring).
    ``kind`` is the registry string; ``needs_hidden`` says whether the
    engine must hand the proposer the target's hidden states."""

    kind: str
    needs_hidden: bool

    def init_state(self, params: dict, prompts: torch.Tensor, max_seq: int, *,
                   lengths: Optional[torch.Tensor] = None,
                   reuse: Any = None) -> Any:
        ...

    def propose(self, params: dict, state: Any, last_token: torch.Tensor,
                gamma: int, generator: Optional[torch.Generator]
                ) -> Tuple[torch.Tensor, torch.Tensor, Any]:
        ...

    def commit(self, params: dict, state: Any, *, base_len: torch.Tensor,
               n_accept: torch.Tensor, n_commit: torch.Tensor,
               verify_tokens: torch.Tensor,
               hidden: Optional[torch.Tensor]) -> Any:
        ...


_REGISTRY: Dict[str, Callable[..., "Proposer"]] = {}


def register_proposer(name: str, factory: Optional[Callable] = None):
    """Register ``factory(target, draft, temperature) -> Proposer``, directly
    or as a decorator."""
    def _register(f):
        _REGISTRY[name] = f
        return f

    return _register(factory) if factory is not None else _register


def registered_proposers() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def make_proposer(kind: str, target, draft=None, *,
                  temperature: float = 0.0, **opts) -> "Proposer":
    """Build a registered proposer by name."""
    if kind not in _REGISTRY:
        raise KeyError(
            f"unknown proposer {kind!r}; registered: {registered_proposers()}")
    return _REGISTRY[kind](target, draft, temperature=temperature, **opts)


class ModelProposer:
    """Drafts with an autoregressive small attention model (paper Sec. 3.1).
    State: ``{"cache": draft_cache}``."""

    kind = "model"
    needs_hidden = False

    def __init__(self, target, draft, temperature: float = 0.0):
        if draft is None:
            raise ValueError("ModelProposer requires a draft Model")
        if draft.cfg.is_recurrent:
            raise NotImplementedError(
                "recurrent drafts are ROADMAP queue 1 item 9")
        self.draft = draft
        self.temperature = temperature

    def init_state(self, params, prompts, max_seq, *, lengths=None,
                   reuse=None):
        """Prefill the draft cache: a fresh one, or ``reuse``'s (a state of
        the same shape) reset in place."""
        cache = self.draft.init_cache(
            prompts.shape[0], max_seq,
            reuse=None if reuse is None else reuse["cache"])
        _, cache = self.draft.prefill(params["draft"], prompts, cache,
                                      lengths=lengths)
        return {"cache": cache}

    def propose(self, params, state, last_token, gamma, generator):
        """gamma single-token draft forwards + one extra that writes the
        last draft's KV so the cache is complete on full acceptance."""
        params_d = params["draft"]
        c = state["cache"]
        token = last_token
        qs, ds = [], []
        for _ in range(gamma):
            logits, c = self.draft.extend(params_d, token[:, None], c)
            c = dict(c, lengths=c["lengths"] + 1)
            q = probs_from_logits(logits[:, 0], self.temperature)
            token = sample_from(q, generator, self.temperature)
            qs.append(q)
            ds.append(token)
        _, c = self.draft.extend(params_d, token[:, None], c)
        drafts, q_dist = stack_drafts(ds, qs, last_token.shape[0],
                                      self.draft.cfg.vocab_size,
                                      last_token.device)
        return drafts, q_dist, {"cache": c}

    def commit(self, params, state, *, base_len, n_accept, n_commit,
               verify_tokens, hidden):
        # attention cache: rejected-suffix KV left stale (position-masked)
        return {"cache": dict(state["cache"], lengths=base_len + n_commit)}

    def merge_state(self, old, new, mask):
        """Admission merge, in place: the draft cache follows the
        model-cache layout, so row selection is the target's primitive."""
        return {"cache": merge_cache_rows(old["cache"], new["cache"], mask)}

    def scatter_state(self, old, new, rows, *, valid=None):
        """Sliced admission: row-scatter the compact draft cache."""
        return {"cache": scatter_cache_rows(old["cache"], new["cache"],
                                            rows, valid=valid)}

    def grow_state(self, state, new_max_seq):
        """Raise the draft cache's capacity on session growth."""
        return {"cache": grow_cache_seq(state["cache"], self.draft.cfg,
                                        new_max_seq)}


class NoneProposer:
    """Zero-width proposer: the round degenerates to one target forward of
    ``last_token`` and a sample from its distribution — exactly the AR
    baseline, sharing the engine loop and SDStats with real SD."""

    kind = "none"
    needs_hidden = False

    def __init__(self, target, draft=None, temperature: float = 0.0):
        self.vocab_size = target.cfg.vocab_size

    def init_state(self, params, prompts, max_seq, *, lengths=None,
                   reuse=None):
        return None

    def propose(self, params, state, last_token, gamma, generator):
        B = last_token.shape[0]
        dev = last_token.device
        return (torch.zeros((B, 0), dtype=torch.int32, device=dev),
                torch.zeros((B, 0, self.vocab_size), dtype=torch.float32,
                            device=dev), state)

    def commit(self, params, state, *, base_len, n_accept, n_commit,
               verify_tokens, hidden):
        return state

    def merge_state(self, old, new, mask):
        """Stateless drafter: nothing to merge on admission."""
        return old

    def scatter_state(self, old, new, rows, *, valid=None):
        """Stateless drafter: nothing to scatter on admission."""
        return old

    def grow_state(self, state, new_max_seq):
        """Stateless drafter: nothing to grow."""
        return state


register_proposer("model", ModelProposer)
register_proposer("none", NoneProposer)
