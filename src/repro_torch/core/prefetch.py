"""Prefetch-aware proposer (SP-MoE, arXiv:2510.10302): warm the target's
expert weights during the draft phase.

Port of ``repro.core.prefetch``.  At moderate batch sizes a sparse MoE
target's verify pass streams only the weights of the experts its tokens
route to.  The draft stream names the tokens the next verify will process,
so a cheap probe of the target's routers over them predicts which experts
verify will hit.  ``PrefetchProposer`` wraps the draft-model drafter:

  1. PROPOSE — delegate to a ``ModelProposer`` (same drafts, same
     distributions, same generator draws, so greedy tokens equal the
     "model" proposer's).
  2. PROBE   — embed the round's speculated stream [last_token, drafts]
     with the target's table and push it through every MoE layer's router
     (fp32); the top-M experts by votes per layer become a
     ``models/moe.PrefetchPlan`` in the work state.
  3. WARM    — the engine (``core/spec_decode.py``) gathers the plan's
     experts' weights (``models/moe.warm_experts``) into fixed buffers
     between propose and verify.
  4. SCORE   — verify runs through ``Model.extend_with_prefetch``, which
     counts hits (activated and warmed) against misses on the device; the
     counts come back with the round's one readback.

The probe and the warm gather are plain torch, as the reference computes
them outside any Pallas kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.proposer import ModelProposer, register_proposer
from repro_torch.models.moe import PrefetchPlan


def _top(score: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest entries of the last axis, ties to the
    lower index (``lax.top_k``'s order; ``torch.topk`` promises none)."""
    return torch.sort(score, dim=-1, descending=True, stable=True)[1][..., :k]


def router_probe(params_t: dict, cfg, tokens: torch.Tensor, *,
                 top_m: int, shard=None) -> PrefetchPlan:
    """Predict the experts a verify pass over ``tokens`` (B, T) will
    activate: per MoE layer, each router applied to the raw token
    embeddings (the stand-in for that layer's hidden states), top-K
    routing per token, then the top-M experts by vote count with the mean
    router probability as the tie-break.  A dense layer gets an all-False
    mask and no ids.  Everything stays on the device.  A vocab-parallel
    embedding (``shard``'s placement, the target's) is looked up across
    the ranks."""
    E = max(cfg.num_experts, 1)
    K = max(cfg.num_experts_per_tok, 1)
    dev = tokens.device
    ids = tokens.reshape(-1).to(torch.int64)
    table = params_t["embed"]["table"]
    if shard is not None and shard.blocked("embed/table"):   # a vocab block
        from repro_torch.distributed import collectives as col
        x = col.vocab_embed(table, ids, shard)
    else:
        x = table[ids]
    x = x.float()                                                # (N, d)
    masks, ids = [], []
    for l in range(cfg.num_layers):
        if not cfg.moe_pattern[l % cfg.period]:
            masks.append(torch.zeros((E,), dtype=torch.bool, device=dev))
            ids.append(torch.zeros((0,), dtype=torch.int64, device=dev))
            continue
        router = params_t["layers"][l]["ffn"]["router"]          # (d, E)
        probs = torch.softmax(x @ router, dim=-1)                # (N, E)
        # scatter-add votes: no (N, K, E) one-hot on the propose path
        votes = torch.zeros((E,), dtype=torch.float32, device=dev)
        votes.scatter_add_(0, _top(probs, K).reshape(-1),
                           torch.ones((probs.shape[0] * K,), device=dev))
        top_ids = _top(votes + probs.mean(0), top_m)             # (M,)
        masks.append(torch.zeros((E,), dtype=torch.bool, device=dev)
                     .scatter_(0, top_ids, True))
        ids.append(top_ids)
    return PrefetchPlan(masks=tuple(masks), expert_ids=tuple(ids))


class PrefetchProposer:
    """The draft model's drafter with draft-phase expert warming (module
    docstring).

    Drafting is delegated entirely to a ``ModelProposer`` over ``draft``;
    the wrapper adds the router probe to
    ``propose`` (the plan rides in the round's work state under "plan")
    and sets ``provides_prefetch``, so the engine runs the warm and scored
    verify stages.  ``top_m`` (default ``min(E, 2K)``) is clamped to
    [1, E]."""

    kind = "prefetch"
    needs_hidden = False
    provides_prefetch = True

    def __init__(self, target, draft, temperature: float = 0.0, *,
                 top_m: Optional[int] = None):
        self.target = target
        self.draft = draft
        self.inner = ModelProposer(target, draft, temperature=temperature)
        cfg = target.cfg
        E, K = max(cfg.num_experts, 1), max(cfg.num_experts_per_tok, 1)
        self.top_m = (min(E, max(1, int(top_m))) if top_m is not None
                      else min(E, 2 * K))

    def init_state(self, params, prompts, max_seq, *, lengths=None,
                   reuse=None, last_hidden=None):
        return {"inner": self.inner.init_state(
            params, prompts, max_seq, lengths=lengths,
            reuse=None if reuse is None else reuse["inner"])}

    def propose(self, params, state, last_token, gamma, generator):
        drafts, q_dist, work = self.inner.propose(
            params, state["inner"], last_token, gamma, generator)
        # this round's draft stream is the coming verify stream: probe it
        stream = torch.cat([last_token[:, None].to(drafts.dtype), drafts], 1)
        plan = router_probe(params["target"], self.target.cfg, stream,
                            shard=self.target._shard(),
                            top_m=self.top_m)
        return drafts, q_dist, {"inner": work, "plan": plan}

    def commit(self, params, state, *, base_len, n_accept, n_commit,
               verify_tokens, hidden):
        return {"inner": self.inner.commit(
            params, state["inner"], base_len=base_len, n_accept=n_accept,
            n_commit=n_commit, verify_tokens=verify_tokens, hidden=hidden)}

    def merge_state(self, old, new, mask):
        """Admission merge, delegated (the plan is round work state)."""
        return {"inner": self.inner.merge_state(old["inner"], new["inner"],
                                                mask)}

    def scatter_state(self, old, new, rows, *, valid=None):
        """Sliced admission, delegated to the wrapped drafter."""
        return {"inner": self.inner.scatter_state(old["inner"], new["inner"],
                                                  rows, valid=valid)}

    def grow_state(self, state, new_max_seq):
        """Session growth, delegated to the wrapped drafter."""
        return {"inner": self.inner.grow_state(state["inner"], new_max_seq)}


register_proposer("prefetch", PrefetchProposer)
