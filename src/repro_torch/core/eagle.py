"""EAGLE-style speculation head (arXiv:2401.15077): the paper's second SD
configuration (its Mixtral experiments draft with an EAGLE head).

Port of ``repro.core.eagle``.  The draft is one transformer block grafted
onto the TARGET's feature stream:

    f̂_{t+1} = Block( W_fuse [ embed(x_{t+1}) ; f_t ] )
    p̂(x_{t+2}) = TargetHead( f̂_{t+1} )

where f_t is the target's final hidden state at the last verified position.
A propose chain feeds the block its own predicted features; each verify
refreshes f from the target's real features (``needs_hidden``: the engine
hands ``commit`` the verify pass's hidden states).  The head reuses the
target's embedding and unembedding; its own parameters are the fusion
matrix and one dense ``"attn"`` block (``eagle_head_config``).  Greedy
output equals the target's AR output by construction.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.proposer import register_proposer, stack_drafts
from repro_torch.core.rejection import probs_from_logits, sample_from
from repro_torch.core.spec_decode import SDEngine
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import dense_init
from repro_torch.models.model import (Model, grow_cache_seq, merge_cache_rows,
                                      scatter_cache_rows)


def eagle_head_config(cfg: ModelConfig) -> ModelConfig:
    """The head's block for a target config: one dense-FFN ``"attn"`` layer
    in the target's width (drafts are dense, paper Sec. 3.3), as the
    reference derives it.  A plain function of the config, so the tuner
    can price the head without building a model."""
    return cfg.with_overrides(
        name=f"{cfg.name}-eagle", num_layers=1, layer_pattern=("attn",),
        moe_pattern=(False,), num_experts=0, num_experts_per_tok=0,
        d_ff=4 * cfg.d_model, num_heads=max(4, cfg.num_heads // 4),
        num_kv_heads=max(2, cfg.num_kv_heads // 4), head_dim=64)


class EagleHead:
    """One-block speculation head bound to a target ``Model``; it lives on
    the target's device, in the target's dtype."""

    def __init__(self, target: Model):
        self.target = target
        self.cfg = eagle_head_config(target.cfg)
        H, Hkv = self.cfg.num_heads, self.cfg.num_kv_heads
        if H % Hkv:
            raise ValueError(
                f"{target.cfg.name}: its EAGLE head would have {H} query "
                f"heads over {Hkv} KV heads (max(4, {target.cfg.num_heads} "
                f"// 4) over max(2, {target.cfg.num_kv_heads} // 4)), which "
                "do not group; the reference's head fails on the same counts "
                "(ROADMAP queue 3)")
        # the head's KV cache has a one-layer model's layout
        self._block = Model(self.cfg, device=target.device)

    @property
    def device(self) -> torch.device:
        return self.target.device

    def init(self, generator: torch.Generator) -> dict:
        """Random head parameters (``{"fuse", "layers"}``) from
        ``generator``, on the target's device."""
        cfg, dt = self.cfg, self.target.dtype
        kw = dict(generator=generator, device=self.device)
        return {"fuse": dense_init((2 * cfg.d_model, cfg.d_model), dt, **kw),
                "layers": tfm.init_stack(cfg, dt, **kw)}

    def init_cache(self, batch: int, max_seq: int, *,
                   reuse: Optional[dict] = None) -> dict:
        """The head's dense KV cache (``Model.init_cache``'s layout; a
        ``reuse`` cache of this shape is reset in place)."""
        return self._block.init_cache(batch, max_seq, reuse=reuse)

    def step(self, params_target, params, feat: torch.Tensor,
             token: torch.Tensor, cache: dict):
        """One propose step: (feature (B, d) at pos-1, token (B,) at pos) →
        (next-token logits (B, V), predicted next feature (B, d), cache
        with ``lengths`` + 1).  The token's K/V is written in place."""
        tgt = self.target
        positions = cache["lengths"].to(torch.int64)[:, None]
        emb = tgt._embed(params_target, token.to(torch.int64)[:, None],
                         positions)
        x = torch.cat([emb[:, 0], feat.to(emb.dtype)], dim=-1)
        x = (x @ params["fuse"])[:, None]                       # (B, 1, d)
        x, _, _ = tfm.stack_forward(params["layers"], self.cfg, x, positions,
                                 cache["layers"], mode="extend")
        logits = tgt._head(params_target, x)[:, 0]             # tied head
        return logits, x[:, 0], dict(cache, lengths=cache["lengths"] + 1)


@register_proposer("eagle")
class EagleProposer:
    """Chains an ``EagleHead`` on its own predicted features.

    State: ``{"cache": head KV cache, "feat": (B, d) feature carry}``; the
    carry starts from the target prefill's last hidden state and is
    refreshed every round from the verify pass."""

    kind = "eagle"
    needs_hidden = True

    def __init__(self, target: Model, draft: Optional[EagleHead] = None,
                 temperature: float = 0.0):
        if target.cfg.is_recurrent:
            raise ValueError("the EAGLE feature carry assumes an attention "
                             "target")
        if draft is not None and not isinstance(draft, EagleHead):
            raise TypeError("EagleProposer draft must be an EagleHead "
                            f"(got {type(draft).__name__})")
        self.target = target
        self.head = draft if draft is not None else EagleHead(target)
        self.temperature = temperature

    def init_state(self, params, prompts, max_seq, *, lengths=None,
                   reuse=None, last_hidden=None):
        B, T = prompts.shape
        cache = self.head.init_cache(
            B, max_seq, reuse=None if reuse is None else reuse["cache"])
        if lengths is None:
            lengths = torch.full((B,), T, dtype=torch.int32,
                                 device=self.head.device)
        return {"cache": dict(cache, lengths=lengths.to(torch.int32)),
                "feat": last_hidden}

    def propose(self, params, state, last_token, gamma, generator):
        feat, token, ec = state["feat"], last_token, state["cache"]
        qs, ds = [], []
        for _ in range(gamma):
            logits, feat, ec = self.head.step(params["target"],
                                              params["draft"], feat, token, ec)
            q = probs_from_logits(logits, self.temperature)
            token = sample_from(q, generator, self.temperature)
            qs.append(q)
            ds.append(token)
        drafts, q_dist = stack_drafts(ds, qs, last_token.shape[0],
                                      self.target.cfg.vocab_size,
                                      last_token.device)
        return drafts, q_dist, {"cache": ec, "feat": state["feat"]}

    def commit(self, params, state, *, base_len, n_accept, n_commit,
               verify_tokens, hidden):
        # lengths roll back (stale K/V are position-masked); the carry
        # becomes the target's hidden state at the last accepted position
        B = hidden.shape[0]
        feat = hidden[torch.arange(B, device=hidden.device),
                      n_accept.to(torch.int64)]
        return {"cache": dict(state["cache"], lengths=base_len + n_commit),
                "feat": feat}

    def merge_state(self, old, new, mask):
        """Admission merge, in place: head KV rows and feature carry."""
        rows = torch.as_tensor(np.nonzero(np.asarray(mask, bool))[0],
                               device=old["feat"].device)
        old["feat"][rows] = new["feat"][rows]
        return {"cache": merge_cache_rows(old["cache"], new["cache"], mask),
                "feat": old["feat"]}

    def scatter_state(self, old, new, rows, *, valid=None):
        """Sliced admission, in place: head KV rows and feature carry; pad
        lanes (``valid`` False) are dropped on the host."""
        rows = np.asarray(rows, np.int64)
        keep = (np.arange(rows.shape[0]) if valid is None
                else np.nonzero(np.asarray(valid, bool))[0])
        dev = old["feat"].device
        old["feat"][torch.as_tensor(rows[keep], device=dev)] = \
            new["feat"][torch.as_tensor(keep, device=dev)]
        return {"cache": scatter_cache_rows(old["cache"], new["cache"], rows,
                                            valid=valid),
                "feat": old["feat"]}

    def grow_state(self, state, new_max_seq):
        """Pad the head's KV cache on session growth (the carry has no
        sequence axis)."""
        return {"cache": grow_cache_seq(state["cache"], self.head.cfg,
                                        new_max_seq),
                "feat": state["feat"]}


class EagleSpecDecoder(SDEngine):
    """Legacy shim: target + ``EagleHead`` == ``SDEngine("eagle")``.

    Prefer ``SDEngine(target, make_proposer("eagle", target, head))``."""

    def __init__(self, target: Model, head: EagleHead, gamma: int = 4,
                 temperature: float = 0.0):
        super().__init__(target,
                         EagleProposer(target, head, temperature=temperature),
                         gamma=gamma, temperature=temperature)
        self.head = head
