"""Decoder-only language model: embedding → decoder stack → head.

Port of ``repro.models.model.Model`` for decoder-only attention configs:

    model  = Model(cfg, moe_dispatch="gmm")            # device="cuda" default
    params = model.init(torch.Generator(model.device).manual_seed(0))
    cache  = model.init_cache(batch, max_seq)
    logits, cache = model.prefill(params, tokens, cache, lengths=...)
    logits, pend  = model.extend(params, tokens, cache)
    cache  = model.commit(pend, n_commit)

Cache layout::

    {"layers": [{"k", "v"} per layer], "lengths": (B,) int32}

``extend`` consumes T tokens per sequence at offsets ``lengths`` — T=1 is
plain decode, T=gamma+1 a speculative-decoding verify pass — and writes
their K/V into the cache in place; ``commit`` bumps ``lengths`` (stale
entries of a rejected suffix are masked by position, see attention.py).

``params["layers"]`` is a list with one block per layer; the reference
stacks each period slot's leaves over ``num_periods`` instead
(``models/convert.py`` maps one layout onto the other).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import (apply_norm, embed, init_embedding,
                                       init_norm, unembed)


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[cfg.dtype]


class Model:
    """Decoder-only language model on one device."""

    def __init__(self, cfg: ModelConfig, *, moe_dispatch: str = "onehot",
                 use_flash: bool = False, device=None):
        if cfg.is_encoder_decoder or cfg.is_recurrent:
            raise NotImplementedError(
                f"{cfg.name}: encoder-decoder and recurrent stacks are ROADMAP "
                "queue 1 item 9; this slice ports decoder-only attention")
        self.cfg = cfg
        self.moe_dispatch = moe_dispatch
        self.use_flash = use_flash
        self.device = resolve_device(device)
        self.dtype = torch_dtype(cfg)
        # target/draft forward passes run (prefill + extend), for callers
        # that check how many times each kernel of a forward must launch
        self.forward_count = 0

    # ------------------------------------------------------------------ init
    def init(self, generator: torch.Generator) -> dict:
        """Random parameters on ``self.device`` drawn from ``generator``
        (which must live on the same device)."""
        cfg, dt = self.cfg, self.dtype
        kw = dict(generator=generator, device=self.device)
        params: Dict[str, Any] = {
            "embed": init_embedding(cfg.vocab_size, cfg.d_model, dt, **kw),
            "final_norm": init_norm(cfg, dt, self.device),
            "layers": tfm.init_stack(cfg, dt, **kw),
        }
        if not cfg.tie_embeddings:
            params["head"] = init_embedding(cfg.vocab_size, cfg.d_model, dt, **kw)
        return params

    # ----------------------------------------------------------------- embed
    def _embed(self, params, tokens):
        return embed(params["embed"], tokens,
                     scale=self.cfg.name.startswith("gemma"))

    def _head(self, params, x):
        cfg = self.cfg
        x = apply_norm(params["final_norm"], x, cfg.norm_eps)
        table = params["embed"] if cfg.tie_embeddings else params["head"]
        return unembed(table, x, cfg.final_logit_softcap)

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, dtype=torch.int64, device=self.device)

    # ----------------------------------------------------------------- cache
    def init_cache(self, batch: int, max_seq: int, *,
                   paged: bool = False) -> dict:
        """Dense decode cache: every attention layer holds (B, max_seq) K/V
        (plus the trash slot of attention.make_attn_cache)."""
        return {
            "layers": tfm.make_stack_cache(self.cfg, batch, max_seq,
                                           self.dtype, self.device,
                                           paged=paged),
            "lengths": torch.zeros((batch,), dtype=torch.int32,
                                   device=self.device),
        }

    # --------------------------------------------------------------- prefill
    def prefill(self, params, tokens, cache: dict, *,
                lengths=None) -> Tuple[torch.Tensor, dict]:
        """Prefill padded prompts (B, T); returns the logits at each
        sequence's last prompt position (B, V) and the filled cache."""
        tokens = self._tokens(tokens)
        B, T = tokens.shape
        if lengths is None:
            lengths = torch.full((B,), T, dtype=torch.int32, device=self.device)
        lengths = torch.as_tensor(lengths, dtype=torch.int32, device=self.device)
        positions = torch.arange(T, device=self.device)[None, :].expand(B, T)
        x = self._embed(params, tokens)
        x = tfm.stack_forward(params["layers"], self.cfg, x, positions,
                              cache["layers"], mode="prefill",
                              dispatch=self.moe_dispatch,
                              use_flash=self.use_flash)
        self.forward_count += 1
        # head only at each sequence's last prompt position — never (B,T,V)
        idx = (lengths.to(torch.int64) - 1)[:, None, None].expand(B, 1, x.shape[-1])
        last_h = torch.gather(x, 1, idx)
        last = self._head(params, last_h)[:, 0]
        return last, dict(cache, lengths=lengths)

    # ---------------------------------------------------------------- extend
    def _extend_impl(self, params, tokens, cache):
        tokens = self._tokens(tokens)
        B, T = tokens.shape
        positions = (cache["lengths"].to(torch.int64)[:, None]
                     + torch.arange(T, device=self.device)[None, :])
        x = self._embed(params, tokens)
        x = tfm.stack_forward(params["layers"], self.cfg, x, positions,
                              cache["layers"], mode="extend",
                              dispatch=self.moe_dispatch,
                              use_flash=self.use_flash)
        self.forward_count += 1
        return self._head(params, x), x, dict(cache)

    def extend(self, params, tokens, cache: dict, *,
               collect: bool = False) -> Tuple[torch.Tensor, dict]:
        """Decode/verify T tokens per sequence at offsets ``lengths``:
        returns logits (B, T, V) and the pending cache (K/V written,
        ``lengths`` unchanged until ``commit``).  ``collect`` gathers
        recurrent states in the reference; attention stacks have none."""
        logits, _, pend = self._extend_impl(params, tokens, cache)
        return logits, pend

    # ---------------------------------------------------------------- commit
    def commit(self, pend: dict, n_commit: torch.Tensor,
               collected: bool = False) -> dict:
        """Accept ``n_commit`` (B,) tokens of the last extend: attention
        layers only bump ``lengths`` (stale K/V are masked out)."""
        return dict(pend, lengths=pend["lengths"] + n_commit.to(torch.int32))

    # ------------------------------------------------------------ decode 1tk
    def decode_step(self, params, token: torch.Tensor, cache: dict):
        """Plain AR decode of one token per sequence. token: (B,) → (B,V)."""
        logits, pend = self.extend(params, self._tokens(token)[:, None], cache)
        cache = self.commit(pend, torch.ones_like(cache["lengths"]))
        return logits[:, 0], cache
