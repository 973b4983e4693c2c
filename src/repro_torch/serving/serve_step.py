"""The serving step functions: one AR decode step, one SD verify step and
the prefill, each a closure over a ``Model``.

Port of ``repro.serving.serve_step``: one new token per sequence against a
KV cache, or a gamma+1-token SD verify (the paper's verification
workload), as the reference's multi-pod dry-run lowers them.  Under a mesh
the model computes on this rank's blocks (``Model(mesh=...)``, params from
``distributed/sharding.shard_params``, a cache from ``Model.init_cache``
or ``sharding.shard_cache``) and every rank returns the whole batch's
logits.
"""
from __future__ import annotations

import torch

from repro_torch.models.model import Model


def make_decode_step(model: Model):
    """AR decode: (params, token (B,), cache) -> (logits (B, V), cache)."""

    def decode_step(params, token, cache):
        logits, pend = model.extend(params, token[:, None], cache,
                                    collect=True)
        n = torch.ones((token.shape[0],), dtype=torch.int32,
                       device=logits.device)
        cache = model.commit(pend, n, collected=True)
        return logits[:, 0], cache

    return decode_step


def make_verify_step(model: Model, gamma: int):
    """SD verify: (params, tokens (B, gamma+1), n_commit (B,), cache) ->
    (logits (B, gamma+1, V), cache).  ``n_commit`` is data (from
    rejection), so one step serves every acceptance outcome."""

    def verify_step(params, tokens, n_commit, cache):
        logits, pend = model.extend(params, tokens, cache, collect=True)
        cache = model.commit(pend, n_commit, collected=True)
        return logits, cache

    return verify_step


def make_prefill_step(model: Model):
    """Prefill: (params, tokens (B, T), cache, lengths=None, **kw) ->
    (last-position logits (B, V), cache)."""

    def prefill_step(params, tokens, cache, lengths=None, **kw):
        return model.prefill(params, tokens, cache, lengths=lengths, **kw)

    return prefill_step
