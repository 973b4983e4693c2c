"""Training step: causal-LM loss (+ MoE aux loss) + AdamW.

Port of ``repro.training.train_loop``.  ``make_train_step`` builds the step
``python -m repro_torch.launch.train`` runs.  The loss is taken over the
head in chunks of 512 positions, each under a checkpoint, so neither pass
keeps (B, T, vocab) logits; gradients come from ``torch.autograd.grad``
over the parameters' floating leaves (nothing accumulates in ``.grad``),
and AdamW updates the parameters and moments in place.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import TrainConfig
from repro_torch.distributed import collectives as col
from repro_torch.distributed.sharding import shard_batch
from repro_torch.models.model import Model
from repro_torch.training.optimizer import AdamState, adamw_update, init_adam
from repro_torch.training.tree import tree_items, tree_leaves, tree_map


def _nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, -1, labels[..., None])[..., 0]


def lm_loss(logits: torch.Tensor, labels: torch.Tensor,
            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Cross entropy; logits[:, t] predicts labels[:, t] (labels are
    pre-shifted by the data pipeline: labels = tokens >> 1)."""
    nll = _nll(logits, labels)
    mask = torch.ones_like(nll) if mask is None else mask.float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def chunked_lm_loss(model: Model, params, hidden: torch.Tensor,
                    labels: torch.Tensor, mask: Optional[torch.Tensor],
                    chunk: int = 512, shard=None) -> torch.Tensor:
    """Cross entropy without keeping (B, T, vocab): the head runs over
    T-chunks, each under a checkpoint, so the backward recomputes one
    chunk's logits at a time.  hidden[:, t] predicts labels[:, t].

    Under a mesh (``shard``, the rows this rank's) each chunk's logits are
    gathered over the vocab (``Model._head``) and the masked mean is the
    whole batch's: the sum of ``nll * mask`` and the token count are each
    summed over the batch axes before the division, never a mean of
    per-rank means."""
    B, T, _ = hidden.shape
    chunk = min(chunk, T)
    pad = (-T) % chunk
    m = (torch.ones((B, T), dtype=torch.float32, device=hidden.device)
         if mask is None else mask.float())
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        m = F.pad(m, (0, pad))

    def body(h, tgt, msk):
        nll = _nll(model._head(params, h, shard), tgt)
        return torch.sum(nll * msk), torch.sum(msk)

    run = body
    if torch.is_grad_enabled() and hidden.requires_grad:
        run = lambda *a: checkpoint(body, *a, use_reentrant=False)
    s = torch.zeros((), device=hidden.device)
    c = torch.zeros((), device=hidden.device)
    for t0 in range(0, T + pad, chunk):
        ds, dc = run(hidden[:, t0:t0 + chunk], labels[:, t0:t0 + chunk],
                     m[:, t0:t0 + chunk])
        s, c = s + ds, c + dc
    if shard is not None and shard.batch_axes:
        s = col.reduce_over(s, shard, shard.batch_axes)
        c = col.reduce_over(c, shard, shard.batch_axes)
    return s / torch.clamp(c, min=1.0)


def _split_axes(model: Model, params) -> list:
    """The mesh axes each leaf of placed ``params`` is split over (in
    ``tree_leaves`` order), from the placement ``Model.place`` recorded
    (none when the params are whole)."""
    out = []
    for path, _ in tree_items(params):
        spec = model.placement
        for k in path.split("/"):
            if spec is not None:
                spec = spec[int(k)] if isinstance(spec, list) else spec[k]
        out.append(tuple(a for e in spec or () if e is not None
                         for a in ((e,) if isinstance(e, str) else e)))
    return out


def _sync_grads(shard, grads: list, split: list) -> None:
    """Sum, in place, each gradient over the batch axes its leaf is not
    split on: the replicas of a data-parallel leaf computed on different
    rows.  (A leaf split over a batch axis got that sum from its gather's
    reduce-scatter.)"""
    for g, axes in zip(grads, split):
        over = tuple(a for a in shard.batch_axes if a not in axes)
        if over and shard.size(over) > 1:
            col.all_reduce_(g, shard.group(over))


def _sharded_norm(shard, split: list):
    """The global gradient norm of a placed tree: each leaf's block summed
    over the axes it is split on only, so a replicated leaf counts once."""
    def norm(grads) -> torch.Tensor:
        groups: dict = {}
        for g, axes in zip(tree_leaves(grads), split):
            sq = torch.sum(torch.square(g.float()))
            groups[axes] = groups.get(axes, 0.0) + sq
        total = 0.0
        for axes, sq in groups.items():
            if axes:
                sq = sq.clone()
                col.all_reduce_(sq, shard.group(axes))
            total = total + sq
        return torch.sqrt(total)
    return norm


def make_train_step(model: Model, tcfg: TrainConfig):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: ``params`` and the moments are updated in place.  ``batch``
    holds ``tokens``, ``labels`` (B, T), optionally ``mask``, and an
    encoder-decoder's ``encoder_embeds`` / a vision stub's
    ``inputs_embeds``, as numpy arrays or tensors.

    With ``Model(mesh=...)`` the step is the sharded one: ``params`` and
    the moments are this rank's blocks (``Model.place``, with
    ``fsdp=True`` as the reference trains; ``init_adam`` of the placed
    params or ``sharding.shard_opt_state``), ``batch`` is the whole batch
    every rank holds and the step takes its rows (``sharding.shard_batch``),
    the loss and its gradient are the whole batch's, gradients of replicas
    are summed over the batch axes, and the clip reads the global norm."""
    cfg = model.cfg
    dev = model.device
    mesh = model.mesh

    def loss_fn(params, batch, axes):
        kwargs = {}
        if cfg.is_encoder_decoder:
            kwargs["encoder_embeds"] = batch["encoder_embeds"]
        if cfg.frontend == "vision_stub" and "inputs_embeds" in batch:
            kwargs["inputs_embeds"] = batch["inputs_embeds"]
        hidden, metrics = model.forward_hidden(params, batch["tokens"],
                                               batch_axes=axes, **kwargs)
        labels = torch.as_tensor(batch["labels"], dtype=torch.int64,
                                 device=dev)
        mask = batch.get("mask")
        if mask is not None:
            mask = torch.as_tensor(mask, device=dev)
        shard = model._shard(axes)
        loss = chunked_lm_loss(model, params, hidden, labels, mask,
                               shard=shard)
        aux = metrics["aux_loss"] / max(cfg.num_layers, 1)
        total = loss + cfg.router_aux_loss_coef * aux
        counts = metrics["expert_counts"]
        if shard is not None and axes:      # the whole batch's counts
            counts = col.reduce_over(counts, shard, axes)
        return total, {"loss": loss, "aux_loss": aux,
                       "expert_counts": counts}

    def train_step(params, opt_state: AdamState, batch):
        axes = ()
        if mesh is not None:     # this rank's rows (sharding.batch_spec)
            batch, axes = shard_batch(batch, mesh, model.mesh_layout)
        # views of the leaves that autograd differentiates; the leaves
        # themselves never require grad, and AdamW writes into them
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        with torch.enable_grad():
            total, metrics = loss_fn(live, batch, axes)
            flat = torch.autograd.grad(total, tree_leaves(live),
                                       allow_unused=True,
                                       materialize_grads=True)
        del live
        norm_fn = None
        if mesh is not None:
            shard, split = model._shard(axes), _split_axes(model, params)
            _sync_grads(shard, flat, split)
            if any(split):
                norm_fn = _sharded_norm(shard, split)
        it = iter(flat)
        grads = tree_map(lambda _: next(it), params)
        del flat, it
        params, opt_state, opt_metrics = adamw_update(params, grads,
                                                      opt_state, tcfg,
                                                      norm_fn=norm_fn)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics = dict(metrics, **opt_metrics, total_loss=total.detach())
        return params, opt_state, metrics

    return train_step


def init_train_state(model: Model, generator: torch.Generator
                     ) -> Tuple[dict, AdamState]:
    params = model.init(generator)
    return params, init_adam(params)
