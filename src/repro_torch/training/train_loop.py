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
from repro_torch.models.model import Model
from repro_torch.training.optimizer import AdamState, adamw_update, init_adam
from repro_torch.training.tree import tree_leaves, tree_map


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
                    chunk: int = 512) -> torch.Tensor:
    """Cross entropy without keeping (B, T, vocab): the head runs over
    T-chunks, each under a checkpoint, so the backward recomputes one
    chunk's logits at a time.  hidden[:, t] predicts labels[:, t]."""
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
        nll = _nll(model._head(params, h), tgt)
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
    return s / torch.clamp(c, min=1.0)


def make_train_step(model: Model, tcfg: TrainConfig):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: ``params`` and the moments are updated in place.  ``batch``
    holds ``tokens``, ``labels`` (B, T), optionally ``mask``, and an
    encoder-decoder's ``encoder_embeds`` / a vision stub's
    ``inputs_embeds``, as numpy arrays or tensors."""
    cfg = model.cfg
    dev = model.device

    def loss_fn(params, batch):
        kwargs = {}
        if cfg.is_encoder_decoder:
            kwargs["encoder_embeds"] = batch["encoder_embeds"]
        if cfg.frontend == "vision_stub" and "inputs_embeds" in batch:
            kwargs["inputs_embeds"] = batch["inputs_embeds"]
        hidden, metrics = model.forward_hidden(params, batch["tokens"],
                                               **kwargs)
        labels = torch.as_tensor(batch["labels"], dtype=torch.int64,
                                 device=dev)
        mask = batch.get("mask")
        if mask is not None:
            mask = torch.as_tensor(mask, device=dev)
        loss = chunked_lm_loss(model, params, hidden, labels, mask)
        aux = metrics["aux_loss"] / max(cfg.num_layers, 1)
        total = loss + cfg.router_aux_loss_coef * aux
        return total, {"loss": loss, "aux_loss": aux,
                       "expert_counts": metrics["expert_counts"]}

    def train_step(params, opt_state: AdamState, batch):
        # views of the leaves that autograd differentiates; the leaves
        # themselves never require grad, and AdamW writes into them
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        with torch.enable_grad():
            total, metrics = loss_fn(live, batch)
            flat = torch.autograd.grad(total, tree_leaves(live),
                                       allow_unused=True,
                                       materialize_grads=True)
        del live
        it = iter(flat)
        grads = tree_map(lambda _: next(it), params)
        del flat, it
        params, opt_state, opt_metrics = adamw_update(params, grads,
                                                      opt_state, tcfg)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics = dict(metrics, **opt_metrics, total_loss=total.detach())
        return params, opt_state, metrics

    return train_step


def init_train_state(model: Model, generator: torch.Generator
                     ) -> Tuple[dict, AdamState]:
    params = model.init(generator)
    return params, init_adam(params)
