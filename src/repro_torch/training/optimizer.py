"""AdamW + cosine schedule + global-norm clipping on the port's parameter
tree (dicts and lists of tensors).

Port of ``repro.training.optimizer`` with its arithmetic: clipped gradients
are cast back to each leaf's dtype, the schedule and the bias corrections
are fp32 tensors on the parameters' device (no host sync), and the decayed
step ``lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)`` is computed in fp32
and cast back to the leaf's dtype.  The reference donates its buffers to
the jitted step; here the moments and the parameters are updated in place
under ``torch.no_grad()``, leaf by leaf, so a step holds one leaf's fp32
temporaries at a time beside the weights, gradients and moments.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.training.tree import tree_leaves, tree_map


class AdamState(NamedTuple):
    step: torch.Tensor      # () int32, on the parameters' device
    mu: dict                # first moment  (tree like params, fp32)
    nu: dict                # second moment


def init_adam(params) -> AdamState:
    zeros = lambda: tree_map(
        lambda a: torch.zeros_like(a, dtype=torch.float32), params)
    dev = tree_leaves(params)[0].device
    return AdamState(step=torch.zeros((), dtype=torch.int32, device=dev),
                     mu=zeros(), nu=zeros())


def cosine_schedule(step: torch.Tensor, cfg: TrainConfig) -> torch.Tensor:
    """Linear warm-up, then cosine decay to a 0.1 floor; fp32."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.learning_rate * warm * (0.1 + 0.9 * cos)


def _global_norm(grads) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree_leaves(grads)))


def _clip_scale(gnorm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, each in its
    own dtype; the global norm before clipping)."""
    gnorm = _global_norm(grads)
    scale = _clip_scale(gnorm, max_norm)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gnorm


@torch.no_grad()
def adamw_update(params, grads, state: AdamState, cfg: TrainConfig
                 ) -> Tuple[dict, AdamState, dict]:
    """One AdamW step, in place: ``params`` and the moments of ``state``
    are updated and returned (the same objects; ``step`` is a new tensor).
    ``grads`` is a tree like ``params``; it is read, never written."""
    gnorm = _global_norm(grads)
    scale = _clip_scale(gnorm, cfg.grad_clip)
    step = state.step + 1
    lr = cosine_schedule(step, cfg)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state.mu), tree_leaves(state.nu)):
        g32 = (g.float() * scale).to(g.dtype).float()
        m.mul_(b1).add_(g32 * (1 - b1))
        v.mul_(b2).add_(torch.square(g32).mul_(1 - b2))
        del g32
        delta = (m / bc1).div_(torch.sqrt(v / bc2).add_(cfg.eps))
        delta.add_(cfg.weight_decay * p.float())
        # an fp32 leaf is updated in place by sub_ (p.float() is p)
        p.copy_(p.float().sub_(delta.mul_(lr)))
    return params, AdamState(step, state.mu, state.nu), {"lr": lr,
                                                         "grad_norm": gnorm}
