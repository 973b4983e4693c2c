"""Parameters from the reference's layout.

``repro.models.model.Model.init`` returns a pytree whose ``layers`` is a list
with one entry per period slot, each slot's leaves stacked over
``num_periods`` (``repro.models.transformer.init_stack``).  The port keeps
one dict per layer.  This module takes that pytree as numpy arrays (the
caller runs ``jax.device_get`` on its side), so the port never imports JAX.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.array(a)                     # a writable copy of a JAX buffer
    if a.dtype.name == "bfloat16":      # ml_dtypes bfloat16: same bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _map(tree: Any, fn) -> Any:
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def params_from_jax(tree: dict, cfg: ModelConfig, device) -> dict:
    """Port parameters from the reference's numpy pytree.

    Layer ``l`` of the port is period ``l // period`` of slot
    ``l % period`` in the reference."""
    out = {k: _map(v, lambda a: _tensor(a, device))
           for k, v in tree.items() if k != "layers"}
    slots = tree["layers"]
    out["layers"] = [
        _map(slots[l % cfg.period],
             lambda a, p=l // cfg.period: _tensor(np.asarray(a)[p], device))
        for l in range(cfg.num_layers)]
    return out
