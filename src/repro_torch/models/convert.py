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
from repro_torch.training.optimizer import AdamState


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


def _unstack(slots, period: int, num_layers: int, device) -> list:
    """Layer ``l`` of the port is period ``l // period`` of slot
    ``l % period`` in the reference."""
    return [_map(slots[l % period],
                 lambda a, p=l // period: _tensor(np.asarray(a)[p], device))
            for l in range(num_layers)]


def params_from_jax(tree: dict, cfg: ModelConfig, device) -> dict:
    """Port parameters from the reference's numpy pytree: the decoder's
    stacked layers (cross-attention sublayers and recurrent mixers
    included), an encoder-decoder's encoder (one ``"attn"`` slot stacked
    over ``encoder_layers``), and every other leaf as it is.  Each leaf
    keeps its dtype: the fp32 leaves of a bf16 model (Mamba's ``A_log``,
    ``D``, ``dt_bias``, the xLSTM gate weights and biases) stay fp32."""
    out = {k: _map(v, lambda a: _tensor(a, device))
           for k, v in tree.items() if k not in ("layers", "encoder")}
    out["layers"] = _unstack(tree["layers"], cfg.period, cfg.num_layers,
                             device)
    if "encoder" in tree:
        enc = tree["encoder"]
        out["encoder"] = {
            "layers": _unstack(enc["layers"], 1, cfg.encoder_layers, device),
            "final_norm": _map(enc["final_norm"],
                               lambda a: _tensor(a, device))}
    return out


def opt_state_from_jax(state, cfg: ModelConfig, device):
    """The port's ``AdamState`` from the reference's (``step``, ``mu``,
    ``nu``) as numpy: the moments go through ``params_from_jax``'s
    unstacking, so both packages can start from the same params and
    moments."""
    step, mu, nu = state
    return AdamState(
        step=torch.as_tensor(np.array(step), dtype=torch.int32,
                             device=device),
        mu=params_from_jax(mu, cfg, device),
        nu=params_from_jax(nu, cfg, device))
