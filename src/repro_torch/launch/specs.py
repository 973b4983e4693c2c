"""Shape/variant resolution and abstract input specs (shared by the dry-run
and the roofline analyzer).

Port of ``repro.launch.specs``.  The reference's stand-ins are
``jax.ShapeDtypeStruct``s; here they are tensors on the ``meta`` device,
which carry a shape and a dtype and allocate nothing.

The cache is the port's (``Model.init_cache``): one dict per layer with no
period axis, a trash slot past the capacity on dense attention K/V, and an
encoder-decoder's cross K/V slots (B, S_enc, Hkv, hd) per layer from the
start (prefill fills them).  The reference's stacked (P, B, ...) leaf
``layers[k]`` holds the port's layers l with l % period == k.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.configs.registry import get_config
from repro_torch.models.model import Model

SWA_VARIANT_WINDOW = 4096


def arch_for_shape(arch: str, shape: ShapeConfig, gamma: int = 0) -> ModelConfig:
    """Resolve the config actually counted for a shape.

    long_500k on architectures without native sub-quadratic decode gets the
    documented SWA-4096 variant: every full-attention block kind ("attn" /
    "mla") becomes "swa".  MLA -> SWA also switches the attention
    parameterization, a recorded deviation, as in the reference.  An
    encoder-decoder at long_500k decode gets the same variant."""
    cfg = get_config(arch)
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        pattern = tuple("swa" if k in ("attn", "mla") else k
                        for k in cfg.layer_pattern)
        cfg = cfg.with_overrides(
            name=f"{cfg.name}+swa{SWA_VARIANT_WINDOW}",
            layer_pattern=pattern, sliding_window=SWA_VARIANT_WINDOW)
    if cfg.is_encoder_decoder and shape.kind == "decode":
        pattern = tuple("swa" if (shape.name == "long_500k" and k == "attn")
                        else k for k in cfg.layer_pattern)
        if shape.name == "long_500k":
            cfg = cfg.with_overrides(
                name=f"{cfg.name}+swa{SWA_VARIANT_WINDOW}",
                layer_pattern=pattern, sliding_window=SWA_VARIANT_WINDOW)
    return cfg


def meta(shape, dtype) -> torch.Tensor:
    """A stand-in of ``shape`` and ``dtype`` that allocates nothing."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig, model: Model,
                gamma: int = 0) -> dict:
    """Meta inputs of the step function of a ``shape.kind``, whole (every
    rank's): train ``{"batch": tokens, labels, mask (B, S)[, encoder_embeds
    (B, S_enc, d)]}``; prefill tokens (B, S), the cache and lengths (B,)
    [and encoder_embeds]; decode one token (B,) or, with ``gamma`` > 0, the
    verify's tokens (B, gamma + 1) and n_commit (B,), and the cache of
    ``seq_len`` positions.  ``model`` must live on the meta device."""
    if model.device.type != "meta":
        raise ValueError(f"input_specs builds meta stand-ins; the model is on "
                         f"{model.device}")
    B, S = shape.global_batch, shape.seq_len
    dt = model.dtype
    enc = ({"encoder_embeds": meta((B, cfg.encoder_seq_len, cfg.d_model), dt)}
           if cfg.is_encoder_decoder else {})
    if shape.kind == "train":
        return {"batch": {"tokens": meta((B, S), torch.int32),
                          "labels": meta((B, S), torch.int32),
                          "mask": meta((B, S), torch.float32), **enc}}
    cache = model.init_cache(B, S)
    if shape.kind == "prefill":
        return {"tokens": meta((B, S), torch.int32), "cache": cache,
                "lengths": meta((B,), torch.int32), **enc}
    # decode: ONE new token (or the gamma + 1 of a verify) against a
    # seq_len cache; an encoder-decoder's cross K/V were written at prefill
    if gamma > 0:
        return {"tokens": meta((B, gamma + 1), torch.int32),
                "n_commit": meta((B,), torch.int32), "cache": cache}
    return {"token": meta((B,), torch.int32), "cache": cache}
