"""Config registry: --arch <id> resolution, reduced variants, drafts.

Holds the configurations the port serves and prices: the paper's MoE
target ``qwen2-57b-a14b`` and its draft ``qwen2-0.5b``, and the dense and
sparse comparisons the cost model prices (``qwen2-7b``, ``mixtral-8x7b``,
``qwen3-moe-30b-a3b``)."""
from __future__ import annotations

from typing import Callable, Dict

from repro_torch.configs.base import ModelConfig

_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}
_REDUCED: Dict[str, Callable[[], ModelConfig]] = {}


def register(name: str, full: Callable[[], ModelConfig],
             reduced: Callable[[], ModelConfig]):
    _REGISTRY[name] = full
    _REDUCED[name] = reduced


def get_config(name: str, *, reduced: bool = False, **overrides) -> ModelConfig:
    table = _REDUCED if reduced else _REGISTRY
    if name not in table:
        _load_all()
    if name not in table:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(table)}")
    cfg = table[name]()
    return cfg.with_overrides(**overrides) if overrides else cfg


def _load_all():
    from repro_torch.configs import (  # noqa: F401
        drafts, mixtral_8x7b, qwen2_7b, qwen2_57b_a14b, qwen3_moe_30b_a3b)


def draft_for(cfg: ModelConfig) -> ModelConfig:
    """Default draft model for a target: small dense decoder sharing the
    target's vocab (the framework default of ``repro.configs.registry``)."""
    return ModelConfig(
        name=f"{cfg.name}-draft",
        family="dense",
        num_layers=4,
        d_model=min(512, cfg.d_model),
        num_heads=8,
        num_kv_heads=2,
        d_ff=4 * min(512, cfg.d_model),
        vocab_size=cfg.vocab_size,
        rope_type="rope" if cfg.rope_type in ("rope", "mrope") else "sinusoidal"
        if cfg.rope_type == "sinusoidal" else "rope",
        dtype=cfg.dtype,
        source="framework default draft",
    )
