"""Config registry: --arch <id> resolution, reduced variants, drafts.

Holds the configurations the port serves and prices: the paper's MoE
target ``qwen2-57b-a14b`` and its draft ``qwen2-0.5b``, the dense and
sparse comparisons the cost model prices (``qwen2-7b``, ``mixtral-8x7b``,
``qwen3-moe-30b-a3b``), the attention-only assigned archs (``dbrx-132b``,
``gemma-7b``, ``gemma3-12b``, ``minicpm3-4b``, ``qwen2-vl-2b``), the
recurrent ones (``jamba-v0.1-52b``, Mamba + attention + MoE, and
``xlstm-1.3b``, mLSTM + sLSTM) and the encoder-decoder ``whisper-base``."""
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


def registered() -> list:
    """Every arch name ``get_config`` resolves, sorted."""
    _load_all()
    return sorted(_REGISTRY)


def _load_all():
    from repro_torch.configs import (  # noqa: F401
        dbrx_132b, drafts, gemma3_12b, gemma_7b, jamba_v01_52b, minicpm3_4b,
        mixtral_8x7b, qwen2_7b, qwen2_57b_a14b, qwen2_vl_2b,
        qwen3_moe_30b_a3b, whisper_base, xlstm_1_3b)


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
