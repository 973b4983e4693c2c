"""Gemma3-12B [hf:google/gemma-3-1b-pt family] — dense, 5:1 local:global.

Five sliding-window (1024) layers per one global layer; 128k context
native.  The interleave makes long_500k decode feasible faithfully: only
8/48 layers keep a full-length KV.
"""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import register


def full() -> ModelConfig:
    return ModelConfig(
        name="gemma3-12b", family="dense",
        num_layers=48, d_model=3840, num_heads=16, num_kv_heads=8,
        head_dim=256, d_ff=15360, vocab_size=262144,
        layer_pattern=("swa", "swa", "swa", "swa", "swa", "attn"),
        sliding_window=1024, mlp_activation="gelu",
        rope_theta=1_000_000.0, tie_embeddings=True,
        final_logit_softcap=30.0,
        source="hf:google/gemma-3-1b-pt (scaled per card family)",
    )


def reduced() -> ModelConfig:
    return full().with_overrides(
        name="gemma3-12b-reduced", num_layers=2, d_model=256, num_heads=4,
        num_kv_heads=2, head_dim=64, d_ff=512, vocab_size=512,
        layer_pattern=("swa", "attn"), moe_pattern=(False, False),
        sliding_window=16, dtype="float32")


register("gemma3-12b", full, reduced)
