"""Gemma-7B [arXiv:2403.08295] — dense, GeGLU, head_dim 256, MHA (kv=16).

The model card's 2B sibling uses MQA; 7B is effectively MHA (16 q / 16 kv).
"""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import register


def full() -> ModelConfig:
    return ModelConfig(
        name="gemma-7b", family="dense",
        num_layers=28, d_model=3072, num_heads=16, num_kv_heads=16,
        head_dim=256, d_ff=24576, vocab_size=256000,
        mlp_activation="gelu", rope_theta=10_000.0,
        tie_embeddings=True, norm_type="rmsnorm",
        source="arXiv:2403.08295",
    )


def reduced() -> ModelConfig:
    return full().with_overrides(
        name="gemma-7b-reduced", num_layers=2, d_model=256, num_heads=4,
        num_kv_heads=4, head_dim=64, d_ff=512, vocab_size=512, dtype="float32")


register("gemma-7b", full, reduced)
