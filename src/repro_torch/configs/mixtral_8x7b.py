"""Mixtral-8x7B [arXiv:2401.04088] — the paper's second target (Eagle-head
draft in the paper; we pair it with a small dense draft)."""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import register


def full() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b", family="moe",
        num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
        head_dim=128, d_ff=14336, vocab_size=32000,
        num_experts=8, num_experts_per_tok=2, moe_d_ff=14336,
        rope_theta=1_000_000.0,
        source="arXiv:2401.04088",
    )


def reduced() -> ModelConfig:
    return full().with_overrides(
        name="mixtral-8x7b-reduced", num_layers=2, d_model=256, num_heads=4,
        num_kv_heads=2, head_dim=64, d_ff=512, vocab_size=512,
        num_experts=4, num_experts_per_tok=2, moe_d_ff=512, dtype="float32")


register("mixtral-8x7b", full, reduced)
