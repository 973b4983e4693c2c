"""Qwen2-57B-A14B [arXiv:2407.10671] — the PAPER's headline target model.

64 experts top-8 (rho=0.125) + one 8x shared expert; every speedup table
(Tables 1-2) and the sparsity sweep (Fig. 4, K in {1,2,4,8,16,32} via
num_experts_per_tok override) run on this config."""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import register


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen2-57b-a14b", family="moe",
        num_layers=28, d_model=3584, num_heads=28, num_kv_heads=4,
        head_dim=128, d_ff=2560, vocab_size=151936,
        num_experts=64, num_experts_per_tok=8, moe_d_ff=2560,
        num_shared_experts=8, qkv_bias=True, rope_theta=1_000_000.0,
        source="arXiv:2407.10671 (Qwen2 technical report)",
    )


def reduced() -> ModelConfig:
    return full().with_overrides(
        name="qwen2-57b-a14b-reduced", num_layers=2, d_model=256, num_heads=4,
        num_kv_heads=2, head_dim=64, d_ff=128, vocab_size=512,
        num_experts=4, num_experts_per_tok=2, moe_d_ff=128,
        num_shared_experts=1, dtype="float32")


register("qwen2-57b-a14b", full, reduced)
