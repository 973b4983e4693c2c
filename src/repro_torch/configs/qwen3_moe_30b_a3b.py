"""Qwen3-30B-A3B [hf:Qwen/Qwen3-30B-A3B] — 128 experts top-8.

rho = 8/128 = 0.0625 — the sparsest assigned architecture and the paper's
sweet spot: T_thres(tau=.95) = 47 tokens, so the SD-favourable moderate-
batch window is the widest here (benchmarks/sparsity_sweep.py)."""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import register


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b", family="moe",
        num_layers=48, d_model=2048, num_heads=32, num_kv_heads=4,
        head_dim=128, d_ff=768, vocab_size=151936,
        num_experts=128, num_experts_per_tok=8, moe_d_ff=768,
        rope_theta=1_000_000.0,
        source="hf:Qwen/Qwen3-30B-A3B",
    )


def reduced() -> ModelConfig:
    return full().with_overrides(
        name="qwen3-moe-30b-a3b-reduced", num_layers=2, d_model=256,
        num_heads=4, num_kv_heads=2, head_dim=64, d_ff=128, vocab_size=512,
        num_experts=4, num_experts_per_tok=2, moe_d_ff=128, dtype="float32")


register("qwen3-moe-30b-a3b", full, reduced)
