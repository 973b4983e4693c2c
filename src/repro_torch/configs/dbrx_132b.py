"""DBRX-132B [hf:databricks/dbrx-base] — fine-grained MoE, 16 experts top-4.

rho = 4/16 = 0.25; T_thres(tau=.95) = 11 tokens — expert activation
saturates at tiny batches, the classic MoESD regime."""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import register


def full() -> ModelConfig:
    return ModelConfig(
        name="dbrx-132b", family="moe",
        num_layers=40, d_model=6144, num_heads=48, num_kv_heads=8,
        head_dim=128, d_ff=10752, vocab_size=100352,
        num_experts=16, num_experts_per_tok=4, moe_d_ff=10752,
        rope_theta=500_000.0, norm_type="layernorm",
        source="hf:databricks/dbrx-base",
    )


def reduced() -> ModelConfig:
    return full().with_overrides(
        name="dbrx-132b-reduced", num_layers=2, d_model=256, num_heads=4,
        num_kv_heads=2, head_dim=64, d_ff=512, vocab_size=512,
        num_experts=4, num_experts_per_tok=2, moe_d_ff=512, dtype="float32")


register("dbrx-132b", full, reduced)
