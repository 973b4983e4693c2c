"""Qwen2-7B [arXiv:2407.10671] — dense GQA with QKV bias.  Also serves as
the paper's dense control family (its 0.5B sibling is the paper's draft)."""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import register


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen2-7b", family="dense",
        num_layers=28, d_model=3584, num_heads=28, num_kv_heads=4,
        head_dim=128, d_ff=18944, vocab_size=152064,
        qkv_bias=True, rope_theta=1_000_000.0,
        source="arXiv:2407.10671",
    )


def reduced() -> ModelConfig:
    return full().with_overrides(
        name="qwen2-7b-reduced", num_layers=2, d_model=256, num_heads=4,
        num_kv_heads=2, head_dim=64, d_ff=512, vocab_size=512, dtype="float32")


register("qwen2-7b", full, reduced)
