"""Draft-model configs (paper Sec. 4: standalone small same-family models)."""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import register


def qwen2_0_5b() -> ModelConfig:
    """Qwen2-0.5B-Instruct — the paper's draft for Qwen2-57B-A14B."""
    return ModelConfig(
        name="qwen2-0.5b", family="dense",
        num_layers=24, d_model=896, num_heads=14, num_kv_heads=2,
        head_dim=64, d_ff=4864, vocab_size=151936,
        qkv_bias=True, tie_embeddings=True, rope_theta=1_000_000.0,
        source="arXiv:2407.10671",
    )


def qwen2_0_5b_reduced() -> ModelConfig:
    return qwen2_0_5b().with_overrides(
        name="qwen2-0.5b-reduced", num_layers=2, d_model=128, num_heads=4,
        num_kv_heads=2, head_dim=32, d_ff=256, vocab_size=512, dtype="float32")


register("qwen2-0.5b", qwen2_0_5b, qwen2_0_5b_reduced)
