"""MiniCPM3-4B [hf:openbmb/MiniCPM3-4B] — dense with MLA attention.

Multi-head Latent Attention: KV compressed to a 256-dim latent (+32-dim
shared rope key); q through a 768-rank LoRA.  Cache stores the latent, not
per-head K/V — the decode_32k KV footprint is ~9x smaller than GQA-40.
"""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import register


def full() -> ModelConfig:
    return ModelConfig(
        name="minicpm3-4b", family="dense",
        num_layers=62, d_model=2560, num_heads=40, num_kv_heads=40,
        head_dim=96, d_ff=6400, vocab_size=73448,
        layer_pattern=("mla",),
        mla_kv_lora_rank=256, mla_q_lora_rank=768,
        mla_qk_rope_dim=32, mla_qk_nope_dim=64, mla_v_head_dim=64,
        rope_theta=10_000.0, tie_embeddings=True,
        source="hf:openbmb/MiniCPM3-4B",
    )


def reduced() -> ModelConfig:
    return full().with_overrides(
        name="minicpm3-4b-reduced", num_layers=2, d_model=256, num_heads=4,
        num_kv_heads=4, d_ff=512, vocab_size=512, dtype="float32",
        mla_kv_lora_rank=64, mla_q_lora_rank=48, mla_qk_rope_dim=16,
        mla_qk_nope_dim=32, mla_v_head_dim=32, head_dim=48)


register("minicpm3-4b", full, reduced)
