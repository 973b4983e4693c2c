"""Qwen2-VL-2B [arXiv:2409.12191] — VLM language backbone with M-RoPE.

Vision tower (ViT + merger) is a STUB per the assignment: input_specs()
provides patch embeddings; the LM consumes them via inputs_embeds.  M-RoPE
splits each head's rotary halves into (temporal=16, height=24, width=24)
bands; for pure text all three ids coincide and it reduces to 1-D RoPE.
Dynamic resolution enters through the (t,h,w) position ids, not the LM.
"""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import register


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-2b", family="vlm",
        num_layers=28, d_model=1536, num_heads=12, num_kv_heads=2,
        head_dim=128, d_ff=8960, vocab_size=151936,
        qkv_bias=True, rope_type="mrope", mrope_sections=(16, 24, 24),
        rope_theta=1_000_000.0, tie_embeddings=True, frontend="vision_stub",
        source="arXiv:2409.12191",
    )


def reduced() -> ModelConfig:
    return full().with_overrides(
        name="qwen2-vl-2b-reduced", num_layers=2, d_model=256, num_heads=4,
        num_kv_heads=2, head_dim=64, d_ff=512, vocab_size=512,
        mrope_sections=(8, 12, 12), dtype="float32")


register("qwen2-vl-2b", full, reduced)
