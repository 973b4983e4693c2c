"""Jamba-v0.1-52B [arXiv:2403.19887] — hybrid Mamba+attention MoE.

Period of 8 layers: 1 attention : 7 Mamba (attention at index 4 per the
paper's block diagram); MoE FFN every other layer (e=2), 16 experts top-2.
The MoESD analysis applies to the MoE layers; the Mamba layers carry
recurrent state through the SD verify/commit path (models/ssm.py).
"""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import register

_PATTERN = ("mamba", "mamba", "mamba", "mamba", "attn", "mamba", "mamba", "mamba")
_MOE = (False, True, False, True, False, True, False, True)


def full() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b", family="hybrid",
        num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
        head_dim=128, d_ff=14336, vocab_size=65536,
        layer_pattern=_PATTERN, moe_pattern=_MOE,
        num_experts=16, num_experts_per_tok=2, moe_d_ff=14336,
        ssm_state_dim=16, ssm_conv_dim=4, ssm_expand=2,
        rope_type="none",          # Jamba uses no positional encoding
        source="arXiv:2403.19887",
    )


def reduced() -> ModelConfig:
    return full().with_overrides(
        name="jamba-v0.1-52b-reduced", num_layers=2, d_model=256, num_heads=4,
        num_kv_heads=2, head_dim=64, d_ff=512, vocab_size=512,
        layer_pattern=("mamba", "attn"), moe_pattern=(True, False),
        num_experts=4, num_experts_per_tok=2, moe_d_ff=512, dtype="float32")


register("jamba-v0.1-52b", full, reduced)
