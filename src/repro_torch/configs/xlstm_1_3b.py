"""xLSTM-1.3B [arXiv:2405.04517] — recurrent sLSTM + mLSTM stack (7:1).

No attention, no KV cache: decode state is O(1) in sequence length, so
long_500k runs natively.  The MoESD *analysis* is inapplicable (no MoE
FFN, d_ff=0 — mLSTM blocks are self-contained); the SD *engine* still
serves it via per-step state collection + commit-gather (models/ssm.py,
``Model.commit``)."""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import register

_PATTERN = ("mlstm",) * 7 + ("slstm",)


def full() -> ModelConfig:
    return ModelConfig(
        name="xlstm-1.3b", family="ssm",
        num_layers=48, d_model=2048, num_heads=4, num_kv_heads=4,
        d_ff=0, vocab_size=50304, head_dim=512,
        layer_pattern=_PATTERN, rope_type="none", norm_type="layernorm",
        source="arXiv:2405.04517",
    )


def reduced() -> ModelConfig:
    return full().with_overrides(
        name="xlstm-1.3b-reduced", num_layers=2, d_model=256, num_heads=4,
        num_kv_heads=4, head_dim=64, vocab_size=512,
        layer_pattern=("mlstm", "slstm"), moe_pattern=(False, False),
        dtype="float32")


register("xlstm-1.3b", full, reduced)
