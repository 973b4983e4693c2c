"""Whisper-base [arXiv:2212.04356] — audio encoder-decoder backbone.

Per the assignment carve-out the mel-spectrogram + conv frontend is a STUB:
input_specs() feeds precomputed frame embeddings (B, 1500, 512) directly to
the encoder.  Deviations from the paper: decoder positions are sinusoidal
(not learned) so the assigned 32k/500k decode shapes exceed the original
448-token table; long_500k additionally uses the SWA-4096 variant on
decoder self-attention (cross-attention is O(1) in S — fixed 1500 frames).
"""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import register


def full() -> ModelConfig:
    return ModelConfig(
        name="whisper-base", family="audio",
        num_layers=6, d_model=512, num_heads=8, num_kv_heads=8,
        head_dim=64, d_ff=2048, vocab_size=51865,
        is_encoder_decoder=True, encoder_layers=6, encoder_seq_len=1500,
        rope_type="sinusoidal", norm_type="layernorm", frontend="audio_stub",
        tie_embeddings=True,
        source="arXiv:2212.04356",
    )


def reduced() -> ModelConfig:
    return full().with_overrides(
        name="whisper-base-reduced", num_layers=2, encoder_layers=2,
        d_model=128, num_heads=4, num_kv_heads=4, head_dim=32, d_ff=256,
        vocab_size=512, encoder_seq_len=16, dtype="float32")


register("whisper-base", full, reduced)
