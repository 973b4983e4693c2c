"""Model, input-shape and training configuration (copies of
``repro.configs.base``'s ``ModelConfig``, ``ShapeConfig`` with
``INPUT_SHAPES``, and ``TrainConfig``).

A single flat dataclass covers every assigned architecture family
(dense / MoE / SSM / hybrid / audio enc-dec / VLM).  Heterogeneous layer
stacks are expressed with ``layer_pattern`` — one *period* of block kinds
that is tiled ``num_layers / len(layer_pattern)`` times, which is also the
unit the transformer scans over (keeps HLO small for 62-layer models).

Block kinds:
  "attn"    full causal self-attention (GQA/MQA per num_kv_heads)
  "swa"     sliding-window self-attention (window = sliding_window)
  "mla"     multi-head latent attention (DeepSeek-V2 style, MiniCPM3)
  "mamba"   Mamba selective-SSM block (Jamba)
  "mlstm"   xLSTM matrix-LSTM block
  "slstm"   xLSTM scalar-LSTM block

``moe_pattern`` parallels ``layer_pattern``: True → the FFN of that layer is
a routed MoE, False → dense FFN.  Empty pattern → all-dense (or all-MoE if
num_experts > 0).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 → d_model // num_heads

    # ---- layer stack ------------------------------------------------------
    layer_pattern: Tuple[str, ...] = ()      # one period; () → all "attn"
    moe_pattern: Tuple[bool, ...] = ()       # parallels layer_pattern

    # ---- FFN --------------------------------------------------------------
    mlp_activation: str = "silu"             # "silu" (SwiGLU) | "gelu" (GeGLU)

    # ---- attention --------------------------------------------------------
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    rope_type: str = "rope"                  # "rope" | "mrope" | "learned" | "sinusoidal"
    mrope_sections: Tuple[int, ...] = ()     # qwen2-vl: rotary dims per (t,h,w)
    sliding_window: int = 0                  # used by "swa" blocks
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    max_position_embeddings: int = 1_048_576

    # ---- MLA (MiniCPM3 / DeepSeek-V2) --------------------------------------
    mla_kv_lora_rank: int = 0
    mla_q_lora_rank: int = 0
    mla_qk_rope_dim: int = 0
    mla_qk_nope_dim: int = 0
    mla_v_head_dim: int = 0

    # ---- MoE ---------------------------------------------------------------
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_d_ff: int = 0                        # expert hidden dim; 0 → d_ff
    num_shared_experts: int = 0              # always-on shared experts
    router_aux_loss_coef: float = 0.0
    router_jitter: float = 0.0

    # ---- SSM (Mamba) -------------------------------------------------------
    ssm_state_dim: int = 16
    ssm_conv_dim: int = 4
    ssm_expand: int = 2
    ssm_dt_rank: int = 0                     # 0 → ceil(d_model / 16)

    # ---- encoder-decoder (whisper) -----------------------------------------
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_seq_len: int = 1500              # whisper: 1500 frames after conv

    # ---- modality frontend stub --------------------------------------------
    frontend: str = "none"                   # none | audio_stub | vision_stub

    # ---- misc ---------------------------------------------------------------
    norm_type: str = "rmsnorm"               # rmsnorm | layernorm
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"                  # activation/param dtype
    source: str = ""                         # citation for the config

    # ------------------------------------------------------------------------
    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if not self.layer_pattern:
            object.__setattr__(self, "layer_pattern", ("attn",))
        if not self.moe_pattern:
            default_moe = self.num_experts > 0
            object.__setattr__(
                self, "moe_pattern", tuple(default_moe for _ in self.layer_pattern)
            )
        if len(self.moe_pattern) != len(self.layer_pattern):
            raise ValueError(
                f"{self.name}: moe_pattern length {len(self.moe_pattern)} != "
                f"layer_pattern length {len(self.layer_pattern)}"
            )
        if self.num_layers % len(self.layer_pattern) != 0:
            raise ValueError(
                f"{self.name}: num_layers={self.num_layers} not divisible by "
                f"pattern period {len(self.layer_pattern)}"
            )
        if self.moe_d_ff == 0:
            object.__setattr__(self, "moe_d_ff", self.d_ff)

    # ---- derived quantities -------------------------------------------------
    @property
    def num_periods(self) -> int:
        return self.num_layers // len(self.layer_pattern)

    @property
    def period(self) -> int:
        return len(self.layer_pattern)

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)

    @property
    def moe_sparsity(self) -> float:
        """rho = K / E (paper §3.2)."""
        if self.num_experts == 0:
            return 1.0
        return self.num_experts_per_tok / self.num_experts

    @property
    def is_recurrent(self) -> bool:
        """True if any block keeps recurrent (non-KV) state."""
        return any(k in ("mamba", "mlstm", "slstm") for k in self.layer_pattern)

    @property
    def has_full_attention(self) -> bool:
        return any(k in ("attn", "mla") for k in self.layer_pattern)

    @property
    def sub_quadratic(self) -> bool:
        """Can this config decode at 500k context without O(S) full-attn KV on
        every layer?  (Some full-attn layers are OK if a minority — gemma3 /
        jamba keep a few global layers.)"""
        if not self.has_full_attention:
            return True
        n_full = sum(1 for k in self.layer_pattern if k in ("attn", "mla"))
        return n_full / self.period <= 0.5

    def param_count(self) -> int:
        """Total parameter count (embedding + stack + head), exact."""
        return _param_count(self)

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only K experts)."""
        return _param_count(self, active_only=True)

    def with_overrides(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def _ffn_params(cfg: ModelConfig, d_ff: int) -> int:
    # gated MLP: gate + up + down
    return 3 * cfg.d_model * d_ff


def _attn_params(cfg: ModelConfig, kind: str) -> int:
    d, hd = cfg.d_model, cfg.head_dim
    if kind == "mla":
        r_kv, r_q = cfg.mla_kv_lora_rank, cfg.mla_q_lora_rank
        qk = cfg.mla_qk_rope_dim + cfg.mla_qk_nope_dim
        n = 0
        n += d * (r_kv + cfg.mla_qk_rope_dim)                # kv down (+ rope k)
        n += r_kv * cfg.num_heads * (cfg.mla_qk_nope_dim + cfg.mla_v_head_dim)
        if r_q:
            n += d * r_q + r_q * cfg.num_heads * qk
        else:
            n += d * cfg.num_heads * qk
        n += cfg.num_heads * cfg.mla_v_head_dim * d          # out proj
        return n
    # gqa / swa
    n = d * cfg.num_heads * hd                               # q
    n += 2 * d * cfg.num_kv_heads * hd                       # k, v
    n += cfg.num_heads * hd * d                              # o
    if cfg.qkv_bias:
        n += (cfg.num_heads + 2 * cfg.num_kv_heads) * hd
    return n


def _ssm_params(cfg: ModelConfig, kind: str) -> int:
    d = cfg.d_model
    if kind == "mamba":
        d_in = cfg.ssm_expand * d
        dt_rank = cfg.ssm_dt_rank or -(-d // 16)
        n = d * 2 * d_in                                     # in proj (x, z)
        n += d_in * cfg.ssm_conv_dim                         # conv
        n += d_in * (dt_rank + 2 * cfg.ssm_state_dim)        # x -> dt,B,C
        n += dt_rank * d_in                                  # dt proj
        n += d_in * cfg.ssm_state_dim + d_in                 # A_log, D
        n += d_in * d                                        # out proj
        return n
    if kind == "mlstm":
        d_in = 2 * d
        hd = d_in // cfg.num_heads
        n = d * 2 * d_in                                     # up proj (x, z)
        n += 3 * d_in * d_in                                 # q,k,v
        n += 2 * cfg.num_heads * d_in                        # i,f gates (per head)
        n += d_in * d                                        # down proj
        return n
    if kind == "slstm":
        n = 4 * d * d + 4 * d * d                            # input + recurrent (4 gates)
        n += 2 * (d * (4 * d) // 3)                          # up/down ffn (4/3 ratio)
        return n
    raise ValueError(kind)


def _param_count(cfg: ModelConfig, active_only: bool = False) -> int:
    n = cfg.vocab_size * cfg.d_model                         # embed
    if not cfg.tie_embeddings:
        n += cfg.vocab_size * cfg.d_model                    # lm head
    per_period = 0
    for kind, is_moe in zip(cfg.layer_pattern, cfg.moe_pattern):
        if kind in ("attn", "swa", "mla"):
            per_period += _attn_params(cfg, kind)
        else:
            per_period += _ssm_params(cfg, kind)
        if is_moe:
            e = cfg.num_experts_per_tok if active_only else cfg.num_experts
            per_period += e * _ffn_params(cfg, cfg.moe_d_ff)
            per_period += cfg.num_shared_experts * _ffn_params(cfg, cfg.moe_d_ff)
            per_period += cfg.d_model * cfg.num_experts      # router
        elif kind not in ("mamba", "mlstm", "slstm"):
            per_period += _ffn_params(cfg, cfg.d_ff)
        per_period += 2 * cfg.d_model                        # 2 norms / layer
    n += per_period * cfg.num_periods
    if cfg.is_encoder_decoder:
        # encoder layers: bidirectional attn + ffn + cross-attn params on decoder
        enc = cfg.encoder_layers * (
            _attn_params(cfg, "attn") + _ffn_params(cfg, cfg.d_ff) + 2 * cfg.d_model
        )
        cross = cfg.num_layers * (_attn_params(cfg, "attn") + cfg.d_model)
        n += enc + cross
    return n


# ---------------------------------------------------------------------------
# Run / shape configs
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                                # "train" | "prefill" | "decode"


# the input shapes the dry-run tools (launch/dryrun.py) count a step at
INPUT_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 1_000
    remat: bool = True
    seed: int = 0
