"""Analytic roofline simulator: the cost model under the AutoTuner.

A copy of ``repro.core.simulator`` (numpy only).  The wall-clock terms of
an SD round (T_T, T_D, T_reject) come from a component-level roofline
model of one accelerator (or a group of ``num_chips``):

  per component: time = max(flops / (F_peak·eff_c), bytes / (BW·eff_m))
                        + op_overhead

summed over layer components (attention projections, attention scores/KV
read, dense FFN, MoE experts, embedding head).  The MoE term embeds the
paper's two effects directly:

  * number of activated experts N(t)  →  expert weight bytes loaded,
  * per-expert token load T̄_exp(t;ρ)  →  per-expert compute-vs-load max().

Two hardware records: ``V5E`` (the reference's default, a TPU v5e, kept so
parity tests price the same hardware as the reference) and ``H100`` (the
port's default, an NVIDIA H100 SXM5 80GB from its data sheet).  σ/α come
from real runs of the SD engine; the simulator only prices time.
``core/target_efficiency.py`` measures the same T_T on the card, so the
two can be printed side by side.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.configs.base import ModelConfig, _ssm_params
from repro_torch.core.analytics import (expected_activated_experts,
                                       mean_tokens_per_expert)


@dataclass(frozen=True)
class Hardware:
    name: str = "tpu-v5e"
    peak_flops: float = 197e12            # bf16 FLOP/s per chip
    hbm_bw: float = 819e9                 # bytes/s per chip
    ici_bw: float = 50e9                  # bytes/s per link
    vmem_bytes: int = 16 * 2 ** 20
    compute_eff: float = 0.85             # achievable fraction of peak
    mem_eff: float = 0.75
    op_overhead: float = 2e-6             # fixed per-component dispatch cost
    num_chips: int = 1                    # tensor/expert-parallel group size

    @property
    def ridge_point(self) -> float:
        return self.peak_flops / self.hbm_bw


V5E = Hardware()

# NVIDIA H100 SXM5 80GB.  Peaks are data-sheet figures (the same ones behind
# the kernel bounds of chip_smoke.py); the three efficiencies are NOT fitted
# to measurements on the card: a fitted cost model is SpeedupModel.fit's job.
H100 = Hardware(
    name="h100-sxm5-80gb",
    peak_flops=989e12,          # dense bf16 tensor-core FLOP/s, data sheet
    hbm_bw=3.35e12,             # HBM3 bytes/s, data sheet
    ici_bw=450e9,               # NVLink 4: 900 GB/s a GPU (data sheet), 450 a way
    vmem_bytes=228 * 2 ** 10,   # shared memory of one SM, data sheet
    compute_eff=0.85,           # the reference's V5E value, kept
    mem_eff=0.75,               # the reference's V5E value, kept
    op_overhead=2e-6,           # the reference's per-component cost, kept
)


def _component_time(flops: float, bytes_: float, hw: Hardware) -> float:
    n = max(hw.num_chips, 1)
    tc = flops / (hw.peak_flops * hw.compute_eff * n)
    tm = bytes_ / (hw.hbm_bw * hw.mem_eff * n)
    return max(tc, tm) + hw.op_overhead


@dataclass
class Simulator:
    hw: Hardware = H100                  # the reference defaults to V5E
    dtype_bytes: int = 2                   # bf16 weights/activations
    context_len: int = 512                 # mean KV length (paper omits KV; kept small)
    expert_offload_bw: Optional[float] = None
    # paper §3.4 "extended configurations": when expert weights live in host
    # memory, their load bandwidth drops from HBM to PCIe/DMA — the system
    # becomes more memory-bound and the SD window widens.  Set e.g. 64e9.

    # ------------------------------------------------------------------ FFN
    def _dense_ffn_time(self, cfg: ModelConfig, t: int) -> float:
        f = cfg.d_ff
        flops = 2.0 * t * 3 * cfg.d_model * f
        bytes_ = 3.0 * cfg.d_model * f * self.dtype_bytes
        return _component_time(flops, bytes_, self.hw)

    def _moe_ffn_time(self, cfg: ModelConfig, t: int) -> float:
        E, K, f = cfg.num_experts, cfg.num_experts_per_tok, cfg.moe_d_ff
        n_act = expected_activated_experts(t, E, K)
        t_exp = mean_tokens_per_expert(t, cfg.moe_sparsity)
        expert_bytes = 3.0 * cfg.d_model * f * self.dtype_bytes
        expert_flops = 2.0 * t_exp * 3 * cfg.d_model * f
        load_bw = (self.expert_offload_bw if self.expert_offload_bw
                   else self.hw.hbm_bw * self.hw.mem_eff)
        per_expert = max(
            expert_flops / (self.hw.peak_flops * self.hw.compute_eff),
            expert_bytes / load_bw,
        )
        # experts execute across the parallel group; router is negligible
        n = max(self.hw.num_chips, 1)
        total = per_expert * float(n_act) / n + self.hw.op_overhead
        if cfg.num_shared_experts:
            total += self._dense_ffn_time(
                cfg.with_overrides(d_ff=f * cfg.num_shared_experts), t)
        return total

    # ------------------------------------------------------------ attention
    def _attn_time(self, cfg: ModelConfig, batch: int, s: int, kind: str) -> float:
        t = batch * s
        hd = cfg.head_dim
        if kind == "mla":
            pbytes = (cfg.d_model * (cfg.mla_kv_lora_rank + cfg.mla_qk_rope_dim)
                      + cfg.mla_kv_lora_rank * cfg.num_heads
                      * (cfg.mla_qk_nope_dim + cfg.mla_v_head_dim)
                      + cfg.d_model * cfg.num_heads * (cfg.mla_qk_nope_dim + cfg.mla_qk_rope_dim)
                      + cfg.num_heads * cfg.mla_v_head_dim * cfg.d_model) * self.dtype_bytes
            kv_entry = (cfg.mla_kv_lora_rank + cfg.mla_qk_rope_dim)
        else:
            pbytes = (cfg.d_model * (cfg.num_heads + 2 * cfg.num_kv_heads) * hd
                      + cfg.num_heads * hd * cfg.d_model) * self.dtype_bytes
            kv_entry = 2 * cfg.num_kv_heads * hd
        proj_flops = 2.0 * t * pbytes / self.dtype_bytes
        ctx = self.context_len if kind != "swa" else min(
            self.context_len, cfg.sliding_window or self.context_len)
        kv_bytes = batch * ctx * kv_entry * self.dtype_bytes
        score_flops = 2.0 * t * ctx * cfg.num_heads * hd * 2
        return (_component_time(proj_flops, pbytes, self.hw)
                + _component_time(score_flops, kv_bytes, self.hw))

    def _recurrent_time(self, cfg: ModelConfig, batch: int, s: int, kind: str) -> float:
        t = batch * s
        pbytes = _ssm_params(cfg, kind) * self.dtype_bytes
        flops = 2.0 * t * pbytes / self.dtype_bytes
        # recurrent state read/write per step
        if kind == "mamba":
            state = batch * cfg.ssm_expand * cfg.d_model * cfg.ssm_state_dim * 4
        elif kind == "mlstm":
            d_in = 2 * cfg.d_model
            state = batch * cfg.num_heads * (d_in // cfg.num_heads) ** 2 * 4
        else:
            state = batch * cfg.d_model * 4
        return _component_time(flops, pbytes + state * s, self.hw)

    # -------------------------------------------------------------- forward
    def forward_time(self, cfg: ModelConfig, batch: int, s: int,
                     context_len: Optional[int] = None) -> float:
        """Seconds for one forward of ``s`` tokens per sequence, batch B."""
        if context_len is not None:
            old = self.context_len
            self.context_len = context_len
        t = batch * s
        total = 0.0
        for kind, is_moe in zip(cfg.layer_pattern, cfg.moe_pattern):
            if kind in ("attn", "swa", "mla"):
                lt = self._attn_time(cfg, batch, s, kind)
            else:
                lt = self._recurrent_time(cfg, batch, s, kind)
            if is_moe:
                lt += self._moe_ffn_time(cfg, t)
            elif kind not in ("mlstm", "slstm") and cfg.d_ff > 0:
                lt += self._dense_ffn_time(cfg, t)
            total += lt * cfg.num_periods
        # unembedding (head) — embedding gather is negligible
        head_bytes = cfg.vocab_size * cfg.d_model * self.dtype_bytes
        total += _component_time(2.0 * t * cfg.vocab_size * cfg.d_model,
                                 head_bytes, self.hw)
        if context_len is not None:
            self.context_len = old
        return total

    # ------------------------------------------------------- raw cost census
    def forward_costs(self, cfg: ModelConfig, batch: int, s: int,
                      context_len: Optional[int] = None,
                      train: bool = False) -> dict:
        """Analytic (FLOPs, HBM bytes) census for one forward (or train
        step) — the roofline numerator (the reference's launch/roofline.py
        uses it where XLA's cost analysis counts scan bodies once)."""
        ctx = context_len if context_len is not None else self.context_len
        t = batch * s
        flops = 0.0
        pbytes_total = 0.0
        act_bytes = 0.0
        kv_bytes = 0.0
        d = cfg.d_model
        for kind, is_moe in zip(cfg.layer_pattern, cfg.moe_pattern):
            if kind in ("attn", "swa", "mla"):
                if kind == "mla":
                    pb = (d * (cfg.mla_kv_lora_rank + cfg.mla_qk_rope_dim)
                          + cfg.mla_kv_lora_rank * cfg.num_heads
                          * (cfg.mla_qk_nope_dim + cfg.mla_v_head_dim)
                          + d * cfg.num_heads * (cfg.mla_qk_nope_dim + cfg.mla_qk_rope_dim)
                          + cfg.num_heads * cfg.mla_v_head_dim * d)
                    kv_entry = cfg.mla_kv_lora_rank + cfg.mla_qk_rope_dim
                else:
                    pb = (d * (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim
                          + cfg.num_heads * cfg.head_dim * d)
                    kv_entry = 2 * cfg.num_kv_heads * cfg.head_dim
                c = ctx if kind != "swa" else min(ctx, cfg.sliding_window or ctx)
                # causal masking halves effective score FLOPs when the
                # queries span the context (train/prefill); decode steps
                # (s << ctx) attend the full prefix
                causal_frac = 0.5 if s > 1 and s == ctx else 1.0
                flops += (2.0 * t * pb
                          + 2.0 * t * c * cfg.num_heads * cfg.head_dim * 2
                          * causal_frac)
                pbytes_total += pb * self.dtype_bytes
                kv_bytes += batch * c * kv_entry * self.dtype_bytes
            else:
                pb = _ssm_params(cfg, kind)
                flops += 2.0 * t * pb
                pbytes_total += pb * self.dtype_bytes
            if is_moe:
                E, K, f = cfg.num_experts, cfg.num_experts_per_tok, cfg.moe_d_ff
                n_act = float(expected_activated_experts(t, E, K))
                flops += 2.0 * t * K * 3 * d * f
                pbytes_total += n_act * 3 * d * f * self.dtype_bytes
                if cfg.num_shared_experts:
                    fs = f * cfg.num_shared_experts
                    flops += 2.0 * t * 3 * d * fs
                    pbytes_total += 3 * d * fs * self.dtype_bytes
            elif kind not in ("mlstm", "slstm") and cfg.d_ff > 0:
                flops += 2.0 * t * 3 * d * cfg.d_ff
                pbytes_total += 3 * d * cfg.d_ff * self.dtype_bytes
            act_bytes += 4 * t * d * self.dtype_bytes
        flops *= cfg.num_periods
        pbytes_total *= cfg.num_periods
        kv_bytes *= cfg.num_periods
        act_bytes *= cfg.num_periods
        # head: train reads every position, inference only the sampled ones
        head_t = t if train else batch
        flops += 2.0 * head_t * d * cfg.vocab_size
        pbytes_total += cfg.vocab_size * d * self.dtype_bytes
        if cfg.is_encoder_decoder:
            enc_pb = cfg.encoder_layers * (
                (4 * d * d) + 3 * d * cfg.d_ff) * self.dtype_bytes
            pbytes_total += enc_pb
            flops += 2.0 * batch * cfg.encoder_seq_len * enc_pb / self.dtype_bytes
        if train:
            flops *= 3.0                                  # fwd + bwd
            pbytes_total *= 3.0                           # read + grad write + opt
            act_bytes *= 2.0
        return {"flops": flops,
                "bytes": pbytes_total + act_bytes + kv_bytes}

    def reject_time(self, batch: int, gamma: int, vocab: int) -> float:
        """Rejection sampling: O(B * gamma * V) elementwise + sampling."""
        bytes_ = 3.0 * batch * (gamma + 1) * vocab * 4
        return _component_time(batch * gamma * vocab * 4.0, bytes_, self.hw)

    # -------------------------------------------------------------- SD time
    def sd_round_time(self, target: ModelConfig, draft: ModelConfig,
                      batch: int, gamma: int) -> dict:
        propose = (gamma + 1) * self.forward_time(draft, batch, 1)
        verify = self.forward_time(target, batch, gamma + 1)
        reject = self.reject_time(batch, gamma, target.vocab_size)
        return {"propose": propose, "verify": verify, "reject": reject,
                "total": propose + verify + reject}

    def sd_speedup(self, target: ModelConfig, draft: ModelConfig,
                   batch: int, gamma: int, sigma: float) -> float:
        """Paper Eq. 4 with engine semantics (gamma+1-token verify)."""
        round_t = self.sd_round_time(target, draft, batch, gamma)["total"]
        t_ar = self.forward_time(target, batch, 1)
        return sigma * (gamma + 1) * t_ar / round_t

    def target_efficiency(self, target: ModelConfig, batch: int, gamma: int) -> float:
        return (self.forward_time(target, batch, 1)
                / self.forward_time(target, batch, gamma + 1))
