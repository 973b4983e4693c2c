#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed N]

Phases, each of which fails the run if it fails:

  1. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
  2. build every CUDA kernel of the path from the sources in this checkout,
     one nvcc per source, all at once, and print the build time; beside it
     ``ptxas -v`` of the TMA + wgmma kernels (flash prefill at head dims 32,
     64, 128 with one and two consumer warpgroups; capacity GEMM with 1 and 2 consumer warpgroups and column
     tiles of 128 and 256; paged and dense decode/verify at head dims 64 and
     128; ragged down and fused gate/up GEMMs, silu and gelu): registers,
     dynamic shared memory, spills;
  3. kernels: at the main paths' shapes, run each kernel and its plain
     PyTorch version on the same inputs made from --seed, hold them within
     the stated tolerance and time both beside the card's bound:
       * the ragged expert-FFN kernels (SD verify: 320 routed rows, top-8 of
         64 experts; AR verify: 64 rows; prefill: 4096 rows; empty experts
         with unaligned groups), bf16, rtol = atol = 3e-2
         (tests/test_ragged_gmm.py); each case prints the items of the
         fused kernel (expert chunks x column tiles) beside the visit count
         of the old visit list, and the expert-chunk count of the down
         kernel (ragged.expert_chunks); both kernels must report the TMA +
         wgmma route (ragged.LAST_ROUTE); the fused kernel's two products
         alone (torch._grouped_mm over a copy of [Wg | Wu], no act * mul)
         are timed on a line of their own, as context, not its yardstick;
       * the paged decode/verify attention kernel (28 query / 4 KV heads,
         pages of 64, noise in every page, a permuted table, ragged
         lengths): SD verify (B 8, T 5), AR verify (T 1), long context
         (~8k positions), logit cap 30, head dims 64 and 256, bf16 at
         rtol = atol = 2e-2 and, where it runs the split-KV TMA + wgmma
         body (paged.LAST_ROUTE "sm90": head dims 64 and 128), every
         element within PAGED_ROW_TOL x the rms of its output row; SD verify
         and long context also in fp32 at 2e-5 (the reference's bound,
         src/repro/kernels/decode_attention/decode_attention.py:288);
       * the flash prefill kernel (prefill of 8 prompts of 256 tokens at the
         target's 28/4 heads of 128 and the draft's 14/2 heads of 64, a 4096-
         token prefill, a window-and-cap case), bf16 at rtol = atol = 3e-2
         and every element within 5e-2 of the rms of its output row (the
         late rows of a long prefill are smaller than 3e-2) through the
         TMA + wgmma kernel, and fp32 at the reference's 2e-5 through the
         CUDA-core body (tests/test_kernels.py);
       * the dense decode/verify kernel on the (B, S+1, Hkv, D) cache layout:
         SD verify (B 8, T 5, S 512, lengths 129-290), AR (T 1), the draft's
         14/2 heads of 64 at T 1 and T 5, long context (S 8192), bf16 at
         4e-2 through the split-KV TMA + wgmma body (decode_attention
         .LAST_ROUTE "sm90") and every element within DECODE_ROW_TOL x the
         rms of its output row, SD verify and long context also in fp32 at
         3e-5 through the CUDA-core body (tests/test_kernels.py);
       * the capacity-binned expert GEMM at the full expert widths (E 64,
         D 3584, F 2560, gate/up and down) at the SD-verify capacity
         expert_capacity(40, 8, 64) = 128 and a prefill capacity
         expert_capacity(2048, 8, 64) = 512, bf16 at 2e-2 through the TMA +
         wgmma kernel, fp32 at 1e-5 through the CUDA-core one
         (tests/test_kernels.py);
     each kernel is also timed beside one PyTorch call that computes the
     same function and that the port never calls (the yardstick), eagerly
     and on the device alone (calls captured in one CUDA graph); each
     flash, paged, ragged (fused and down) and capacity case prints the
     kernel its launch ran (route: gmm._route, the wrapper's dispatch, for the
     capacity GEMM; for the others the kernel their launcher reports), and
     a bf16 case that did not run the TMA + wgmma kernel fails the run;
  4. reference: on the reduced qwen2-57b-a14b in fp32, the CUDA path agrees
     with the port's plain CPU path (which the CPU tests hold against the JAX
     reference) and greedy SD equals greedy AR; greedy SD from CUDA-graph
     replay equals the eager card round's and the CPU round's token for
     token; a continuous paged stream (6 requests, Poisson arrivals, one
     late long prompt that grows the session) emits the same tokens from
     graph replay, eagerly on the card and on the CPU, and SD the same as
     AR; with use_flash=True on the reduced target and draft
     (prompts of 129-256 tokens: prompt bucket 256, max_seq 512), the CUDA
     path agrees with the CPU path, greedy SD equals greedy AR and the
     greedy outputs equal those with use_flash=False;
  5. serve: qwen2-57b-a14b at its full published width, depth cut to LAYERS
     of 28, with the full qwen2-0.5b draft and random weights from --seed,
     greedy, gamma 4, max-batch 8.  First one captured round's verify
     logits (bf16) are held against the eager round's on the same state
     within rtol = atol = 3e-2, with the argmax agreement printed.  Then
     each path, first with the "model" proposer (SD), then "none" (AR),
     every round from CUDA graphs (core/graphs.py), its workload run twice
     on one engine: the second run must capture nothing, replays every
     round under torch.cuda.set_sync_debug_mode("error") up to its one
     readback, and each path prints its captures, replays, capture time
     and graph-pool memory:
       * ServingEngine(scheduler="wave"): 16 requests, max-new 32, with the
         default (untimed) round; after it, two waves of 8 on an engine with
         the timed round (three stage graphs) give the propose/verify/
         reject breakdown of the second, and on the wave paths the same
         waves run eagerly (cuda_graphs=False), graphs against eager in one
         run (tok/s and the propose share of the timed round);
       * ServingEngine(scheduler="continuous", kv_layout="paged",
         page_size=64): 16 chat prompts with Poisson arrivals (0.5 per
         round, max-new 8/16/32) plus a 700-token prompt at round 6 that
         grows the page pool mid-stream;
       * ServingEngine(scheduler="wave") over Model(..., use_flash=True)
         target and draft ("wave-flash"): 16 prompts of 129-256 tokens
         (long system or RAG prompts), max-new 32, so every prefill runs the
         flash kernel and every extend (max_seq 512) the dense decode kernel;
  6. tuner: the serving CLI's AutoTuner (launch/serve.make_tuner, priced on
     the full published config on the H100 record).  On the serve phase's
     full-width target and draft, after the fixed-gamma serve lines: a
     captured gamma-8 round's verify logits against the eager round's
     (dense, and paged, where 9 queries take the gathered view) within
     rtol = atol = 3e-2, then
       a. measured target efficiency: for B in 1..128, one extend of T
          random tokens per row (T 1..9) on a cache prefilled with 64
          tokens, captured in a CUDA graph and replayed
          (core/target_efficiency.py), T_T(B,1), T_T(B,5) and eta_target
          beside the token-0 extends the reference times and the H100
          simulator's, and one draft extend T_D(B,1) beside its price;
       d. the plans: AutoTuner.plan(B) and speedup_window() at alpha 0.7
          for the CLI's tuner, the full config with the served draft and the
          4-layer config with it, and beside the last the plan of the same
          tuner whose simulator returns the measured T_T and T_D;
       b. tuner-driven wave serving (the wave workload of phase 5), each
          wave's plan, alpha before and after, tok/s, captures and replays;
       c. tuner-driven continuous paged serving (the continuous workload of
          phase 5), the plan per round against N(t), captures per gamma key
          and the graph pool; an SD->AR hand-off is required;
     b and c run their workload twice on one engine, the tuner's alpha reset
     to 0.7 between: the repeat plans the same and captures nothing.  Times
     are only required to be finite and positive; bf16 outputs are printed
     beside the tuner-less AR run's, not required to equal them.  Last, on
     the reduced target in fp32: waves (12 requests, max-batch 2) and the
     continuous paged stream of phase 4, planned per wave and per round
     through gamma changes and the SD->AR hand-off, must give the
     tuner-less AR run's greedy tokens on the card and the tuner-driven CPU
     run's, with the same plans on both devices.
  7. ops: the capacity-binned MoE FFN (kernels/gmm/ops.py) at full width in
     fp32, top-8 routing of 40 tokens: moe_ffn_gmm (3 launches) and
     gmm_legacy (1 launch), held against the ragged dispatch, moe_ffn_ref
     and ragged_gmm.
     Each path runs with every launch count set to 0 just before it and
     read just after (replays credit the launches their capture recorded):
     each gmm kernel's count must equal (MoE layers x that
     path's target forwards); on the continuous paths the paged kernel's
     must equal (attention layers x rounds); on the wave-flash paths the
     flash kernel's must equal (attention layers x prefill forwards) and
     the dense decode kernel's (attention layers x extend forwards), summed
     over target and draft; every other count must be 0.  The tuner's three
     paths (tuner/eta, tuner/wave, tuner/continuous) are counted the same
     way.

It ends with a JSON line of per-kernel numbers and, last, the device line.
Without a card, or outside a checkout of the repository, it exits non-zero
and prints no result.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, published, at 700 W
BF16_FLOPS = 989e12                # dense bf16 tensor-core peak, published
FP32_FLOPS = 67e12                 # fp32 outside the tensor cores, published
TOL = 3e-2                         # rtol and atol, tests/test_ragged_gmm.py
# paged attention: bf16 output rounding; fp32 the reference's own bound
PAGED_TOL = {"bfloat16": 2e-2, "float32": 2e-5}
# bf16 paged attention on the split-KV body, besides PAGED_TOL: every
# element within PAGED_ROW_TOL x the rms of its output row.  At ~8k keys a
# row averages ~8k values of v, |out| ~ 0.011, below PAGED_TOL itself.  On
# patched copies of the kernel (kernel_variants.py mutants) a dropped split
# put the long-context case's worst element at 2.6 x its row's rms and a
# stale 64-key chunk at 1.6 x; the sound kernel stays at <= 0.025 x (bf16
# rounding of P and of the output; PERF.md).
PAGED_ROW_TOL = 5e-2
# the reference's bounds, tests/test_kernels.py
FLASH_TOL = {"bfloat16": 3e-2, "float32": 2e-5}
# bf16 flash, besides FLASH_TOL: every element within FLASH_ROW_TOL x the rms
# of its output row (b, t, h).  Row t averages t + 1 values of v, so its
# |out| ~ 1/sqrt(t + 1), 0.016 at t 4095: below FLASH_TOL itself.  A stale or
# skipped 128-key chunk moves such a row by ~sqrt(128)/(t + 1), 18 % of its
# rms; one bf16 rounding of a row's largest element is ~3 %.
FLASH_ROW_TOL = 5e-2
DECODE_TOL = {"bfloat16": 4e-2, "float32": 3e-5}
# bf16 dense decode on the split-KV body, besides DECODE_TOL: every element
# within DECODE_ROW_TOL x the rms of its output row.  At 8k keys |out| ~
# 0.011, below DECODE_TOL itself; the faults of kernel_variants.py (the
# combine leaving out the last live split, a chunk loaded from the previous
# chunk's keys) must fail it at long context while the sound kernel passes.
DECODE_ROW_TOL = 5e-2
GMM_TOL = {"bfloat16": 2e-2, "float32": 1e-5}
# Target depth at full width: the bf16 weights of all 28 layers (57.4B
# parameters, ~115 GB) do not fit in the card's 80 GB; 4 layers are ~18 GB.
LAYERS = 4
TPU_SITES = {                      # the Pallas kernel each CUDA kernel replaces
    "fused_gate_up": "src/repro/kernels/gmm/ragged.py:124",    # _fused_kernel
    "ragged_gmm": "src/repro/kernels/gmm/ragged.py:104",       # _ragged_kernel
    # _paged_decode_kernel
    "paged_decode_attention":
        "src/repro/kernels/decode_attention/decode_attention.py:78",
    "decode_attention":                                        # _decode_kernel
        "src/repro/kernels/decode_attention/decode_attention.py:28",
    "flash_attention":                                         # _flash_kernel
        "src/repro/kernels/flash_attention/flash_attention.py:27",
    "gmm_capacity": "src/repro/kernels/gmm/gmm.py:26",         # _gmm_kernel
}
SOURCES = {
    "fused_gate_up": "src/repro_torch/kernels/gmm/csrc/ragged_gmm.cu",
    "ragged_gmm": "src/repro_torch/kernels/gmm/csrc/ragged_gmm.cu",
    "paged_decode_attention":
        "src/repro_torch/kernels/decode_attention/csrc/"
        "paged_decode_attention.cu",
    "decode_attention":
        "src/repro_torch/kernels/decode_attention/csrc/decode_attention.cu",
    "flash_attention":
        "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
    "gmm_capacity": "src/repro_torch/kernels/gmm/csrc/gmm_capacity.cu",
}
PATHS = ("wave/model", "wave/none", "continuous/model", "continuous/none",
         "wave-flash/model", "wave-flash/none")
OPS_PATH = "ops/moe_ffn_gmm"
MAIN_PATH = {"fused_gate_up": "wave/model", "ragged_gmm": "wave/model",
             "paged_decode_attention": "continuous/model",
             "decode_attention": "wave-flash/model",
             "flash_attention": "wave-flash/model",
             "gmm_capacity": OPS_PATH}
MAIN_CASE = {"fused_gate_up": "verify", "ragged_gmm": "verify",
             "paged_decode_attention": "sd_verify",
             "decode_attention": "sd_verify",
             "flash_attention": "prefill_target",
             "gmm_capacity": "sd_verify_gate_up"}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, *, warmup: int = 2, iters: int = 10) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_time_ms(fn, *, calls: int = 20, iters: int = 5):
    """Device time per call without the host's cost of submitting it:
    ``calls`` calls captured in one CUDA graph, the graph replayed ``iters``
    times.  An eager call of a short kernel costs the host more than the
    device (the wrapper's checks and the launch), so events around eager
    calls time the host there.  None when the call cannot be captured."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            for _ in range(calls):
                fn()
    except RuntimeError:
        torch.cuda.synchronize()
        return None
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (iters * calls)
    del graph
    return ms


def _fmt(ms) -> str:
    return "-" if ms is None else f"{ms:.4f} ms"


def bound_ms(bytes_moved: float, flops: float, peak: float = BF16_FLOPS):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# --------------------------------------------------------------------- build
def _counted_modules():
    """Every kernel wrapper module: each has SOURCE, LAUNCHES and
    reset_launch_counts()."""
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.decode_attention import paged
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.gmm import gmm, ragged
    return (ragged, paged, dec_ops, flash_attention, gmm)


def build_kernels():
    """Build every library (one nvcc each, all at once); print the build
    time and, from ``ptxas -v`` of the build, the registers, shared memory
    and spills of the TMA + wgmma kernels."""
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.decode_attention import paged
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.gmm import gmm, ragged
    sources = tuple(m.SOURCE for m in _counted_modules())
    t0 = time.perf_counter()
    build.build_all(sources)
    for src in sources:
        build.load(src)
    t_build = time.perf_counter() - t0
    reports = {src: build.ptxas_report(src)
               for src in (flash_attention.SOURCE, gmm.SOURCE, paged.SOURCE,
                           dec_ops.SOURCE, ragged.SOURCE)}
    log(f"build: {t_build:.1f} s -> " + ", ".join(
        str(build.library_path(src).relative_to(ROOT)) for src in sources))
    smem = {"flash_sm90_kernel": build.load(
                flash_attention.SOURCE).flash_sm90_smem_bytes,
            "gmm_capacity_sm90_kernel": build.load(
                gmm.SOURCE).gmm_capacity_sm90_smem_bytes,
            "paged_sm90_kernel": build.load(paged.SOURCE).paged_sm90_smem_bytes,
            "decode_sm90_kernel": build.load(
                dec_ops.SOURCE).decode_sm90_smem_bytes,
            "ragged_sm90_kernel": build.load(
                ragged.SOURCE).ragged_sm90_smem_bytes}     # (nmat, act)
    seen = set()
    for src, text in reports.items():
        for line in text.splitlines():
            if "(C75" in line and "sm90_kernel" in line:   # ptxas's advisories
                log(f"ptxas ({src.name}): {line.strip()[:240]}")
        for kernel, args, regs, spills in _ptxas_entries(text):
            seen.add((kernel, args))
            log(f"ptxas {kernel}<{', '.join(map(str, args))}> ({src.name}): "
                f"{regs} registers at entry, {smem[kernel](*args)} bytes "
                f"dynamic shared memory, {spills}")
    want = ({("flash_sm90_kernel", (d, nc)) for d in (32, 64, 128)
             for nc in (1, 2)}
            | {("gmm_capacity_sm90_kernel", a)
               for a in ((1, 128), (2, 128), (2, 256))}
            | {("paged_sm90_kernel", (d,)) for d in (64, 128)}
            | {("decode_sm90_kernel", (d,)) for d in (64, 128)}
            | {("ragged_sm90_kernel", a) for a in ((1, 0), (2, 0), (2, 1))})
    if seen != want:
        raise AssertionError(f"ptxas -v shows TMA + wgmma kernels {sorted(seen)}"
                             f", expected {sorted(want)}")


def _ptxas_entries(text: str, kernels=("flash_sm90_kernel",
                                        "gmm_capacity_sm90_kernel",
                                        "paged_sm90_kernel",
                                        "decode_sm90_kernel",
                                        "ragged_sm90_kernel")):
    """(kernel, template arguments, registers, spill line) for each entry
    function of ``kernels`` in ``ptxas -v`` output."""
    pattern = re.compile(r"Compiling entry function '\w*?(%s)(?:I((?:Li\d+E)+)E)?"
                         % "|".join(kernels))
    name = args = spills = None
    for line in text.splitlines():
        m = pattern.search(line)
        if m:
            name = m.group(1)
            args = tuple(int(a) for a in re.findall(r"Li(\d+)E",
                                                    m.group(2) or ""))
        elif name and "spill stores" in line:
            spills = line.strip()
        elif name and "Used" in line:
            regs = re.search(r"Used (\d+) registers", line)
            yield name, args, int(regs.group(1)), spills
            name = None


def reset_launch_counts():
    for m in _counted_modules():
        m.reset_launch_counts()


def launch_counts() -> dict:
    counts = {}
    for m in _counted_modules():
        counts.update(m.LAUNCHES)
    return counts


# ------------------------------------------------------------------- kernels
def _hold(name: str, case: str, out, ref, tol: float, res: dict) -> float:
    """Fail unless the kernel's output is finite and within rtol = atol =
    tol of its plain version; record the worst error.  Returns it."""
    import torch
    err = (out.float() - ref.float()).abs()
    over = err / (tol + tol * ref.float().abs())
    if not torch.isfinite(out).all() or (over > 1).any():
        raise AssertionError(
            f"{name} [{case}]: kernel disagrees with its plain version "
            f"(max abs err {err.max().item():.4g}, "
            f"{int((over > 1).sum())} elements outside rtol=atol={tol})")
    res["max_abs_err"] = max(res["max_abs_err"], err.max().item())
    res["max_err_over_tol"] = max(res["max_err_over_tol"], over.max().item())
    return err.max().item()


def row_scaled_err(out, ref) -> float:
    """The largest |out - ref| over the rms of ref's row (the last dim)."""
    ref = ref.float()
    rms = ref.square().mean(-1, keepdim=True).sqrt()
    return ((out.float() - ref).abs() / rms).max().item()


def _library(fn, label: str):
    """A yardstick call the port never makes, if this build takes it:
    (fn or None, label)."""
    try:
        fn()
    except (RuntimeError, TypeError, ValueError) as e:
        return None, f"{label} refused: {str(e).splitlines()[0]}"
    return fn, label


def routed_sizes(n_tokens: int, E: int, K: int, gen, dev):
    """Group sizes of top-K routing of random router logits."""
    import torch
    logits = torch.randn((n_tokens, E), generator=gen, device=dev)
    idx = logits.topk(K, dim=-1).indices.reshape(-1)
    return torch.bincount(idx, minlength=E).to(torch.int32)


def grouped_mm_library(h, w, sizes):
    """One PyTorch call computing the ragged product, where this build has
    one (torch._grouped_mm with offsets); used here only as a yardstick."""
    import torch
    fn = getattr(torch, "_grouped_mm", None)
    if fn is None:
        return None, "torch._grouped_mm is not in this build"
    offs = torch.cumsum(sizes, 0).to(torch.int32)
    try:
        fn(h, w, offs=offs)
    except RuntimeError as e:                      # unsupported shape/arch
        return None, f"torch._grouped_mm refused: {str(e).splitlines()[0]}"
    return (lambda: fn(h, w, offs=offs)), "torch._grouped_mm"


def ragged_cases(E: int, K: int, gen, dev) -> dict:
    """Group sizes of the ragged kernels' cases: top-K routing of the
    tokens of an SD verify, an AR verify and a prefill, and a fixed list
    with empty experts and unaligned groups."""
    import torch
    edge = torch.zeros((E,), dtype=torch.int32, device=dev)
    edge[[0, 2, 3, 5, 6, 7, 40, 63]] = torch.tensor(
        [37, 1, 129, 77, 13, 200, 3, 17], dtype=torch.int32, device=dev)
    return {
        "verify": routed_sizes(40, E, K, gen, dev),      # B=8 x (gamma+1)=5
        "ar_verify": routed_sizes(8, E, K, gen, dev),    # B=8 x 1: ~1 row/expert
        "prefill": routed_sizes(512, E, K, gen, dev),    # B=8 x T=64
        "edge": edge,                                    # empties, unaligned
    }


def kernel_phase(seed: int):
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.gmm import ragged
    from repro_torch.kernels.gmm.ref import fused_gate_up_ref, ragged_gmm_ref

    dev = torch.device("cuda")
    cfg = get_config("qwen2-57b-a14b")
    E, K, D, F = cfg.num_experts, cfg.num_experts_per_tok, cfg.d_model, cfg.moe_d_ff
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = torch.bfloat16
    wg, wu = ((torch.randn((E, D, F), generator=gen, device=dev) / D ** 0.5).to(dt)
              for _ in range(2))
    wd = (torch.randn((E, F, D), generator=gen, device=dev) / F ** 0.5).to(dt)
    # the fused kernel's two products alone, for context: one grouped
    # product over [Wg | Wu] (made here, outside any timed region)
    wgu = torch.cat([wg, wu], dim=2)
    cases = ragged_cases(E, K, gen, dev)
    results = {name: {"cases": {}, "max_abs_err": 0.0, "max_err_over_tol": 0.0}
               for name in ("fused_gate_up", "ragged_gmm")}
    bm = ragged.sm90_chunk_rows()                     # rows of an expert chunk
    tiles_n = -(-F // ragged.sm90_tile_cols(2))      # the fused kernel's columns
    for case, sizes in cases.items():
        N = int(sizes.sum())
        active = int((sizes > 0).sum())
        xs = torch.randn((N, D), generator=gen, device=dev).to(dt)
        h = ragged.fused_gate_up(xs, wg, wu, sizes)
        routes = {"fused_gate_up": ragged.LAST_ROUTE["fused_gate_up"]}
        h_ref = fused_gate_up_ref(xs, wg, wu, sizes)
        y = ragged.ragged_gmm(h_ref, wd, sizes)
        routes["ragged_gmm"] = ragged.LAST_ROUTE["ragged_gmm"]  # as reported
        y_ref = ragged_gmm_ref(h_ref, wd, sizes)
        torch.cuda.synchronize()
        for name, route in routes.items():
            if route != "sm90":
                raise AssertionError(f"{name} [{case}]: bf16 ran the {route} "
                                     "kernel, not the TMA + wgmma one")
        for name, out, ref in (("fused_gate_up", h, h_ref),
                               ("ragged_gmm", y, y_ref)):
            _hold(name, case, out, ref, TOL, results[name])
        meta, _ = ragged._plan(xs, E, sizes, None)     # the old visit list
        visits = int(meta.num_visits[0])
        chunks = len(ragged.expert_chunks(sizes, bm))
        prod_fn, prod_name = grouped_mm_library(xs, wgu, sizes)
        products = dict(
            products_only_ms=cuda_time_ms(prod_fn) if prod_fn else None,
            products_only_graph_ms=(graph_time_ms(prod_fn, calls=10, iters=3)
                                    if prod_fn else None))
        log(f"kernel fused_gate_up [{case:9s}] products only (context, not "
            f"the yardstick: {prod_name} over [Wg | Wu], no act * mul): "
            f"{_fmt(products['products_only_ms'])} (graph "
            f"{_fmt(products['products_only_graph_ms'])})")
        timings = {
            "fused_gate_up": dict(
                fn=lambda: ragged.fused_gate_up(xs, wg, wu, sizes),
                plain_ms=cuda_time_ms(lambda: fused_gate_up_ref(xs, wg, wu, sizes),
                                      warmup=1, iters=3),
                bytes=N * D * 2 + active * 2 * D * F * 2 + E * 4 + N * F * 2,
                flops=2 * 2 * N * D * F, library=(None, "no single call"),
                work=f"items={chunks}x{tiles_n}={chunks * tiles_n:4d} "
                     f"(visit list {visits:3d}) "
                     f"route={routes['fused_gate_up']}",
                extra=dict(route=routes["fused_gate_up"], expert_chunks=chunks,
                           column_tiles=tiles_n, items=chunks * tiles_n,
                           **products)),
            "ragged_gmm": dict(
                fn=lambda: ragged.ragged_gmm(h_ref, wd, sizes),
                plain_ms=cuda_time_ms(lambda: ragged_gmm_ref(h_ref, wd, sizes),
                                      warmup=1, iters=3),
                bytes=N * F * 2 + active * F * D * 2 + E * 4 + N * D * 2,
                flops=2 * N * F * D,
                library=grouped_mm_library(h_ref, wd, sizes),
                work=f"expert chunks={chunks:3d} (bm {bm}) "
                     f"route={routes['ragged_gmm']}",
                extra=dict(route=routes["ragged_gmm"], expert_chunks=chunks,
                           chunk_rows=bm)),
        }
        for name, t in timings.items():
            b_ms, b_by = bound_ms(t["bytes"], t["flops"])
            lib_fn, lib_name = t["library"]
            ms = cuda_time_ms(t["fn"])
            graph_ms = graph_time_ms(t["fn"], calls=10, iters=3)
            lib_ms = cuda_time_ms(lib_fn) if lib_fn is not None else None
            lib_graph_ms = (graph_time_ms(lib_fn, calls=10, iters=3)
                            if lib_fn is not None else None)
            results[name]["cases"][case] = dict(
                rows=N, active_experts=active, visits=visits,
                kernel_ms=ms, kernel_graph_ms=graph_ms,
                plain_ms=t["plain_ms"], bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms, library_graph_ms=lib_graph_ms,
                library=lib_name, **t["extra"])
            log(f"kernel {name:13s} [{case:9s}] rows={N:5d} experts={active:2d} "
                f"{t['work']}  {ms:.3f} ms (graph "
                f"{_fmt(graph_ms)})  "
                f"plain {t['plain_ms']:.3f} ms  bound {b_ms:.3f} ms ({b_by})  "
                f"library {_fmt(lib_ms)} (graph {_fmt(lib_graph_ms)}; "
                f"{lib_name})")
    del wg, wu, wd, wgu
    torch.cuda.empty_cache()
    return results


PAGED_CASES = {        # name: (dtype, T, head dim, (min, max) length, cap)
    "sd_verify": ("bfloat16", 5, 128, (16, 130), 0.0),
    "ar_verify": ("bfloat16", 1, 128, (16, 130), 0.0),
    "long_context": ("bfloat16", 5, 128, (8000, 8192), 0.0),
    "capped": ("bfloat16", 5, 128, (16, 130), 30.0),
    "head_dim_64": ("bfloat16", 5, 64, (16, 130), 0.0),
    "head_dim_256": ("bfloat16", 5, 256, (16, 130), 0.0),
    # fp32 runs the CUDA-core body: its long page walk is held at the fp32
    # bound (a typical |out| at ~8k keys is near the bf16 bound; the bf16
    # split-KV body is held at PAGED_ROW_TOL for that)
    "fp32_sd_verify": ("float32", 5, 128, (16, 130), 0.0),
    "fp32_long_context": ("float32", 5, 128, (8000, 8192), 0.0),
}


def sdpa_gathered(q, kp, vp, lengths, table):
    """``F.scaled_dot_product_attention`` over the dense view gathered
    beforehand: a yardstick that excludes the gather, never used by the
    port.  Returns (fn, label)."""
    import torch
    import torch.nn.functional as F
    B, T, Hq, D = q.shape
    MP, ps = table.shape[1], kp.shape[1]
    S = MP * ps
    idx = table.to(torch.int64)
    kd = kp[idx].reshape(B, S, -1, D).transpose(1, 2).contiguous()
    vd = vp[idx].reshape(B, S, -1, D).transpose(1, 2).contiguous()
    qh = q.transpose(1, 2).contiguous()
    q_pos = lengths.to(torch.int64)[:, None] + torch.arange(T, device=q.device)
    mask = (torch.arange(S, device=q.device)[None, None, :]
            <= q_pos[:, :, None])[:, None]                     # (B, 1, T, S)

    def fn():
        return F.scaled_dot_product_attention(qh, kd, vd, attn_mask=mask,
                                              enable_gqa=True)
    try:
        fn()
    except (RuntimeError, TypeError) as e:
        return None, f"sdpa refused: {str(e).splitlines()[0]}"
    return fn, "F.scaled_dot_product_attention(enable_gqa), gather excluded"


def paged_inputs(spec, gen, dev, B: int = 8, Hq: int = 28, Hkv: int = 4,
                 ps: int = 64):
    """(q, k_pages, v_pages, lengths, table) of a PAGED_CASES entry at the
    serve widths: noise in every physical page (trash page 0 included), a
    permuted table one page wider than the longest row needs, ragged
    lengths."""
    import torch
    dtype_name, T, D, (lo, hi), _ = spec
    dt = getattr(torch, dtype_name)
    MP = -(-(hi + T) // ps) + 1
    NP = B * MP + 1                                        # page 0 = trash
    kp = torch.randn((NP, ps, Hkv, D), generator=gen, device=dev).to(dt)
    vp = torch.randn((NP, ps, Hkv, D), generator=gen, device=dev).to(dt)
    table = (torch.randperm(NP - 1, generator=gen, device=dev) + 1
             ).reshape(B, MP).to(torch.int32)
    lengths = torch.randint(lo, hi + 1, (B,), generator=gen,
                            device=dev).to(torch.int32)
    q = torch.randn((B, T, Hq, D), generator=gen, device=dev).to(dt)
    return q, kp, vp, lengths, table


def paged_kernel_phase(seed: int):
    """The paged decode/verify kernel against its plain version at the
    serve widths (28 query / 4 KV heads, pages of 64)."""
    import torch
    from repro_torch.kernels.decode_attention import paged
    from repro_torch.kernels.decode_attention.ref import \
        paged_decode_attention_plain

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    res = {"cases": {}, "max_abs_err": 0.0, "max_err_over_tol": 0.0}
    for case, spec in PAGED_CASES.items():
        dtype_name, T, D, _, cap = spec
        args = paged_inputs(spec, gen, dev)
        q, kp, vp, lengths, table = args
        B, Hq, Hkv = q.shape[0], q.shape[2], kp.shape[2]
        MP, ps = table.shape[1], kp.shape[1]
        out = paged.paged_decode_attention(*args, logit_cap=cap)
        route = paged.LAST_ROUTE["paged_decode_attention"]
        ref = paged_decode_attention_plain(*args, logit_cap=cap)
        torch.cuda.synchronize()
        want = "sm90" if dtype_name == "bfloat16" and D in (64, 128) else "simt"
        if route != want:
            raise AssertionError(f"paged_decode_attention [{case}]: ran the "
                                 f"{route} body, expected {want}")
        tol = PAGED_TOL[dtype_name]
        err = _hold("paged_decode_attention", case, out, ref, tol, res)
        row_err = row_scaled_err(out, ref)
        if route == "sm90" and row_err > PAGED_ROW_TOL:
            raise AssertionError(
                f"paged_decode_attention [{case}]: an element is "
                f"{row_err:.3g} x the rms of its row from the plain version "
                f"(bound {PAGED_ROW_TOL})")
        # bytes the call must move: K and V at the keys 0..length+T-1 of
        # each row, the table entries of the pages those keys lie in, the
        # lengths, q and out
        keys = sum(min(int(n) + T, MP * ps) for n in lengths.tolist())
        touched = sum(-(-min(int(n) + T, MP * ps) // ps)
                      for n in lengths.tolist())
        elem = q.element_size()
        n_bytes = (keys * Hkv * D * 2 * elem + 2 * q.numel() * elem
                   + lengths.numel() * 4 + touched * 4)
        flops = 2 * 2 * Hq * T * keys * D
        b_ms, b_by = bound_ms(n_bytes, flops, BF16_FLOPS
                              if dtype_name == "bfloat16" else FP32_FLOPS)
        ms = cuda_time_ms(lambda: paged.paged_decode_attention(
            *args, logit_cap=cap), warmup=3, iters=20)
        plain_ms = cuda_time_ms(lambda: paged_decode_attention_plain(
            *args, logit_cap=cap), warmup=1, iters=3)
        sdpa_fn, sdpa_label = (sdpa_gathered(*args) if cap == 0.0
                               else (None, "sdpa has no logit cap"))
        sdpa_ms = cuda_time_ms(sdpa_fn, warmup=2, iters=10) \
            if sdpa_fn is not None else None
        graph_ms = graph_time_ms(lambda: paged.paged_decode_attention(
            *args, logit_cap=cap))
        sdpa_graph_ms = graph_time_ms(sdpa_fn) if sdpa_fn is not None else None
        res["cases"][case] = dict(
            dtype=dtype_name, route=route, B=B, T=T, head_dim=D, page_size=ps,
            lengths=[int(n) for n in lengths.tolist()], keys=keys,
            pages_touched=touched,
            kernel_ms=ms, kernel_graph_ms=graph_ms, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by,
            bytes=n_bytes, library_ms=None,
            library="no single call walks a block table",
            sdpa_gathered_ms=sdpa_ms, sdpa_gathered_graph_ms=sdpa_graph_ms,
            sdpa_gathered=sdpa_label,
            max_abs_err=err, tol=tol, max_row_scaled_err=row_err)
        log(f"kernel paged_decode_attention [{case:14s}] {dtype_name} "
            f"route={route} T={T} "
            f"D={D} keys={keys:5d} pages={touched:4d}  {ms:.4f} ms "
            f"(graph {_fmt(graph_ms)})  "
            f"plain {plain_ms:.3f} ms  "
            f"bound {b_ms:.4f} ms ({b_by})  sdpa "
            f"{'-' if sdpa_ms is None else f'{sdpa_ms:.4f} ms'} "
            f"(graph {_fmt(sdpa_graph_ms)}; {sdpa_label})  max err {err:.3g}, "
            f"{row_err:.3g} x row rms")
        del args, kp, vp, q, out, ref
    torch.cuda.empty_cache()
    return res


FLASH_CASES = {  # name: (dtype, B, T, Hq, Hkv, D, window, cap)
    "prefill_target": ("bfloat16", 8, 256, 28, 4, 128, 0, 0.0),
    "prefill_draft": ("bfloat16", 8, 256, 14, 2, 64, 0, 0.0),
    "long_prefill": ("bfloat16", 1, 4096, 28, 4, 128, 0, 0.0),
    "window_cap": ("bfloat16", 2, 512, 28, 4, 128, 256, 30.0),
    "fp32_prefill": ("float32", 2, 256, 28, 4, 128, 0, 0.0),
}


def flash_kernel_phase(seed: int):
    """The flash prefill kernel through the (B, T, H, D) wrapper the model
    calls, against its plain version, at the serve prefill shapes."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention, ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    res = {"cases": {}, "max_abs_err": 0.0, "max_err_over_tol": 0.0}
    for case, (dtype_name, B, T, Hq, Hkv, D, window, cap) in FLASH_CASES.items():
        dt = getattr(torch, dtype_name)
        q = torch.randn((B, T, Hq, D), generator=gen, device=dev).to(dt)
        k, v = (torch.randn((B, T, Hkv, D), generator=gen, device=dev).to(dt)
                for _ in range(2))
        kw = dict(causal=True, window=window, logit_cap=cap)
        out = ops.flash_attention(q, k, v, **kw)
        ref = flash_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        route = flash_attention.LAST_ROUTE["flash_attention"]
        if dtype_name == "bfloat16" and route != "sm90":
            raise AssertionError(f"flash_attention [{case}]: bf16 ran the "
                                 f"{route} kernel, not the TMA + wgmma one")
        err = _hold("flash_attention", case, out, ref, FLASH_TOL[dtype_name],
                    res)
        row_err = row_scaled_err(out, ref)
        if dtype_name == "bfloat16" and row_err > FLASH_ROW_TOL:
            raise AssertionError(
                f"flash_attention [{case}]: an element is {row_err:.3g} x the "
                f"rms of its row from the plain version (bound "
                f"{FLASH_ROW_TOL})")
        # work: each query t sees min(t + 1, window) keys; QK^T and PV are
        # 2 * D FLOPs per (query, key) each; q, k, v read once, out written
        pairs = sum(min(t + 1, window) if window else t + 1 for t in range(T))
        flops = 4 * B * Hq * D * pairs
        n_bytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
        b_ms, b_by = bound_ms(n_bytes, flops, BF16_FLOPS
                              if dtype_name == "bfloat16" else FP32_FLOPS)
        ms = cuda_time_ms(lambda: ops.flash_attention(q, k, v, **kw),
                          warmup=3, iters=20)
        plain_ms = cuda_time_ms(lambda: flash_attention_plain(q, k, v, **kw),
                                warmup=1, iters=3)
        if cap == 0.0 and window == 0:
            qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            lib_fn, lib = _library(
                lambda: F.scaled_dot_product_attention(
                    qh, kh, vh, is_causal=True, enable_gqa=True),
                "F.scaled_dot_product_attention(is_causal, enable_gqa), "
                "(B, H, T, D) copies excluded")
        else:
            lib_fn, lib = None, "sdpa has no window-and-cap mask of its own"
        lib_ms = cuda_time_ms(lib_fn, warmup=3, iters=20) if lib_fn else None
        graph_ms = graph_time_ms(lambda: ops.flash_attention(q, k, v, **kw))
        lib_graph_ms = graph_time_ms(lib_fn) if lib_fn else None
        res["cases"][case] = dict(
            dtype=dtype_name, route=route, B=B, T=T, heads=(Hq, Hkv),
            head_dim=D, window=window, cap=cap, kernel_ms=ms,
            kernel_graph_ms=graph_ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, bytes=n_bytes,
            flops=flops, library_ms=lib_ms, library_graph_ms=lib_graph_ms,
            library=lib, max_abs_err=err, tol=FLASH_TOL[dtype_name],
            max_row_scaled_err=row_err)
        log(f"kernel flash_attention [{case:14s}] {dtype_name} route={route} "
            f"B={B} T={T} heads={Hq}/{Hkv}x{D} w={window} cap={cap:g}  "
            f"{ms:.4f} ms "
            f"(graph {_fmt(graph_ms)})  plain {plain_ms:.3f} ms  bound "
            f"{b_ms:.4f} ms ({b_by})  library {_fmt(lib_ms)} (graph "
            f"{_fmt(lib_graph_ms)}; {lib})  max err {err:.3g}, "
            f"{row_err:.3g} x row rms")
        del q, k, v, out, ref
    torch.cuda.empty_cache()
    return res


DECODE_CASES = {  # name: (dtype, B, T, Hq, Hkv, D, S, (min, max) length)
    "sd_verify": ("bfloat16", 8, 5, 28, 4, 128, 512, (129, 290)),
    "ar": ("bfloat16", 8, 1, 28, 4, 128, 512, (129, 290)),
    "draft_ar": ("bfloat16", 8, 1, 14, 2, 64, 512, (129, 290)),
    "draft_sd_verify": ("bfloat16", 8, 5, 14, 2, 64, 512, (129, 290)),
    "long_context": ("bfloat16", 8, 5, 28, 4, 128, 8192, (8000, 8187)),
    "fp32_sd_verify": ("float32", 8, 5, 28, 4, 128, 512, (129, 290)),
    # at ~8k keys a typical |out| is ~0.02, near the bf16 bound
    "fp32_long_context": ("float32", 8, 5, 28, 4, 128, 8192, (8000, 8187)),
}


def decode_inputs(spec, gen, dev):
    """(q, k, v, lengths) of a DECODE_CASES entry: k and v are the model's
    (B, S+1, Hkv, D) cache sliced to S, noise everywhere and huge values in
    slot S (the trash slot), ragged lengths."""
    import torch
    dtype_name, B, T, Hq, Hkv, D, S, (lo, hi) = spec
    dt = getattr(torch, dtype_name)
    kc, vc = (torch.randn((B, S + 1, Hkv, D), generator=gen, device=dev
                          ).to(dt) for _ in range(2))
    kc[:, S], vc[:, S] = 1e3, -1e3
    lengths = torch.randint(lo, hi + 1, (B,), generator=gen,
                            device=dev).to(torch.int32)
    q = torch.randn((B, T, Hq, D), generator=gen, device=dev).to(dt)
    return q, kc[:, :S], vc[:, :S], lengths


def sdpa_dense(q, k, v, lengths):
    """``F.scaled_dot_product_attention`` with the causal mask of the
    lengths over (B, H, S, D) copies of the cache made beforehand: a
    yardstick the port never calls.  Returns (fn or None, label)."""
    import torch
    import torch.nn.functional as F
    B, T, _, _ = q.shape
    S = k.shape[1]
    qh = q.transpose(1, 2).contiguous()
    kh, vh = (t.transpose(1, 2).contiguous() for t in (k, v))
    q_pos = lengths.to(torch.int64)[:, None] + torch.arange(T, device=q.device)
    mask = (torch.arange(S, device=q.device)[None, None, :]
            <= q_pos[:, :, None])[:, None]                  # (B, 1, T, S)
    return _library(
        lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                               enable_gqa=True),
        "F.scaled_dot_product_attention(mask, enable_gqa) over the "
        "contiguous (B, H, S, D) cache, copies excluded")


def decode_kernel_phase(seed: int):
    """The dense decode/verify kernel on the model's (B, S+1, Hkv, D) cache
    layout sliced to S (slot S, the trash slot, holds huge values), against
    its plain version."""
    import torch
    from repro_torch.kernels.decode_attention import ops
    from repro_torch.kernels.decode_attention.ref import decode_attention_plain

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 4)
    res = {"cases": {}, "max_abs_err": 0.0, "max_err_over_tol": 0.0}
    for case, spec in DECODE_CASES.items():
        dtype_name, B, T, Hq, Hkv, D, S, _ = spec
        q, k, v, lengths = decode_inputs(spec, gen, dev)
        out = ops.decode_attention(q, k, v, lengths)
        route = ops.LAST_ROUTE["decode_attention"]
        ref = decode_attention_plain(q, k, v, lengths)
        torch.cuda.synchronize()
        want = "sm90" if dtype_name == "bfloat16" and D in (64, 128) else "simt"
        if route != want:
            raise AssertionError(f"decode_attention [{case}]: ran the {route} "
                                 f"body, expected {want}")
        err = _hold("decode_attention", case, out, ref,
                    DECODE_TOL[dtype_name], res)
        row_err = row_scaled_err(out, ref)
        if route == "sm90" and row_err > DECODE_ROW_TOL:
            raise AssertionError(
                f"decode_attention [{case}]: an element is {row_err:.3g} x "
                f"the rms of its row from the plain version (bound "
                f"{DECODE_ROW_TOL})")
        # bytes: K and V at the keys 0..min(S, length+T)-1 of each row, q,
        # out and the lengths; FLOPs: 4 * D per (query row, visible key)
        lens = [int(n) for n in lengths.tolist()]
        keys = sum(min(S, n + T) for n in lens)
        pairs = sum(min(S, n + t + 1) for n in lens for t in range(T))
        elem = q.element_size()
        n_bytes = (keys * Hkv * D * 2 * elem + 2 * q.numel() * elem
                   + 4 * B)
        flops = 4 * (Hq // Hkv) * Hkv * D * pairs
        b_ms, b_by = bound_ms(n_bytes, flops, BF16_FLOPS
                              if dtype_name == "bfloat16" else FP32_FLOPS)
        ms = cuda_time_ms(lambda: ops.decode_attention(q, k, v, lengths),
                          warmup=3, iters=20)
        plain_ms = cuda_time_ms(
            lambda: decode_attention_plain(q, k, v, lengths), warmup=1, iters=3)
        lib_fn, lib = sdpa_dense(q, k, v, lengths)
        lib_ms = cuda_time_ms(lib_fn, warmup=3, iters=20) if lib_fn else None
        graph_ms = graph_time_ms(lambda: ops.decode_attention(q, k, v,
                                                              lengths))
        lib_graph_ms = graph_time_ms(lib_fn) if lib_fn else None
        res["cases"][case] = dict(
            dtype=dtype_name, route=route, B=B, T=T, heads=(Hq, Hkv),
            head_dim=D, S=S, lengths=lens, keys=keys, kernel_ms=ms,
            kernel_graph_ms=graph_ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, bytes=n_bytes, flops=flops, library_ms=lib_ms,
            library_graph_ms=lib_graph_ms, library=lib, max_abs_err=err,
            tol=DECODE_TOL[dtype_name], max_row_scaled_err=row_err)
        log(f"kernel decode_attention [{case:17s}] {dtype_name} route={route} "
            f"B={B} T={T} heads={Hq}/{Hkv}x{D} S={S} keys={keys}  {ms:.4f} ms "
            f"(graph {_fmt(graph_ms)})  plain {plain_ms:.3f} ms  bound "
            f"{b_ms:.4f} ms ({b_by})  library {_fmt(lib_ms)} (graph "
            f"{_fmt(lib_graph_ms)})  max err {err:.3g}, {row_err:.3g} x row "
            f"rms")
        del q, k, v, out, ref, lib_fn
    torch.cuda.empty_cache()
    return res


def capacity_cases() -> dict:
    """name: (dtype, E, C, in width, out width): qwen2-57b-a14b's experts,
    gate/up (D -> F) and down (F -> D), at the SD-verify and a prefill
    capacity."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.gmm.ops import expert_capacity
    cfg = get_config("qwen2-57b-a14b")
    E, K, D, F = (cfg.num_experts, cfg.num_experts_per_tok, cfg.d_model,
                  cfg.moe_d_ff)
    c_verify = expert_capacity(40, K, E)          # B 8 x (gamma + 1) 5 tokens
    c_prefill = expert_capacity(2048, K, E)       # B 8 x 256 tokens
    return {
        "sd_verify_gate_up": ("bfloat16", E, c_verify, D, F),
        "sd_verify_down": ("bfloat16", E, c_verify, F, D),
        "prefill_gate_up": ("bfloat16", E, c_prefill, D, F),
        "prefill_down": ("bfloat16", E, c_prefill, F, D),
        "fp32_sd_verify_gate_up": ("float32", E, c_verify, D, F),
    }


def capacity_kernel_phase(seed: int):
    """The capacity-binned expert GEMM at capacity_cases()."""
    import torch
    from repro_torch.kernels.gmm import gmm
    from repro_torch.kernels.gmm.ref import gmm_capacity_ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 5)
    res = {"cases": {}, "max_abs_err": 0.0, "max_err_over_tol": 0.0}
    for case, (dtype_name, E, C, Din, Dout) in capacity_cases().items():
        dt = getattr(torch, dtype_name)
        x = torch.randn((E, C, Din), generator=gen, device=dev).to(dt)
        w = (torch.randn((E, Din, Dout), generator=gen, device=dev)
             / Din ** 0.5).to(dt)
        out = gmm.gmm_capacity(x, w)
        route = gmm._route(x, w)                  # the wrapper's dispatch
        if dtype_name == "bfloat16" and route != "sm90":
            raise AssertionError(f"gmm_capacity [{case}]: bf16 ran the "
                                 f"{route} kernel, not the TMA + wgmma one")
        ref = gmm_capacity_ref(x, w)
        torch.cuda.synchronize()
        err = _hold("gmm_capacity", case, out, ref, GMM_TOL[dtype_name], res)
        elem = x.element_size()
        n_bytes = (x.numel() + w.numel() + E * C * Dout) * elem
        flops = 2 * E * C * Din * Dout
        b_ms, b_by = bound_ms(n_bytes, flops, BF16_FLOPS
                              if dtype_name == "bfloat16" else FP32_FLOPS)
        ms = cuda_time_ms(lambda: gmm.gmm_capacity(x, w), warmup=2, iters=10)
        plain_ms = cuda_time_ms(lambda: gmm_capacity_ref(x, w), warmup=1,
                                iters=3)
        lib_fn, lib = _library(lambda: torch.bmm(x, w), "torch.bmm")
        lib_ms = cuda_time_ms(lib_fn, warmup=2, iters=10) if lib_fn else None
        graph_ms = graph_time_ms(lambda: gmm.gmm_capacity(x, w), calls=10,
                                 iters=3)
        lib_graph_ms = (graph_time_ms(lib_fn, calls=10, iters=3) if lib_fn
                        else None)
        res["cases"][case] = dict(
            dtype=dtype_name, route=route, E=E, C=C, K=Din, F=Dout,
            kernel_ms=ms, kernel_graph_ms=graph_ms, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, bytes=n_bytes, flops=flops,
            library_ms=lib_ms, library_graph_ms=lib_graph_ms, library=lib,
            max_abs_err=err, tol=GMM_TOL[dtype_name])
        log(f"kernel gmm_capacity [{case:22s}] {dtype_name} route={route} "
            f"E={E} C={C} {Din}->{Dout}  {ms:.3f} ms (graph {_fmt(graph_ms)})"
            f"  plain {plain_ms:.3f} ms  bound {b_ms:.3f} ms ({b_by})  library "
            f"{_fmt(lib_ms)} (graph {_fmt(lib_graph_ms)}; {lib})  "
            f"max err {err:.3g}")
        del x, w, out, ref
    torch.cuda.empty_cache()
    return res


def capacity_ops_path(seed: int):
    """The capacity-binned MoE FFN of kernels/gmm/ops.py at full width in
    fp32 with top-8 routing of 40 tokens (an SD verify at B 8, gamma 4):
    one moe_ffn_gmm and one gmm_legacy call, counted, then held against the
    ragged dispatch, moe_ffn_ref and ragged_gmm."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.gmm import ops, ragged
    from repro_torch.kernels.gmm.ref import moe_ffn_ref
    from repro_torch.models import moe

    dev = torch.device("cuda")
    cfg = get_config("qwen2-57b-a14b")
    E, K, D, F = (cfg.num_experts, cfg.num_experts_per_tok, cfg.d_model,
                  cfg.moe_d_ff)
    gen = torch.Generator(device=dev).manual_seed(seed + 6)
    x = torch.randn((40, D), generator=gen, device=dev)
    wg, wu = ((torch.randn((E, D, F), generator=gen, device=dev) / D ** 0.5)
              for _ in range(2))
    wd = torch.randn((E, F, D), generator=gen, device=dev) / F ** 0.5
    probs = torch.softmax(torch.randn((40, E), generator=gen, device=dev), -1)
    weights, idx = probs.topk(K, -1)
    weights = weights / weights.sum(-1, keepdim=True)
    flat = idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    xs = x[order // K]                                   # expert-sorted rows
    sizes = torch.bincount(flat, minlength=E).to(torch.int32)
    cap = ops.expert_capacity(40, K, E)
    torch.cuda.synchronize()

    reset_launch_counts()
    y, dropped = ops.moe_ffn_gmm(x, wg, wu, wd, weights, idx, capacity=cap,
                                 return_dropped=True)
    legacy = ops.gmm_legacy(xs, wg, sizes)
    torch.cuda.synchronize()
    counts = launch_counts()
    expect = {n: 0 for n in counts}
    expect["gmm_capacity"] = 3 + 1
    log(f"ops[{OPS_PATH}]: capacity {cap}, dropped {int(dropped)}; launches "
        f"counted {counts}, expected {expect}")
    if counts != expect or int(dropped) != 0:
        raise AssertionError(f"ops[{OPS_PATH}]: launches {counts} != {expect} "
                             f"or dropped {int(dropped)} != 0")
    ragged_y = moe._dispatch_gmm({"w_gate": wg, "w_up": wu, "w_down": wd},
                                 cfg, x, weights, idx)
    checks = {"moe_ffn_gmm vs ragged dispatch": (y, ragged_y, 1e-4),
              "moe_ffn_gmm vs moe_ffn_ref": (
                  y, moe_ffn_ref(x, wg, wu, wd, weights, idx), 1e-4),
              "gmm_legacy vs ragged_gmm": (
                  legacy, ragged.ragged_gmm(xs, wg, sizes), 2e-4)}
    for what, (a, b, tol) in checks.items():
        err = (a - b).abs().max().item()
        if not torch.allclose(a, b, rtol=tol, atol=tol):
            raise AssertionError(f"ops: {what}: max err {err:.3g} > {tol}")
        log(f"ops: {what}: max err {err:.3g} (rtol=atol={tol})")
    del wg, wu, wd
    torch.cuda.empty_cache()
    return counts


# ----------------------------------------------------------------- reference
def reference_phase(seed: int):
    """Reduced target in fp32: the CUDA path vs the port's plain CPU path,
    and greedy SD == greedy AR on the card."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.core.proposer import make_proposer
    from repro_torch.core.spec_decode import SDEngine, generate_ar
    from repro_torch.models.model import Model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("qwen2-57b-a14b", reduced=True)
    dcfg = get_config("qwen2-0.5b", reduced=True)
    cpu, gpu = (Model(cfg, moe_dispatch="gmm", device=d) for d in ("cpu", "cuda"))
    p_cpu = cpu.init(torch.Generator().manual_seed(seed))
    p_gpu = _to_device(p_cpu, gpu.device)
    rng = np.random.default_rng(seed)
    toks = rng.integers(3, cfg.vocab_size, (4, 16)).astype(np.int32)
    lengths = np.array([16, 9, 12, 5], np.int32)
    ver = rng.integers(3, cfg.vocab_size, (4, 5)).astype(np.int32)
    outs = []
    for m, p in ((cpu, p_cpu), (gpu, p_gpu)):
        last, cache = m.prefill(p, toks, m.init_cache(4, 32), lengths=lengths)
        logits, _ = m.extend(p, ver, cache)
        outs.append((last.cpu(), logits.cpu()))
    err = max((a - b).abs().max().item() for a, b in zip(*outs))
    if not err <= 1e-3:
        raise AssertionError(f"reference: CUDA path vs CPU path max err {err:.3g}")
    drafts = {"cpu": Model(dcfg, device="cpu"), "cuda": Model(dcfg, device="cuda")}
    pd_cpu = drafts["cpu"].init(torch.Generator().manual_seed(seed + 1))
    pd_gpu = _to_device(pd_cpu, drafts["cuda"].device)
    draft = drafts["cuda"]
    eng = SDEngine(gpu, make_proposer("model", gpu, draft), gamma=4)
    sd, _ = eng.generate(p_gpu, pd_gpu, toks, 24, lengths=lengths)
    ar = generate_ar(gpu, p_gpu, toks, 24, lengths=lengths)
    if not np.array_equal(sd, ar):
        raise AssertionError("reference: greedy SD != greedy AR on the card")
    # graph replay vs the eager card round vs the CPU round, token for token
    again, _ = eng.generate(p_gpu, pd_gpu, toks, 24, lengths=lengths)
    eager, _ = SDEngine(gpu, make_proposer("model", gpu, draft), gamma=4,
                        cuda_graphs=False).generate(p_gpu, pd_gpu, toks, 24,
                                                    lengths=lengths)
    on_cpu, _ = SDEngine(cpu, make_proposer("model", cpu, drafts["cpu"]),
                         gamma=4).generate(p_cpu, pd_cpu, toks, 24,
                                           lengths=lengths)
    if eng.graphs.total_captures != 1 or not eng.graphs.total_replays:
        raise AssertionError(f"reference: SD session captured "
                             f"{eng.graphs.captures}, replayed "
                             f"{eng.graphs.replays}")
    for name, out in (("replayed again", again), ("eager", eager),
                      ("CPU", on_cpu)):
        if not np.array_equal(out, sd):
            raise AssertionError(f"reference: greedy SD from graph replay "
                                 f"!= {name}")
    log(f"reference: reduced fp32 logits CUDA vs CPU max err {err:.2e} (<= 1e-3); "
        "greedy SD == greedy AR (4 rows x 24 tokens); graph replay == eager "
        f"card == CPU ({eng.graphs.total_captures} capture, "
        f"{eng.graphs.total_replays} replays)")

    # continuous paged stream: card vs CPU, SD vs AR
    streams = {}
    for dev, tm, pt, pd in (("cpu", cpu, p_cpu, pd_cpu),
                            ("cuda", gpu, p_gpu, pd_gpu),
                            ("cuda-eager", gpu, p_gpu, pd_gpu)):
        for kind in ("model", "none"):
            if dev != "cpu":
                reset_launch_counts()
            streams[dev, kind] = continuous_stream(
                cfg, tm, pt, drafts[dev.split("-")[0]], pd, kind, seed,
                cuda_graphs=False if dev == "cuda-eager" else None)
            if dev != "cpu" and not launch_counts()["paged_decode_attention"]:
                raise AssertionError("reference: the continuous paged stream "
                                     "never launched the paged kernel")
            if dev == "cuda" and not streams[dev, kind]["replays"]:
                raise AssertionError("reference: the continuous paged stream "
                                     "replayed no round")
    base = streams["cpu", "model"]
    for key, got in streams.items():
        if got["growths"] == [] or got["outputs"].keys() != base["outputs"].keys():
            raise AssertionError(f"reference: stream {key} did not grow or "
                                 "lost requests")
        for uid, (reason, out) in base["outputs"].items():
            r2, o2 = got["outputs"][uid]
            if r2 != reason or not np.array_equal(o2, out):
                raise AssertionError(
                    f"reference: continuous paged stream {key} request {uid} "
                    f"({r2}, {o2.tolist()}) != cpu/model ({reason}, "
                    f"{out.tolist()})")
    log(f"reference: continuous paged stream ({len(base['outputs'])} requests, "
        f"growths {base['growths']}, {base['rounds']} SD rounds): card "
        f"(graph replay: {streams['cuda', 'model']['captures']} captures, "
        f"{streams['cuda', 'model']['replays']} replays) == eager card == "
        "CPU and SD == AR, token for token")


def flash_reference_phase(seed: int):
    """use_flash=True on the reduced target and draft in fp32, prompts of
    129-256 tokens (prompt bucket 256, max_seq 512): the CUDA path (flash and
    dense decode kernels) agrees with the CPU path (their plain versions),
    and on the card greedy SD equals greedy AR and the greedy outputs equal
    those with use_flash=False."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import prompt_batch
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import ServingEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(seed)
    params, errs = {}, {}
    reset_launch_counts()
    for name, c, disp, s in (
            ("target", get_config("qwen2-57b-a14b", reduced=True), "gmm", seed),
            ("draft", get_config("qwen2-0.5b", reduced=True), "onehot",
             seed + 1)):
        cpu = Model(c, moe_dispatch=disp, use_flash=True, device="cpu")
        gpu = Model(c, moe_dispatch=disp, use_flash=True, device="cuda")
        p_cpu = cpu.init(torch.Generator().manual_seed(s))
        p_gpu = _to_device(p_cpu, gpu.device)
        toks = rng.integers(3, c.vocab_size, (4, 256)).astype(np.int32)
        lengths = np.array([256, 129, 200, 171], np.int32)
        ver = rng.integers(3, c.vocab_size, (4, 5)).astype(np.int32)
        outs = []
        for m, p in ((cpu, p_cpu), (gpu, p_gpu)):
            last, cache = m.prefill(p, toks, m.init_cache(4, 512),
                                    lengths=lengths)
            logits, _ = m.extend(p, ver, cache)
            outs.append((last.cpu(), logits.cpu()))
        errs[name] = max((a - b).abs().max().item() for a, b in zip(*outs))
        if not errs[name] <= 1e-3:
            raise AssertionError(f"reference use_flash {name}: CUDA path vs "
                                 f"CPU path max err {errs[name]:.3g}")
        params[name] = (c, disp, p_gpu)
    counts = launch_counts()
    if not (counts["flash_attention"] and counts["decode_attention"]):
        raise AssertionError(f"reference use_flash: the kernels were not "
                             f"launched ({counts})")
    (tc, tdisp, pt), (dc, _, pd) = params["target"], params["draft"]
    pb = prompt_batch(tc.vocab_size, 6, seed=seed, min_len=129, max_len=256)
    outputs = {}
    for flash in (True, False):
        tm = Model(tc, moe_dispatch=tdisp, use_flash=flash, device="cuda")
        dm = Model(dc, use_flash=flash, device="cuda")
        for kind in ("model", "none"):
            eng = ServingEngine(tm, dm if kind == "model" else None, pt,
                                pd if kind == "model" else None, max_batch=4,
                                gamma=4, temperature=0.0, proposer=kind,
                                seed=seed)
            for i in range(6):
                eng.submit(pb["tokens"][i][: int(pb["lengths"][i])],
                           max_new_tokens=24)
            eng.run()
            outputs[flash, kind] = np.stack([eng.done[u].output
                                             for u in sorted(eng.done)])
    base = outputs[True, "model"]
    for key, out in outputs.items():
        if not np.array_equal(out, base):
            raise AssertionError(f"reference use_flash: greedy outputs "
                                 f"{key} != (use_flash, SD)")
    log(f"reference use_flash: reduced fp32 logits CUDA vs CPU max err "
        f"target {errs['target']:.2e}, draft {errs['draft']:.2e} (<= 1e-3), "
        f"launches {counts}; greedy SD == AR == use_flash=False "
        f"({base.shape[0]} prompts of 129-256 tokens x 24 tokens)")


def continuous_stream(cfg, target, params_t, draft, params_d, kind: str,
                      seed: int, cuda_graphs=None, tuner=None) -> dict:
    """The reduced continuous paged stream: 5 Poisson arrivals with mixed
    budgets and one late long prompt that forces a session growth."""
    import numpy as np
    from repro_torch.data.pipeline import prompt_batch
    from repro_torch.launch.serve import plan_trajectory
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.scheduler import submit_poisson
    eng = ServingEngine(target, draft if kind == "model" else None, params_t,
                        params_d if kind == "model" else None,
                        scheduler="continuous", kv_layout="paged",
                        page_size=16, max_batch=4, gamma=4, proposer=kind,
                        seed=seed, cuda_graphs=cuda_graphs, tuner=tuner)
    pb = prompt_batch(cfg.vocab_size, 5, seed=seed, min_len=5, max_len=24)
    submit_poisson(eng, pb["tokens"], pb["lengths"], rate=0.5,
                   max_new_choices=(4, 8, 12), seed=seed)
    long = np.random.default_rng(seed).integers(3, cfg.vocab_size, 150)
    eng.submit(long, max_new_tokens=8, arrival_round=3)
    (rep,) = eng.run()
    stats = eng.session_stats()[kind]
    return {"outputs": {u: (r.finish_reason, r.output)
                        for u, r in eng.done.items()},
            "growths": stats["growths"], "rounds": rep.stats.rounds,
            "captures": stats["captures"], "replays": stats["replays"],
            "steps": [(st.live, st.gamma) for st in rep.steps],
            "plans": plan_trajectory(rep.steps), "keys": stats["keys"]}


def _to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, dev) for v in tree]
    return tree.to(dev)


# --------------------------------------------------------------------- serve
def captured_verify_check(target, draft, params_t, params_d, pb, *,
                          gamma: int = 4, paged: bool = False,
                          label: str = "serve") -> None:
    """bf16, full width: one captured round's verify logits (its propose
    and verify, as the round's stages run them, through RoundGraphs: the
    key's first run is eager, the second replays its graph) against the
    eager round's on the same session state, within rtol = atol = 3e-2;
    prints the largest error, the argmax agreement and, for the spread, the
    largest error of a second eager round against the first.  ``paged``:
    the target cache in pages of 64, so a verify wider than
    PAGED_KERNEL_MAX_T attends over the gathered view.  The card sums each
    token's expert rows in a fixed order (models/moe.py), so the two may
    agree to the bit, which is not required."""
    import numpy as np
    import torch
    from repro_torch.core.graphs import RoundGraphs
    from repro_torch.core.proposer import make_proposer
    from repro_torch.core.spec_decode import SDEngine

    B, max_seq = 8, 128
    opts, table = None, None
    if paged:
        per_row = max_seq // 64
        opts = {"paged": True, "page_size": 64, "pool_pages": B * per_row + 1}
        table = 1 + torch.arange(B * per_row, dtype=torch.int32,
                                 device="cuda").view(B, per_row)  # 0: trash
    eng = SDEngine(target, make_proposer("model", target, draft), gamma=gamma)
    state = eng.start(params_t, params_d, pb["tokens"][:B, :64],
                      max_seq=max_seq, lengths=np.minimum(pb["lengths"][:B], 64),
                      cache_opts=opts, page_table=table)
    leaves = list(_leaves([state.t_cache, state.p_state, state.last_token]))
    snap = [t.clone() for t in leaves]
    out = torch.empty((B, gamma + 1, target.cfg.vocab_size),
                      dtype=target.dtype, device="cuda")

    def propose_verify(_):
        drafts, _, _ = eng.proposer.propose(state.params, state.p_state,
                                            state.last_token, gamma, None)
        logits, _ = target.extend(
            params_t, torch.cat([state.last_token[:, None], drafts], 1),
            state.t_cache)
        out.copy_(logits)

    graphs = RoundGraphs(target.device, capture=True, models=(target, draft))
    logits = []
    # eager (+ capture), replay, and eager again for the run-to-run spread
    for run in (lambda: graphs.run(("verify",), [propose_verify]),) * 2 + (
            lambda: propose_verify(None),):
        for t, s in zip(leaves, snap):
            t.copy_(s)
        run()
        logits.append(out.float().clone())
    eager, replay, again = logits
    err = (replay - eager).abs()
    if not (torch.isfinite(replay).all()
            and (err <= TOL + TOL * eager.abs()).all()):
        raise AssertionError(f"{label}: captured verify logits vs eager max "
                             f"err {err.max().item():.4g} (rtol=atol={TOL})")
    agree = (replay.argmax(-1) == eager.argmax(-1)).float().mean().item()
    log(f"{label}: captured round's verify logits (bf16, B {B}, gamma "
        f"{gamma}, {'paged' if paged else 'dense'} cache) vs the eager "
        f"round's on the same state: max abs err {err.max().item():.4g} "
        f"(rtol=atol={TOL}), argmax agreement {agree:.3f}; a second eager "
        f"round vs the first: max abs err "
        f"{(again - eager).abs().max().item():.4g}; "
        f"{graphs.total_captures} capture, {graphs.total_replays} replay")


def serve_phase(seed: int):
    import gc

    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.core.analytics import occupancy_timeline
    from repro_torch.data.pipeline import prompt_batch
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.scheduler import submit_poisson

    cfg = get_config("qwen2-57b-a14b").with_overrides(num_layers=LAYERS)
    dcfg = get_config("qwen2-0.5b")
    t0 = time.perf_counter()
    target = Model(cfg, moe_dispatch="gmm", device="cuda")
    gen = torch.Generator(device=target.device)
    params_t = target.init(gen.manual_seed(seed))
    draft = Model(dcfg, device="cuda")
    params_d = draft.init(gen.manual_seed(seed + 1))
    # the same weights behind Model(..., use_flash=True): use_flash changes
    # no parameter
    target_f = Model(cfg, moe_dispatch="gmm", use_flash=True, device="cuda")
    draft_f = Model(dcfg, use_flash=True, device="cuda")
    torch.cuda.synchronize()
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params_t))
    log(f"serve: target {cfg.name} x{LAYERS} of 28 layers ({n_bytes / 1e9:.2f} GB of "
        f"{cfg.dtype} weights), draft {dcfg.name} x{dcfg.num_layers}, init "
        f"{time.perf_counter() - t0:.1f} s")

    # the verify pass must not wait on the host for the routing, the
    # lengths or the block table, dense or paged
    tok = torch.randint(3, cfg.vocab_size, (8, 64), device="cuda")
    for paged in (False, True):
        cache = target.init_cache(8, 128, paged=paged)
        if paged:
            cache["pages"]["table"] = torch.arange(
                1, 17, dtype=torch.int32, device="cuda").reshape(8, 2)
        _, cache = target.prefill(params_t, tok, cache)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            target.extend(params_t, tok[:, :5], cache)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        del cache
    log("serve: a full-width verify pass ran with no host sync, dense and "
        "paged")

    pb = prompt_batch(cfg.vocab_size, 16, kind="chat", seed=seed)
    captured_verify_check(target, draft, params_t, params_d, pb)
    # long system / RAG prompts: bucket 256, max_seq pow2(256 + 32 + 4 + 2)
    pb_long = prompt_batch(cfg.vocab_size, 16, seed=seed + 7, min_len=129,
                           max_len=256)
    long_prompt = np.random.default_rng(seed).integers(3, cfg.vocab_size, 700)
    moe_layers = sum(cfg.moe_pattern[l % cfg.period] for l in range(LAYERS))
    attn_layers = LAYERS                        # every layer is "attn"
    draft_attn_layers = dcfg.num_layers

    def engine(kind: str, timed: bool, flash: bool = False, **kw):
        tm, dm = (target_f, draft_f) if flash else (target, draft)
        return ServingEngine(tm, dm if kind == "model" else None,
                             params_t, params_d if kind == "model" else None,
                             max_batch=8, gamma=4, temperature=0.0,
                             proposer=kind, seed=seed, timed=timed, **kw)

    def graph_note(eng, kind: str) -> str:
        g = eng._sessions[kind].graphs
        if not g.capture:
            return "eager"
        return (f"graphs: {g.total_captures} captures in "
                f"{sum(g.capture_seconds.values()):.3f} s, "
                f"{g.total_replays} replays, pool "
                f"{g.pool_bytes() / 2**20:.1f} MiB")

    def wave(eng, kind: str, n_requests: int, label: str):
        """One batch of requests through ``eng``; (outputs, rounds, tok/s
        of each wave, the propose share of the timed rounds or None)."""
        flash = eng.target.use_flash
        prompts = pb_long if flash else pb
        for i in range(n_requests):
            eng.submit(prompts["tokens"][i][: int(prompts["lengths"][i])],
                       max_new_tokens=32)
        first = max(eng.done, default=0)
        rounds, rates, t_prop, t_all = 0, [], 0.0, 0.0
        for r in eng.run():
            rounds += r.stats.rounds
            rates.append(r.tokens_per_second)
            t_prop += r.propose_time
            t_all += r.propose_time + r.verify_time + r.reject_time
            sd = (f"sigma={r.stats.sigma:.3f} alpha={r.stats.alpha:.3f}"
                  if r.used_sd else "AR")
            phases = (f" propose={r.propose_time:.3f} s verify="
                      f"{r.verify_time:.3f} s reject={r.reject_time:.3f} s"
                      if eng.timed else "")
            log(f"serve wave{'-flash' if flash else ''} ({label}"
                f"{', timed round' if eng.timed else ''}): "
                f"proposer={r.proposer} B={r.batch}/{r.bucket} "
                f"gamma={r.gamma} dispatch={r.moe_dispatch} "
                f"{r.tokens_per_second:.2f} tok/s  {sd} rounds={r.stats.rounds} "
                f"wall={r.wall_time:.3f} s{phases} captures={r.captures} "
                f"replays={r.replays}")
        out = np.stack([eng.done[u].output for u in sorted(eng.done)
                        if u > first])
        if out.shape != (n_requests, 32) or out.min() < 0 \
                or out.max() >= cfg.vocab_size:
            raise AssertionError(f"serve wave[{kind}]: bad outputs {out.shape}")
        share = t_prop / t_all if eng.timed and t_all else None
        return out, rounds, rates, share

    def continuous(eng, kind: str, label: str):
        first = max(eng.done, default=0)
        submit_poisson(eng, pb["tokens"], pb["lengths"], rate=0.5,
                       max_new_choices=(8, 16, 32), seed=seed)
        eng.submit(long_prompt, max_new_tokens=16, arrival_round=6)
        (r,) = eng.run()
        sd = (f"sigma={r.stats.sigma:.3f} alpha={r.stats.alpha:.3f}"
              if r.used_sd else "AR")
        occ = occupancy_timeline([s.live for s in r.steps],
                                 [s.committed for s in r.steps])
        stats = eng.session_stats()[kind]
        log(f"serve continuous paged ({label}): proposer={r.proposer} "
            f"requests={r.batch} pool={r.bucket} gamma={r.gamma} "
            f"{r.tokens_per_second:.2f} tok/s  {sd} rounds={r.stats.rounds} "
            f"tokens={r.tokens_out} wall={r.wall_time:.3f} s "
            f"captures={r.captures} replays={r.replays}")
        log(f"  N(t): peak={occ['peak_live']:.0f} mean={occ['mean_live']:.2f} "
            f"token_weighted={occ['token_weighted_live']:.2f} "
            f"occupancy={occ['mean_occupancy']:.2f}  "
            f"admitted={sum(s.admitted for s in r.steps)} "
            f"retired={sum(s.retired for s in r.steps)}")
        log(f"  admission: {sum(s.admit_rows for s in r.steps)} prefill rows, "
            f"{sum(s.admit_tokens for s in r.steps)} row-tokens (sliced); "
            f"admit traces {stats['admit_traces']}; growths {stats['growths']}")
        done = {u - first: eng.done[u] for u in eng.done if u > first}
        reasons = {d.finish_reason for d in done.values()}
        if len(done) != 17 or reasons != {"length"}:
            raise AssertionError(f"serve continuous[{kind}]: {len(done)} "
                                 f"requests finished {reasons}")
        if not stats["growths"]:
            raise AssertionError(f"serve continuous[{kind}]: the 700-token "
                                 "prompt did not grow the page pool")
        eng._slot_scheduler._alloc.assert_no_leaks()
        return ({u: d.output for u, d in done.items()}, r.stats.rounds,
                [r.tokens_per_second], None)

    def release():
        gc.collect()
        torch.cuda.empty_cache()

    outputs, launches, rates = {}, {}, {}
    torch.cuda.reset_peak_memory_stats()
    for path in PATHS:
        sched, kind = path.split("/")
        flash = sched == "wave-flash"
        tm, dm = (target_f, draft_f) if flash else (target, draft)
        if sched == "continuous":
            eng = engine(kind, False, scheduler="continuous",
                         kv_layout="paged", page_size=64)
            run = lambda label: continuous(eng, kind, label)   # noqa: E731
        else:
            eng = engine(kind, False, flash)
            run = lambda label: wave(eng, kind, 16, label)     # noqa: E731
        # the path itself, run twice on one engine (the second run of the
        # same workload replays every round, under sync debug mode "error"
        # up to each round's readback): every count zeroed just before,
        # read just after
        reset_launch_counts()
        for m in (tm, dm):
            m.forward_count = m.prefill_count = 0
        out, rounds, rates[path, "graphs"], _ = run("graphs, first run")
        caps = eng.session_stats()[kind]["captures"]
        eng._sessions[kind].sync_guard = True
        out2, rounds2, rates[path, "graphs, again"], _ = run("graphs, again")
        eng._sessions[kind].sync_guard = False
        stats = eng.session_stats()[kind]
        launches[path] = launch_counts()
        log(f"serve[{path}]: {graph_note(eng, kind)}")
        if stats["captures"] != caps or caps < 1 or \
                stats["replays"] != rounds2 + rounds - caps:
            raise AssertionError(f"serve[{path}]: the second run captured "
                                 f"{stats['captures'] - caps} new keys, or "
                                 f"replayed too little ({stats})")
        if sched == "continuous":
            same = out.keys() == out2.keys() and all(
                np.array_equal(out[u], out2[u]) for u in out)
        else:
            same = np.array_equal(out, out2)
        log(f"serve[{path}]: second identical run captured nothing; its "
            f"outputs {'equal' if same else 'differ from'} the first run's "
            "(bf16: not required to be equal)")
        rounds += rounds2
        outputs[path] = out
        expect = {name: 0 for name in launches[path]}
        expect["fused_gate_up"] = expect["ragged_gmm"] = \
            moe_layers * tm.forward_count
        if sched == "continuous":
            expect["paged_decode_attention"] = attn_layers * rounds
        if flash:
            layers = ((tm, attn_layers), (dm, draft_attn_layers))
            expect["flash_attention"] = sum(n * m.prefill_count
                                            for m, n in layers)
            expect["decode_attention"] = sum(
                n * (m.forward_count - m.prefill_count) for m, n in layers)
        log(f"serve[{path}]: {tm.forward_count} target forwards "
            f"({tm.prefill_count} prefills), {dm.forward_count} draft "
            f"forwards ({dm.prefill_count} prefills), {rounds} rounds; "
            f"launches counted (credited per replay) {launches[path]}, "
            f"expected {expect}")
        if launches[path] != expect:
            raise AssertionError(f"serve[{path}]: launches {launches[path]} "
                                 f"!= expected {expect}")
        del eng
        release()
        if sched == "continuous":
            continue
        # the phase breakdown (timed round: three stage graphs), and on the
        # wave paths the same waves eagerly, graphs against eager in one run
        modes = ((None, "graphs"), (False, "eager")) if not flash \
            else ((None, "graphs"),)
        for cuda_graphs, label in modes:
            if cuda_graphs is False:
                eng = engine(kind, False, flash, cuda_graphs=False)
                _, _, rates[path, label], _ = wave(eng, kind, 16, label)
                del eng
            eng = engine(kind, True, flash, cuda_graphs=cuda_graphs)
            wave(eng, kind, 8, label)                      # warm (captures)
            _, _, _, share = wave(eng, kind, 8, label)
            rates[path, label + " timed"] = share
            log(f"serve[{path}] ({label}): propose share of the timed round "
                f"{share:.3f}")
            del eng
            release()
    for path in ("wave/model", "wave/none"):
        g, e = rates[path, "graphs, again"], rates[path, "eager"]
        log(f"serve[{path}]: graphs vs eager in this run: "
            f"{', '.join(f'{x:.2f}' for x in g)} vs "
            f"{', '.join(f'{x:.2f}' for x in e)} tok/s per wave; propose "
            f"share of the timed round {rates[path, 'graphs timed']:.3f} vs "
            f"{rates[path, 'eager timed']:.3f}")
    for sched in ("wave", "continuous", "wave-flash"):
        a, b = outputs[f"{sched}/model"], outputs[f"{sched}/none"]
        if sched == "continuous":
            a, b = (np.concatenate([a[u] for u in sorted(a)]),
                    np.concatenate([b[u] for u in sorted(b)]))
        agree = float((a == b).mean()) if a.shape == b.shape else 0.0
        log(f"serve {sched}: SD vs AR token agreement {agree:.3f} (bf16: not "
            "required to be exact)")
    log(f"serve: torch.cuda.max_memory_allocated() = "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del target_f, draft_f
    release()
    served = {"cfg": cfg, "dcfg": dcfg, "target": target, "draft": draft,
              "params_t": params_t, "params_d": params_d, "pb": pb,
              "long_prompt": long_prompt, "outputs": outputs,
              "moe_layers": moe_layers, "attn_layers": attn_layers}
    return launches, served


# ---------------------------------------------------------------------- tuner
TUNER_BATCHES = (1, 2, 4, 8, 16, 32, 64, 128)
ETA_PROMPT, ETA_SEQ = 64, 128       # the wave workload's prompt bucket, max_seq


def tuner_reference_phase(seed: int):
    """Reduced fp32 on the card: the serving CLI's AutoTuner (make_tuner)
    plans every wave and every continuous paged round, through gamma
    changes and SD->AR hand-offs; greedy outputs equal the tuner-less AR
    run's on the card and the tuner-driven CPU run's, token for token,
    with the same plans on both devices."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import prompt_batch
    from repro_torch.launch.serve import make_tuner
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import ServingEngine

    cfg = get_config("qwen2-57b-a14b", reduced=True)
    dcfg = get_config("qwen2-0.5b", reduced=True)
    p_cpu = Model(cfg, moe_dispatch="gmm", device="cpu").init(
        torch.Generator().manual_seed(seed))
    pd_cpu = Model(dcfg, device="cpu").init(
        torch.Generator().manual_seed(seed + 1))
    pb = prompt_batch(cfg.vocab_size, 12, seed=seed, min_len=5, max_len=24)

    def models(dev):
        tm, dm = Model(cfg, moe_dispatch="gmm", device=dev), Model(dcfg,
                                                                 device=dev)
        return tm, _to_device(p_cpu, tm.device), dm, _to_device(pd_cpu,
                                                                dm.device)

    def waves(dev, kind, tuner):
        tm, pt, dm, pd = models(dev)
        eng = ServingEngine(tm, dm if kind == "model" else None, pt,
                            pd if kind == "model" else None, max_batch=2,
                            gamma=4, proposer=kind, seed=seed, tuner=tuner)
        for i in range(12):
            eng.submit(pb["tokens"][i][: int(pb["lengths"][i])],
                       max_new_tokens=12)
        reports = eng.run()
        out = np.stack([eng.done[u].output for u in sorted(eng.done)])
        return out, [r.gamma for r in reports], eng.session_stats()

    wave = {dev: waves(dev, "model", make_tuner("qwen2-57b-a14b"))
            for dev in ("cuda", "cpu")}
    ar, _, _ = waves("cuda", "none", None)
    gammas = wave["cuda"][1]
    if gammas != wave["cpu"][1] or len(set(gammas)) < 3 or 0 not in gammas:
        raise AssertionError(f"tuner reference: wave gammas {gammas} (card) "
                             f"vs {wave['cpu'][1]} (CPU): expected the same "
                             "plans, gamma changes and an AR hand-off")
    for name, out in (("tuner-less AR on the card", ar),
                      ("tuner-driven CPU run", wave["cpu"][0])):
        if not np.array_equal(wave["cuda"][0], out):
            raise AssertionError(f"tuner reference: tuner-driven waves on the "
                                 f"card != {name}")
    keys = wave["cuda"][2]["model"]["keys"]
    log(f"tuner reference: reduced fp32 waves (12 requests, max-batch 2) planned "
        f"gamma {gammas} (0: AR, the 'none' session); card == tuner-less AR == "
        f"CPU token for token; graph keys (gamma, batch, max_seq): "
        f"captures/replays {keys}")

    streams = {}
    for dev in ("cuda", "cpu"):
        tm, pt, dm, pd = models(dev)
        streams[dev] = continuous_stream(cfg, tm, pt, dm, pd, "model", seed,
                                         tuner=make_tuner("qwen2-57b-a14b"))
    tm, pt, dm, pd = models("cuda")
    ar = continuous_stream(cfg, tm, pt, dm, pd, "none", seed)
    got = streams["cuda"]
    g = [gm for _, gm in got["steps"]]
    first_ar = g.index(0) if 0 in g else None
    if (got["steps"] != streams["cpu"]["steps"] or first_ar is None
            or len({x for x in g[:first_ar]}) < 2):
        raise AssertionError(f"tuner reference: continuous plans {got['plans']}"
                             f" (card) vs {streams['cpu']['plans']} (CPU): "
                             "expected the same plans, gamma changes, then "
                             "the SD->AR hand-off")
    for name, other in (("tuner-less AR stream", ar),
                        ("tuner-driven CPU stream", streams["cpu"])):
        for uid, (reason, out) in other["outputs"].items():
            r2, o2 = got["outputs"][uid]
            if r2 != reason or not np.array_equal(o2, out):
                raise AssertionError(f"tuner reference: continuous request "
                                     f"{uid} on the card != {name}")
    log(f"tuner reference: reduced fp32 continuous paged stream, plans "
        f"(N(t)/gamma per round) {got['plans']}; card == tuner-less AR == CPU "
        f"token for token; graph keys captures/replays {got['keys']}")


def measured_tuner(cfg, dcfg, alpha: float, sim, t_t: dict, t_d: dict):
    """An AutoTuner whose simulator answers ``forward_time`` with the
    measured T_T(B, T) and T_D(B, 1) instead of their prices, so its plan
    and best_gamma come from the tuner's own formula
    (``Simulator.sd_speedup``) on the card's times; the rejection term
    stays priced."""
    from repro_torch.core.autotune import AutoTuner
    from repro_torch.core.simulator import Simulator

    class Measured(Simulator):
        def forward_time(self, c, batch, s, context_len=None):
            if c is cfg:
                return t_t[batch][s]
            if c is not dcfg or s != 1:
                raise ValueError(f"not measured: {c.name} at T {s}")
            return t_d[batch]

    return AutoTuner(cfg, dcfg, alpha, sim=Measured(
        hw=sim.hw, context_len=sim.context_len))


def tuner_phase(seed: int, served: dict) -> dict:
    """The AutoTuner on the full-width target and draft of the serve phase:
    (a) measured against predicted target efficiency and draft forwards;
    (d) the H100 record's plans beside the speedup the measured times give;
    (b) tuner-driven wave serving and (c) tuner-driven continuous paged
    serving, each run twice (the repeat captures nothing).  Returns the
    launch counts of its three paths."""
    import gc

    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.core.autotune import AutoTuner
    from repro_torch.core.simulator import Simulator
    from repro_torch.core.target_efficiency import (
        measure_extend_time, measure_target_efficiency,
        predicted_target_efficiency)
    from repro_torch.launch.serve import make_tuner, plan_trajectory
    from repro_torch.models.attention import PAGED_KERNEL_MAX_T
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.scheduler import submit_poisson

    cfg, dcfg = served["cfg"], served["dcfg"]
    target, draft = served["target"], served["draft"]
    params_t, params_d = served["params_t"], served["params_d"]
    moe_layers, attn_layers = served["moe_layers"], served["attn_layers"]
    full = get_config("qwen2-57b-a14b")
    gammas = AutoTuner(cfg, dcfg).gammas
    # priced at the measured context: prompts of ETA_PROMPT tokens
    sim = Simulator(context_len=ETA_PROMPT)
    launches = {}

    def reset():
        reset_launch_counts()
        for m in (target, draft):
            m.forward_count = m.prefill_count = 0

    def check_launches(path: str, rounds: int = 0) -> None:
        got = launch_counts()
        expect = {name: 0 for name in got}
        expect["fused_gate_up"] = expect["ragged_gmm"] = \
            moe_layers * target.forward_count
        if rounds:
            expect["paged_decode_attention"] = attn_layers * rounds
        log(f"tuner[{path}]: {target.forward_count} target forwards, "
            f"{draft.forward_count} draft forwards; launches counted "
            f"(credited per replay) {got}, expected {expect}")
        if got != expect:
            raise AssertionError(f"tuner[{path}]: launches {got} != {expect}")
        launches[path] = got

    # the tuner paths' widest round: gamma 8, dense (waves) and paged
    # (the continuous stream; 9 queries take the gathered view)
    for paged in (False, True):
        captured_verify_check(target, draft, params_t, params_d, served["pb"],
                              gamma=max(gammas), paged=paged, label="tuner")

    # (a) measured T_T and T_D: one extend, captured, replayed 7 times
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(seed + 11)
    t_t, t_d = {}, {}
    reset()
    for B in TUNER_BATCHES:
        tok = torch.randint(3, cfg.vocab_size, (B, ETA_PROMPT), generator=gen,
                            device="cuda")
        # distinct verify tokens per position, so the target routes them as
        # it routes drafts; the reference's token-0 extend for comparison
        ver = torch.randint(3, cfg.vocab_size, (B, max(gammas) + 1),
                            generator=gen, device="cuda")
        _, cache = target.prefill(params_t, tok,
                                  target.init_cache(B, ETA_SEQ))
        te = measure_target_efficiency(target, params_t, cache, 4,
                                       tokens=ver)
        zeros = measure_target_efficiency(target, params_t, cache, 4)
        t_t[B] = {1: te["T_T_1"], 5: te["T_T_gamma"]}
        for g in gammas:
            if g + 1 not in t_t[B]:
                t_t[B][g + 1] = measure_extend_time(target, params_t, cache,
                                                    g + 1, tokens=ver)
        _, dcache = draft.prefill(params_d, tok, draft.init_cache(B, ETA_SEQ))
        t_d[B] = measure_extend_time(draft, params_d, dcache, 1, tokens=ver)
        del cache, dcache
        pred = predicted_target_efficiency(sim, cfg, B, 4)
        times = list(t_t[B].values()) + [t_d[B], zeros["T_T_1"],
                                          zeros["T_T_gamma"]]
        if not all(np.isfinite(x) and x > 0 for x in times):
            raise AssertionError(f"tuner eta: B {B}: times {times}")
        log(f"tuner eta B={B}: measured T_T(B,1) {t_t[B][1] * 1e3:.4f} ms, "
            f"T_T(B,5) {t_t[B][5] * 1e3:.4f} ms, eta_target "
            f"{te['target_efficiency']:.4f} (token-0 extends, as the "
            f"reference times them: {zeros['T_T_1'] * 1e3:.4f} / "
            f"{zeros['T_T_gamma'] * 1e3:.4f} ms, "
            f"{zeros['target_efficiency']:.4f}) | H100 simulator eta_target "
            f"{pred['target_efficiency']:.4f}, T_T(B,1) "
            f"{pred['T_T_1'] * 1e3:.4f} ms, T_T(B,5) "
            f"{pred['T_T_gamma'] * 1e3:.4f} ms")
        d_sim = sim.forward_time(dcfg, B, 1)
        log(f"tuner draft B={B}: measured T_D(B,1) {t_d[B] * 1e3:.4f} ms "
            f"(one {dcfg.name} extend, graph replay) | H100 simulator "
            f"{d_sim * 1e3:.4f} ms (measured / priced "
            f"{t_d[B] / d_sim:.2f})")
    log("tuner eta: T_T(B,T) ms measured, T = 2..9: " + "; ".join(
        f"B {B}: " + " ".join(f"{t_t[B][T] * 1e3:.3f}" for T in sorted(t_t[B]))
        for B in TUNER_BATCHES))
    check_launches("tuner/eta")
    log(f"tuner eta: {time.perf_counter() - t0:.1f} s")

    # (d) plans on the H100 record, beside the same tuner's plans on the
    # measured times
    cli = make_tuner(full.name)
    alpha = cli.alpha
    tuners = {f"{full.name} x28 + {cli.draft.name} (CLI)": cli,
              f"{full.name} x28 + {dcfg.name}": AutoTuner(full, dcfg, alpha),
              f"{cfg.name} x{cfg.num_layers} + {dcfg.name}":
                  AutoTuner(cfg, dcfg, alpha)}
    on_card = measured_tuner(cfg, dcfg, alpha, sim, t_t, t_d)
    for name, tuner in tuners.items():
        win = tuner.speedup_window()
        log(f"tuner plan [{name}], H100 record, alpha {alpha}: speedup window "
            f"peak B {win['peak_batch']} ({win['peak']:.3f}x), window "
            f"{win['window']}")
        measured_here = tuner.target is cfg
        for B in TUNER_BATCHES:
            plan = tuner.plan(B)
            line = (f"  B={B}: plan gamma={plan['gamma']} "
                    f"use_sd={plan['use_sd']} predicted "
                    f"{plan['predicted_speedup']:.3f}x")
            if measured_here:
                meas = on_card.plan(B)
                line += (f" | measured T_T, T_D: "
                         f"{on_card.speedup(B, plan['gamma']):.3f}x at gamma "
                         f"{plan['gamma']}; plan gamma={meas['gamma']} "
                         f"use_sd={meas['use_sd']} "
                         f"{meas['predicted_speedup']:.3f}x")
            log(line)

    # (b) tuner-driven wave serving: 16 chat prompts, max-batch 8
    pb = served["pb"]
    tuner = make_tuner(full.name)
    eng = ServingEngine(target, draft, params_t, params_d, max_batch=8,
                        gamma=4, proposer="model", seed=seed, tuner=tuner)
    reset()
    runs = []
    for run in ("first run", "again"):
        tuner.alpha = 0.7                       # the same workload, replayed
        if run == "again":
            for sess in eng._sessions.values():
                sess.sync_guard = True
        first = max(eng.done, default=0)
        for i in range(16):
            eng.submit(pb["tokens"][i][: int(pb["lengths"][i])],
                       max_new_tokens=32)
        reports = eng.run()
        for r in reports:
            sd = (f"sigma={r.stats.sigma:.3f} alpha={r.stats.alpha:.3f}"
                  if r.used_sd else "AR")
            log(f"tuner wave ({run}): plan gamma={r.plan['gamma']} "
                f"use_sd={r.plan['use_sd']} predicted "
                f"{r.plan['predicted_speedup']:.3f}x, tuner alpha "
                f"{r.tuner_alpha[0]:.3f} -> {r.tuner_alpha[1]:.3f}; ran "
                f"proposer={r.proposer} B={r.batch}/{r.bucket} gamma={r.gamma} "
                f"{r.tokens_per_second:.2f} tok/s {sd} rounds={r.stats.rounds} "
                f"captures={r.captures} replays={r.replays}")
        out = np.stack([eng.done[u].output for u in sorted(eng.done)
                        if u > first])
        if out.shape != (16, 32) or out.min() < 0 or out.max() >= cfg.vocab_size:
            raise AssertionError(f"tuner wave: bad outputs {out.shape}")
        runs.append((out, reports))
    for sess in eng._sessions.values():
        sess.sync_guard = False
    again = runs[1][1]
    if sum(r.captures for r in again) or \
            [r.gamma for r in again] != [r.gamma for r in runs[0][1]]:
        raise AssertionError("tuner wave: the repeat captured "
                             f"{sum(r.captures for r in again)} keys or "
                             "planned other gammas")
    for kind, st in eng.session_stats().items():
        if kind != "resilience":
            log(f"tuner wave: session[{kind}] graph keys (gamma, batch, "
                f"max_seq): captures/replays {st['keys']}, pool "
                f"{eng._sessions[kind].graphs.pool_bytes() / 2**20:.1f} MiB")
    ar = served["outputs"]["wave/none"]
    log(f"tuner wave: outputs vs the tuner-less AR wave: token agreement "
        f"{float((runs[0][0] == ar).mean()):.3f} (bf16: not required to be "
        f"exact; the reduced fp32 phase requires it); the repeat's outputs "
        f"{'equal' if np.array_equal(runs[0][0], runs[1][0]) else 'differ from'}"
        " the first run's")
    check_launches("tuner/wave")
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    # (c) tuner-driven continuous paged serving: Poisson arrivals and a
    # 700-token prompt at round 6, pool of 8, pages of 64
    tuner = make_tuner(full.name)
    eng = ServingEngine(target, draft, params_t, params_d, max_batch=8,
                        gamma=4, proposer="model", seed=seed, tuner=tuner,
                        scheduler="continuous", kv_layout="paged",
                        page_size=64)
    reset()
    runs, kernel_rounds = [], 0
    for run in ("first run", "again"):
        tuner.alpha = 0.7
        if run == "again":
            eng._sessions["model"].sync_guard = True
        first = max(eng.done, default=0)
        submit_poisson(eng, pb["tokens"], pb["lengths"], rate=0.5,
                       max_new_choices=(8, 16, 32), seed=seed)
        eng.submit(served["long_prompt"], max_new_tokens=16, arrival_round=6)
        (r,) = eng.run()
        # a verify wider than PAGED_KERNEL_MAX_T (gamma 8) attends over the
        # gathered view, as in the reference: no paged kernel in that round
        kernel_rounds += sum(1 for st in r.steps if st.live
                             and st.gamma + 1 <= PAGED_KERNEL_MAX_T)
        traj = [(st.live, st.gamma) for st in r.steps]
        log(f"tuner continuous ({run}): {r.tokens_per_second:.2f} tok/s "
            f"rounds={r.stats.rounds} tokens={r.tokens_out} "
            f"captures={r.captures} replays={r.replays}, tuner alpha "
            f"{tuner.alpha:.3f}; plans (N(t)/gamma per round) "
            f"{plan_trajectory(r.steps)}")
        done = {u - first: eng.done[u] for u in eng.done if u > first}
        if len(done) != 17 or {d.finish_reason for d in done.values()} != \
                {"length"}:
            raise AssertionError(f"tuner continuous: {len(done)} requests")
        runs.append(({u: d.output for u, d in done.items()}, traj, r))
    eng._sessions["model"].sync_guard = False
    g = [gm for _, gm in runs[0][1]]
    if 0 not in g or len({x for x in g[:g.index(0)]}) < 2:
        raise AssertionError(f"tuner continuous: gammas {g}: expected gamma "
                             "changes, then the SD->AR hand-off")
    if runs[1][2].captures or runs[1][1] != runs[0][1]:
        raise AssertionError(f"tuner continuous: the repeat captured "
                             f"{runs[1][2].captures} keys or planned "
                             "other rounds")
    st = eng.session_stats()["model"]
    log(f"tuner continuous: graph keys (gamma, batch, max_seq): "
        f"captures/replays {st['keys']}; growths {st['growths']}; graph pool "
        f"{eng._sessions['model'].graphs.pool_bytes() / 2**20:.1f} MiB in "
        f"{sum(eng._sessions['model'].graphs.capture_seconds.values()):.3f} s "
        "of captures")
    ar = served["outputs"]["continuous/none"]
    a = np.concatenate([runs[0][0][u] for u in sorted(runs[0][0])])
    b = np.concatenate([ar[u] for u in sorted(ar)])
    log(f"tuner continuous: outputs vs the tuner-less AR stream: token "
        f"agreement {float((a == b).mean()) if a.shape == b.shape else 0:.3f} "
        "(bf16: not required to be exact; the reduced fp32 phase requires it)")
    eng._slot_scheduler._alloc.assert_no_leaks()
    check_launches("tuner/continuous", kernel_rounds)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run it from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))

    card = card_line()
    log(f"card: {card}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    t_start = time.perf_counter()
    build_kernels()
    kernels = kernel_phase(args.seed)
    kernels["paged_decode_attention"] = paged_kernel_phase(args.seed)
    kernels["decode_attention"] = decode_kernel_phase(args.seed)
    kernels["flash_attention"] = flash_kernel_phase(args.seed)
    kernels["gmm_capacity"] = capacity_kernel_phase(args.seed)
    reference_phase(args.seed)
    flash_reference_phase(args.seed)
    launches, served = serve_phase(args.seed)
    launches.update(tuner_phase(args.seed, served))
    del served
    tuner_reference_phase(args.seed)
    launches[OPS_PATH] = capacity_ops_path(args.seed)

    tols = {"fused_gate_up": f"rtol=atol={TOL} (tests/test_ragged_gmm.py)",
            "ragged_gmm": f"rtol=atol={TOL} (tests/test_ragged_gmm.py)",
            "paged_decode_attention":
                "bf16 rtol=atol=2e-2, fp32 2e-5 (decode_attention.py:288); "
                f"bf16 split-KV body also <= {PAGED_ROW_TOL} x row rms",
            "decode_attention": "bf16 rtol=atol=4e-2, fp32 3e-5 "
                                "(tests/test_kernels.py); bf16 split-KV "
                                f"body also <= {DECODE_ROW_TOL} x row rms",
            "flash_attention": "bf16 rtol=atol=3e-2, fp32 2e-5 "
                               "(tests/test_kernels.py); bf16 also "
                               f"<= {FLASH_ROW_TOL} x row rms",
            "gmm_capacity": "bf16 rtol=atol=2e-2, fp32 1e-5 "
                            "(tests/test_kernels.py)"}
    line = []
    for name, res in kernels.items():
        v = res["cases"][MAIN_CASE[name]]
        line.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": TPU_SITES[name],
            # the kernel's main path, and every path beside it
            "launches": launches[MAIN_PATH[name]][name],
            "main_path": MAIN_PATH[name],
            "launches_by_path": {path: counts[name]
                                 for path, counts in launches.items()},
            "max_abs_err": res["max_abs_err"], "tol": tols[name],
            "max_err_over_tol": res["max_err_over_tol"],
            "ms": v["kernel_ms"], "kernel_ms": v["kernel_ms"],
            "plain_ms": v["plain_ms"], "bound_ms": v["bound_ms"],
            "bound_by": v["bound_by"], "library_ms": v["library_ms"],
            "library": v["library"], "cases": res["cases"]})
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(f"card: {card}")
    log(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
