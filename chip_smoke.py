#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed N]

Phases, each of which fails the run if it fails:

  1. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
  2. build every CUDA kernel of the path from the sources in this checkout,
     one nvcc per source, all at once, and print the build time; beside it
     ``ptxas -v`` of the TMA + wgmma kernels (flash prefill at head dims 32,
     64, 128 with one and two consumer warpgroups, 256 with two; capacity GEMM with 1
     and 2 consumer warpgroups and column tiles of 128 and 256; paged
     decode/verify at head dims 64, 128, 256, dense at 64 and 128; ragged
     down and fused gate/up GEMMs, silu and gelu) and of attention_tile.cuh's
     body at head dim 256 (kernel 4 in bf16 and fp32, kernel 5 in fp32):
     registers, dynamic shared memory, spills (none allowed in the D-256
     TMA + wgmma bodies);
  3. kernels: at the main paths' shapes, run each kernel and its plain
     PyTorch version on the same inputs made from --seed, hold them within
     the stated tolerance and time both beside the card's bound:
       * the ragged expert-FFN kernels (SD verify: 320 routed rows, top-8 of
         64 experts; AR verify: 64 rows; prefill: 4096 rows; empty experts
         with unaligned groups; the same three routings at mixtral-8x7b's
         and dbrx-132b's expert widths), bf16, rtol = atol = 3e-2
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
         (~8k positions), logit cap 30, head dims 64 and 256, and at
         gemma3-12b's 16/8 and gemma-7b's 16/16 heads of 256 (1100-1640
         cached positions), bf16 at rtol = atol = 2e-2 through the split-KV
         TMA + wgmma body (paged.LAST_ROUTE "sm90" at every head dim) and
         every element within PAGED_ROW_TOL x the rms of its output row,
         with the body's shared memory on the line; SD verify
         and long context also in fp32 at 2e-5 (the reference's bound,
         src/repro/kernels/decode_attention/decode_attention.py:288);
       * the flash prefill kernel (prefill of 8 prompts of 256 tokens at the
         target's 28/4 heads of 128 and the draft's 14/2 heads of 64, a 4096-
         token prefill, a window-and-cap case; at head dim 256 gemma3-12b's
         16/8 heads with its window of 1024 and without, gemma-7b's 16/16,
         T 256 and 2048, through the TMA + wgmma body in bf16 and
         attention_tile's CUDA-core body in fp32), bf16 at rtol = atol = 3e-2
         and every element within 5e-2 of the rms of its output row (the
         late rows of a long prefill are smaller than 3e-2) through the
         TMA + wgmma kernel, and fp32 at the reference's 2e-5 through the
         CUDA-core body (tests/test_kernels.py);
       * the dense decode/verify kernel on the (B, S+1, Hkv, D) cache layout:
         SD verify (B 8, T 5, S 512, lengths 129-290), AR (T 1), the draft's
         14/2 heads of 64 at T 1 and T 5, long context (S 8192), and at
         head dim 256 gemma3-12b's 16/8 heads (T 1, 5, 9) and gemma-7b's
         16/16 (T 5) at S 2048 (the split-KV body too) and gemma3's heads
         at T 33 (66 rows a KV head: attention_tile's WMMA body), bf16 at
         4e-2 through the split-KV TMA + wgmma body (decode_attention
         .LAST_ROUTE "sm90") and the WMMA body ("wmma"), and every
         element within DECODE_ROW_TOL x the rms of its output row on
         both, SD verify and long context also in fp32 at
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
     greedy outputs equal those with use_flash=False; a continuous paged
     stream with prefix sharing (a 128-token shared prefix, 2 pages of 64,
     and a follow-up turn whose boundary page is copied on write), chunked
     admission (chunks of 64, a late 700-token prompt) and the fault smoke
     lane's scripted injector (failed admissions, held pages, a NaN row, a
     slow round) emits the same tokens and finish reasons from graph
     replay, eagerly on the card and on the CPU; the requests that finish
     cleanly beside the NaN row give the stream's tokens without the NaN
     fault, and that stream gives those of the stream without sharing and
     chunking; the EAGLE and prefetch proposers (a reduced EagleHead; the
     reduced draft behind the router probe): greedy SD from graph replay
     equals a second replayed generation, the eager card session, the CPU
     and greedy AR, token for token, with the prefetch hit, actual and
     predicted counts equal to the CPU's; and an EAGLE continuous paged
     stream with prefix sharing (pages of 16) and chunked admission
     (chunks of 16, a late 40-token prompt) from graph replay equals the
     eager card and the CPU, request for request;
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
       * continuous-prefix (SD, then AR): the continuous workload with
         every prompt behind a 256-token shared system prompt (4 pages),
         prefix_sharing=True and prefill_chunk 128: tok/s, prefix and
         copy-on-write counters, chunk steps, captures, replays and graph
         pool beside the card's name and power limit, and the greedy
         tokens' agreement with the same stream without sharing and
         chunking on the same engine (bf16; printed);
       * continuous-faults (SD): the continuous workload under a seeded
         injector (failed admissions, held pages, a NaN row after the last
         admission, a slow round of 10x the clean stream's median round):
         one numerical_fault and 16 "length", a slow round counted, no
         leaked page, and every other request's tokens equal to the clean
         stream's;
       * wave-prefetch (the "prefetch" proposer: the "model" drafter and a
         router probe that warms the top 16 of 64 experts a MoE layer,
         then AR): the wave workload; every prefetch round runs staged
         (propose and probe, warm, verify, finalize: four graphs a key);
         tok/s, the hit rate, predicted = rounds x 16 x MoE layers
         (required), captures and replays per stage key, the warm stage's
         device time beside its byte bound and its buffers' bytes, and a
         timed wave's propose/warm/verify/reject split;
       * wave-eagle and continuous-eagle (SD with the "eagle" proposer,
         then AR), after the qwen2-57b-a14b target is freed: mixtral-8x7b
         at its published width (d 4096, 8 experts top-2, moe_d_ff 14336),
         depth cut to LAYERS of 32, with its full-width EagleHead (8/2
         heads of 64, d_ff 16384), on the wave workload and on the
         continuous paged workload (admission through
         prefill_with_hidden, the feature carry's scatter and growth,
         kernel 3 every round); tok/s, rounds, sigma, captures, replays
         and the launches of kernels 1 and 2;
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
  8. the attention-only assigned archs (dbrx-132b, gemma-7b, gemma3-12b,
     minicpm3-4b, qwen2-vl-2b), each with its draft_for draft:
       a. reduced, fp32: card vs CPU logits, and greedy waves SD from graph
          replay == SD eager == SD on the CPU == AR; gemma3-12b (rings in a
          paged cache, a row reused after a request longer than its window)
          and minicpm3-4b (latent pages) also on a continuous paged stream;
       b. at published width, random bf16 weights, SD then AR, max-batch 8,
          gamma 4: wave-gemma3 (all 48 layers, use_flash, 16 prompts of
          1100-1600 tokens: kernel 5 at D 256 with the window, kernel 4 at
          D 256 on the global layers), continuous-gemma3 (the same model
          paged, pages of 64: kernel 3 at D 256), wave-dbrx (4 of 40
          layers: kernels 1 and 2), wave-gemma7b (full depth, use_flash,
          the prompts of wave-gemma3: kernels 4 and 5 at D 256),
          wave-minicpm3 and wave-qwen2vl (full depth); tok/s, captures,
          replays, launches; on the use_flash paths every launch of
          kernels 3-5 at D 256 must report its D-256 body (TMA + wgmma for
          3, 4 and 5), counted per route and head dim.
  9. the recurrent and encoder-decoder archs (jamba-v0.1-52b, xlstm-1.3b,
     whisper-base), each with its draft_for draft:
       a. reduced, fp32, in phase 8a's loop (whose logit check is also a
          verify with collected states, a commit with an inactive row and
          the next decode step): card vs CPU logits, greedy waves SD from
          graph replay == SD eager == SD on the CPU == AR (whisper through
          SDEngine.generate with stub frames in prefill_kwargs:
          ServingEngine refuses an encoder-decoder); jamba also on a
          continuous paged stream with and without chunked admission; and
          the recurrent-draft pair of the reference's
          test_recurrent_draft_lossless (SD == AR);
       b. in phase 8b's loop, at published width, random bf16 weights, SD
          then AR, max-batch 8, gamma 4: wave-jamba (JAMBA_LAYERS = 8 of
          32 layers, one whole period, use_flash, prompts of 130-256
          tokens in a bucket of 256 at max_seq 512: kernels 1, 2, 4, 5),
          continuous-jamba (paged, pages of 64: kernels 1, 2, 3),
          wave-xlstm (all 48 layers, use_flash: no kernel in the target,
          4 and 5 in its draft) and wave-whisper (6 + 6 layers, 1500
          frames, through SDEngine.generate and the AR session with the
          prompts and capacity of wave-jamba, use_flash: kernels 5 and 4
          on the decoder); tok/s, captures, replays, graph pool, launches;
       c. one recurrent layer at published width, B 8, device-only: an SD
          verify (T 5, states collected) and a prefill (T 256) of Mamba
          (jamba's width), mLSTM and sLSTM (xlstm's), each beside its
          bound (weights and states at the memory rate against the
          matmuls at the bf16 peak and the recurrence at the fp32 peak).
     Phase 3 also holds kernels 1 and 2 at jamba's routing (E 16, top-2,
     d 4096, f 14336) and kernels 4 and 5 at the shapes these paths give
     them: T 256 prefills and T 5 / T 1 extends at S 512 of whisper's 8 / 8
     heads of 64, jamba's 32 / 8 heads of 128 and the drafts' 8 / 2 of 64.
     Each path runs with every launch count set to 0 just before it and
     read just after (replays credit the launches their capture recorded):
     each gmm kernel's count must equal (MoE layers x that
     path's target forwards); on the continuous paths the paged kernel's
     must equal (attention layers x rounds), and on the continuous-prefix
     paths (attention layers x (rounds + tail admissions of at most 8
     tokens)); on the wave-flash paths the
     flash kernel's must equal (attention layers x prefill forwards) and
     the dense decode kernel's (attention layers x extend forwards), summed
     over target and draft; every other count must be 0.  The tuner's three
     paths (tuner/eta, tuner/wave, tuner/continuous), wave-prefetch,
     wave-eagle, continuous-eagle and phases 8b's and 9b's paths are
     counted the same way (8b: the dense decode kernel on the global layers only, since a
     sliding-window layer attends over its ring by mask; on
     continuous-gemma3 the flash count a positive multiple of the layers a
     prefill runs it on, as the 1-token fillers and short prompts take no
     kernel).

  10. training, after the serving phases have freed their models; no
     kernel runs (none has a backward, and each wrapper refuses an input
     that requires grad, as the reference's Pallas kernels refuse jax.grad):
       a. reduced, fp32, TF32 off: qwen2-57b-a14b-reduced (experts, shared
          expert, aux loss) and qwen2-0.5b-reduced, 3 AdamW steps from one
          init on the card and on the CPU: loss, aux and grad norm of each
          step within TRAIN_TOL, the parameters after step 3 within
          TRAIN_PARAM_TOL x the sum of the steps' learning rates; and
          chunked_sdpa's recompute backward at T 1536 (two key chunks, a
          window and a softcap), card against CPU within TRAIN_TOL;
       b. train/qwen2-0.5b: the draft at its published config (24 layers,
          bf16 weights, fp32 moments) through launch/train.py's main,
          --seq 2048 --batch 4 --steps 20 --kind code --lr 1e-3, its
          checkpoint in a temporary directory restored bit for bit; every
          loss finite, the last below the first by more than 1.0 (at T
          2048 every attention takes chunked_sdpa's backward);
       c. train/qwen2-57b-a14b: the target at published width, TRAIN_LAYERS
          of 28 layers, onehot dispatch, remat, B 2, T 512, lr 1e-4, 5
          steps, every loss finite and the last below the first.
     b and c print the step's ms (median of the steps after the first two),
     tokens/s, torch.cuda.max_memory_allocated and the step's FLOP bound at
     the bf16 peak (8 x matmul parameters x tokens with remat, every expert
     on every token under onehot, plus 4 x the causal attention's forward),
     beside the card's name and power limit.  Every kernel's launch count
     must be 0 over each of a, b and c.
  11. expert parallelism (ep_phase, run after phase 6 on phase 5's target
     and weights, no second copy), on a NCCL world of one
     (launch/mesh.make_ep_mesh(1)):
       a. kernels 1 and 2 at the target's width on an expert-parallel
          receive buffer: the SD verify's 320 routed rows of EP_ROWS = 384,
          NaN in the rows past the groups, held against the plain version
          on the real rows at rtol = atol = 3e-2, and device-only at N 320
          and N 384 in turns (A B B A): the rows past the groups must cost
          no tiles (the gap within the repeats' spread plus EP_TIME_NOISE
          of the time);
       b. distributed/collectives.moe_ep_forward against the gmm dispatch:
          the reduced target's layer in fp32 (within 3e-4) and the served
          layer in bf16 (printed) at an SD verify (B 8, T 5) and a
          256-token prefill, each device-only with its NCCL all-to-alls
          inside the captured call; EP_CALLS must be > 0;
       c. wave-ep/model and wave-ep/none: phase 5's wave workload on a
          Model(moe_dispatch="ep", mesh=...) engine, every round from CUDA
          graphs, run twice (the repeat captures nothing; its rounds under
          sync debug mode "error"); tok/s, the greedy tokens' agreement
          with wave/model's and wave/none's (bf16, printed), launches of
          kernels 1-2 and EP calls each = MoE layers x target forwards;
          then the workload a third time under compile_guard,
          transfer_guard and sharding_guard (analysis/runtime.py), which
          must count 0, 0 and be ok; and the three guards over phase 5's
          continuous paged stream (gmm) on a warm engine, likewise.
  12. tensor parallelism (tp_phase, right after phase 11 on its target and
     weights), on a new NCCL world of one:
       a. kernel 4's partial entry (one key block of a cache split along
          its sequence: output and log-sum-exp) at the target's 28/4 heads
          of 128, bf16, B 8, T 5, S 512 and S 8192, and at gemma3-12b's
          16/8 heads of 256 at S 2048, the keys in 2 and in 4 blocks: each block against its plain version (4e-2; the lse at
          -inf exactly where the plain version's is), the blocks merged by
          log-sum-exp against the whole call (4e-2 and DECODE_ROW_TOL x a
          row's rms), route sm90; device-only ms per block beside the whole
          call, the block's byte bound and aten's efficient attention with
          its log-sum-exp over the block;
       b. wave-tp/model and wave-tp/none: phase 5's wave workload on
          Model(moe_dispatch="ep", mesh=..., mesh_layout="tp") through
          ServingEngine(mesh=..., mesh_layout="tp"): greedy tokens equal
          to wave-ep's bit for bit (every spec resolves whole at m 1),
          launches equal to wave-ep's, tok/s beside wave-ep's, and the
          three guards 0 / 0 / ok on the warm repeat;
       c. one sharded train step (params placed with fsdp=True, the model
          on the mesh) of the reduced fp32 target equal to the unsharded
          step, leaf for leaf.

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
# rounding of P and of the output; PERF.md).  At head dim 256 (gemma's
# 1100-1640 positions, |out| ~ 0.045, near PAGED_TOL) the same body is held
# to the same bound: it read <= 0.028 x there (NVIDIA H100 80GB HBM3,
# 700.00 W), and kernel_variants.py's paged_last_chunk fault (each split
# skips its last chunk) must fail it.
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
# At head dim 256 (gemma's 1100-1640 positions, |out| ~ 0.045, near
# DECODE_TOL) both bf16 bodies are held to the same bound: the WMMA body
# read <= 0.027 x there (NVIDIA H100 80GB HBM3, 700.00 W), and
# kernel_variants.py's decode_last_chunk fault (each split of the split-KV
# body skips its last chunk) and tile_last_chunk fault (attention_tile
# skips its last key chunk) must fail it.
DECODE_ROW_TOL = 5e-2
GMM_TOL = {"bfloat16": 2e-2, "float32": 1e-5}
# Target depth at full width: the bf16 weights of all 28 layers (57.4B
# parameters, ~115 GB) do not fit in the card's 80 GB; 4 layers are ~18 GB.
LAYERS = 4
EAGLE_ARCH = "mixtral-8x7b"          # the EAGLE paths' target (cut to LAYERS)
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
    # attention_tile.cuh's body at head dim 256: kernel 4's in both dtypes
    # (dense decode library), kernel 5's in fp32 (flash library)
    tile_smem = build.load(flash_attention.SOURCE).attention_tile_smem_bytes
    smem["attention_tile_kernel"] = lambda dt, d: tile_smem(
        0 if dt == "bf16" else 1, d)
    seen, tiles, spilled = set(), set(), []
    for src, text in reports.items():
        for line in text.splitlines():
            if "(C75" in line and "sm90_kernel" in line:   # ptxas's advisories
                log(f"ptxas ({src.name}): {line.strip()[:240]}")
        for kernel, args, regs, spills in _ptxas_entries(text):
            if kernel == "attention_tile_kernel":
                if args[1] != 256:
                    continue
                tiles.add((src.name, args[0]))
            else:
                seen.add((kernel, args))
                if (args[0] == 256 and kernel in D256_SM90
                        and not re.search(r"\b0 bytes spill stores, 0 bytes "
                                          r"spill loads", spills or "")):
                    spilled.append((kernel, args, spills))
            log(f"ptxas {kernel}<{', '.join(map(str, args))}> ({src.name}): "
                f"{regs} registers at entry, {smem[kernel](*args)} bytes "
                f"dynamic shared memory, {spills}")
    if spilled:
        raise AssertionError(f"ptxas -v: the head-dim-256 TMA + wgmma bodies "
                             f"spill: {spilled}")
    want = ({("flash_sm90_kernel", (d, nc)) for d in (32, 64, 128)
             for nc in (1, 2)} | {("flash_sm90_kernel", (256, 2))}
            | {("gmm_capacity_sm90_kernel", a)
               for a in ((1, 128), (2, 128), (2, 256))}
            | {("paged_sm90_kernel", (d,)) for d in (64, 128, 256)}
            | {("decode_sm90_kernel", (d,)) for d in (64, 128, 256)}
            | {("ragged_sm90_kernel", a) for a in ((1, 0), (2, 0), (2, 1))})
    if seen != want:
        raise AssertionError(f"ptxas -v shows TMA + wgmma kernels {sorted(seen)}"
                             f", expected {sorted(want)}")
    # kernel 4 in both dtypes; flash in fp32 (bf16 runs flash_sm90 at 256)
    want = {(dec_ops.SOURCE.name, "bf16"), (dec_ops.SOURCE.name, "fp32"),
            (flash_attention.SOURCE.name, "fp32")}
    if tiles != want:
        raise AssertionError(f"ptxas -v shows attention_tile_kernel at head "
                             f"dim 256 as {sorted(tiles)}, expected "
                             f"{sorted(want)}")


# the TMA + wgmma bodies of kernels 3, 4 and 5 at head dim 256: no spills
D256_SM90 = ("flash_sm90_kernel", "paged_sm90_kernel", "decode_sm90_kernel")


def _ptxas_entries(text: str, kernels=("flash_sm90_kernel",
                                        "gmm_capacity_sm90_kernel",
                                        "paged_sm90_kernel",
                                        "decode_sm90_kernel",
                                        "ragged_sm90_kernel",
                                        "attention_tile_kernel")):
    """(kernel, template arguments, registers, spill line) for each entry
    function of ``kernels`` in ``ptxas -v`` output; a type argument
    (attention_tile_kernel's) comes first, as "bf16" or "fp32"."""
    pattern = re.compile(r"Compiling entry function '\w*?(%s)"
                         r"(?:I(13__nv_bfloat16|f)?((?:Li\d+E)+)E)?"
                         % "|".join(kernels))
    name = args = spills = None
    for line in text.splitlines():
        m = pattern.search(line)
        if m:
            name = m.group(1)
            dt = {None: (), "f": ("fp32",)}.get(m.group(2), ("bf16",))
            args = dt + tuple(int(a) for a in re.findall(r"Li(\d+)E",
                                                         m.group(3) or ""))
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
    """Group sizes of the ragged kernels' cases at qwen2-57b-a14b's expert
    widths: top-K routing of the tokens of an SD verify, an AR verify and a
    prefill, and a fixed list with empty experts and unaligned groups."""
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


def prefixed_ragged_cases(prefix: str):
    """The routings of ragged_cases' serving cases (an SD verify, an AR
    verify and a prefill of B 8) as PREFIX_verify, PREFIX_ar_verify and
    PREFIX_prefill: the cases at another target's expert widths."""
    def cases(E: int, K: int, gen, dev) -> dict:
        return {f"{prefix}_verify": routed_sizes(40, E, K, gen, dev),
                f"{prefix}_ar_verify": routed_sizes(8, E, K, gen, dev),
                f"{prefix}_prefill": routed_sizes(512, E, K, gen, dev)}
    return cases


def kernel_phase(seed: int):
    """Kernels 1 and 2 against their plain versions at the expert widths of
    every full-width MoE target: qwen2-57b-a14b (the serve and prefetch
    paths), EAGLE_ARCH (the EAGLE paths), dbrx-132b (wave-dbrx) and
    jamba-v0.1-52b (wave-jamba, continuous-jamba: E 16, top-2, d 4096,
    f 14336); every bf16 case must take the TMA + wgmma route."""
    import torch

    gen = torch.Generator(device=torch.device("cuda")).manual_seed(seed)
    results = {name: {"cases": {}, "max_abs_err": 0.0, "max_err_over_tol": 0.0}
               for name in ("fused_gate_up", "ragged_gmm")}
    for arch, cases_fn in (("qwen2-57b-a14b", ragged_cases),
                           (EAGLE_ARCH, prefixed_ragged_cases("mixtral")),
                           ("dbrx-132b", prefixed_ragged_cases("dbrx")),
                           ("jamba-v0.1-52b",
                            prefixed_ragged_cases("jamba"))):
        _ragged_width_cases(arch, cases_fn, gen, results)
    return results


def _ragged_width_cases(arch: str, cases_fn, gen, results: dict) -> None:
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.gmm import ragged
    from repro_torch.kernels.gmm.ref import fused_gate_up_ref, ragged_gmm_ref

    dev = torch.device("cuda")
    cfg = get_config(arch)
    E, K, D, F = cfg.num_experts, cfg.num_experts_per_tok, cfg.d_model, cfg.moe_d_ff
    dt = torch.bfloat16
    wg, wu = ((torch.randn((E, D, F), generator=gen, device=dev) / D ** 0.5).to(dt)
              for _ in range(2))
    wd = (torch.randn((E, F, D), generator=gen, device=dev) / F ** 0.5).to(dt)
    # the fused kernel's two products alone, for context: one grouped
    # product over [Wg | Wu] (made here, outside any timed region)
    wgu = torch.cat([wg, wu], dim=2)
    cases = cases_fn(E, K, gen, dev)
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
                arch=arch, E=E, d=D, f=F,
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
    # the EAGLE paths' target (EAGLE_ARCH: 32 query / 8 KV heads of 128)
    "mixtral_sd_verify": ("bfloat16", 5, 128, (16, 130), 0.0),
    "mixtral_ar_verify": ("bfloat16", 1, 128, (16, 130), 0.0),
    # continuous-gemma3's global layers (16 / 8 heads of 256, the split-KV
    # TMA + wgmma body) at the path's lengths, and gemma-7b's 16 / 16
    "gemma3_sd_verify": ("bfloat16", 5, 256, (1100, 1640), 0.0),
    "gemma3_ar_verify": ("bfloat16", 1, 256, (1100, 1640), 0.0),
    "gemma7b_sd_verify": ("bfloat16", 5, 256, (1100, 1640), 0.0),
}
SERVE_HEADS = (28, 4)               # qwen2-57b-a14b's query / KV heads
PAGED_HEADS = {"mixtral_sd_verify": (32, 8), "mixtral_ar_verify": (32, 8),
               "gemma3_sd_verify": (16, 8), "gemma3_ar_verify": (16, 8),
               "gemma7b_sd_verify": (16, 16)}


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


def paged_inputs(spec, gen, dev, heads=SERVE_HEADS, B: int = 8,
                 ps: int = 64):
    """(q, k_pages, v_pages, lengths, table) of a PAGED_CASES entry at
    ``heads`` (query, KV; a case's own: PAGED_HEADS, else the serve
    widths): noise in every physical page (trash page 0 included), a
    permuted table one page wider than the longest row needs, ragged
    lengths."""
    import torch
    Hq, Hkv = heads
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
    serve widths (28 query / 4 KV heads, pages of 64) and at the EAGLE
    paths' (32 / 8)."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attention import paged
    from repro_torch.kernels.decode_attention.ref import \
        paged_decode_attention_plain

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    res = {"cases": {}, "max_abs_err": 0.0, "max_err_over_tol": 0.0}
    for case, spec in PAGED_CASES.items():
        dtype_name, T, D, _, cap = spec
        args = paged_inputs(spec, gen, dev, PAGED_HEADS.get(case, SERVE_HEADS))
        q, kp, vp, lengths, table = args
        B, Hq, Hkv = q.shape[0], q.shape[2], kp.shape[2]
        MP, ps = table.shape[1], kp.shape[1]
        out = paged.paged_decode_attention(*args, logit_cap=cap)
        route = paged.LAST_ROUTE["paged_decode_attention"]
        ref = paged_decode_attention_plain(*args, logit_cap=cap)
        torch.cuda.synchronize()
        want = "sm90" if dtype_name == "bfloat16" else "simt"
        if route != want:
            raise AssertionError(f"paged_decode_attention [{case}]: ran the "
                                 f"{route} body, expected {want}")
        tol = PAGED_TOL[dtype_name]
        err = _hold("paged_decode_attention", case, out, ref, tol, res)
        row_err = row_scaled_err(out, ref)
        if dtype_name == "bfloat16" and row_err > PAGED_ROW_TOL:
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
        smem = (build.load(paged.SOURCE).paged_sm90_smem_bytes(D)
                if route == "sm90" else None)
        res["cases"][case] = dict(
            dtype=dtype_name, route=route, B=B, T=T, Hq=Hq, Hkv=Hkv,
            head_dim=D, page_size=ps, smem_bytes=smem,
            lengths=[int(n) for n in lengths.tolist()], keys=keys,
            pages_touched=touched,
            kernel_ms=ms, kernel_graph_ms=graph_ms, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by,
            bytes=n_bytes, library_ms=None,
            library="no single call walks a block table",
            sdpa_gathered_ms=sdpa_ms, sdpa_gathered_graph_ms=sdpa_graph_ms,
            sdpa_gathered=sdpa_label,
            max_abs_err=err, tol=tol, max_row_scaled_err=row_err)
        log(f"kernel paged_decode_attention [{case:17s}] {dtype_name} "
            f"route={route} smem={smem} T={T} H={Hq}/{Hkv} "
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
    # head dim 256 (TMA + wgmma in bf16): gemma3-12b's 16 / 8 heads on its
    # sliding-window (1024) and global layers, gemma-7b's 16 / 16, at a
    # short prefill (B 8, T 256) and wave-gemma3's bucket (T 2048)
    "gemma3_swa_256": ("bfloat16", 8, 256, 16, 8, 256, 1024, 0.0),
    "gemma3_global_256": ("bfloat16", 8, 256, 16, 8, 256, 0, 0.0),
    "gemma3_swa_2048": ("bfloat16", 2, 2048, 16, 8, 256, 1024, 0.0),
    "gemma3_global_2048": ("bfloat16", 2, 2048, 16, 8, 256, 0, 0.0),
    "gemma7b_256": ("bfloat16", 8, 256, 16, 16, 256, 0, 0.0),
    "gemma7b_2048": ("bfloat16", 2, 2048, 16, 16, 256, 0, 0.0),
    "fp32_gemma3_swa_2048": ("float32", 1, 2048, 16, 8, 256, 1024, 0.0),
    "fp32_gemma7b_256": ("float32", 2, 256, 16, 16, 256, 0, 0.0),
    # the FLASH_PROMPTS paths' prefills (prompts of 130-256 tokens: bucket
    # 256): whisper-base's decoder self-attention (8 / 8 heads of 64, g 1),
    # jamba-v0.1-52b's attention layer (32 / 8 heads of 128, g 4) and the
    # draft_for draft of every phase 8-9 path (8 / 2 heads of 64)
    "whisper_prefill": ("bfloat16", 8, 256, 8, 8, 64, 0, 0.0),
    "jamba_prefill": ("bfloat16", 8, 256, 32, 8, 128, 0, 0.0),
    "draft_8x2_prefill": ("bfloat16", 8, 256, 8, 2, 64, 0, 0.0),
}


def flash_route(dtype_name: str) -> str:
    """The body the flash launcher must report: TMA + wgmma for bf16 at
    every head dim (32 to 256), attention_tile's CUDA-core body for fp32."""
    return "sm90" if dtype_name == "bfloat16" else "simt"


def flash_kernel_phase(seed: int):
    """The flash prefill kernel through the (B, T, H, D) wrapper the model
    calls, against its plain version, at the serve prefill shapes."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import build
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
        if route != flash_route(dtype_name):
            raise AssertionError(f"flash_attention [{case}]: {dtype_name} ran "
                                 f"the {route} kernel, expected "
                                 f"{flash_route(dtype_name)}")
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
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        if cap == 0.0 and window == 0:
            lib_fn, lib = _library(
                lambda: F.scaled_dot_product_attention(
                    qh, kh, vh, is_causal=True, enable_gqa=True),
                "F.scaled_dot_product_attention(is_causal, enable_gqa), "
                "(B, H, T, D) copies excluded")
        elif cap == 0.0:
            pos = torch.arange(T, device=dev)
            band = ((pos[None, :] <= pos[:, None])
                    & (pos[None, :] > pos[:, None] - window))
            lib_fn, lib = _library(
                lambda: F.scaled_dot_product_attention(
                    qh, kh, vh, attn_mask=band, enable_gqa=True),
                "F.scaled_dot_product_attention(window band mask, "
                "enable_gqa), (B, H, T, D) copies excluded")
        else:
            lib_fn, lib = None, "sdpa has no tanh logit cap"
        lib_ms = cuda_time_ms(lib_fn, warmup=3, iters=20) if lib_fn else None
        graph_ms = graph_time_ms(lambda: ops.flash_attention(q, k, v, **kw))
        lib_graph_ms = graph_time_ms(lib_fn) if lib_fn else None
        # the bf16 body's shared memory at its consumer count
        smem = (build.load(flash_attention.SOURCE).flash_sm90_smem_bytes(
                    D, flash_attention.consumers(T, D))
                if route == "sm90" else None)
        res["cases"][case] = dict(
            dtype=dtype_name, route=route, B=B, T=T, heads=(Hq, Hkv),
            head_dim=D, window=window, cap=cap, kernel_ms=ms,
            kernel_graph_ms=graph_ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, bytes=n_bytes,
            flops=flops, library_ms=lib_ms, library_graph_ms=lib_graph_ms,
            library=lib, max_abs_err=err, tol=FLASH_TOL[dtype_name],
            max_row_scaled_err=row_err, smem_bytes=smem)
        log(f"kernel flash_attention [{case:14s}] {dtype_name} route={route} "
            f"smem={smem} B={B} T={T} heads={Hq}/{Hkv}x{D} w={window} "
            f"cap={cap:g}  "
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
    # head dim 256 (the split-KV body in bf16): wave-gemma3's global layers
    # (16 / 8 heads) at its lengths, gamma 4 and 8 verifies and AR, and
    # gemma-7b's 16 / 16; and a gamma-32 verify of gemma3's heads, 66 rows
    # a KV head, which only the WMMA body takes (no serving path sends it)
    "gemma3_sd_verify": ("bfloat16", 8, 5, 16, 8, 256, 2048, (1100, 1640)),
    "gemma3_ar": ("bfloat16", 8, 1, 16, 8, 256, 2048, (1100, 1640)),
    "gemma3_gamma8_verify": ("bfloat16", 8, 9, 16, 8, 256, 2048,
                             (1100, 1640)),
    "gemma7b_sd_verify": ("bfloat16", 8, 5, 16, 16, 256, 2048, (1100, 1640)),
    "gemma3_wide_verify": ("bfloat16", 8, 33, 16, 8, 256, 2048, (1100, 1640)),
    "fp32_gemma3_sd_verify": ("float32", 8, 5, 16, 8, 256, 2048,
                              (1100, 1640)),
    # the FLASH_PROMPTS paths' extends at FLASH_MAX_SEQ 512, SD verify and
    # AR: whisper-base's decoder self-attention (8 / 8 heads of 64, g 1),
    # jamba-v0.1-52b's attention layer (32 / 8 heads of 128, g 4) and the
    # draft_for draft (8 / 2 heads of 64)
    "whisper_sd_verify": ("bfloat16", 8, 5, 8, 8, 64, 512, (129, 290)),
    "whisper_ar": ("bfloat16", 8, 1, 8, 8, 64, 512, (129, 290)),
    "jamba_sd_verify": ("bfloat16", 8, 5, 32, 8, 128, 512, (129, 290)),
    "jamba_ar": ("bfloat16", 8, 1, 32, 8, 128, 512, (129, 290)),
    "draft_8x2_sd_verify": ("bfloat16", 8, 5, 8, 2, 64, 512, (129, 290)),
    "draft_8x2_ar": ("bfloat16", 8, 1, 8, 2, 64, 512, (129, 290)),
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
        want = ("simt" if dtype_name != "bfloat16" else "sm90"
                if D in (64, 128, 256) and (Hq // Hkv) * T <= 64 else "wmma")
        if route != want:
            raise AssertionError(f"decode_attention [{case}]: ran the {route} "
                                 f"body, expected {want}")
        err = _hold("decode_attention", case, out, ref,
                    DECODE_TOL[dtype_name], res)
        row_err = row_scaled_err(out, ref)
        if dtype_name == "bfloat16" and row_err > DECODE_ROW_TOL:
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


def prefix_fault_reference_phase(seed: int):
    """Reduced target in fp32, one continuous paged stream (pages of 64,
    pool of 4) with prefix sharing (a 128-token, 2-page shared prefix,
    tails of 3-7 tokens, and a follow-up turn that extends an earlier
    prompt, so its boundary page is copied on write), chunked admission
    (chunks of 64, a late 700-token prompt) and the smoke lane's scripted
    injector (faults._smoke_injector: failed admissions at round 1, every
    free page held at rounds 2-4, a NaN row at 6, a slow round at 7).  The
    same tokens and finish reasons from graph replay, eagerly on the card
    and on the CPU; every request that finished cleanly gives the tokens
    of the same stream without the NaN fault; and that stream gives, token
    for token, the tokens of the stream without sharing and chunking."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models.model import Model
    from repro_torch.serving import faults
    from repro_torch.serving.engine import ServingEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("qwen2-57b-a14b", reduced=True)
    dcfg = get_config("qwen2-0.5b", reduced=True)
    models = {}
    p_cpu = Model(cfg, moe_dispatch="gmm", device="cpu").init(
        torch.Generator().manual_seed(seed))
    pd_cpu = Model(dcfg, device="cpu").init(
        torch.Generator().manual_seed(seed + 1))
    for dev in ("cpu", "cuda"):
        models[dev] = (Model(cfg, moe_dispatch="gmm", device=dev),
                       Model(dcfg, device=dev), _to_device(p_cpu, dev),
                       _to_device(pd_cpu, dev))
    rng = np.random.default_rng(seed + 3)
    prefix = rng.integers(3, cfg.vocab_size, 128)
    first = np.concatenate([prefix, rng.integers(3, cfg.vocab_size, 5)])
    spec = [(first, 16, 0),                                   # the leader
            (np.concatenate([prefix, rng.integers(3, cfg.vocab_size, 7)]),
             10, 0),                                          # staggered
            (rng.integers(3, cfg.vocab_size, 9), 4, 0),       # unrelated
            (np.concatenate([first, rng.integers(3, cfg.vocab_size, 4)]),
             8, 3),                                           # follow-up turn
            (np.concatenate([prefix, rng.integers(3, cfg.vocab_size, 3)]),
             8, 3),
            (rng.integers(3, cfg.vocab_size, 700), 8, 3),     # 11 chunks
            (np.concatenate([prefix, rng.integers(3, cfg.vocab_size, 6)]),
             8, 8)]
    script = faults._smoke_injector().faults

    def stream(dev, nan=True, sharing=True, cuda_graphs=None):
        inj = faults.FaultInjector([f for f in script
                                    if nan or f.kind != "nan_row"])
        eng = ServingEngine(*models[dev], scheduler="continuous",
                            kv_layout="paged", page_size=64, max_batch=4,
                            gamma=4, seed=seed, cuda_graphs=cuda_graphs,
                            prefix_sharing=sharing,
                            prefill_chunk=64 if sharing else None,
                            fault_injector=inj,
                            resilience=faults.ResilienceConfig(
                                faulty_rounds_to_ar=64,
                                faulty_rounds_to_stop=128))
        for p, m, arrive in spec:
            eng.submit(p.astype(np.int32), max_new_tokens=m,
                       arrival_round=arrive)
        (rep,) = eng.run()
        eng._slot_scheduler._alloc.assert_no_leaks()
        return {"out": {u: (r.finish_reason, r.output)
                        for u, r in eng.done.items()},
                "counters": dict(eng.fault_counters),
                "injected": dict(inj.injected),
                "chunk_steps": sum(s.chunk_steps for s in rep.steps),
                "steps": [(s.live, s.gamma) for s in rep.steps],
                "stats": eng.session_stats()["model"]}

    reset_launch_counts()
    runs = {"replay": stream("cuda")}
    paged = launch_counts()["paged_decode_attention"]
    runs["eager"] = stream("cuda", cuda_graphs=False)
    runs["cpu"] = stream("cpu")
    runs["clean"] = stream("cuda", nan=False)
    runs["plain"] = stream("cuda", nan=False, sharing=False)
    base = runs["replay"]
    c = base["counters"]
    if not (paged and base["stats"]["replays"]
            and c.get("prefix_hits", 0) >= 2 and c.get("cow_copies", 0) >= 1
            and c.get("numerical_faults", 0) >= 1
            and c.get("admit_retries", 0) >= 1 and base["chunk_steps"] >= 11
            and base["stats"]["growths"]
            and base["injected"]["page_exhaustion"] == 1):
        raise AssertionError(f"prefix/faults reference: the stream missed a "
                             f"path: counters {c}, injected "
                             f"{base['injected']}, chunk steps "
                             f"{base['chunk_steps']}, paged launches {paged}, "
                             f"growths {base['stats']['growths']}")
    for name in ("eager", "cpu"):
        got = runs[name]
        if got["out"].keys() != base["out"].keys() or any(
                got["out"][u][0] != r
                or not np.array_equal(got["out"][u][1], o)
                for u, (r, o) in base["out"].items()) \
                or got["counters"] != c or got["steps"] != base["steps"]:
            raise AssertionError(f"prefix/faults reference: graph replay != "
                                 f"{name} ({got['counters']} vs {c})")
    clean = {u: o for u, (r, o) in base["out"].items() if r == "length"}
    reasons = sorted(r for r, _ in base["out"].values())
    if not clean or "numerical_fault" not in reasons or any(
            runs["clean"]["out"][u][0] != "length"
            or not np.array_equal(runs["clean"]["out"][u][1], o)
            for u, o in clean.items()):
        raise AssertionError(f"prefix/faults reference: rows that finished "
                             f"cleanly beside the NaN row ({sorted(clean)}) "
                             "differ from the stream without the NaN fault "
                             f"(finish reasons {reasons})")
    plain, shared = runs["plain"]["out"], runs["clean"]["out"]
    if plain.keys() != shared.keys() or any(
            plain[u][0] != r or not np.array_equal(plain[u][1], o)
            for u, (r, o) in shared.items()):
        raise AssertionError("prefix/faults reference: the shared, chunked "
                             "stream != the stream without sharing and "
                             "chunking")
    log(f"reference prefix/faults: continuous paged stream ({len(spec)} "
        f"requests, finish reasons {reasons}; counters {c}; injected "
        f"{base['injected']}; {base['chunk_steps']} chunk steps; growths "
        f"{base['stats']['growths']}; prefix traces "
        f"{base['stats']['prefix_traces']}; paged kernel launches {paged}): "
        f"graph replay ({base['stats']['captures']} captures, "
        f"{base['stats']['replays']} replays) == eager card == CPU; the "
        f"{len(clean)} requests that finished cleanly == the stream without "
        "the NaN fault; sharing and chunking == neither, token for token")


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


# ----------------------------------------------------- prefix sharing, faults
SYSTEM_PROMPT = 256                 # shared system-prompt tokens (4 pages)
PREFIX_CHUNK = 128                  # prefill_chunk of the two paths below


def prefix_faults_phase(seed: int, served: dict) -> dict:
    """Two continuous paged paths at full width on the serve phase's target
    and draft, each run twice on one engine (the repeat captures nothing),
    every launch count zeroed just before the path and read after it:

      * continuous-prefix (SD, then AR): the serve phase's continuous
        workload with every prompt behind a 256-token shared system prompt,
        prefix_sharing=True, prefill_chunk 128; its tok/s, prefix and
        copy-on-write counters, chunk steps, captures, replays and graph
        pool, and its greedy tokens beside those of the same stream without
        sharing and chunking on the same engine (bf16: the agreement is
        printed; the reduced fp32 phase requires equality);
      * continuous-faults (SD): the same workload without the shared prompt
        under a seeded injector: failed admissions at round 1, every free
        page held at rounds 2-4, a NaN row at the first round after the
        last admission of the clean stream, then a slow round of 10x the
        clean stream's median round (deadline 5x).  The clean stream (the
        same script without the NaN row and the slow round) runs first;
        the faulted stream must end with one numerical_fault and the rest
        "length", a slow round counted, no leaked page, and every other
        request's tokens equal to the clean stream's.

    Kernel 3 must launch attention layers x (rounds + tail admissions of
    at most PAGED_KERNEL_MAX_T tokens); kernels 1 and 2 MoE layers x target
    forwards; the others never.  Returns the launch counts per path."""
    import gc

    import numpy as np
    import torch
    from repro_torch.models.attention import PAGED_KERNEL_MAX_T
    from repro_torch.serving import faults
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.scheduler import submit_poisson

    cfg = served["cfg"]
    target, draft = served["target"], served["draft"]
    params_t, params_d = served["params_t"], served["params_d"]
    moe_layers, attn_layers = served["moe_layers"], served["attn_layers"]
    pb = served["pb"]
    system = np.random.default_rng(seed + 17).integers(3, cfg.vocab_size,
                                                       SYSTEM_PROMPT)
    prefixed = {"tokens": [np.concatenate([system, pb["tokens"][i][:n]])
                           for i, n in enumerate(pb["lengths"])],
                "lengths": [SYSTEM_PROMPT + int(n) for n in pb["lengths"]]}
    launches = {}

    def engine(kind: str, **kw):
        return ServingEngine(target, draft if kind == "model" else None,
                             params_t, params_d if kind == "model" else None,
                             max_batch=8, gamma=4, temperature=0.0,
                             proposer=kind, seed=seed, scheduler="continuous",
                             kv_layout="paged", page_size=64,
                             prefill_chunk=PREFIX_CHUNK, **kw)

    def reset():
        reset_launch_counts()
        for m in (target, draft):
            m.forward_count = m.prefill_count = 0

    def stream(eng, prompts):
        first = max(eng.done, default=0)
        submit_poisson(eng, prompts["tokens"], prompts["lengths"], rate=0.5,
                       max_new_choices=(8, 16, 32), seed=seed)
        eng.submit(served["long_prompt"], max_new_tokens=16, arrival_round=6)
        (r,) = eng.run()
        eng._slot_scheduler._alloc.assert_no_leaks()
        done = {u - first: eng.done[u] for u in eng.done if u > first}
        if len(done) != 17:
            raise AssertionError(f"{len(done)} of 17 requests finished")
        return done, r

    def check_launches(path: str, rounds: int, tails: int) -> None:
        got = launch_counts()
        expect = {name: 0 for name in got}
        expect["fused_gate_up"] = expect["ragged_gmm"] = \
            moe_layers * target.forward_count
        expect["paged_decode_attention"] = attn_layers * (rounds + tails)
        log(f"{path}: {target.forward_count} target forwards "
            f"({target.prefill_count} prefills), {draft.forward_count} draft "
            f"forwards, {rounds} rounds, {tails} tail admissions of <= "
            f"{PAGED_KERNEL_MAX_T} tokens; launches counted (credited per "
            f"replay) {got}, expected {expect}")
        if got != expect:
            raise AssertionError(f"{path}: launches {got} != {expect}")
        launches[path] = got

    def line(path: str, label: str, r, eng, kind: str, c: dict) -> str:
        g = eng._sessions[kind].graphs
        return (f"{path} ({label}): {r.tokens_per_second:.2f} tok/s rounds="
                f"{r.stats.rounds} tokens={r.tokens_out} wall={r.wall_time:.3f}"
                f" s prefix_hits={c.get('prefix_hits', 0)} "
                f"prefix_shared_tokens={c.get('prefix_shared_tokens', 0)} "
                f"cow_copies={c.get('cow_copies', 0)} chunk_steps="
                f"{sum(s.chunk_steps for s in r.steps)} captures={r.captures} "
                f"replays={r.replays} pool {g.pool_bytes() / 2**20:.1f} MiB")

    card = card_line()
    for kind in ("model", "none"):
        path = f"continuous-prefix/{kind}"
        eng = engine(kind, prefix_sharing=True)
        sess = eng._session(kind)
        tails = []
        admit_rows_prefix = sess.admit_rows_prefix

        def counted(state, tail_toks, *a, **kw):
            tails.append(np.shape(tail_toks)[1])
            return admit_rows_prefix(state, tail_toks, *a, **kw)

        sess.admit_rows_prefix = counted
        reset()
        runs = []
        for label in ("first run", "again"):
            before = dict(eng.fault_counters)
            done, r = stream(eng, prefixed)
            counters = {k: v - before.get(k, 0)
                        for k, v in eng.fault_counters.items()}
            log(line(path, label, r, eng, kind, counters) + f" | {card}")
            reasons = {d.finish_reason for d in done.values()}
            if reasons != {"length"}:
                raise AssertionError(f"{path}: finish reasons {reasons}")
            runs.append((done, r, counters))
        first, again = runs
        if again[1].captures or first[2] != again[2] or \
                not first[2].get("prefix_hits"):
            raise AssertionError(f"{path}: the repeat captured "
                                 f"{again[1].captures} keys, or its counters "
                                 f"{again[2]} != {first[2]}")
        check_launches(path, first[1].stats.rounds + again[1].stats.rounds,
                       sum(1 for t in tails if t <= PAGED_KERNEL_MAX_T))
        # the same stream without sharing and chunking, on the same engine
        eng.prefix_sharing, eng.prefill_chunk = False, None
        plain, _ = stream(eng, prefixed)
        a = np.concatenate([first[0][u].output for u in sorted(first[0])])
        b = np.concatenate([plain[u].output for u in sorted(plain)])
        same = all(np.array_equal(first[0][u].output, again[0][u].output)
                   for u in first[0])
        log(f"{path}: greedy tokens vs the same stream without sharing and "
            f"chunking on one engine geometry: agreement "
            f"{float((a == b).mean()) if a.shape == b.shape else 0.0:.3f} "
            "(bf16; the reduced fp32 phase requires 1); the repeat's tokens "
            f"{'equal' if same else 'differ from'} the first run's; graph "
            f"keys {eng.session_stats()[kind]['keys']}")
        del eng, sess
        gc.collect()
        torch.cuda.empty_cache()

    # continuous-faults: the clean stream, then the faulted one twice
    path = "continuous-faults/model"
    eng = engine("model", resilience=faults.ResilienceConfig(
        faulty_rounds_to_ar=64, faulty_rounds_to_stop=128))
    reset()
    script = [faults.Fault(round=1, kind="admit_fail"),
              faults.Fault(round=2, kind="page_exhaustion", hold_rounds=3)]
    eng.fault_injector = faults.FaultInjector(script)
    clean, r0 = stream(eng, pb)
    rounds = r0.stats.rounds
    log(line(path, "clean", r0, eng, "model", eng.fault_counters)
        + f" | {card}")
    tau = float(np.median([s.round_time for s in r0.steps if s.live]))
    last_admit = max(s.round_index for s in r0.steps if s.admitted)
    fault_round = min(s.round_index for s in r0.steps
                      if s.round_index > last_admit and s.live >= 2)
    eng.resilience = faults.ResilienceConfig(
        round_deadline_s=5 * tau, faulty_rounds_to_ar=64,
        faulty_rounds_to_stop=128)
    faulted = script + [faults.Fault(round=fault_round, kind="nan_row"),
                        faults.Fault(round=fault_round + 1, kind="slow_round",
                                     delay_s=10 * tau)]
    runs = []
    for label in ("faulted", "faulted, again"):
        before = dict(eng.fault_counters)
        eng.fault_injector = faults.FaultInjector(faulted, seed=seed)
        done, r = stream(eng, pb)
        rounds += r.stats.rounds
        counters = {k: v - before.get(k, 0)
                    for k, v in eng.fault_counters.items()}
        log(line(path, label, r, eng, "model", counters) + f" | counters "
            f"{counters}, injected {eng.fault_injector.injected}, finish reasons "
            f"{r.finish_reasons} | {card}")
        reasons = sorted(d.finish_reason for d in done.values())
        ok = {u: d for u, d in done.items() if d.finish_reason == "length"}
        if reasons != ["length"] * 16 + ["numerical_fault"] or \
                not counters.get("slow_rounds") or any(
                    not np.array_equal(d.output, clean[u].output)
                    for u, d in ok.items()):
            raise AssertionError(
                f"{path} ({label}): finish reasons {reasons}, counters "
                f"{counters}, or a co-batched row's tokens differ from the "
                "clean stream's")
        runs.append(r)
    if runs[1].captures:
        raise AssertionError(f"{path}: the repeat captured "
                             f"{runs[1].captures} keys")
    log(f"{path}: NaN row at round {fault_round} (the clean stream's last "
        f"admission at round {last_admit}), slow round {10 * tau * 1e3:.1f} "
        f"ms against a {5 * tau * 1e3:.1f} ms deadline (median round "
        f"{tau * 1e3:.2f} ms); the 16 other requests, the rows co-batched "
        "with the NaN row among them, equal the clean stream's tokens; no "
        "leaked page")
    check_launches(path, rounds, 0)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ----------------------------------------------------- eagle and prefetch
def proposer_reference_phase(seed: int):
    """Reduced fp32 on the card, the EAGLE and prefetch proposers: greedy
    SD from graph replay (a second generation on one session) == the eager
    card session == the CPU == greedy AR, token for token, with the
    prefetch hit, actual and predicted counts equal to the CPU's; and one
    EAGLE continuous paged stream with prefix sharing (pages of 16, a
    20-token shared prefix, gamma 2) and chunked admission (chunks of 16,
    a late 40-token prompt) from graph replay == eager card == CPU,
    request for request."""
    import gc

    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.core.eagle import EagleHead
    from repro_torch.core.proposer import make_proposer
    from repro_torch.core.spec_decode import SDEngine, generate_ar
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import ServingEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("qwen2-57b-a14b", reduced=True)
    dcfg = get_config("qwen2-0.5b", reduced=True)
    pt = Model(cfg, moe_dispatch="gmm", device="cpu").init(
        torch.Generator().manual_seed(seed))
    pd = Model(dcfg, device="cpu").init(torch.Generator().manual_seed(seed + 1))
    ph = EagleHead(Model(cfg, device="cpu")).init(
        torch.Generator().manual_seed(seed + 2))

    def models(dev):
        tm = Model(cfg, moe_dispatch="gmm", device=dev)
        return tm, _to_device(pt, tm.device), {
            "prefetch": (Model(dcfg, device=dev), _to_device(pd, tm.device)),
            "eagle": (EagleHead(tm), _to_device(ph, tm.device))}

    rng = np.random.default_rng(seed)
    toks = rng.integers(3, cfg.vocab_size, (4, 16)).astype(np.int32)
    lengths = np.array([16, 9, 12, 5], np.int32)
    on = {dev: models(dev) for dev in ("cuda", "cpu")}
    pf = lambda st: (st.prefetch_hits, st.prefetch_actual,  # noqa: E731
                     st.prefetch_predicted)
    for kind in ("eagle", "prefetch"):
        runs = {}
        for label, dev, graphs in (("graphs", "cuda", None),
                                   ("eager", "cuda", False),
                                   ("cpu", "cpu", None)):
            tm, p_t, drafts = on[dev]
            draft, p_d = drafts[kind]
            eng = SDEngine(tm, make_proposer(kind, tm, draft), gamma=4,
                           cuda_graphs=graphs)
            runs[label] = eng.generate(p_t, p_d, toks, 24, lengths=lengths)
            if label == "graphs":
                runs["replayed again"] = eng.generate(p_t, p_d, toks, 24,
                                                      lengths=lengths)
                graphs = eng.graphs
                caps, reps = graphs.total_captures, graphs.total_replays
        tm, p_t, _ = on["cuda"]
        ar = generate_ar(tm, p_t, toks, 24, lengths=lengths)
        out, stats = runs["graphs"]
        if caps != 1 or not reps:
            raise AssertionError(f"proposer reference[{kind}]: {caps} "
                                 f"captures, {reps} replays")
        for name, (o, st) in runs.items():
            if not np.array_equal(o, out) or pf(st) != pf(stats):
                raise AssertionError(
                    f"proposer reference[{kind}]: graph replay != {name} "
                    f"(prefetch counts {pf(stats)} vs {pf(st)})")
        if not np.array_equal(out, ar):
            raise AssertionError(f"proposer reference[{kind}]: greedy SD != "
                                 "greedy AR on the card")
        log(f"proposer reference[{kind}]: reduced fp32, greedy SD from graph "
            "replay == replayed again == eager card == CPU == AR (4 rows x "
            f"24 tokens); {caps} capture, {reps} replays"
            + (f"; prefetch hits/actual/predicted {pf(stats)} on every run"
               if kind == "prefetch" else ""))

    def shared_stream(dev, cuda_graphs=None):
        tm, p_t, drafts = on[dev]
        head, p_h = drafts["eagle"]
        eng = ServingEngine(tm, head, p_t, p_h, max_batch=2, gamma=2,
                            force_sd=True, proposer="eagle", seed=seed,
                            scheduler="continuous", kv_layout="paged",
                            page_size=16, prefix_sharing=True,
                            prefill_chunk=16, cuda_graphs=cuda_graphs)
        base = np.arange(3, 23)
        for i, n in enumerate((3, 7, 5)):
            eng.submit(np.concatenate([base, np.arange(30, 34) + 4 * i]),
                       max_new_tokens=n)
        eng.submit(np.arange(3, 43), max_new_tokens=6, arrival_round=2)
        (rep,) = eng.run()
        eng._slot_scheduler._alloc.assert_no_leaks()
        return ({u: (r.finish_reason, r.output) for u, r in eng.done.items()},
                dict(eng.fault_counters),
                sum(s.chunk_steps for s in rep.steps), rep)

    base, counters, chunks, rep = shared_stream("cuda")
    if not counters.get("prefix_hits") or not chunks or not rep.replays:
        raise AssertionError(f"proposer reference: the EAGLE stream shared "
                             f"no prefix, chunked nothing or replayed no "
                             f"round ({counters}, {chunks} chunk steps, "
                             f"{rep.replays} replays)")
    for name, args in (("eager card", ("cuda", False)), ("CPU", ("cpu",))):
        got, c2, _, _ = shared_stream(*args)
        if c2 != counters or got.keys() != base.keys() or any(
                got[u][0] != base[u][0] or not np.array_equal(got[u][1],
                                                              base[u][1])
                for u in base):
            raise AssertionError(f"proposer reference: the EAGLE stream "
                                 f"with prefix sharing and chunks != {name}")
    log(f"proposer reference: reduced fp32 EAGLE continuous paged stream with "
        f"prefix sharing and chunks of 16 ({len(base)} requests, counters "
        f"{counters}, {chunks} chunk steps, {rep.captures} captures, "
        f"{rep.replays} replays): graph replay == eager card == CPU, request "
        "for request")
    # the sessions' graph pools and arenas go now, not under a later
    # phase's timing
    del on, tm, p_t, eng, runs, rep
    gc.collect()
    torch.cuda.empty_cache()


def _path_runs(eng, kind: str, run, path: str, card: str):
    """Run ``run(label)`` twice on ``eng``: the second identical run must
    capture nothing and replays every round under sync debug mode "error"
    up to each readback.  Returns the two results."""
    sess = eng._session(kind)
    first = run("graphs, first run")
    caps = sess.graphs.total_captures
    sess.sync_guard = True
    again = run("graphs, again")
    sess.sync_guard = False
    if sess.graphs.total_captures != caps or caps < 1:
        raise AssertionError(f"{path}: the second run captured "
                             f"{sess.graphs.total_captures - caps} new keys")
    log(f"{path}: second identical run captured nothing; graphs "
        f"{sess.graphs.total_captures} captures in "
        f"{sum(sess.graphs.capture_seconds.values()):.3f} s, "
        f"{sess.graphs.total_replays} replays, pool "
        f"{sess.graphs.pool_bytes() / 2**20:.1f} MiB | {card}")
    return first, again


def _reset_routes() -> None:
    from repro_torch.kernels.decode_attention import paged
    from repro_torch.kernels.gmm import ragged
    for routes in (ragged.LAST_ROUTE, paged.LAST_ROUTE):
        routes.update(dict.fromkeys(routes))


def _check_routes(path: str, names) -> None:
    """Fail unless each named kernel's last launch since ``_reset_routes``
    (eager, or a stage's capture) took the TMA + wgmma route."""
    from repro_torch.kernels.decode_attention import paged
    from repro_torch.kernels.gmm import ragged
    seen = {**ragged.LAST_ROUTE, **paged.LAST_ROUTE}
    got = {name: seen[name] for name in names}
    if set(got.values()) != {"sm90"}:
        raise AssertionError(f"{path}: bf16 routes {got}, expected sm90")
    log(f"{path}: routes {got}")


def _check_head_dim_256_routes(path: str, paged: bool) -> None:
    """Fail unless every launch of kernels 3-5 at head dim 256 since the
    counts were reset (eager, or a stage's capture: a replay runs what was
    captured) ran its D-256 TMA + wgmma body (at most 64 query rows a KV
    head on every path); and the path's prefill kernel and its extend
    kernel (paged if ``paged``, else dense) each ran at D 256."""
    from repro_torch.kernels.decode_attention import ops as dec
    from repro_torch.kernels.decode_attention import paged as pg
    from repro_torch.kernels.flash_attention import flash_attention as fa
    tallies = {"flash_attention": (fa.ROUTE_LAUNCHES, "sm90"),
               "decode_attention": (dec.ROUTE_LAUNCHES, "sm90"),
               "paged_decode_attention": (pg.ROUTE_LAUNCHES, "sm90")}
    must = ("flash_attention",
            "paged_decode_attention" if paged else "decode_attention")
    for name, (tally, want) in tallies.items():
        at256 = {route: n for (route, d), n in tally.items() if d == 256}
        if set(at256) - {want} or (name in must and not at256):
            raise AssertionError(f"{path}: {name} launches at head dim 256 "
                                 f"by route {at256}, expected {want} only")
    log(f"{path}: launches by (route, head dim) " + "; ".join(
        f"{name} {dict(sorted(tally.items()))}"
        for name, (tally, _) in tallies.items()))


def _wave_line(path: str, label: str, r) -> str:
    sd = (f"sigma={r.stats.sigma:.3f} alpha={r.stats.alpha:.3f}"
          if r.used_sd else "AR")
    pf = (f" prefetch hit rate {r.prefetch_hit_rate:.4f} (hits "
          f"{r.prefetch_hits}, actual {r.stats.prefetch_actual}, predicted "
          f"{r.stats.prefetch_predicted})" if r.stats.prefetch_actual else "")
    return (f"{path} ({label}): proposer={r.proposer} B={r.batch}/{r.bucket} "
            f"gamma={r.gamma} {r.tokens_per_second:.2f} tok/s  {sd} "
            f"rounds={r.stats.rounds} wall={r.wall_time:.3f} s{pf} "
            f"captures={r.captures} replays={r.replays}")


def prefetch_phase(seed: int, served: dict) -> dict:
    """wave-prefetch at full width on the serve phase's target and draft:
    the "prefetch" proposer (the "model" drafter and a router probe, top-M
    min(64, 2 x 8) = 16 experts a MoE layer) on the wave workload (16 chat
    prompts, max-batch 8, 32 new tokens, gamma 4, greedy), then AR, each
    run twice on one engine (the repeat captures nothing).  Every prefetch
    round runs staged: propose (and probe), warm, verify, finalize, each
    stage its own graph.  Prints tok/s, the hit rate, predicted = rounds x
    16 x MoE layers (required), captures and replays per stage key, the
    warm stage's device time beside its bound, the warm buffers' bytes,
    and a timed wave's propose/warm/verify/reject split.  Kernels 1 and 2
    must launch MoE layers x target forwards, the others never.  Returns
    the launch counts per path."""
    import gc

    import numpy as np
    import torch
    from repro_torch.core.prefetch import router_probe
    from repro_torch.models.moe import warm_experts
    from repro_torch.serving.engine import ServingEngine

    cfg = served["cfg"]
    target, draft = served["target"], served["draft"]
    params_t, params_d = served["params_t"], served["params_d"]
    moe_layers, pb = served["moe_layers"], served["pb"]
    top_m = min(cfg.num_experts, 2 * cfg.num_experts_per_tok)
    card = card_line()
    launches, outputs = {}, {}

    def engine(kind: str, timed: bool = False):
        return ServingEngine(target, draft if kind != "none" else None,
                             params_t, params_d if kind != "none" else None,
                             max_batch=8, gamma=4, temperature=0.0,
                             proposer=kind, seed=seed, timed=timed)

    def wave(eng, path: str, n: int, label: str):
        first = max(eng.done, default=0)
        for i in range(n):
            eng.submit(pb["tokens"][i][: int(pb["lengths"][i])],
                       max_new_tokens=32)
        reports = eng.run()
        for r in reports:
            log(_wave_line(path, label, r) + (
                f" propose={r.propose_time:.4f} s warm={r.warm_time:.4f} s "
                f"verify={r.verify_time:.4f} s reject={r.reject_time:.4f} s"
                if eng.timed else ""))
        out = np.stack([eng.done[u].output for u in sorted(eng.done)
                        if u > first])
        if out.shape != (n, 32):
            raise AssertionError(f"{path}: bad outputs {out.shape}")
        return out, reports

    for kind in ("prefetch", "none"):
        path = f"wave-prefetch/{kind}"
        eng = engine(kind)
        reset_launch_counts()
        _reset_routes()
        for m in (target, draft):
            m.forward_count = m.prefill_count = 0
        (out, reps), (_, reps2) = _path_runs(
            eng, kind, lambda label: wave(eng, path, 16, label), path, card)
        rounds = sum(r.stats.rounds for r in reps + reps2)
        _check_routes(path, ("fused_gate_up", "ragged_gmm"))
        got = launch_counts()
        expect = {name: 0 for name in got}
        expect["fused_gate_up"] = expect["ragged_gmm"] = \
            moe_layers * target.forward_count
        log(f"{path}: {target.forward_count} target forwards, "
            f"{draft.forward_count} draft forwards, {rounds} rounds; launches "
            f"counted (credited per replay) {got}, expected {expect}")
        if got != expect:
            raise AssertionError(f"{path}: launches {got} != {expect}")
        launches[path] = got
        outputs[kind] = out
        sess = eng._sessions[kind]
        if kind == "prefetch":
            stats = [r.stats for r in reps + reps2]
            predicted = sum(s.prefetch_predicted for s in stats)
            hits = sum(s.prefetch_hits for s in stats)
            actual = sum(s.prefetch_actual for s in stats)
            if predicted != rounds * top_m * moe_layers or not actual:
                raise AssertionError(
                    f"{path}: predicted {predicted} != rounds {rounds} x "
                    f"{top_m} x {moe_layers}, or no expert counted")
            log(f"{path}: hit rate {hits / actual:.4f} ({hits} of {actual} "
                f"activated experts warm), predicted {predicted} = {rounds} "
                f"rounds x {top_m} x {moe_layers} MoE layers; session totals "
                f"{eng.session_stats()[kind]['prefetch']} | {card}")
            for key, n in sorted(sess.graphs.captures.items(),
                                 key=lambda kv: str(kv[0])):
                stages = len(sess.graphs._captured[key].graphs)
                log(f"{path}: key (stage {key[0]!r}, gamma {key[1]}, batch "
                    f"{key[2]}, max_seq {key[3]}): {n} capture of {stages} "
                    f"stage graphs, {sess.graphs.replays[key]} replays")
            # the warm stage alone at this run's plan shape, into the
            # session's own buffers
            stream = torch.as_tensor(np.stack([pb["tokens"][i][:5]
                                               for i in range(8)]),
                                     device="cuda")
            plan = router_probe(params_t, cfg, stream, top_m=top_m)
            n_bytes = sess.warm_bytes()

            def warm():
                warm_experts(params_t["layers"], cfg, plan, out=sess._warm)

            layers = [l for l in range(cfg.num_layers)
                      if cfg.moe_pattern[l % cfg.period]]

            def per_element():
                # the same gather over bf16 elements of the (E, d, f)
                # tensors, which warm_experts replaces by 8-byte words
                for l, buf in zip(layers, sess._warm):
                    for k in ("w_gate", "w_up", "w_down"):
                        torch.index_select(params_t["layers"][l]["ffn"][k], 0,
                                           plan.expert_ids[l], out=buf[k])

            ms_eager = cuda_time_ms(warm)
            ms = graph_time_ms(warm, calls=4)
            ms_elem = graph_time_ms(per_element, calls=4)
            bound, by = bound_ms(2 * n_bytes, 0.0)
            log(f"{path}: warm stage (index_select of {top_m} experts x 3 "
                f"matrices x {moe_layers} layers into fixed buffers, "
                f"{n_bytes / 1e9:.3f} GB): {ms_eager:.4f} ms eager, "
                f"{_fmt(ms)} device-only, bound {bound:.4f} ms "
                f"({by}: read + write at {HBM_BYTES_PER_S / 1e12:.2f} TB/s); "
                f"the same gather over bf16 elements {_fmt(ms_elem)} "
                f"device-only | {card}")
            del eng, sess
            gc.collect()
            torch.cuda.empty_cache()
            # the timed round: four stage graphs with a sync between
            eng = engine(kind, timed=True)
            wave(eng, path, 8, "timed round, warm")
            wave(eng, path, 8, "timed round")
        else:
            del sess
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    a, b = outputs["prefetch"], served["outputs"]["wave/model"]
    log(f"wave-prefetch: greedy tokens vs the serve phase's wave/model run "
        f"{float((a == b).mean()):.3f} (bf16; the reduced fp32 phase requires "
        f"equality); vs AR {float((a == outputs['none']).mean()):.3f}")
    return launches



def eagle_phase(seed: int) -> dict:
    """The EAGLE proposer at full width: mixtral-8x7b at its published
    width (d 4096, 8 experts top-2, moe_d_ff 14336, 32/8 heads of 128),
    depth cut to LAYERS of 32 (the bf16 weights of all 32 layers, ~93 GB,
    do not fit in 80 GB), with its full-width EagleHead (8/2 heads of 64,
    d_ff 16384), random weights from --seed, greedy, gamma 4, max-batch 8:
      * wave-eagle (SD with the "eagle" proposer, then AR): the wave
        workload of the serve phase (16 chat prompts, 32 new tokens);
      * continuous-eagle (SD, then AR): the continuous paged workload
        (Poisson arrivals at 0.5 a round, max_new 8/16/32, a 700-token
        prompt at round 6, pool of 8, pages of 64): admissions through
        prefill_with_hidden, the feature carry's scatter and growth, and
        kernel 3 every round.
    Each path runs twice on one engine (the repeat captures nothing) with
    every count zeroed before it: kernels 1 and 2 must launch MoE layers x
    target forwards, kernel 3 attention layers x rounds on the continuous
    paths, the others never (the head's attention and FFN are plain
    torch), and each of those kernels must take its TMA + wgmma route.
    Returns the launch counts per path."""
    import gc

    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.core.eagle import EagleHead
    from repro_torch.data.pipeline import prompt_batch
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.scheduler import submit_poisson

    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(EAGLE_ARCH).with_overrides(num_layers=LAYERS)
    t0 = time.perf_counter()
    target = Model(cfg, moe_dispatch="gmm", device="cuda")
    gen = torch.Generator(device=target.device)
    params_t = target.init(gen.manual_seed(seed))
    head = EagleHead(target)
    params_h = head.init(gen.manual_seed(seed + 1))
    torch.cuda.synchronize()
    n_t = sum(t.numel() for t in _leaves(params_t))
    n_h = sum(t.numel() for t in _leaves(params_h))
    card = card_line()
    log(f"eagle: target {cfg.name} x{LAYERS} of 32 layers ({n_t / 1e9:.3f} B "
        f"parameters, {2 * n_t / 1e9:.2f} GB of {cfg.dtype}), EagleHead "
        f"{head.cfg.num_heads}/{head.cfg.num_kv_heads} heads of "
        f"{head.cfg.head_dim}, d_ff {head.cfg.d_ff} ({n_h / 1e9:.3f} B "
        f"parameters), init {time.perf_counter() - t0:.1f} s; card memory "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated | {card}")
    pb = prompt_batch(cfg.vocab_size, 16, kind="chat", seed=seed)
    long_prompt = np.random.default_rng(seed).integers(3, cfg.vocab_size, 700)
    moe_layers = sum(cfg.moe_pattern[l % cfg.period] for l in range(LAYERS))
    attn_layers = LAYERS
    launches, outputs = {}, {}

    def engine(kind: str, **kw):
        return ServingEngine(target, head if kind == "eagle" else None,
                             params_t, params_h if kind == "eagle" else None,
                             max_batch=8, gamma=4, temperature=0.0,
                             proposer=kind, seed=seed, **kw)

    def wave(eng, path, label):
        first = max(eng.done, default=0)
        for i in range(16):
            eng.submit(pb["tokens"][i][: int(pb["lengths"][i])],
                       max_new_tokens=32)
        reports = eng.run()
        for r in reports:
            log(_wave_line(path, label, r))
        out = np.stack([eng.done[u].output for u in sorted(eng.done)
                        if u > first])
        if out.shape != (16, 32) or out.min() < 0 or \
                out.max() >= cfg.vocab_size:
            raise AssertionError(f"{path}: bad outputs {out.shape}")
        return out, sum(r.stats.rounds for r in reports)

    def continuous(eng, path, kind, label):
        first = max(eng.done, default=0)
        submit_poisson(eng, pb["tokens"], pb["lengths"], rate=0.5,
                       max_new_choices=(8, 16, 32), seed=seed)
        eng.submit(long_prompt, max_new_tokens=16, arrival_round=6)
        (r,) = eng.run()
        stats = eng.session_stats()[kind]
        log(_wave_line(path, label, r) + f" tokens={r.tokens_out} "
            f"admitted={sum(s.admitted for s in r.steps)} growths "
            f"{stats['growths']}")
        done = {u - first: eng.done[u] for u in eng.done if u > first}
        reasons = {d.finish_reason for d in done.values()}
        if len(done) != 17 or reasons != {"length"} or not stats["growths"]:
            raise AssertionError(f"{path}: {len(done)} requests finished "
                                 f"{reasons}, growths {stats['growths']}")
        eng._slot_scheduler._alloc.assert_no_leaks()
        return ({u: d.output for u, d in done.items()}, r.stats.rounds)

    for path in ("wave-eagle/eagle", "wave-eagle/none",
                 "continuous-eagle/eagle", "continuous-eagle/none"):
        sched, kind = path.split("/")
        if sched == "continuous-eagle":
            eng = engine(kind, scheduler="continuous", kv_layout="paged",
                         page_size=64)
            run = lambda label: continuous(eng, path, kind,  # noqa: E731
                                           label)
        else:
            eng = engine(kind)
            run = lambda label: wave(eng, path, label)       # noqa: E731
        reset_launch_counts()
        _reset_routes()
        target.forward_count = target.prefill_count = 0
        (out, rounds), (_, rounds2) = _path_runs(eng, kind, run, path, card)
        rounds += rounds2
        _check_routes(path, ("fused_gate_up", "ragged_gmm")
                      + (("paged_decode_attention",)
                         if sched == "continuous-eagle" else ()))
        got = launch_counts()
        expect = {name: 0 for name in got}
        expect["fused_gate_up"] = expect["ragged_gmm"] = \
            moe_layers * target.forward_count
        if sched == "continuous-eagle":
            expect["paged_decode_attention"] = attn_layers * rounds
        log(f"{path}: {target.forward_count} target forwards "
            f"({target.prefill_count} prefills), {rounds} rounds; launches "
            f"of kernels 1 and 2 {got['fused_gate_up']}, {got['ragged_gmm']};"
            f" all counted (credited per replay) {got}, expected {expect}")
        if got != expect:
            raise AssertionError(f"{path}: launches {got} != {expect}")
        launches[path] = got
        outputs[path] = out
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    for sched in ("wave-eagle", "continuous-eagle"):
        a, b = outputs[f"{sched}/eagle"], outputs[f"{sched}/none"]
        if sched == "continuous-eagle":
            a, b = (np.concatenate([a[u] for u in sorted(a)]),
                    np.concatenate([b[u] for u in sorted(b)]))
        log(f"{sched}: SD vs AR token agreement "
            f"{float((a == b).mean()) if a.shape == b.shape else 0.0:.3f} "
            "(bf16: not required to be exact)")
    log(f"eagle: torch.cuda.max_memory_allocated() = "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del target, head, params_t, params_h
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# -------------- the assigned archs beyond phase 4's (phases 8 and 9)
# attention-only (phase 8), then recurrent and encoder-decoder (phase 9)
NEW_ARCHS = ("dbrx-132b", "gemma-7b", "gemma3-12b", "minicpm3-4b",
             "qwen2-vl-2b", "jamba-v0.1-52b", "xlstm-1.3b", "whisper-base")
# the archs whose reduced config also serves a continuous paged stream, and
# the prefill chunks it is served with (None: whole prompts)
PAGED_STREAMS = {"gemma3-12b": (None,), "minicpm3-4b": (None,),
                 "jamba-v0.1-52b": (None, 8)}


def _frames(cfg, B: int, seed: int, dev):
    """Stub encoder frames (B, encoder_seq_len, d) from ``seed``, in the
    model's dtype (whisper's frontend is a stub in both packages)."""
    import numpy as np
    import torch
    a = 0.5 * np.random.default_rng(seed).standard_normal(
        (B, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
    return torch.from_numpy(a).to(dev)


def arch_reference_phase(seed: int):
    """Phases 8a and 9a: the NEW_ARCHS reduced, in fp32 (TF32 off), each
    with its ``draft_for`` draft.  A ragged prefill (lengths 40, 23, 31), a
    verify extend with collected states, a commit of (5, 2, 0) tokens (an
    inactive row takes the last collected step) and the next decode step,
    card against CPU logits (1e-3); then greedy waves (4 prompts of 5-40
    tokens, past gemma3-reduced's window of 16; max-batch 2, 8 new tokens,
    gamma 4): SD from graph replay == SD eager on the card == SD on the CPU
    == AR on the card, token for token, through ServingEngine, and for
    whisper-base (ServingEngine refuses an encoder-decoder) through
    SDEngine.generate with stub frames in prefill_kwargs.  The archs of
    PAGED_STREAMS also serve a continuous paged stream (5 requests, 2
    slots, pages of 8) with the same four-way equality, once per prefill
    chunk listed: gemma3-12b (rings dense inside a paged cache; a row
    reused after a 40-token request, longer than its window), minicpm3-4b
    (latent pages), jamba-v0.1-52b (dense recurrent rows, without and with
    chunked admission)."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import draft_for, get_config
    from repro_torch.core.proposer import make_proposer
    from repro_torch.core.spec_decode import SDEngine
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import ServingEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(seed)
    for arch in NEW_ARCHS:
        t0 = time.perf_counter()
        cfg = get_config(arch, reduced=True)
        dcfg = draft_for(cfg)
        disp = "gmm" if cfg.num_experts else "onehot"
        m = {d: (Model(cfg, moe_dispatch=disp, device=d), Model(dcfg, device=d))
             for d in ("cpu", "cuda")}
        p_cpu = (m["cpu"][0].init(torch.Generator().manual_seed(seed)),
                 m["cpu"][1].init(torch.Generator().manual_seed(seed + 1)))
        p = {"cpu": p_cpu,
             "cuda": tuple(_to_device(x, torch.device("cuda")) for x in p_cpu)}
        enc = cfg.is_encoder_decoder
        toks = rng.integers(3, cfg.vocab_size, (3, 40)).astype(np.int32)
        lengths = np.array([40, 23, 31], np.int32)
        ver = rng.integers(3, cfg.vocab_size, (3, 5)).astype(np.int32)
        outs = []
        for d in ("cpu", "cuda"):
            t, pt = m[d][0], p[d][0]
            kw = {"encoder_embeds": _frames(cfg, 3, seed, d)} if enc else {}
            last, cache = t.prefill(pt, toks, t.init_cache(3, 64),
                                    lengths=lengths, **kw)
            logits, pend = t.extend(pt, ver, cache, collect=True)
            cache = t.commit(pend, torch.tensor([5, 2, 0], device=d),
                             collected=True)
            nxt, _ = t.decode_step(pt, ver[:, 0], cache)
            outs.append((last.cpu(), logits.cpu(), nxt.cpu()))
        err = max((a - b).abs().max().item() for a, b in zip(*outs))
        if not err <= 1e-3:
            raise AssertionError(f"arch-reference[{arch}]: CUDA path vs CPU "
                                 f"path max err {err:.3g}")
        prompts = [rng.integers(3, cfg.vocab_size, n) for n in (40, 5, 17, 28)]
        streams = [("wave", {})] + [
            (f"continuous-paged chunk={chunk}", dict(
                scheduler="continuous", kv_layout="paged", page_size=8,
                prefill_chunk=chunk))
            for chunk in PAGED_STREAMS.get(arch, ())]
        for sched, kw in streams:
            runs = {}
            for label, dev, proposer, graphs in (
                    ("SD replay", "cuda", "model", None),
                    ("SD eager", "cuda", "model", False),
                    ("SD cpu", "cpu", "model", None),
                    ("AR replay", "cuda", "none", None)):
                (t, dm), (pt, pd) = m[dev], p[dev]
                sd = proposer == "model"
                if enc:
                    eng = SDEngine(t, make_proposer(proposer, t,
                                                    dm if sd else None),
                                   gamma=4 if sd else 0, cuda_graphs=graphs)
                    bucket = np.zeros((4, 40), np.int32)
                    for i, q in enumerate(prompts):
                        bucket[i, :len(q)] = q
                    out, _ = eng.generate(
                        pt, pd if sd else None, bucket, 8,
                        lengths=np.array([len(q) for q in prompts]),
                        prefill_kwargs={"encoder_embeds": _frames(
                            cfg, 4, seed + 1, dev)})
                    runs[label] = list(out)
                    replays = eng.graphs.total_replays
                else:
                    extra = {} if graphs is None else {"cuda_graphs": graphs}
                    eng = ServingEngine(
                        t, dm if sd else None, pt, pd if sd else None,
                        max_batch=2, gamma=4, proposer=proposer,
                        force_sd=True, seed=seed, **kw, **extra)
                    uids = [eng.submit(q, max_new_tokens=8) for q in
                            (prompts + [prompts[0][:12]] if kw else prompts)]
                    reports = eng.run()
                    runs[label] = [np.asarray(eng.done[u].output)
                                   for u in uids]
                    replays = sum(r.replays for r in reports)
                if label == "SD replay" and not replays:
                    raise AssertionError(f"arch-reference[{arch}] {sched}: "
                                         "no round was replayed")
            base = runs["SD replay"]
            for label, out in runs.items():
                if len(out) != len(base) or not all(
                        np.array_equal(a, b) for a, b in zip(out, base)):
                    raise AssertionError(f"arch-reference[{arch}] {sched}: "
                                         f"{label} != SD replay")
            log(f"arch-reference[{arch}] {sched}: logits card vs CPU max err "
                f"{err:.3g}; SD replay == SD eager == SD CPU == AR over "
                f"{len(base)} requests ({sum(len(o) for o in base)} tokens) "
                f"in {time.perf_counter() - t0:.1f} s")
        del m, p, p_cpu
    torch.cuda.empty_cache()


def recurrent_draft_phase(seed: int):
    """Phase 9a's last check, the pair of the reference's
    test_recurrent_draft_lossless: a 2-layer mLSTM/sLSTM draft over a
    4-layer dense target, fp32, gamma 3, 16 new tokens: SD from graph
    replay == SD on the CPU == AR, token for token."""
    import numpy as np
    import torch
    from repro_torch.configs.base import ModelConfig
    from repro_torch.core.proposer import make_proposer
    from repro_torch.core.spec_decode import SDEngine, SpecDecoder
    from repro_torch.models.model import Model

    torch.backends.cuda.matmul.allow_tf32 = False
    tcfg = ModelConfig("t-dense", "dense", 4, 128, 4, 2, 256, 512,
                       dtype="float32")
    rcfg = ModelConfig("t-rnn-draft", "ssm", 2, 64, 2, 2, 0, 512,
                       layer_pattern=("mlstm", "slstm"), rope_type="none",
                       dtype="float32")
    prompts = np.random.default_rng(seed).integers(0, 512, (2, 8)).astype(
        np.int32)
    p_cpu = (Model(tcfg, device="cpu").init(torch.Generator().manual_seed(seed)),
             Model(rcfg, device="cpu").init(
                 torch.Generator().manual_seed(seed + 9)))
    outs = {}
    for d in ("cpu", "cuda"):
        t, dm = Model(tcfg, device=d), Model(rcfg, device=d)
        pt, pd = (_to_device(x, torch.device(d)) for x in p_cpu)
        sdec = SpecDecoder(t, dm, gamma=3)
        outs[d], stats = sdec.generate(pt, pd, prompts, 16)
        if d == "cuda":
            ar = SDEngine(t, make_proposer("none", t), gamma=0).generate(
                pt, None, prompts, 16)[0]
            if not sdec.graphs.total_replays:
                raise AssertionError("recurrent-draft: no round replayed")
    if not (np.array_equal(outs["cuda"], outs["cpu"])
            and np.array_equal(outs["cuda"], ar)):
        raise AssertionError("recurrent-draft: SD replay, SD CPU and AR "
                             "disagree")
    log(f"recurrent-draft (2-layer mLSTM/sLSTM draft over a dense target): "
        f"SD replay == SD CPU == AR over {outs['cuda'].size} tokens, "
        f"alpha {stats.alpha:.3f}")
    torch.cuda.empty_cache()


# jamba-v0.1-52b at full width is ~99 GB of bf16 weights; one period of 8
# layers (7 Mamba + 1 attention, 4 MoE FFNs) holds every kind it has
JAMBA_LAYERS = 8
# path label, arch, layers served (None: all), use_flash, workload
ARCH_PATHS = (
    ("wave-gemma3", "gemma3-12b", None, True, "long"),
    ("continuous-gemma3", "gemma3-12b", None, True, "long"),
    ("wave-dbrx", "dbrx-132b", LAYERS, False, "chat"),
    ("wave-gemma7b", "gemma-7b", None, True, "long"),
    ("wave-minicpm3", "minicpm3-4b", None, False, "chat"),
    ("wave-qwen2vl", "qwen2-vl-2b", None, False, "chat"),
    ("wave-jamba", "jamba-v0.1-52b", JAMBA_LAYERS, True, "flash"),
    ("continuous-jamba", "jamba-v0.1-52b", JAMBA_LAYERS, False, "chat"),
    ("wave-xlstm", "xlstm-1.3b", None, True, "flash"),
    ("wave-whisper", "whisper-base", None, True, "flash"),
)
LONG_PROMPTS = (1100, 1600)          # the "long" paths: past the 1024 window
# the "flash" paths: bucket 256, so every prefill takes kernel 5; the
# capacity is FLASH_MAX_SEQ, the power of two ServingEngine gives that
# bucket (>= 256 + 32 new tokens + gamma + 2), so every extend takes kernel
# 4 (S >= 512)
FLASH_PROMPTS = (129, 256)
FLASH_MAX_SEQ = 512


def arch_serve_phase(seed: int, paths=None) -> dict:
    """Phases 8b and 9b: the ARCH_PATHS at their published widths, random
    bf16 weights from --seed, each with its ``draft_for`` draft, greedy,
    gamma 4, max-batch 8, every round from CUDA graphs; each path SD
    ("model") then AR ("none"), with every count zeroed before it:
      * wave-gemma3: gemma3-12b, all 48 layers, use_flash on target and
        draft, 16 prompts of LONG_PROMPTS tokens (bucket 2048, so the
        window of 1024 masks), 32 new tokens: every prefill runs kernel 5
        on all 48 + 4 layers (TMA + wgmma at D 256 on the target), every
        extend kernel 4 on the 8 global layers and the draft's 4;
      * continuous-gemma3: the same model, paged (pages of 64), the same
        prompts with Poisson arrivals (0.5 a round, 8/16/32 new tokens):
        kernel 3 at D 256 on the global layers every round, rings dense;
      * wave-dbrx: dbrx-132b cut to LAYERS of 40 layers, gmm dispatch, 16
        chat prompts, 32 new tokens: kernels 1 and 2 in every forward;
      * wave-gemma7b: gemma-7b at full depth (28 layers, 16 / 16 heads of
        256), use_flash, the prompts of wave-gemma3 (bucket 2048): kernel
        5 at D 256 on every prefill, kernel 4 at D 256 on every extend;
      * wave-minicpm3, wave-qwen2vl: minicpm3-4b and qwen2-vl-2b at full
        depth, the wave workload of wave-dbrx;
      * wave-jamba: jamba-v0.1-52b cut to JAMBA_LAYERS of 32 layers (one
        whole period: 7 Mamba, 1 attention of 32 / 8 heads of 128, 4 MoE
        FFNs of 16 experts top-2), use_flash, 16 prompts of FLASH_PROMPTS
        tokens, 32 new tokens: kernels 1 and 2 on the MoE layers of every
        target forward, kernel 5 on every prefill's attention layers,
        kernel 4 on every extend's;
      * continuous-jamba: the same model paged (pages of 64), the chat
        workload of continuous-gemma3: kernels 1 and 2, kernel 3 on the
        attention layer every round;
      * wave-xlstm: xlstm-1.3b, all 48 layers (42 mLSTM, 6 sLSTM; no
        kernel runs in the target), use_flash, the prompts of wave-jamba:
        its draft runs kernels 4 and 5;
      * wave-whisper: whisper-base, 6 + 6 layers, stub frames of 1500
        (the encoder is plain attention, as in the reference), use_flash,
        the prompts of wave-jamba in two batches of 8 on one engine,
        through SDEngine.generate at FLASH_MAX_SEQ (ServingEngine refuses
        an encoder-decoder): kernels 5 and 4 on the decoder's 8 / 8 heads
        of 64.
    On the use_flash paths at head dim 256 every launch of kernels 3-5
    must have run its D-256 body (_check_head_dim_256_routes).  Each path
    prints a digest of its greedy tokens (serve_ab.py --arch compares two
    trees' digests).  ``paths`` names the ARCH_PATHS to run (default all).
    Returns the launch counts per path."""
    import gc
    import hashlib

    import numpy as np
    import torch
    from repro_torch.configs.registry import draft_for, get_config
    from repro_torch.core.proposer import make_proposer
    from repro_torch.core.spec_decode import SDEngine
    from repro_torch.data.pipeline import prompt_batch
    from repro_torch.models.model import Model
    from repro_torch.models.transformer import layer_kinds
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.scheduler import submit_poisson

    card = card_line()
    launches, loaded = {}, None
    for path_name, arch, layers, flash, workload in ARCH_PATHS:
        if paths is not None and path_name not in paths:
            continue
        full = get_config(arch)
        cfg = full if layers is None else full.with_overrides(num_layers=layers)
        dcfg = draft_for(full)
        if loaded is None or loaded[0] != (arch, layers):
            # free the previous model before the next one is made
            loaded = target = draft = params_t = params_d = None
            gc.collect()
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            disp = "gmm" if cfg.num_experts else "onehot"
            target = Model(cfg, moe_dispatch=disp, device="cuda")
            draft = Model(dcfg, device="cuda")
            gen = torch.Generator(device=target.device)
            params_t = target.init(gen.manual_seed(seed))
            params_d = draft.init(gen.manual_seed(seed + 1))
            torch.cuda.synchronize()
            n_t = sum(t.numel() for t in _leaves(params_t))
            log(f"arch-serve: {arch} x{cfg.num_layers} of {full.num_layers} "
                f"layers ({n_t / 1e9:.3f} B parameters, {2 * n_t / 1e9:.2f} "
                f"GB bf16), draft {dcfg.name} d {dcfg.d_model} x"
                f"{dcfg.num_layers}, init {time.perf_counter() - t0:.1f} s; "
                f"card memory {torch.cuda.memory_allocated() / 1e9:.2f} GB "
                f"| {card}")
            loaded = ((arch, layers), target, draft, params_t, params_d)
        _, target, draft, params_t, params_d = loaded
        target.use_flash = draft.use_flash = flash
        if workload == "chat":
            pb = prompt_batch(cfg.vocab_size, 16, kind="chat", seed=seed)
            prompts = [pb["tokens"][i][: int(pb["lengths"][i])]
                       for i in range(16)]
        else:
            prng = np.random.default_rng(
                seed + (11 if workload == "long" else 13))
            span = LONG_PROMPTS if workload == "long" else FLASH_PROMPTS
            prompts = [prng.integers(3, cfg.vocab_size,
                                     int(prng.integers(*span) + 1))
                       for _ in range(16)]
        kinds = layer_kinds(cfg)
        # the layers kernel 5 runs on at a prefill (rings too: it takes the
        # window), and those the dense decode and paged kernels run on:
        # full attention ("swa" rings attend by mask)
        flash_layers = sum(k in ("attn", "swa") for k, _ in kinds)
        attn_global = sum(k == "attn" for k, _ in kinds)
        moe_layers = sum(is_moe for _, is_moe in kinds)
        paged = path_name.startswith("continuous")
        outputs = {}
        for kind in ("model", "none"):
            path = f"{path_name}/{kind}"
            sd = kind == "model"
            reset_launch_counts()
            _reset_routes()
            for m in (target, draft):
                m.forward_count = m.prefill_count = 0
            t_path = time.perf_counter()
            if cfg.is_encoder_decoder:
                eng = SDEngine(target, make_proposer(
                    kind, target, draft if sd else None),
                    gamma=4 if sd else 0)
                done, rounds = [], 0
                for b0 in (0, 8):
                    batch = prompts[b0:b0 + 8]
                    toks = np.zeros((8, FLASH_PROMPTS[1]), np.int32)
                    for i, q in enumerate(batch):
                        toks[i, :len(q)] = q
                    out, st = eng.generate(
                        params_t, params_d if sd else None, toks, 32,
                        lengths=np.array([len(q) for q in batch]),
                        max_seq=FLASH_MAX_SEQ,
                        prefill_kwargs={"encoder_embeds": _frames(
                            cfg, 8, seed + b0, "cuda")})
                    done += [np.asarray(o) for o in out]
                    rounds += st.rounds
                torch.cuda.synchronize()
                wall = time.perf_counter() - t_path
                toks_out = sum(o.size for o in done)
                graphs = eng.graphs
            else:
                extra = (dict(scheduler="continuous", kv_layout="paged",
                              page_size=64) if paged else {})
                eng = ServingEngine(target, draft if sd else None, params_t,
                                    params_d if sd else None, max_batch=8,
                                    gamma=4, temperature=0.0, proposer=kind,
                                    seed=seed, **extra)
                if paged:
                    lens = np.array([len(q) for q in prompts])
                    toks = np.zeros((16, lens.max()), np.int32)
                    for i, q in enumerate(prompts):
                        toks[i, :len(q)] = q
                    submit_poisson(eng, toks, lens, rate=0.5,
                                   max_new_choices=(8, 16, 32), seed=seed)
                else:
                    for q in prompts:
                        eng.submit(q, max_new_tokens=32)
                reports = eng.run()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t_path
                rounds = sum(r.stats.rounds for r in reports)
                for r in reports:
                    log(_wave_line(path, "graphs", r)
                        + (f" tokens={r.tokens_out}" if paged else ""))
                fin = [eng.done[u] for u in sorted(eng.done)]
                if len(fin) != 16 or {f.finish_reason for f in fin} != {
                        "length"}:
                    raise AssertionError(
                        f"{path}: {len(fin)} requests finished "
                        f"{ {f.finish_reason for f in fin} }")
                if paged:
                    eng._slot_scheduler._alloc.assert_no_leaks()
                done = [np.asarray(f.output) for f in fin]
                toks_out = sum(r.tokens_out for r in reports)
                graphs = eng._session(kind).graphs
            for o in done:
                if o.min() < 0 or o.max() >= cfg.vocab_size:
                    raise AssertionError(f"{path}: token out of the vocab")
            per_req = [hashlib.sha256(o.astype(np.int64).tobytes()
                                      ).hexdigest()[:8] for o in done]
            digest = hashlib.sha256(" ".join(per_req).encode()
                                    ).hexdigest()[:16]
            log(f"{path}: tokens digest {digest} (requests "
                f"{' '.join(per_req)})")
            got = launch_counts()
            expect = {name: 0 for name in got}
            if moe_layers:
                expect["fused_gate_up"] = expect["ragged_gmm"] = \
                    moe_layers * target.forward_count
            used = [(target, flash_layers, attn_global)]
            if sd:
                used.append((draft, dcfg.num_layers, dcfg.num_layers))
            if flash and not paged:
                expect["flash_attention"] = sum(
                    n * m.prefill_count for m, n, _ in used)
                expect["decode_attention"] = sum(
                    g * (m.forward_count - m.prefill_count)
                    for m, _, g in used)
            if paged:
                expect["paged_decode_attention"] = attn_global * rounds
            if paged and flash:
                # fillers and short prompts prefill below 128 tokens (no
                # flash); every admission prefills target and draft alike
                per = sum(n for _, n, _ in used)
                n_flash = got["flash_attention"]
                if n_flash < per or n_flash % per:
                    raise AssertionError(f"{path}: {n_flash} flash launches, "
                                         f"not a positive multiple of {per}")
                expect["flash_attention"] = n_flash
                if sd:
                    expect["decode_attention"] = dcfg.num_layers * (
                        draft.forward_count - draft.prefill_count)
            log(f"{path}: {toks_out} tokens in {wall:.2f} s "
                f"({toks_out / wall:.2f} tok/s end to end, max-batch 8, "
                f"captures {graphs.total_captures}, replays "
                f"{graphs.total_replays}, graph pool "
                f"{graphs.pool_bytes() / 2**30:.2f} GiB, peak memory "
                f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB); "
                f"{target.forward_count} target forwards "
                f"({target.prefill_count} prefills), {draft.forward_count} "
                f"draft forwards, {rounds} rounds; launches {got}, expected "
                f"{expect} | {card}")
            if got != expect:
                raise AssertionError(f"{path}: launches {got} != {expect}")
            if moe_layers:
                _check_routes(path, ("fused_gate_up", "ragged_gmm")
                              + (("paged_decode_attention",) if paged
                                 else ()))
            if flash and cfg.head_dim == 256:
                _check_head_dim_256_routes(path, paged)
            launches[path] = got
            outputs[kind] = done
            del eng
            gc.collect()
        agree = np.mean([float((a == b).mean()) for a, b in
                         zip(outputs["model"], outputs["none"])])
        log(f"{path_name}: SD vs AR token agreement {agree:.3f} (bf16: not "
            "required to be exact)")
    del loaded
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def recurrent_layer_phase(seed: int) -> dict:
    """One recurrent layer at published width, bf16 weights and the
    reference's fp32 states, B 8: an SD verify (T 5, every step's state
    collected) and a prefill (T 256, final state), device-only (captured
    in a CUDA graph and replayed), beside the bound: the bytes of the
    weights, the state read and the states written (collected: T of
    them) at the card's memory rate, against the matmuls at the bf16 peak
    plus the recurrence's elementwise work at the fp32 peak.  Mamba at
    jamba-v0.1-52b's width (d_in 8192, 16 states), mLSTM and sLSTM at
    xlstm-1.3b's (d 2048, 4 heads of 1024)."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models import ssm

    card = card_line()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 21)
    B = 8
    out = {}
    for kind, arch in (("mamba", "jamba-v0.1-52b"), ("mlstm", "xlstm-1.3b"),
                       ("slstm", "xlstm-1.3b")):
        cfg = get_config(arch)
        d = cfg.d_model
        params = ssm.INIT[kind](cfg, torch.bfloat16, generator=gen,
                                device=dev)
        state = ssm.MAKE_STATE[kind](cfg, B, torch.bfloat16, dev)
        w_bytes = sum(t.numel() * t.element_size() for t in params.values())
        # matmul weights (the recurrent r_* of sLSTM are the step's work)
        mm_elems = sum(t.numel() for k, t in params.items()
                       if t.dim() == 2 and k not in ("conv_w", "A_log")
                       and not k.startswith("r_"))
        s_bytes = sum(t.numel() * t.element_size() for t in state.values())
        if kind == "mamba":
            step_elems = B * cfg.ssm_expand * d * cfg.ssm_state_dim * 7
        elif kind == "mlstm":
            hd = 2 * d // cfg.num_heads
            step_elems = B * cfg.num_heads * hd * hd * 6
        else:
            step_elems = 4 * 2 * B * d * d + 12 * B * d
        row = {}
        for label, T, collect in (("verify", 5, True), ("prefill", 256, False)):
            x = torch.randn((B, T, d), generator=gen, device=dev).to(
                torch.bfloat16)
            fn = (lambda x=x, c=collect: ssm.FORWARD[kind](
                params, cfg, x, state, collect_states=c))
            fn()
            torch.cuda.synchronize()
            ms = graph_time_ms(fn, calls=1, iters=3)
            n_bytes = (w_bytes + s_bytes * (1 + (T if collect else 1))
                       + 2 * x.numel() * x.element_size())
            t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
            t_ops = (2 * B * T * mm_elems / BF16_FLOPS
                     + T * step_elems / FP32_FLOPS) * 1e3
            b_ms = max(t_bytes, t_ops)
            row[label] = dict(ms=ms, bound_ms=b_ms,
                              bound_by="bytes" if t_bytes >= t_ops
                              else "operations", bytes=n_bytes,
                              bytes_ms=t_bytes, ops_ms=t_ops)
            log(f"recurrent layer {kind} at {arch} width ({label}: B {B}, "
                f"T {T}{', states collected' if collect else ''}): "
                f"{_fmt(ms)} device-only, bound {b_ms:.4f} ms "
                f"({row[label]['bound_by']}; {n_bytes / 1e6:.1f} MB = "
                f"{t_bytes:.4f} ms, operations {t_ops:.4f} ms), weights "
                f"{w_bytes / 1e6:.1f} MB, state {s_bytes / 1e6:.1f} MB | "
                f"{card}")
            del x
        out[kind] = row
        del params, state
        torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------------ training
# card against CPU in fp32 with TF32 off: loss, aux, grad norm and gradients
TRAIN_TOL = 1e-4
# parameters after 3 AdamW steps, card against CPU, in units of the sum of
# the steps' learning rates: an update divides by sqrt(v) + eps, so where a
# gradient is near eps its last bits move that element by up to one step;
# the mean over every element is held at TRAIN_PARAM_MEAN_TOL
TRAIN_PARAM_TOL = 0.5
TRAIN_PARAM_MEAN_TOL = 1e-3
# qwen2-57b-a14b at full width: one layer is ~2.01 B parameters and the
# untied embedding and head ~1.09 B; at 12 bytes a parameter (bf16 weight
# and gradient, fp32 moments) 1 layer is ~37 GB, 2 layers ~61 GB before
# AdamW's fp32 temporaries (~2.3 GB each for the 587 M-element expert
# leaves).  So 1 layer fits the 80 GB card with room; 2 would not.
TRAIN_LAYERS = 1


def _train_flop_bound(params, cfg, B: int, T: int):
    """(bound ms at the bf16 peak, FLOPs) of one train step with remat: 8 x
    the matmul parameters x tokens (forward, the remat's forward, backward
    at twice the forward; every expert on every token under onehot, the
    embedding table once as the head whether tied or not) plus 4 x the
    causal attention's forward (4 x D x Hq per visible query-key pair)."""
    from repro_torch.training.tree import tree_items
    n = sum(p.numel() for path, p in tree_items(params)
            if p.dim() >= 2 and not (path == "embed/table"
                                     and not cfg.tie_embeddings))
    pairs = B * T * (T + 1) // 2
    attn = 4 * cfg.head_dim * cfg.num_heads * pairs * cfg.num_layers
    flops = 8 * n * B * T + 4 * attn
    return flops / BF16_FLOPS * 1e3, flops


def _train_line(path: str, cfg, B: int, T: int, step_s, losses, params,
                card: str) -> None:
    import numpy as np
    import torch
    ms = float(np.median(step_s[2:])) * 1e3
    b_ms, flops = _train_flop_bound(params, cfg, B, T)
    peak = torch.cuda.max_memory_allocated()
    log(f"{path}: {cfg.name} {cfg.num_layers} layers, B {B}, T {T}, "
        f"{len(losses)} steps: step {ms:.1f} ms (median of steps 3-"
        f"{len(losses)}; first {step_s[0] * 1e3:.1f}, second "
        f"{step_s[1] * 1e3:.1f}), {B * T / ms * 1e3:.0f} tokens/s, peak "
        f"memory {peak / 2**30:.2f} GiB, FLOP bound {b_ms:.1f} ms "
        f"({flops / 1e12:.2f} TFLOP at the bf16 peak; step at "
        f"{b_ms / ms:.3f} of it); losses {losses[0]:.4f} -> "
        f"{losses[-1]:.4f} | {card}")


def _no_launches(path: str) -> dict:
    counts = launch_counts()
    if any(counts.values()):
        raise AssertionError(f"{path}: kernel launches {counts}: training "
                             "must take no kernel route")
    return counts


def train_reference_phase(seed: int) -> dict:
    """Phase 10a: reduced fp32 training, card against CPU, and
    chunked_sdpa's backward at T 1536."""
    import numpy as np
    import torch
    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import packed_batches
    from repro_torch.models.attention import chunked_sdpa
    from repro_torch.models.model import Model
    from repro_torch.training.optimizer import init_adam
    from repro_torch.training.train_loop import make_train_step
    from repro_torch.training.tree import tree_items

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    reset_launch_counts()
    for arch in ("qwen2-57b-a14b", "qwen2-0.5b"):
        cfg = get_config(arch, reduced=True)
        tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=3)
        it = packed_batches(cfg.vocab_size, 4, 64, kind="code", seed=seed)
        batches = [next(it) for _ in range(3)]
        cpu_params = Model(cfg, device="cpu").init(
            torch.Generator("cpu").manual_seed(seed))
        # the step updates params in place: the card's copy is made first
        start = {"cuda": _to_device(cpu_params, torch.device("cuda")),
                 "cpu": cpu_params}
        runs = {}
        for dev in ("cpu", "cuda"):
            model = Model(cfg, remat=True, device=dev)
            params = start[dev]
            opt = init_adam(params)
            step = make_train_step(model, tcfg)
            mets = []
            for b in batches:
                params, opt, m = step(params, opt, b)
                mets.append({k: float(m[k]) for k in
                             ("loss", "aux_loss", "grad_norm", "lr")})
            runs[dev] = (params, mets)
        (pc, mc), (pg, mg) = runs["cpu"], runs["cuda"]
        for i, (a, b) in enumerate(zip(mg, mc)):
            for k in a:
                if not np.isclose(a[k], b[k], rtol=TRAIN_TOL, atol=1e-6):
                    raise AssertionError(f"train {cfg.name} step {i + 1}: "
                                         f"{k} card {a[k]} cpu {b[k]}")
        lr_sum = sum(m["lr"] for m in mc)
        diffs = [(path, (g.cpu() - c).abs()) for (path, g), (_, c) in
                 zip(tree_items(pg), tree_items(pc))]
        worst_path, worst = max(((p, float(d.max())) for p, d in diffs),
                                key=lambda x: x[1])
        mean = float(sum(d.sum() for _, d in diffs)
                     / sum(d.numel() for _, d in diffs))
        log(f"train {cfg.name} fp32, 3 steps, card vs CPU: losses "
            f"{[round(m['loss'], 6) for m in mg]} (cpu "
            f"{[round(m['loss'], 6) for m in mc]}), aux "
            f"{mg[-1]['aux_loss']:.6f}, grad norm {mg[-1]['grad_norm']:.6f}; "
            f"parameters after step 3: max |diff| {worst:.3e} "
            f"({worst / lr_sum:.4f} x the lr sum, {worst_path}), mean "
            f"{mean:.3e} ({mean / lr_sum:.2e} x)")
        if worst > TRAIN_PARAM_TOL * lr_sum or \
                mean > TRAIN_PARAM_MEAN_TOL * lr_sum:
            raise AssertionError(f"train {cfg.name}: parameters after step 3 "
                                 "differ between card and CPU")
    # chunked_sdpa's recompute backward at T 1536: keys in chunks of 1024
    # (one full, one of 512), a window of 700 and a softcap of 30
    rng = np.random.default_rng(seed)
    T = 1536
    arrs = [rng.standard_normal((1, T, h, 64)).astype(np.float32)
            for h in (4, 2, 2)]
    w = rng.standard_normal((1, T, 4, 64)).astype(np.float32)
    grads = {}
    for dev in ("cpu", "cuda"):
        q, k, v = (torch.from_numpy(a).to(dev).requires_grad_()
                   for a in arrs)
        pos = torch.arange(T, device=dev)[None]
        out = chunked_sdpa(q, k, v, pos, pos, scale=0.125, window=700,
                           logit_cap=30.0)
        (torch.tanh(out) * torch.from_numpy(w).to(dev)).sum().backward()
        grads[dev] = [t.grad.cpu() for t in (q, k, v)]
    errs = [float((a - b).abs().max()) for a, b in zip(grads["cuda"],
                                                          grads["cpu"])]
    for a, b in zip(grads["cuda"], grads["cpu"]):
        if not torch.allclose(a, b, rtol=TRAIN_TOL, atol=TRAIN_TOL):
            raise AssertionError(f"chunked_sdpa backward at T {T}: card vs "
                                 f"CPU max |diff| {errs}")
    log(f"train chunked_sdpa backward, T {T}, 4/2 heads of 64, window 700, "
        f"softcap 30, fp32: dq, dk, dv card vs CPU max |diff| "
        f"{', '.join(f'{e:.2e}' for e in errs)} (tolerance {TRAIN_TOL})")
    return {"train/reduced": _no_launches("train/reduced")}


def train_phase(seed: int) -> dict:
    """Phase 10b-c: the draft at its published config through the
    launcher, and the MoE target at published width, TRAIN_LAYERS deep."""
    import gc
    import os
    import tempfile

    import numpy as np
    import torch
    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import packed_batches
    from repro_torch.launch import train as train_cli
    from repro_torch.models.model import Model
    from repro_torch.training.checkpoint import restore_checkpoint
    from repro_torch.training.train_loop import (init_train_state,
                                                 make_train_step)
    from repro_torch.training.tree import tree_items

    card = card_line()
    out = {}
    # (b) qwen2-0.5b through the launcher
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    B, T, steps = 4, 2048, 20
    with tempfile.TemporaryDirectory() as d:
        res = train_cli.main(["--arch", "qwen2-0.5b", "--seq", str(T),
                              "--batch", str(B), "--steps", str(steps),
                              "--kind", "code", "--lr", "1e-3",
                              "--ckpt-dir", d, "--log-every", "5",
                              "--seed", str(seed)])
        path = "train/qwen2-0.5b"
        out[path] = _no_launches(path)
        cfg = get_config("qwen2-0.5b")
        _train_line(path, cfg, B, T, res["step_seconds"], res["losses"],
                    res["params"], card)
        losses = res["losses"]
        if not (np.isfinite(losses).all() and losses[-1] < losses[0] - 1.0):
            raise AssertionError(f"{path}: losses {losses}")
        tree = {"params": res["params"], "opt": res["opt"]}
        t0 = time.perf_counter()
        restored, manifest = restore_checkpoint(res["ckpt"], tree)
        bad = [k for (k, a), (_, b) in zip(tree_items(restored),
                                           tree_items(tree))
               if a.dtype != b.dtype or not torch.equal(a, b)]
        n_bytes = sum(os.path.getsize(os.path.join(res["ckpt"], f))
                      for f in os.listdir(res["ckpt"]))
        if bad or manifest["step"] != steps:
            raise AssertionError(f"{path}: checkpoint differs at {bad[:5]}")
        log(f"{path}: checkpoint {len(manifest['keys'])} leaves, "
            f"{n_bytes / 1e9:.2f} GB, restored bit for bit in "
            f"{time.perf_counter() - t0:.1f} s")
        del res, tree, restored
    # (c) qwen2-57b-a14b at published width, TRAIN_LAYERS deep
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    cfg = get_config("qwen2-57b-a14b").with_overrides(num_layers=TRAIN_LAYERS)
    B, T, steps = 2, 512, 5
    model = Model(cfg, remat=True)
    params, opt = init_train_state(
        model, torch.Generator("cuda").manual_seed(seed))
    # lr 1e-4: Adam's first steps move every weight by about lr, and at
    # lr 1e-3 (the launcher's default) this one wide layer under an untied
    # 3584-wide head overshot (loss 13.1 -> 31.8 at step 2 on an H100)
    step = make_train_step(model, TrainConfig(learning_rate=1e-4,
                                              warmup_steps=1,
                                              total_steps=steps))
    it = packed_batches(cfg.vocab_size, B, T, kind="code", seed=seed)
    losses, step_s = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, next(it))
        losses.append(float(m["loss"]))
        step_s.append(time.perf_counter() - t0)
    path = "train/qwen2-57b-a14b"
    out[path] = _no_launches(path)
    _train_line(path, cfg, B, T, step_s, losses, params, card)
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"{path}: losses {losses}")
    del params, opt, model, m
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------- tuner
TUNER_BATCHES =(1, 2, 4, 8, 16, 32, 64, 128)
ETA_PROMPT, ETA_SEQ = 64, 128       # the wave workload's prompt bucket, max_seq


# ------------------------------------------------------ expert parallelism
EP_PATHS = ("wave-ep/model", "wave-ep/none")
EP_ROWS = 384                       # the receive buffer of phase 11a
EP_TIME_NOISE = 0.05                # of the N = 320 time, beyond the spread


def _ep_hold(label: str, out, ref, tol: float) -> float:
    """Fail unless ``out`` is finite and within rtol = atol = ``tol`` of
    ``ref``; returns the max abs error."""
    import torch
    err = (out.float() - ref.float()).abs()
    over = err > tol + tol * ref.float().abs()
    if not torch.isfinite(out).all() or over.any():
        raise AssertionError(f"{label}: max abs err {err.max().item():.4g} "
                             f"outside rtol=atol={tol}")
    return err.max().item()


def ep_phase(seed: int, served: dict) -> dict:
    """Expert parallelism on a NCCL world of one (ROADMAP queue 1 item 11),
    on the serve phase's target (its weights, no second copy):

      a. kernels 1-2 at the target's width (E 64, d 3584, f 2560, bf16, the
         TMA + wgmma route) on an expert-parallel receive buffer: the SD
         verify's 320 routed rows of N = EP_ROWS, NaN in the rows past the
         groups, held against the plain version on the real rows within
         rtol = atol = TOL, and device-only times at N 320 and N 384 in
         turns (A B B A): the rows past the groups must cost no tiles (the
         times within the spread of the repeats plus EP_TIME_NOISE);
      b. moe_ep_forward against moe_forward(dispatch="gmm"): the reduced
         target in fp32 (within 3e-4, tests/test_ep_dispatch.py) and the
         served layer in bf16 (agreement printed), at an SD verify (B 8,
         T 5) and a 256-token prefill, each device-only (the NCCL
         all-to-alls inside the captured call); EP_CALLS > 0;
      c. wave-ep/model and wave-ep/none: the wave workload of phase 5 on
         an "ep" engine, every round from CUDA graphs, run twice (the
         repeat captures nothing), tok/s, the tokens' agreement with
         wave/model's and wave/none's, launches of kernels 1-2 and EP
         calls = MoE layers x target forwards; then the workload a third
         time under compile_guard, transfer_guard and sharding_guard (0,
         0, ok); and the guards over phase 5's continuous paged stream
         (gmm), warm.
    Returns the launch counts of the wave-ep paths."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.analysis import (compile_guard, sharding_guard,
                                      transfer_guard)
    from repro_torch.configs.registry import get_config
    from repro_torch.distributed import collectives
    from repro_torch.kernels.gmm import ragged
    from repro_torch.kernels.gmm.ref import fused_gate_up_ref, ragged_gmm_ref
    from repro_torch.launch.mesh import make_ep_mesh
    from repro_torch.models.model import Model
    from repro_torch.models.moe import init_moe, moe_forward
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.scheduler import submit_poisson

    card = card_line()
    dev = torch.device("cuda")
    cfg, dcfg = served["cfg"], served["dcfg"]
    target, draft = served["target"], served["draft"]
    params_t, params_d = served["params_t"], served["params_d"]
    moe_layers, pb = served["moe_layers"], served["pb"]
    gen = torch.Generator(device=dev).manual_seed(seed + 25)
    served.setdefault("tok_s", {})

    # a. kernels 1-2 with rows past the groups
    ffn = params_t["layers"][0]["ffn"]
    wg, wu, wd = ffn["w_gate"], ffn["w_up"], ffn["w_down"]
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    sizes = routed_sizes(40, E, K, gen, dev)            # B 8 x (gamma + 1)
    real = int(sizes.sum())
    xs = torch.randn((EP_ROWS, cfg.d_model), generator=gen,
                     device=dev).to(torch.bfloat16)
    xs[real:] = float("nan")
    h = ragged.fused_gate_up(xs, wg, wu, sizes)
    y = ragged.ragged_gmm(h, wd, sizes)
    torch.cuda.synchronize()
    routes = dict(ragged.LAST_ROUTE)
    if set(routes.values()) != {"sm90"}:
        raise AssertionError(f"ep kernels: routes {routes}, expected sm90")
    h_ref = fused_gate_up_ref(xs[:real], wg, wu, sizes)
    err_h = _ep_hold("ep fused_gate_up [trailing rows]", h[:real], h_ref, TOL)
    err_y = _ep_hold("ep ragged_gmm [trailing rows]", y[:real],
                     ragged_gmm_ref(h_ref, wd, sizes), TOL)
    times = {}
    h_real = h[:real].contiguous()
    fns = {("fused_gate_up", real): lambda: ragged.fused_gate_up(
               xs[:real], wg, wu, sizes),
           ("fused_gate_up", EP_ROWS): lambda: ragged.fused_gate_up(
               xs, wg, wu, sizes),
           ("ragged_gmm", real): lambda: ragged.ragged_gmm(h_real, wd, sizes),
           ("ragged_gmm", EP_ROWS): lambda: ragged.ragged_gmm(h, wd, sizes)}
    for name in ("fused_gate_up", "ragged_gmm"):
        for n in (real, EP_ROWS, EP_ROWS, real):          # A B B A
            times.setdefault((name, n), []).append(
                graph_time_ms(fns[name, n], calls=10, iters=5))
    for name in ("fused_gate_up", "ragged_gmm"):
        a, b = times[name, real], times[name, EP_ROWS]
        spread = max(abs(a[0] - a[1]), abs(b[0] - b[1]))
        gap = abs(sum(b) / 2 - sum(a) / 2)
        log(f"ep kernel {name:13s} [verify, {real} of {EP_ROWS} rows]: "
            f"N {real} {a[0]:.4f}/{a[1]:.4f} ms, N {EP_ROWS} {b[0]:.4f}/"
            f"{b[1]:.4f} ms device-only (A B B A), gap {gap:.4f} ms, spread "
            f"{spread:.4f} ms; max abs err on the real rows "
            f"{err_h if name == 'fused_gate_up' else err_y:.4g} "
            f"(rtol=atol={TOL}), route {routes[name]} | {card}")
        if gap > spread + EP_TIME_NOISE * sum(a) / 2:
            raise AssertionError(f"ep kernel {name}: the rows past the groups "
                                 f"cost {gap:.4f} ms (spread {spread:.4f})")
    del xs, h, y, h_ref, h_real, fns
    torch.cuda.empty_cache()

    # b. the EP layer on a NCCL world of one against the gmm dispatch
    mesh = make_ep_mesh(1)
    collectives.reset_ep_calls()
    rcfg = get_config("qwen2-57b-a14b", reduced=True)
    rp = init_moe(rcfg, torch.float32, generator=gen, device=dev)
    shapes = {"verify": (8, 5), "prefill": (1, 256)}
    for label, c, p, dt in (("fp32 reduced", rcfg, rp, torch.float32),
                            ("bf16 full width", cfg, ffn, torch.bfloat16)):
        for case, (B, T) in shapes.items():
            x = torch.randn((B, T, c.d_model), generator=gen, device=dev).to(dt)
            y_ep = collectives.moe_ep_forward(p, c, x, mesh=mesh)
            y_gmm = moe_forward(p, c, x, dispatch="gmm")[0]
            torch.cuda.synchronize()
            if dt == torch.float32:
                err = _ep_hold(f"ep layer [{label}, {case}]", y_ep, y_gmm,
                               3e-4)
                agree = f"max abs err {err:.3g} (rtol=atol=3e-4)"
            else:
                err = (y_ep.float() - y_gmm.float()).abs().max().item()
                rel = err / y_gmm.float().abs().max().item()
                if not torch.isfinite(y_ep).all():
                    raise AssertionError(f"ep layer [{label}, {case}]: "
                                         "non-finite output")
                agree = (f"max abs diff {err:.4g} ({rel:.3g} of the largest "
                         "|y|; printed, bf16 sums in another order)")
            t_ep = graph_time_ms(lambda: collectives.moe_ep_forward(
                p, c, x, mesh=mesh), calls=5, iters=5)
            t_gmm = graph_time_ms(lambda: moe_forward(p, c, x,
                                                      dispatch="gmm"),
                                  calls=5, iters=5)
            if t_ep is None:
                raise AssertionError("ep layer: the all-to-all dispatch "
                                     "could not be captured in a CUDA graph")
            log(f"ep layer [{label}, {case} B {B} T {T}]: {agree}; "
                f"device-only ep {t_ep:.4f} ms, gmm {_fmt(t_gmm)} | {card}")
    calls = collectives.EP_CALLS["moe_ep_forward"]
    if calls <= 0:
        raise AssertionError("ep layer: EP_CALLS is 0")
    log(f"ep layer: EP_CALLS = {calls} (eager calls; captures credit none)")
    del rp
    torch.cuda.empty_cache()

    # c. wave-ep, then the guards over warm streams
    target_ep = Model(cfg, moe_dispatch="ep", mesh=mesh, device="cuda")
    launches = {}

    def guarded(eng, run, path: str):
        with compile_guard() as cg, transfer_guard() as tg, \
                sharding_guard(eng) as sg:
            out = run("warm, under the guards")
        log(f"{path}: warm repeat under the guards: compile_guard "
            f"{cg.count}, transfer_guard {tg.count}, {sg.render()}")
        if cg.count or tg.count or not sg.ok:
            raise AssertionError(f"{path}: guard violation {tg.lines[:5]}")
        return out

    for path in EP_PATHS:
        kind = path.split("/")[1]
        eng = ServingEngine(target_ep, draft if kind == "model" else None,
                            params_t, params_d if kind == "model" else None,
                            max_batch=8, gamma=4, temperature=0.0,
                            proposer=kind, seed=seed, mesh=mesh)

        def run(label, eng=eng, path=path):
            first = max(eng.done, default=0)
            for i in range(16):
                eng.submit(pb["tokens"][i][: int(pb["lengths"][i])],
                           max_new_tokens=32)
            for r in eng.run():
                log(_wave_line(path, label, r) + f" ep={r.ep}")
                served["tok_s"].setdefault(path, []).append(
                    r.tokens_per_second)
            return np.stack([eng.done[u].output for u in sorted(eng.done)
                             if u > first])

        reset_launch_counts()
        collectives.reset_ep_calls()
        for m in (target_ep, draft):
            m.forward_count = m.prefill_count = 0
        out, _ = _path_runs(eng, kind, run, path, card)
        launches[path] = launch_counts()
        served["outputs"][path] = out
        calls = collectives.EP_CALLS["moe_ep_forward"]
        want = moe_layers * target_ep.forward_count
        expect = {name: 0 for name in launches[path]}
        expect["fused_gate_up"] = expect["ragged_gmm"] = want
        log(f"{path}: {target_ep.forward_count} target forwards, launches "
            f"(credited per replay) {launches[path]}, EP calls {calls}, "
            f"expected {want} each")
        if launches[path] != expect or calls != want or want <= 0:
            raise AssertionError(f"{path}: launches {launches[path]}, EP "
                                 f"calls {calls}, expected {want}")
        ref = served["outputs"][f"wave/{kind}"]
        log(f"{path}: greedy tokens vs wave/{kind}'s "
            f"{float((out == ref).mean()):.3f} (bf16: the ep combine sums "
            "in fp32, gmm in bf16; the fp32 phase requires equality)")
        guarded(eng, run, path)
        del eng

    # the guards over phase 5's continuous paged stream (gmm), warm
    eng = ServingEngine(target, draft, params_t, params_d, max_batch=8,
                        gamma=4, temperature=0.0, proposer="model",
                        seed=seed, scheduler="continuous", kv_layout="paged",
                        page_size=64)

    def stream(label):
        first = max(eng.done, default=0)
        submit_poisson(eng, pb["tokens"], pb["lengths"], rate=0.5,
                       max_new_choices=(8, 16, 32), seed=seed)
        eng.submit(served["long_prompt"], max_new_tokens=16, arrival_round=6)
        (r,) = eng.run()
        log(f"continuous/model ({label}): {r.tokens_per_second:.2f} tok/s "
            f"rounds={r.stats.rounds} captures={r.captures} "
            f"replays={r.replays}")
        return {u - first: eng.done[u].output for u in eng.done if u > first}

    stream("graphs, first run")
    guarded(eng, stream, "continuous/model")
    del eng, target_ep
    torch.cuda.empty_cache()
    dist.destroy_process_group()
    return launches


TP_PATHS = ("wave-tp/model", "wave-tp/none")
PARTIAL_MAIN_CASE = "sd_verify_4x1"
# kernel 4's partial entry (phase 12a), bf16, an SD verify over a cache
# split into 2 and 4 key blocks: the target's 28 / 4 heads of 128, and
# gemma3-12b's 16 / 8 heads of 256 at wave-gemma3's lengths (the split-KV
# body at D 256).  name: (Hq, Hkv, D, S, (min, max) length)
PARTIAL_CASES = {"sd_verify": (28, 4, 128, 512, (129, 290)),
                 "long_context": (28, 4, 128, 8192, (8000, 8187)),
                 "gemma3_sd_verify": (16, 8, 256, 2048, (1100, 1640))}
# the partial entry's fp32 log-sum-exp against its plain version, rtol =
# atol: a row's lse sums its block's visible keys' exp-scores, so leaving
# out even one 64-key chunk of a 2048-key block moves it by ~log(1 + 64 /
# 2048) ~ 3e-2 nats, well outside 1e-3 (+ 1e-3 x |lse| ~ 1e-2)
PARTIAL_LSE_TOL = 1e-3


def _hold_lse(label: str, got, want, tol: float) -> float:
    """Fail unless two log-sum-exps are -inf at the same rows and within
    rtol = atol = ``tol`` elsewhere; returns the max abs error."""
    import torch
    inf = torch.isinf(want)
    if not torch.equal(torch.isinf(got), inf) or torch.isnan(got).any():
        raise AssertionError(f"{label}: lse -inf at other rows than the "
                             "plain version's")
    err = (got[~inf] - want[~inf]).abs()
    if (err > tol + tol * want[~inf].abs()).any():
        raise AssertionError(f"{label}: lse max abs err {err.max():.4g} "
                             f"outside rtol=atol={tol}")
    return float(err.max()) if err.numel() else 0.0


def _hold_block_rows(label: str, out, want, want_lse) -> float:
    """Fail unless a block's output is exactly 0 at the rows that see no
    key of it (plain lse -inf) and within DECODE_ROW_TOL x the rms of the
    plain row elsewhere; returns the largest row-scaled error."""
    import torch
    seen = torch.isfinite(want_lse)
    if (out[~seen] != 0).any():
        raise AssertionError(f"{label}: nonzero output at a row that sees "
                             "no key of the block")
    if not seen.any():
        return 0.0
    err = row_scaled_err(out[seen], want[seen])
    if err > DECODE_ROW_TOL:
        raise AssertionError(f"{label}: {err:.3g} x a row's rms from the "
                             f"plain version (bound {DECODE_ROW_TOL})")
    return err


def partial_kernel_phase(seed: int) -> dict:
    """Phase 12a: kernel 4's partial entry (a key block of a cache split
    along its sequence) against its plain version, element by element, row
    by row and lse by lse; its blocks merged by log-sum-exp against the
    whole call, and the plain blocks merged against the plain whole; timed
    beside its bound and one library call per block; returns the entry's
    case results."""
    import torch
    from repro_torch.distributed.collectives import lse_combine
    from repro_torch.kernels.decode_attention import ops
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_partial_plain, decode_attention_plain)

    card = card_line()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 26)
    tol = DECODE_TOL["bfloat16"]
    res = {"cases": {}, "max_abs_err": 0.0, "max_err_over_tol": 0.0}
    for name, (Hq, Hkv, D, S, span) in PARTIAL_CASES.items():
        spec = ("bfloat16", 8, 5, Hq, Hkv, D, S, span)
        _, B, T, Hq, Hkv, D, _, _ = spec
        q, k, v, lengths = decode_inputs(spec, gen, dev)
        whole = ops.decode_attention(q, k, v, lengths)
        plain_whole = decode_attention_plain(q, k, v, lengths)
        whole_ms = graph_time_ms(lambda: ops.decode_attention(q, k, v,
                                                              lengths))
        lens = [int(n) for n in lengths.tolist()]
        for blocks in (2, 4):
            n = S // blocks
            outs, lses, p_outs, p_lses = [], [], [], []
            for i in range(blocks):
                kb, vb = k[:, i * n:(i + 1) * n], v[:, i * n:(i + 1) * n]
                out, lse = ops.decode_attention_partial(q, kb, vb, lengths,
                                                        k_lo=i * n)
                route = ops.LAST_ROUTE["decode_attention_partial"]
                if route != "sm90":
                    raise AssertionError(f"decode_attention_partial: ran the "
                                         f"{route} body, expected sm90")
                p_out, p_lse = decode_attention_partial_plain(
                    q, kb, vb, lengths, k_lo=i * n)
                torch.cuda.synchronize()
                case = f"{name}_{blocks}x{i}"
                err = _hold("decode_attention_partial", case, out, p_out,
                            tol, res)
                row_err = _hold_block_rows(
                    f"decode_attention_partial [{case}]", out, p_out, p_lse)
                lse_err = _hold_lse(f"decode_attention_partial [{case}]",
                                    lse, p_lse, PARTIAL_LSE_TOL)
                outs.append(out)
                lses.append(lse)
                p_outs.append(p_out)
                p_lses.append(p_lse)
                # bytes: the block's visible keys, q, out and lse, lengths;
                # FLOPs: 4 D per (query row, visible key of the block)
                keys = sum(max(0, min(n, ln + T - i * n)) for ln in lens)
                pairs = sum(max(0, min(n, ln + t + 1 - i * n))
                            for ln in lens for t in range(T))
                n_bytes = (keys * Hkv * D * 2 * 2 + 2 * q.numel() * 2
                           + B * T * Hq * 4 + 4 * B)
                b_ms, b_by = bound_ms(n_bytes, 4 * Hq * D * pairs)
                ms = graph_time_ms(lambda: ops.decode_attention_partial(
                    q, kb, vb, lengths, k_lo=i * n))
                plain_ms = cuda_time_ms(lambda: decode_attention_partial_plain(
                    q, kb, vb, lengths, k_lo=i * n), warmup=1, iters=3)
                lib_fn, lib = sdpa_lse_block(q, kb, vb, lengths, i * n)
                lib_ms = graph_time_ms(lib_fn) if lib_fn else None
                res["cases"][case] = dict(
                    S=S, blocks=blocks, block=i, keys=keys, route=route,
                    kernel_ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                    bound_by=b_by, library_ms=lib_ms, library=lib,
                    whole_ms=whole_ms, max_abs_err=err,
                    row_scaled_err=row_err, lse_max_abs_err=lse_err,
                    bytes=n_bytes)
                log(f"kernel decode_attention_partial [{case:16s}] bf16 "
                    f"route={route} B={B} T={T} heads={Hq}/{Hkv}x{D} block "
                    f"[{i * n}, {(i + 1) * n}) keys={keys}  {_fmt(ms)} "
                    f"device-only (whole call {_fmt(whole_ms)})  plain "
                    f"{plain_ms:.3f} ms  bound {b_ms:.4f} ms ({b_by})  "
                    f"library {_fmt(lib_ms)}  max err {err:.3g} "
                    f"({row_err:.3g} x row rms), lse {lse_err:.3g} | "
                    f"{card}")
            merged = lse_combine(torch.stack(outs), torch.stack(lses)).to(
                whole.dtype)
            err = _hold("decode_attention_partial", f"{name} merged of "
                        f"{blocks}", merged, whole, tol, res)
            row_err = row_scaled_err(merged, whole)
            if row_err > DECODE_ROW_TOL:
                raise AssertionError(
                    f"decode_attention_partial [{name}, {blocks} blocks]: "
                    f"the merge is {row_err:.3g} x a row's rms from the "
                    f"whole call (bound {DECODE_ROW_TOL})")
            p_merged = lse_combine(torch.stack(p_outs),
                                   torch.stack(p_lses)).to(whole.dtype)
            p_err = row_scaled_err(p_merged, plain_whole)
            if p_err > DECODE_ROW_TOL:
                raise AssertionError(
                    f"decode_attention_partial_plain [{name}, {blocks} "
                    f"blocks]: the plain merge is {p_err:.3g} x a row's rms "
                    f"from decode_attention_plain (bound {DECODE_ROW_TOL})")
            log(f"kernel decode_attention_partial [{name}] {blocks} blocks "
                f"merged by log-sum-exp vs the whole call: max err "
                f"{err:.3g}, {row_err:.3g} x row rms; plain blocks merged "
                f"vs the plain whole {p_err:.3g} x row rms")
        del q, k, v, whole, plain_whole
    torch.cuda.empty_cache()
    return res


def sdpa_lse_block(q, kb, vb, lengths, k_lo: int):
    """``aten._scaled_dot_product_efficient_attention(compute_log_sumexp=
    True)`` over one key block, K/V repeated to the query heads and the
    causal mask as an additive bias, copies made beforehand: a yardstick
    the port never calls.  Returns (fn or None, label)."""
    import torch
    B, T, Hq, _ = q.shape
    n, Hkv = kb.shape[1], kb.shape[2]
    g = Hq // Hkv
    qh = q.transpose(1, 2).contiguous()
    kh, vh = (t.transpose(1, 2).repeat_interleave(g, 1).contiguous()
              for t in (kb, vb))
    q_pos = lengths.to(torch.int64)[:, None] + torch.arange(T, device=q.device)
    k_pos = k_lo + torch.arange(n, device=q.device)
    bias = torch.zeros((B, Hq, T, n), dtype=q.dtype, device=q.device)
    bias.masked_fill_((k_pos[None, None, :] > q_pos[:, :, None])[:, None],
                      float("-inf"))
    return _library(
        lambda: torch.ops.aten._scaled_dot_product_efficient_attention(
            qh, kh, vh, bias, True),
        "aten._scaled_dot_product_efficient_attention(compute_log_sumexp) "
        "over the block, K/V repeated to the query heads, copies excluded")


def tp_phase(seed: int, served: dict) -> dict:
    """Phase 12: tensor parallelism on a NCCL world of one, after phase 11
    on its target and weights.

      a. kernel 4's partial entry (``partial_kernel_phase``);
      b. wave-tp/model and wave-tp/none: phase 5's wave workload on
         ``Model(moe_dispatch="ep", mesh=make_ep_mesh(1), mesh_layout=
         "tp")`` through ``ServingEngine(mesh=..., mesh_layout="tp")``
         (every spec resolves whole at m 1): greedy tokens equal to
         wave-ep's bit for bit, tok/s beside wave-ep's, launches per path
         equal to wave-ep's, and the workload again under compile_guard,
         transfer_guard and sharding_guard (0 / 0 / ok);
      c. one sharded train step (``make_train_step`` on a model with the
         mesh, params placed with fsdp=True) of the reduced fp32 target
         equals the unsharded step on the card, leaf for leaf.
    Returns (the partial entry's results, the wave-tp launch counts)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.analysis import (compile_guard, sharding_guard,
                                      transfer_guard)
    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import packed_batches
    from repro_torch.launch.mesh import make_ep_mesh
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.training.optimizer import init_adam
    from repro_torch.training.train_loop import make_train_step
    from repro_torch.training.tree import tree_items

    t0 = time.perf_counter()
    card = card_line()
    partial = partial_kernel_phase(seed)

    # b. wave-tp
    cfg, draft = served["cfg"], served["draft"]
    params_t, params_d = served["params_t"], served["params_d"]
    pb = served["pb"]
    mesh = make_ep_mesh(1)
    target_tp = Model(cfg, moe_dispatch="ep", mesh=mesh, mesh_layout="tp",
                      device="cuda")
    draft.mesh, draft.mesh_layout = mesh, "tp"     # phase 11's world is gone
    launches = {}
    for path in TP_PATHS:
        kind = path.split("/")[1]
        eng = ServingEngine(target_tp, draft if kind == "model" else None,
                            params_t, params_d if kind == "model" else None,
                            max_batch=8, gamma=4, temperature=0.0,
                            proposer=kind, seed=seed, mesh=mesh,
                            mesh_layout="tp")
        tps = []

        def run(label, eng=eng, path=path, tps=tps):
            first = max(eng.done, default=0)
            for i in range(16):
                eng.submit(pb["tokens"][i][: int(pb["lengths"][i])],
                           max_new_tokens=32)
            for r in eng.run():
                log(_wave_line(path, label, r))
                tps.append(r.tokens_per_second)
            return np.stack([eng.done[u].output for u in sorted(eng.done)
                             if u > first])

        reset_launch_counts()
        out, _ = _path_runs(eng, kind, run, path, card)
        launches[path] = launch_counts()
        ep_path = f"wave-ep/{kind}"
        if launches[path] != served["launches"][ep_path]:
            raise AssertionError(f"{path}: launches {launches[path]}, "
                                 f"{ep_path}'s {served['launches'][ep_path]}")
        if launches[path]["decode_attention_partial"] != 0:
            raise AssertionError(f"{path}: the partial entry launched at m 1,"
                                 " where no cache splits along its sequence")
        if not np.array_equal(out, served["outputs"][ep_path]):
            raise AssertionError(f"{path}: greedy tokens differ from "
                                 f"{ep_path}'s at m 1")
        log(f"{path}: greedy tokens equal {ep_path}'s bit for bit; launches "
            f"{launches[path]} = {ep_path}'s; tok/s {tps} beside {ep_path}'s "
            f"{served['tok_s'][ep_path]} | {card}")
        with compile_guard() as cg, transfer_guard() as tg, \
                sharding_guard(eng) as sg:
            run("warm, under the guards")
        log(f"{path}: warm repeat under the guards: compile_guard "
            f"{cg.count}, transfer_guard {tg.count}, {sg.render()}")
        if cg.count or tg.count or not sg.ok:
            raise AssertionError(f"{path}: guard violation {tg.lines[:5]}")
        del eng
    del target_tp
    torch.cuda.empty_cache()

    # c. one sharded train step at m 1 == the unsharded step
    rcfg = get_config("qwen2-57b-a14b", reduced=True)
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=3)
    batch = next(packed_batches(rcfg.vocab_size, 4, 64, kind="code",
                                seed=seed))
    init = Model(rcfg, device="cuda").init(
        torch.Generator("cuda").manual_seed(seed))
    runs = {}
    for label, m in (("unsharded", None), ("sharded", mesh)):
        model = Model(rcfg, remat=True, device="cuda", mesh=m)
        params = model.place(_clone_tree(init), fsdp=True)
        opt = init_adam(params)
        params, opt, met = make_train_step(model, tcfg)(params, opt, batch)
        runs[label] = (params, opt, met)
    (pu, ou, mu), (ps, os_, ms) = runs["unsharded"], runs["sharded"]
    for tree_u, tree_s, what in ((pu, ps, "params"), (ou.mu, os_.mu, "mu"),
                                 (ou.nu, os_.nu, "nu")):
        for (path, a), (_, b) in zip(tree_items(tree_u), tree_items(tree_s)):
            if not torch.equal(a, b):
                raise AssertionError(f"train step at m 1: {what} {path} "
                                     "differs from the unsharded step")
    for k in ("loss", "aux_loss", "grad_norm", "total_loss"):
        if not torch.equal(mu[k], ms[k]):
            raise AssertionError(f"train step at m 1: {k} {float(ms[k])} vs "
                                 f"{float(mu[k])}")
    log(f"train step at m 1 (reduced fp32, fsdp=True placement): params, "
        f"moments and metrics equal the unsharded step's (loss "
        f"{float(ms['loss']):.6f}, grad norm {float(ms['grad_norm']):.6f})")
    del runs, init
    torch.cuda.empty_cache()
    dist.destroy_process_group()
    log(f"phase 12 (tensor parallelism): {time.perf_counter() - t0:.1f} s")
    return partial, launches


def _clone_tree(tree):
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone_tree(v) for v in tree]
    return tree.clone()


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
    prefix_fault_reference_phase(args.seed)
    proposer_reference_phase(args.seed)
    launches, served = serve_phase(args.seed)
    launches.update(prefix_faults_phase(args.seed, served))
    launches.update(prefetch_phase(args.seed, served))
    launches.update(tuner_phase(args.seed, served))
    launches.update(ep_phase(args.seed, served))
    served["launches"] = launches
    partial, tp_launches = tp_phase(args.seed, served)
    launches.update(tp_launches)
    del served
    launches.update(eagle_phase(args.seed))
    tuner_reference_phase(args.seed)
    arch_reference_phase(args.seed)
    recurrent_draft_phase(args.seed)
    launches.update(arch_serve_phase(args.seed))
    recurrent_layer_phase(args.seed)
    launches[OPS_PATH] = capacity_ops_path(args.seed)
    launches.update(train_reference_phase(args.seed))
    launches.update(train_phase(args.seed))

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
        if name == "decode_attention":
            # the partial entry of the same source: on no path of one card
            # (a cache splits along its sequence only over 2 ranks or more)
            pv = partial["cases"][PARTIAL_MAIN_CASE]
            line[-1]["partial"] = {
                "entry": "decode_attention_partial", "route": pv["route"],
                "launches": launches[TP_PATHS[0]]["decode_attention_partial"],
                "launches_by_path": {
                    path: counts["decode_attention_partial"]
                    for path, counts in launches.items()},
                "main_path": TP_PATHS[0],
                "max_abs_err": partial["max_abs_err"],
                "max_err_over_tol": partial["max_err_over_tol"],
                "ms": pv["kernel_ms"], "plain_ms": pv["plain_ms"],
                "bound_ms": pv["bound_ms"], "bound_by": pv["bound_by"],
                "library_ms": pv["library_ms"], "library": pv["library"],
                "cases": partial["cases"]}
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(f"card: {card}")
    log(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
