#!/usr/bin/env python3
"""Where a training step's time goes on one NVIDIA GPU.

    python3 train_profile.py [--seed N] [--steps N]

Two of chip_smoke.py's phase-10 paths, random weights from --seed on
packed code batches: the draft ``qwen2-0.5b`` at its published config (B 4,
T 2048, lr 1e-3: every attention takes chunked_sdpa's recompute backward)
and ``qwen2-57b-a14b`` at published width, one of 28 layers (B 2, T 512,
onehot, lr 1e-4), both with per-layer remat.  For each, after two warm-up
steps it traces --steps steps with torch.profiler (CPU and CUDA activity)
and prints per step: the wall time (host clock, to the read of the loss),
the device-busy time (the union of the traced device intervals), the
device's idle share, the device operations, the busy time by kind of
kernel (bf16 and fp32 matmuls: cuBLAS/CUTLASS GEMMs by their names; the
rest by name) and the eight longest kernels.  Then AdamW alone (``adamw_update`` on the trained
parameters with gradients of their shapes, CUDA events, median of 5): the
optimizer's share of the step.  It ends with one JSON line and the card's
name and power limit.  Exits non-zero without a card or outside a checkout.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
MATMUL = ("gemm", "cutlass", "xmma", "cublas", "wgmma", "nvjet")


def by_kind(ops) -> dict:
    """Device ms by kind of kernel: matmuls by their library's names (fp32
    ones apart: "f32f32" or "sgemm" in the name), the rest by the kernel's
    name without its namespace and template arguments."""
    out = {}
    for s, e, name in ops:
        low = name.lower()
        if any(m in low for m in MATMUL):
            fp32 = "f32f32" in low or "sgemm" in low
            kind = "matmul fp32" if fp32 else "matmul"
        else:
            kind = low.replace("void ", "").split("<")[0].split("(")[0]
            kind = kind.split("::")[-1][:40]
        out[kind] = out.get(kind, 0.0) + (e - s) / 1e3
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=2)
    args = ap.parse_args()
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("train_profile: run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("train_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from round_profile import busy_us, profile, top_kernels
    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import packed_batches
    from repro_torch.models.model import Model
    from repro_torch.training.optimizer import adamw_update
    from repro_torch.training.train_loop import (init_train_state,
                                                 make_train_step)
    from repro_torch.training.tree import tree_map

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    result = {"card": card}
    for label, cfg, B, T, lr in (
            ("qwen2-0.5b", get_config("qwen2-0.5b"), 4, 2048, 1e-3),
            ("qwen2-57b-a14b x1", get_config("qwen2-57b-a14b")
             .with_overrides(num_layers=1), 2, 512, 1e-4)):
        model = Model(cfg, remat=True)
        params, opt = init_train_state(
            # lint: allow[R504] one model per iteration, from the run's seed
            model, torch.Generator("cuda").manual_seed(args.seed))
        tcfg = TrainConfig(learning_rate=lr, warmup_steps=1,
                           total_steps=args.steps + 2)
        step = make_train_step(model, tcfg)
        it = packed_batches(cfg.vocab_size, B, T, kind="code", seed=args.seed)
        walls = []

        def run(n):
            nonlocal params, opt
            for _ in range(n):
                t0 = time.perf_counter()
                params, opt, m = step(params, opt, next(it))
                float(m["loss"])
                walls.append(time.perf_counter() - t0)

        run(2)
        torch.cuda.reset_peak_memory_stats()
        ops, wall = profile(lambda: run(args.steps))
        if not ops:
            raise AssertionError(f"{label}: the trace holds no device "
                                 "operation")
        n = args.steps
        grads = tree_map(torch.randn_like, params)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        adamw = []
        for _ in range(5):
            start.record()
            adamw_update(params, grads, opt, tcfg)
            end.record()
            torch.cuda.synchronize()
            adamw.append(start.elapsed_time(end))
        row = {"step_wall_ms": 1e3 * float(np.median(walls[2:])),
               "device_busy_ms": busy_us(ops) / 1e3 / n,
               "idle_share": 1 - busy_us(ops) / 1e6 / wall,
               "device_ops": len(ops) / n,
               "by_kind_ms": {k: round(v / n, 3)
                              for k, v in list(by_kind(ops).items())[:8]},
               "top": top_kernels(ops, 8),
               "adamw_ms": float(np.median(adamw)),
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        result[label] = row
        print(f"{label} (B {B}, T {T}): step wall {row['step_wall_ms']:.1f} "
              f"ms, device busy {row['device_busy_ms']:.1f} ms, idle share "
              f"{row['idle_share']:.3f}, {row['device_ops']:.0f} device ops "
              f"a step; AdamW alone {row['adamw_ms']:.1f} ms; busy by kind "
              f"(ms a step) {row['by_kind_ms']}; longest kernels (ms over "
              f"{n} steps) {row['top']} | {card}", flush=True)
        del params, opt, grads, model, step
        torch.cuda.empty_cache()
    print(f"card: {card}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
