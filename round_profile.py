#!/usr/bin/env python3
"""Where an SD round's time goes on one NVIDIA GPU, CUDA graphs against
eager.

    python3 round_profile.py [--seed N] [--rounds N]

Builds qwen2-57b-a14b at its full published width, depth cut to 4 of 28
layers, with the full qwen2-0.5b draft (random bf16 weights from --seed),
and opens a wave session of 8 chat prompts (gamma 4, greedy, dense cache of
128 positions, as chip_smoke.py's wave path).  For the "model" (SD) and
"none" (AR) proposers, each with the round captured in CUDA graphs and run
eagerly, it runs one round (the key's capture), then traces --rounds rounds
with torch.profiler (CPU and CUDA activity) and prints per round: the wall
time (host clock, to the round's readback), the device-busy time (the union
of the traced kernel, copy and set intervals), the device's idle share of
the wall time, the device operations launched and the five longest kernels
by total time.  Then, eagerly, one draft forward (B 8, T 1) and one target
verify forward (B 8, T 5) alone: their device operations and busy time.
It ends with one JSON line of these numbers and the card's name and power
limit.  Exits non-zero without a card or outside a checkout.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
LAYERS = 4


def device_ops(prof):
    """(start, end, name) of every device-side event of a trace."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.time_range.start, e.time_range.end, e.name)
            for e in prof.events() if e.device_type == cuda]


def busy_us(ops) -> float:
    """Length of the union of the intervals."""
    total, end = 0.0, None
    for s, e, _ in sorted(ops):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def top_kernels(ops, n: int = 5):
    by = {}
    for s, e, name in ops:
        by[name] = by.get(name, 0.0) + (e - s)
    return [(k[:60], round(v / 1e3, 3)) for k, v in
            sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def profile(fn):
    import torch
    from torch.profiler import ProfilerActivity, profile as tprof
    torch.cuda.synchronize()
    with tprof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return device_ops(p), wall


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rounds", type=int, default=8)
    args = ap.parse_args()
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("round_profile: run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("round_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.registry import get_config
    from repro_torch.core.proposer import make_proposer
    from repro_torch.core.spec_decode import SDEngine
    from repro_torch.data.pipeline import prompt_batch
    from repro_torch.models.model import Model

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    cfg = get_config("qwen2-57b-a14b").with_overrides(num_layers=LAYERS)
    dcfg = get_config("qwen2-0.5b")
    target = Model(cfg, moe_dispatch="gmm", device="cuda")
    draft = Model(dcfg, device="cuda")
    gen = torch.Generator(device="cuda")
    params_t = target.init(gen.manual_seed(args.seed))
    params_d = draft.init(gen.manual_seed(args.seed + 1))
    pb = prompt_batch(cfg.vocab_size, 8, kind="chat", seed=args.seed)
    prompts = np.full((8, 64), 0, np.int32)
    prompts[:, : pb["tokens"].shape[1]] = pb["tokens"][:, :64]
    lengths = np.minimum(pb["lengths"], 64)

    result = {"card": card, "rounds": {}, "forwards": {}}
    for kind in ("model", "none"):
        for graphs in (True, False):
            eng = SDEngine(target, make_proposer(
                kind, target, draft if kind == "model" else None),
                gamma=4 if kind == "model" else 0, cuda_graphs=graphs)
            state = eng.start(params_t, params_d if kind == "model" else None,
                              prompts, max_seq=128, lengths=lengths)
            state, _ = eng.round(state)                # the key's capture
            walls = []

            def rounds():
                nonlocal state
                for _ in range(args.rounds):
                    state, res = eng.round(state)
                    walls.append(res.round_time)

            ops, wall = profile(rounds)
            label = f"{'SD' if kind == 'model' else 'AR'} " \
                    f"{'graphs' if graphs else 'eager'}"
            n = args.rounds
            row = {"wall_ms": 1e3 * float(np.median(walls)),
                   "device_busy_ms": busy_us(ops) / 1e3 / n,
                   "idle_share": 1 - busy_us(ops) / 1e6 / wall,
                   "device_ops": len(ops) / n,
                   "top": top_kernels(ops)}
            result["rounds"][label] = row
            print(f"{label}: round wall {row['wall_ms']:.3f} ms (median), "
                  f"device busy {row['device_busy_ms']:.3f} ms, idle share "
                  f"{row['idle_share']:.3f}, {row['device_ops']:.0f} device "
                  f"ops a round; longest kernels (ms over {n} rounds) "
                  f"{row['top']}", flush=True)
            if not ops:
                raise AssertionError(f"{label}: the trace holds no device "
                                     "operation")
            del eng, state
            torch.cuda.empty_cache()

    # one forward of each model alone, eagerly
    for name, model, params, T in (("draft forward (B 8, T 1)", draft,
                                    params_d, 1),
                                   ("target verify (B 8, T 5)", target,
                                    params_t, 5)):
        cache = model.init_cache(8, 128)
        _, cache = model.prefill(params, prompts, cache, lengths=lengths)
        # lint: allow[R505] token ids of a timing probe; values do not matter
        tok = torch.randint(3, cfg.vocab_size, (8, T), device="cuda")
        model.extend(params, tok, cache)               # warm-up
        ops, wall = profile(lambda: model.extend(params, tok, cache))
        result["forwards"][name] = {"device_ops": len(ops),
                                    "device_busy_ms": busy_us(ops) / 1e3,
                                    "wall_ms": wall * 1e3,
                                    "top": top_kernels(ops)}
        print(f"{name}, eager: {len(ops)} device ops, device busy "
              f"{busy_us(ops) / 1e3:.3f} ms, wall {wall * 1e3:.3f} ms; "
              f"longest {top_kernels(ops)}", flush=True)
        del cache
    print(f"card: {card}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
