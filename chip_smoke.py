#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed N]

Phases, each of which fails the run if it fails:

  1. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
  2. build every CUDA kernel of the path from the sources in this checkout;
  3. kernels: at the main path's shapes (SD verify: 320 routed rows, top-8 of
     64 experts; AR verify: 64 rows, about one per expert; prefill: 4096
     rows; empty experts with unaligned groups), run each kernel and its
     plain PyTorch version on the same bf16 inputs, hold them within the
     reference's bound (rtol = atol = 3e-2, tests/test_ragged_gmm.py) and
     time both beside the card's bound;
  4. reference: on the reduced qwen2-57b-a14b in fp32, the CUDA path agrees
     with the port's plain CPU path (which the CPU tests hold against the JAX
     reference) and greedy SD equals greedy AR;
  5. serve: ServingEngine(scheduler="wave") on qwen2-57b-a14b at its full
     published width, depth cut to LAYERS of 28, with the full qwen2-0.5b
     draft and random weights from --seed: 16 requests, max-batch 8, max-new
     32, gamma 4, greedy, with the default (untimed) round, first with the
     "model" proposer (SD, the main path), then "none" (AR).  Each path runs
     with the launch counts set to 0 just before it and read just after, and
     every kernel's count must equal (MoE layers x that path's target
     forwards).  One more wave per proposer runs the timed round for the
     propose/verify/reject breakdown; it is not counted.

It ends with a JSON line of per-kernel numbers and, last, the device line.
Without a card, or outside a checkout of the repository, it exits non-zero
and prints no result.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, published, at 700 W
BF16_FLOPS = 989e12                # dense bf16 tensor-core peak, published
TOL = 3e-2                         # rtol and atol, tests/test_ragged_gmm.py
# Target depth at full width: the bf16 weights of all 28 layers (57.4B
# parameters, ~115 GB) do not fit in the card's 80 GB; 4 layers are ~18 GB.
LAYERS = 4
TPU_SITES = {                      # the Pallas kernel each CUDA kernel replaces
    "fused_gate_up": "src/repro/kernels/gmm/ragged.py:124",    # _fused_kernel
    "ragged_gmm": "src/repro/kernels/gmm/ragged.py:104",       # _ragged_kernel
}


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


def bound_ms(bytes_moved: float, flops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# --------------------------------------------------------------------- build
def build_kernels():
    from repro_torch.kernels import build
    from repro_torch.kernels.gmm import ragged
    t0 = time.perf_counter()
    build.load(ragged.SOURCE)
    log(f"build: {time.perf_counter() - t0:.1f} s -> "
        f"{build.library_path(ragged.SOURCE).relative_to(ROOT)}")


# ------------------------------------------------------------------- kernels
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
    edge = torch.zeros((E,), dtype=torch.int32, device=dev)
    edge[[0, 2, 3, 5, 6, 7, 40, 63]] = torch.tensor(
        [37, 1, 129, 77, 13, 200, 3, 17], dtype=torch.int32, device=dev)
    cases = {
        "verify": routed_sizes(40, E, K, gen, dev),      # B=8 x (gamma+1)=5
        "ar_verify": routed_sizes(8, E, K, gen, dev),    # B=8 x 1: ~1 row/expert
        "prefill": routed_sizes(512, E, K, gen, dev),    # B=8 x T=64
        "edge": edge,                                    # empties, unaligned
    }
    results = {name: {"cases": {}, "max_abs_err": 0.0, "max_err_over_tol": 0.0}
               for name in ("fused_gate_up", "ragged_gmm")}
    for case, sizes in cases.items():
        N = int(sizes.sum())
        active = int((sizes > 0).sum())
        xs = torch.randn((N, D), generator=gen, device=dev).to(dt)
        h = ragged.fused_gate_up(xs, wg, wu, sizes)
        h_ref = fused_gate_up_ref(xs, wg, wu, sizes)
        y = ragged.ragged_gmm(h_ref, wd, sizes)
        y_ref = ragged_gmm_ref(h_ref, wd, sizes)
        torch.cuda.synchronize()
        for name, out, ref in (("fused_gate_up", h, h_ref),
                               ("ragged_gmm", y, y_ref)):
            err = (out.float() - ref.float()).abs()
            over = err / (TOL + TOL * ref.float().abs())
            bad = over > 1
            if not torch.isfinite(out).all() or bad.any():
                raise AssertionError(
                    f"{name} [{case}]: kernel disagrees with its plain version "
                    f"(max abs err {err.max().item():.4g}, "
                    f"{int(bad.sum())} elements outside rtol=atol={TOL})")
            res = results[name]
            res["max_abs_err"] = max(res["max_abs_err"], err.max().item())
            res["max_err_over_tol"] = max(res["max_err_over_tol"],
                                          over.max().item())
        meta, _ = ragged._plan(xs, E, sizes, None)     # the kernels' visit list
        timings = {
            "fused_gate_up": dict(
                ms=cuda_time_ms(lambda: ragged.fused_gate_up(xs, wg, wu, sizes)),
                plain_ms=cuda_time_ms(lambda: fused_gate_up_ref(xs, wg, wu, sizes),
                                      warmup=1, iters=3),
                bytes=N * D * 2 + active * 2 * D * F * 2 + E * 4 + N * F * 2,
                flops=2 * 2 * N * D * F, library=(None, "no single call")),
            "ragged_gmm": dict(
                ms=cuda_time_ms(lambda: ragged.ragged_gmm(h_ref, wd, sizes)),
                plain_ms=cuda_time_ms(lambda: ragged_gmm_ref(h_ref, wd, sizes),
                                      warmup=1, iters=3),
                bytes=N * F * 2 + active * F * D * 2 + E * 4 + N * D * 2,
                flops=2 * N * F * D,
                library=grouped_mm_library(h_ref, wd, sizes)),
        }
        for name, t in timings.items():
            b_ms, b_by = bound_ms(t["bytes"], t["flops"])
            lib_fn, lib_name = t["library"]
            lib_ms = cuda_time_ms(lib_fn) if lib_fn is not None else None
            results[name]["cases"][case] = dict(
                rows=N, active_experts=active,
                visits=int(meta.num_visits[0]), kernel_ms=t["ms"],
                plain_ms=t["plain_ms"], bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms, library=lib_name)
            log(f"kernel {name:13s} [{case:9s}] rows={N:5d} experts={active:2d} "
                f"visits={int(meta.num_visits[0]):3d}  {t['ms']:.3f} ms  "
                f"plain {t['plain_ms']:.3f} ms  bound {b_ms:.3f} ms ({b_by})  "
                f"library {'-' if lib_ms is None else f'{lib_ms:.3f} ms'} "
                f"({lib_name})")
    del wg, wu, wd
    torch.cuda.empty_cache()
    return results


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
    draft = Model(dcfg, device="cuda")
    p_d = draft.init(torch.Generator(device="cuda").manual_seed(seed + 1))
    eng = SDEngine(gpu, make_proposer("model", gpu, draft), gamma=4)
    sd, _ = eng.generate(p_gpu, p_d, toks, 24, lengths=lengths)
    ar = generate_ar(gpu, p_gpu, toks, 24, lengths=lengths)
    if not np.array_equal(sd, ar):
        raise AssertionError("reference: greedy SD != greedy AR on the card")
    log(f"reference: reduced fp32 logits CUDA vs CPU max err {err:.2e} (<= 1e-3); "
        "greedy SD == greedy AR (4 rows x 24 tokens)")


def _to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, dev) for v in tree]
    return tree.to(dev)


# --------------------------------------------------------------------- serve
def serve_phase(seed: int):
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import prompt_batch
    from repro_torch.kernels.gmm import ragged
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import ServingEngine

    cfg = get_config("qwen2-57b-a14b").with_overrides(num_layers=LAYERS)
    dcfg = get_config("qwen2-0.5b")
    t0 = time.perf_counter()
    target = Model(cfg, moe_dispatch="gmm", device="cuda")
    gen = torch.Generator(device=target.device)
    params_t = target.init(gen.manual_seed(seed))
    draft = Model(dcfg, device="cuda")
    params_d = draft.init(gen.manual_seed(seed + 1))
    torch.cuda.synchronize()
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params_t))
    log(f"serve: target {cfg.name} x{LAYERS} of 28 layers ({n_bytes / 1e9:.2f} GB of "
        f"{cfg.dtype} weights), draft {dcfg.name} x{dcfg.num_layers}, init "
        f"{time.perf_counter() - t0:.1f} s")

    # the verify pass must not wait on the host for the routing
    cache = target.init_cache(8, 128)
    tok = torch.randint(3, cfg.vocab_size, (8, 64), device="cuda")
    _, cache = target.prefill(params_t, tok, cache)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        target.extend(params_t, tok[:, :5], cache)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    log("serve: a full-width verify pass ran with no host sync")
    del cache

    pb = prompt_batch(cfg.vocab_size, 16, kind="chat", seed=seed)
    moe_layers = sum(cfg.moe_pattern[l % cfg.period] for l in range(LAYERS))

    def serve(kind: str, n_requests: int, timed: bool):
        eng = ServingEngine(target, draft if kind == "model" else None,
                            params_t, params_d if kind == "model" else None,
                            max_batch=8, gamma=4, temperature=0.0,
                            proposer=kind, seed=seed, timed=timed)
        for i in range(n_requests):
            eng.submit(pb["tokens"][i][: int(pb["lengths"][i])],
                       max_new_tokens=32)
        for r in eng.run():
            sd = (f"sigma={r.stats.sigma:.3f} alpha={r.stats.alpha:.3f}"
                  if r.used_sd else "AR")
            phases = (f" propose={r.propose_time:.3f} s verify="
                      f"{r.verify_time:.3f} s reject={r.reject_time:.3f} s"
                      if timed else "")
            log(f"serve wave{' (timed round)' if timed else ''}: "
                f"proposer={r.proposer} B={r.batch}/{r.bucket} "
                f"gamma={r.gamma} dispatch={r.moe_dispatch} "
                f"{r.tokens_per_second:.2f} tok/s  {sd} rounds={r.stats.rounds} "
                f"wall={r.wall_time:.3f} s{phases}")
        return np.stack([eng.done[u].output for u in sorted(eng.done)])

    outputs, launches = {}, {}
    torch.cuda.reset_peak_memory_stats()
    for kind in ("model", "none"):
        # the path itself, default round: counts zeroed just before, read after
        ragged.reset_launch_counts()
        target.forward_count = 0
        outputs[kind] = serve(kind, 16, timed=False)
        launches[kind] = dict(ragged.LAUNCHES)
        expect = moe_layers * target.forward_count
        log(f"serve[{kind}]: {target.forward_count} target forwards x "
            f"{moe_layers} MoE layers = {expect} expected launches per kernel; "
            f"counted {launches[kind]}")
        for name, n in launches[kind].items():
            if n != expect:
                raise AssertionError(
                    f"serve[{kind}] {name}: {n} launches, expected {expect}")
        serve(kind, 8, timed=True)             # phase breakdown, not counted
    for kind, out in outputs.items():
        if out.shape != (16, 32) or out.min() < 0 or out.max() >= cfg.vocab_size:
            raise AssertionError(f"serve[{kind}]: bad outputs {out.shape}")
    agree = float((outputs["model"] == outputs["none"]).mean())
    log(f"serve: outputs (16, 32) in vocab for both proposers; SD vs AR token "
        f"agreement {agree:.3f} (bf16: not required to be exact)")
    log(f"serve: torch.cuda.max_memory_allocated() = "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
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
    reference_phase(args.seed)
    launches = serve_phase(args.seed)

    line = []
    for name, res in kernels.items():
        v = res["cases"]["verify"]
        line.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/gmm/csrc/ragged_gmm.cu",
            "replaces": TPU_SITES[name],
            # the main path is SD ("model" proposer); AR ("none") beside it
            "launches": launches["model"][name],
            "launches_by_path": {path: counts[name]
                                 for path, counts in launches.items()},
            "max_abs_err": res["max_abs_err"],
            "tol": f"rtol=atol={TOL} (tests/test_ragged_gmm.py)",
            "max_err_over_tol": res["max_err_over_tol"],
            "ms": v["kernel_ms"], "kernel_ms": v["kernel_ms"],
            "plain_ms": v["plain_ms"], "bound_ms": v["bound_ms"],
            "bound_by": v["bound_by"], "library_ms": v["library_ms"],
            "cases": res["cases"]})
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(f"card: {card}")
    log(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
