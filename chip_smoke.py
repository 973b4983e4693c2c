#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed N]

Phases, each of which fails the run if it fails:

  1. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
  2. build every CUDA kernel of the path from the sources in this checkout,
     one nvcc per source, all at once;
  3. kernels: at the main paths' shapes, run each kernel and its plain
     PyTorch version on the same inputs made from --seed, hold them within
     the stated tolerance and time both beside the card's bound:
       * the ragged expert-FFN kernels (SD verify: 320 routed rows, top-8 of
         64 experts; AR verify: 64 rows; prefill: 4096 rows; empty experts
         with unaligned groups), bf16, rtol = atol = 3e-2
         (tests/test_ragged_gmm.py);
       * the paged decode/verify attention kernel (28 query / 4 KV heads,
         pages of 64, noise in every page, a permuted table, ragged
         lengths): SD verify (B 8, T 5), AR verify (T 1), long context
         (~8k positions), logit cap 30, head dims 64 and 256, bf16 at
         rtol = atol = 2e-2; SD verify and long context also in fp32 at
         2e-5 (the reference's bound,
         src/repro/kernels/decode_attention/decode_attention.py:288);
  4. reference: on the reduced qwen2-57b-a14b in fp32, the CUDA path agrees
     with the port's plain CPU path (which the CPU tests hold against the JAX
     reference) and greedy SD equals greedy AR; a continuous paged stream
     (6 requests, Poisson arrivals, one late long prompt that grows the
     session) emits the same tokens on the card as on the CPU, and SD the
     same as AR;
  5. serve: qwen2-57b-a14b at its full published width, depth cut to LAYERS
     of 28, with the full qwen2-0.5b draft and random weights from --seed,
     greedy, gamma 4, max-batch 8, each path first with the "model"
     proposer (SD), then "none" (AR):
       * ServingEngine(scheduler="wave"): 16 requests, max-new 32, with the
         default (untimed) round; one more wave per proposer runs the timed
         round for the propose/verify/reject breakdown and is not counted;
       * ServingEngine(scheduler="continuous", kv_layout="paged",
         page_size=64): 16 chat prompts with Poisson arrivals (0.5 per
         round, max-new 8/16/32) plus a 700-token prompt at round 6 that
         grows the page pool mid-stream.
     Each path runs with every launch count set to 0 just before it and
     read just after: each gmm kernel's count must equal (MoE layers x that
     path's target forwards), and on the continuous paths the paged
     kernel's must equal (attention layers x rounds).

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
FP32_FLOPS = 67e12                 # fp32 outside the tensor cores, published
TOL = 3e-2                         # rtol and atol, tests/test_ragged_gmm.py
# paged attention: bf16 output rounding; fp32 the reference's own bound
PAGED_TOL = {"bfloat16": 2e-2, "float32": 2e-5}
# Target depth at full width: the bf16 weights of all 28 layers (57.4B
# parameters, ~115 GB) do not fit in the card's 80 GB; 4 layers are ~18 GB.
LAYERS = 4
TPU_SITES = {                      # the Pallas kernel each CUDA kernel replaces
    "fused_gate_up": "src/repro/kernels/gmm/ragged.py:124",    # _fused_kernel
    "ragged_gmm": "src/repro/kernels/gmm/ragged.py:104",       # _ragged_kernel
    # _paged_decode_kernel
    "paged_decode_attention":
        "src/repro/kernels/decode_attention/decode_attention.py:78",
}
SOURCES = {
    "fused_gate_up": "src/repro_torch/kernels/gmm/csrc/ragged_gmm.cu",
    "ragged_gmm": "src/repro_torch/kernels/gmm/csrc/ragged_gmm.cu",
    "paged_decode_attention":
        "src/repro_torch/kernels/decode_attention/csrc/"
        "paged_decode_attention.cu",
}
PATHS = ("wave/model", "wave/none", "continuous/model", "continuous/none")


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


def bound_ms(bytes_moved: float, flops: float, peak: float = BF16_FLOPS):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# --------------------------------------------------------------------- build
def build_kernels():
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attention import paged
    from repro_torch.kernels.gmm import ragged
    sources = (ragged.SOURCE, paged.SOURCE)
    t0 = time.perf_counter()
    build.build_all(sources)
    for src in sources:
        build.load(src)
    log(f"build: {time.perf_counter() - t0:.1f} s -> " + ", ".join(
        str(build.library_path(src).relative_to(ROOT)) for src in sources))


def reset_launch_counts():
    from repro_torch.kernels.decode_attention import paged
    from repro_torch.kernels.gmm import ragged
    ragged.reset_launch_counts()
    paged.reset_launch_counts()


def launch_counts() -> dict:
    from repro_torch.kernels.decode_attention import paged
    from repro_torch.kernels.gmm import ragged
    return {**ragged.LAUNCHES, **paged.LAUNCHES}


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


PAGED_CASES = {        # name: (dtype, T, head dim, (min, max) length, cap)
    "sd_verify": ("bfloat16", 5, 128, (16, 130), 0.0),
    "ar_verify": ("bfloat16", 1, 128, (16, 130), 0.0),
    "long_context": ("bfloat16", 5, 128, (8000, 8192), 0.0),
    "capped": ("bfloat16", 5, 128, (16, 130), 30.0),
    "head_dim_64": ("bfloat16", 5, 64, (16, 130), 0.0),
    "head_dim_256": ("bfloat16", 5, 256, (16, 130), 0.0),
    "fp32_sd_verify": ("float32", 5, 128, (16, 130), 0.0),
    # the bf16 bound is near a typical |out| (~0.02) at ~8k keys, so the
    # long page walk is also held at the fp32 bound
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


def paged_kernel_phase(seed: int):
    """The paged decode/verify kernel against its plain version at the
    serve widths (28 query / 4 KV heads, pages of 64)."""
    import torch
    from repro_torch.kernels.decode_attention import paged
    from repro_torch.kernels.decode_attention.ref import \
        paged_decode_attention_plain

    dev = torch.device("cuda")
    B, Hq, Hkv, ps = 8, 28, 4, 64
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    res = {"cases": {}, "max_abs_err": 0.0, "max_err_over_tol": 0.0}
    for case, (dtype_name, T, D, (lo, hi), cap) in PAGED_CASES.items():
        dt = getattr(torch, dtype_name)
        MP = -(-(hi + T) // ps) + 1
        NP = B * MP + 1                                    # page 0 = trash
        # noise in every physical page, trash page included
        kp = torch.randn((NP, ps, Hkv, D), generator=gen, device=dev).to(dt)
        vp = torch.randn((NP, ps, Hkv, D), generator=gen, device=dev).to(dt)
        table = (torch.randperm(NP - 1, generator=gen, device=dev) + 1
                 ).reshape(B, MP).to(torch.int32)
        lengths = torch.randint(lo, hi + 1, (B,), generator=gen,
                                device=dev).to(torch.int32)
        q = torch.randn((B, T, Hq, D), generator=gen, device=dev).to(dt)
        args = (q, kp, vp, lengths, table)
        out = paged.paged_decode_attention(*args, logit_cap=cap)
        ref = paged_decode_attention_plain(*args, logit_cap=cap)
        torch.cuda.synchronize()
        tol = PAGED_TOL[dtype_name]
        err = (out.float() - ref.float()).abs()
        over = err / (tol + tol * ref.float().abs())
        if not torch.isfinite(out).all() or (over > 1).any():
            raise AssertionError(
                f"paged_decode_attention [{case}]: kernel disagrees with its "
                f"plain version (max abs err {err.max().item():.4g}, "
                f"{int((over > 1).sum())} elements outside rtol=atol={tol})")
        res["max_abs_err"] = max(res["max_abs_err"], err.max().item())
        res["max_err_over_tol"] = max(res["max_err_over_tol"],
                                      over.max().item())
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
        res["cases"][case] = dict(
            dtype=dtype_name, B=B, T=T, head_dim=D, page_size=ps,
            lengths=[int(n) for n in lengths.tolist()], keys=keys,
            pages_touched=touched,
            kernel_ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            bytes=n_bytes, library_ms=None,
            library="no single call walks a block table",
            sdpa_gathered_ms=sdpa_ms, sdpa_gathered=sdpa_label,
            max_abs_err=err.max().item(), tol=tol)
        log(f"kernel paged_decode_attention [{case:14s}] {dtype_name} T={T} "
            f"D={D} keys={keys:5d} pages={touched:4d}  {ms:.4f} ms  "
            f"plain {plain_ms:.3f} ms  "
            f"bound {b_ms:.4f} ms ({b_by})  sdpa "
            f"{'-' if sdpa_ms is None else f'{sdpa_ms:.4f} ms'} "
            f"({sdpa_label})  max err {err.max().item():.3g}")
        del kp, vp, q, out, ref
    torch.cuda.empty_cache()
    return res


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
    log(f"reference: reduced fp32 logits CUDA vs CPU max err {err:.2e} (<= 1e-3); "
        "greedy SD == greedy AR (4 rows x 24 tokens)")

    # continuous paged stream: card vs CPU, SD vs AR
    streams = {}
    for dev, tm, pt, pd in (("cpu", cpu, p_cpu, pd_cpu),
                            ("cuda", gpu, p_gpu, pd_gpu)):
        for kind in ("model", "none"):
            if dev == "cuda":
                reset_launch_counts()
            streams[dev, kind] = continuous_stream(
                cfg, tm, pt, drafts[dev], pd, kind, seed)
            if dev == "cuda" and not launch_counts()["paged_decode_attention"]:
                raise AssertionError("reference: the continuous paged stream "
                                     "never launched the paged kernel")
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
        f"growths {base['growths']}, {base['rounds']} SD rounds): card == CPU "
        "and SD == AR, token for token")


def continuous_stream(cfg, target, params_t, draft, params_d, kind: str,
                      seed: int) -> dict:
    """The reduced continuous paged stream: 5 Poisson arrivals with mixed
    budgets and one late long prompt that forces a session growth."""
    import numpy as np
    from repro_torch.data.pipeline import prompt_batch
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.scheduler import submit_poisson
    eng = ServingEngine(target, draft if kind == "model" else None, params_t,
                        params_d if kind == "model" else None,
                        scheduler="continuous", kv_layout="paged",
                        page_size=16, max_batch=4, gamma=4, proposer=kind,
                        seed=seed)
    pb = prompt_batch(cfg.vocab_size, 5, seed=seed, min_len=5, max_len=24)
    submit_poisson(eng, pb["tokens"], pb["lengths"], rate=0.5,
                   max_new_choices=(4, 8, 12), seed=seed)
    long = np.random.default_rng(seed).integers(3, cfg.vocab_size, 150)
    eng.submit(long, max_new_tokens=8, arrival_round=3)
    (rep,) = eng.run()
    return {"outputs": {u: (r.finish_reason, r.output)
                        for u, r in eng.done.items()},
            "growths": eng.session_stats()[kind]["growths"],
            "rounds": rep.stats.rounds}


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
    long_prompt = np.random.default_rng(seed).integers(3, cfg.vocab_size, 700)
    moe_layers = sum(cfg.moe_pattern[l % cfg.period] for l in range(LAYERS))
    attn_layers = LAYERS                        # every layer is "attn"

    def engine(kind: str, timed: bool, **kw):
        return ServingEngine(target, draft if kind == "model" else None,
                             params_t, params_d if kind == "model" else None,
                             max_batch=8, gamma=4, temperature=0.0,
                             proposer=kind, seed=seed, timed=timed, **kw)

    def wave(kind: str, n_requests: int, timed: bool):
        eng = engine(kind, timed)
        for i in range(n_requests):
            eng.submit(pb["tokens"][i][: int(pb["lengths"][i])],
                       max_new_tokens=32)
        rounds = 0
        for r in eng.run():
            rounds += r.stats.rounds
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
        out = np.stack([eng.done[u].output for u in sorted(eng.done)])
        if out.shape != (n_requests, 32) or out.min() < 0 \
                or out.max() >= cfg.vocab_size:
            raise AssertionError(f"serve wave[{kind}]: bad outputs {out.shape}")
        return out, rounds

    def continuous(kind: str):
        eng = engine(kind, False, scheduler="continuous", kv_layout="paged",
                     page_size=64)
        submit_poisson(eng, pb["tokens"], pb["lengths"], rate=0.5,
                       max_new_choices=(8, 16, 32), seed=seed)
        eng.submit(long_prompt, max_new_tokens=16, arrival_round=6)
        (r,) = eng.run()
        sd = (f"sigma={r.stats.sigma:.3f} alpha={r.stats.alpha:.3f}"
              if r.used_sd else "AR")
        occ = occupancy_timeline([s.live for s in r.steps],
                                 [s.committed for s in r.steps])
        stats = eng.session_stats()[kind]
        log(f"serve continuous paged: proposer={r.proposer} "
            f"requests={r.batch} pool={r.bucket} gamma={r.gamma} "
            f"{r.tokens_per_second:.2f} tok/s  {sd} rounds={r.stats.rounds} "
            f"tokens={r.tokens_out} wall={r.wall_time:.3f} s")
        log(f"  N(t): peak={occ['peak_live']:.0f} mean={occ['mean_live']:.2f} "
            f"token_weighted={occ['token_weighted_live']:.2f} "
            f"occupancy={occ['mean_occupancy']:.2f}  "
            f"admitted={sum(s.admitted for s in r.steps)} "
            f"retired={sum(s.retired for s in r.steps)}")
        log(f"  admission: {sum(s.admit_rows for s in r.steps)} prefill rows, "
            f"{sum(s.admit_tokens for s in r.steps)} row-tokens (sliced); "
            f"admit traces {stats['admit_traces']}; growths {stats['growths']}")
        reasons = {eng.done[u].finish_reason for u in eng.done}
        if len(eng.done) != 17 or reasons != {"length"}:
            raise AssertionError(f"serve continuous[{kind}]: {len(eng.done)} "
                                 f"requests finished {reasons}")
        if not stats["growths"]:
            raise AssertionError(f"serve continuous[{kind}]: the 700-token "
                                 "prompt did not grow the page pool")
        eng._slot_scheduler._alloc.assert_no_leaks()
        return {u: eng.done[u].output for u in eng.done}, r.stats.rounds

    outputs, launches = {}, {}
    torch.cuda.reset_peak_memory_stats()
    for path in PATHS:
        sched, kind = path.split("/")
        # the path itself: every count zeroed just before, read just after
        reset_launch_counts()
        target.forward_count = 0
        if sched == "wave":
            outputs[path], rounds = wave(kind, 16, timed=False)
        else:
            outputs[path], rounds = continuous(kind)
        launches[path] = launch_counts()
        expect = {"fused_gate_up": moe_layers * target.forward_count,
                  "ragged_gmm": moe_layers * target.forward_count,
                  "paged_decode_attention":
                      attn_layers * rounds if sched == "continuous" else 0}
        log(f"serve[{path}]: {target.forward_count} target forwards, {rounds} "
            f"rounds; launches counted {launches[path]}, expected {expect}")
        if launches[path] != expect:
            raise AssertionError(f"serve[{path}]: launches {launches[path]} "
                                 f"!= expected {expect}")
        if sched == "wave":
            wave(kind, 8, timed=True)           # phase breakdown, not counted
    for sched in ("wave", "continuous"):
        a, b = outputs[f"{sched}/model"], outputs[f"{sched}/none"]
        if sched == "continuous":
            a, b = (np.concatenate([a[u] for u in sorted(a)]),
                    np.concatenate([b[u] for u in sorted(b)]))
        agree = float((a == b).mean()) if a.shape == b.shape else 0.0
        log(f"serve {sched}: SD vs AR token agreement {agree:.3f} (bf16: not "
            "required to be exact)")
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
    kernels["paged_decode_attention"] = paged_kernel_phase(args.seed)
    reference_phase(args.seed)
    launches = serve_phase(args.seed)

    line = []
    for name, res in kernels.items():
        paged = name == "paged_decode_attention"
        v = res["cases"]["sd_verify" if paged else "verify"]
        line.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": TPU_SITES[name],
            # the main path: continuous paged SD for the paged kernel, wave
            # SD for the gmm kernels; every path beside it
            "launches": launches["continuous/model" if paged
                                 else "wave/model"][name],
            "launches_by_path": {path: counts[name]
                                 for path, counts in launches.items()},
            "max_abs_err": res["max_abs_err"],
            "tol": ("bf16 rtol=atol=2e-2, fp32 2e-5 (decode_attention.py:288)"
                    if paged else f"rtol=atol={TOL} (tests/test_ragged_gmm.py)"),
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
