#!/usr/bin/env python3
"""Time the port's hand-written kernels on the device alone, for one or more
source trees in turns, so that two versions of a kernel are compared in one
run on one card.

    python3 kernel_ab.py ROOT [ROOT ...] [--only KIND[,KIND ...]]

Each ROOT is a directory holding ``src/repro_torch``: this checkout (``.``)
or another commit unpacked with ``git archive`` into an ignored directory
of it, e.g. the parent:

    mkdir -p build/parent && git archive HEAD~1 | tar -x -C build/parent
    python3 kernel_ab.py build/parent .

The trees run in the order given, then in reverse (A B B A for two trees),
each in a process of its own that builds its kernels into
``ROOT/build/kernels``.  The cases, inputs, bounds and timing are
chip_smoke.py's: every bf16 case of its flash, capacity, paged, dense
decode and ragged phases (``FLASH_CASES``, ``capacity_cases``,
``PAGED_CASES`` through ``paged_inputs``, ``DECODE_CASES`` through
``decode_inputs``, ``ragged_cases``) is held against its plain PyTorch
version at chip_smoke.py's tolerance and timed as calls captured in one CUDA
graph (``graph_time_ms``), beside the PyTorch call that computes the same
function where there is one (``F.scaled_dot_product_attention``,
``torch.bmm``, ``sdpa_gathered``, ``sdpa_dense``, ``grouped_mm_library``).
Prints a line per (tree, case) and, last, a JSON object of the median time
of each (tree, case).  ``--only`` keeps the named kinds of case: flash, gmm
(the capacity GEMM), paged, decode (dense decode/verify), fused (ragged
gate/up), down (ragged down).  Needs an NVIDIA GPU.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import chip_smoke


KINDS = ("flash", "gmm", "paged", "decode", "fused", "down")


def child(root: Path, label: str, kinds=KINDS) -> None:
    """Time every case of ``kinds`` with the kernels of ``root``; one JSON
    line each."""
    sys.path.insert(0, str(root / "src"))
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as flash
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.decode_attention import paged
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_plain, paged_decode_attention_plain)
    from repro_torch.kernels.gmm import gmm, ragged
    from repro_torch.kernels.gmm.ref import (fused_gate_up_ref,
                                             gmm_capacity_ref, ragged_gmm_ref)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    res = {"max_abs_err": 0.0, "max_err_over_tol": 0.0}

    def emit(kind, case, out, ref, tol, fn, lib_fn, calls):
        if kind not in kinds:
            return
        err = chip_smoke._hold(f"{label} {kind}", case, out, ref, tol, res)
        print(json.dumps({
            "tree": label, "kernel": kind, "case": case,
            "ms": chip_smoke.graph_time_ms(fn, calls=calls),
            "library_ms": (chip_smoke.graph_time_ms(lib_fn, calls=calls)
                           if lib_fn else None),
            "max_abs_err": err,
            "row_scaled_err": chip_smoke.row_scaled_err(out, ref)}),
            flush=True)

    for case, (dtype_name, B, T, Hq, Hkv, D, window, cap) in \
            chip_smoke.FLASH_CASES.items():
        if dtype_name != "bfloat16" or "flash" not in kinds:
            continue
        q = torch.randn((B, T, Hq, D), generator=gen, device=dev).bfloat16()
        k, v = (torch.randn((B, T, Hkv, D), generator=gen, device=dev
                            ).bfloat16() for _ in range(2))
        kw = dict(window=window, logit_cap=cap)
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        lib = None                 # SDPA has no tanh cap of its own
        if window == 0 and cap == 0.0:
            def lib():
                return F.scaled_dot_product_attention(
                    qh, kh, vh, is_causal=True, enable_gqa=True)
        emit("flash", case, flash.flash_attention(q, k, v, **kw),
             flash_attention_plain(q, k, v, **kw),
             chip_smoke.FLASH_TOL[dtype_name],
             lambda: flash.flash_attention(q, k, v, **kw), lib, 20)
        del q, k, v, qh, kh, vh
    for case, (dtype_name, E, C, K, Fo) in chip_smoke.capacity_cases().items():
        if dtype_name != "bfloat16" or "gmm" not in kinds:
            continue
        x = torch.randn((E, C, K), generator=gen, device=dev).bfloat16()
        w = (torch.randn((E, K, Fo), generator=gen, device=dev) / K ** 0.5
             ).bfloat16()
        emit("gmm", case, gmm.gmm_capacity(x, w), gmm_capacity_ref(x, w),
             chip_smoke.GMM_TOL[dtype_name], lambda: gmm.gmm_capacity(x, w),
             lambda: torch.bmm(x, w), 10)
        del x, w
        torch.cuda.empty_cache()
    for case, spec in chip_smoke.PAGED_CASES.items():
        dtype_name, _, _, _, cap = spec
        if dtype_name != "bfloat16" or "paged" not in kinds:
            continue
        args = chip_smoke.paged_inputs(spec, gen, dev)
        lib, _ = (chip_smoke.sdpa_gathered(*args) if cap == 0.0
                  else (None, None))
        emit("paged", case, paged.paged_decode_attention(*args, logit_cap=cap),
             paged_decode_attention_plain(*args, logit_cap=cap),
             chip_smoke.PAGED_TOL[dtype_name],
             lambda: paged.paged_decode_attention(*args, logit_cap=cap), lib,
             20)
        del args, lib
        torch.cuda.empty_cache()
    for case, spec in chip_smoke.DECODE_CASES.items():
        if spec[0] != "bfloat16" or "decode" not in kinds:
            continue
        args = chip_smoke.decode_inputs(spec, gen, dev)
        lib, _ = chip_smoke.sdpa_dense(*args)
        emit("decode", case, dec_ops.decode_attention(*args),
             decode_attention_plain(*args), chip_smoke.DECODE_TOL[spec[0]],
             lambda: dec_ops.decode_attention(*args), lib, 20)
        del args, lib
        torch.cuda.empty_cache()
    if not {"fused", "down"} & set(kinds):
        return
    from repro_torch.configs.registry import get_config
    cfg = get_config("qwen2-57b-a14b")
    E, K, D, Fd = (cfg.num_experts, cfg.num_experts_per_tok, cfg.d_model,
                   cfg.moe_d_ff)
    wg, wu = ((torch.randn((E, D, Fd), generator=gen, device=dev) / D ** 0.5
               ).bfloat16() for _ in range(2))
    wd = (torch.randn((E, Fd, D), generator=gen, device=dev) / Fd ** 0.5
          ).bfloat16()
    for case, sizes in chip_smoke.ragged_cases(E, K, gen, dev).items():
        xs = torch.randn((int(sizes.sum()), D), generator=gen, device=dev
                         ).bfloat16()
        h = fused_gate_up_ref(xs, wg, wu, sizes)
        if "fused" in kinds:
            emit("fused", case, ragged.fused_gate_up(xs, wg, wu, sizes), h,
                 chip_smoke.TOL,
                 lambda: ragged.fused_gate_up(xs, wg, wu, sizes), None, 10)
        lib, _ = chip_smoke.grouped_mm_library(h, wd, sizes)
        emit("down", case, ragged.ragged_gmm(h, wd, sizes),
             ragged_gmm_ref(h, wd, sizes), chip_smoke.TOL,
             lambda: ragged.ragged_gmm(h, wd, sizes), lib, 10)
        del xs, h, lib
    del wg, wu, wd
    torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="*", type=Path)
    ap.add_argument("--only", default=",".join(KINDS),
                    help="comma-separated kinds of case (default: all)")
    ap.add_argument("--child", nargs=2, metavar=("ROOT", "LABEL"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    kinds = tuple(args.only.split(","))
    if set(kinds) - set(KINDS):
        ap.error(f"--only takes kinds from {KINDS}")
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    if args.child:
        child(Path(args.child[0]).resolve(), args.child[1], kinds)
        return 0
    if not args.roots:
        ap.error("give at least one source tree")
    for root in args.roots:
        if not (root / "src" / "repro_torch").is_dir():
            ap.error(f"{root} holds no src/repro_torch")
    card = chip_smoke.card_line()
    print(f"card: {card}", flush=True)
    order = [str(r) for r in args.roots]
    order += order[::-1]
    times = {}
    for label in order:
        proc = subprocess.run([sys.executable, __file__, "--child", label,
                               label, "--only", args.only],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        for line in proc.stdout.splitlines():
            if not line.startswith("{"):
                continue
            rec = json.loads(line)
            lib = rec["library_ms"]
            print(f"{rec['tree']:24s} {rec['kernel']:6s} {rec['case']:18s} "
                  f"{chip_smoke._fmt(rec['ms'])}  library "
                  f"{chip_smoke._fmt(lib)}  max err {rec['max_abs_err']:.3g}"
                  f", {rec['row_scaled_err']:.3g} x row rms", flush=True)
            key = f"{rec['tree']}|{rec['kernel']}|{rec['case']}"
            times.setdefault(key, {"ms": [], "library_ms": []})
            times[key]["ms"].append(rec["ms"])
            times[key]["library_ms"].append(rec["library_ms"])
    def median(xs):
        return None if None in xs else statistics.median(xs)
    print(json.dumps({"card": card, "median_ms": {
        k: {"ms": median(v["ms"]), "library_ms": median(v["library_ms"])}
        for k, v in times.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
