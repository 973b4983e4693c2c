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
``decode_inputs``, ``ragged_cases``), and every fp32 case of the first four,
is held against its plain PyTorch version at chip_smoke.py's tolerance and
timed as calls captured in one CUDA graph (``graph_time_ms``), beside the
PyTorch call that computes the same function where there is one
(``flash_library``: ``F.scaled_dot_product_attention``; ``torch.bmm`` with
TF32 off; ``sdpa_gathered``, ``sdpa_dense``, ``grouped_mm_library``).
The capacity cases with an operand off 16 bytes (chip_smoke's
``UNALIGNED_CAPACITY``) run on a tree with the old bodies as ``"wmma"``
(bf16) and ``"simt"`` (fp32), on one with two bodies as ``"sm90"`` with
its staged producer and ``"simt90"``; each staged case is timed again on
aligned copies of its operands (``capacity_case``).
A tree whose kernel refuses a case (a head dim or page size an older body
did not take) reports the case as refused instead of a time.  The kind
oldgmm times the ragged kernels off the bf16 TMA route (``old_routes``:
bm 16 and 128, bf16 operands TMA cannot address, fp32, 600 experts), both
products, beside the card's bound for the same work and
``torch._grouped_mm`` where it takes the call: on a tree with the old
bodies they run ``"wmma"`` (bf16) and ``"simt"`` (fp32), on one with two
bodies ``"sm90"`` (its staged producer off TMA's shapes) and ``"simt90"``.
Prints a line per (tree, case) and, last, a JSON object of the median
time of each (tree, case).  ``--only`` keeps the named kinds of case: flash,
gmm (the capacity GEMM), paged, decode (dense decode/verify), fused (ragged
gate/up), down (ragged down), oldgmm (the ragged cases off the bf16 TMA
route; only when named).  Needs an NVIDIA GPU.
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
EXTRA_KINDS = ("oldgmm",)            # run only when named in --only


def child(root: Path, label: str, kinds=KINDS) -> None:
    """Time every case of ``kinds`` with the kernels of ``root``; one JSON
    line each."""
    sys.path.insert(0, str(root / "src"))
    import torch
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
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 torch.bmm in fp32
    gen = torch.Generator(device=dev).manual_seed(0)
    res = {"max_abs_err": 0.0, "max_err_over_tol": 0.0}

    def emit(kind, case, fn, ref, tol, lib_fn, calls, **extra):
        """Hold and time one case; False when the tree's kernel refuses
        it (or the kind is not asked for)."""
        if kind not in kinds:
            return False
        rec = {"tree": label, "kernel": kind, "case": case, **extra}
        try:
            out = fn()
        except (ValueError, RuntimeError) as e:     # a body that refuses it
            print(json.dumps({**rec, "ms": None, "library_ms": None,
                              "refused": str(e).splitlines()[0]}),
                  flush=True)
            return False
        err = chip_smoke._hold(f"{label} {kind}", case, out, ref, tol, res)
        print(json.dumps({
            **rec, "ms": chip_smoke.graph_time_ms(fn, calls=calls),
            "library_ms": (chip_smoke.graph_time_ms(lib_fn, calls=calls)
                           if lib_fn else None),
            "max_abs_err": err,
            "row_scaled_err": chip_smoke.row_scaled_err(out, ref)}),
            flush=True)
        return True

    for case, (dtype_name, B, T, Hq, Hkv, D, window, cap) in \
            chip_smoke.FLASH_CASES.items():
        if "flash" not in kinds:
            continue
        dt = getattr(torch, dtype_name)
        q = torch.randn((B, T, Hq, D), generator=gen, device=dev).to(dt)
        k, v = (torch.randn((B, T, Hkv, D), generator=gen, device=dev
                            ).to(dt) for _ in range(2))
        kw = dict(window=window, logit_cap=cap)
        lib, _ = chip_smoke.flash_library(q, k, v, window, cap)
        emit("flash", case, lambda: flash.flash_attention(q, k, v, **kw),
             flash_attention_plain(q, k, v, **kw),
             chip_smoke.FLASH_TOL[dtype_name], lib, 20)
        del q, k, v, lib
    for case, spec in chip_smoke.capacity_cases().items():
        if "gmm" not in kinds:
            continue
        capacity_case(emit, gmm, gmm_capacity_ref, case, spec, gen, dev)
    for case, spec in chip_smoke.PAGED_CASES.items():
        dtype_name, _, _, _, cap = spec
        if "paged" not in kinds:
            continue
        heads = chip_smoke.PAGED_HEADS.get(case, chip_smoke.SERVE_HEADS)
        args = chip_smoke.paged_inputs(
            spec, gen, dev, heads, ps=chip_smoke.PAGED_PAGE_SIZE.get(case, 64))
        lib, _ = (chip_smoke.sdpa_gathered(*args) if cap == 0.0
                  else (None, None))
        emit("paged", case,
             lambda: paged.paged_decode_attention(*args, logit_cap=cap),
             paged_decode_attention_plain(*args, logit_cap=cap),
             chip_smoke.PAGED_TOL[dtype_name], lib, 20)
        del args, lib
        torch.cuda.empty_cache()
    for case, spec in chip_smoke.DECODE_CASES.items():
        if "decode" not in kinds:
            continue
        args = chip_smoke.decode_inputs(spec, gen, dev)
        lib, _ = chip_smoke.sdpa_dense(*args)
        emit("decode", case, lambda: dec_ops.decode_attention(*args),
             decode_attention_plain(*args), chip_smoke.DECODE_TOL[spec[0]],
             lib, 20)
        del args, lib
        torch.cuda.empty_cache()
    if not {"fused", "down", "oldgmm"} & set(kinds):
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
        emit("fused", case, lambda: ragged.fused_gate_up(xs, wg, wu, sizes),
             h, chip_smoke.TOL, None, 10)
        lib, _ = (chip_smoke.grouped_mm_library(h, wd, sizes)
                  if "down" in kinds else (None, None))
        emit("down", case, lambda: ragged.ragged_gmm(h, wd, sizes),
             ragged_gmm_ref(h, wd, sizes), chip_smoke.TOL, lib, 10)
        del xs, h, lib
    del wg, wu, wd
    torch.cuda.empty_cache()
    if "oldgmm" in kinds:
        old_routes(emit, gen, dev)


def capacity_case(emit, gmm, gmm_capacity_ref, case, spec, gen, dev) -> None:
    """One capacity GEMM case beside its bound and ``torch.bmm``.  Each
    tree checks its own (route, producer): one with four bodies runs an
    operand off 16 bytes on ``"wmma"`` (bf16) or ``"simt"`` (fp32), one
    with two bodies on ``"sm90"`` with its staged producer or ``"simt90"``
    (chip_smoke.capacity_route).  A staged case is timed again with its
    operands copied to 16-byte aligned bases (``*_aligned``: the TMA
    producer on the same values)."""
    import torch
    dtype_name, E, C, Din, Dout = spec
    dt = getattr(torch, dtype_name)
    x, w = chip_smoke.capacity_inputs(case, spec, gen, dev)
    unaligned = case in chip_smoke.UNALIGNED_CAPACITY
    want = chip_smoke.capacity_route(case, dtype_name)
    if not hasattr(gmm, "LAST_PRODUCER"):          # the four-body tree
        want = (("wmma" if dt == torch.bfloat16 else "simt") if unaligned
                else want[0], None)
    b_ms, b_by = chip_smoke.bound_ms(
        (x.numel() + w.numel() + E * C * Dout) * x.element_size(),
        2 * E * C * Din * Dout,
        chip_smoke.BF16_FLOPS if dt == torch.bfloat16 else chip_smoke.FP32_FLOPS)
    ref = gmm_capacity_ref(x, w)
    tol = chip_smoke.GMM_TOL[dtype_name]
    calls = 10 if dt == torch.bfloat16 else 3
    if emit("gmm", case, lambda: gmm.gmm_capacity(x, w), ref, tol,
            lambda: torch.bmm(x, w), calls, bound_ms=b_ms, bound_by=b_by,
            route="/".join(filter(None, want))):
        got = (gmm.LAST_ROUTE["gmm_capacity"],
               getattr(gmm, "LAST_PRODUCER", {}).get("gmm_capacity"))
        if got != want:
            raise AssertionError(f"gmm [{case}]: ran {got}, expected {want}")
    if unaligned and dt == torch.bfloat16:
        xa, wa = x.clone(), w.clone()
        emit("gmm", f"{case}_aligned", lambda: gmm.gmm_capacity(xa, wa), ref,
             tol, None, calls, bound_ms=b_ms, bound_by=b_by, route="sm90/tma")
        del xa, wa
    del x, w, ref
    torch.cuda.empty_cache()


def old_routes(emit, gen, dev) -> None:
    """Kernels 1-2 off the bf16 TMA route: chip_smoke.py's
    RAGGED_BODY_CASES (bm 16 and 128, x 2 bytes off 16 and f 2564 in bf16,
    fp32 aligned and 4 bytes off, at qwen2-57b-a14b's widths), 600 experts
    at narrow widths in both dtypes, and fp32 at a test shape whose D pitch
    is 280 bytes; both products, each beside its bound (each operand read
    once: x, the weights of the experts that hold rows, the output written
    once; 2 N K F FLOPs a product at the dtype's peak) and
    ``torch._grouped_mm`` where it takes the call; a bf16 case whose x is
    off 16 bytes again with x aligned (``*_aligned``: the TMA producer on
    the same routing).  Each tree checks its own routes: one with the old
    bodies runs ``"wmma"`` (bf16) and ``"simt"`` (fp32), one with two
    bodies the (body, producer) each case names."""
    import torch
    from repro_torch.kernels.gmm import ragged
    from repro_torch.kernels.gmm.ref import fused_gate_up_ref, ragged_gmm_ref
    two_bodies = hasattr(ragged, "LAST_PRODUCER")
    cases = chip_smoke.ragged_body_case_list(gen, dev)

    def test_shape():                 # x's row pitch 280 bytes, fp32
        sizes = torch.tensor([37, 0, 1, 129, 0, 77, 13, 200],
                             dtype=torch.int32, device=dev)
        xs = torch.randn((int(sizes.sum()), 70), generator=gen, device=dev)
        return xs, chip_smoke._ragged_weights(8, 70, 96, torch.float32,
                                              gen), sizes
    cases.append(("fp32_pitch280_test_shape", None, ("simt90", None),
                  test_shape))
    for case, bm, want, make in cases:
        xs, (wg, wu, wd), sizes = make()
        N, D = xs.shape
        E, _, F = wg.shape
        f32 = xs.dtype == torch.float32
        if not two_bodies:
            want = ("simt", None) if f32 else ("wmma", None)
        peak = chip_smoke.FP32_FLOPS if f32 else chip_smoke.BF16_FLOPS
        tol = chip_smoke.RAGGED_F32_TOL if f32 else chip_smoke.TOL
        el = xs.element_size()
        active = int((sizes > 0).sum())
        h = fused_gate_up_ref(xs, wg, wu, sizes)
        h = chip_smoke._offset(h, xs.data_ptr() % 16 // el)
        for name, fn, ref, n_bytes, flops, lib in (
                ("fused",
                 lambda: ragged.fused_gate_up(xs, wg, wu, sizes, bm=bm), h,
                 (N * D + 2 * active * D * F + N * F) * el + 4 * E,
                 4 * N * D * F, None),
                ("down", lambda: ragged.ragged_gmm(h, wd, sizes, bm=bm),
                 ragged_gmm_ref(h, wd, sizes),
                 (N * F + active * F * D + N * D) * el + 4 * E,
                 2 * N * F * D, chip_smoke.grouped_mm_library(h, wd, sizes)[0])):
            b_ms, b_by = chip_smoke.bound_ms(n_bytes, flops, peak)
            kernel = "fused_gate_up" if name == "fused" else "ragged_gmm"
            if not emit("oldgmm", f"{name}_{case}", fn, ref, tol, lib,
                        3 if f32 else 5, bound_ms=b_ms, bound_by=b_by,
                        rows=N, route="/".join(filter(None, want))):
                continue
            got = (ragged.LAST_ROUTE[kernel],
                   getattr(ragged, "LAST_PRODUCER", {}).get(kernel))
            if got != want:
                raise AssertionError(f"oldgmm {name} [{case}]: ran {got}, "
                                     f"expected {want}")
        if xs.data_ptr() % 16 and not f32:
            # the same routing with x (and h) 16-byte aligned: the TMA
            # producer's time beside the staged one's
            xa, ha = xs.clone(), h.clone()
            emit("oldgmm", f"fused_{case}_aligned",
                 lambda: ragged.fused_gate_up(xa, wg, wu, sizes), h, tol, None, 5,
                 route="sm90/tma")
            emit("oldgmm", f"down_{case}_aligned", lambda: ragged.ragged_gmm(ha, wd, sizes),
                 ragged_gmm_ref(ha, wd, sizes), tol, None, 5, route="sm90/tma")
            del xa, ha
        del xs, wg, wu, wd, h
    cases.clear()
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
    if set(kinds) - set(KINDS + EXTRA_KINDS):
        ap.error(f"--only takes kinds from {KINDS + EXTRA_KINDS}")
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
            if "refused" in rec:
                print(f"{rec['tree']:24s} {rec['kernel']:6s} "
                      f"{rec['case']:18s} refused: {rec['refused']}",
                      flush=True)
            else:
                bound = (f"  bound {rec['bound_ms']:.4f} ms "
                         f"({rec['bound_by']}) route={rec['route']}"
                         if "bound_ms" in rec else "")
                print(f"{rec['tree']:24s} {rec['kernel']:6s} "
                      f"{rec['case']:18s} {chip_smoke._fmt(rec['ms'])}  "
                      f"library {chip_smoke._fmt(lib)}{bound}  max err "
                      f"{rec['max_abs_err']:.3g}, "
                      f"{rec['row_scaled_err']:.3g} x row rms", flush=True)
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
