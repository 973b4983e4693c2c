#!/usr/bin/env python3
"""Build patched copies of this checkout's kernel sources and measure them
on the card: faults that a tolerance must catch, and the tile and split
choices of the TMA + wgmma kernels.

    python3 kernel_variants.py mutants
    python3 kernel_variants.py tune NAME [NAME ...]

Each variant is this checkout's ``src/repro_torch`` copied to the ignored
``build/variants/NAME`` with the text replacements of ``VARIANTS`` applied
(each must match exactly once, so a variant that no longer fits the sources
fails instead of measuring the unpatched kernel); it builds its kernels into
its own ``build/kernels``.

``mutants`` runs every bf16 case of chip_smoke.py's paged and dense decode
phases (``PAGED_CASES`` through ``paged_inputs``, ``DECODE_CASES`` through
``decode_inputs``; the dense decode's fp32 cases at head dim 256 too, which
attention_tile's CUDA-core body runs) and of its ragged phase (the fused gate/up and down
kernels on ``ragged_cases``), same seeds, through this tree and each
``FAULTS`` variant, and prints, per case, the largest elementwise error
over the kernel's tolerance (``PAGED_TOL``, ``DECODE_TOL``, ``TOL``) and,
for the attention kernels, the largest error over the rms of its output row
over its row bound (``PAGED_ROW_TOL``, ``DECODE_ROW_TOL``); above 1 fails
chip_smoke.py (a non-finite output counts as infinitely far; an fp32 case
has no row bound).  Then one JSON line.  It exits non-zero unless every
fault is caught in each case ``FAULT_CASES`` names for it: a bf16 attention
fault by the row bound (the TMA + wgmma bodies' faults at long context,
the head-dim-256 bodies' at gemma's heads and lengths), an fp32 one and a
ragged one by the tolerance (ragged at every serving case: SD verify, AR
verify, prefill); and this tree passes every bound everywhere.

``tune`` times the named ``TUNING`` variants against this tree with
kernel_ab.py (this tree first, A B ... B A), on the cases of the kernels
they change (``TUNE_KINDS`` by the name's prefix).  Needs an NVIDIA GPU.
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PAGED = "kernels/decode_attention/csrc/paged_sm90.cuh"
DECODE = "kernels/decode_attention/csrc/decode_sm90.cuh"
SPLITKV = "kernels/csrc/splitkv_sm90.cuh"
FLASH = "kernels/flash_attention/csrc/flash_sm90.cuh"
RAGGED = "kernels/gmm/csrc/ragged_sm90.cuh"
TILE = "kernels/csrc/attention_tile.cuh"

FAULTS = {
    # the combine step (shared by the paged and dense bodies) leaves out the
    # last live split of every row
    "dropped_split": [(SPLITKV, "for (int s = 0; s < live; ++s) {\n"
                                "      const long long at",
                       "for (int s = 0; s < live - 1; ++s) {\n"
                       "      const long long at")],
    # chunk 5 of every split is loaded from chunk 4's keys again (stale)
    "paged_stale_chunk": [(PAGED, "const int lk = kb + j * per;",
                           "const int lk = (i == 5 ? kb - BK : kb) + j * per;")],
    "decode_stale_chunk": [(DECODE, "map, bar, 64 * c, h, kb, b);",
                            "map, bar, 64 * c, h, i == 5 ? kb - BK : kb, b);")],
    # the fused kernel loads Wu's tile from Wg's map (computes act(g) * g)
    "fused_wu_from_wg_map": [(RAGGED, "m == 0 ? &wmap : &umap", "&wmap")],
    # the epilogue (shared by both ragged products) stores 8 rows past the
    # expert's end, over the next expert's first rows (never past N)
    "ragged_rows_past_end": [(RAGGED, "if (r < w.row_end && c < F) {",
                              "if (r < min(w.row_end + 8, off[E]) && c < F) {")],
    # attention_tile's body (dense decode's at head dim 256 in fp32, and in
    # bf16 with more than 64 rows a KV head) skips its last key chunk
    "tile_last_chunk": [(TILE, "for (int kbase = kstart; kbase < kend; "
                               "kbase += BK) {",
                         "for (int kbase = kstart; kbase + BK < kend; "
                         "kbase += BK) {")],
    # every split of the paged split-KV body (at every head dim) that holds
    # more than one chunk skips its last
    "paged_last_chunk": [(PAGED, "const int n_chunks = min(p.cps, (last - k0) "
                                 "/ BK + 1);",
                          "const int n_chunks = max(1, min(p.cps, (last - k0) "
                          "/ BK + 1) - 1);")],
    # every split of the dense split-KV body (at every head dim) that holds
    # more than one chunk skips its last
    "decode_last_chunk": [(DECODE, "const int n_chunks = min(p.cps, (last - k0) "
                                   "/ BK + 1);",
                           "const int n_chunks = max(1, min(p.cps, (last - k0) "
                           "/ BK + 1) - 1);")],
}
SERVING_CASES = ("verify", "ar_verify", "prefill")    # chip_smoke.ragged_cases
# chip_smoke's bf16 cases at head dim 256 on gemma's heads and lengths (the
# split-KV body), and the dense decode cases attention_tile's body still
# runs at head dim 256 (fp32; bf16 with 66 rows a KV head)
GEMMA_DECODE = ("gemma3_sd_verify", "gemma3_ar", "gemma3_gamma8_verify",
                "gemma7b_sd_verify")
TILE_DECODE = ("fp32_gemma3_sd_verify", "gemma3_wide_verify")
GEMMA_PAGED = ("gemma3_sd_verify", "gemma3_ar_verify", "gemma7b_sd_verify")
# fault: {kernel it is planted in: the cases of that kernel that must each
# catch it}
FAULT_CASES = {"dropped_split": {"paged": ("long_context",),
                                 "decode": ("long_context",)},
               "paged_stale_chunk": {"paged": ("long_context",)},
               "decode_stale_chunk": {"decode": ("long_context",)},
               "fused_wu_from_wg_map": {"fused": SERVING_CASES},
               "ragged_rows_past_end": {"fused": SERVING_CASES,
                                        "down": SERVING_CASES},
               "tile_last_chunk": {"decode": TILE_DECODE},
               "decode_last_chunk": {"decode": GEMMA_DECODE},
               "paged_last_chunk": {"paged": GEMMA_PAGED + ("long_context",)}}
TUNING = {
    # splits for 2 or 4 blocks per SM at long context instead of 1
    "paged_waves2": [(PAGED, "constexpr int WAVES = 1;",
                      "constexpr int WAVES = 2;")],
    "paged_waves4": [(PAGED, "constexpr int WAVES = 1;",
                      "constexpr int WAVES = 4;")],
    # 6 chunks of K and V in flight instead of 4 (paged and dense bodies)
    "splitkv_stages6": [(SPLITKV, "constexpr int STAGES = 4;",
                         "constexpr int STAGES = 6;")],
    # 2 chunks in flight at head dim 256 instead of 3 (160 KB a block)
    "splitkv_stages256_2": [(SPLITKV, "constexpr int STAGES_256 = 3;",
                             "constexpr int STAGES_256 = 2;")],
    # dense decode splits of at least 2 or 4 chunks instead of 8: the serve
    # shape (S 512) then runs 4 or 2 splits and the combine kernel
    "decode_min_chunks2": [(DECODE, "constexpr int MIN_CHUNKS = 8;",
                            "constexpr int MIN_CHUNKS = 2;")],
    "decode_min_chunks4": [(DECODE, "constexpr int MIN_CHUNKS = 8;",
                            "constexpr int MIN_CHUNKS = 4;")],
    # gemma3-12b's dense decode at head dim 256 (B 8 x Hkv 8 at S 2048, 32
    # chunks a row; 1 split by default): 2 splits (of at least 8 chunks),
    # or 4 (and splits for 2 blocks per SM)
    "decode256_min_chunks8": [(DECODE, "constexpr int MIN_CHUNKS_256 = 32;",
                               "constexpr int MIN_CHUNKS_256 = 8;")],
    "decode256_min_chunks8_waves2": [
        (DECODE, "constexpr int MIN_CHUNKS_256 = 32;",
         "constexpr int MIN_CHUNKS_256 = 8;"),
        (DECODE, "constexpr int WAVES = 1;", "constexpr int WAVES = 2;")],
    # flash: one block per item (the grid of the kernel before it was made
    # persistent), and the persistent grid's plain static stride
    "flash_one_item_per_block": [
        (FLASH, "const int grid = p.n_items < slots ? p.n_items : slots;",
         "const int grid = p.n_items;")],
    "flash_plain_stride": [
        (FLASH, "return n * G + ((n & 1) ? G - 1 - j : j);",
         "return n * G + j;")],
    # flash: 128-query items on two consumer warpgroups (one block an SM)
    # at every length, or 64-query items (two blocks an SM) at every length
    "flash_wide_only": [(FLASH, "constexpr int NARROW_MAX_T = 512;",
                         "constexpr int NARROW_MAX_T = 0;")],
    "flash_narrow_all": [(FLASH, "constexpr int NARROW_MAX_T = 512;",
                          "constexpr int NARROW_MAX_T = 1 << 30;")],
    # 8 stages of the down kernel's ring instead of 5
    "ragged_stages8": [(RAGGED, "STAGES = NMAT == 1 ? 5 : 5;",
                        "STAGES = NMAT == 1 ? 8 : 5;")],
    # 256 output columns per down item (4 stages fit shared memory)
    "ragged_bn256": [(RAGGED, "BN = NMAT == 1 ? 128 : 128;",
                      "BN = NMAT == 1 ? 256 : 128;"),
                     (RAGGED, "STAGES = NMAT == 1 ? 5 : 5;",
                      "STAGES = NMAT == 1 ? 4 : 5;")],
    # the fused gate/up kernel: 4 stages of its ring instead of 5, and 64
    # columns per matrix (wgmma n64 twice, twice the items; 8 stages fit)
    "fused_stages4": [(RAGGED, "STAGES = NMAT == 1 ? 5 : 5;",
                       "STAGES = NMAT == 1 ? 5 : 4;")],
    "fused_bn64": [(RAGGED, "BN = NMAT == 1 ? 128 : 128;",
                    "BN = NMAT == 1 ? 128 : 64;"),
                   (RAGGED, "STAGES = NMAT == 1 ? 5 : 5;",
                    "STAGES = NMAT == 1 ? 5 : 8;")],
}
VARIANTS = {**FAULTS, **TUNING}
# the kernel_ab.py kinds a tuning variant changes, by its name's prefix
TUNE_KINDS = {"paged": ("paged",), "decode": ("decode",),
              "decode256": ("decode",),
              "splitkv": ("paged", "decode"), "flash": ("flash",),
              "ragged": ("down",), "fused": ("fused",)}


def make_tree(name: str) -> Path:
    """build/variants/NAME: this checkout's src/repro_torch, patched."""
    tree = ROOT / "build" / "variants" / name
    if tree.exists():
        shutil.rmtree(tree)
    shutil.copytree(ROOT / "src" / "repro_torch", tree / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for rel, old, new in VARIANTS[name]:
        path = tree / "src" / "repro_torch" / rel
        text = path.read_text()
        if text.count(old) != 1:
            raise SystemExit(f"variant {name}: {old!r} occurs "
                             f"{text.count(old)} times in {rel}")
        path.write_text(text.replace(old, new))
    return tree


def child_errors(root: Path, label: str) -> None:
    """One JSON line per bf16 paged, dense decode and ragged case: errors
    over the bounds."""
    sys.path.insert(0, str(root / "src"))
    import torch

    import chip_smoke
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.decode_attention import ops, paged
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_plain, paged_decode_attention_plain)
    from repro_torch.kernels.gmm import ragged
    from repro_torch.kernels.gmm.ref import fused_gate_up_ref, ragged_gmm_ref

    def report(kernel, case, out, ref, tol, row_tol, route):
        out, ref = out.float(), ref.float()
        finite = bool(torch.isfinite(out).all())
        over = ((out - ref).abs() / (tol + tol * ref.abs())).max().item() \
            if finite else float("inf")
        row = (None if not row_tol else float("inf") if not finite
               else chip_smoke.row_scaled_err(out, ref) / row_tol)
        print(json.dumps({"tree": label, "kernel": kernel, "case": case,
                          "route": route, "err_over_tol": over,
                          "row_err_over_bound": row,
                          "max_abs_err": (out - ref).abs().max().item()}),
              flush=True)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)   # chip_smoke's seed 0
    for case, spec in chip_smoke.PAGED_CASES.items():
        heads = chip_smoke.PAGED_HEADS.get(case, chip_smoke.SERVE_HEADS)
        args = chip_smoke.paged_inputs(spec, gen, dev, heads)
        dtype_name, _, _, _, cap = spec
        if dtype_name != "bfloat16":
            continue
        out = paged.paged_decode_attention(*args, logit_cap=cap)
        report("paged", case, out,
               paged_decode_attention_plain(*args, logit_cap=cap),
               chip_smoke.PAGED_TOL[dtype_name], chip_smoke.PAGED_ROW_TOL,
               paged.LAST_ROUTE["paged_decode_attention"])
    gen = torch.Generator(device=dev).manual_seed(4)   # chip_smoke's seed 0
    for case, spec in chip_smoke.DECODE_CASES.items():
        args = chip_smoke.decode_inputs(spec, gen, dev)
        bf16 = spec[0] == "bfloat16"
        if not bf16 and spec[5] != 256:
            continue
        out = ops.decode_attention(*args)
        report("decode", case, out, decode_attention_plain(*args),
               chip_smoke.DECODE_TOL[spec[0]],
               chip_smoke.DECODE_ROW_TOL if bf16 else None,
               ops.LAST_ROUTE["decode_attention"])
    del args, out
    # chip_smoke.kernel_phase's inputs at seed 0, in its order
    cfg = get_config("qwen2-57b-a14b")
    E, K, D, F = (cfg.num_experts, cfg.num_experts_per_tok, cfg.d_model,
                  cfg.moe_d_ff)
    gen = torch.Generator(device=dev).manual_seed(0)
    wg, wu = ((torch.randn((E, D, F), generator=gen, device=dev) / D ** 0.5
               ).bfloat16() for _ in range(2))
    wd = (torch.randn((E, F, D), generator=gen, device=dev) / F ** 0.5
          ).bfloat16()
    for case, sizes in chip_smoke.ragged_cases(E, K, gen, dev).items():
        xs = torch.randn((int(sizes.sum()), D), generator=gen, device=dev
                         ).bfloat16()
        h = fused_gate_up_ref(xs, wg, wu, sizes)
        report("fused", case, ragged.fused_gate_up(xs, wg, wu, sizes), h,
               chip_smoke.TOL, None, ragged.LAST_ROUTE["fused_gate_up"])
        report("down", case, ragged.ragged_gmm(h, wd, sizes),
               ragged_gmm_ref(h, wd, sizes), chip_smoke.TOL, None,
               ragged.LAST_ROUTE["ragged_gmm"])


def mutants() -> int:
    trees = {".": ROOT, **{name: make_tree(name) for name in FAULTS}}
    rows = []
    for label, tree in trees.items():
        proc = subprocess.run([sys.executable, __file__, "--child-errors",
                               str(tree), label], capture_output=True,
                              text=True, cwd=ROOT)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        for line in proc.stdout.splitlines():
            if line.startswith("{"):
                rec = json.loads(line)
                rows.append(rec)
                row = rec["row_err_over_bound"]
                print(f"{rec['tree']:20s} {rec['kernel']:6s} {rec['case']:17s} "
                      f"route={rec['route']}"
                      f"  err/tol {rec['err_over_tol']:.3g}  row err/bound "
                      f"{'-' if row is None else f'{row:.3g}'}  max abs err "
                      f"{rec['max_abs_err']:.3g}", flush=True)
    print(json.dumps({"cases": rows}))
    sound = [r for r in rows if r["tree"] == "."]

    def caught(name, kernel, case):
        return any((r["err_over_tol"] if r["row_err_over_bound"] is None
                    else r["row_err_over_bound"]) > 1
                   for r in rows if r["tree"] == name
                   and r["kernel"] == kernel and r["case"] == case)

    missed = [(name, kernel, case) for name, kernels in FAULT_CASES.items()
              for kernel, cases in kernels.items() for case in cases
              if not caught(name, kernel, case)]
    ok = (all(r["err_over_tol"] <= 1 and (r["row_err_over_bound"] is None
                                          or r["row_err_over_bound"] <= 1)
              for r in sound) and not missed)
    print(f"mutants: sound tree within every bound and every fault caught: "
          f"{ok}" + (f" (missed {missed})" if missed else ""))
    return 0 if ok else 1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", nargs="?", choices=("mutants", "tune"))
    ap.add_argument("names", nargs="*")
    ap.add_argument("--child-errors", nargs=2, metavar=("ROOT", "LABEL"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    if args.child_errors:
        child_errors(Path(args.child_errors[0]), args.child_errors[1])
        return 0
    if args.mode == "mutants":
        return mutants()
    if args.mode != "tune" or not args.names:
        ap.error("give mutants, or tune with variant names from TUNING")
    unknown = [n for n in args.names if n not in TUNING]
    if unknown:
        ap.error(f"unknown tuning variants {unknown}; known: {sorted(TUNING)}")
    trees = [str(make_tree(n).relative_to(ROOT)) for n in args.names]
    kinds = sorted({kind for n in args.names
                    for kind in TUNE_KINDS[n.split("_")[0]]})
    return subprocess.run([sys.executable, str(ROOT / "kernel_ab.py"), ".",
                           *trees, "--only", ",".join(kinds)],
                          cwd=ROOT).returncode


if __name__ == "__main__":
    sys.exit(main())
