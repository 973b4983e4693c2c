#!/usr/bin/env python3
"""Build patched copies of this checkout's kernel sources and measure them
on the card: faults that a tolerance must catch, and the tile and split
choices of the TMA + wgmma kernels.

    python3 kernel_variants.py mutants [NAME ...]
    python3 kernel_variants.py tune NAME [NAME ...]

Each variant is this checkout's ``src/repro_torch`` copied to the ignored
``build/variants/NAME`` with the text replacements of ``VARIANTS`` applied
(each must match exactly once, so a variant that no longer fits the sources
fails instead of measuring the unpatched kernel); it builds its kernels into
its own ``build/kernels``.

``mutants`` runs every case of chip_smoke.py's paged and dense decode
phases (``PAGED_CASES`` through ``paged_inputs``, ``DECODE_CASES`` through
``decode_inputs``; bf16 on the TMA + wgmma bodies, fp32 on the split-KV
CUDA-core body), every bf16 case of its
ragged phase (the fused gate/up and down kernels on ``ragged_cases``) and
its cases off that route (``ragged_body_case_list``: the staged producer,
the fp32 body), every fp32 case of its flash and capacity GEMM phases
(``FLASH_CASES``, ``capacity_cases``) and the capacity GEMM's bf16 cases
on its staged producer (``UNALIGNED_CAPACITY``), same seeds, through this
tree and each ``FAULTS`` variant named (every one by default; a fault tree
runs only the kinds of case its fault is planted in), and prints, per case,
the largest elementwise error
over the kernel's tolerance (``PAGED_TOL``, ``DECODE_TOL``, ``TOL``,
``FLASH_TOL``, ``GMM_TOL``) and,
for the attention kernels, the largest error over the rms of its output row
over its row bound (``PAGED_ROW_TOL``, ``DECODE_ROW_TOL``); above 1 fails
chip_smoke.py (a non-finite output counts as infinitely far; an fp32 case
has no row bound).  Then one JSON line.  It exits non-zero unless every
fault is caught in each case ``FAULT_CASES`` names for it: a bf16 attention
fault by the row bound (the TMA + wgmma bodies' faults at long context,
the head-dim-256 bodies' at gemma's heads and lengths, the row tiles' in
every case wider than 64 rows a KV head, the paged producer's on the page
sizes it is planted for), an fp32 one and a ragged one by
the tolerance (ragged at every serving case: SD verify, AR verify,
prefill, or every case of the producer or body it is planted in), a fault of kernels 5 and 6's fp32 bodies by the tolerance in
every fp32 case (of kernel 6's 4-byte copies: every case that takes
them), of kernels 3 and 4's in the fp32 cases it reaches, of kernel 6's
staged producer in every bf16 case that stages x; and
this tree passes every bound everywhere.

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
RAGGED_CU = "kernels/gmm/csrc/ragged_gmm.cu"
DECODE32 = "kernels/csrc/decode_f32.cuh"
FLASH32 = "kernels/flash_attention/csrc/flash_f32.cuh"
CAPACITY = "kernels/gmm/csrc/gmm_capacity.cu"

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
    "decode_stale_chunk": [(DECODE, "map, bar, L::DC * c, h, kb, b);",
                            "map, bar, L::DC * c, h, i == 5 ? kb - BK : kb, "
                            "b);")],
    # on pages of 24 (TMA boxes of 8 rows) the second box of every chunk is
    # never loaded, the full barriers expecting its bytes no more (its rows
    # keep what the ring stage held before)
    "paged_box_dropped": [
        (PAGED, "if (j < nbox) {\n            for (int c = 0; c < L::NB; ++c)",
         "if (j < nbox && !(p.ps == 24 && j == 1)) {\n            for (int c "
         "= 0; c < L::NB; ++c)"),
        (PAGED, "static_cast<uint32_t>(nbox * per * D * 2)",
         "static_cast<uint32_t>((nbox - (p.ps == 24 && nbox > 1)) * per * D "
         "* 2)")],
    # the producer that stages chunks by cp.async (pages not a multiple of
    # 8) leaves out row 9 of every chunk
    "paged_staged_row_dropped": [
        (PAGED, "const int r = u / UPR, w = u % UPR;",
         "const int r = u / UPR, w = u % UPR;\n        if (r == 9) continue;")],
    # the fused kernel loads Wu's tile from Wg's map (computes act(g) * g)
    "fused_wu_from_wg_map": [(RAGGED, "m == 0 ? &wmap : &umap, &full[s], w.n * BN + 64 * bx,\n",
                              "&wmap, &full[s], w.n * BN + 64 * bx,\n")],
    # the bf16 body's staged producer leaves the last 8 columns of every
    # second 64-column box of each weight tile unloaded (zeros)
    "ragged_staged_w_cols_dropped": [
        (RAGGED, "const int n_cols = F - col0;",
         "const int n_cols = min(F - col0, 64) - 8 * (bx == 1);")],
    # the fp32 body drops its last K tile
    "ragged_simt90_last_k_tile": [(RAGGED_CU, "for (int kt = 0; kt < nk; ++kt) {",
                                   "for (int kt = 0; kt + 1 < nk; ++kt) {")],
    # the epilogue (shared by both ragged products) stores 8 rows past the
    # expert's end, over the next expert's first rows (never past N)
    "ragged_rows_past_end": [(RAGGED, "if (r < w.row_end && c < F) {",
                              "if (r < min(w.row_end + 8, off[E]) && c < F) {")],
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
    # the dense TMA + wgmma body loads every row tile's q from position 0
    # (a tile's t0 ignored)
    "decode_tile_t0": [(DECODE, "L::DC * c, h * p.g, rt.t0, b);",
                        "L::DC * c, h * p.g, 0, b);")],
    # the combine leaves out the last live split of every row of an fp32
    # output (kernels 3 and 4's fp32 body), or that body skips the last
    # chunk of every split
    "f32_dropped_split": [(SPLITKV, "for (int s = 0; s < live; ++s) {\n"
                                    "      const long long at",
                           "for (int s = 0; s < live - (sizeof(OutT) == 4); "
                           "++s) {\n      const long long at")],
    "f32_last_stage": [(DECODE32, "for (int c = 0; c < n_stages; ++c) {",
                        "for (int c = 0; c + 1 < n_stages; ++c) {")],
    # kernel 5's fp32 bodies (both: Q in shared memory, Q in registers) skip
    # their last key chunk, or do not rescale O when a row's max rises
    "flash32_last_chunk": [(FLASH32, "for (int c = 0; c < n_chunks; ++c) {",
                            "for (int c = 0; c + 1 < n_chunks; ++c) {"),
                           (FLASH32, "for (int c = 0; c < tl.n_chunks; ++c) {",
                            "for (int c = 0; c + 1 < tl.n_chunks; ++c) {")],
    "flash32_no_rescale": [(FLASH32, "o[i][cc] *= corr;", "o[i][cc] *= 1.f;"),
                           (FLASH32, "o[i][cc] *= ci;", "o[i][cc] *= 1.f;")],
    # kernel 6's fp32 body drops the last K tile, or stages the first K
    # column of every tile of x as zeros (both copy widths); its 4-byte
    # copies alone drop the last K tile
    "simt90_last_k_tile": [(CAPACITY, "for (int kt = 0; kt < nk; ++kt) {",
                            "for (int kt = 0; kt + 1 < nk; ++kt) {")],
    "simt90_x_col0_zero": [(CAPACITY, "xr[q][0] = v.x;\n        xr[q][1] = v.y;\n"
                                      "        xr[q][2] = v.z;",
                            "xr[q][0] = kq == 0 ? 0.f : v.x;\n        "
                            "xr[q][1] = v.y;\n        xr[q][2] = v.z;"),
                           (CAPACITY, "xr[q][0] = ok ? src[0] : 0.f;",
                            "xr[q][0] = ok && kq != 0 ? src[0] : 0.f;")],
    "simt90_4byte_last_k_tile": [(CAPACITY, "for (int kt = 0; kt < nk; ++kt) {",
                                  "for (int kt = 0; kt + (XV == 1 || WV == 1) < nk; "
                                  "++kt) {")],
    # kernel 6's staged producer leaves out the last unit (8 columns) of
    # every row of x's last K tile (zeros)
    "cap_staged_x_last_unit": [(CAPACITY, "C - row0, k0, K - k0};",
                                "C - row0, k0, K - k0 - 8 * (k0 + BK >= K)};")],
}
SERVING_CASES = ("verify", "ar_verify", "prefill")    # chip_smoke.ragged_cases
# the fp32 body's cases of chip_smoke.ragged_body_case_list (600 experts too)
FP32_RAGGED = ("fp32_verify", "fp32_ar_verify", "fp32_prefill",
               "fp32_unaligned_verify", "e600_float32")
# chip_smoke's bf16 cases at head dim 256 on gemma's heads and lengths (the
# split-KV body), the dense decode cases wider than 64 rows a KV head (row
# tiles), and the paged cases on pages of 24 (TMA boxes of 8 rows) and on
# pages that are not a multiple of 8 (chunks staged by cp.async)
GEMMA_DECODE = ("gemma3_sd_verify", "gemma3_ar", "gemma3_gamma8_verify",
                "gemma7b_sd_verify")
WIDE_DECODE = ("wide_verify", "gamma16_verify", "wide_long_context",
               "gemma3_wide_verify")
GEMMA_PAGED = ("gemma3_sd_verify", "gemma3_ar_verify", "gemma7b_sd_verify",
               "gemma3_pages48_sd_verify")
PAGES24 = ("odd_pages_sd_verify", "pages24_long_context")
STAGED_PAGES = ("pages12_sd_verify", "pages7_sd_verify")


def _fp32_cases(cases: dict) -> tuple:
    return tuple(name for name, spec in cases.items() if spec[0] == "float32")


def flash_fp32_cases() -> tuple:
    """chip_smoke.py's fp32 flash cases (head dims 64, 128, 256)."""
    import chip_smoke
    return _fp32_cases(chip_smoke.FLASH_CASES)


def decode_fp32_cases() -> tuple:
    """chip_smoke.py's fp32 dense decode cases (the split-KV CUDA-core
    body at every head dim)."""
    import chip_smoke
    return _fp32_cases(chip_smoke.DECODE_CASES)


def paged_fp32_cases() -> tuple:
    """chip_smoke.py's fp32 paged cases (the same body, paged)."""
    import chip_smoke
    return _fp32_cases(chip_smoke.PAGED_CASES)


def gmm_fp32_cases() -> tuple:
    """chip_smoke.py's fp32 capacity GEMM cases (the simt90 body, 16-byte
    copies, or 4-byte ones where an operand is off 16 bytes)."""
    import chip_smoke
    return _fp32_cases(chip_smoke.capacity_cases())


def gmm_unaligned_cases(dtype_name: str, operand: str) -> tuple:
    """chip_smoke.py's capacity cases of a dtype whose ``operand`` is off
    16 bytes (bf16: the staged producer; fp32: the 4-byte copies)."""
    import chip_smoke
    return tuple(c for c, spec in chip_smoke.capacity_cases().items()
                 if spec[0] == dtype_name
                 and chip_smoke.UNALIGNED_CAPACITY.get(c) == operand)


def gmm_fp32_unaligned_cases() -> tuple:
    return (gmm_unaligned_cases("float32", "x")
            + gmm_unaligned_cases("float32", "w"))


# fault: {kernel it is planted in: the cases of that kernel that must each
# catch it}
FAULT_CASES = {"dropped_split": {"paged": ("long_context",),
                                 "decode": ("long_context",)},
               "paged_stale_chunk": {"paged": ("long_context",)},
               "decode_stale_chunk": {"decode": ("long_context",)},
               "fused_wu_from_wg_map": {"fused": SERVING_CASES},
               "ragged_rows_past_end": {"fused": SERVING_CASES,
                                        "down": SERVING_CASES},
               # weights staged by hand only where TMA cannot address them
               "ragged_staged_w_cols_dropped": {"fused": ("f2564_verify",)},
               "ragged_simt90_last_k_tile": {"fused": FP32_RAGGED,
                                             "down": FP32_RAGGED},
               "paged_box_dropped": {"paged": PAGES24},
               "paged_staged_row_dropped": {"paged": STAGED_PAGES},
               "decode_tile_t0": {"decode": WIDE_DECODE},
               # every fp32 case of kernels 3 and 4 with more than one
               # live split (the paged SD verify holds one), by the
               # tolerance; every one for the skipped chunk
               "f32_dropped_split": {"decode": decode_fp32_cases,
                                     "paged": ("fp32_long_context",)},
               "f32_last_stage": {"decode": decode_fp32_cases,
                                  "paged": paged_fp32_cases},
               "decode_last_chunk": {"decode": GEMMA_DECODE},
               "paged_last_chunk": {"paged": GEMMA_PAGED + ("long_context",)},
               # every fp32 case of kernels 5 and 6, by the tolerance
               "flash32_last_chunk": {"flash": flash_fp32_cases},
               "flash32_no_rescale": {"flash": flash_fp32_cases},
               "simt90_last_k_tile": {"gmm": gmm_fp32_cases},
               "simt90_x_col0_zero": {"gmm": gmm_fp32_cases},
               # kernel 6's 4-byte copies, in every fp32 case that takes
               # them; its staged producer's x, in every bf16 case with x
               # staged
               "simt90_4byte_last_k_tile": {"gmm": gmm_fp32_unaligned_cases},
               "cap_staged_x_last_unit": {
                   "gmm": lambda: gmm_unaligned_cases("bfloat16", "x")}}
TUNING = {
    # K/V boxes of 4 rows on pages of 12 or 20 (TMA writing half of an
    # 8-row swizzle atom), or of any height on every page size (pages of 7:
    # 64 one-row boxes a chunk), instead of staging those by cp.async
    "paged_tma_box4": [(PAGED, "constexpr int MIN_BOX = 8;",
                        "constexpr int MIN_BOX = 4;")],
    "paged_tma_box1": [(PAGED, "constexpr int MIN_BOX = 8;",
                        "constexpr int MIN_BOX = 1;")],
    # every page size staged by cp.async (the TMA boxes never used)
    "paged_staged_all": [(PAGED, "    if (per < MIN_BOX) {\n      stage_chunks",
                          "    if (per > 0) {\n      stage_chunks")],
    # one producer lane issuing every TMA box of a chunk (up to 8 on pages of
    # 8 or 24) instead of a lane a box
    "paged_one_issuer": [(PAGED, "constexpr int BOX_LANES = 8;",
                          "constexpr int BOX_LANES = 1;")],
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
    # kernels 3 and 4's fp32 body: 2 ring stages at head dims 64 and 128
    # instead of 3
    "f32_stages2": [(DECODE32, "static constexpr int STAGES = D == 256 ? 2 : 3;",
                     "static constexpr int STAGES = 2;")],
    # dense fp32 splits for one block an SM at every head dim (2 up to D
    # 128 by default); row tiles of 64 rows (one tile up to 64 rows, 5
    # busy warps at 35), 24 or 16 instead of 32
    "f32_waves1": [(DECODE32, "const int waves = head_dim == 256 ? Cfg<256>::MIN_BLOCKS "
                              ": Cfg<128>::MIN_BLOCKS;", "const int waves = 1;")],
    "f32_tile64": [(DECODE32, "constexpr int TILE_ROWS = 32;",
                    "constexpr int TILE_ROWS = 64;")],
    "f32_tile24": [(DECODE32, "constexpr int TILE_ROWS = 32;",
                    "constexpr int TILE_ROWS = 24;")],
    "f32_tile16": [(DECODE32, "constexpr int TILE_ROWS = 32;",
                    "constexpr int TILE_ROWS = 16;")],
    # one block an SM at every head dim (all 255 registers a thread, one
    # wave of splits); 64-key stages up to D 128 (one block an SM)
    "f32_one_block": [(DECODE32, "MIN_BLOCKS = 2 * (BYTES + 1024) <= 228 * 1024 ? 2 : 1;",
                       "MIN_BLOCKS = 1;")],
    "f32_bn64": [(DECODE32, "static constexpr int BN = 32;              // keys of a ring stage",
                  "static constexpr int BN = D == 256 ? 32 : 64;")],
    # the bf16 dense body's splits planned over (sequence, KV head) pairs
    # alone, not over their row tiles: twice the splits of a two-tile
    # verify at 8k keys, two waves
    "decode_tiles_plan_off": [(DECODE, "splitkv::plan(B * n_tiles, Hkv, S,",
                               "splitkv::plan(B, Hkv, S,")],
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
    # kernel 6's fp32 body: K 16 deep a stage; 4 stages (room for one
    # block an SM)
    "simt90_bk16": [(CAPACITY, "constexpr int BK = 32;                       // K per stage",
                     "constexpr int BK = 16;")],
    "simt90_stages4": [(CAPACITY, "constexpr int STAGES = 3;",
                        "constexpr int STAGES = 4;")],
    # kernel 5's fp32 bodies: q in registers at head dim 128 too; 16-key
    # chunks for it at 256
    "flash32_qreg_d128": [(FLASH32, "constexpr int QREG_MIN_D = 256;",
                           "constexpr int QREG_MIN_D = 128;")],
    "flash32_qreg_bn16": [(FLASH32, "static constexpr int BN = 32;",
                           "static constexpr int BN = 16;")],
    # kernel 6 with x staged by hand: 128-column tiles up to C 128 (as with
    # x by TMA) instead of 256
    "cap_staged_x_bn128": [(CAPACITY, "constexpr bool WIDE_STAGED_X = true;",
                            "constexpr bool WIDE_STAGED_X = false;")],
}
VARIANTS = {**FAULTS, **TUNING}
# the kernel_ab.py kinds a tuning variant changes, by its name's prefix
TUNE_KINDS = {"paged": ("paged",), "decode": ("decode",),
              "decode256": ("decode",),
              "splitkv": ("paged", "decode"), "flash": ("flash",),
              "flash32": ("flash",), "simt90": ("gmm",),
              "f32": ("paged", "decode"),
              "ragged": ("down",), "fused": ("fused",), "cap": ("gmm",)}


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


KINDS = ("paged", "decode", "fused", "down", "flash", "gmm")


def child_errors(root: Path, label: str) -> None:
    """One JSON line per case: the paged and dense decode cases, the bf16
    ragged cases, and the fp32 flash and capacity GEMM cases (a fault
    tree's: only those of the kinds its fault is planted in); errors over
    the bounds."""
    kinds = tuple(FAULT_CASES[label]) if label in FAULTS else KINDS
    sys.path.insert(0, str(root / "src"))
    import torch

    import chip_smoke
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.decode_attention import ops, paged
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_plain, paged_decode_attention_plain)
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain
    from repro_torch.kernels.gmm import gmm, ragged
    from repro_torch.kernels.gmm.ref import (fused_gate_up_ref,
                                             gmm_capacity_ref, ragged_gmm_ref)

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
    torch.backends.cuda.matmul.allow_tf32 = False   # the fp32 GEMM's oracle
    gen = torch.Generator(device=dev).manual_seed(3)   # chip_smoke's seed 0
    for case, (dtype_name, B, T, Hq, Hkv, D, window, cap) in \
            chip_smoke.FLASH_CASES.items():
        if "flash" not in kinds:
            break
        dt = getattr(torch, dtype_name)
        q = torch.randn((B, T, Hq, D), generator=gen, device=dev).to(dt)
        k, v = (torch.randn((B, T, Hkv, D), generator=gen, device=dev).to(dt)
                for _ in range(2))
        if dtype_name != "float32":
            continue
        kw = dict(window=window, logit_cap=cap)
        report("flash", case, flash_ops.flash_attention(q, k, v, **kw),
               flash_attention_plain(q, k, v, **kw),
               chip_smoke.FLASH_TOL[dtype_name], None,
               flash_attention.LAST_ROUTE["flash_attention"])
        del q, k, v
    gen = torch.Generator(device=dev).manual_seed(5)   # chip_smoke's seed 0
    for case, spec in chip_smoke.capacity_cases().items():
        if "gmm" not in kinds:
            break
        dtype_name = spec[0]
        x, w = chip_smoke.capacity_inputs(case, spec, gen, dev)
        if dtype_name != "float32" and case not in chip_smoke.UNALIGNED_CAPACITY:
            continue
        out = gmm.gmm_capacity(x, w)
        report("gmm", case, out, gmm_capacity_ref(x, w),
               chip_smoke.GMM_TOL[dtype_name], None,
               "/".join(filter(None, (gmm.LAST_ROUTE["gmm_capacity"],
                                      gmm.LAST_PRODUCER["gmm_capacity"]))))
        del x, w
        torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(2)   # chip_smoke's seed 0
    for case, spec in chip_smoke.PAGED_CASES.items():
        heads = chip_smoke.PAGED_HEADS.get(case, chip_smoke.SERVE_HEADS)
        args = chip_smoke.paged_inputs(
            spec, gen, dev, heads, ps=chip_smoke.PAGED_PAGE_SIZE.get(case, 64))
        dtype_name, _, _, _, cap = spec
        if "paged" not in kinds:
            continue
        out = paged.paged_decode_attention(*args, logit_cap=cap)
        report("paged", case, out,
               paged_decode_attention_plain(*args, logit_cap=cap),
               chip_smoke.PAGED_TOL[dtype_name],
               chip_smoke.PAGED_ROW_TOL if dtype_name == "bfloat16" else None,
               paged.LAST_ROUTE["paged_decode_attention"])
    gen = torch.Generator(device=dev).manual_seed(4)   # chip_smoke's seed 0
    for case, spec in chip_smoke.DECODE_CASES.items():
        args = chip_smoke.decode_inputs(spec, gen, dev)
        bf16 = spec[0] == "bfloat16"
        if "decode" not in kinds:
            continue
        out = ops.decode_attention(*args)
        report("decode", case, out, decode_attention_plain(*args),
               chip_smoke.DECODE_TOL[spec[0]],
               chip_smoke.DECODE_ROW_TOL if bf16 else None,
               ops.LAST_ROUTE["decode_attention"])
    if not {"fused", "down"} & set(kinds):
        return
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
        if "fused" in kinds:
            report("fused", case, ragged.fused_gate_up(xs, wg, wu, sizes), h,
                   chip_smoke.TOL, None, ragged.LAST_ROUTE["fused_gate_up"])
        if "down" in kinds:
            report("down", case, ragged.ragged_gmm(h, wd, sizes),
                   ragged_gmm_ref(h, wd, sizes), chip_smoke.TOL, None,
                   ragged.LAST_ROUTE["ragged_gmm"])
    del wg, wu, wd
    torch.cuda.empty_cache()
    # the ragged cases off the bf16 TMA route: the staged producer, the
    # fp32 body, 600 experts
    for case, bm, _, make in chip_smoke.ragged_body_case_list(gen, dev):
        xs, (g, u, d), sizes = make()
        tol = (chip_smoke.RAGGED_F32_TOL if xs.dtype == torch.float32
               else chip_smoke.TOL)
        h = fused_gate_up_ref(xs, g, u, sizes)
        if "fused" in kinds:
            report("fused", case, ragged.fused_gate_up(xs, g, u, sizes, bm=bm),
                   h, tol, None, ragged.LAST_ROUTE["fused_gate_up"])
        h = chip_smoke._offset(h, xs.data_ptr() % 16 // xs.element_size())
        if "down" in kinds:
            report("down", case, ragged.ragged_gmm(h, d, sizes, bm=bm),
                   ragged_gmm_ref(h, d, sizes), tol, None,
                   ragged.LAST_ROUTE["ragged_gmm"])
        del xs, g, u, d, h


def _fault_cases(name: str) -> dict:
    """{kernel: the cases that must each catch fault ``name``}."""
    return {kernel: cases() if callable(cases) else cases
            for kernel, cases in FAULT_CASES[name].items()}


def mutants(names=()) -> int:
    """This tree and each fault of ``names`` (every fault by default)."""
    names = tuple(names) or tuple(FAULTS)
    trees = {".": ROOT, **{name: make_tree(name) for name in names}}
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

    missed = [(name, kernel, case) for name in names
              for kernel, cases in _fault_cases(name).items()
              for case in cases if not caught(name, kernel, case)]
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
    sys.path.insert(0, str(ROOT / "src"))   # chip_smoke's case lists
    if args.mode == "mutants":
        unknown = [n for n in args.names if n not in FAULTS]
        if unknown:
            ap.error(f"unknown faults {unknown}; known: {sorted(FAULTS)}")
        return mutants(args.names)
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
