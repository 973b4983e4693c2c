"""Flash attention for prefill: the wrapper around the CUDA kernel in
``csrc/flash_attention.cu``.

Port of ``repro.kernels.flash_attention.flash_attention.flash_attention_bhtd``:
(B, Hq, T, D) queries over (B, Hkv, S, D) keys and values, causal by index
(or not), with an optional sliding window and tanh logit cap, GQA through
``h // g``.  The reference asserts ``T % min(128, T) == 0`` and
``S % min(128, S) == 0`` (its block contract); this wrapper raises a
``ValueError`` for the same calls, on every device.

CPU tensors take the plain PyTorch version (``ref.py``); CUDA tensors launch
the kernel or raise.  ``LAUNCHES`` counts kernel launches.  bf16 runs the
TMA + wgmma kernel (``csrc/flash_sm90.cuh``) at every head dim (32 to 256),
fp32 the CUDA-core body of ``csrc/flash_f32.cuh``; the launcher
reports which one it launched, and ``LAST_ROUTE`` holds it (``"sm90"`` or
``"f32"``); ``ROUTE_LAUNCHES`` tallies launches by (route, head dim).
"""
from __future__ import annotations

import ctypes
import math
from collections import Counter
from pathlib import Path

import torch

from repro_torch.kernels import attention_launch, build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"

# kernel launches since the last reset
LAUNCHES = {"flash_attention": 0}
# the kernel the last launch ran, as the launcher reported it
LAST_ROUTE = {"flash_attention": None}
# launches since the last reset by (route, head dim): eager calls and
# the calls a CUDA graph captures (a replay runs what was captured)
ROUTE_LAUNCHES: Counter = Counter()
_ROUTES = ("sm90", "f32")      # the launcher's kernel codes
BLOCK = 128                    # the reference's bq = bk
NARROW_MAX_T = 512             # flash_sm90.cuh: 64-query items up to this T


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    ROUTE_LAUNCHES.clear()


def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    if not getattr(lib, "_argtypes_set", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        st = ctypes.POINTER(ctypes.c_longlong)
        lib.flash_attention_launch.argtypes = [
            i, i, p, p, p, p, st, i, i, i, i, i, i, i, f, f, p,
            ctypes.POINTER(i)]
        lib.flash_attention_launch.restype = i
        lib._argtypes_set = True
    return lib


def consumers(T: int, head_dim: int) -> int:
    """Consumer warpgroups of the bf16 kernel's block (``flash_sm90.cuh``
    ``consumers``): one (64-query items, two blocks an SM) up to
    ``NARROW_MAX_T`` queries below head dim 256, else two (128-query items,
    one block an SM)."""
    return 1 if T <= NARROW_MAX_T and head_dim < 256 else 2


def schedule(T: int, B: int, Hq: int, sm_count: int,
             head_dim: int = 128) -> list:
    """The bf16 kernel's persistent schedule, as ``csrc/flash_sm90.cuh``
    computes it on the device: per block of the grid, the (query tile,
    head, sequence) items it runs, in order.  With one consumer warpgroup
    (``consumers``) an item is 64 positions and two blocks share an SM,
    with two 128 and one; the grid is one block per slot, at most one per
    item.  The item
    list is heaviest first (the last query tile of every (sequence, head)
    before the one before it); block j of G takes item r * G + j in round r
    when r is even and r * G + G - 1 - j when it is odd."""
    rows, per_sm = (64, 2) if consumers(T, head_dim) == 1 else (128, 1)
    n_qt = -(-T // rows)
    n_items = n_qt * B * Hq
    grid = min(n_items, per_sm * sm_count)
    blocks = []
    for j in range(grid):
        items, r = [], 0
        while True:
            idx = r * grid + (grid - 1 - j if r % 2 else j)
            if idx >= n_items:
                break
            bh = idx % (B * Hq)
            items.append((n_qt - 1 - idx // (B * Hq), bh % Hq, bh // Hq))
            r += 1
        blocks.append(items)
    return blocks


def check_blocks(T: int, S: int) -> None:
    """The reference's block contract: T and S are multiples of their
    block, min(128, T) and min(128, S)."""
    if T % min(BLOCK, T) or S % min(BLOCK, S):
        raise ValueError(
            f"flash attention takes T and S that are multiples of "
            f"min({BLOCK}, T) and min({BLOCK}, S), as the reference asserts; "
            f"got T={T}, S={S}")


def flash_attention_btd(q, k, v, *, causal: bool = True, window: int = 0,
                        scale: float = 0.0,
                        logit_cap: float = 0.0) -> torch.Tensor:
    """The kernel on (B, T, Hq, D)-indexed views (any strides the kernel
    takes); returns a new (B, T, Hq, D) tensor."""
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    check_blocks(T, S)
    attention_launch.check("flash attention", q, k, v, g_rows=1)
    if scale == 0.0:
        scale = 1.0 / math.sqrt(D)
    out = torch.empty((B, T, Hq, D), dtype=q.dtype, device=q.device)
    if B == 0 or T == 0:
        return out
    st = attention_launch.strides(q, k, v, out)
    kernel = ctypes.c_int(-1)
    with torch.cuda.device(q.device):
        status = _lib().flash_attention_launch(
            attention_launch.DTYPES[q.dtype], D, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(), st, B, T, S,
            Hq, Hkv, int(causal), int(window), float(scale), float(logit_cap),
            torch.cuda.current_stream().cuda_stream, ctypes.byref(kernel))
    build.check(status, "flash_attention")
    # lint: allow[T106] credited by RoundGraphs on every replay
    LAUNCHES["flash_attention"] += 1
    # lint: allow[T106] a replay launches what its capture did
    LAST_ROUTE["flash_attention"] = _ROUTES[kernel.value]
    # lint: allow[T106] eager runs and captures only (chip_smoke's checks)
    ROUTE_LAUNCHES[LAST_ROUTE["flash_attention"], D] += 1
    return out


def flash_attention_bhtd(
    q: torch.Tensor,           # (B, Hq, T, D)
    k: torch.Tensor,           # (B, Hkv, S, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    scale: float = 0.0,
    logit_cap: float = 0.0,
) -> torch.Tensor:             # (B, Hq, T, D)
    """Attention in the reference kernel's layout; the result is in q's
    dtype.  ``scale`` 0 means 1/sqrt(D)."""
    check_blocks(q.shape[2], k.shape[2])
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   scale=scale, logit_cap=logit_cap)
    if q.device.type != "cuda":
        raise ValueError(f"no flash attention kernel for device {q.device}")
    out = flash_attention_btd(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=causal,
        window=window, scale=scale, logit_cap=logit_cap)
    return out.transpose(1, 2)
