"""Flash attention for prefill: the wrapper around the CUDA kernel in
``csrc/flash_attention.cu``.

Port of ``repro.kernels.flash_attention.flash_attention.flash_attention_bhtd``:
(B, Hq, T, D) queries over (B, Hkv, S, D) keys and values, causal by index
(or not), with an optional sliding window and tanh logit cap, GQA through
``h // g``.  The reference asserts ``T % min(128, T) == 0`` and
``S % min(128, S) == 0`` (its block contract); this wrapper raises a
``ValueError`` for the same calls, on every device.

CPU tensors take the plain PyTorch version (``ref.py``); CUDA tensors launch
the kernel or raise.  ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from repro_torch.kernels import attention_launch, build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"

# kernel launches since the last reset
LAUNCHES = {"flash_attention": 0}
BLOCK = 128                    # the reference's bq = bk


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    if not getattr(lib, "_argtypes_set", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        st = ctypes.POINTER(ctypes.c_longlong)
        lib.flash_attention_launch.argtypes = [
            i, i, p, p, p, p, st, i, i, i, i, i, i, i, f, f, p]
        lib.flash_attention_launch.restype = i
        lib._argtypes_set = True
    return lib


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
    with torch.cuda.device(q.device):
        status = _lib().flash_attention_launch(
            attention_launch.DTYPES[q.dtype], D, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(), st, B, T, S,
            Hq, Hkv, int(causal), int(window), float(scale), float(logit_cap),
            torch.cuda.current_stream().cuda_stream)
    build.check(status, "flash_attention")
    LAUNCHES["flash_attention"] += 1
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
