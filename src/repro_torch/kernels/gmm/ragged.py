"""Ragged grouped matmul for the MoE expert FFN: wrappers around the CUDA
kernels in ``csrc/ragged_gmm.cu``.

Port of ``repro.kernels.gmm.ragged``.  Tokens arrive sorted by expert id
with per-expert ``group_sizes``; no capacity bins.  ``make_group_metadata``
maps the static visit axis ``ceil(N/bm) + E - 1`` onto the ragged
(expert, m-tile) work list, on the device and without a host sync: an
m-tile whose rows belong to one expert is visited once, a tile straddling a
group boundary once per group, and an empty expert not at all.

Both products in bf16 (``fused_gate_up`` and ``ragged_gmm``, the two
launches of ``ragged_moe_ffn``) take the TMA + wgmma kernel
(``csrc/ragged_sm90.cuh``) whenever TMA can address their operands
(``_route``): its work items are expert-aligned, (expert, row chunk of 64
rows, column tile), built inside the kernel from ``group_sizes``, so
an expert's weights are read once per chunk of its rows rather than once per
row tile its rows touch, and the wrapper builds no list: the bf16 expert
FFN is two launches that read ``group_sizes`` on the device.
``expert_chunks`` computes the same list on the host for tests and
reports; nothing on the kernel's path calls it.  Other bf16 shapes keep the
WMMA kernels, fp32 the CUDA-core ones, both on ``make_group_metadata``'s
visit list.

Each wrapper takes the plain PyTorch version (``ref.py``) for tensors on the
CPU and launches its kernel for CUDA tensors; there is no fallback between
the two.  ``LAUNCHES`` counts kernel launches per kernel, so a run can show
that its main path went through them; ``LAST_ROUTE`` holds the kernel the
last launch of each ran, as its launcher reported it (``"sm90"``,
``"wmma"`` or ``"simt"``).
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.gmm.ref import (fused_gate_up_ref, ragged_gmm_ref,
                                         ragged_moe_ffn_ref)

SOURCE = Path(__file__).resolve().parent / "csrc" / "ragged_gmm.cu"

# kernel launches since the last reset, by kernel
LAUNCHES = {"fused_gate_up": 0, "ragged_gmm": 0}
# the kernel the last launch of each ran, as its launcher reported it
LAST_ROUTE = {"fused_gate_up": None, "ragged_gmm": None}
_ROUTES = ("sm90", "wmma", "simt")   # the launchers' kernel codes
_SM90_MAX_EXPERTS = 512              # the TMA kernel's shared tables

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
_ACTS = {"silu": 0, "gelu": 1}
_MAX_GRID_Y = 65535


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


class GroupMetadata(NamedTuple):
    """Visit list driving the ragged grid (all int32, on the device)."""
    group_offsets: torch.Tensor  # (E+1,) row offsets of each expert's slab
    group_ids: torch.Tensor      # (T_max,) expert id per visit
    m_tile_ids: torch.Tensor     # (T_max+1,) m-tile per visit, -1 sentinel last
    num_visits: torch.Tensor     # (1,) visits that carry real work


def make_group_metadata(group_sizes: torch.Tensor, n_rows_pad: int,
                        bm: int) -> GroupMetadata:
    """Map a static ``T_max = n_rows_pad/bm + E - 1`` visit axis onto the
    ragged (expert, m-tile) work list.  ``num_visits`` counts the visits that
    do real work: over the NON-EMPTY experts, the m-tiles their row range
    touches.  Only device ops: nothing here waits for the routing."""
    E = group_sizes.shape[0]
    dev = group_sizes.device
    sizes = group_sizes.to(torch.int64)
    ends = torch.cumsum(sizes, 0)
    starts = ends - sizes
    tiles = torch.where(sizes > 0, (ends + bm - 1) // bm - starts // bm,
                        torch.zeros_like(sizes))
    visit_ends = torch.cumsum(tiles, 0)
    num_visits = visit_ends[-1:]                                 # (1,)
    t_max = n_rows_pad // bm + E - 1
    t = torch.arange(t_max, device=dev, dtype=torch.int64)
    g = torch.searchsorted(visit_ends, t, right=True).clamp(max=E - 1)
    mt = starts[g] // bm + (t - (visit_ends[g] - tiles[g]))
    valid = t < num_visits
    # padding visits replay the last real tile (the kernels skip them)
    last_tile = mt.index_select(0, (num_visits - 1).clamp(min=0)) \
        if t_max else mt
    mt = torch.where(valid, mt, last_tile)
    g = torch.where(valid, g, torch.full_like(g, E - 1))
    mt_ext = torch.cat([mt, torch.full((1,), -1, dtype=mt.dtype, device=dev)])
    offsets = torch.cat([torch.zeros((1,), dtype=ends.dtype, device=dev), ends])
    return GroupMetadata(offsets.to(torch.int32), g.to(torch.int32),
                         mt_ext.to(torch.int32), num_visits.to(torch.int32))


def expert_chunks(group_sizes: torch.Tensor, bm: int) -> torch.Tensor:
    """The TMA kernel's work list without its column tiles: one row per
    (expert, chunk) of ``bm`` rows, ``(expert, first row, end row)`` with
    the end capped at the expert's last row, expert-major.  Empty experts
    have no chunk.  Its length is sum(ceil(size / bm)) over the experts."""
    sizes = group_sizes.to(torch.int64).cpu()
    ends = torch.cumsum(sizes, 0)
    starts = ends - sizes
    chunks = (sizes + bm - 1) // bm
    e = torch.repeat_interleave(torch.arange(len(sizes)), chunks)
    c = torch.arange(int(chunks.sum())) - torch.repeat_interleave(
        torch.cumsum(chunks, 0) - chunks, chunks)
    row0 = starts[e] + c * bm
    return torch.stack([e, row0, torch.minimum(row0 + bm, ends[e])], 1)


def _row_tile(n_rows: int, n_experts: int) -> int:
    """16-row tiles when experts hold few rows each (decode/verify), else
    64: the kernels' two instantiations."""
    return 16 if n_rows <= 32 * n_experts else 64


def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.fused_gate_up_launch.argtypes = [i, i, i, p, p, p, p, p, p, p, p,
                                             i, i, i, i, p, ctypes.POINTER(i)]
        lib.ragged_gmm_launch.argtypes = [i, i, p, p, p, p, p, p, p, i, i, i,
                                          i, p, ctypes.POINTER(i)]
        lib.ragged_gmm_sm90_launch.argtypes = [p, p, p, p, i, i, i, i, p,
                                               ctypes.POINTER(i)]
        lib.fused_gate_up_sm90_launch.argtypes = [i, p, p, p, p, p, i, i, i,
                                                  i, p, ctypes.POINTER(i)]
        lib.ragged_sm90_tile_cols.argtypes = [i]
        lib.fused_gate_up_launch.restype = i
        lib.ragged_gmm_launch.restype = i
        lib.ragged_gmm_sm90_launch.restype = i
        lib.fused_gate_up_sm90_launch.restype = i
        lib.ragged_sm90_chunk_rows.restype = i
        lib.ragged_sm90_tile_cols.restype = i
        lib._argtypes_set = True
    return lib


def _check(xs: torch.Tensor, ws, group_sizes: torch.Tensor) -> None:
    if xs.dtype not in _DTYPES:
        raise TypeError(f"ragged kernels take bf16 or fp32, got {xs.dtype}")
    E, K, _ = ws[0].shape
    if xs.dim() != 2 or xs.shape[1] != K:
        raise ValueError(f"xs {tuple(xs.shape)} does not match weights "
                         f"{tuple(ws[0].shape)}")
    for t in (xs, *ws):
        if t.device != xs.device or t.dtype != xs.dtype:
            raise ValueError("xs and weights must share device and dtype")
        if not t.is_contiguous():
            raise ValueError("ragged kernels take contiguous tensors")
    if any(w.shape != ws[0].shape for w in ws):
        raise ValueError("gate and up weights must have one shape")
    if group_sizes.shape != (E,) or group_sizes.device != xs.device:
        raise ValueError(f"group_sizes must be ({E},) on {xs.device}")


def _vec_ok(K: int, F: int, tensors) -> bool:
    """Whether every 16-byte chunk the kernels load is aligned."""
    vec = 16 // tensors[0].element_size()
    return (K % vec == 0 and F % vec == 0
            and all(t.data_ptr() % 16 == 0 for t in tensors))


def _route(xs: torch.Tensor, w, bm: Optional[int] = None) -> str:
    """The kernel a launch takes, for ``w`` the weight of ``ragged_gmm`` or
    the tuple (gate, up) of ``fused_gate_up``: ``"simt"`` for fp32; for
    bf16 ``"sm90"`` when TMA can address x and every weight (row pitches
    multiples of 16 bytes, 16-byte aligned bases), there are at most 512
    experts and ``bm`` is None or 64 (its chunk rows); else ``"wmma"``
    (``bm`` 16 asks for it)."""
    if xs.dtype == torch.float32:
        return "simt"
    ws = (w,) if isinstance(w, torch.Tensor) else tuple(w)
    E, K, F = ws[0].shape
    if (bm in (None, 64) and E <= _SM90_MAX_EXPERTS
            and K % 8 == 0 and F % 8 == 0
            and all(t.data_ptr() % 16 == 0 for t in (xs, *ws))):
        return "sm90"
    return "wmma"


def sm90_chunk_rows() -> int:
    """Rows of one expert chunk of the TMA kernel, as its library says
    (needs the built library)."""
    return _lib().ragged_sm90_chunk_rows()


def sm90_tile_cols(n_mat: int) -> int:
    """Output columns of one item of the TMA kernel: ``n_mat`` 1 for the
    down product, 2 for the fused gate/up (needs the built library)."""
    return _lib().ragged_sm90_tile_cols(n_mat)


def _plan(xs: torch.Tensor, E: int, group_sizes: torch.Tensor,
          bm: Optional[int]):
    N = xs.shape[0]
    bm = _row_tile(N, E) if bm is None else bm
    if bm not in (16, 64):
        raise ValueError(f"the kernels are built for bm in (16, 64), got {bm}")
    n_pad = -(-N // bm) * bm
    if n_pad // bm + E - 1 > _MAX_GRID_Y:
        raise ValueError(f"{N} rows over {E} experts exceed the grid")
    return make_group_metadata(group_sizes, n_pad, bm), bm


def _launch_fused(xs, w_gate, w_up, meta: GroupMetadata, bm: int,
                  activation: str) -> torch.Tensor:
    N, K = xs.shape
    F = w_gate.shape[2]
    out = torch.empty((N, F), dtype=xs.dtype, device=xs.device)
    kernel = ctypes.c_int(-1)
    with torch.cuda.device(xs.device):
        status = _lib().fused_gate_up_launch(
            _DTYPES[xs.dtype], bm, _ACTS[activation], xs.data_ptr(),
            w_gate.data_ptr(), w_up.data_ptr(), out.data_ptr(),
            meta.group_offsets.data_ptr(), meta.group_ids.data_ptr(),
            meta.m_tile_ids.data_ptr(), meta.num_visits.data_ptr(), K, F,
            meta.group_ids.shape[0], int(_vec_ok(K, F, (xs, w_gate, w_up, out))),
            torch.cuda.current_stream().cuda_stream, ctypes.byref(kernel))
    build.check(status, "fused_gate_up")
    LAUNCHES["fused_gate_up"] += 1
    LAST_ROUTE["fused_gate_up"] = _ROUTES[kernel.value]
    return out


def _launch_fused_sm90(xs, w_gate, w_up, group_sizes: torch.Tensor,
                       activation: str) -> torch.Tensor:
    N, K = xs.shape
    E, _, F = w_gate.shape
    sizes = group_sizes.to(torch.int32).contiguous()   # no-op when it is
    out = torch.empty((N, F), dtype=xs.dtype, device=xs.device)
    kernel = ctypes.c_int(-1)
    with torch.cuda.device(xs.device):
        status = _lib().fused_gate_up_sm90_launch(
            _ACTS[activation], xs.data_ptr(), w_gate.data_ptr(),
            w_up.data_ptr(), out.data_ptr(), sizes.data_ptr(), N, K, F, E,
            torch.cuda.current_stream().cuda_stream, ctypes.byref(kernel))
    build.check(status, "fused_gate_up")
    LAUNCHES["fused_gate_up"] += 1
    LAST_ROUTE["fused_gate_up"] = _ROUTES[kernel.value]
    return out


def _launch_ragged(xs, w, meta: GroupMetadata, bm: int) -> torch.Tensor:
    N, K = xs.shape
    F = w.shape[2]
    out = torch.empty((N, F), dtype=xs.dtype, device=xs.device)
    kernel = ctypes.c_int(-1)
    with torch.cuda.device(xs.device):
        status = _lib().ragged_gmm_launch(
            _DTYPES[xs.dtype], bm, xs.data_ptr(), w.data_ptr(), out.data_ptr(),
            meta.group_offsets.data_ptr(), meta.group_ids.data_ptr(),
            meta.m_tile_ids.data_ptr(), meta.num_visits.data_ptr(), K, F,
            meta.group_ids.shape[0], int(_vec_ok(K, F, (xs, w, out))),
            torch.cuda.current_stream().cuda_stream, ctypes.byref(kernel))
    build.check(status, "ragged_gmm")
    LAUNCHES["ragged_gmm"] += 1
    LAST_ROUTE["ragged_gmm"] = _ROUTES[kernel.value]
    return out


def _launch_ragged_sm90(xs, w, group_sizes: torch.Tensor) -> torch.Tensor:
    N, K = xs.shape
    E, _, F = w.shape
    sizes = group_sizes.to(torch.int32).contiguous()   # no-op when it is
    out = torch.empty((N, F), dtype=xs.dtype, device=xs.device)
    kernel = ctypes.c_int(-1)
    with torch.cuda.device(xs.device):
        status = _lib().ragged_gmm_sm90_launch(
            xs.data_ptr(), w.data_ptr(), out.data_ptr(),
            sizes.data_ptr(), N, K, F, E,
            torch.cuda.current_stream().cuda_stream, ctypes.byref(kernel))
    build.check(status, "ragged_gmm")
    LAUNCHES["ragged_gmm"] += 1
    LAST_ROUTE["ragged_gmm"] = _ROUTES[kernel.value]
    return out


def _on_cuda(xs: torch.Tensor) -> bool:
    if xs.device.type == "cpu":
        return False
    if xs.device.type != "cuda":
        raise ValueError(f"no ragged kernel for device {xs.device}")
    return True


def ragged_gmm(xs: torch.Tensor,            # (N, D) tokens sorted by expert
               w: torch.Tensor,             # (E, D, F) expert weights
               group_sizes: torch.Tensor,   # (E,) rows per expert
               *, bm: Optional[int] = None) -> torch.Tensor:   # (N, F)
    """``xs[n] @ w[e(n)]`` with fp32 accumulation, cast to ``xs.dtype``.
    ``group_sizes`` must sum to N.  ``bm`` (16 or 64) overrides the row
    tile, which is otherwise 64 rows for the TMA kernel and chosen from the
    rows per expert for the visit-list kernels; 16 takes the WMMA kernel in
    bf16."""
    if not _on_cuda(xs):
        return ragged_gmm_ref(xs, w, group_sizes)
    _check(xs, (w,), group_sizes)
    if xs.shape[0] == 0:
        return xs.new_empty((0, w.shape[2]))
    if _route(xs, w, bm) == "sm90":
        return _launch_ragged_sm90(xs, w, group_sizes)
    meta, bm = _plan(xs, w.shape[0], group_sizes, bm)
    return _launch_ragged(xs, w, meta, bm)


def fused_gate_up(xs: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                  group_sizes: torch.Tensor, *, activation: str = "silu",
                  bm: Optional[int] = None) -> torch.Tensor:
    """``act(xs @ w_gate[g]) * (xs @ w_up[g])`` in ONE launch: (N, D) → (N, F).
    ``bm`` as for ``ragged_gmm``."""
    if activation not in _ACTS:
        raise ValueError(f"activation must be one of {sorted(_ACTS)}")
    if not _on_cuda(xs):
        return fused_gate_up_ref(xs, w_gate, w_up, group_sizes, activation)
    _check(xs, (w_gate, w_up), group_sizes)
    if xs.shape[0] == 0:
        return xs.new_empty((0, w_gate.shape[2]))
    if _route(xs, (w_gate, w_up), bm) == "sm90":
        return _launch_fused_sm90(xs, w_gate, w_up, group_sizes, activation)
    meta, bm = _plan(xs, w_gate.shape[0], group_sizes, bm)
    return _launch_fused(xs, w_gate, w_up, meta, bm, activation)


def ragged_moe_ffn(xs: torch.Tensor,         # (N, D) tokens sorted by expert
                   w_gate: torch.Tensor, w_up: torch.Tensor,
                   w_down: torch.Tensor,     # (E, F, D)
                   group_sizes: torch.Tensor, *, activation: str = "silu",
                   bm: Optional[int] = None) -> torch.Tensor:
    """Whole expert FFN on expert-sorted tokens in 2 launches:
    ``fused_gate_up``, then ``ragged_gmm`` of its ``h``, which is rounded to
    the input dtype between the launches, as in the reference.  On the bf16
    TMA route (``_route``) nothing else runs: each kernel builds its work
    list from ``group_sizes``; the visit-list kernels build theirs each."""
    if activation not in _ACTS:
        raise ValueError(f"activation must be one of {sorted(_ACTS)}")
    if not _on_cuda(xs):
        return ragged_moe_ffn_ref(xs, w_gate, w_up, w_down, group_sizes,
                                  activation)
    _check(xs, (w_gate, w_up), group_sizes)
    E, D, F = w_gate.shape
    if (w_down.shape != (E, F, D) or w_down.dtype != xs.dtype
            or w_down.device != xs.device or not w_down.is_contiguous()):
        raise ValueError(f"w_down must be a contiguous ({E}, {F}, {D}) "
                         f"{xs.dtype} tensor on {xs.device}")
    h = fused_gate_up(xs, w_gate, w_up, group_sizes, activation=activation,
                      bm=bm)
    return ragged_gmm(h, w_down, group_sizes, bm=bm)
