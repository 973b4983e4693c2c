"""Ragged grouped matmul for the MoE expert FFN: wrappers around the CUDA
kernels in ``csrc/ragged_gmm.cu``.

Port of ``repro.kernels.gmm.ragged``.  Tokens arrive sorted by expert id
with per-expert ``group_sizes``; no capacity bins.  Both products
(``fused_gate_up`` and ``ragged_gmm``, the two launches of
``ragged_moe_ffn``) run one of two bodies on the card, by element type
(``_route``):

  * ``"sm90"``, every bf16 call: the TMA + wgmma kernel
    (``csrc/ragged_sm90.cuh``).  Its work items are expert-aligned,
    (expert, row chunk of 64 rows, column tile), built inside the kernel
    from ``group_sizes``, so an expert's weights are read once per chunk of
    its rows rather than once per row tile its rows touch, and the wrapper
    builds no list: the bf16 expert FFN is two launches that read
    ``group_sizes`` on the device.  Its producer loads the tiles by TMA
    where TMA can address the operands (K and F multiples of 8, 16-byte
    aligned bases) and stages them by ``cp.async`` into the same layout
    otherwise (``LAST_PRODUCER``: ``"tma"`` or ``"staged"``); more than 512
    experts take one launch a window of 512.
  * ``"simt90"``, every fp32 call: the CUDA-core body of ``ragged_gmm.cu``
    on the same kind of items (chunks of 64 rows), a ring of weight tiles
    filled by ``cp.async`` and x through registers, 16-byte copies where
    aligned and 4-byte ones otherwise.

``bm`` is the reference's row-tile argument (16, 64, its default 128, ...).
The bodies' chunks do not depend on it: it changes nothing here, on the
card or on the CPU, and no value of it makes a call raise.
``make_group_metadata`` (the reference's row-tile-aligned visit list) and
``expert_chunks`` (the bf16 body's chunks, computed on the host) serve
tests and reports; nothing on a kernel's path calls them.

The groups may cover fewer than N rows (``sum(group_sizes) <= N``, the
expert-parallel receive buffer of ``distributed/collectives.py``): no body
launches an item for the rows past the last group, nor stores into them.
The bf16 body's 64-row box of a chunk reads up to 63 rows past its
expert's end (the next expert's rows, or these), multiplies them and never
stores them, as at any group boundary; the fp32 body never reads them.

Each wrapper takes the plain PyTorch version (``ref.py``) for tensors on the
CPU and launches its kernel for CUDA tensors; there is no fallback between
the two, nor between the bodies: a call the body refuses raises.  On the
meta device (the dry-run, ``launch/dryrun.py``) it launches nothing: it
records its kernel's work in the active step counters
(``launch/costs.record_kernel``) and returns an empty result of its shape;
its group sizes must then hold values (a stated routing,
``launch/costs.stated_group_sizes``).  ``LAUNCHES`` counts kernel launches
per kernel, so a run can show that its main path went through them;
``LAST_ROUTE`` holds the body the last launch of each ran, as its
launcher reported it (``"sm90"`` or ``"simt90"``), and ``ROUTE_LAUNCHES``
tallies launches by (kernel, route).
"""
from __future__ import annotations

import ctypes
from collections import Counter
from pathlib import Path
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import build, refuse_autograd
from repro_torch.kernels.gmm.ref import (fused_gate_up_ref, ragged_gmm_ref,
                                         ragged_moe_ffn_ref)
from repro_torch.launch import costs

SOURCE = Path(__file__).resolve().parent / "csrc" / "ragged_gmm.cu"

# kernel launches since the last reset, by kernel
LAUNCHES = {"fused_gate_up": 0, "ragged_gmm": 0}
# the body the last launch of each ran, as its launcher reported it, and the
# bf16 body's producer ("tma" or "staged"; None after an fp32 launch)
LAST_ROUTE = {"fused_gate_up": None, "ragged_gmm": None}
LAST_PRODUCER = {"fused_gate_up": None, "ragged_gmm": None}
# launches since the last reset by (kernel, route)
ROUTE_LAUNCHES: Counter = Counter()
# the two bodies, and the bf16 body's producers, by the launcher's code
# (0: sm90 with TMA, 1: sm90 staged, 2: simt90)
_ROUTES = ("sm90", "simt90")
_PRODUCERS = ("tma", "staged", None)

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
_ACTS = {"silu": 0, "gelu": 1}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    ROUTE_LAUNCHES.clear()


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


def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ragged_launch.argtypes = [i, i, i, p, p, p, p, p, i, i, i, i, p,
                                      ctypes.POINTER(i), ctypes.POINTER(i)]
        lib.ragged_sm90_tile_cols.argtypes = [i]
        lib.ragged_simt90_tile_cols.argtypes = [i]
        lib.ragged_launch.restype = i
        for fn in (lib.ragged_sm90_chunk_rows, lib.ragged_sm90_tile_cols,
                   lib.ragged_simt90_chunk_rows, lib.ragged_simt90_tile_cols):
            fn.restype = i
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


def _route(xs: torch.Tensor, w, bm: Optional[int] = None) -> str:
    """The body a launch takes, for ``w`` the weight of ``ragged_gmm`` or
    the tuple (gate, up) of ``fused_gate_up``: ``"sm90"`` for bf16 (at any
    shape, base and number of experts), ``"simt90"`` for fp32.  ``bm`` (the
    reference's row tile) does not enter."""
    return "simt90" if xs.dtype == torch.float32 else "sm90"


def _tma_ok(xs: torch.Tensor, w) -> bool:
    """Whether the bf16 body's producer loads this call's tiles by TMA (K
    and F multiples of 8, x and every weight 16-byte aligned; the output,
    a new tensor, always is) rather than staging them."""
    ws = (w,) if isinstance(w, torch.Tensor) else tuple(w)
    _, K, F = ws[0].shape
    return (K % 8 == 0 and F % 8 == 0
            and all(t.data_ptr() % 16 == 0 for t in (xs, *ws)))


def sm90_chunk_rows() -> int:
    """Rows of one expert chunk of the bf16 body, as its library says
    (needs the built library)."""
    return _lib().ragged_sm90_chunk_rows()


def sm90_tile_cols(n_mat: int) -> int:
    """Output columns of one item of the bf16 body: ``n_mat`` 1 for the
    down product, 2 for the fused gate/up (needs the built library)."""
    return _lib().ragged_sm90_tile_cols(n_mat)


def simt90_chunk_rows() -> int:
    """Rows of one expert chunk of the fp32 body (needs the library)."""
    return _lib().ragged_simt90_chunk_rows()


def simt90_tile_cols(n_mat: int) -> int:
    """Output columns of one item of the fp32 body, as ``sm90_tile_cols``."""
    return _lib().ragged_simt90_tile_cols(n_mat)


def _launch(name: str, xs: torch.Tensor, w: torch.Tensor,
            u: Optional[torch.Tensor], group_sizes: torch.Tensor,
            activation: str = "silu") -> torch.Tensor:
    """One call of ``ragged_launch``: the down product (``u`` None) or the
    fused gate/up (``w`` the gate weight, ``u`` the up weight)."""
    N, K = xs.shape
    E, _, F = w.shape
    sizes = group_sizes.to(torch.int32).contiguous()   # no-op when it is
    out = torch.empty((N, F), dtype=xs.dtype, device=xs.device)
    body, launches = ctypes.c_int(-1), ctypes.c_int(0)
    with torch.cuda.device(xs.device):
        status = _lib().ragged_launch(
            _DTYPES[xs.dtype], 1 if u is None else 2, _ACTS[activation],
            xs.data_ptr(), w.data_ptr(), (w if u is None else u).data_ptr(),
            out.data_ptr(), sizes.data_ptr(), N, K, F, E,
            torch.cuda.current_stream().cuda_stream, ctypes.byref(body),
            ctypes.byref(launches))
    build.check(status, name)
    route = _ROUTES[body.value // 2]
    # lint: allow[T106] credited by RoundGraphs on every replay
    LAUNCHES[name] += launches.value
    # lint: allow[T106] a replay launches what its capture did
    LAST_ROUTE[name] = route
    # lint: allow[T106] a replay launches what its capture did
    LAST_PRODUCER[name] = _PRODUCERS[body.value]
    # lint: allow[T106] eager runs and captures only (chip_smoke's checks)
    ROUTE_LAUNCHES[name, route] += launches.value
    return out


def _counted(xs: torch.Tensor, ws, group_sizes: torch.Tensor
             ) -> torch.Tensor:
    """A product on the meta device: record its work (PERF.md's bound rule
    for kernels 1-2: 2·rows·D·F FLOPs a weight; the rows of ``xs``, the
    weights of every expert with a row, the sizes and the output rows
    moved once each) and return its empty (N, F) result."""
    if group_sizes.is_meta:
        raise ValueError("a ragged kernel on the meta device needs group "
                         "sizes with values (launch/costs."
                         "stated_group_sizes)")
    # lint: allow[T104] meta tensors only (the dry-run), never captured
    sizes = group_sizes.tolist()
    N, D = xs.shape
    F = ws[0].shape[2]
    rows = min(sum(sizes), N)
    active = sum(s > 0 for s in sizes)
    es = xs.element_size()
    costs.record_kernel(
        2 * rows * D * F * len(ws),
        rows * D * es + active * len(ws) * D * F * ws[0].element_size()
        + len(sizes) * group_sizes.element_size() + rows * F * es)
    return xs.new_empty((N, F))


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
    ``group_sizes`` sums to at most N; the rows past the last group are
    left unwritten (the plain version zeroes them).  ``bm`` is the
    reference's row tile and changes nothing: every bf16 call takes the
    ``sm90`` body (64-row expert chunks), every fp32 call ``simt90``."""
    refuse_autograd("ragged_gmm", xs, w)
    if xs.is_meta:
        return _counted(xs, (w,), group_sizes)
    if not _on_cuda(xs):
        return ragged_gmm_ref(xs, w, group_sizes)
    _check(xs, (w,), group_sizes)
    if xs.shape[0] == 0:
        return xs.new_empty((0, w.shape[2]))
    return _launch("ragged_gmm", xs, w, None, group_sizes)


def fused_gate_up(xs: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                  group_sizes: torch.Tensor, *, activation: str = "silu",
                  bm: Optional[int] = None) -> torch.Tensor:
    """``act(xs @ w_gate[g]) * (xs @ w_up[g])`` in ONE launch: (N, D) → (N, F).
    ``bm`` as for ``ragged_gmm``."""
    if activation not in _ACTS:
        raise ValueError(f"activation must be one of {sorted(_ACTS)}")
    refuse_autograd("fused_gate_up", xs, w_gate, w_up)
    if xs.is_meta:
        return _counted(xs, (w_gate, w_up), group_sizes)
    if not _on_cuda(xs):
        return fused_gate_up_ref(xs, w_gate, w_up, group_sizes, activation)
    _check(xs, (w_gate, w_up), group_sizes)
    if xs.shape[0] == 0:
        return xs.new_empty((0, w_gate.shape[2]))
    return _launch("fused_gate_up", xs, w_gate, w_up, group_sizes,
                   activation)


def ragged_moe_ffn(xs: torch.Tensor,         # (N, D) tokens sorted by expert
                   w_gate: torch.Tensor, w_up: torch.Tensor,
                   w_down: torch.Tensor,     # (E, F, D)
                   group_sizes: torch.Tensor, *, activation: str = "silu",
                   bm: Optional[int] = None) -> torch.Tensor:
    """Whole expert FFN on expert-sorted tokens in 2 launches:
    ``fused_gate_up``, then ``ragged_gmm`` of its ``h``, which is rounded to
    the input dtype between the launches, as in the reference.  Nothing
    else runs: each body builds its work list from ``group_sizes`` on the
    device.  ``bm`` (the reference's row tile, 128 by default there)
    changes nothing on the card or on the CPU."""
    if activation not in _ACTS:
        raise ValueError(f"activation must be one of {sorted(_ACTS)}")
    refuse_autograd("ragged_moe_ffn", xs, w_gate, w_up, w_down)
    if not xs.is_meta:
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
