"""Language model: embedding → (optional encoder) → decoder stack → head.

Port of ``repro.models.model.Model`` (attention, recurrent and hybrid
decoders, and whisper's encoder-decoder):

    model  = Model(cfg, moe_dispatch="gmm")            # device="cuda" default
    params = model.init(torch.Generator(model.device).manual_seed(0))
    cache  = model.init_cache(batch, max_seq)
    logits, cache = model.prefill(params, tokens, cache, lengths=...)
    logits, pend  = model.extend(params, tokens, cache, collect=True)
    cache  = model.commit(pend, n_commit, collected=True)

``prefill_with_hidden`` and ``extend_with_hidden`` also return the final
pre-head hidden states (what an EAGLE head reads), ``extend_with_prefetch``
scores an expert-prefetch plan while it verifies, and ``forward_hidden`` /
``forward_train`` are the cacheless forward with the router's metrics.

Cache layout::

    {"layers": [one dict per layer], "lengths": (B,) int32}
    layer:  "attn" {"k", "v"}, "swa" {"k", "v", "pos"} (a ring), "mla"
            {"latent", "k_rope"} (see attention.make_attn_cache);
            "mamba"/"mlstm"/"slstm": the recurrent state (models/ssm.py)
    paged:  "attn" {"k_pages", "v_pages"}, "mla" {"latent_pages",
            "k_rope_pages"}, rings and recurrent states dense, plus
            "pages": {"table": (B, max_pages) int32}
    encoder-decoder: also "cross": [{"k", "v"} (B, S_enc, Hkv, D) per
            layer], the encoder output's projections, written by prefill

``extend`` consumes T tokens per sequence at offsets ``lengths`` — T=1 is
plain decode, T=gamma+1 a speculative-decoding verify pass — and writes
their K/V into the cache in place; ``commit`` bumps ``lengths`` (stale
entries of a rejected suffix are masked by position, see attention.py).
Recurrent states cannot be rolled back: ``extend(collect=True)`` leaves
them as they were and hands every per-step state (T, B, ...) to the
pending cache (``pend["collected"]``), and ``commit(collected=True)``
copies step ``n_commit - 1`` of each row into the live state, in place
(taken modulo T: a row that commits 0 tokens takes the last step, as the
reference's index -1 does).  ``extend(collect=False)`` advances them
through all T tokens in place.

Paged KV (``init_cache(..., paged=True)``): every layer stores its K/V in
fixed-size pages of a physical pool (NP, page, Hkv, D), addressed through
one per-row block table ``cache["pages"]["table"]`` (B, max_pages).
Physical page 0 is the trash page that unallocated and retired rows point
at, so stale lanes write harmlessly and no index is ever negative.  The
table is data: ``PageAllocator`` assigns pages on the host, and the caller
pushes the table to the device between rounds; only pool growth
(``grow_cache_pages``) changes shapes.

``params["layers"]`` is a list with one block per layer; the reference
stacks each period slot's leaves over ``num_periods`` instead
(``models/convert.py`` maps one layout onto the other), so the cache
helpers below find batch on axis 0 where the reference finds it on axis 1.
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.distributed import collectives as col
from repro_torch.distributed.constraints import constrain
from repro_torch.models import attention as attn_mod
from repro_torch.models import transformer as tfm
from repro_torch.models.attention import GATHER_ON_CUDA, SWA_RING_PAD
from repro_torch.models.layers import (apply_norm, embed, init_embedding,
                                       init_norm, scale_embedding,
                                       sinusoidal_at, unembed)
from repro_torch.models.transformer import RECURRENT_KINDS


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[cfg.dtype]


def merge_cache_rows(old: dict, new: dict, mask,
                     row_block: Optional[slice] = None) -> dict:
    """Row-wise select between two same-shape DENSE decode caches: rows
    where ``mask`` (B,) is True take ``new`` (a fresh prefill), the others
    keep ``old``.  The full-pool admission primitive (``SDEngine.admit``).
    ``mask`` is a host array; the rows are copied into ``old``'s tensors in
    place (a session's graphs read them there), and the cache dict is
    returned.  Recurrent states are taken whole per row.  An
    encoder-decoder cache is refused, as in the reference (its cross K/V
    are per wave).  ``row_block``: the rows of ``mask`` that caches placed
    with their batch over ``"data"`` hold (``Model.row_block``)."""
    if old.get("cross") is not None:
        raise NotImplementedError(
            "merge_cache_rows: encoder-decoder cross caches are static "
            "per-wave; continuous admission is decoder-only")
    if row_block is not None:
        mask = np.asarray(mask, bool)[row_block]
    if old.get("pages") is not None:
        raise NotImplementedError(
            "merge_cache_rows needs two same-shape caches; a paged cache "
            "admits through scatter_cache_rows (the sliced path)")
    rows = torch.as_tensor(np.nonzero(np.asarray(mask, bool))[0],
                           device=old["lengths"].device)
    for lo, ln in zip(old["layers"], new["layers"]):
        for k in lo:
            lo[k][rows] = ln[k][rows]
    old["lengths"][rows] = new["lengths"][rows]
    return dict(old)


_PAGED_LEAF_PAIRS = (("k_pages", "k"), ("v_pages", "v"),
                     ("latent_pages", "latent"), ("k_rope_pages", "k_rope"))


def scatter_cache_rows(old: dict, new: dict, rows, *, valid=None,
                       n_prompt: Optional[int] = None,
                       row_block: Optional[slice] = None,
                       table: Optional[torch.Tensor] = None) -> dict:
    """Row-scatter a COMPACT (R-row) fresh cache into a live B-row cache.

    The row-sliced admission primitive (``SDEngine.admit_rows``): ``new``
    is a dense prefill of only the admitted rows, ``rows`` (R,) the pool
    row each goes to, ``valid`` (R,) marks real lanes (bucketing pads
    replicate admissions; they are dropped).  ``rows`` and ``valid`` are
    host arrays from the scheduler, so the dropped lanes are filtered on
    the host: a boolean index on a device tensor would sync.

    Dense leaves (recurrent states included) take whole rows; paged leaves
    take the first ``n_prompt`` positions (rounded up to whole pages)
    through ``old``'s block table, which must already map the admitted
    rows.  ``new`` must be dense with the live cache's logical capacity.
    Updates ``old``'s tensors in place (a functional update would copy the
    whole pool per admission) and returns the cache dict.  An
    encoder-decoder cache is refused, as in the reference.

    A live cache placed with its batch over ``"data"`` holds the rows
    ``row_block`` of the whole batch: its row leaves take the admitted rows
    it holds, and its page pools, whole on every rank, take every admitted
    row through the whole block ``table`` (``Model.whole_rows``); ``new``
    must hold every admitted row."""
    if old.get("cross") is not None:
        raise NotImplementedError(
            "scatter_cache_rows: continuous admission is decoder-only")
    rows = np.asarray(rows, np.int64)
    keep = (np.arange(rows.shape[0]) if valid is None
            else np.nonzero(np.asarray(valid, bool))[0])
    dev = old["lengths"].device
    dst = torch.as_tensor(rows[keep], device=dev)
    src = torch.as_tensor(keep, device=dev)
    # the admitted rows this rank's row leaves hold, at their local index
    mine = keep
    if row_block is not None:
        held = (rows[keep] >= row_block.start) & (rows[keep] < row_block.stop)
        mine = keep[held]
    dst_row = torch.as_tensor(rows[mine] - (row_block.start if row_block
                                            else 0), device=dev)
    src_row = torch.as_tensor(mine, device=dev)
    if table is None and old.get("pages") is not None:
        table = old["pages"]["table"]
    paged_to_dense = dict(_PAGED_LEAF_PAIRS)
    for lo, ln in zip(old["layers"], new["layers"]):
        for k, leaf in lo.items():
            if k not in paged_to_dense:
                leaf[dst_row] = ln[k][src_row]
                continue
            n = ln[paged_to_dense[k]]
            ps, S_f = leaf.shape[1], n.shape[1] - 1     # minus the trash slot
            span = S_f if n_prompt is None else min(-(-n_prompt // ps) * ps,
                                                    S_f)
            pos = torch.arange(span, device=dev)
            lp = (pos // ps).clamp(max=table.shape[1] - 1)
            pid = table[dst][:, lp].to(torch.int64)              # (R', span)
            leaf[pid, (pos % ps)[None, :]] = n[src, :span]
    old["lengths"][dst_row] = new["lengths"][src_row]
    return dict(old)


class PageAllocator:
    """Host-side block manager for a paged decode cache (port of
    ``repro.models.model.PageAllocator``).

    A free list over the physical pool, per-row page ownership, and a
    (B, max_pages) logical->physical table the forwards consume as data.
    Physical page 0 is the trash page: never allocated, the target of every
    unassigned table entry, so retired rows' frozen-lane writes land
    harmlessly and reads stay in bounds.

    ``alloc``/``free_row`` mutate ``self.table`` in place; callers push it
    to the device after a change.  When ``can_alloc`` says no,
    ``grown_geometry`` gives the next pow2 (pool_pages, max_pages) to
    rebuild with via :func:`grow_cache_pages`.

    Pages are refcounted so rows can share a prompt prefix
    (:meth:`fork_prefix`); a sharing row that must write into a shared page
    first detaches it by copy-on-write (:meth:`cow_range`).
    """

    def __init__(self, batch: int, page_size: int, pool_pages: int,
                 max_pages: int):
        self.page_size = int(page_size)
        self.pool_pages = int(pool_pages)
        self.max_pages = int(max_pages)
        self.free: List[int] = list(range(1, self.pool_pages))
        self.owned: Dict[int, List[int]] = {}
        self.reserved: List[int] = []
        self.ref: Dict[int, int] = {}
        self.table = np.zeros((batch, self.max_pages), np.int32)

    def pages_for(self, n_positions: int) -> int:
        return -(-int(n_positions) // self.page_size)

    def can_alloc(self, n_positions: int) -> bool:
        need = self.pages_for(n_positions)
        return need <= len(self.free) and need <= self.max_pages

    def alloc(self, row: int, n_positions: int) -> None:
        """Assign pages covering ``n_positions`` to ``row`` (must be free)."""
        need = self.pages_for(n_positions)
        if row in self.owned:
            raise ValueError(f"row {row} already owns pages; free_row first")
        if need > len(self.free) or need > self.max_pages:
            raise ValueError(
                f"cannot allocate {need} pages (free={len(self.free)}, "
                f"max_pages={self.max_pages}); grow the pool first")
        pages = [self.free.pop() for _ in range(need)]
        for p in pages:
            self.ref[p] = 1
        self.owned[row] = pages
        self.table[row, :] = 0
        self.table[row, :need] = pages

    def fork_prefix(self, src: int, dst: int, n_positions: int) -> int:
        """Share ``src``'s pages covering its first ``n_positions`` with
        ``dst`` (which must own nothing); returns the pages shared."""
        need = self.pages_for(n_positions)
        if dst in self.owned:
            raise ValueError(f"row {dst} already owns pages; free_row first")
        src_pages = self.owned.get(src)
        if src_pages is None or len(src_pages) < need:
            raise ValueError(
                f"row {src} owns {0 if src_pages is None else len(src_pages)}"
                f" pages, cannot share {need}")
        pages = list(src_pages[:need])
        for p in pages:
            self.ref[p] += 1
        self.owned[dst] = pages
        self.table[dst, :] = 0
        self.table[dst, :need] = pages
        return need

    def extend_row(self, row: int, n_positions: int) -> int:
        """Grow ``row``'s ownership with private pages until it covers
        ``n_positions``; returns the pages added."""
        if row not in self.owned:
            raise ValueError(f"row {row} owns no pages; alloc or "
                             "fork_prefix first")
        need = self.pages_for(n_positions)
        have = len(self.owned[row])
        extra = need - have
        if extra <= 0:
            return 0
        if extra > len(self.free) or need > self.max_pages:
            raise ValueError(
                f"cannot extend row {row} by {extra} pages "
                f"(free={len(self.free)}, max_pages={self.max_pages})")
        pages = [self.free.pop() for _ in range(extra)]
        for p in pages:
            self.ref[p] = 1
        self.owned[row].extend(pages)
        self.table[row, have:need] = pages
        return extra

    def cow_range(self, row: int, start: int, end: int) -> List[Tuple[int, int]]:
        """Detach every SHARED page of ``row`` covering positions
        [start, end) onto a fresh private page; returns the (src, dst)
        physical pairs the caller must copy on the device before writing."""
        pages = self.owned.get(row, [])
        pairs: List[Tuple[int, int]] = []
        lp0 = int(start) // self.page_size
        lp1 = min(-(-int(end) // self.page_size), len(pages))
        for lp in range(max(lp0, 0), lp1):
            p = pages[lp]
            if self.ref[p] > 1:
                if not self.free:
                    raise ValueError(
                        f"cow_range: no free page to detach page {p} of "
                        f"row {row}; grow the pool first")
                fresh = self.free.pop()
                self.ref[p] -= 1
                self.ref[fresh] = 1
                pages[lp] = fresh
                self.table[row, lp] = fresh
                pairs.append((p, fresh))
        return pairs

    def shared_page_count(self) -> int:
        """Physical pages referenced by more than one row."""
        return sum(1 for c in self.ref.values() if c > 1)

    def free_row(self, row: int) -> None:
        """Drop ``row``'s references (pages return to the pool at refcount
        zero) and point its table at trash.  Freeing a row that owns
        nothing is a no-op; a page already free or untracked raises."""
        pages = self.owned.pop(row, [])
        for p in pages:
            c = self.ref.get(p)
            if c is None or p in self.free:
                raise ValueError(
                    f"double free: row {row} page {p} is already "
                    "free/untracked — page ownership is corrupted")
            if c > 1:
                self.ref[p] = c - 1
            else:
                del self.ref[p]
                self.free.append(p)
        self.table[row, :] = 0

    def free_fraction(self) -> float:
        """Fraction of allocatable pages (trash excluded) currently free."""
        return len(self.free) / max(self.pool_pages - 1, 1)

    def reserve(self, n: int) -> List[int]:
        """Withdraw ``n`` pages from the free list without a row."""
        if n > len(self.free):
            raise ValueError(f"cannot reserve {n} pages ({len(self.free)} "
                             "free)")
        pages = [self.free.pop() for _ in range(n)]
        self.reserved.extend(pages)
        return pages

    def release(self, pages: List[int]) -> None:
        """Return pages taken by :meth:`reserve`; a page never reserved, or
        released twice, raises."""
        for p in pages:
            if p not in self.reserved:
                raise ValueError(f"release of page {p} that is not "
                                 "reserved (double release?)")
            self.reserved.remove(p)
            if p in self.free:
                raise ValueError(f"double free: page {p} already in the "
                                 "free list")
            self.free.append(p)

    def assert_no_leaks(self) -> None:
        """End-of-stream invariant: no row owns pages, no reservation is
        out, the free list holds exactly ``pool_pages - 1`` distinct pages
        and every table entry points at trash.  Raises ``RuntimeError``
        listing every violated condition."""
        problems = []
        if self.owned:
            problems.append(f"rows still own pages: {sorted(self.owned)}")
        if self.reserved:
            problems.append(f"outstanding reservations: "
                            f"{sorted(self.reserved)}")
        if len(self.free) != self.pool_pages - 1:
            problems.append(f"free list has {len(self.free)} pages, "
                            f"expected {self.pool_pages - 1}")
        if len(set(self.free)) != len(self.free):
            problems.append("free list contains duplicates")
        if self.ref:
            shared = self.shared_page_count()
            problems.append(
                f"{len(self.ref)} pages still refcounted "
                f"({shared} of them shared): {sorted(self.ref)[:16]}")
        if self.table.any():
            rows = sorted(set(np.nonzero(self.table)[0].tolist()))
            problems.append(f"table rows still mapped: {rows}")
        if problems:
            raise RuntimeError("PageAllocator leak check failed: "
                               + "; ".join(problems))

    def grown_geometry(self, n_positions: int) -> Tuple[int, int]:
        """(pool_pages, max_pages) after pow2 growth that fits an
        allocation of ``n_positions`` more positions."""
        need = self.pages_for(n_positions)
        max_pages = self.max_pages
        while need > max_pages:
            max_pages *= 2
        pool = self.pool_pages
        while need > pool - 1 - (self.pool_pages - 1 - len(self.free)):
            pool *= 2
        return pool, max_pages

    def grow(self, pool_pages: int, max_pages: int) -> None:
        """Adopt a grown geometry (pool and device table already padded
        by :func:`grow_cache_pages`)."""
        assert pool_pages >= self.pool_pages and max_pages >= self.max_pages
        self.free.extend(range(self.pool_pages, pool_pages))
        self.table = np.pad(self.table,
                            ((0, 0), (0, max_pages - self.max_pages)))
        self.pool_pages, self.max_pages = pool_pages, max_pages


def _pad_tail(leaf: torch.Tensor, axis: int, extra: int) -> torch.Tensor:
    """``leaf`` with ``extra`` zero slots appended along ``axis``."""
    shape = list(leaf.shape)
    shape[axis] = extra
    return torch.cat([leaf, leaf.new_zeros(shape)], dim=axis)


def grow_cache_pages(cache: dict, pool_pages: int, max_pages: int) -> dict:
    """Pad a paged cache to a larger pool / logical capacity: pool leaves
    along the physical-page axis, the block table along the logical-page
    axis (new entries point at trash page 0).  Dense leaves (SWA rings) and
    lengths are untouched."""
    if cache.get("pages") is None:
        raise ValueError("grow_cache_pages: not a paged cache")

    def grow_slot(slot):
        out = dict(slot)
        for paged_key, _ in _PAGED_LEAF_PAIRS:
            if paged_key not in slot:
                continue
            extra = pool_pages - slot[paged_key].shape[0]
            if extra:
                out[paged_key] = _pad_tail(slot[paged_key], 0, extra)
        return out

    table = cache["pages"]["table"]
    extra_lp = max_pages - table.shape[1]
    if extra_lp:
        table = _pad_tail(table, 1, extra_lp)
    return dict(cache, layers=[grow_slot(s) for s in cache["layers"]],
                pages=dict(cache["pages"], table=table))


def copy_cache_pages(cache: dict, pairs) -> dict:
    """Copy physical pages src -> dst across every paged leaf, in place.

    The copy-on-write step: after :meth:`PageAllocator.cow_range` hands back
    (src, dst) pairs, this clones their contents so the detached row keeps
    its shared-prefix KV.  Callers pad ``pairs`` to a bucketed count with
    (0, 0) trash self-copies.  The pool tensors are written where they are
    (the session's round graphs read them there) and the cache dict is
    returned."""
    if cache.get("pages") is None:
        raise ValueError("copy_cache_pages: not a paged cache")
    if not pairs:
        return cache
    dev = cache["lengths"].device
    src = torch.as_tensor([p[0] for p in pairs], dtype=torch.int64, device=dev)
    dst = torch.as_tensor([p[1] for p in pairs], dtype=torch.int64, device=dev)
    for slot in cache["layers"]:
        for paged_key, _ in _PAGED_LEAF_PAIRS:
            if paged_key in slot:
                leaf = slot[paged_key]
                leaf[dst] = leaf[src]   # the gather is read before the write
    return cache


def grow_cache_seq(cache: dict, cfg: ModelConfig, new_max_seq: int) -> dict:
    """Raise a DENSE cache's logical capacity to ``new_max_seq``: the
    draft-side companion of :func:`grow_cache_pages`.  Full-attention K/V
    and MLA latents take the new positions before the trailing trash slot,
    which stays last.  A SWA ring only matches if its window already fit the
    old capacity: a resize would remap the ``pos % w`` slots of live data,
    so it raises, as in the reference.  Recurrent states have no sequence
    axis and stay as they are."""
    def grow(leaf):
        S = leaf.shape[1] - 1
        if new_max_seq <= S:
            return leaf
        grown = leaf.new_zeros((leaf.shape[0], new_max_seq + 1)
                               + tuple(leaf.shape[2:]))
        grown[:, :S] = leaf[:, :S]
        return grown

    def grow_slot(slot, kind):
        if kind in RECURRENT_KINDS:
            return slot
        if kind == "swa":
            w_new = min(cfg.sliding_window + SWA_RING_PAD, new_max_seq)
            if slot["k"].shape[1] != w_new:
                raise NotImplementedError(
                    "grow_cache_seq: SWA ring resize would remap live "
                    "slots; size the stream so capacity >= window + pad")
            return slot
        return {k: grow(v) for k, v in slot.items()}

    return dict(cache, layers=[
        grow_slot(slot, kind)
        for slot, (kind, _) in zip(cache["layers"], tfm.layer_kinds(cfg))])


def _leaves(cache: dict) -> List[torch.Tensor]:
    """Every tensor of a decode cache, in a fixed order."""
    out = [leaf for slot in cache["layers"] for leaf in slot.values()]
    out += [leaf for slot in cache.get("cross") or () for leaf in slot.values()]
    out.append(cache["lengths"])
    if cache.get("pages") is not None:
        out.append(cache["pages"]["table"])
    return out


def _leaf_shapes(cache: dict) -> list:
    return [(tuple(t.shape), t.dtype) for t in _leaves(cache)]


def _page_table(cache: dict) -> Optional[torch.Tensor]:
    pages = cache.get("pages")
    return None if pages is None else pages["table"]


class Model:
    """Language model on one device: a decoder stack of any block kinds,
    with an encoder in front for an encoder-decoder config."""

    def __init__(self, cfg: ModelConfig, *, moe_dispatch: str = "onehot",
                 use_flash: bool = False, remat: bool = False,
                 paged_attention: str = "kernel", device=None, mesh=None,
                 mesh_layout: Optional[str] = None):
        if paged_attention not in ("kernel", "gather"):
            raise ValueError(
                f"paged_attention must be 'kernel' or 'gather', got "
                f"{paged_attention!r}")
        self.cfg = cfg
        self.moe_dispatch = moe_dispatch
        self.use_flash = use_flash
        # per-layer checkpoints in a forward under autograd (training)
        self.remat = remat
        self.paged_attention = paged_attention
        self.device = resolve_device(device)
        if paged_attention == "gather" and self.device.type == "cuda":
            raise ValueError(GATHER_ON_CUDA)
        self.dtype = torch_dtype(cfg)
        # the mesh is threaded explicitly to every MoE layer's "ep" dispatch
        # (distributed/collectives.py); None is one device
        if mesh is not None:
            from repro_torch.distributed.constraints import resolve_mesh
            mesh, mesh_layout = resolve_mesh(mesh, mesh_layout)
        self.mesh = mesh
        self.mesh_layout = mesh_layout
        # the resolved spec of every params leaf under the mesh, recorded by
        # place(); None: the params are whole
        self.placement = None
        # target/draft forward passes run (prefill + extend) and the prefills
        # among them, for callers that check how many times each kernel of a
        # forward must launch
        self.forward_count = 0
        self.prefill_count = 0

    @property
    def _mesh_kw(self) -> dict:
        return {"mesh": self.mesh, "mesh_layout": self.mesh_layout}

    # ------------------------------------------------------------ placement
    def place(self, params, *, fsdp: bool = False, fsdp_min_size: int = 0):
        """This rank's blocks of whole ``params`` under the mesh
        (``distributed/sharding.shard_params``: fsdp=False serves, True
        trains), and the placement every forward on them reads; whole
        ``params`` without a mesh."""
        if self.mesh is None:
            return params
        from repro_torch.distributed import sharding as sh
        specs = sh.param_placement(params, self.mesh, fsdp=fsdp,
                                   fsdp_min_size=fsdp_min_size,
                                   layout=self.mesh_layout)
        self.placement = sh.resolve_tree(specs, sh.mesh_dims(self.mesh))
        return sh.shard_params(params, self.mesh, fsdp=fsdp,
                               fsdp_min_size=fsdp_min_size,
                               layout=self.mesh_layout)

    def _shard(self, batch_axes=()) -> Optional[col.Shard]:
        """This rank's place on the mesh, with the params' placement (None
        without a mesh)."""
        if self.mesh is None:
            return None
        return col.Shard(self.mesh, self.mesh_layout, batch_axes,
                         params=self.placement)

    def _keep(self, kind: str, is_moe: bool):
        """Which leaves of a layer of ``kind`` compute on their ``"model"``
        block (Megatron's column/row split, the experts under the "ep"
        dispatch); ``Model._prepare`` gathers the others."""
        gqa = kind in ("attn", "swa")
        experts = not is_moe or self.moe_dispatch == "ep"

        def keep(path: str) -> bool:
            if gqa and re.search(r"mixer/(wq|wk|wv|wo|bq|bk|bv)$", path):
                return True
            if "ffn/shared/" in path:
                return True
            return experts and bool(re.search(r"ffn/(w_gate|w_up|w_down)$",
                                              path))
        return keep

    def _prepare(self, shard, cache=None, prefix: str = "layers"):
        """``prepare(l, params)`` for ``stack_forward``: layer ``l``'s params
        as it computes on them and its ``Shard`` (those params' remaining
        specs, its cache's leaf specs, marked as a layer's: a census counts
        what it issues ``in_loop``); None without a mesh."""
        if shard is None:
            return None
        shard = shard.replace(in_stack=True)
        specs = self.placement
        for part in prefix.split("/"):
            specs = None if specs is None else specs[part]
        cfg = self.enc_cfg if prefix.startswith("encoder") else self.cfg
        kinds = tfm.layer_kinds(cfg)
        place = None if cache is None else cache.get("placement")

        def prepare(l: int, params: dict):
            params, left = col.materialize(
                params, None if specs is None else specs[l], shard,
                self._keep(*kinds[l]), f"{prefix}/{l}")
            return params, shard.replace(
                params=left, cache=None if place is None else place.layer(l))
        return prepare

    def _top(self, params, name: str, shard):
        """A top-level leaf group (embed, head, final norms) as computed on,
        and its ``Shard``: a vocab table keeps its ``"model"`` block."""
        for part in name.split("/"):
            params = params[part]
        if shard is None:
            return params, None
        params, left = col.materialize(params, shard.sub(*name.split("/"))
                                       .params, shard,
                                       lambda path: path.endswith("table"),
                                       name)
        return params, shard.replace(params=left)

    def row_block(self, cache: dict) -> Optional[slice]:
        """The rows of the whole batch a cache placed with its batch over
        ``"data"`` holds (its ``CachePlacement``); None when it holds them
        all."""
        place = cache.get("placement")
        if place is None or place.rows is None:
            return None
        lo, n = place.rows
        return slice(lo, lo + n)

    def _rows(self, tokens: torch.Tensor, cache: dict):
        """(shard, this rank's rows of ``tokens``, their slice) for a pass
        over a cache: a cache placed with its batch over ``"data"`` holds
        B / d rows, and the pass runs those rows only (slice None: all)."""
        shard = self._shard()
        rows = self.row_block(cache)
        if rows is None:
            return shard, tokens, None
        return shard.with_batch(("data",)), tokens[rows], rows

    def whole_rows(self, cache: dict, leaf: torch.Tensor) -> torch.Tensor:
        """``leaf`` (a per-row leaf of ``cache``: ``lengths``, the block
        table) over the whole batch, all-gathered when ``cache`` holds a
        block of the rows."""
        if self.row_block(cache) is None:
            return leaf
        return col.gather(leaf, 0, self._shard(), "data")

    def cache_lengths(self, cache: dict) -> torch.Tensor:
        """The cache's ``lengths`` over the whole batch."""
        return self.whole_rows(cache, cache["lengths"])

    @property
    def enc_cfg(self) -> ModelConfig:
        """The encoder's config: ``encoder_layers`` dense attention blocks."""
        cfg = self.cfg
        return cfg.with_overrides(
            num_layers=cfg.encoder_layers, layer_pattern=("attn",),
            moe_pattern=(False,), num_experts=0, num_experts_per_tok=0)

    # ------------------------------------------------------------------ init
    def init(self, generator: torch.Generator) -> dict:
        """Random parameters on ``self.device`` drawn from ``generator``
        (which must live on the same device)."""
        cfg, dt = self.cfg, self.dtype
        kw = dict(generator=generator, device=self.device)
        params: Dict[str, Any] = {
            "embed": init_embedding(cfg.vocab_size, cfg.d_model, dt, **kw),
            "final_norm": init_norm(cfg, dt, self.device),
            "layers": tfm.init_stack(cfg, dt, cross=cfg.is_encoder_decoder,
                                     **kw),
        }
        if not cfg.tie_embeddings:
            params["head"] = init_embedding(cfg.vocab_size, cfg.d_model, dt, **kw)
        if cfg.is_encoder_decoder:
            enc = self.enc_cfg
            params["encoder"] = {"layers": tfm.init_stack(enc, dt, **kw),
                                 "final_norm": init_norm(enc, dt, self.device)}
        return params

    # ----------------------------------------------------------------- embed
    def _embed(self, params, tokens, positions, inputs_embeds=None,
               shard=None):
        cfg = self.cfg
        if inputs_embeds is not None:   # a frontend's embeddings (vision stub)
            x = torch.as_tensor(inputs_embeds, device=self.device).to(
                self.dtype)
        else:
            table, tshard = self._top(params, "embed", shard)
            gemma = cfg.name.startswith("gemma")
            if tshard is not None and tshard.blocked("table"):  # vocab-parallel
                x = col.vocab_embed(table["table"], tokens, tshard)
                x = scale_embedding(x) if gemma else x
            else:
                x = embed(table, tokens, scale=gemma)
        if cfg.rope_type == "sinusoidal":
            x = x + sinusoidal_at(positions, cfg.d_model).to(x.dtype)
        return x

    def _head(self, params, x, shard=None):
        """Full-vocab logits of ``x``'s rows: a vocab-parallel table gives
        this rank's columns (*f* at its input), all-gathered over
        ``"model"``."""
        cfg = self.cfg
        x = apply_norm(self._top(params, "final_norm", shard)[0], x,
                       cfg.norm_eps)
        table, tshard = self._top(
            params, "embed" if cfg.tie_embeddings else "head", shard)
        if tshard is None or not tshard.blocked("table"):
            return unembed(table, x, cfg.final_logit_softcap)
        logits = unembed(table, col.copy_to(x, shard),
                         cfg.final_logit_softcap)
        return col.gather(logits, logits.dim() - 1, shard)

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, dtype=torch.int64, device=self.device)

    # --------------------------------------------------------------- encoder
    def encode(self, params, encoder_embeds, shard=None) -> torch.Tensor:
        """Whisper-style encoder over stub frame embeddings (B, S_enc, d):
        sinusoidal positions, ``encoder_layers`` bidirectional attention
        blocks (plain attention, as in the reference: no kernel), final
        norm."""
        cfg = self.enc_cfg
        x = torch.as_tensor(encoder_embeds, device=self.device).to(self.dtype)
        B, S, _ = x.shape
        positions = torch.arange(S, device=self.device)[None, :].expand(B, S)
        x = x + sinusoidal_at(positions, cfg.d_model).to(x.dtype)
        x, _, _ = tfm.stack_forward(params["encoder"]["layers"], cfg, x,
                                    positions, None, mode="prefill",
                                    causal=False, use_flash=False,
                                    remat=self.remat, shard=shard,
                                    prepare=self._prepare(
                                        shard, prefix="encoder/layers"))
        return apply_norm(self._top(params, "encoder/final_norm", shard)[0],
                          x, cfg.norm_eps)

    def _cross_kvs(self, params, enc_out, shard=None) -> List[dict]:
        """The encoder output projected through every decoder layer's
        cross-attention K/V (whole weights: ``_prepare`` gathers them)."""
        prepare = self._prepare(shard)
        return [attn_mod.cross_attn_prefill_cache(
            (lp if prepare is None else prepare(l, lp)[0])["cross"],
            self.cfg, enc_out, self.dtype)
            for l, lp in enumerate(params["layers"])]

    def _encoder_kvs(self, params, encoder_embeds, shard=None) -> List[dict]:
        if encoder_embeds is None:
            raise ValueError(
                f"{self.cfg.name} is an encoder-decoder: pass "
                "encoder_embeds (B, S_enc, d), the frontend stub's frames")
        return self._cross_kvs(params, self.encode(params, encoder_embeds,
                                                   shard), shard)

    # ----------------------------------------------------------------- cache
    def init_cache(self, batch: int, max_seq: int, *, paged: bool = False,
                   page_size: int = 64, pool_pages: Optional[int] = None,
                   reuse: Optional[dict] = None, device=None,
                   placed: bool = False, kv_mode: str = "auto",
                   split_batch: bool = True) -> dict:
        """Allocate a decode cache.

        Dense (default): every attention layer holds (B, max_seq) K/V (plus
        the trash slot of attention.make_attn_cache).  ``paged=True``: every
        layer holds a pool of ``pool_pages`` pages of ``page_size``
        positions (default: every row at ``max_seq`` plus the trash page),
        addressed through ``cache["pages"]["table"]``
        (B, ceil(max_seq / page_size)); ``max_seq`` is then the logical
        capacity, growable with :func:`grow_cache_pages`.  Recurrent layers
        hold their state (B, ...), zero; an encoder-decoder also holds the
        cross K/V of ``encoder_seq_len`` frames, which prefill writes.

        ``reuse``: a cache of exactly this shape, reset in place instead of
        allocating (every leaf zeroed, ``lengths``, the table, recurrent
        states and cross K/V included, a ring's ``pos`` set back to -1) and
        returned, so tensors a captured round reads keep their addresses.
        ``device`` overrides the model's (``"meta"`` gives the shapes
        alone).

        ``placed`` under a mesh (a session's target cache, as the
        reference's SDEngine places it; a draft's stays whole): every leaf
        is allocated at this rank's block (``distributed/sharding.
        cache_spec``: batch over ``"data"``, KV heads or, when the model
        axis does not divide them, the sequence over ``"model"``; recurrent
        states over their first divisible dim), never whole, and the cache
        carries its ``CachePlacement`` under ``"placement"``.
        ``kv_mode="heads"`` keeps the sequence whole (a compact admission
        cache scattered into a page pool, which splits heads only);
        ``split_batch=False`` keeps the batch whole over ``"data"`` (a
        compact admission cache, whose rows may go to any rank's)."""
        dev = self.device if device is None else torch.device(device)
        if reuse is not None:
            want = self.init_cache(batch, max_seq, paged=paged,
                                   page_size=page_size,
                                   pool_pages=pool_pages, device="meta",
                                   placed=placed, kv_mode=kv_mode,
                                   split_batch=split_batch)
            if _leaf_shapes(want) != _leaf_shapes(reuse):
                raise ValueError("init_cache(reuse=...): the cache to reuse "
                                 "does not have the requested shape")
            for leaf in _leaves(reuse):
                leaf.zero_()
            for slot in reuse["layers"]:
                if "pos" in slot:
                    slot["pos"].fill_(-1)
            return reuse
        if placed and self.mesh is not None:
            return self._placed_cache(batch, max_seq, paged=paged,
                                      page_size=page_size,
                                      pool_pages=pool_pages, device=dev,
                                      kv_mode=kv_mode,
                                      split_batch=split_batch)
        cfg = self.cfg
        cache: Dict[str, Any] = {
            "layers": tfm.make_stack_cache(cfg, batch, max_seq,
                                           self.dtype, dev,
                                           paged=paged, page_size=page_size,
                                           pool_pages=pool_pages),
            "lengths": torch.zeros((batch,), dtype=torch.int32, device=dev),
        }
        if paged:
            cache["pages"] = {"table": torch.zeros(
                (batch, -(-max_seq // page_size)), dtype=torch.int32,
                device=dev)}
        if cfg.is_encoder_decoder:
            shape = (batch, cfg.encoder_seq_len, cfg.num_kv_heads,
                     cfg.head_dim)
            cache["cross"] = [
                {k: torch.zeros(shape, dtype=self.dtype, device=dev)
                 for k in ("k", "v")} for _ in range(cfg.num_layers)]
        return cache

    def _placed_cache(self, batch: int, max_seq: int, *, paged, page_size,
                      pool_pages, device, kv_mode, split_batch) -> dict:
        from repro_torch.distributed import sharding as sh
        whole = self.init_cache(batch, max_seq, paged=paged,
                                page_size=page_size, pool_pages=pool_pages,
                                device="meta")
        dims = sh.mesh_dims(self.mesh)

        def make(path, leaf, spec, trash):
            shape = sh.local_cache_shape(leaf.shape, spec, trash, dims)
            return torch.full(shape, -1 if path.endswith("/pos") else 0,
                              dtype=leaf.dtype, device=device)

        return sh.place_cache(whole, self.mesh, make, kv_mode, split_batch)

    # ----------------------------------------------------------------- train
    def forward_hidden(self, params, tokens, *, inputs_embeds=None,
                       encoder_embeds=None, mrope_positions=None,
                       batch_axes=()) -> Tuple[torch.Tensor, dict]:
        """Final pre-head hidden states (B, T, d) of a cacheless causal
        forward over ``tokens`` (B, T) (or ``inputs_embeds`` (B, T, d), when
        given, with ``tokens`` None), and the MoE metrics summed over layers
        (``aux_loss``, ``expert_counts``).  An encoder-decoder reads
        ``encoder_embeds`` (B, S_enc, d).  The train forward of
        ``training/train_loop.py``; with ``remat``, under autograd, each
        layer runs under a checkpoint.  Under a mesh the rows given are
        this rank's, split over ``batch_axes`` (``sharding.shard_batch``)."""
        if inputs_embeds is None:
            tokens = self._tokens(tokens)
            B, T = tokens.shape
        else:
            B, T = inputs_embeds.shape[:2]
        shard = self._shard(batch_axes)
        positions = torch.arange(T, device=self.device)[None, :].expand(B, T)
        cross_kvs = (self._encoder_kvs(params, encoder_embeds, shard)
                     if self.cfg.is_encoder_decoder else None)
        x, metrics, _ = tfm.stack_forward(
            params["layers"], self.cfg,
            self._embed(params, tokens, positions, inputs_embeds, shard),
            positions, None, mode="prefill", dispatch=self.moe_dispatch,
            **self._mesh_kw,
            use_flash=self.use_flash, cross_kvs=cross_kvs, want_metrics=True,
            mrope_positions=self._mrope(mrope_positions), remat=self.remat,
            shard=shard, prepare=self._prepare(shard))
        self.forward_count += 1
        return x, metrics

    def forward_train(self, params, tokens, **kw) -> Tuple[torch.Tensor, dict]:
        """Logits (B, T, V) of :meth:`forward_hidden` and its metrics."""
        x, metrics = self.forward_hidden(params, tokens, **kw)
        return self._head(params, x, self._shard(kw.get("batch_axes", ()))
                          ), metrics

    def _mrope(self, mrope_positions) -> Optional[torch.Tensor]:
        return None if mrope_positions is None else torch.as_tensor(
            mrope_positions, device=self.device)

    # --------------------------------------------------------------- prefill
    def prefill(self, params, tokens, cache: dict, *, lengths=None,
                inputs_embeds=None, encoder_embeds=None,
                mrope_positions=None) -> Tuple[torch.Tensor, dict]:
        """Prefill padded prompts (B, T); returns the logits at each
        sequence's last prompt position (B, V) and the filled cache.
        ``inputs_embeds`` (B, T, d) replaces the token embeddings (a
        frontend's output); ``encoder_embeds`` (B, S_enc, d) are an
        encoder-decoder's frames, encoded once into the cache's cross K/V;
        ``mrope_positions`` (B, T, 3) are M-RoPE's (t, h, w) ids (text-only
        positions when None).  A recurrent layer runs over the whole padded
        bucket, as the reference's does, so its state is only right for a
        row that fills it (ROADMAP queue 3)."""
        last, _, cache = self.prefill_with_hidden(
            params, tokens, cache, lengths=lengths,
            inputs_embeds=inputs_embeds, encoder_embeds=encoder_embeds,
            mrope_positions=mrope_positions)
        return last, cache

    def prefill_with_hidden(self, params, tokens, cache: dict, *,
                            lengths=None, inputs_embeds=None,
                            encoder_embeds=None, mrope_positions=None
                            ) -> Tuple[torch.Tensor, torch.Tensor, dict]:
        """:meth:`prefill` that also returns the pre-head hidden state at
        each sequence's last prompt position (B, d): the feature carry of
        hidden-feeding proposers (``core/eagle.EagleProposer``)."""
        tokens = self._tokens(tokens)
        B, T = tokens.shape
        if lengths is None:
            lengths = torch.full((B,), T, dtype=torch.int32, device=self.device)
        lengths = torch.as_tensor(lengths, dtype=torch.int32, device=self.device)
        shard, tokens, rows = self._rows(tokens, cache)
        if rows is not None:       # this data group's rows of every input
            lengths = lengths[rows]
            pick = lambda a: None if a is None else a[rows]
            inputs_embeds, encoder_embeds, mrope_positions = (
                pick(inputs_embeds), pick(encoder_embeds),
                pick(mrope_positions))
            B = tokens.shape[0]
        positions = torch.arange(T, device=self.device)[None, :].expand(B, T)
        if self.cfg.is_encoder_decoder:
            place = cache.get("placement")
            for l, (live, kv) in enumerate(zip(cache["cross"],
                                               self._encoder_kvs(
                    params, encoder_embeds, shard))):
                for n in ("k", "v"):
                    whole, blk = kv[n], live[n]
                    dim = None if place is None else shard.replace(
                        cache=place.layer(l)).cache_split(f"cross/{n}")
                    if dim is not None:   # this rank's heads or frames
                        whole = whole.narrow(dim, shard.j * blk.shape[dim],
                                             blk.shape[dim])
                    if blk.shape != whole.shape:
                        raise ValueError(
                            f"encoder_embeds give cross K/V "
                            f"{tuple(kv['k'].shape)}; the cache holds "
                            f"{tuple(live['k'].shape)} (encoder_seq_len "
                            "frames)")
                    blk.copy_(whole)
        x = self._embed(params, tokens, positions, inputs_embeds, shard)
        x, _, _ = tfm.stack_forward(
            params["layers"], self.cfg, x, positions, cache["layers"],
            mode="prefill", dispatch=self.moe_dispatch,
            **self._mesh_kw,
            use_flash=self.use_flash, cross_kvs=cache.get("cross"),
            page_table=_page_table(cache),
            paged_attention=self.paged_attention,
            mrope_positions=self._mrope(mrope_positions), shard=shard,
            prepare=self._prepare(shard, cache))
        self.forward_count += 1
        self.prefill_count += 1
        # head only at each sequence's last prompt position — never (B,T,V)
        idx = (lengths.to(torch.int64) - 1)[:, None, None].expand(B, 1, x.shape[-1])
        last_h = torch.gather(x, 1, idx)
        last = self._head(params, last_h, shard)[:, 0]
        last = constrain(last, "logits", mesh=self.mesh,
                         layout=self.mesh_layout, shard=shard)
        last_h = constrain(last_h[:, 0], "hidden", mesh=self.mesh,
                           layout=self.mesh_layout, shard=shard)
        return last, last_h, dict(cache, lengths=lengths)

    # ---------------------------------------------------------------- extend
    def _extend_impl(self, params, tokens, cache, collect=False,
                     prefetch_masks=None):
        tokens = self._tokens(tokens)
        shard, tokens, _ = self._rows(tokens, cache)
        B, T = tokens.shape
        positions = (cache["lengths"].to(torch.int64)[:, None]
                     + torch.arange(T, device=self.device)[None, :])
        x = self._embed(params, tokens, positions, shard=shard)
        x, metrics, collected = tfm.stack_forward(
            params["layers"], self.cfg, x, positions, cache["layers"],
            mode="extend", collect=collect, dispatch=self.moe_dispatch,
            **self._mesh_kw,
            use_flash=self.use_flash, cross_kvs=cache.get("cross"),
            page_table=_page_table(cache),
            paged_attention=self.paged_attention,
            prefetch_masks=prefetch_masks, shard=shard,
            prepare=self._prepare(shard, cache))
        # lint: allow[T106] credited by RoundGraphs on every replay
        self.forward_count += 1
        pend = dict(cache)
        if any(c is not None for c in collected):
            pend["collected"] = collected
        kw = dict(mesh=self.mesh, layout=self.mesh_layout, shard=shard)
        return (constrain(self._head(params, x, shard), "logits", **kw),
                constrain(x, "hidden", **kw), pend, metrics)

    def extend(self, params, tokens, cache: dict, *,
               collect: bool = False) -> Tuple[torch.Tensor, dict]:
        """Decode/verify T tokens per sequence at offsets ``lengths``:
        returns logits (B, T, V) and the pending cache (K/V written,
        ``lengths`` unchanged until ``commit``).  ``collect`` keeps every
        recurrent layer's per-step states for ``commit(collected=True)``
        (module docstring); without it recurrent states advance through all
        T tokens."""
        logits, _, pend, _ = self._extend_impl(params, tokens, cache, collect)
        return logits, pend

    def extend_with_hidden(self, params, tokens, cache: dict, *,
                           collect: bool = False):
        """:meth:`extend` that also returns the final hidden states
        (B, T, d), which EAGLE-style heads (``core/eagle.py``) read."""
        logits, x, pend, _ = self._extend_impl(params, tokens, cache, collect)
        return logits, x, pend

    def extend_with_prefetch(self, params, tokens, cache: dict, plan, *,
                             collect: bool = False):
        """Verify forward that scores an expert-prefetch plan as it runs:
        the compute of :meth:`extend`, and each MoE layer compares the
        experts it routed to with ``plan.masks``
        (``models/moe.PrefetchPlan``).  Returns logits (B, T, V), hidden
        states (B, T, d), the pending cache and ``{"hits", "actual",
        "predicted"}``: int32 device scalars summed over the MoE layers."""
        logits, x, pend, metrics = self._extend_impl(
            params, tokens, cache, collect,
            prefetch_masks=list(plan.masks))
        pf = {k: metrics[f"prefetch_{k}"]
              for k in ("hits", "actual", "predicted")}
        return logits, x, pend, pf

    # ---------------------------------------------------------------- commit
    def commit(self, pend: dict, n_commit: torch.Tensor,
               collected: bool = False) -> dict:
        """Accept ``n_commit`` (B,) tokens of the last extend (the whole
        batch's; a cache placed with its batch over ``"data"`` takes its
        rows): attention
        layers only bump ``lengths`` (stale K/V are masked out); with
        ``collected``, every recurrent layer copies its collected step
        ``(n_commit - 1) mod T`` of each row into its live state, in place
        (the reference's index -1 of a row that commits nothing wraps to
        the last step the same way)."""
        n_commit = n_commit.to(torch.int32)
        rows = self.row_block(pend)
        if rows is not None:      # a cache with its batch over "data"
            n_commit = n_commit[rows]
        steps = pend.get("collected")
        if steps is not None and not collected:
            raise ValueError("commit: the extend collected per-step states; "
                             "commit them with collected=True")
        if steps is not None:
            for slot, st in zip(pend["layers"], steps):
                if st is None:
                    continue
                T = next(iter(st.values())).shape[0]
                idx = torch.remainder(n_commit.to(torch.int64) - 1, T)
                rows = torch.arange(idx.shape[0], device=idx.device)
                for k, leaf in slot.items():
                    leaf.copy_(st[k][idx, rows])
        out = {k: v for k, v in pend.items() if k != "collected"}
        out["lengths"] = pend["lengths"] + n_commit
        return out

    # ------------------------------------------------------------ decode 1tk
    def decode_step(self, params, token: torch.Tensor, cache: dict):
        """Plain AR decode of one token per sequence. token: (B,) → (B,V)."""
        logits, pend = self.extend(params, self._tokens(token)[:, None], cache,
                                   collect=True)
        cache = self.commit(pend, torch.ones(
            token.shape, dtype=torch.int32, device=self.device),
            collected=True)
        return logits[:, 0], cache
