"""Decoder-only language model: embedding → decoder stack → head.

Port of ``repro.models.model.Model`` for decoder-only attention configs:

    model  = Model(cfg, moe_dispatch="gmm")            # device="cuda" default
    params = model.init(torch.Generator(model.device).manual_seed(0))
    cache  = model.init_cache(batch, max_seq)
    logits, cache = model.prefill(params, tokens, cache, lengths=...)
    logits, pend  = model.extend(params, tokens, cache)
    cache  = model.commit(pend, n_commit)

Cache layout::

    {"layers": [{"k", "v"} per layer], "lengths": (B,) int32}
    paged:  {"layers": [{"k_pages", "v_pages"} per layer], "lengths": (B,),
             "pages": {"table": (B, max_pages) int32}}

``extend`` consumes T tokens per sequence at offsets ``lengths`` — T=1 is
plain decode, T=gamma+1 a speculative-decoding verify pass — and writes
their K/V into the cache in place; ``commit`` bumps ``lengths`` (stale
entries of a rejected suffix are masked by position, see attention.py).

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

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.models.attention import GATHER_ON_CUDA
from repro_torch.models.layers import (apply_norm, embed, init_embedding,
                                       init_norm, unembed)


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[cfg.dtype]


def merge_cache_rows(old: dict, new: dict, mask) -> dict:
    """Row-wise select between two same-shape DENSE decode caches: rows
    where ``mask`` (B,) is True take ``new`` (a fresh prefill), the others
    keep ``old``.  The full-pool admission primitive (``SDEngine.admit``).
    ``mask`` is a host array; the rows are copied into ``old``'s tensors in
    place (a session's graphs read them there), and the cache dict is
    returned."""
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


_PAGED_LEAF_PAIRS = (("k_pages", "k"), ("v_pages", "v"))


def scatter_cache_rows(old: dict, new: dict, rows, *, valid=None,
                       n_prompt: Optional[int] = None) -> dict:
    """Row-scatter a COMPACT (R-row) fresh cache into a live B-row cache.

    The row-sliced admission primitive (``SDEngine.admit_rows``): ``new``
    is a dense prefill of only the admitted rows, ``rows`` (R,) the pool
    row each goes to, ``valid`` (R,) marks real lanes (bucketing pads
    replicate admissions; they are dropped).  ``rows`` and ``valid`` are
    host arrays from the scheduler, so the dropped lanes are filtered on
    the host: a boolean index on a device tensor would sync.

    Dense leaves take whole rows; paged leaves take the first ``n_prompt``
    positions (rounded up to whole pages) through ``old``'s block table,
    which must already map the admitted rows.  ``new`` must be dense with
    the live cache's logical capacity.  Updates ``old``'s tensors in place
    (a functional update would copy the whole pool per admission) and
    returns the cache dict."""
    rows = np.asarray(rows, np.int64)
    keep = (np.arange(rows.shape[0]) if valid is None
            else np.nonzero(np.asarray(valid, bool))[0])
    dev = old["lengths"].device
    dst = torch.as_tensor(rows[keep], device=dev)
    src = torch.as_tensor(keep, device=dev)
    table = None if old.get("pages") is None else old["pages"]["table"]
    paged_to_dense = dict(_PAGED_LEAF_PAIRS)
    for lo, ln in zip(old["layers"], new["layers"]):
        for k, leaf in lo.items():
            if k not in paged_to_dense:
                leaf[dst] = ln[k][src]
                continue
            n = ln[paged_to_dense[k]]
            ps, S_f = leaf.shape[1], n.shape[1] - 1     # minus the trash slot
            span = S_f if n_prompt is None else min(-(-n_prompt // ps) * ps,
                                                    S_f)
            pos = torch.arange(span, device=dev)
            lp = (pos // ps).clamp(max=table.shape[1] - 1)
            pid = table[dst][:, lp].to(torch.int64)              # (R', span)
            leaf[pid, (pos % ps)[None, :]] = n[src, :span]
    old["lengths"][dst] = new["lengths"][src]
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
    axis (new entries point at trash page 0).  Lengths are untouched."""
    if cache.get("pages") is None:
        raise ValueError("grow_cache_pages: not a paged cache")

    def grow_slot(slot):
        out = dict(slot)
        for paged_key, _ in _PAGED_LEAF_PAIRS:
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


def grow_cache_seq(cache: dict, cfg: ModelConfig, new_max_seq: int) -> dict:
    """Raise a DENSE cache's logical capacity to ``new_max_seq``: the
    draft-side companion of :func:`grow_cache_pages`.  New positions go
    before the trailing trash slot, which stays last.  (``cfg`` keeps the
    reference's signature; every ported layer is full attention.)"""
    def grow(leaf):
        S = leaf.shape[1] - 1
        if new_max_seq <= S:
            return leaf
        grown = leaf.new_zeros((leaf.shape[0], new_max_seq + 1)
                               + tuple(leaf.shape[2:]))
        grown[:, :S] = leaf[:, :S]
        return grown

    return dict(cache, layers=[{k: grow(v) for k, v in slot.items()}
                               for slot in cache["layers"]])


def _leaves(cache: dict) -> List[torch.Tensor]:
    """Every tensor of a decode cache, in a fixed order."""
    out = [leaf for slot in cache["layers"] for leaf in slot.values()]
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
    """Decoder-only language model on one device."""

    def __init__(self, cfg: ModelConfig, *, moe_dispatch: str = "onehot",
                 use_flash: bool = False, paged_attention: str = "kernel",
                 device=None):
        if paged_attention not in ("kernel", "gather"):
            raise ValueError(
                f"paged_attention must be 'kernel' or 'gather', got "
                f"{paged_attention!r}")
        if cfg.is_encoder_decoder or cfg.is_recurrent:
            raise NotImplementedError(
                f"{cfg.name}: encoder-decoder and recurrent stacks are ROADMAP "
                "queue 1 item 9; this slice ports decoder-only attention")
        self.cfg = cfg
        self.moe_dispatch = moe_dispatch
        self.use_flash = use_flash
        self.paged_attention = paged_attention
        self.device = resolve_device(device)
        if paged_attention == "gather" and self.device.type == "cuda":
            raise ValueError(GATHER_ON_CUDA)
        self.dtype = torch_dtype(cfg)
        # target/draft forward passes run (prefill + extend) and the prefills
        # among them, for callers that check how many times each kernel of a
        # forward must launch
        self.forward_count = 0
        self.prefill_count = 0

    # ------------------------------------------------------------------ init
    def init(self, generator: torch.Generator) -> dict:
        """Random parameters on ``self.device`` drawn from ``generator``
        (which must live on the same device)."""
        cfg, dt = self.cfg, self.dtype
        kw = dict(generator=generator, device=self.device)
        params: Dict[str, Any] = {
            "embed": init_embedding(cfg.vocab_size, cfg.d_model, dt, **kw),
            "final_norm": init_norm(cfg, dt, self.device),
            "layers": tfm.init_stack(cfg, dt, **kw),
        }
        if not cfg.tie_embeddings:
            params["head"] = init_embedding(cfg.vocab_size, cfg.d_model, dt, **kw)
        return params

    # ----------------------------------------------------------------- embed
    def _embed(self, params, tokens):
        return embed(params["embed"], tokens,
                     scale=self.cfg.name.startswith("gemma"))

    def _head(self, params, x):
        cfg = self.cfg
        x = apply_norm(params["final_norm"], x, cfg.norm_eps)
        table = params["embed"] if cfg.tie_embeddings else params["head"]
        return unembed(table, x, cfg.final_logit_softcap)

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, dtype=torch.int64, device=self.device)

    # ----------------------------------------------------------------- cache
    def init_cache(self, batch: int, max_seq: int, *, paged: bool = False,
                   page_size: int = 64, pool_pages: Optional[int] = None,
                   reuse: Optional[dict] = None, device=None) -> dict:
        """Allocate a decode cache.

        Dense (default): every attention layer holds (B, max_seq) K/V (plus
        the trash slot of attention.make_attn_cache).  ``paged=True``: every
        layer holds a pool of ``pool_pages`` pages of ``page_size``
        positions (default: every row at ``max_seq`` plus the trash page),
        addressed through ``cache["pages"]["table"]``
        (B, ceil(max_seq / page_size)); ``max_seq`` is then the logical
        capacity, growable with :func:`grow_cache_pages`.

        ``reuse``: a cache of exactly this shape, reset in place instead of
        allocating (every leaf zeroed, ``lengths`` and the table included)
        and returned, so tensors a captured round reads keep their
        addresses.  ``device`` overrides the model's (``"meta"`` gives the
        shapes alone)."""
        dev = self.device if device is None else torch.device(device)
        if reuse is not None:
            want = self.init_cache(batch, max_seq, paged=paged,
                                   page_size=page_size,
                                   pool_pages=pool_pages, device="meta")
            if _leaf_shapes(want) != _leaf_shapes(reuse):
                raise ValueError("init_cache(reuse=...): the cache to reuse "
                                 "does not have the requested shape")
            for leaf in _leaves(reuse):
                leaf.zero_()
            return reuse
        cache: Dict[str, Any] = {
            "layers": tfm.make_stack_cache(self.cfg, batch, max_seq,
                                           self.dtype, dev,
                                           paged=paged, page_size=page_size,
                                           pool_pages=pool_pages),
            "lengths": torch.zeros((batch,), dtype=torch.int32, device=dev),
        }
        if paged:
            cache["pages"] = {"table": torch.zeros(
                (batch, -(-max_seq // page_size)), dtype=torch.int32,
                device=dev)}
        return cache

    # --------------------------------------------------------------- prefill
    def prefill(self, params, tokens, cache: dict, *,
                lengths=None) -> Tuple[torch.Tensor, dict]:
        """Prefill padded prompts (B, T); returns the logits at each
        sequence's last prompt position (B, V) and the filled cache."""
        tokens = self._tokens(tokens)
        B, T = tokens.shape
        if lengths is None:
            lengths = torch.full((B,), T, dtype=torch.int32, device=self.device)
        lengths = torch.as_tensor(lengths, dtype=torch.int32, device=self.device)
        positions = torch.arange(T, device=self.device)[None, :].expand(B, T)
        x = self._embed(params, tokens)
        x = tfm.stack_forward(params["layers"], self.cfg, x, positions,
                              cache["layers"], mode="prefill",
                              dispatch=self.moe_dispatch,
                              use_flash=self.use_flash,
                              page_table=_page_table(cache),
                              paged_attention=self.paged_attention)
        self.forward_count += 1
        self.prefill_count += 1
        # head only at each sequence's last prompt position — never (B,T,V)
        idx = (lengths.to(torch.int64) - 1)[:, None, None].expand(B, 1, x.shape[-1])
        last_h = torch.gather(x, 1, idx)
        last = self._head(params, last_h)[:, 0]
        return last, dict(cache, lengths=lengths)

    # ---------------------------------------------------------------- extend
    def _extend_impl(self, params, tokens, cache):
        tokens = self._tokens(tokens)
        B, T = tokens.shape
        positions = (cache["lengths"].to(torch.int64)[:, None]
                     + torch.arange(T, device=self.device)[None, :])
        x = self._embed(params, tokens)
        x = tfm.stack_forward(params["layers"], self.cfg, x, positions,
                              cache["layers"], mode="extend",
                              dispatch=self.moe_dispatch,
                              use_flash=self.use_flash,
                              page_table=_page_table(cache),
                              paged_attention=self.paged_attention)
        self.forward_count += 1
        return self._head(params, x), x, dict(cache)

    def extend(self, params, tokens, cache: dict, *,
               collect: bool = False) -> Tuple[torch.Tensor, dict]:
        """Decode/verify T tokens per sequence at offsets ``lengths``:
        returns logits (B, T, V) and the pending cache (K/V written,
        ``lengths`` unchanged until ``commit``).  ``collect`` gathers
        recurrent states in the reference; attention stacks have none."""
        logits, _, pend = self._extend_impl(params, tokens, cache)
        return logits, pend

    # ---------------------------------------------------------------- commit
    def commit(self, pend: dict, n_commit: torch.Tensor,
               collected: bool = False) -> dict:
        """Accept ``n_commit`` (B,) tokens of the last extend: attention
        layers only bump ``lengths`` (stale K/V are masked out)."""
        return dict(pend, lengths=pend["lengths"] + n_commit.to(torch.int32))

    # ------------------------------------------------------------ decode 1tk
    def decode_step(self, params, token: torch.Tensor, cache: dict):
        """Plain AR decode of one token per sequence. token: (B,) → (B,V)."""
        logits, pend = self.extend(params, self._tokens(token)[:, None], cache)
        cache = self.commit(pend, torch.ones_like(cache["lengths"]))
        return logits[:, 0], cache
