"""Placement rules and placement: parameter, cache, batch and optimizer
blocks over a mesh.

Port of ``repro.distributed.sharding``.  The rules are pure functions of a
leaf's path and shape and of the mesh's axis sizes (a ``DeviceMesh``, or a
mapping from axis name to size).  A spec is a tuple with one entry per
dimension: ``None`` (whole), an axis name, or a tuple of two or more axis
names; it equals ``tuple(PartitionSpec)`` of the reference's rule
(``PartitionSpec`` spells one axis in a tuple as the bare name).

Logical placement, as in the reference: attention heads, the FFN hidden
dim and the vocab dim of embed/head over ``"model"`` (tensor parallel,
"tp"); MoE experts expert-parallel, the expert axis over ``"model"`` (the
paper's EP deployment, §3.4); batch dims of activations and caches over
``("pod", "data")``; with FSDP, parameters also shard their largest
remaining dim over the data axes ("fsdp" makes every axis a batch/FSDP
axis).  A dim the axis size does not divide stays whole (``_fit``).

Placement is real: where the reference hands GSPMD a ``NamedSharding``,
the port gives each rank its block of the leaf.  A dim sharded over axes
``(a1, a2)`` orders its blocks with ``a1`` major, as ``NamedSharding``
does: the block index is ``idx(a1) * size(a2) + idx(a2)``.
``shard_params`` copies each rank's block out of a whole tree (so the
whole can be freed); ``Model.init_cache`` and ``init_adam`` allocate
blocks directly (``local_cache_leaf``, and zeros like the placed
params); ``shard_cache`` and ``shard_opt_state`` place a whole cache or
optimizer state; ``shard_batch`` takes a rank's rows of a batch.

The port's caches differ from the reference's in two ways the cache rules
absorb (``port_cache_spec``): a layer's leaves have no leading period
axis, and a dense attention or MLA cache has one trash slot past its
logical capacity S (models/attention.py).  A cache sharded over its
sequence keeps ``S / m`` positions and a trash slot of its own.

The layers read a placement, never a shape: ``Model.place`` records the
params' specs (``param_placement``) when it places them, and a placed
cache carries its ``CachePlacement`` under ``"placement"``.  Both hold
specs resolved to the mesh (``resolve_spec``: an axis of size 1 splits
nothing and is dropped, so at a world of one every leaf is whole).
"""
from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.launch.mesh import mesh_dims

Spec = tuple


def _axis_size(dims: dict, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        return dims[axes]
    return math.prod(dims[a] for a in axes)


def _canonical(axes):
    """One dimension's entry as ``PartitionSpec`` spells it: no axes is
    None, one axis its bare name."""
    if isinstance(axes, tuple) and len(axes) <= 1:
        return axes[0] if axes else None
    return axes


def _fit(mesh, spec: Spec, shape) -> Spec:
    """Drop sharded axes whose dim is not divisible by the axis size."""
    dims = mesh_dims(mesh)
    out = []
    for dim, axes in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if axes is not None and dim > 0 and dim % _axis_size(dims, axes) == 0:
            out.append(_canonical(axes))
        else:
            out.append(None)
    return tuple(out)


# ---------------------------------------------------------------------------
# parameter rules
# ---------------------------------------------------------------------------

# (path regex, spec WITHOUT the leading scan axis). First match wins.
# "D" placeholder = FSDP axes in train mode, None in serve mode.
_PARAM_RULES = [
    # MoE experts: expert-parallel over "model"; FSDP over the big d_ff dim
    (r"ffn/(w_gate|w_up|w_down)$", ("model", None, "D")),
    (r"ffn/router$", (None, None)),
    (r"shared/(w_gate|w_up)$", ("D", "model")),
    (r"shared/w_down$", ("model", "D")),
    # dense FFN: megatron column/row split
    (r"(^|/)(w_gate|w_up|w_ffn_up)$", ("D", "model")),
    (r"(^|/)(w_down|w_ffn_down)$", ("model", "D")),
    # attention projections
    (r"(wq|wk|wv|w_uq|w_uk|w_uv)$", ("D", "model")),
    (r"(wo)$", ("model", "D")),
    (r"(bq|bk|bv)$", ("model",)),
    (r"(w_dkv|w_dq)$", ("D", None)),
    # ssm / xlstm
    (r"mixer/w_in$", ("D", "model")),
    (r"mixer/(w_out|w_down)$", ("model", "D")),
    (r"mixer/w_up$", ("D", "model")),
    (r"mixer/(conv_w|conv_b)$", (None,)),
    (r"mixer/(w_xdbc|w_dt|A_log|dt_bias|D)$", ("model",)),
    (r"mixer/(w_i|w_f|i_bias|f_bias)$", (None,)),
    (r"(r_z|r_i|r_f|r_o|w_z)$", ("D", "model")),
    # embeddings / head: vocab over model
    (r"(embed|head)/table$", ("model", "D")),
    # norms & everything small: replicated
    (r".*", (None,)),
]

def param_spec(path_str: str, shape, *, mesh, fsdp: bool, stacked: bool,
               fsdp_min_size: int = 0, layout: str = "tp") -> Spec:
    """layout "tp": Megatron TP over "model" + FSDP over ("pod","data");
    "fsdp": no tensor parallelism, every axis (incl. "model") a batch/FSDP
    axis, dense weights shard their FSDP dim over ALL axes, MoE experts
    keep the expert axis on "model".  ``stacked``: the leaf has a leading
    scan axis (the reference's period stacking; the port's layers are
    not stacked)."""
    names = tuple(mesh_dims(mesh))
    d_axes = tuple(a for a in names if a in ("pod", "data"))
    n_elem = math.prod(shape) if shape else 0

    def matches(pat, spec):
        # dense FFN and MoE expert weights share ffn/w_* paths; the rank
        # separates them: 2-D dense, 3-D (E, d, f) experts
        if not re.search(pat, path_str):
            return False
        return len(spec) + (1 if stacked else 0) <= len(shape) \
            or len(spec) <= 1

    if layout == "fsdp":
        ok = fsdp and n_elem >= fsdp_min_size
        for pat, spec in _PARAM_RULES:
            if not matches(pat, spec):
                continue
            is_expert = len(spec) == 3 and spec[0] == "model"
            resolved, assigned = [], False
            for s in spec:
                if is_expert:
                    resolved.append("model" if s == "model" else
                                    (d_axes if ok else None) if s == "D"
                                    else None)
                elif s in ("model", "D") and not assigned:
                    resolved.append(names if ok else None)
                    assigned = True
                else:
                    resolved.append(None)
            if stacked:
                resolved = [None] + resolved
            return _fit(mesh, tuple(resolved), shape)
        return ()
    fs = d_axes if (fsdp and d_axes and n_elem >= fsdp_min_size) else None
    for pat, spec in _PARAM_RULES:
        if matches(pat, spec):
            resolved = tuple(fs if s == "D" else s for s in spec)
            if stacked:
                resolved = (None,) + resolved
            return _fit(mesh, resolved, shape)
    return ()


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def mesh_coords(mesh) -> Dict[str, int]:
    """This rank's index on every axis of a ``DeviceMesh``."""
    return {a: mesh.get_local_rank(a) for a in mesh.mesh_dim_names}


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def block_index(entry, dims: dict, coords: dict) -> Tuple[int, int]:
    """(index, count) of this rank's block along a dim sharded over
    ``entry``: the first axis major, as ``NamedSharding`` orders them."""
    idx, n = 0, 1
    for a in _axes(entry):
        idx, n = idx * dims[a] + coords[a], n * dims[a]
    return idx, n


def local_shape(shape, spec: Spec, dims: dict) -> tuple:
    """The block shape of a leaf of ``shape`` under ``spec``."""
    return tuple(n // _axis_size(dims, e) if e is not None else n
                 for n, e in zip(shape, tuple(spec) + (None,) * len(shape)))


def resolve_spec(spec: Spec, dims: dict) -> Spec:
    """``spec`` with the axes of size 1 dropped: each entry the axes of more
    than one rank it splits over (None, a bare name or a tuple)."""
    return tuple(_canonical(tuple(a for a in _axes(e) if dims[a] > 1))
                 for e in spec)


def resolve_tree(specs, dims: dict):
    """``resolve_spec`` at every leaf of a spec tree."""
    if isinstance(specs, dict):
        return {k: resolve_tree(v, dims) for k, v in specs.items()}
    if isinstance(specs, list):
        return [resolve_tree(v, dims) for v in specs]
    return resolve_spec(specs, dims)


def take_block(t: torch.Tensor, spec: Spec, dims: dict, coords: dict, *,
               trash_dim: Optional[int] = None) -> torch.Tensor:
    """This rank's block of a whole leaf, copied out (the leaf itself when
    the spec shards nothing).  ``trash_dim``: that dim holds a trash slot
    past the positions the spec splits, which the block keeps a copy of."""
    out = t
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        i, n = block_index(entry, dims, coords)
        if n == 1:
            continue
        size = t.shape[dim] - (1 if dim == trash_dim else 0)
        per = size // n
        blk = out.narrow(dim, i * per, per)
        if dim == trash_dim:
            blk = torch.cat([blk, out.narrow(dim, size, 1)], dim)
        out = blk
    return out if out is t else out.clone()


def _map_with_path(tree: Any, fn, path: str = "") -> Any:
    if isinstance(tree, dict):
        return {k: _map_with_path(v, fn, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_with_path(v, fn, f"{path}/{i}" if path else str(i))
                for i, v in enumerate(tree)]
    return fn(path, tree)


def param_placement(params, mesh, *, fsdp: bool = False,
                    fsdp_min_size: int = 0, layout: str = "tp"):
    """The spec of every leaf of a whole params tree (the reference's
    ``shard_params`` pytree of ``NamedSharding``)."""
    return _map_with_path(params, lambda path, leaf: param_spec(
        path, tuple(leaf.shape), mesh=mesh, fsdp=fsdp, stacked=False,
        fsdp_min_size=fsdp_min_size, layout=layout))


def _place(tree, specs, mesh):
    dims, coords = mesh_dims(mesh), mesh_coords(mesh)

    def go(t, sp):
        if isinstance(t, dict):
            return {k: go(v, sp[k]) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [go(v, s) for v, s in zip(t, sp)]
        return take_block(t, sp, dims, coords)

    return go(tree, specs)


def shard_params(params, mesh, *, fsdp: bool = False,
                 fsdp_min_size: int = 0, layout: str = "tp"):
    """This rank's params: every leaf's block under ``param_spec`` (expert
    blocks over ``"model"``, attention heads, FFN columns/rows and the
    vocab under "tp", FSDP dims over the data axes, or every axis under
    "fsdp"), copied out so the whole leaf can be freed.  A leaf the spec
    does not shard is returned as it is (at a world of one, every leaf)."""
    specs = param_placement(params, mesh, fsdp=fsdp,
                            fsdp_min_size=fsdp_min_size, layout=layout)
    return _place(params, specs, mesh)


def shard_opt_state(opt_state, param_placement_tree, mesh):
    """The moments' blocks: each inherits its parameter's spec; ``step``
    stays whole.  ``param_placement_tree`` is ``param_placement``'s."""
    from repro_torch.training.optimizer import AdamState
    return AdamState(step=opt_state.step,
                     mu=_place(opt_state.mu, param_placement_tree, mesh),
                     nu=_place(opt_state.nu, param_placement_tree, mesh))


# ---------------------------------------------------------------------------
# cache rules
# ---------------------------------------------------------------------------

def cache_spec(path_str: str, shape, *, mesh, kv_mode: str = "auto") -> Spec:
    """KV/state caches: leading (P periods, B, ...).

    Batch shards over ("pod","data") when divisible.  ``kv_mode``: auto,
    the head axis over "model" when divisible, else the sequence axis;
    seq, always the sequence axis; heads, the head axis (whole when not
    divisible)."""
    dims = mesh_dims(mesh)
    d_axes = tuple(a for a in dims if a in ("pod", "data")) or None
    msize = dims["model"]
    if re.search(r"lengths$", path_str):
        return _fit(mesh, (d_axes,), shape)
    if re.search(r"pages/table$", path_str):
        # (B, max_pages) block table: rows follow batch
        return _fit(mesh, (d_axes, None), shape)
    if re.search(r"(k|v)_pages$", path_str) and len(shape) == 5:
        # (P, pool, page, Hkv, hd): the pool is shared through the table,
        # so only the head axis shards
        return _fit(mesh, (None, None, None, "model", None), shape)
    if re.search(r"(latent|k_rope)_pages$", path_str):
        return (None,) * len(shape)
    if re.search(r"(^|/)(k|v)$", path_str) and len(shape) == 5:
        # (P, B, S, Hkv, hd)
        head_ok = shape[3] % msize == 0
        if kv_mode == "seq" or (kv_mode == "auto" and not head_ok):
            return _fit(mesh, (None, d_axes, "model", None, None), shape)
        return _fit(mesh, (None, d_axes, None, "model", None), shape)
    if re.search(r"pos$", path_str) and len(shape) == 3:
        return _fit(mesh, (None, d_axes, None), shape)
    if re.search(r"(latent|k_rope)$", path_str) and len(shape) == 4:
        return _fit(mesh, (None, d_axes, "model", None), shape)
    if re.search(r"(^|/)(conv|ssm|C|n|m|c|h)$", path_str):
        # recurrent states (P, B, ...): batch, and the first state dim the
        # model axis divides
        spec = [None, d_axes] + [None] * (len(shape) - 2)
        for i in range(2, len(shape)):
            if shape[i] % msize == 0:
                spec[i] = "model"
                break
        return _fit(mesh, tuple(spec), shape)
    return _fit(mesh, (None, d_axes), shape)


# the dense leaves that hold a trash slot past their logical capacity
_TRASH_LEAVES = ("k", "v", "latent", "k_rope")


def port_cache_spec(path: str, shape, *, mesh, ring: bool = False,
                    kv_mode: str = "auto", split_batch: bool = True
                    ) -> Tuple[Spec, Optional[int]]:
    """(spec, trash dim) of a leaf of the port's cache under ``cache_spec``
    (module docstring): a layer leaf (``layers/<l>/...``, ``cross/<l>/...``)
    is read as the reference's with a period axis of 1 in front, and a
    dense attention or MLA leaf (not a ``ring``) without its trash slot;
    the trash dim is the sequence dim then, else None.  ``kv_mode="heads"``
    keeps MLA's latent whole too, as its page pools are; ``split_batch``
    False keeps the batch whole over the data axes (a compact admission
    cache, whose rows go to every rank's rows)."""
    shape = tuple(shape)
    if kv_mode == "heads" and path.endswith(("/latent", "/k_rope")):
        return (None,) * len(shape), None     # as an MLA page pool: whole
    layer = path.startswith(("layers/", "cross/"))
    trash = (layer and not ring and path.startswith("layers/")
             and path.rsplit("/", 1)[-1] in _TRASH_LEAVES)
    ref = ((1,) + shape) if layer else shape
    if trash:
        ref = ref[:2] + (ref[2] - 1,) + ref[3:]
    spec = cache_spec(path, ref, mesh=mesh, kv_mode=kv_mode)
    spec = tuple(spec) + (None,) * (len(ref) - len(spec))
    if not split_batch:            # only the batch dim names a data axis
        spec = tuple(None if e is not None and e != "model" else e
                     for e in spec)
    if layer:
        spec = spec[1:]
    return spec, (1 if trash and spec[1] is not None else None)


@dataclass(frozen=True)
class CachePlacement:
    """Where a placed cache's leaves split, as ``"placement"`` of the cache
    carries it: each layer's leaf specs (``port_cache_spec``'s, resolved to
    the mesh; a cross-attention slot's under ``"cross/k"``, ``"cross/v"``)
    and ``rows``, the (first row, rows) of the whole batch this rank holds
    (None: all of them)."""
    layers: tuple                      # per layer: ((leaf, spec), ...)
    rows: Optional[Tuple[int, int]] = None

    def layer(self, l: int) -> dict:
        return dict(self.layers[l])


def place_cache(whole: dict, mesh, make, kv_mode: str = "auto",
                split_batch: bool = True) -> dict:
    """A placed cache built leaf by leaf: ``make(path, leaf, spec, trash
    dim)`` returns this rank's block of the whole cache's ``leaf`` (a real
    tensor to slice, or a meta tensor that only gives shapes; the spec is
    ``port_cache_spec``'s), and the result carries its
    ``CachePlacement``."""
    dims, coords = mesh_dims(mesh), mesh_coords(mesh)
    specs: Dict[str, Spec] = {}

    def go(tree, path, ring=False):
        if isinstance(tree, dict):
            ring = ring or "pos" in tree          # a sliding-window ring
            return {k: go(v, f"{path}/{k}" if path else k, ring)
                    for k, v in tree.items() if k != "placement"}
        if isinstance(tree, (list, tuple)):
            return [go(v, f"{path}/{i}", ring) for i, v in enumerate(tree)]
        spec, trash = port_cache_spec(path, tree.shape, mesh=mesh, ring=ring,
                                      kv_mode=kv_mode,
                                      split_batch=split_batch)
        specs[path] = resolve_spec(spec, dims)
        return make(path, tree, spec, trash)

    out = go(whole, "")
    layers = []
    for l, slot in enumerate(whole["layers"]):
        leaves = [(k, specs[f"layers/{l}/{k}"]) for k in slot]
        if whole.get("cross"):
            leaves += [(f"cross/{k}", specs[f"cross/{l}/{k}"])
                       for k in whole["cross"][l]]
        layers.append(tuple(leaves))
    rows = None
    i, n = block_index(specs["lengths"][0], dims, coords)
    if n > 1:
        per = whole["lengths"].shape[0] // n
        rows = (i * per, per)
    out["placement"] = CachePlacement(tuple(layers), rows)
    return out


def shard_cache(cache: dict, mesh, kv_mode: str = "auto") -> dict:
    """This rank's blocks of a whole cache (batch over the data axes, KV
    heads or the sequence over ``"model"``, per ``cache_spec``), with the
    ``CachePlacement`` the forward reads."""
    dims, coords = mesh_dims(mesh), mesh_coords(mesh)
    return place_cache(cache, mesh, lambda path, leaf, spec, trash:
                       take_block(leaf, spec, dims, coords, trash_dim=trash),
                       kv_mode)


def local_cache_shape(shape, spec: Spec, trash: Optional[int],
                      dims: dict) -> tuple:
    """The block shape of a cache leaf (the trash slot kept whole)."""
    if trash is None:
        return local_shape(shape, spec, dims)
    ref = list(shape)
    ref[trash] -= 1
    out = list(local_shape(ref, spec, dims))
    out[trash] += 1
    return tuple(out)


# ---------------------------------------------------------------------------
# batches
# ---------------------------------------------------------------------------

def batch_spec(mesh, shape, layout: str = "tp") -> Spec:
    """tokens/labels/mask (B, T) and embeds (B, T, d): batch over the data
    axes (every axis in the "fsdp" layout)."""
    names = tuple(mesh_dims(mesh))
    if layout == "fsdp":
        d_axes = names or None
    else:
        d_axes = tuple(a for a in names if a in ("pod", "data")) or None
    return _fit(mesh, (d_axes,) + (None,) * (len(shape) - 1), shape)



def shard_batch(batch: dict, mesh, layout: str = "tp"
                ) -> Tuple[dict, tuple]:
    """This rank's rows of a batch of arrays or tensors (B, ...) under
    ``batch_spec``, and the axes of more than one rank the rows split over
    (() when the batch stays whole).  Every leaf must share the batch
    size."""
    dims, coords = mesh_dims(mesh), mesh_coords(mesh)
    sizes = {int(v.shape[0]) for v in batch.values() if v is not None}
    if len(sizes) != 1:
        raise ValueError(f"batch leaves disagree on the batch size: {sizes}")
    B = sizes.pop()
    entry = batch_spec(mesh, (B,), layout)[0]
    if entry is None:
        return dict(batch), ()
    i, n = block_index(entry, dims, coords)
    if n == 1:
        return dict(batch), ()
    per = B // n
    return ({k: None if v is None else v[i * per:(i + 1) * per]
             for k, v in batch.items()},
            tuple(a for a in _axes(entry) if dims[a] > 1))
