"""Placement rules: parameter, cache and batch specs over a mesh.

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

What this slice places for real is the expert axis (``shard_params``):
each rank keeps the contiguous block of ``E / ep`` experts of its
``"model"`` coordinate, and ``collectives.moe_ep_forward`` routes tokens to
them.  Every other leaf stays whole on every rank, which computes what the
reference computes, since GSPMD's result does not depend on placement.
Placing the tensor-parallel and FSDP shards of the non-expert leaves
(attention heads, the dense FFN and the vocab split over ``"model"``, with
their all-reduces) is ROADMAP queue 1 item 11b.
"""
from __future__ import annotations

import math
import re
from typing import Any

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

_EXPERT_LEAF = re.compile(r"ffn/(w_gate|w_up|w_down)$")


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


def _map_with_path(tree: Any, fn, path: str = "") -> Any:
    if isinstance(tree, dict):
        return {k: _map_with_path(v, fn, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_with_path(v, fn, f"{path}/{i}" if path else str(i))
                for i, v in enumerate(tree)]
    return fn(path, tree)


def shard_params(params, mesh, *, layout: str = "tp"):
    """This rank's params: each expert leaf (``ffn/w_gate|w_up|w_down``,
    (E, d, f)) whose spec puts ``"model"`` on its expert axis keeps the
    contiguous block of ``E / ep`` experts of the rank's ``"model"``
    coordinate, copied so the whole leaf can be freed; at ep 1 the block
    is the leaf itself.  Every other leaf is this rank's as it is (module
    docstring)."""
    ep = mesh_dims(mesh)["model"]
    j = mesh.get_local_rank("model")

    def place(path: str, leaf):
        if not (isinstance(leaf, torch.Tensor) and _EXPERT_LEAF.search(path)
                and leaf.dim() == 3):
            return leaf
        spec = param_spec(path, tuple(leaf.shape), mesh=mesh, fsdp=False,
                          stacked=False, layout=layout)
        if spec[0] != "model" or ep == 1:
            return leaf
        e_local = leaf.shape[0] // ep
        return leaf[j * e_local:(j + 1) * e_local].clone()

    return _map_with_path(params, place)


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

