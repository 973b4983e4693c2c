"""The explicitly threaded mesh: validation, and the batch axes of a layout.

Port of ``repro.distributed.constraints``.  The mesh is threaded explicitly,
``Model(cfg, mesh=...)`` and ``ServingEngine(..., mesh=...)``, never kept in
process-global state: ``set_mesh`` is removed and raises, as in the
reference.
"""
from __future__ import annotations

from typing import Optional, Tuple

from repro_torch.launch.mesh import mesh_dims

VALID_LAYOUTS = ("tp", "fsdp")


def _validate(mesh, layout: str) -> None:
    if layout not in VALID_LAYOUTS:
        raise ValueError(f"layout must be one of {VALID_LAYOUTS}, "
                         f"got {layout!r}")
    if mesh is not None:
        from torch.distributed.device_mesh import DeviceMesh

        from repro_torch.launch.mesh import CensusMesh
        if not isinstance(mesh, (DeviceMesh, CensusMesh)):
            raise TypeError(f"mesh must be a torch.distributed DeviceMesh "
                            f"(or the dry-run's CensusMesh), got "
                            f"{type(mesh)!r}")


def set_mesh(mesh, layout: str = "tp"):
    """REMOVED: there is no process-global mesh.  Thread the mesh
    explicitly, ``Model(cfg, mesh=...)`` / ``ServingEngine(..., mesh=...)``;
    calling this always raises ``RuntimeError``."""
    raise RuntimeError(
        "set_mesh was removed: pass mesh=/mesh_layout= explicitly "
        "(Model(cfg, mesh=...), ServingEngine(..., mesh=...))")


def resolve_mesh(mesh=None, layout: Optional[str] = None
                 ) -> Tuple[Optional[object], str]:
    """Validate and normalize an explicitly threaded (mesh, layout) pair;
    ``mesh=None`` means one device."""
    if mesh is not None:
        _validate(mesh, layout or "tp")
        return mesh, (layout or "tp")
    if layout is not None:
        _validate(None, layout)
    return None, (layout or "tp")


def data_axes_of(mesh, layout: str):
    """Batch-parallel axes under a layout: every axis for fsdp, the
    ("pod", "data") subset for tp.  None when the mesh has no such axes."""
    names = tuple(mesh_dims(mesh))
    if layout == "fsdp":
        return names or None
    return tuple(a for a in names if a in ("pod", "data")) or None


def constrain(x, kind: str, *, mesh=None, layout: Optional[str] = None,
              shard=None):
    """The reference pins an activation's sharding here (a GSPMD
    annotation for its partitioner).  Torch has no partitioner: this is
    where an activation of a batch split over ``"data"`` (``shard``'s
    ``batch_axes``, ``distributed/collectives.Shard``) is all-gathered into
    the whole batch, which every rank then holds: ``"hidden"`` (the
    pre-head states) and ``"logits"`` (the head's, already gathered over
    the vocab), so rejection accepts the same prefix on every rank.
    Without a split batch it validates the pair and returns ``x``."""
    resolve_mesh(mesh, layout)
    if shard is None or "data" not in shard.batch_axes:
        return x
    from repro_torch.distributed import collectives as col
    return col.gather(x, 0, shard, "data")
