"""The expert-parallel device mesh over ``torch.distributed``.

Port of ``repro.launch.mesh``'s ``make_ep_mesh`` and its axis helpers.  A
mesh is a ``torch.distributed.device_mesh.DeviceMesh`` of shape
``(data_degree, ep_degree)`` named ``("data", "model")``: one rank per cell,
rank ``r`` at ``(r // ep_degree, r % ep_degree)``, each holding the experts of
its ``"model"`` coordinate.  On the card each rank drives one GPU over NCCL;
with ``device="cpu"`` the ranks are CPU processes over gloo (the tests).

The process group is the caller's when one is running: ``torchrun
--nproc-per-node N`` starts one process a card and sets the environment
``init_process_group`` reads.  With no group and a world of one asked for,
the mesh starts a single-rank group itself through a store it owns, so
``--ep-degree 1`` needs no launcher.

``CensusMesh`` is a mesh of axis sizes alone, with no process group: the
dry-run (``launch/dryrun.py``) runs rank 0's step on it, and every
collective over it is recorded (``launch/costs.py``) instead of issued.

``make_production_mesh`` and ``make_test_mesh`` describe TPU pods (16 x 16
v5e chips, forced host devices) and have no counterpart here (the README's
list of what does not port).
"""
from __future__ import annotations

import math
import os
from typing import Dict, Optional, Union

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

AXES = ("data", "model")


def _start_group(device: torch.device, need: int) -> None:
    """Join the launcher's process group, or start a world of one."""
    backend = "nccl" if device.type == "cuda" else "gloo"
    if "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ:
        dist.init_process_group(backend)                 # torchrun's env://
    elif need == 1:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)


def make_ep_mesh(ep_degree: int, *, data_degree: int = 1,
                 device: Optional[Union[str, torch.device]] = None):
    """``("data", "model")`` mesh for expert-parallel serving: the model
    axis spans ``ep_degree`` ranks (each holding E/ep_degree experts), the
    data axis ``data_degree``.  Every rank of the world is one cell, so
    the world must hold exactly ``data_degree * ep_degree`` ranks.  On the
    card (the default) each rank takes the GPU of its local rank."""
    if ep_degree < 1 or data_degree < 1:
        raise ValueError(f"degrees must be >= 1, got "
                         f"{data_degree}x{ep_degree}")
    dev = resolve_device(device)
    need = data_degree * ep_degree
    if not dist.is_initialized():
        _start_group(dev, need)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != need:
        raise ValueError(
            f"mesh {data_degree}x{ep_degree} needs {need} ranks, the world "
            f"has {world} (start one process a rank: torchrun "
            f"--nproc-per-node {need})")
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        torch.cuda.set_device(local % torch.cuda.device_count())
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(dev.type, (data_degree, ep_degree),
                            mesh_dim_names=AXES)


class CensusGroup:
    """The process group of ``axes`` on a ``CensusMesh``: a collective over
    it records itself and returns a result of the right shape without
    communicating (``distributed/collectives.py``).  ``in_loop``: it was
    taken by a layer of the stack."""

    def __init__(self, axes: tuple, in_loop: bool = False):
        self.axes, self.in_loop = tuple(axes), in_loop


class CensusMesh:
    """A ``("data", "model")`` mesh (or any axes) of sizes alone, seen from
    rank 0, with no process group: the dry-run's.  It answers what the
    layers ask of a ``DeviceMesh`` (axis names and sizes, this rank's
    coordinates, the group of an axis)."""

    def __init__(self, dims: Dict[str, int]):
        self.dims = dict(dims)
        self.mesh_dim_names = tuple(self.dims)

    def get_local_rank(self, axis: str) -> int:
        return 0

    def group(self, axes, in_loop: bool = False) -> CensusGroup:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return CensusGroup(tuple(a for a in self.dims if a in axes),  # mesh order
                           in_loop)

    def get_group(self, axis: str) -> CensusGroup:
        return self.group(axis)


def mesh_dims(mesh) -> Dict[str, int]:
    """Axis name -> size, in the mesh's axis order: a ``DeviceMesh``'s, a
    ``CensusMesh``'s, or a mapping given as it is (the placement rules take
    either, so they can be read without a process group)."""
    if isinstance(mesh, dict):
        return dict(mesh)
    if isinstance(mesh, CensusMesh):
        return dict(mesh.dims)
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def data_axes(mesh) -> tuple:
    """The batch-parallel axes of a mesh: ("pod","data") or ("data",)."""
    return tuple(a for a in mesh_dims(mesh) if a in ("pod", "data"))


def model_axis_size(mesh) -> int:
    return mesh_dims(mesh)["model"]


def data_axis_size(mesh) -> int:
    dims = mesh_dims(mesh)
    return math.prod(dims[a] for a in data_axes(mesh))
