"""Checkpointing: a tree of tensors <-> a directory of .npy leaves plus a
``manifest.json``.

Port of ``repro.training.checkpoint``: every leaf is one ``.npy`` file keyed
by its tree path (``training/tree.py``), and the manifest records the step,
the keys and the caller's metadata.  numpy has no bfloat16 without
``ml_dtypes``, so a bf16 leaf is stored as its uint16 bits and the manifest
records each leaf's dtype.  Restore rebuilds into the template's structure,
dtypes and devices, and refuses a template whose leaves differ.
"""
from __future__ import annotations

import json
import os
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.training.tree import tree_items, tree_map_with_path


def _file(path: str, key: str) -> str:
    return os.path.join(path, key.replace("/", "__") + ".npy")


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_numpy(a: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def save_checkpoint(ckpt_dir: str, step: int, tree: Any,
                    metadata: Optional[dict] = None) -> str:
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    os.makedirs(path, exist_ok=True)
    flat = dict(tree_items(tree))
    for key, leaf in flat.items():
        np.save(_file(path, key), _to_numpy(leaf))
    manifest = {"step": step, "keys": sorted(flat),
                "dtypes": {k: str(v.dtype).removeprefix("torch.")
                           for k, v in flat.items()},
                "metadata": metadata or {}}
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    return path


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [d for d in os.listdir(ckpt_dir) if d.startswith("step_")]
    return os.path.join(ckpt_dir, max(steps)) if steps else None


def restore_checkpoint(path: str, template: Any) -> tuple[Any, dict]:
    """(a tree like ``template`` holding the checkpoint's leaves in the
    template's dtypes and devices, the manifest)."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    keys = [k for k, _ in tree_items(template)]
    if sorted(keys) != manifest["keys"]:
        missing = set(manifest["keys"]) ^ set(keys)
        raise ValueError(f"checkpoint/template structure mismatch: "
                         f"{sorted(missing)[:5]}")

    def load(key, like):
        t = _from_numpy(np.load(_file(path, key)), manifest["dtypes"][key])
        return t.to(device=like.device, dtype=like.dtype)

    return tree_map_with_path(load, template), manifest
