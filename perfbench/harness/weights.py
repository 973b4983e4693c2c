"""Random weights made on the device from the seed, in a few large calls.

Every leaf of every model is a view into one flat buffer per dtype (bf16
for the served weights, float32 for the routers), filled by ``torch.randn``
from one generator on the device in chunks, then scaled in place: a matrix
by 1/sqrt(its fan-in), an embedding table by 0.02, a norm scale to
1 + 0.1 n and a bias to 0.1 n.  Each leaf starts on a 256-byte boundary, so
the kernels see the alignment an allocation would give them.  ``refill``
draws the same buffers again from another seed, in place, so that a
captured graph keeps reading them.

The tree is the parameter layout the program's models read (a dict per
layer: ``norm1``, ``mixer`` with ``wq``, ``wk``, ``wv``, ``wo`` and the
biases, ``norm2``, ``ffn``); the reference reads the same tree.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

ALIGN_BYTES = 256
CHUNK = 1 << 28                      # elements per randn call


def _mlp(d: int, f: int) -> dict:
    return {"w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)}


def _block(spec: dict) -> dict:
    d, H, Hkv, D = spec["d"], spec["heads"], spec["kv_heads"], spec["head_dim"]
    mixer = {"wq": (d, H * D), "wk": (d, Hkv * D), "wv": (d, Hkv * D),
             "wo": (H * D, d)}
    if spec["qkv_bias"]:
        mixer.update(bq=(H * D,), bk=(Hkv * D,), bv=(Hkv * D,))
    if spec["experts"]:
        E, f = spec["experts"], spec["expert_ff"]
        ffn = {"router": (d, E), "w_gate": (E, d, f), "w_up": (E, d, f),
               "w_down": (E, f, d)}
        if spec["shared_ff"]:
            ffn["shared"] = _mlp(d, spec["shared_ff"])
    else:
        ffn = _mlp(d, spec["ff"])
    return {"norm1": {"scale": (d,)}, "mixer": mixer,
            "norm2": {"scale": (d,)}, "ffn": ffn}


def model_shapes(spec: dict) -> dict:
    """Leaf shapes of a decoder's tree."""
    tree = {"embed": {"table": (spec["vocab"], spec["d"])},
            "final_norm": {"scale": (spec["d"],)},
            "layers": [_block(spec) for _ in range(spec["layers"])]}
    if not spec["tie"]:
        tree["head"] = {"table": (spec["vocab"], spec["d"])}
    return tree


def eagle_shapes(target: dict, head: dict) -> dict:
    """Leaf shapes of an EAGLE head at the target's width: the fusion
    matrix and one dense block."""
    spec = dict(target, heads=head["heads"], kv_heads=head["kv_heads"],
                head_dim=head["head_dim"], ff=head["ff"], experts=0,
                qkv_bias=target["qkv_bias"])
    d = target["d"]
    return {"fuse": (2 * d, d), "layers": [_block(spec)]}


def _kind(path: Tuple[str, ...]) -> str:
    name = path[-1]
    if name == "scale":
        return "norm"
    if name in ("bq", "bk", "bv"):
        return "bias"
    if name == "table":
        return "embed"
    return "matrix"


def _walk(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (str(i),))
    else:
        yield path, tree


def _build(tree, path, leaves):
    if isinstance(tree, dict):
        return {k: _build(v, path + (k,), leaves) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_build(v, path + (str(i),), leaves) for i, v in enumerate(tree)]
    return leaves[path]


class Weights:
    """The weights of named trees (``{"target": shapes, ...}``) in one
    bf16 and one float32 buffer on ``device``, drawn from ``seed``."""

    def __init__(self, shapes: Dict[str, dict], seed: int, device,
                 dtype=torch.bfloat16):
        self.device = torch.device(device)
        self.plan: Dict[torch.dtype, List[tuple]] = {dtype: [],
                                                     torch.float32: []}
        size = {dtype: 0, torch.float32: 0}
        for name, tree in shapes.items():
            for path, shape in _walk(tree):
                dt = torch.float32 if path[-1] == "router" else dtype
                align = ALIGN_BYTES // torch.empty((), dtype=dt).element_size()
                off = -(-size[dt] // align) * align
                n = math.prod(shape)
                self.plan[dt].append(((name,) + path, off, shape))
                size[dt] = off + n
        self.buffers = {dt: torch.empty((max(n, 1),), dtype=dt,
                                        device=self.device)
                        for dt, n in size.items()}
        leaves = {}
        for dt, entries in self.plan.items():
            buf = self.buffers[dt]
            for path, off, shape in entries:
                leaves[path] = buf[off: off + math.prod(shape)].view(shape)
        self.trees = {name: _build(tree, (name,), leaves)
                      for name, tree in shapes.items()}
        self._leaves = leaves
        self.refill(seed)

    def refill(self, seed: int) -> None:
        """Draw every leaf from ``seed``, in place."""
        gen = torch.Generator(device=self.device).manual_seed(
            int(seed) % (1 << 63))
        for buf in self.buffers.values():
            for lo in range(0, buf.numel(), CHUNK):
                chunk = buf[lo: lo + CHUNK]
                torch.randn(chunk.shape, generator=gen, out=chunk)
        for dt, entries in self.plan.items():
            for path, _, shape in entries:
                leaf = self._leaves[path]
                kind = _kind(path)
                if kind == "norm":
                    leaf.mul_(0.1).add_(1.0)
                elif kind == "bias":
                    leaf.mul_(0.1)
                elif kind == "embed":
                    leaf.mul_(0.02)
                else:
                    leaf.mul_(1.0 / math.sqrt(shape[-2]))

    def __getitem__(self, name: str) -> dict:
        return self.trees[name]
