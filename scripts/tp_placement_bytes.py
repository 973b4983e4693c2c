"""Per-rank bytes of a model placed on a mesh, reckoned on the meta device.

    PYTHONPATH=src python scripts/tp_placement_bytes.py [--arch qwen2-57b-a14b]
        [--degrees 2 4 8] [--layout tp]

For each model-axis degree m (a (1, m) mesh): the bytes one rank holds of
the weights under ``distributed/sharding.param_spec`` in serving (fsdp
off), split into the experts and the rest, beside the expert-only
placement (only the expert axis split), and the KV cache bytes a rank
holds per cached token under ``cache_spec``.  Shapes only: nothing is
allocated, nothing runs on a device.  Imports the port alone.
"""
import argparse
import math

import torch

from repro_torch.configs.registry import get_config
from repro_torch.distributed import sharding as sh
from repro_torch.models.model import Model
from repro_torch.training.tree import tree_items


def rank_bytes(cfg, m: int, layout: str) -> dict:
    dims = {"data": 1, "model": m}
    params = Model(cfg, device="meta").init(torch.Generator())
    out = {"experts": 0, "rest": 0, "experts_whole": 0, "rest_whole": 0}
    for path, leaf in tree_items(params):
        spec = sh.param_spec(path, tuple(leaf.shape), mesh=dims, fsdp=False,
                             stacked=False, layout=layout)
        n = math.prod(sh.local_shape(tuple(leaf.shape), spec, dims))
        nb = n * leaf.element_size()
        expert = leaf.dim() == 3 and "/ffn/w_" in path
        out["experts" if expert else "rest"] += nb
        # the expert-only placement: the expert axis split, the rest whole
        out["experts_whole" if expert else "rest_whole"] += (
            nb if expert else leaf.numel() * leaf.element_size())
    # KV cache a rank holds per cached token: its blocks' bytes without
    # the trash slot, over the logical capacity S
    S = 64 * m
    cache = Model(cfg, device="meta").init_cache(1, S)
    per_tok = 0.0
    for path, leaf in tree_items(cache):
        if not path.startswith("layers/"):
            continue
        spec, trash = sh.port_cache_spec(path, leaf.shape, mesh=dims)
        local = sh.local_cache_shape(tuple(leaf.shape), spec, trash, dims)
        held = math.prod(local) * leaf.element_size()
        if leaf.shape[1] == S + 1:                 # minus the trash slot
            held = held * (local[1] - 1) // local[1]
        per_tok += held / S
    out["kv_bytes_per_token"] = per_tok
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-57b-a14b")
    ap.add_argument("--degrees", type=int, nargs="+", default=[2, 4, 8])
    ap.add_argument("--layout", default="tp", choices=["tp", "fsdp"])
    args = ap.parse_args()
    cfg = get_config(args.arch)
    print(f"{cfg.name} ({cfg.dtype}), layout {args.layout}, serving "
          "placement (fsdp off); GB = 1e9 bytes, per rank")
    print(f"{'m':>3} {'experts':>9} {'rest':>8} {'total':>8} "
          f"{'EP only':>8} {'KV B/token':>11}")
    for m in args.degrees:
        r = rank_bytes(cfg, m, args.layout)
        print(f"{m:3d} {r['experts'] / 1e9:9.2f} {r['rest'] / 1e9:8.2f} "
              f"{(r['experts'] + r['rest']) / 1e9:8.2f} "
              f"{(r['experts_whole'] + r['rest_whole']) / 1e9:8.2f} "
              f"{r['kv_bytes_per_token']:11.0f}")


if __name__ == "__main__":
    main()
