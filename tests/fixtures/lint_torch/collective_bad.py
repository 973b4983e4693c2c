"""Fixture: collective and host-boundary hazards (S4xx)."""
import re

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.graphs import RoundGraphs


def cache_spec(path_str, shape):
    if re.search(r"(k|v)_pages$", path_str):
        return (None, "model")
    return (None,) * len(shape)


def reduce(x):
    dist.all_reduce(x)
    return x


def make_cache(n):
    return {"k_pages": torch.zeros(n), "q_pages": torch.zeros(n)}


def place(shape):
    return cache_spec("layers/0/q_pages", shape)


def set_globals():
    torch.set_default_dtype(torch.float64)


def rounds(x):
    graphs = RoundGraphs(x.device, capture=True)

    def stage(prev):
        mask = torch.as_tensor(np.ones(4, bool), device=x.device)
        return x * mask
    graphs.run(("k",), [stage])
