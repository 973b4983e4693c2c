"""The one traffic generator: a mix's parameters (``perfbench/traffic/*.json``)
and a seed give the requests of each unit of the run.

A mix is served in units that cannot be cut: a wave (``"scheduler":
"wave"``) or a burst streamed through the continuous scheduler
(``"continuous"``).  A unit holds ``requests`` requests, made of groups of
``strata`` requests whose lengths are the strata of the length
distributions: length i of a group is the distribution's quantile at
(i + 1/2) / strata, rounded and clipped to [min, max].  Within a group the
prompt and output lengths are each shuffled by the unit's index ``k``
alone, and the seed draws the token ids: every seed does the same work in
the same order (the order decides how a continuous scheduler pads its
admissions), and the units of a run differ in order.  The warm-up unit is
unit -1.

Length distributions: ``{"dist": "fixed", "value": n}`` or
``{"dist": "lognormal", "median": m, "sigma": s, "min": a, "max": b}``.
"""
from __future__ import annotations

from dataclasses import dataclass
from statistics import NormalDist
from typing import List

import numpy as np

FIRST_ID = 3                          # ids 0-2 are the tokenizer's specials


@dataclass
class Request:
    prompt: np.ndarray                # (T,) int32 token ids
    max_new: int


def strata(dist: dict, n: int) -> List[int]:
    """The ``n`` strata of a length distribution, ascending."""
    if dist["dist"] == "fixed":
        return [int(dist["value"])] * n
    if dist["dist"] != "lognormal":
        raise ValueError(f"unknown length distribution {dist['dist']!r}")
    nd = NormalDist()
    out = []
    for i in range(n):
        z = nd.inv_cdf((i + 0.5) / n)
        v = float(dist["median"]) * float(np.exp(float(dist["sigma"]) * z))
        out.append(int(min(max(round(v), dist["min"]), dist["max"])))
    return out


def unit_rng(seed: int, k: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 64), k + 1])


def order_rng(k: int) -> np.random.Generator:
    return np.random.default_rng([k + 1, 1 << 32])


def unit(traffic: dict, seed: int, k: int, vocab: int) -> List[Request]:
    """The requests of unit ``k`` (``k = -1``: the warm-up unit)."""
    n, g = int(traffic["requests"]), int(traffic["strata"])
    if n % g:
        raise ValueError(f"requests {n} is not a multiple of strata {g}")
    p_strata = strata(traffic["prompt"], g)
    o_strata = strata(traffic["output"], g)
    rng, order = unit_rng(seed, k), order_rng(k)
    out = []
    for _ in range(n // g):
        for p, o in zip(order.permutation(p_strata),
                        order.permutation(o_strata)):
            ids = rng.integers(FIRST_ID, vocab, size=int(p), dtype=np.int64)
            out.append(Request(ids.astype(np.int32), int(o)))
    return out
