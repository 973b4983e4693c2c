"""The traffic generator: deterministic per seed, the same work on every
seed and unit, lengths as the mix states them."""
from __future__ import annotations

import json
from collections import Counter

import numpy as np
import pytest

import perfbench_cpu_cells  # noqa: F401
from perfbench.harness import cells, traffic

MIXES = sorted(p.stem for p in (cells.BENCH_DIR / "traffic").glob("*.json"))
SEEDS = [0, 7, 2**31 + 11, 2**40 + 3]


def _mix(name):
    return json.loads((cells.BENCH_DIR / "traffic" / f"{name}.json")
                      .read_text())


def _sizes(reqs):
    return Counter((len(r.prompt), r.max_new) for r in reqs)


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_requests(name):
    mix = _mix(name)
    a = traffic.unit(mix, 2**31 + 5, 3, 151936)
    b = traffic.unit(mix, 2**31 + 5, 3, 151936)
    assert len(a) == len(b) == mix["requests"]
    for x, y in zip(a, b):
        assert np.array_equal(x.prompt, y.prompt) and x.max_new == y.max_new


@pytest.mark.parametrize("name", MIXES)
def test_every_seed_and_unit_does_the_same_work(name):
    mix = _mix(name)
    p = Counter(traffic.strata(mix["prompt"], mix["strata"]))
    o = Counter(traffic.strata(mix["output"], mix["strata"]))
    n = mix["requests"] // mix["strata"]
    seen = set()
    for seed in SEEDS:
        for k in (-1, 0, 1):
            reqs = traffic.unit(mix, seed, k, 32000)
            # each group of `strata` requests holds every stratum once
            for g in range(n):
                grp = reqs[g * mix["strata"]:(g + 1) * mix["strata"]]
                assert Counter(len(r.prompt) for r in grp) == p
                assert Counter(r.max_new for r in grp) == o
            seen.add(tuple(int(r.prompt[0]) for r in reqs))
            for r in reqs:
                assert r.prompt.dtype == np.int32
                assert r.prompt.min() >= traffic.FIRST_ID
                assert r.prompt.max() < 32000
    assert len(seen) == len(SEEDS) * 3      # other seeds, other tokens


@pytest.mark.parametrize("name", MIXES)
def test_unit_order_is_the_units_and_not_the_seeds(name):
    mix = _mix(name)
    sizes = lambda seed, k: [(len(r.prompt), r.max_new)  # noqa: E731
                             for r in traffic.unit(mix, seed, k, 32000)]
    assert sizes(1, 0) == sizes(2**31 + 9, 0)
    if mix["strata"] > 1 and mix["prompt"]["dist"] != "fixed":
        assert sizes(1, 0) != sizes(1, 1)


@pytest.mark.parametrize("name", MIXES)
def test_lengths_within_the_stated_bounds(name):
    mix = _mix(name)
    for key in ("prompt", "output"):
        dist = mix[key]
        got = traffic.strata(dist, mix["strata"])
        assert got == sorted(got)
        if dist["dist"] == "lognormal":
            assert dist["min"] <= got[0] and got[-1] <= dist["max"]
            assert got[len(got) // 2] == pytest.approx(dist["median"],
                                                       rel=0.1)


def test_burst_never_grows_the_page_pool():
    """The continuous scheduler sizes the pool from the first pool-full of
    requests (1 + their pages, to a power of two) and grows it when the
    live requests need more: with every group holding each stratum once,
    the first group's pages are the same in every burst, and no 16 of a
    burst's requests need more than that pool."""
    for name in MIXES:
        mix = _mix(name)
        if mix["scheduler"] != "continuous":
            continue
        ps, pool = mix["page_size"], mix["max_batch"]
        pages = lambda p, o: -(-(p + o + mix["gamma"] + 2) // ps)  # noqa
        P = traffic.strata(mix["prompt"], mix["strata"])
        O = traffic.strata(mix["output"], mix["strata"])
        first = 1 + sum(pages(p, o) for p, o in zip(P, O))
        pool_pages = 1
        while pool_pages < first:
            pool_pages *= 2
        copies = mix["requests"] // mix["strata"]
        worst = sorted([pages(p, max(O)) for p in P] * copies)[-pool:]
        assert sum(worst) <= pool_pages - 1


@pytest.mark.parametrize("name", MIXES)
def test_warm_group_opens_the_windows_round_key(name):
    """Set-up serves one group of the warm-up unit, its outputs cut to
    ``warm_tokens``: a wave's group is its whole unit (its cache length
    follows the outputs, so no cut), and a stream's cut group sizes the
    same capacity and page pool as every burst of the window."""
    from perfbench.harness import runner
    mix = _mix(name)
    warm = runner.warm_group(mix, 2**31 + 9, 151936, mix.get("warm_tokens"))
    assert len(warm) == mix["strata"]
    if mix["scheduler"] == "wave":
        assert "warm_tokens" not in mix and len(warm) == mix["requests"]
        return
    assert all(r.max_new <= mix["warm_tokens"] for r in warm)
    ps, g = mix["page_size"], mix["gamma"]

    def pow2(n):
        x = 1
        while x < n:
            x *= 2
        return x

    def geometry(reqs):
        need = [len(r.prompt) + r.max_new + g + 2 for r in reqs]
        return (pow2(max(need)),
                pow2(1 + sum(-(-n // ps) for n in need[: mix["max_batch"]])))
    for k in range(4):
        unit = traffic.unit(mix, 2**31 + 9, k, 151936)
        assert geometry(unit) == geometry(warm)
