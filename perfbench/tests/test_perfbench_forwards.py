"""The harness's account of a unit's target forwards (rows, and the
experts a forward with few rows activates), held against the program's
own forward counters at test size on the CPU."""
from __future__ import annotations

import numpy as np
import pytest

import perfbench_cpu_cells as pc
from perfbench.harness import cells, check, costs, runner, traffic

CELLS = [w["name"] for w in cells.load_manifest()["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_forwards_match_the_programs_counters(cell):
    c = pc.tiny(cell)
    spec = cells.target_spec(c.config)
    system = runner.build(c, 7, "cpu")
    runner.serve(system, traffic.unit(c.traffic, 7, -1, spec["vocab"]))
    target = system.engine.target
    target.forward_count = target.prefill_count = 0
    unit = runner.serve(system, traffic.unit(c.traffic, 7, 0, spec["vocab"]))
    fw = runner.forwards(spec, unit)
    assert len(fw) == target.forward_count
    waves = [r for r in unit.reports if r.scheduler == "wave"]
    admissions = sum(1 for r in unit.reports if r.steps
                     for s in r.steps if s.admit_tokens)
    streams = len(unit.reports) - len(waves)
    assert target.prefill_count == len(waves) + admissions + streams
    # forwards that may leave experts idle name their tokens, and the
    # reference's routing of those tokens gives each layer's active experts
    from repro_torch.data.tokenizer import PAD
    seqs = [np.concatenate([r.prompt, r.output]) for r in unit.requests] \
        + [np.array([PAD])]
    routes = [dict(enumerate(layer)) for layer in
              check.routes(spec, system.weights["target"], seqs)]
    active = runner.active_experts(spec, fw, routes)
    assert active is not None and len(active) == len(fw)
    for (rows, counts), f in zip(active, fw):
        assert rows == f.rows
        if counts is None:
            assert costs.expected_idle(rows, spec) < costs.ALL_ACTIVE_IDLE
        else:
            assert len(counts) == spec["layers"]
            assert all(spec["top_k"] <= n <= spec["experts"] for n in counts)
    assert costs.forward_experts_least_s(active, spec) > 0


def test_unknown_tokens_give_no_count():
    spec = {"experts": 64, "top_k": 8, "layers": 2}
    fw = [runner.Forward(4, None, False)]
    assert runner.active_experts(spec, fw, routes=[[], []]) is None
    fw = [runner.Forward(4096, None, True)]
    assert runner.active_experts(spec, fw, routes=None) == [(4096, None)]
