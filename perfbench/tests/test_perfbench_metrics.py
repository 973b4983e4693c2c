"""The metric arithmetic on hand-made inputs: rates over elapsed time, the
p90 and its sample count, the union of device intervals and the idle gaps,
the token-weighted batch, and mfu and the expert kernels' roofline against
shapes worked by hand."""
from __future__ import annotations

import math
from types import SimpleNamespace

import numpy as np
import pytest

import perfbench_cpu_cells  # noqa: F401
from perfbench.harness import cells, costs, runner
from perfbench.harness.trace import (Trace, idle_gaps, seconds_by_name,
                                     union_seconds)


def _req(prompt, out, submitted, finished, reason="length"):
    return SimpleNamespace(prompt=np.zeros(prompt), output=np.zeros(out),
                           submitted_at=submitted, finished_at=finished,
                           finish_reason=reason, max_new_tokens=out)


def test_rate_is_all_clean_tokens_over_the_elapsed_window():
    reqs = [_req(10, 100, 0.0, 1.0), _req(10, 50, 0.0, 2.0),
            _req(10, 30, 0.0, 2.5, reason="aborted")]
    e2e = runner.end_to_end(reqs, 4.0, 12.5)
    assert e2e["tokens_per_s"] == pytest.approx(150 / 4.0)
    assert e2e["setup_s"] == 12.5
    assert e2e["request_p90_s"] is None          # under 100 requests


@pytest.mark.parametrize("n", [99, 128, 192])
def test_p90_over_all_requests(n):
    rng = np.random.default_rng(n)
    lat = rng.exponential(3.0, n)
    reqs = [_req(1, 1, 1.0, 1.0 + x) for x in lat]
    got = runner.end_to_end(reqs, 10.0, 1.0)["request_p90_s"]
    if n < 100:
        assert got is None
        return
    assert got == pytest.approx(float(np.percentile(lat, 90)))
    # from 100 requests on, at least ten lie beyond the 90th percentile
    assert (lat > got).sum() >= 10


def test_percentile_of_one_value_and_order_free():
    assert costs.percentile([4.0], 95) == 4.0
    assert costs.percentile([3.0, 1.0, 2.0], 50) == 2.0
    with pytest.raises(ValueError):
        costs.percentile([], 95)


def test_union_and_gaps_of_device_intervals():
    ops = [(0.0, 1.0, "a"), (0.5, 2.0, "b"), (3.0, 4.0, "a"), (3.5, 3.6, "c")]
    assert union_seconds(ops) == pytest.approx(3.0)
    gaps = idle_gaps(ops, -1.0, 6.0)
    assert gaps == [(4.0, 6.0), (-1.0, 0.0), (2.0, 3.0)]
    assert seconds_by_name(ops) == pytest.approx({"a": 2.0, "b": 1.5,
                                                  "c": 0.1})
    tr = Trace(device=ops, host=[(1.9, 3.1, "cudaStreamSynchronize"),
                                 (4.2, 4.3, "aten::copy_")], lo=-1.0, hi=6.0)
    assert tr.busy_s == pytest.approx(3.0)
    assert tr.window_s == pytest.approx(7.0)
    bd = tr.breakdown()
    assert bd["device_ops"][0] == ["a", 2.0]
    assert bd["idle_gaps"][0] == ["aten::copy_", 2.0]
    assert bd["idle_gaps"][2] == ["cudaStreamSynchronize", 1.0]
    assert bd["idle_gaps"][1] == ["host: python", 1.0]


def test_busy_counts_only_the_traced_stretch():
    tr = Trace(device=[(0.0, 2.0, "k"), (5.0, 7.0, "k")], lo=1.0, hi=6.0)
    assert tr.busy_s == pytest.approx(2.0)


def test_token_weighted_rows_match_the_programs_occupancy_timeline():
    from repro_torch.core.analytics import occupancy_timeline
    live, committed = [16, 12, 3, 16], [16, 30, 3, 1]
    want = occupancy_timeline(live, committed)["token_weighted_live"]
    assert costs.token_weighted(live, committed) == pytest.approx(want)
    assert costs.token_weighted([], []) == 0.0


SPEC = {"d": 8, "layers": 2, "heads": 2, "kv_heads": 1, "head_dim": 4,
        "vocab": 100, "experts": 4, "top_k": 2, "expert_ff": 16,
        "shared_ff": 32, "ff": 0}


def test_active_parameters_by_hand():
    # attention 8 * 4 * (2*2 + 2*1) = 192; router 8 * 4 = 32; two experts
    # 2 * 3 * 8 * 16 = 768; shared 3 * 8 * 32 = 768; head 8 * 100 = 800
    assert cells.active_params(SPEC) == 2 * (192 + 32 + 768 + 768) + 800
    dense = dict(SPEC, experts=0, ff=10)
    assert cells.active_params(dense) == 2 * (192 + 240) + 800


def test_mfu_by_hand():
    active = 1000
    # one request of 3 prompt and 2 output positions: 5 positions at
    # 2 * 1000, and 1+2+3+4+5 = 15 visible pairs a layer at 4 * 4 * 2
    flops = 5 * 2000 + 2 * 15 * 32
    got = costs.mfu_percent([(3, 2)], SPEC, active, 2.0)
    assert got == pytest.approx(100 * flops / (costs.BF16_FLOPS * 2.0))


def test_expert_kernels_least_time_by_hand():
    # 4 rows x top-2 = 8 slots, 4 experts of 8 x 16, bf16
    fused_b = 2 * (8 * 8 + 2 * 4 * 8 * 16 + 8 * 16) + 16
    down_b = 2 * (8 * 16 + 4 * 16 * 8 + 8 * 8) + 16
    want = fused_b / costs.HBM_BYTES_S + down_b / costs.HBM_BYTES_S
    got = costs.expert_kernels_least_s(4, SPEC, 4)
    assert got == pytest.approx(want)
    # a prefill of 16384 rows at qwen2's widths is bound by FLOPs
    wide = dict(SPEC, d=3584, expert_ff=2560, experts=64, top_k=8)
    n = 16384 * 8
    got = costs.expert_kernels_least_s(16384, wide, 64)
    assert got == pytest.approx(6.0 * n * 3584 * 2560 / costs.BF16_FLOPS)
    many = costs.forward_experts_least_s([(4, None)] * 3, SPEC)
    assert many == pytest.approx(3 * 2 * costs.expert_kernels_least_s(4, SPEC,
                                                                       4))
    # two of four experts active in one layer: half their weights' bytes
    some = costs.forward_experts_least_s([(4, [2, 4])], SPEC)
    assert some == pytest.approx(costs.expert_kernels_least_s(4, SPEC, 2)
                                 + costs.expert_kernels_least_s(4, SPEC, 4))
    assert costs.expected_idle(32, dict(SPEC, experts=64, top_k=8)) == \
        pytest.approx(64 * (7 / 8) ** 32)


def test_expert_kernels_at_the_cells_widths():
    """qwen2's AR step at B 32 reads nearly every expert's weights: the
    bytes bound it, and 0.9 of 64 experts are expected idle there."""
    spec = cells.target_spec(cells.resolve("qwen2moe-ar-wave-b32").config)
    t = costs.expert_kernels_least_s(32, spec, spec["experts"])
    weights = 3 * 64 * 3584 * 2560 * 2
    assert weights / costs.HBM_BYTES_S < t < 1.02 * weights / costs.HBM_BYTES_S
    idle = 64 * (1 - 8 / 64) ** 32
    assert 0.85 < idle < 0.95
    assert math.isclose(idle / 64, 0.0139, abs_tol=0.001)
