"""A run of each cell, with the look for a card skipped (test sizes on the
CPU, the port in float32), comes out correct when the program is sound,
and not correct when the timed path is broken underneath it: a round that
leaves its state unchanged, half the batch left out (its rows serve the
other half's tokens), a token altered where it is produced, and, where the
cell drafts, a draft altered where the drafter proposes it (greedy
speculative decoding still serves the target's tokens: only the drafter
check sees it)."""
from __future__ import annotations

import json

import numpy as np
import pytest

import perfbench_cpu_cells as pc
from perfbench.harness import cells, runner

CELLS = [w["name"] for w in cells.load_manifest()["workloads"]]
SEED = 2**31 + 101


SPECULATING = [c for c in CELLS if cells.resolve(c).traffic["speculate"]]


def limits(cell: str) -> dict:
    return json.loads((cells.BENCH_DIR / "limits" / f"{cell}.json")
                      .read_text())


def limit(cell: str) -> float:
    return limits(cell)["gap_p90"]


def run(cell: str, trace: bool = False):
    # every request judged
    return runner.run(pc.tiny(cell), SEED, 0.3, trace, device="cpu",
                      limits=limits(cell), sample=64)


def _round_fault(monkeypatch, fault):
    from repro_torch.core import spec_decode
    orig = spec_decode.SDEngine.round

    def broken(self, state, **kw):
        state, res = orig(self, state, **kw)
        fault(res)
        return state, res
    monkeypatch.setattr(spec_decode.SDEngine, "round", broken)


def state_unchanged(monkeypatch):
    from repro_torch.models import model
    monkeypatch.setattr(model.Model, "commit",
                        lambda self, pend, n_commit, collected=False: pend)


def half_left_out(monkeypatch):
    def fault(res):
        B = res.committed.shape[0]
        res.committed[B // 2:] = res.committed[: B - B // 2]
    _round_fault(monkeypatch, fault)


def token_altered(monkeypatch):
    from repro_torch.core import spec_decode
    orig = spec_decode.rejection_sample

    def altered(*a, **kw):
        n_accept, next_token, extra = orig(*a, **kw)
        return n_accept, (next_token + 1) % a[0].shape[-1], extra
    monkeypatch.setattr(spec_decode, "rejection_sample", altered)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    res = run(cell, trace=True)
    v = res["verdict"]
    assert v["correct"], v
    assert v["checks"]["gap_p90"]["value"] == 0.0   # float32 both sides
    if cell in SPECULATING:
        assert v["checks"]["draft_gap_p90"]["value"] == 0.0
        assert v["drafts_judged"] > 0
    else:
        assert "draft_gap_p90" not in v["checks"]
    assert v["attempted"] > 0 and v["failed"] == 0
    names = {m["name"] for m in pc.tiny(cell).per_layer}
    # every per-layer metric but the device trace's is read on the CPU
    assert set(res["metrics"]) >= names - {"expert_kernels_roofline",
                                          "paged_attention_ms", "idle_share",
                                          "peak_mem_gib"}
    assert res["metrics"]["window_captures"]["value"] == 0
    assert res["metrics"]["tokens_per_row_round"]["value"] >= 1.0


@pytest.mark.parametrize("fault", [state_unchanged, half_left_out,
                                   token_altered])
@pytest.mark.parametrize("cell", CELLS)
def test_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    res = run(cell)
    v = res["verdict"]
    assert not v["correct"], v
    assert v["checks"]["gap_p90"]["value"] > limit(cell)


def draft_altered(monkeypatch):
    from repro_torch.core import eagle, proposer
    for cls in (proposer.ModelProposer, eagle.EagleProposer):
        orig = cls.propose

        def altered(self, *a, _orig=orig, **kw):
            drafts, q_dist, work = _orig(self, *a, **kw)
            return (drafts + 1) % q_dist.shape[-1], q_dist, work
        monkeypatch.setattr(cls, "propose", altered)


@pytest.mark.parametrize("cell", SPECULATING)
def test_broken_drafter_is_not_correct(cell, monkeypatch):
    draft_altered(monkeypatch)
    res = run(cell)
    v = res["verdict"]
    assert not v["correct"], v
    assert v["checks"]["draft_gap_p90"]["value"] > \
        limits(cell)["draft_gap_p90"]


def test_end_to_end_line_on_the_cpu():
    res = run("qwen2moe-ar-wave-b32")
    m = res["metrics"]
    assert set(m) == {"tokens_per_s", "setup_s"}
    assert m["tokens_per_s"]["value"] > 0 and m["setup_s"]["value"] > 0
    assert res["device"]["platform"] == "cpu"
    assert np.isfinite(res["verdict"]["checks"]["gap_p90"]["value"])
