"""The port's runtime guards (``repro_torch.analysis``) on the CPU.

Mirrors tests/test_runtime_guards.py.  ``sharding_guard`` wraps each
engine's rounds and records, per round key, the (shape, dtype, device,
stride) signature of what the round reads: its four tests run on a
minimal engine here, its two warm-engine tests on a real SDEngine and a
continuous ServingEngine, with ``compile_guard`` (new round keys and
admission shapes, kernel libraries), which counts the cold run's keys and
nothing on the warm run.  ``transfer_guard`` watches torch.cuda's host
synchronisations: without a card it refuses to run (its four tests are
in tests/test_torch_gpu_ep.py)."""
import numpy as np
import pytest
import torch

from repro_torch.analysis import (available, compile_guard, sharding_guard,
                                  transfer_guard)
from repro_torch.configs.base import ModelConfig
from repro_torch.core.proposer import ModelProposer
from repro_torch.core.spec_decode import SDEngine
from repro_torch.models.model import Model
from repro_torch.serving.engine import ServingEngine

TCFG = ModelConfig("tg-moe", "moe", 2, 64, 4, 2, 128, 256, num_experts=4,
                   num_experts_per_tok=2, dtype="float32")
DCFG = ModelConfig("tg-draft", "dense", 2, 32, 2, 2, 64, 256,
                   dtype="float32")


@pytest.fixture(scope="module")
def models():
    t = Model(TCFG, moe_dispatch="gmm", device="cpu")
    d = Model(DCFG, device="cpu")
    return (t, d, t.init(torch.Generator().manual_seed(0)),
            d.init(torch.Generator().manual_seed(1)))


class _FakeEngine:
    """The two methods sharding_guard wraps and reads: one round key a
    batch size, and a round that reads its state."""

    def __init__(self):
        self.rounds = 0

    def round_key(self, state, gamma=None, timed=False):
        return ("round", gamma or 0, state["x"].shape[0])

    def round(self, state, *, gamma=None, generator=None, active=None,
              timed=False):
        self.rounds += 1
        return state, None


# ------------------------------------------------------- sharding_guard
def test_sharding_guard_single_signature_is_ok():
    eng = _FakeEngine()
    x = torch.arange(4, dtype=torch.float32)
    with sharding_guard(eng) as g:
        eng.round({"x": x})
        eng.round({"x": x + 1})                   # same layout
    assert g.programs == 1 and g.ok and eng.rounds == 2
    assert "one input signature" in g.render()


def test_sharding_guard_equivalent_spellings_collapse():
    """Layouts are compared by what they address: a size-1 dimension's
    stride moves no element, so (4, 1) tensors with strides (1, 1) and
    (1, 4) are one layout; "cuda" and "cuda:<current>" are one device."""
    eng = _FakeEngine()
    a = torch.zeros((4, 1))
    b = torch.empty_strided((4, 1), (1, 4))
    assert a.stride() != b.stride()
    with sharding_guard(eng) as g:
        eng.round({"x": a})
        eng.round({"x": b})
    assert g.ok, g.render()
    assert "round" not in vars(eng)               # the method is restored


def test_sharding_guard_detects_second_signature():
    """The same shape under a transposed layout is a violation (a replay
    would read the captured buffer's layout); a spelling-only difference
    is not."""
    eng = _FakeEngine()
    x = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    with sharding_guard(eng) as g:
        eng.round({"x": x})
        eng.round({"x": x.t().contiguous().t()})  # (3, 4), strides (1, 3)
    assert not g.ok, g.render()
    (label, sigs), = g.violations
    assert "round" in label and len(sigs) == 2
    assert "input signatures" in g.render()
    with sharding_guard(eng) as g2:
        eng.round({"x": x})
        eng.round({"x": x.clone()})
    assert g2.ok, g2.render()


def test_sharding_guard_restores_round():
    eng = _FakeEngine()
    eng.round = eng.round                          # an instance attribute
    orig = eng.round
    with sharding_guard(eng) as g:
        assert eng.round is not orig              # wrapped inside
        eng.round({"x": torch.zeros(2)})
    assert eng.round is orig                      # restored on exit
    assert g.programs == 1


# ------------------------------------ warm engines under both guards
def test_warm_sd_session_one_signature_no_new_keys(models):
    """The cold rounds count their new round key; a warm SDEngine session
    replays its rounds with no new key and one input signature a key."""
    t, d, pt, pd = models
    eng = SDEngine(t, ModelProposer(t, d), gamma=2)
    prompts = np.tile(np.arange(3, 9), (2, 1))
    with compile_guard() as cold:
        state = eng.start(pt, pd, prompts, max_seq=48)
        for _ in range(2):                        # warm the round key
            state, _ = eng.round(state)
        live = cold.count
    assert cold.count == live >= 1                # live, then frozen
    with compile_guard() as cg, sharding_guard(eng) as sg:
        for _ in range(3):
            state, _ = eng.round(state)
    assert cg.count == 0
    assert sg.programs > 0 and sg.ok, sg.render()


def test_warm_continuous_stream_one_signature_no_new_keys(models):
    """A second identical-shape stream through a warm continuous
    ServingEngine runs no new round key or admission shape and keeps one
    input signature a round key (the sharded EP lane is in
    test_torch_expert_parallel.py)."""
    t, d, pt, pd = models
    eng = ServingEngine(t, d, pt, pd, max_batch=2, gamma=2, force_sd=True,
                        scheduler="continuous")
    with compile_guard() as cold:
        for m in (3, 7, 5):
            eng.submit(np.arange(3, 9), max_new_tokens=m)
        eng.run()                                 # warm stream
    assert cold.count >= 2                        # a round key, an admission
    with compile_guard() as cg, sharding_guard(eng) as sg:
        for m in (4, 6, 5):
            eng.submit(np.arange(3, 9), max_new_tokens=m)
        eng.run()
    assert cg.count == 0
    assert sg.programs > 0 and sg.ok, sg.render()


# ------------------------------------------------------- transfer_guard
def test_transfer_guard_refuses_without_a_card():
    """No card, nothing to watch: the guard raises instead of counting 0,
    and the serving CLI's --transfer-guard stops with its message."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: tests/test_torch_gpu_ep.py runs "
                    "the guard")
    assert not available()
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        with transfer_guard():
            pass
    with pytest.raises(ValueError, match="level"):
        with transfer_guard("bogus"):
            pass
    from repro_torch.launch.serve import main
    with pytest.raises(SystemExit, match="needs a CUDA device"):
        main(["--arch", "qwen2-57b-a14b", "--reduced", "--transfer-guard",
              "--device", "cpu"])
