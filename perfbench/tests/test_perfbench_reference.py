"""The frozen reference (``perfbench/reference``) against the port's float32
CPU forward at test sizes: both targets, the qwen2-0.5b-shaped draft and
the EAGLE head, on the weights the harness makes."""
from __future__ import annotations

import numpy as np
import pytest
import torch

import perfbench_cpu_cells as pc
from perfbench.harness import cells, runner
from perfbench.harness.weights import Weights, eagle_shapes, model_shapes
from perfbench.reference import model as ref

TOL = 2e-4


def _program(spec, name):
    from repro_torch.models.model import Model
    return Model(runner._port_config(spec, name, "float32"),
                 moe_dispatch="gmm" if spec["experts"] else "onehot",
                 device="cpu")


def _seqs(vocab, lengths, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.integers(3, vocab, n)) for n in lengths]


def _compare(spec, params, name):
    model = _program(spec, name)
    seqs = _seqs(spec["vocab"], [5, 17, 9], 3)
    with torch.no_grad():
        want = ref.logits_at(spec, params, seqs, [1] * len(seqs))
        for s, w in zip(seqs, want):
            x, _ = model.forward_hidden(params, s[None])
            got = model._head(params, x)[0, :-1]
            scale = w.abs().max()
            assert float((got - w).abs().max()) <= TOL * float(scale)
            assert torch.equal(got.argmax(-1), w.argmax(-1))


@pytest.mark.parametrize("cell", ["qwen2moe-sd-wave-b32",
                                  "mixtral-eagle-burst-long"])
def test_target_matches_the_programs_forward(cell):
    c = pc.tiny(cell)
    spec = cells.target_spec(c.config)
    w = Weights({"target": model_shapes(spec)}, 11, "cpu",
                dtype=torch.float32)
    _compare(spec, w["target"], c.config_name)


def test_dense_draft_matches_the_programs_forward():
    c = pc.tiny("qwen2moe-sd-wave-b32")
    spec = cells.draft_spec(c.config)
    assert spec["tie"] and spec["qkv_bias"] and not spec["experts"]
    w = Weights({"draft": model_shapes(spec)}, 12, "cpu", dtype=torch.float32)
    _compare(spec, w["draft"], "draft")


def test_prefill_then_decode_matches_the_full_forward():
    """The program's cached path (prefill, then extend one token at a time)
    against the reference's one full forward."""
    c = pc.tiny("qwen2moe-sd-wave-b32")
    spec = cells.target_spec(c.config)
    params = Weights({"target": model_shapes(spec)}, 13, "cpu",
                     dtype=torch.float32)["target"]
    model = _program(spec, c.config_name)
    (seq,) = _seqs(spec["vocab"], [12], 4)
    with torch.no_grad():
        want = ref.logits_at(spec, params, [seq], [6])[0]     # rows 5..10
        cache = model.init_cache(1, 16)
        last, cache = model.prefill(params, seq[None, :6], cache)
        rows = [last[0]]
        for t in range(6, 11):
            logits, pend = model.extend(params, seq[None, t:t + 1], cache)
            cache = model.commit(pend, torch.ones(1, dtype=torch.int32))
            rows.append(logits[0, 0])
        got = torch.stack(rows)
    assert float((got - want).abs().max()) <= TOL * float(want.abs().max())


def test_eagle_rounds_follow_the_programs_head():
    """Two rounds of the program's head steps, the first keeping two of
    its three, against the reference following the same rounds."""
    from repro_torch.core.eagle import EagleHead
    c = pc.tiny("mixtral-eagle-burst-long")
    spec, hspec = cells.target_spec(c.config), cells.draft_spec(c.config)
    w = Weights({"target": model_shapes(spec),
                 "head": eagle_shapes(spec, hspec)}, 14, "cpu",
                dtype=torch.float32)
    target = _program(spec, c.config_name)
    head = EagleHead(target)
    P, n, g = 5, 8, 3
    rng = torch.Generator().manual_seed(5)
    seq = torch.randint(3, spec["vocab"], (P + n,), generator=rng)
    feats = torch.randn((P + n, spec["d"]), generator=rng)
    rounds = [(1, np.array([int(seq[P + 1]), 7, 9])),
              (3, np.array([4, 11, 5]))]
    with torch.no_grad():
        want = ref.eagle_rounds(
            spec, {"heads": hspec["heads"], "kv_heads": hspec["kv_heads"],
                   "head_dim": hspec["head_dim"], "ff": hspec["ff"]},
            w["target"], w["head"], seq, feats, P, rounds)
        cache = head.init_cache(1, 32)
        got = []
        for c_, d in rounds:
            p = P + c_ - 1                   # the commit rolls lengths here
            cache = dict(cache, lengths=torch.tensor([p], dtype=torch.int32))
            feat, tok = feats[p - 1: p], seq[p: p + 1]
            for j in range(g):
                lg, feat, cache = head.step(w["target"], w["head"], feat,
                                            tok, cache)
                got.append(lg[0])
                tok = torch.tensor([int(d[j])])
    got = torch.stack(got)
    assert want.shape == got.shape == (2 * g, spec["vocab"])
    assert float((got - want).abs().max()) <= TOL * float(want.abs().max())
    assert torch.equal(got.argmax(-1), want.argmax(-1))


def test_harness_tree_is_the_programs_layout():
    """The harness's weights have the tree the program's own init makes."""
    from repro_torch.core.eagle import EagleHead
    c = pc.tiny("mixtral-eagle-burst-long")
    spec, hspec = cells.target_spec(c.config), cells.draft_spec(c.config)
    target = _program(spec, c.config_name)
    gen = torch.Generator().manual_seed(0)
    theirs = {"target": target.init(gen), "head": EagleHead(target).init(gen)}
    ours = Weights({"target": model_shapes(spec),
                    "head": eagle_shapes(spec, hspec)}, 0, "cpu",
                   dtype=torch.float32)

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [shapes(v) for v in tree]
        return tuple(tree.shape)
    for name in theirs:
        assert shapes(ours[name]) == shapes(theirs[name])


def test_control_rounds_weights_and_activations_to_e4m3():
    lin = ref.Linear("fp8")
    w = torch.randn(64, 32)
    q = lin.weight(w)
    assert not torch.equal(q, w)
    # e4m3 keeps 3 mantissa bits: relative error per entry under 2^-4
    big = w.abs() > w.abs().amax(0, keepdim=True) / 8
    assert float(((q - w).abs() / w.abs())[big].max()) <= 2 ** -4
    assert torch.equal(ref.Linear("fp32").weight(w), w)
    with pytest.raises(ValueError):
        ref.Linear("fp16")
