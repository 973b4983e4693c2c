"""Port's SD engine and wave serving vs the reference.

Greedy SD is lossless (equal to greedy AR), the greedy wave outputs of the
port's ServingEngine are token-identical to the reference's on the same
weights and prompts (also with ``use_flash`` on both models, and for a dense
continuous stream), rejection sampling is lossless in distribution at
temperature > 0, and every proposer kind builds its session once."""
import numpy as np
import pytest
import torch

from _torch_parity import model_pair
from repro.configs.registry import get_config
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro_torch.core.proposer import make_proposer
from repro_torch.core.rejection import probs_from_logits, rejection_sample
from repro_torch.core.spec_decode import SDEngine, generate_ar
from repro_torch.data.pipeline import prompt_batch
from repro_torch.serving.engine import ServingEngine

TARGET = get_config("qwen2-57b-a14b", reduced=True)
DRAFT = get_config("qwen2-0.5b", reduced=True)


def _pair():
    _, jpt, tm, tpt = model_pair(TARGET, seed=0, moe_dispatch="gmm")
    _, jpd, dm, tpd = model_pair(DRAFT, seed=7)
    return (jpt, jpd), (tm, tpt, dm, tpd)


def _prompts(n=5):
    pb = prompt_batch(TARGET.vocab_size, n, seed=3, min_len=5, max_len=14)
    return [pb["tokens"][i][: int(pb["lengths"][i])] for i in range(n)]


@pytest.mark.parametrize("target", ["moe", "dense"])
def test_greedy_sd_equals_greedy_ar(target):
    _, (tm, tpt, dm, tpd) = _pair()
    if target == "dense":
        tm, tpt = dm, tpd                     # self-draft on the dense model
    rng = np.random.default_rng(1)
    prompts = rng.integers(3, TARGET.vocab_size, (3, 8)).astype(np.int32)
    lengths = np.array([8, 5, 6], np.int32)
    eng = SDEngine(tm, make_proposer("model", tm, dm), gamma=3)
    out_sd, stats = eng.generate(tpt, tpd, prompts, 16, lengths=lengths)
    out_ar = generate_ar(tm, tpt, prompts, 16, lengths=lengths)
    np.testing.assert_array_equal(out_sd, out_ar)
    assert stats.rounds >= 1 and stats.generated >= 3 * (16 - 1)


def test_greedy_wave_outputs_match_reference():
    """Same weights, same prompts, greedy: the port's wave engine emits the
    reference's tokens exactly (SD waves, then AR waves)."""
    from repro.models.model import Model as JaxModel
    (jpt, jpd), (tm, tpt, dm, tpd) = _pair()
    jt, jd = JaxModel(TARGET, moe_dispatch="gmm"), JaxModel(DRAFT)
    prompts = _prompts()
    for force in (True, False):
        jeng = JaxServingEngine(jt, jd, jpt, jpd, max_batch=4, gamma=4,
                                force_sd=force)
        teng = ServingEngine(tm, dm, tpt, tpd, max_batch=4, gamma=4,
                             force_sd=force)
        for p in prompts:
            jeng.submit(p, max_new_tokens=10)
            teng.submit(p, max_new_tokens=10)
        jrep, trep = jeng.run(), teng.run()
        assert [r.bucket for r in trep] == [r.bucket for r in jrep] == [4, 1]
        for uid in jeng.done:
            np.testing.assert_array_equal(teng.done[uid].output,
                                          jeng.done[uid].output)
        assert [r.stats.rounds for r in trep] == [r.stats.rounds for r in jrep]


def _flash_models():
    """Both pairs with ``use_flash=True``: the same weights as ``_pair``
    (``use_flash`` changes no parameter)."""
    from repro.models.model import Model as JaxModel
    (jpt, jpd), (tm, tpt, dm, tpd) = _pair()
    jt = JaxModel(TARGET, moe_dispatch="gmm", use_flash=True)
    jd = JaxModel(DRAFT, use_flash=True)
    tm.use_flash = dm.use_flash = True
    return (jt, jd, jpt, jpd), (tm, dm, tpt, tpd)


def _long_prompts(n):
    """129-256 tokens: prompt bucket 256, so prefill takes the flash kernel
    and every extend (max_seq 512) the dense decode kernel."""
    pb = prompt_batch(TARGET.vocab_size, n, seed=11, min_len=129, max_len=256)
    return [pb["tokens"][i][: int(pb["lengths"][i])] for i in range(n)]


def test_use_flash_greedy_wave_outputs_match_reference():
    """One SD wave and one AR wave of 4 long prompts."""
    jm, tmods = _flash_models()
    prompts = _long_prompts(4)
    for force in (True, False):
        jeng = JaxServingEngine(*jm, max_batch=4, gamma=4, force_sd=force)
        teng = ServingEngine(*tmods, max_batch=4, gamma=4, force_sd=force)
        for p in prompts:
            jeng.submit(p, max_new_tokens=8)
            teng.submit(p, max_new_tokens=8)
        jrep, trep = jeng.run(), teng.run()
        assert [r.bucket for r in trep] == [r.bucket for r in jrep] == [4]
        for uid in jeng.done:
            np.testing.assert_array_equal(teng.done[uid].output,
                                          jeng.done[uid].output)


def test_use_flash_dense_continuous_stream_matches_reference():
    """Five long prompts through a pool of 4 dense slots (one refill after
    a retirement), SD with the model proposer."""
    jm, tmods = _flash_models()
    prompts = _long_prompts(5)
    engines = [cls(*m, max_batch=4, gamma=4, force_sd=True,
                   scheduler="continuous", kv_layout="dense")
               for cls, m in ((JaxServingEngine, jm), (ServingEngine, tmods))]
    for eng in engines:
        for i, p in enumerate(prompts):
            eng.submit(p, max_new_tokens=4 + 2 * i)
        eng.run()
    jeng, teng = engines
    assert teng.done.keys() == jeng.done.keys() and len(jeng.done) == 5
    for uid in jeng.done:
        assert teng.done[uid].finish_reason == jeng.done[uid].finish_reason
        np.testing.assert_array_equal(teng.done[uid].output,
                                      jeng.done[uid].output)


def _dist(rng, V, sharp=1.0):
    x = rng.standard_normal(V) * sharp
    e = np.exp(x - x.max())
    return e / e.sum()


@pytest.mark.parametrize("seed,vocab,sharp", [
    (0, 2, 0.5), (1, 3, 1.0), (2, 4, 2.0), (3, 5, 3.0), (4, 6, 1.5),
    (5, 6, 0.7)])
def test_rejection_sampling_is_lossless(seed, vocab, sharp):
    """Emitted-token marginal == target distribution p0 for arbitrary
    (p, q), by Monte Carlo through the port's implementation (mirrors
    tests/test_rejection.py::test_lossless_distribution)."""
    rng = np.random.default_rng(seed)
    p0, p1, q0 = (_dist(rng, vocab, sharp) for _ in range(3))
    N = 4000
    gen = torch.Generator().manual_seed(seed)
    p = torch.tensor(np.stack([np.stack([p0, p1])] * N), dtype=torch.float32)
    q = torch.tensor(np.stack([q0] * N), dtype=torch.float32)[:, None]
    drafts = torch.multinomial(q[:, 0], 1, generator=gen).to(torch.int32)
    n_acc, nxt, _ = rejection_sample(p, q, drafts, gen, temperature=1.0)
    emitted = torch.where(n_acc > 0, drafts[:, 0], nxt).numpy()
    counts = np.bincount(emitted, minlength=vocab) / N
    assert np.abs(counts - p0).max() < 4.5 * np.sqrt(p0.max() / N) + 0.02


def test_greedy_rejection_one_hot_path():
    V = 8
    p = torch.nn.functional.one_hot(torch.tensor([[3, 5, 1]]), V).float()
    q = torch.nn.functional.one_hot(torch.tensor([[3, 0]]), V).float()
    n, nxt, _ = rejection_sample(p, q, torch.tensor([[3, 0]]), None, 0.0)
    assert int(n[0]) == 1 and int(nxt[0]) == 5
    np.testing.assert_array_equal(
        probs_from_logits(torch.tensor([[0.1, 2.0, -1.0]]), 0.0).numpy(),
        [[0, 1, 0]])


def test_session_stats_one_construction_per_kind():
    _, (tm, tpt, dm, tpd) = _pair()
    eng = ServingEngine(tm, dm, tpt, tpd, max_batch=2, gamma=2)
    for p in _prompts(4):
        eng.submit(p, max_new_tokens=4)
    eng.run()
    eng.force_sd = False
    for p in _prompts(2):
        eng.submit(p, max_new_tokens=4)
    eng.run()
    stats = eng.session_stats()
    assert stats["resilience"] == {}          # healthy wave serving
    assert {k: s["constructions"] for k, s in stats.items()
            if k != "resilience"} == {"model": 1, "none": 1}
    # both waves ran gamma 2 at batch 2 (a new cache length adds an entry)
    assert set(stats["model"]["traces"]) == {(2, 2)}
    assert stats["none"]["gammas_compiled"] == [0]


def test_serve_cli_autotunes_on_cpu(capsys):
    """Without --no-autotune the CLI serves under the AutoTuner: every
    wave line prints the gamma it ran, its plan and the tuner's alpha
    before and after, and the alpha moves (random weights: alpha ~0)."""
    import re

    from repro_torch.launch import serve
    reports = serve.main(["--arch", "qwen2-57b-a14b", "--reduced", "--device",
                          "cpu", "--requests", "6", "--max-batch", "2",
                          "--max-new", "6"])
    out = capsys.readouterr().out
    plans = re.findall(r"plan: gamma=(\d+) use_sd=(\w+) predicted=\S+ "
                       r"alpha ([\d.]+) -> ([\d.]+)", out)
    assert len(reports) == 3 and len(plans) == 3
    for r, (g, sd, a_in, a_out) in zip(reports, plans):
        assert int(g) == r.plan["gamma"] and f"gamma={r.gamma} " in out
        assert sd == str(r.plan["use_sd"])
    alphas = [float(plans[0][2])] + [float(p[3]) for p in plans]
    assert alphas[0] == 0.7 and all(b < a for a, b in zip(alphas, alphas[1:]))
    assert "graph keys (gamma, batch, max_seq)" in out


def test_serve_cli_runs_on_cpu(capsys):
    from repro_torch.launch import serve
    reports = serve.main(["--arch", "qwen2-57b-a14b", "--reduced", "--device",
                          "cpu", "--requests", "3", "--max-batch", "2",
                          "--max-new", "4", "--no-autotune", "--timed"])
    out = capsys.readouterr().out
    assert len(reports) == 2 and "dispatch=gmm" in out and "verify=" in out
    assert "session[model]: constructed 1x" in out
