"""Quickstart on the PyTorch port: the full API in ~60 lines.

1. build a small MoE target + tiny dense draft,
2. train both on a synthetic code corpus,
3. serve a batch with speculative decoding and verify it is lossless,
4. ask the paper's performance model where SD pays off.

    PYTHONPATH=src python examples/quickstart_torch.py            # the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse

import numpy as np
import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import get_config
from repro_torch.core.autotune import AutoTuner
from repro_torch.core.proposer import make_proposer
from repro_torch.core.spec_decode import SDEngine, generate_ar
from repro_torch.data.pipeline import packed_batches, prompt_batch
from repro_torch.models.model import Model
from repro_torch.training.train_loop import init_train_state, make_train_step


def train(model, steps, kind, seed, lr=3e-3):
    params, opt = init_train_state(
        model, torch.Generator(model.device).manual_seed(seed))
    step = make_train_step(model, TrainConfig(
        learning_rate=lr, total_steps=steps, warmup_steps=steps // 10))
    it = packed_batches(model.cfg.vocab_size, 8, 64, kind=kind, seed=seed)
    for i in range(steps):
        params, opt, m = step(params, opt, next(it))
        if i % 50 == 0:
            print(f"  [{model.cfg.name}] step {i:4d} loss {float(m['loss']):.3f}")
    return params


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; no silent fallback")
    ap.add_argument("--steps", type=int, default=200)
    args = ap.parse_args()

    # 1. models — the paper's pairing, reduced: MoE target + small dense draft
    tcfg = get_config("qwen2-57b-a14b", reduced=True)
    dcfg = get_config("qwen2-0.5b", reduced=True)
    target, draft = Model(tcfg, device=args.device), Model(dcfg,
                                                          device=args.device)

    # 2. train both on the same distribution so the draft can speculate
    print("training target (reduced Qwen2-57B-A14B)...")
    params_t = train(target, args.steps, "code", seed=0)
    print("training draft (reduced Qwen2-0.5B)...")
    params_d = train(draft, args.steps, "code", seed=1)

    # 3. batched speculative decoding — one SDEngine session, any proposer
    #    from the registry ("model" | "eagle" | "none") — and the
    #    losslessness check against the AR baseline (the "none" path)
    pb = prompt_batch(tcfg.vocab_size, 8, kind="code", seed=7)
    prompts, lengths = pb["tokens"], pb["lengths"]
    sd = SDEngine(target, make_proposer("model", target, draft),
                  gamma=4, temperature=0.0)
    out_sd, stats = sd.generate(params_t, params_d, prompts, 32,
                                lengths=lengths)
    out_ar = generate_ar(target, params_t, prompts, 32, lengths=lengths)
    assert np.array_equal(out_sd, out_ar), "SD must be lossless"
    print(f"\nSD lossless ✓  alpha={stats.alpha:.2f} sigma={stats.sigma:.2f} "
          f"rounds={stats.rounds} (AR would need 32)")

    # 4. the paper's model: where does SD pay off for the FULL config?
    tuner = AutoTuner(get_config("qwen2-57b-a14b"), get_config("qwen2-0.5b"),
                      alpha=stats.alpha)
    win = tuner.speedup_window()
    print(f"predicted on {tuner.sim.hw.name}: peak {win['peak']:.2f}x at "
          f"batch {win['peak_batch']}, SD-favourable window "
          f"B∈{win['window']}")


if __name__ == "__main__":
    main()
