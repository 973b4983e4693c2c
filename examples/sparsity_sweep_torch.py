"""Mini-reproduction of Fig. 4 on the PyTorch port: vary K on the paper's
target, predict the speedup with the simulator, fit the Alg. 1 model,
print both curves.  The simulator is host arithmetic over the H100 record
(``core/simulator.H100``); nothing runs on a device, so ``--device`` only
names where the rest of the port would run.

    PYTHONPATH=src python examples/sparsity_sweep_torch.py
"""
import argparse

import numpy as np

from repro_torch.configs.registry import get_config
from repro_torch.core.analytics import activation_threshold, sigma_from_alpha
from repro_torch.core.perf_model import Measurement, SpeedupModel, stride_sample
from repro_torch.core.simulator import Simulator

BATCHES = [1, 2, 4, 8, 16, 24, 32, 48, 64, 96, 128, 192, 256]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="accepted for symmetry with the other examples; "
                         "the sweep is host arithmetic")
    ap.parse_args(argv)
    target = get_config("qwen2-57b-a14b")
    draft = get_config("qwen2-0.5b")
    sim = Simulator()
    sigma = float(sigma_from_alpha(0.8, 4))

    rows = []
    print(f"{'K':>3} {'rho':>6} {'T_thres':>8} {'peak x':>7} {'@B':>5}  curve "
          f"({sim.hw.name})")
    for K in (1, 2, 4, 8, 16, 32):
        cfg = target.with_overrides(num_experts_per_tok=K)
        curve = [sim.sd_speedup(cfg, draft, b, 4, sigma) for b in BATCHES]
        i = int(np.argmax(curve))
        print(f"{K:3d} {K/64:6.3f} {activation_threshold(K/64):8d} "
              f"{curve[i]:7.2f} {BATCHES[i]:5d}  "
              + " ".join(f"{x:.2f}" for x in curve))
        for b, s in zip(BATCHES, curve):
            rows.append(Measurement(b, 4, K, 64, sigma, s))

    model = SpeedupModel(engine_semantics=True)
    fit = model.fit(stride_sample(rows, 21), target, draft)
    print(f"\nAlg.1 model fitted on 21 points: MSE={fit['mse']:.3f}")
    pred = model.predict([16, 48, 128], [4] * 3, [8] * 3, [64] * 3, [sigma] * 3)
    act = [sim.sd_speedup(target, draft, b, 4, sigma) for b in (16, 48, 128)]
    for b, p, a in zip((16, 48, 128), pred, act):
        print(f"  B={b:3d}: model {p:.2f}x vs simulator {a:.2f}x")
    return fit


if __name__ == "__main__":
    main()
