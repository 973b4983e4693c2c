"""Batched SD serving of an MoE on the PyTorch port (the paper's
private-serving scenario): continuous waves of requests, auto-tuned gamma,
per-wave sigma/alpha and the target-efficiency measurement of Sec. 3.1 —
drafted by the prefetch-aware proposer (core/prefetch.py), which probes
the target's routers over each draft stream and warms the predicted
experts' weights during the propose phase; every wave reports the
prediction's hit rate.

    PYTHONPATH=src python examples/serve_moesd_torch.py            # the card
    PYTHONPATH=src python examples/serve_moesd_torch.py --device cpu
"""
import argparse

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import get_config
from repro_torch.core.analytics import occupancy_timeline
from repro_torch.core.autotune import AutoTuner
from repro_torch.core.target_efficiency import measure_target_efficiency
from repro_torch.data.pipeline import packed_batches, prompt_batch
from repro_torch.models.model import Model
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.scheduler import submit_poisson
from repro_torch.training.train_loop import init_train_state, make_train_step


def quick_train(model, steps, kind, seed):
    params, opt = init_train_state(
        model, torch.Generator(model.device).manual_seed(seed))
    step = make_train_step(model, TrainConfig(
        learning_rate=3e-3, total_steps=steps, warmup_steps=steps // 10))
    it = packed_batches(model.cfg.vocab_size, 8, 64, kind=kind, seed=seed)
    for _ in range(steps):
        params, opt, _ = step(params, opt, next(it))
    return params


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; no silent fallback")
    ap.add_argument("--steps", type=int, default=150)
    args = ap.parse_args()
    dev = args.device
    tcfg = get_config("mixtral-8x7b", reduced=True)
    dcfg = get_config("qwen2-0.5b", reduced=True).with_overrides(
        vocab_size=tcfg.vocab_size)
    # train with the onehot dispatch (every kernel wrapper refuses
    # autograd); serve with the ragged gmm kernels, the decode-path default
    draft = Model(dcfg, device=dev)
    print("training reduced Mixtral target + draft on chat workload...")
    params_t = quick_train(Model(tcfg, device=dev), args.steps, "chat", 0)
    params_d = quick_train(draft, args.steps, "chat", 1)
    target = Model(tcfg, moe_dispatch="gmm", device=dev)

    # the tuner plans from the FULL Mixtral config on the H100 record
    tuner = AutoTuner(get_config("mixtral-8x7b"),
                      get_config("qwen2-0.5b"), alpha=0.6)
    # one persistent decoding session per proposer kind; "prefetch" wraps
    # the small-model drafter with draft-phase expert warming (greedy
    # outputs are identical); top_m=2 warms half the reduced config's
    # experts, so the hit rate reflects the probe's quality
    eng = ServingEngine(target, draft, params_t, params_d, max_batch=8,
                        tuner=tuner, proposer="prefetch",
                        proposer_opts={"top_m": 2}, seed=0)
    pb = prompt_batch(tcfg.vocab_size, 24, kind="chat", seed=5)
    for i in range(24):
        eng.submit(pb["tokens"][i][: pb["lengths"][i]], max_new_tokens=24)
    print("serving 24 requests in waves of ≤8 (prefetch-aware drafting)...")
    for r in eng.run():
        s = r.stats
        extra = (f"sigma={s.sigma:.2f} alpha={s.alpha:.2f} rounds={s.rounds}"
                 if r.used_sd and s else "AR mode")
        if r.used_sd and s and s.prefetch_actual:
            extra += (f" prefetch_hit={r.prefetch_hit_rate:.2f} "
                      f"({r.prefetch_hits}/{s.prefetch_actual})")
        print(f"  wave B={r.batch} gamma={r.gamma} sd={r.used_sd} "
              f"{r.tokens_per_second:6.1f} tok/s  {extra}")

    # continuous batching on the same persistent sessions: a fixed pool of
    # slots refilled between rounds, the tuner re-planning {use_sd, gamma}
    # on the live slot count every round, Poisson arrivals
    pb2 = prompt_batch(tcfg.vocab_size, 16, kind="chat", seed=11)
    submit_poisson(eng, pb2["tokens"], pb2["lengths"], rate=1.0,
                   max_new_choices=(8, 16, 24), seed=11)
    print("serving 16 Poisson arrivals through the continuous slot "
          "scheduler (pool of 8)...")
    r = eng.step_continuous()
    occ = occupancy_timeline([s.live for s in r.steps],
                             [s.committed for s in r.steps])
    print(f"  stream: {r.batch} requests, {r.tokens_out} tokens, "
          f"{r.tokens_per_second:6.1f} tok/s over {r.stats.rounds} rounds")
    print(f"  N(t): peak={occ['peak_live']:.0f} mean={occ['mean_live']:.2f} "
          f"token_weighted={occ['token_weighted_live']:.2f} "
          f"occupancy={occ['mean_occupancy']:.2f}")

    # target efficiency, measured on this device (Sec. 3.1 metric)
    cache = target.init_cache(8, 128)
    _, cache = target.prefill(params_t, pb["tokens"][:8, :32], cache)
    te = measure_target_efficiency(target, params_t, cache, gamma=4, iters=3)
    print(f"measured target efficiency T(B,1)/T(B,5) = "
          f"{te['target_efficiency']:.2f} ({target.device.type})")
    print(f"tuner's final alpha estimate: {tuner.alpha:.2f}")
    for kind, s in eng.session_stats().items():
        if kind == "resilience":
            continue              # fault counters (empty on healthy waves)
        print(f"session[{kind}]: constructed {s['constructions']}x for "
              f"{len(eng.reports)} waves, gammas compiled "
              f"{s['gammas_compiled']}, {len(s['traces'])} round traces")


if __name__ == "__main__":
    main()
