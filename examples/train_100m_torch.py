"""End-to-end training on the PyTorch port: a ~100M-parameter MoE
for a few hundred steps with checkpointing.

    PYTHONPATH=src python examples/train_100m_torch.py [--steps 300]
    PYTHONPATH=src python examples/train_100m_torch.py --device cpu
"""
import argparse
import time

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.data.pipeline import packed_batches
from repro_torch.models.model import Model
from repro_torch.training.checkpoint import save_checkpoint
from repro_torch.training.train_loop import init_train_state, make_train_step
from repro_torch.training.tree import tree_leaves


def model_100m() -> ModelConfig:
    """~100M params: a miniature of the paper's Qwen2-57B-A14B shape
    (same family: GQA + shared-expert MoE, rho=1/8)."""
    return ModelConfig(
        name="moesd-100m", family="moe",
        num_layers=8, d_model=512, num_heads=8, num_kv_heads=2,
        head_dim=64, d_ff=1408, vocab_size=8192,
        num_experts=16, num_experts_per_tok=2, moe_d_ff=512,
        num_shared_experts=1, qkv_bias=True, dtype="float32",
        router_aux_loss_coef=0.01,
        source="scaled-down arXiv:2407.10671",
    )


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    # defaults sized for a CPU smoke run; on the card raise them freely
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default="results/ckpt_100m_torch")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; no silent fallback")
    args = ap.parse_args()

    cfg = model_100m()
    model = Model(cfg, remat=True, device=args.device)
    params, opt = init_train_state(
        model, torch.Generator(model.device).manual_seed(0))
    n = sum(x.numel() for x in tree_leaves(params))
    print(f"{cfg.name}: {n/1e6:.1f}M params "
          f"({cfg.active_param_count()/1e6:.1f}M active/token) on "
          f"{model.device}")

    tcfg = TrainConfig(learning_rate=1e-3, total_steps=args.steps,
                       warmup_steps=args.steps // 10)
    step = make_train_step(model, tcfg)
    it = packed_batches(cfg.vocab_size, args.batch, args.seq, kind="code")

    t0 = time.perf_counter()
    first = last = None
    for i in range(1, args.steps + 1):
        params, opt, m = step(params, opt, next(it))
        if i == 1:
            first = float(m["loss"])
        if i % 25 == 0 or i == args.steps:
            last = float(m["loss"])
            tput = args.batch * args.seq * i / (time.perf_counter() - t0)
            counts = m["expert_counts"].float()
            imbalance = float(counts.max() / counts.mean().clamp(min=1))
            print(f"step {i:4d}  loss {last:.4f}  aux "
                  f"{float(m['aux_loss']):.3f}  expert-imbalance "
                  f"{imbalance:.2f}x  {tput:.0f} tok/s")
    path = save_checkpoint(args.ckpt_dir, args.steps,
                           {"params": params, "opt": opt},
                           {"arch": cfg.name, "loss": last})
    print(f"loss {first:.3f} → {last:.3f}; checkpoint at {path}")
    assert last < first - 1.0, "training must make real progress"


if __name__ == "__main__":
    main()
