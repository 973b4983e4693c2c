"""Training launcher: AdamW on synthetic packed batches, on one device.

Port of ``repro.launch.train``: ``Model(cfg, remat=True)`` with the default
``onehot`` MoE dispatch and no ``use_flash`` (the reference's training
reaches no kernel: none of the CUDA kernels has a backward, and each
refuses an input that requires grad), the step of
``training/train_loop.make_train_step``, the reference's log line, and a
checkpoint of params and optimizer state at the end with ``--ckpt-dir``.
Runs on ``--device cuda`` (the default) or ``--device cpu``; without a
card and without ``--device cpu`` it stops.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-57b-a14b \
      --reduced --steps 20 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
      --steps 20 --batch 4 --seq 2048 --kind code
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import packed_batches
from repro_torch.models.model import Model
from repro_torch.training.checkpoint import save_checkpoint
from repro_torch.training.train_loop import init_train_state, make_train_step
from repro_torch.training.tree import tree_leaves


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Train; returns {"params", "opt", "losses", "step_seconds" (host
    clock, each step to the read of its loss), "ckpt" (the checkpoint's
    path or None)} for callers that drive it from Python."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--kind", default="code", choices=["code", "chat"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, reduced=args.reduced)
    tcfg = TrainConfig(learning_rate=args.lr, total_steps=args.steps,
                       warmup_steps=max(args.steps // 10, 1), seed=args.seed)
    model = Model(cfg, remat=True, device=args.device)
    dev = model.device
    params, opt = init_train_state(
        model, torch.Generator(dev).manual_seed(args.seed))
    n_params = sum(x.numel() for x in tree_leaves(params))
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M "
          f"batch={args.batch}x{args.seq}")

    step_fn = make_train_step(model, tcfg)
    it = packed_batches(cfg.vocab_size, args.batch, args.seq, kind=args.kind,
                        seed=args.seed)
    frames = torch.Generator(dev).manual_seed(0)

    def make_batch():
        out = {k: torch.as_tensor(v, device=dev) for k, v in next(it).items()}
        if cfg.is_encoder_decoder:
            out["encoder_embeds"] = torch.randn(
                (args.batch, cfg.encoder_seq_len, cfg.d_model),
                generator=frames, device=dev).to(model.dtype) * 0.02
        return out

    losses, step_seconds = [], []
    t0 = time.perf_counter()
    for step in range(1, args.steps + 1):
        t_step = time.perf_counter()
        params, opt, metrics = step_fn(params, opt, make_batch())
        # reading the loss waits for the whole step, the update included
        losses.append(float(metrics["loss"]))
        step_seconds.append(time.perf_counter() - t_step)
        if step % args.log_every == 0 or step == 1:
            dt = time.perf_counter() - t0
            print(f"step {step:5d}  loss {losses[-1]:.4f}  "
                  f"aux {float(metrics['aux_loss']):.4f}  "
                  f"gnorm {float(metrics['grad_norm']):.3f}  "
                  f"lr {float(metrics['lr']):.2e}  {dt:.1f}s")
    path = None
    if args.ckpt_dir:
        path = save_checkpoint(args.ckpt_dir, args.steps,
                               {"params": params, "opt": opt},
                               {"arch": cfg.name})
        print("saved", path)
    return {"params": params, "opt": opt, "losses": losses,
            "step_seconds": step_seconds, "ckpt": path}


if __name__ == "__main__":
    main()
