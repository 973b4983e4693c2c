"""Serving launcher: batched speculative decoding in waves, on one GPU.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-57b-a14b \
      --reduced --requests 16 --max-batch 8 --max-new 32 --no-autotune

Port of ``repro.launch.serve`` for the flags this slice implements.  The
draft is the reference's default draft for the target (``draft_for``).
Runs on ``--device cuda`` (the default) or ``--device cpu``; without a card
and without ``--device cpu`` it stops.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs.registry import draft_for, get_config
from repro_torch.core.proposer import registered_proposers
from repro_torch.data.pipeline import prompt_batch
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.models.model import Model
from repro_torch.serving.engine import ServingEngine

AUTOTUNE_TODO = (
    "the AutoTuner is not ported yet (ROADMAP queue 1 item 5: AutoTuner with "
    "an H100 Hardware record); pass --no-autotune to serve with a fixed "
    "--gamma, or --proposer none")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--gamma", type=int, default=4)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--kind", default="chat", choices=["code", "chat"])
    ap.add_argument("--proposer", default="model",
                    choices=sorted(registered_proposers()),
                    help="drafting strategy (Proposer registry kind)")
    ap.add_argument("--moe-dispatch", default="gmm", choices=["gmm", "onehot"],
                    help="MoE dispatch for the decode path; gmm = the ragged "
                         "grouped-matmul CUDA kernels")
    ap.add_argument("--timed", action="store_true",
                    help="record per-phase propose/verify/reject timings")
    ap.add_argument("--no-autotune", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if not (args.no_autotune or args.proposer == "none"):
        raise SystemExit(AUTOTUNE_TODO)

    cfg = get_config(args.arch, reduced=args.reduced)
    target = Model(cfg, moe_dispatch=args.moe_dispatch, device=args.device)
    gen = torch.Generator(device=target.device)
    params_t = target.init(gen.manual_seed(args.seed))
    if args.proposer == "none":
        draft, params_d = None, None
    else:
        dcfg = draft_for(cfg) if not args.reduced else \
            draft_for(cfg).with_overrides(
                num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
                d_ff=256, dtype="float32")
        draft = Model(dcfg, device=args.device)
        params_d = draft.init(gen.manual_seed(args.seed + 1))

    eng = ServingEngine(target, draft, params_t, params_d,
                        max_batch=args.max_batch, gamma=args.gamma,
                        temperature=args.temperature, proposer=args.proposer,
                        seed=args.seed, timed=args.timed)
    pb = prompt_batch(cfg.vocab_size, args.requests, kind=args.kind,
                      seed=args.seed)
    for i in range(args.requests):
        eng.submit(pb["tokens"][i][: int(pb["lengths"][i])],
                   max_new_tokens=args.max_new)

    reports = eng.run()
    tok = ByteTokenizer(cfg.vocab_size)
    for r in reports:
        # AR waves carry SDStats too (same loop) but sigma/alpha are
        # degenerate there — label them as the baseline
        sd = (f"sigma={r.stats.sigma:.3f} alpha={r.stats.alpha:.3f} "
              f"rounds={r.stats.rounds}" if r.used_sd and r.stats else "AR")
        timing = (f" propose={r.propose_time:.3f}s verify={r.verify_time:.3f}s"
                  f" reject={r.reject_time:.3f}s" if args.timed else "")
        print(f"{r.scheduler}: B={r.batch}/{r.bucket} gamma={r.gamma} "
              f"proposer={r.proposer} dispatch={r.moe_dispatch} "
              f"sd={r.used_sd} {r.tokens_per_second:.1f} tok/s  "
              f"{sd}{timing}")
    for kind, s in eng.session_stats().items():
        print(f"session[{kind}]: constructed {s['constructions']}x, "
              f"gammas compiled {s['gammas_compiled']}, "
              f"{len(s['traces'])} round traces")
    sample = eng.done[1]
    print(f"sample completion ({sample.finish_reason}):",
          repr(tok.decode(sample.output)[:80]))
    return reports


if __name__ == "__main__":
    main()
