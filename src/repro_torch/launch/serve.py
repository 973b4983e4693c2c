"""Serving launcher: batched speculative decoding on one GPU, in waves or
with the continuous slot scheduler.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-57b-a14b \
      --reduced --requests 16 --max-batch 8 --max-new 32 --no-autotune
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-57b-a14b \
      --reduced --scheduler continuous --kv-layout paged --no-autotune

Port of ``repro.launch.serve`` for the flags this slice implements.  The
draft is the reference's default draft for the target (``draft_for``).
Runs on ``--device cuda`` (the default) or ``--device cpu``; without a card
and without ``--device cpu`` it stops.  Requests are submitted through
``submit_poisson`` (``--arrival-rate`` 0: all at round 0).
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs.registry import draft_for, get_config
from repro_torch.core.analytics import occupancy_timeline
from repro_torch.core.proposer import registered_proposers
from repro_torch.data.pipeline import prompt_batch
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.models.model import Model
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.faults import ResilienceConfig
from repro_torch.serving.scheduler import submit_poisson

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
    ap.add_argument("--scheduler", default="wave",
                    choices=["wave", "continuous"],
                    help="wave = static batch per wave; continuous = slot "
                         "pool with in-flight admission "
                         "(serving/scheduler.py)")
    ap.add_argument("--arrival-rate", type=float, default=0.0,
                    help="continuous mode: Poisson mean arrivals per decode "
                         "round (0 = everything arrives at round 0)")
    ap.add_argument("--mixed-max-new", default=None,
                    help="comma list of max_new_tokens choices drawn per "
                         "request (default: --max-new for every request)")
    ap.add_argument("--eos-id", type=int, default=None,
                    help="early-exit token id (per-request finish_reason)")
    ap.add_argument("--admit-mode", default="sliced",
                    choices=["sliced", "full"],
                    help="continuous admission: prefill only the admitted "
                         "rows (sliced) or the whole pool (full)")
    ap.add_argument("--kv-layout", default="dense",
                    choices=["dense", "paged"],
                    help="target KV layout; paged = block-table pages with "
                         "on-demand growth (continuous mode)")
    ap.add_argument("--page-size", type=int, default=64,
                    help="positions per KV page with --kv-layout paged")
    ap.add_argument("--paged-attention", default="kernel",
                    choices=["kernel", "gather"],
                    help="paged decode/verify attention: the block-table-"
                         "walking CUDA kernel (default) or the dense "
                         "pool[table] gather, a cross-check allowed only "
                         "with --device cpu")
    ap.add_argument("--admission-order", default="fifo",
                    choices=["fifo", "pressure"],
                    help="continuous refill order; pressure picks the "
                         "smallest-page-footprint admissible request when "
                         "the paged pool is under pressure")
    ap.add_argument("--round-deadline-s", type=float, default=None,
                    help="resilience: per-round wall-clock deadline; slower "
                         "rounds count toward the degradation ladder")
    ap.add_argument("--max-rounds-per-request", type=int, default=None,
                    help="resilience: per-request round budget "
                         "(finish_reason='timeout' past it)")
    ap.add_argument("--free-page-watermark", type=float, default=0.0,
                    help="resilience: defer admissions that would leave the "
                         "paged pool's free fraction below this")
    ap.add_argument("--max-pool-pages", type=int, default=None,
                    help="resilience: hard cap on paged pool growth; at the "
                         "cap page pressure preempts the youngest slot")
    ap.add_argument("--timed", action="store_true",
                    help="record per-phase propose/verify/reject timings")
    ap.add_argument("--no-autotune", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if not (args.no_autotune or args.proposer == "none"):
        raise SystemExit(AUTOTUNE_TODO)

    cfg = get_config(args.arch, reduced=args.reduced)
    target = Model(cfg, moe_dispatch=args.moe_dispatch,
                   paged_attention=args.paged_attention, device=args.device)
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

    resilience = ResilienceConfig(
        round_deadline_s=args.round_deadline_s,
        max_rounds_per_request=args.max_rounds_per_request,
        free_page_watermark=args.free_page_watermark,
        max_pool_pages=args.max_pool_pages)
    eng = ServingEngine(target, draft, params_t, params_d,
                        max_batch=args.max_batch, gamma=args.gamma,
                        temperature=args.temperature, proposer=args.proposer,
                        seed=args.seed, timed=args.timed,
                        scheduler=args.scheduler, eos_id=args.eos_id,
                        admit_mode=args.admit_mode,
                        kv_layout=args.kv_layout, page_size=args.page_size,
                        admission_order=args.admission_order,
                        resilience=resilience)
    pb = prompt_batch(cfg.vocab_size, args.requests, kind=args.kind,
                      seed=args.seed)
    max_new_choices = ([int(x) for x in args.mixed_max_new.split(",")]
                       if args.mixed_max_new else [args.max_new])
    submit_poisson(eng, pb["tokens"], pb["lengths"], rate=args.arrival_rate,
                   max_new_choices=max_new_choices, seed=args.seed)

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
              f"{sd}{timing}  captures={r.captures} replays={r.replays}")
        if r.steps:
            occ = occupancy_timeline([s.live for s in r.steps],
                                     [s.committed for s in r.steps])
            handoffs = sum(1 for a, b in zip(r.steps, r.steps[1:])
                           if a.used_sd != b.used_sd)
            print(f"  N(t): peak={occ['peak_live']:.0f} "
                  f"mean={occ['mean_live']:.2f} "
                  f"token_weighted={occ['token_weighted_live']:.2f} "
                  f"occupancy={occ['mean_occupancy']:.2f}  "
                  f"admitted={sum(s.admitted for s in r.steps)} "
                  f"retired={sum(s.retired for s in r.steps)} "
                  f"sd_handoffs={handoffs}")
            print(f"  admission: {sum(s.admit_rows for s in r.steps)} "
                  f"prefill rows, {sum(s.admit_tokens for s in r.steps)} "
                  f"row-tokens ({args.admit_mode})")
    for kind, s in eng.session_stats().items():
        if kind == "resilience":
            if s:                 # fault/preemption/recovery counters
                print("resilience:", " ".join(f"{k}={v}"
                                              for k, v in sorted(s.items())))
            continue
        print(f"session[{kind}]: constructed {s['constructions']}x, "
              f"gammas compiled {s['gammas_compiled']}, "
              f"{len(s['traces'])} round traces, "
              f"{s['captures']} round captures, {s['replays']} replays, "
              f"{len(s['admit_traces'])} admit traces, "
              f"{len(s['growths'])} growths")
    sample = eng.done[1]
    print(f"sample completion ({sample.finish_reason}):",
          repr(tok.decode(sample.output)[:80]))
    return reports


if __name__ == "__main__":
    main()
