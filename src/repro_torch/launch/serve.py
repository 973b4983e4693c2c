"""Serving launcher: batched speculative decoding on one GPU, in waves or
with the continuous slot scheduler.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-57b-a14b \
      --reduced --requests 16 --max-batch 8 --max-new 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-57b-a14b \
      --reduced --scheduler continuous --kv-layout paged
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-57b-a14b \
      --reduced --scheduler continuous --kv-layout paged --page-size 16 \
      --prefix-sharing --shared-prefix 32 --prefill-chunk 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x7b \
      --reduced --proposer eagle
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-57b-a14b \
      --reduced --proposer prefetch --prefetch-top-m 2
  PYTHONPATH=src python -m repro_torch.launch.serve --arch jamba-v0.1-52b \
      --reduced --scheduler continuous --kv-layout paged
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-57b-a14b \
      --reduced --moe-dispatch ep --ep-degree 1 --transfer-guard
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.serve \
      --arch qwen2-57b-a14b --reduced --ep-degree 4

Every registered arch serves but the encoder-decoder ``whisper-base``, whose
requests carry no encoder frames: ``ServingEngine`` refuses it with a
``ValueError`` (ROADMAP queue 3; ``SpecDecoder.generate``/``generate_ar``
serve it with ``prefill_kwargs={"encoder_embeds": ...}``).

Port of ``repro.launch.serve`` for the flags this slice implements.  The
draft is the reference's default draft for the target (``draft_for``), or
with ``--proposer eagle`` an ``EagleHead`` on the target; ``--proposer
prefetch`` warms ``--prefetch-top-m`` experts a MoE layer each round (default
min(E, 2K)) and prints each wave's hit rate.
Unless ``--no-autotune`` (or ``--proposer none``), an ``AutoTuner`` priced
on the full published config (``make_tuner``, the ``H100`` record) plans
{use_sd, gamma} per wave, or per round in continuous mode, and each wave
line prints its plan and the tuner's alpha before and after the wave.
Runs on ``--device cuda`` (the default) or ``--device cpu``; without a card
and without ``--device cpu`` it stops.  Requests are submitted through
``submit_poisson`` (``--arrival-rate`` 0: all at round 0).

``--moe-dispatch ep`` serves through the expert-parallel all-to-all
dispatch on a ``(1, --ep-degree)`` mesh (``launch/mesh.make_ep_mesh``;
``--ep-degree`` above 1 forces ``ep``).  A degree N above 1 runs one
process a rank under ``torchrun --nproc-per-node N`` (a card each, NCCL;
gloo with ``--device cpu``), every rank serving the same stream; only rank
0 prints.  ``--ep-degree 1`` is a world of one the mesh starts itself.
``--mesh-layout`` places the non-expert weights as the reference's does:
``tp`` splits attention heads, FFN columns/rows and the vocab over the
model axis (``Model.place``, over ``distributed/sharding.shard_params``),
``fsdp`` keeps them whole in serving; under both the target's KV cache
splits its heads (or, where the model axis does not divide them, its
sequence) over the ranks.
``--transfer-guard`` serves the stream a second time, warm, under
``transfer_guard``, ``sharding_guard`` and ``compile_guard``
(``analysis/runtime.py``), prints their counts and exits non-zero on an
implicit host sync or a second input signature; it needs a card.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs.registry import draft_for, get_config
from repro_torch.core.analytics import occupancy_timeline
from repro_torch.core.autotune import AutoTuner
from repro_torch.analysis import compile_guard, sharding_guard, transfer_guard
from repro_torch.analysis.runtime import TRANSFER_GUARD_NEEDS_CUDA
from repro_torch.core.proposer import registered_proposers
from repro_torch.data.pipeline import prompt_batch
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.launch.mesh import make_ep_mesh, mesh_dims
from repro_torch.models.model import Model
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.faults import ResilienceConfig
from repro_torch.serving.scheduler import submit_poisson


def make_tuner(arch: str, proposer: str = "model") -> AutoTuner:
    """The serving CLI's tuner: priced on the FULL published config of
    ``arch`` and its default draft, or for ``proposer="eagle"`` the EAGLE
    head's block on that config (``eagle_head_config``: the drafter that
    serves), whatever depth or width is served."""
    full_cfg = get_config(arch)
    if proposer == "eagle":
        from repro_torch.core.eagle import eagle_head_config
        return AutoTuner(full_cfg, eagle_head_config(full_cfg), alpha=0.7)
    return AutoTuner(full_cfg, draft_for(full_cfg), alpha=0.7)


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
    ap.add_argument("--prefetch-top-m", type=int, default=None,
                    help="--proposer prefetch: experts warmed per MoE "
                         "layer each round (default min(E, 2K), clamped to "
                         "[1, E])")
    ap.add_argument("--moe-dispatch", default="gmm",
                    choices=["gmm", "onehot", "ep"],
                    help="MoE dispatch for the decode path; gmm = the ragged "
                         "grouped-matmul CUDA kernels; ep = experts sharded "
                         "over a mesh, all-to-all dispatch into the same "
                         "kernels (--ep-degree)")
    ap.add_argument("--ep-degree", type=int, default=1,
                    help="expert-parallel ranks: builds a (1, N) "
                         "('data','model') mesh, shards the expert weights "
                         "over it (forces --moe-dispatch ep when > 1; run "
                         "under torchrun --nproc-per-node N)")
    ap.add_argument("--mesh-layout", default="tp", choices=["tp", "fsdp"],
                    help="parameter layout on the mesh for the non-expert "
                         "weights (distributed/sharding.param_spec)")
    ap.add_argument("--transfer-guard", action="store_true",
                    help="after the stream, serve it again warm under the "
                         "runtime guards and fail on an implicit host sync "
                         "or a second round-input signature (needs a card)")
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
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="continuous mode: prefill prompts longer than "
                         "this in chunks interleaved with decode rounds")
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
    ap.add_argument("--prefix-sharing", action="store_true",
                    help="paged mode: admissions whose prompt shares a "
                         "page-aligned prefix with a live slot fork its "
                         "pages (refcounted copy-on-write) and prefill only "
                         "the tail")
    ap.add_argument("--admission-order", default="fifo",
                    choices=["fifo", "pressure"],
                    help="continuous refill order; pressure picks the "
                         "smallest-page-footprint admissible request when "
                         "the paged pool is under pressure")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="prepend this many common system-prompt tokens to "
                         "every request (exercises --prefix-sharing)")
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

    cfg = get_config(args.arch, reduced=args.reduced)
    if args.transfer_guard and torch.device(args.device).type != "cuda":
        raise SystemExit(f"--transfer-guard: {TRANSFER_GUARD_NEEDS_CUDA}")
    mesh, say, own_group = None, print, False
    if args.ep_degree > 1 or args.moe_dispatch == "ep":
        if cfg.num_experts % args.ep_degree != 0:
            raise SystemExit(
                f"--ep-degree {args.ep_degree} does not divide "
                f"num_experts={cfg.num_experts} for {args.arch}")
        own_group = not torch.distributed.is_initialized()
        mesh = make_ep_mesh(args.ep_degree, device=args.device)
        if torch.distributed.get_rank() != 0:
            say = lambda *a, **k: None      # every rank serves; rank 0 prints
        if args.moe_dispatch != "ep":
            say(f"--ep-degree {args.ep_degree}: forcing --moe-dispatch ep")
            args.moe_dispatch = "ep"
        say(f"mesh: {mesh_dims(mesh)} layout={args.mesh_layout} "
            f"({torch.distributed.get_world_size()} ranks, "
            f"{torch.distributed.get_backend()})")
    target = Model(cfg, moe_dispatch=args.moe_dispatch,
                   paged_attention=args.paged_attention, device=args.device,
                   mesh=mesh,
                   mesh_layout=args.mesh_layout if mesh is not None else None)
    if args.proposer == "eagle":
        from repro_torch.core.eagle import EagleHead
        draft = EagleHead(target)       # refuses a head it cannot build,
                                        # before any weight is drawn
    gen = torch.Generator(device=target.device)
    params_t = target.init(gen.manual_seed(args.seed))
    if args.proposer == "eagle":
        params_d = draft.init(gen.manual_seed(args.seed + 1))
    elif args.proposer == "none":
        draft, params_d = None, None
    else:
        dcfg = draft_for(cfg) if not args.reduced else \
            draft_for(cfg).with_overrides(
                num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
                d_ff=256, dtype="float32")
        draft = Model(dcfg, device=args.device)
        params_d = draft.init(gen.manual_seed(args.seed + 1))

    tuner = (None if args.no_autotune or args.proposer == "none"
             else make_tuner(args.arch, args.proposer))
    proposer_opts = {}
    if args.proposer == "prefetch" and args.prefetch_top_m is not None:
        proposer_opts["top_m"] = args.prefetch_top_m
    resilience = ResilienceConfig(
        round_deadline_s=args.round_deadline_s,
        max_rounds_per_request=args.max_rounds_per_request,
        free_page_watermark=args.free_page_watermark,
        max_pool_pages=args.max_pool_pages)
    eng = ServingEngine(target, draft, params_t, params_d,
                        max_batch=args.max_batch, tuner=tuner,
                        gamma=args.gamma,
                        temperature=args.temperature, proposer=args.proposer,
                        proposer_opts=proposer_opts, seed=args.seed, timed=args.timed,
                        scheduler=args.scheduler, eos_id=args.eos_id,
                        admit_mode=args.admit_mode,
                        prefill_chunk=args.prefill_chunk,
                        kv_layout=args.kv_layout, page_size=args.page_size,
                        prefix_sharing=args.prefix_sharing,
                        admission_order=args.admission_order,
                        resilience=resilience, mesh=mesh,
                        mesh_layout=args.mesh_layout if mesh is not None
                        else None)
    pb = prompt_batch(cfg.vocab_size, args.requests, kind=args.kind,
                      seed=args.seed)
    if args.shared_prefix > 0:
        # one common system prompt ahead of every request, the workload
        # prefix sharing is built for (the reference's draws)
        rng = np.random.default_rng(args.seed + 17)
        sys_toks = rng.integers(1, cfg.vocab_size,
                                size=args.shared_prefix).astype(np.int32)
        pb["tokens"] = [np.concatenate([sys_toks, np.asarray(
            pb["tokens"][i][: int(pb["lengths"][i])], np.int32)])
            for i in range(len(pb["lengths"]))]
        pb["lengths"] = [int(n) + args.shared_prefix for n in pb["lengths"]]
    max_new_choices = ([int(x) for x in args.mixed_max_new.split(",")]
                       if args.mixed_max_new else [args.max_new])
    def submit():
        submit_poisson(eng, pb["tokens"], pb["lengths"],
                       rate=args.arrival_rate,
                       max_new_choices=max_new_choices, seed=args.seed)

    submit()
    reports = eng.run()
    tok = ByteTokenizer(cfg.vocab_size)
    for r in reports:
        # AR waves carry SDStats too (same loop) but sigma/alpha are
        # degenerate there — label them as the baseline
        sd = (f"sigma={r.stats.sigma:.3f} alpha={r.stats.alpha:.3f} "
              f"rounds={r.stats.rounds}" if r.used_sd and r.stats else "AR")
        timing = (f" propose={r.propose_time:.3f}s verify={r.verify_time:.3f}s"
                  f" reject={r.reject_time:.3f}s" if args.timed else "")
        if args.timed and r.warm_time:
            timing += f" warm={r.warm_time:.3f}s"
        # on the stats, not the kind: any prefetch-aware proposer counts
        pf = (f" prefetch_hit={r.prefetch_hit_rate:.2f} "
              f"({r.prefetch_hits}/{r.stats.prefetch_actual})"
              if r.stats and r.stats.prefetch_actual else "")
        say(f"{r.scheduler}: B={r.batch}/{r.bucket} gamma={r.gamma} "
            f"proposer={r.proposer} dispatch={r.moe_dispatch} "
            f"sd={r.used_sd} {r.tokens_per_second:.1f} tok/s  "
            f"{sd}{pf}{timing}  captures={r.captures} replays={r.replays}")
        if r.ep is not None:
            say(f"  ep: per_shard_load={r.ep['per_shard_load']} "
                f"imbalance={r.ep['imbalance']:.3f} "
                f"a2a_bytes_per_device={r.ep['a2a_bytes_per_device']:.0f}")
        if r.plan is not None:
            say(f"  plan: gamma={r.plan['gamma']} use_sd={r.plan['use_sd']} "
                f"predicted={r.plan['predicted_speedup']:.3f}x "
                f"alpha {r.tuner_alpha[0]:.3f} -> {r.tuner_alpha[1]:.3f}")
        if r.steps:
            occ = occupancy_timeline([s.live for s in r.steps],
                                     [s.committed for s in r.steps])
            handoffs = sum(1 for a, b in zip(r.steps, r.steps[1:])
                           if a.used_sd != b.used_sd)
            say(f"  N(t): peak={occ['peak_live']:.0f} "
                f"mean={occ['mean_live']:.2f} "
                f"token_weighted={occ['token_weighted_live']:.2f} "
                f"occupancy={occ['mean_occupancy']:.2f}  "
                f"admitted={sum(s.admitted for s in r.steps)} "
                f"retired={sum(s.retired for s in r.steps)} "
                f"sd_handoffs={handoffs}")
            if tuner is not None:
                say(f"  plans (N(t)/gamma per round): "
                    f"{plan_trajectory(r.steps)}  tuner alpha "
                    f"{tuner.alpha:.3f}")
            say(f"  admission: {sum(s.admit_rows for s in r.steps)} "
                f"prefill rows, {sum(s.admit_tokens for s in r.steps)} "
                f"row-tokens ({args.admit_mode}), "
                f"{sum(s.chunk_steps for s in r.steps)} chunk steps, "
                f"{sum(s.shared_tokens for s in r.steps)} shared prompt "
                "tokens not prefilled")
    for kind, s in eng.session_stats().items():
        if kind == "resilience":
            if s:                 # fault/preemption/recovery counters
                say("resilience:", " ".join(f"{k}={v}"
                                            for k, v in sorted(s.items())))
            continue
        say(f"session[{kind}]: constructed {s['constructions']}x, "
            f"gammas compiled {s['gammas_compiled']}, "
            f"{len(s['traces'])} round traces, "
            f"{s['captures']} round captures, {s['replays']} replays, "
            f"{len(s['admit_traces'])} admit traces, "
            f"{len(s['prefix_traces'])} prefix traces, "
            f"{len(s['chunk_traces'])} chunk traces, "
            f"{len(s['growths'])} growths")
        say(f"  graph keys (gamma, batch, max_seq): captures/replays " +
            " ".join(f"{k}:{c}/{n}" for k, (c, n) in sorted(s["keys"].items())))
    sample = eng.done[1]
    say(f"sample completion ({sample.finish_reason}):",
        repr(tok.decode(sample.output)[:80]))
    if args.transfer_guard:
        # the first stream ran every round key and admission shape: the
        # same stream again syncs only at the engine's explicit crossings
        # and reads one input signature a round key
        submit()
        with compile_guard() as cg, transfer_guard() as tg, \
                sharding_guard(eng) as sg:
            eng.run()
        say(f"transfer_guard: {tg.count} implicit host sync(s); "
            f"compile_guard: {cg.count} new program(s); {sg.render()}")
        if tg.count or not sg.ok:
            for line in tg.lines[:10]:
                say(" ", line)
            raise SystemExit("guard violation on the warm stream replay")
    if own_group:
        torch.distributed.destroy_process_group()
    return reports


def plan_trajectory(steps) -> str:
    """A continuous stream's rounds as "N(t)/gamma" (gamma 0: an AR
    round), runs of equal rounds merged as "xN"."""
    runs: list = []
    for s in steps:
        if runs and runs[-1][0] == (s.live, s.gamma):
            runs[-1][1] += 1
        else:
            runs.append([(s.live, s.gamma), 1])
    return " ".join(f"{n}/{g}" + (f"x{c}" if c > 1 else "")
                    for (n, g), c in runs)


if __name__ == "__main__":
    main()
