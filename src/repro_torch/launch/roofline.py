"""Roofline analysis over dry-run records (``launch/dryrun.py``).

Port of ``repro.launch.roofline``, over a ``core/simulator.Hardware``
record (``H100`` by default; ``V5E``, the reference's constants, gives the
reference's fields exactly).  Per (arch x shape x mesh):

    compute term    = FLOPs_per_device / hw.peak_flops
    memory term     = bytes_per_device / hw.hbm_bw
    collective term = collective_bytes_per_device / link bandwidth

The numerators of the first two are the analytic census of
``Simulator.forward_costs`` (the one the tuner prices) divided by the
devices, as in the reference: the dry-run's own counts are unfused (its
bytes) and its FLOPs are reported beside as ``hlo_flops_per_device_raw``
(the reference's key).  The collective numerator is the census,
``in_loop x num_periods + outside``.  Its link: NVLink inside a node
(``hw.ici_bw``, 450 GB/s a way on the H100); on a mesh of several nodes
("4x8") the bytes of collectives over the data axis cross InfiniBand
(``IB_BW``).  Plus

    MODEL_FLOPS = 6·N·D (dense) or 6·N_active·D (MoE) for train,
                  2·N(_active)·D for inference forwards,
    usefulness  = MODEL_FLOPS / (FLOPs_per_device × devices)

and whether the peak bytes a rank holds fit its card (``fits_80gb`` on the
H100, ``fits_16gb`` on the v5e).

    PYTHONPATH=src python -m repro_torch.launch.roofline results/dryrun.jsonl [--csv] [--hw v5e]
"""
from __future__ import annotations

import argparse
import glob
import json

from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.configs.registry import get_config
from repro_torch.core.simulator import H100, V5E, Hardware, Simulator
from repro_torch.launch.specs import arch_for_shape

# ConnectX-7 InfiniBand NDR, one port of 400 Gb/s a card (NVIDIA's data
# sheet): the link of a collective whose group spans nodes, bytes/s
IB_BW = 400e9 / 8
# device memory of one card, bytes (data sheets)
HBM_BYTES = {V5E.name: 16e9, H100.name: 80e9}


def model_flops(rec: dict) -> float:
    """Useful model FLOPs for the whole step (global, not per-device)."""
    shape = INPUT_SHAPES[rec["shape"]]
    n_active = rec["active_params"]
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    tokens = shape.global_batch * (1 + rec.get("gamma", 0))
    return 2.0 * n_active * tokens


def per_device_costs(rec: dict):
    """(flops, bytes, collective_bytes, num_periods) per device: the
    analytic census over the devices, and the collective census."""
    shape = INPUT_SHAPES[rec["shape"]]
    cfg = arch_for_shape(rec["arch"], shape, rec.get("gamma", 0))
    n_dev = rec["devices"]
    sim = Simulator()
    if shape.kind == "train":
        costs = sim.forward_costs(cfg, shape.global_batch, shape.seq_len,
                                  context_len=shape.seq_len, train=True)
    elif shape.kind == "prefill":
        costs = sim.forward_costs(cfg, shape.global_batch, shape.seq_len,
                                  context_len=shape.seq_len)
    else:
        costs = sim.forward_costs(cfg, shape.global_batch,
                                  1 + rec.get("gamma", 0),
                                  context_len=shape.seq_len)
    P = cfg.num_periods
    coll = rec["collective_bytes_per_device"]
    if "in_loop" in coll:
        c = coll["in_loop"] * P + coll["outside"]
    else:  # a record without loop attribution: conservative x P
        c = coll["total"] * P
    return costs["flops"] / n_dev, costs["bytes"] / n_dev, c, P


def collective_time(rec: dict, c: float, hw: Hardware) -> float:
    """Seconds for ``c`` collective bytes a device: NVLink (``hw.ici_bw``)
    inside a node; the bytes over the data axis of a mesh of several nodes
    (``collective_bytes_by_axis``) over InfiniBand."""
    by_axis = rec.get("collective_bytes_by_axis")
    nodes = int(rec.get("mesh", "1").split("x")[0]) if by_axis else 1
    if nodes <= 1:
        return c / hw.ici_bw
    across = sum(n for axes, n in by_axis.items()
                 if "data" in axes.split("+"))
    return (c - across) / hw.ici_bw + across / IB_BW


def next_move(rec: dict, dominant: str, usefulness: float,
              hw: Hardware = H100) -> str:
    """One sentence per (arch, shape): what would move the dominant term
    down.  The figures in parentheses are the reference's TPU
    measurements, quoted under ``V5E`` only."""
    tpu = hw.name == V5E.name
    shape = INPUT_SHAPES[rec["shape"]]
    try:
        cfg = get_config(rec["arch"])
    except KeyError:
        return ""
    is_moe = cfg.num_experts > 0
    if dominant == "collective":
        if shape.kind == "train" and is_moe:
            return ("--moe-dispatch ep --layout fsdp: a2a expert dispatch + "
                    "no-TP layout" + (" (measured -90% on jamba)" if tpu
                                      else ""))
        if shape.kind == "train":
            return ("--layout fsdp removes per-layer TP activation "
                    "all-reduces" + (" (measured -91% gemma3, -95% xlstm)"
                                     if tpu else ""))
        return ("decode/prefill collectives are cache-update resharding: "
                "align kv_mode with the head/seq split")
    if dominant == "memory":
        if shape.kind == "decode":
            return ("this is the paper's opportunity: SD verify rides the "
                    "same reads (gamma+1 tokens, +<3% t_mem); beyond that, "
                    "int8 weights / KV quantization")
        return "recompute less (remat policy) or raise arithmetic intensity"
    # compute-dominant
    if usefulness < 0.6 and is_moe:
        return "--moe-dispatch ep removes the E/K one-hot redundancy"
    return (f"at {usefulness:.0%} of useful-FLOP roofline: raise per-chip "
            "batch or trim remat recompute")


def analyze(rec: dict, hw: Hardware = H100) -> dict:
    n_dev = rec["devices"]
    f, b, c, P = per_device_costs(rec)
    t_compute = f / hw.peak_flops
    t_memory = b / hw.hbm_bw
    coll = rec["collective_bytes_per_device"]
    t_coll = collective_time(rec, c, hw)
    terms = {"compute": t_compute, "memory": t_memory, "collective": t_coll}
    dominant = max(terms, key=terms.get)
    mf = model_flops(rec)
    useful = mf / max(f * n_dev, 1.0)
    bound = max(terms.values())
    peak = rec["memory"].get("peak_bytes", 0)
    hbm = HBM_BYTES.get(hw.name, 80e9)
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "t_compute_s": t_compute, "t_memory_s": t_memory,
        "t_collective_s": t_coll, "dominant": dominant,
        "model_flops": mf, "usefulness": useful,
        "scan_trip_count": P,
        "hlo_flops_per_device_raw": rec["flops_per_device"],
        "roofline_bound_s": bound,
        "peak_bytes_gb": peak / 1e9,
        "temp_sum_gb": rec["memory"]["temp_bytes"] / 1e9,
        f"fits_{hbm / 1e9:.0f}gb": peak < hbm,
        "next_move": next_move(rec, dominant, useful, hw),
        "collective_breakdown": coll,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("files", nargs="+")
    ap.add_argument("--csv", action="store_true")
    ap.add_argument("--hw", default="h100", choices=["h100", "v5e"],
                    help="the hardware record (v5e: the reference's)")
    args = ap.parse_args(argv)
    hw = {"h100": H100, "v5e": V5E}[args.hw]
    fits = f"fits_{HBM_BYTES[hw.name] / 1e9:.0f}gb"
    recs = []
    for pat in args.files:
        for f in glob.glob(pat):
            with open(f) as fh:
                for ln in fh:
                    d = json.loads(ln)
                    if d.get("status") == "ok":
                        recs.append(analyze(d, hw))
    recs.sort(key=lambda r: (r["arch"], r["shape"], r["mesh"]))
    if args.csv:
        print("arch,shape,mesh,t_compute_s,t_memory_s,t_collective_s,"
              f"dominant,usefulness,peak_gb,temp_sum_gb,{fits},next_move")
        for r in recs:
            print(f"{r['arch']},{r['shape']},{r['mesh']},"
                  f"{r['t_compute_s']:.4g},{r['t_memory_s']:.4g},"
                  f"{r['t_collective_s']:.4g},{r['dominant']},"
                  f"{r['usefulness']:.3f},{r['peak_bytes_gb']:.2f},"
                  f"{r['temp_sum_gb']:.2f},{r[fits]},"
                  f"\"{r['next_move']}\"")
    else:
        for r in recs:
            print(json.dumps(r))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
