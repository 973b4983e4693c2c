"""Cells, configurations, traffic mixes and per-layer metric readers, found
by the names in ``BENCHMARK.json``.

A cell (``workloads`` entry) names a configuration and a traffic mix.  The
configuration's file is the entry's ``file``; the traffic mix is
``perfbench/traffic/<traffic>.json``; a per-layer metric is read by
``perfbench/metrics/<name>.py``.  Adding any of them is adding files and
entries: nothing here names a cell, a model or a metric.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parents[2]
BENCH_DIR = ROOT / "perfbench"


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    end_to_end: List[dict] = field(default_factory=list)
    per_layer: List[dict] = field(default_factory=list)
    root: Path = ROOT


def load_manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def reports(metric: dict, cell: str) -> bool:
    """Whether ``cell`` reports ``metric`` (no ``workloads`` key: every
    cell)."""
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(name: str, root: Path = ROOT,
            manifest: Optional[dict] = None) -> Cell:
    """The cell ``name`` with its configuration, traffic mix and metrics."""
    manifest = manifest or load_manifest(root)
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; known: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    cfg_entry = configs[w["config"]]
    config = json.loads((root / cfg_entry["file"]).read_text())
    traffic = json.loads((root / "perfbench" / "traffic"
                          / f"{w['traffic']}.json").read_text())
    return Cell(name=name, chips=int(w["chips"]), config_name=w["config"],
                config=config, traffic_name=w["traffic"], traffic=traffic,
                end_to_end=[m for m in manifest["end_to_end"]
                            if reports(m, name)],
                per_layer=[m for m in manifest["per_layer"]
                           if reports(m, name)],
                root=root)


def metric_reader(name: str, root: Path = ROOT):
    """The module of ``perfbench/metrics/<name>.py``: ``UNIT``, ``LAYER``,
    ``MOVES``, ``SOURCE`` and ``read(ctx)``, which returns the metric's
    value or None where the run gave it nothing to read."""
    path = root / "perfbench" / "metrics" / f"{name}.py"
    mod_name = "perfbench_metric_" + "".join(
        c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------- model sizes

def target_spec(config: dict) -> Dict[str, object]:
    """The reference's sizes of a configuration's target (published keys
    of its ``config.json``; experts under ``num_experts`` or Mixtral's
    ``num_local_experts``)."""
    experts = int(config.get("num_experts", config.get("num_local_experts",
                                                       0)))
    d = int(config["hidden_size"])
    heads = int(config["num_attention_heads"])
    return {
        "d": d,
        "layers": int(config["num_hidden_layers"]),
        "heads": heads,
        "kv_heads": int(config["num_key_value_heads"]),
        "head_dim": int(config.get("head_dim", d // heads)),
        "vocab": int(config["vocab_size"]),
        "eps": float(config["rms_norm_eps"]),
        "theta": float(config["rope_theta"]),
        "qkv_bias": bool(config.get("attention_bias", False)),
        "tie": bool(config.get("tie_word_embeddings", False)),
        "ff": 0 if experts else int(config["intermediate_size"]),
        "experts": experts,
        "top_k": int(config.get("num_experts_per_tok", 0)),
        "expert_ff": int(config.get("moe_intermediate_size",
                                    config.get("intermediate_size", 0)))
        if experts else 0,
        "shared_ff": int(config.get("shared_expert_intermediate_size", 0)),
    }


def draft_spec(config: dict) -> Optional[Dict[str, object]]:
    """The drafter's sizes: a dense model (``kind`` "model") in the
    target's spec layout, or an EAGLE head's block (``kind`` "eagle":
    heads, KV heads, head size and FFN width at the target's width)."""
    d = config.get("draft")
    if d is None:
        return None
    if d["kind"] == "eagle":
        return {"kind": "eagle", "heads": int(d["num_attention_heads"]),
                "kv_heads": int(d["num_key_value_heads"]),
                "head_dim": int(d["head_dim"]),
                "ff": int(d["intermediate_size"]),
                "layers": int(d["num_hidden_layers"])}
    return dict(target_spec(d), kind="model")


def active_params(spec: dict) -> int:
    """Parameters a token multiplies: attention projections, the router,
    its ``top_k`` experts and the shared expert (or the dense FFN) of every
    layer, and the head; the embedding lookup multiplies nothing."""
    d, D = spec["d"], spec["head_dim"]
    attn = d * D * (2 * spec["heads"] + 2 * spec["kv_heads"])
    if spec["experts"]:
        ffn = (d * spec["experts"] + 3 * d * spec["expert_ff"] * spec["top_k"]
               + 3 * d * spec["shared_ff"])
    else:
        ffn = 3 * d * spec["ff"]
    return spec["layers"] * (attn + ffn) + d * spec["vocab"]
