"""Cells of the benchmark cut to a CPU test's size: the real traffic mixes
and configurations with their widths, depth and lengths made tiny, so the
harness runs end to end through the port's plain CPU paths."""
from __future__ import annotations

import copy
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from perfbench.harness import cells  # noqa: E402

# the width sets the logits' spread (0.02 sqrt(d)): wide enough that a
# wrong token reads a gap of the full-size cells' order
TINY_TARGET = {"hidden_size": 1024, "num_hidden_layers": 2,
               "num_attention_heads": 4, "num_key_value_heads": 2,
               "head_dim": 16, "vocab_size": 512}
TINY_MOE = {"moe_intermediate_size": 32, "shared_expert_intermediate_size": 64,
            "num_experts": 4, "num_experts_per_tok": 2}
TINY_MIXTRAL = {"intermediate_size": 48, "num_local_experts": 4,
                "num_experts_per_tok": 2}
TINY_DRAFT = {"hidden_size": 32, "num_hidden_layers": 2,
              "num_attention_heads": 2, "num_key_value_heads": 1,
              "head_dim": 16, "intermediate_size": 64, "vocab_size": 512}
# the program derives an EAGLE head of max(4, H/4) heads over max(2, Hkv/4)
# of 64 and an FFN of 4 d
TINY_EAGLE = {"num_attention_heads": 4, "num_key_value_heads": 2,
              "head_dim": 64, "intermediate_size": 4096}
TINY_TRAFFIC = {
    "wave": {"requests": 4, "strata": 4, "max_batch": 4,
             "prompt": {"dist": "lognormal", "median": 8, "sigma": 0.6,
                        "min": 4, "max": 16},
             "output": {"dist": "fixed", "value": 6}, "timed_warm_tokens": 3},
    "continuous": {"requests": 8, "strata": 4, "max_batch": 4,
                   "page_size": 8,
                   "prompt": {"dist": "lognormal", "median": 24, "sigma": 0.5,
                              "min": 12, "max": 48},
                   "output": {"dist": "lognormal", "median": 6, "sigma": 0.6,
                              "min": 2, "max": 12}},
}


def tiny(name: str, dtype: str = "float32") -> cells.Cell:
    """The cell ``name`` at test size, in ``dtype``."""
    cell = cells.resolve(name)
    cfg = copy.deepcopy(cell.config)
    cfg.update(TINY_TARGET)
    cfg.update(TINY_MOE if "num_experts" in cfg else TINY_MIXTRAL)
    cfg["torch_dtype"] = dtype
    d = cfg.get("draft")
    if d is not None:
        d.update(TINY_DRAFT if d["kind"] == "model" else TINY_EAGLE)
    cell.config = cfg
    cell.traffic = dict(cell.traffic,
                        **TINY_TRAFFIC[cell.traffic["scheduler"]])
    return cell
