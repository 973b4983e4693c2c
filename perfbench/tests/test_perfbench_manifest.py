"""BENCHMARK.json against the benchmark's contract: names, units, bounds,
the files each entry names, and which cells report what."""
from __future__ import annotations

import json
import re

import pytest

import perfbench_cpu_cells  # noqa: F401  (puts the checkout on sys.path)
from perfbench.harness import cells

ROOT = cells.ROOT
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
# a width: a size (but the vocabulary's), a dim, a rank, an expansion, the
# experts per token
WIDTH = re.compile(r"^(?!vocab_size$).*(_size$|_dim$|_rank$|expan"
                   r"|experts_per_tok|head)")
CELLS = [w["name"] for w in MANIFEST["workloads"]]
PER_LAYER = [m["name"] for m in MANIFEST["per_layer"]]
E2E = {m["name"]: m for m in MANIFEST["end_to_end"]}


def _one_line(text: str, most: int = 200) -> bool:
    return 1 <= len(text) <= most and "\n" not in text and "\t" not in text


def test_top_level_keys_command_and_paths():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    cmd = MANIFEST["command"]
    assert 1 <= len(cmd) <= 32 and all(_one_line(w) for w in cmd)
    assert cmd == ["python3", "perfbench/run.py"]
    assert 1 <= len(MANIFEST["paths"]) <= 16
    for p in MANIFEST["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    assert (ROOT / cmd[1]).is_file()
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_run_seconds_fits_a_full_check_of_24_cells():
    s = MANIFEST["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("entry", MANIFEST["configs"], ids=lambda c: c["name"])
def test_config_entry(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and _one_line(entry["why"])
    assert _one_line(entry["source"]) and entry["source"].startswith("https://")
    assert entry["file"].startswith(tuple(p + "/" for p in MANIFEST["paths"]))
    cfg = json.loads((ROOT / entry["file"]).read_text())
    assert cfg["name"] == entry["name"]
    assert len(entry["reduced"]) <= 16
    assert cfg["reduced"] == entry["reduced"]
    for key in entry["reduced"]:
        assert NAME.match(key) and not WIDTH.search(key), key
        # a reduced key differs from the published value the file states
        assert cfg["published"][key] != cfg[key]
    assert any(w["config"] == entry["name"] for w in MANIFEST["workloads"])
    files = [c["file"] for c in MANIFEST["configs"]]
    assert files.count(entry["file"]) == 1


@pytest.mark.parametrize("cell", CELLS)
def test_cell_entry_and_files(cell):
    w = next(w for w in MANIFEST["workloads"] if w["name"] == cell)
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(w["name"]) and NAME.match(w["traffic"])
    assert w["chips"] == 1 and _one_line(w["why"])
    resolved = cells.resolve(cell)
    assert resolved.traffic["scheduler"] in ("wave", "continuous")
    limits = json.loads((ROOT / "perfbench" / "limits"
                         / f"{cell}.json").read_text())
    assert limits["gap_p90"] > 0
    # a cell that drafts has its drafts judged too
    assert (limits.get("draft_gap_p90", 0) > 0) == bool(
        resolved.traffic["speculate"])
    names = [m["name"] for m in resolved.end_to_end]
    assert "setup_s" in names and len(names) >= 2
    assert resolved.per_layer


def test_pairs_and_names_unique():
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for group in ("configs", "workloads"):
        names = [e["name"] for e in MANIFEST[group]]
        assert len(set(names)) == len(names)
    metrics = list(E2E) + PER_LAYER
    assert len(set(metrics)) == len(metrics)
    assert sum(w["chips"] == 4 for w in MANIFEST["workloads"]) \
        <= max(1, len(CELLS) // 4)


@pytest.mark.parametrize("name", sorted(E2E))
def test_end_to_end_metric(name):
    m = E2E[name]
    assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
    assert NAME.match(name) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert m["source"] in ("host_clock", "device_trace")
    assert 0.01 <= m["bound"] <= 0.25
    for cell in m.get("workloads", []):
        assert cell in CELLS


@pytest.mark.parametrize("name", PER_LAYER)
def test_per_layer_metric_matches_its_reader(name):
    m = next(m for m in MANIFEST["per_layer"] if m["name"] == name)
    assert set(m) <= {"name", "unit", "better", "source", "layer", "moves",
                      "workloads"}
    assert NAME.match(name) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher") and _one_line(m["layer"])
    assert m["source"] in ("device_trace", "program_span", "program_counter",
                           "host_clock")
    reader = cells.metric_reader(name)
    assert (reader.UNIT, reader.LAYER, reader.MOVES, reader.SOURCE) == \
        (m["unit"], m["layer"], m["moves"], m["source"])
    assert m["moves"] in E2E
    # every cell the metric lists reports the end-to-end metric it moves
    for cell in m.get("workloads", CELLS):
        assert cell in CELLS
        assert cells.reports(E2E[m["moves"]], cell)
    if m["unit"] == "%" and ("roofline" in name or "mfu" in name):
        assert m["better"] == "higher"


def test_every_cell_has_a_kernel_roofline_and_the_step_mfu():
    for cell in CELLS:
        names = [m["name"] for m in cells.resolve(cell).per_layer]
        assert "mfu" in names
        assert any(n.endswith("_roofline") for n in names)
