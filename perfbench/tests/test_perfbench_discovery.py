"""A configuration, a traffic mix, a cell and a per-layer metric are added
as new files and manifest entries alone: the harness finds each by name,
and no existing file changes."""
from __future__ import annotations

import hashlib
import json
import shutil

import perfbench_cpu_cells  # noqa: F401
from perfbench.harness import cells, traffic

ROOT = cells.ROOT


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "perfbench").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_new_files_and_entries_are_found(tmp_path):
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digests(tmp_path)
    manifest = json.loads((tmp_path / "BENCHMARK.json").read_text())
    # a new configuration: an existing one's file under a new name
    cfg = json.loads((tmp_path / manifest["configs"][0]["file"]).read_text())
    cfg["name"] = "new-config"
    (tmp_path / "perfbench/configs/new-config.json").write_text(
        json.dumps(cfg))
    manifest["configs"].append(dict(manifest["configs"][0],
                                    name="new-config",
                                    file="perfbench/configs/new-config.json"))
    # a new traffic mix: data only
    mix = dict(json.loads((tmp_path / "perfbench/traffic/wave-b32-ar.json")
                          .read_text()), max_batch=8, requests=8, strata=8)
    (tmp_path / "perfbench/traffic/new-mix.json").write_text(json.dumps(mix))
    # a new per-layer metric: its own reader
    (tmp_path / "perfbench/metrics/new_metric.py").write_text(
        'UNIT = "count"\nLAYER = "scheduler"\nMOVES = "tokens_per_s"\n'
        'SOURCE = "program_counter"\n\n\ndef read(ctx):\n'
        '    return len(ctx.window_requests)\n')
    manifest["per_layer"].append({
        "name": "new_metric", "unit": "count", "better": "higher",
        "source": "program_counter", "layer": "scheduler",
        "moves": "tokens_per_s", "workloads": ["new-cell"]})
    manifest["workloads"].append({"name": "new-cell", "config": "new-config",
                                  "traffic": "new-mix", "chips": 1,
                                  "why": "a test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))

    cell = cells.resolve("new-cell", root=tmp_path)
    assert cell.config["name"] == "new-config"
    assert cell.traffic["max_batch"] == 8
    assert [m["name"] for m in cell.per_layer if m["name"] == "new_metric"]
    reader = cells.metric_reader("new_metric", root=tmp_path)

    class Ctx:
        window_requests = [1, 2, 3]
    assert reader.read(Ctx()) == 3
    assert len(traffic.unit(cell.traffic, 5, 0, 1000)) == 8
    # nothing that was there changed
    after = _digests(tmp_path)
    assert {k: v for k, v in after.items() if k in before} == before
    # the old cells resolve as before
    for w in manifest["workloads"][:-1]:
        old = cells.resolve(w["name"], root=tmp_path)
        assert "new_metric" not in [m["name"] for m in old.per_layer]
