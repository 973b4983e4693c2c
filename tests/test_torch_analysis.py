"""The port's static analyzer (``repro_torch.analysis``): parity of its
infrastructure with ``repro.analysis``, each pass on its fixture and on a
mutant of a real port file, waivers, the ratchet, the CLI, the docs, and
the port's own tree held clean.
"""
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import repro.analysis._astutil as ref_astutil
import repro.analysis.findings as ref
import repro_torch.analysis._astutil as port_astutil
import repro_torch.analysis.findings as port
from repro_torch.analysis import CODES, analyze_paths
from repro_torch.analysis.__main__ import default_paths, main
from repro_torch.analysis.findings import (Finding, apply_waivers,
                                           load_baseline, parse_waivers,
                                           ratchet, write_baseline)

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
FIX = os.path.join(HERE, "fixtures", "lint_torch")
PORT = os.path.join(REPO, "src", "repro_torch")
SHARED_CODES = sorted(set(ref.CODES) & set(port.CODES))


def _run(name):
    return analyze_paths([os.path.join(FIX, name)], repo_root=REPO)


def _codes_lines(findings):
    return {(f.code, f.line) for f in findings}


# ------------------------------------------------ parity with the reference
def _random_source(rng, n_lines):
    lines = []
    for i in range(n_lines):
        r = rng.random()
        codes = ",".join(rng.choice(SHARED_CODES,
                                    size=int(rng.integers(1, 3))))
        if r < 0.2:
            lines.append(f"x{i} = {i}  # lint: allow[{codes}] reason {i}")
        elif r < 0.3:
            lines.append(f"x{i} = {i}  # lint: allow[{codes}]")
        elif r < 0.35:
            lines.append(f"# lint:allow[{codes.replace(',', ', ')}]   spaced")
        else:
            lines.append(f"y{i} = x{max(i - 1, 0)} + 1")
    return "\n".join(lines) + "\n"


def _random_findings(rng, n, paths, n_lines):
    return [(str(rng.choice(paths)), int(rng.integers(1, n_lines + 1)),
             str(rng.choice(SHARED_CODES)), f"message {int(rng.integers(4))}")
            for _ in range(n)]


def _tuples(findings):
    return [(f.path, f.line, f.code, f.message) for f in findings]


@pytest.mark.parametrize("seed", range(6))
def test_waivers_and_ratchet_match_reference(seed, tmp_path):
    rng = np.random.default_rng(seed)
    paths = ["a.py", "pkg/b.py", "c.py"]
    n_lines = 40
    sources = {p: _random_source(rng, n_lines) for p in paths}
    waivers_ref = {p: ref.parse_waivers(s) for p, s in sources.items()}
    waivers_port = {p: port.parse_waivers(s) for p, s in sources.items()}
    assert waivers_port == waivers_ref
    raw = _random_findings(rng, 60, paths, n_lines)
    f_ref = [ref.Finding(*t) for t in raw]
    f_port = [port.Finding(*t) for t in raw]
    kept_ref = ref.apply_waivers(f_ref, waivers_ref)
    kept_port = port.apply_waivers(f_port, waivers_port)
    assert _tuples(kept_port) == _tuples(kept_ref)
    # the ratchet against a random half as the baseline
    half = [f for f in kept_ref if rng.random() < 0.5]
    base_ref, base_port = (str(tmp_path / "ref.txt"),
                           str(tmp_path / "port.txt"))
    ref.write_baseline(base_ref, half)
    port.write_baseline(base_port, [port.Finding(*t)
                                    for t in _tuples(half)])
    text_ref = open(base_ref).read()
    text_port = open(base_port).read()
    # the first line names each package's own command; the rest is equal
    assert text_port.split("\n", 1)[1] == text_ref.split("\n", 1)[1]
    assert "repro_torch.analysis" in text_port.split("\n", 1)[0]
    later = [t for t in _tuples(kept_ref) if rng.random() < 0.7]
    rep_ref = ref.ratchet([ref.Finding(*t) for t in later],
                          ref.load_baseline(base_ref))
    rep_port = port.ratchet([port.Finding(*t) for t in later],
                            port.load_baseline(base_port))
    assert _tuples(rep_port.new) == _tuples(rep_ref.new)
    assert _tuples(rep_port.baselined) == _tuples(rep_ref.baselined)
    assert sorted(rep_port.stale) == sorted(rep_ref.stale)
    assert rep_port.ok == rep_ref.ok


@pytest.mark.parametrize("seed", range(4))
def test_fingerprints_match_reference_under_line_drift(seed):
    rng = np.random.default_rng(100 + seed)
    for path, line, code, msg in _random_findings(rng, 30, ["a.py", "b.py"],
                                                  500):
        drift = int(rng.integers(1, 50))
        fp = port.Finding(path, line, code, msg).fingerprint
        assert fp == ref.Finding(path, line, code, msg).fingerprint
        assert fp == port.Finding(path, line + drift, code, msg).fingerprint


def test_project_finds_the_same_modules_as_reference():
    roots = [FIX, os.path.join(HERE, "fixtures", "lint"),
             os.path.join(PORT, "analysis"), os.path.join(PORT, "core")]
    got = port_astutil.Project(roots, REPO)
    want = ref_astutil.Project(roots, REPO)
    assert sorted(got.modules) == sorted(want.modules)
    for rel, mod in want.modules.items():
        assert sorted(got.modules[rel].functions) == sorted(mod.functions)
        assert got.modules[rel].imports == mod.imports


# ----------------------------------------------------------------- fixtures
def test_capture_fixture_codes_and_lines():
    assert _codes_lines(_run("capture_bad.py")) == {
        ("T101", 17), ("T102", 19), ("T103", 21), ("T104", 22),
        ("T105", 23), ("T107", 24), ("T108", 25), ("T106", 27),
        ("T106", 28), ("S403", 29), ("T104", 40)}


def test_graph_key_fixture_codes_and_lines():
    assert _codes_lines(_run("graph_key_bad.py")) == {
        ("K202", 19), ("K204", 20), ("K205", 27), ("K201", 28)}


def test_launch_fixture_codes_and_lines():
    assert _codes_lines(_run("launch_bad.py")) == {
        ("P302", 13), ("P306", 14), ("P307", 15), ("P307", 17),
        ("P308", 23), ("P309", 24)}


def test_collective_fixture_codes_and_lines():
    assert _codes_lines(_run("collective_bad.py")) == {
        ("S401", 18), ("S406", 18), ("S404", 23), ("S404", 27),
        ("S405", 31), ("S403", 38)}


def test_generator_fixture_codes_and_lines():
    assert _codes_lines(_run("generator_bad.py")) == {
        ("R505", 8), ("R505", 9), ("R502", 10), ("R504", 17),
        ("R503", 24), ("R503", 34)}


def test_inplace_fixture_codes_and_lines():
    assert _codes_lines(_run("inplace_bad.py")) == {
        ("D601", 13), ("D601", 19), ("D601", 25)}


def test_clean_fixture_has_no_findings():
    assert _run("clean.py") == []


# ------------------------------------------------- mutants of the real tree
def _mutate(tmp_path, rel, old, new, extra=()):
    """Copy ``src/repro_torch/<rel>`` (and ``extra`` beside it) into
    ``tmp_path``, replace ``old`` by ``new`` once, and return the copy's
    path and the 1-based line where ``new`` starts."""
    src = os.path.join(PORT, rel)
    dst = tmp_path / os.path.basename(rel)
    for e in extra:
        target = tmp_path / e
        target.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(os.path.join(os.path.dirname(src), e), target)
    text = open(src).read()
    assert text.count(old) == 1, old
    start = text.index(old)
    dst.write_text(text.replace(old, new))
    return str(dst), text[:start].count("\n") + 1


def _at(path, tmp_path):
    return analyze_paths([path], repo_root=str(tmp_path))


def test_capture_mutant_item_in_verify_stage(tmp_path):
    old = "            drafts, _, p_work = prev\n"
    path, line = _mutate(tmp_path, "core/spec_decode.py", old,
                         old + "            drafts.item()\n")
    assert _codes_lines(_at(path, tmp_path)) == {("T104", line + 1)}


def test_graph_key_mutant_attribute_outside_key(tmp_path):
    old = "            drafts, _, p_work = prev\n"
    path, line = _mutate(tmp_path, "core/spec_decode.py", old,
                         old + "            drafts = drafts + self.gamma\n")
    found = _codes_lines(_at(path, tmp_path))
    assert ("K204", line + 1) not in found      # gamma is in round_key's
    old2 = "            drafts, _, p_work = prev\n"
    path, line = _mutate(tmp_path, "core/spec_decode.py", old2,
                         old2 + "            drafts = drafts + "
                                "self.sync_guard\n")
    assert ("K204", line + 1) in _codes_lines(_at(path, tmp_path))


def test_graph_key_mutant_memo_stored_under_another_key(tmp_path):
    old = "            io = self._io[key] = StaticIO(B, self.target.device)\n"
    path, line = _mutate(tmp_path, "core/spec_decode.py", old,
                         old.replace("[key]", "[key[1:]]"))
    assert _codes_lines(_at(path, tmp_path)) == {("K205", line)}


def test_launch_mutant_dropped_argtype(tmp_path):
    old = "lib.ragged_launch.argtypes = [i, i, i, p, p, p, p, p, i, i, i, i, p,"
    path, line = _mutate(tmp_path, "kernels/gmm/ragged.py", old,
                         old.replace("[i, i, i, p,", "[i, i, p,"),
                         extra=("csrc/ragged_gmm.cu",))
    found = _codes_lines(_at(path, tmp_path))
    # the argtypes line, and the launch that now passes one more argument
    call = next(i for i, t in enumerate(open(path).read().split("\n"), 1)
                if "_lib().ragged_launch(" in t)
    assert found == {("P302", line), ("P308", call)}


def test_generator_mutant_unregistered_graph(tmp_path):
    old = ("                if generator is not None:\n"
           "                    graph.register_generator_state(generator)\n")
    path, _ = _mutate(tmp_path, "core/graphs.py", old, "")
    text = open(path).read().split("\n")
    line = next(i for i, t in enumerate(text, 1)
                if "with torch.cuda.graph(" in t)
    assert ("R503", line) in _codes_lines(_at(path, tmp_path))


def test_collective_mutant_group_dropped(tmp_path):
    old = "    dist.all_to_all_single(out, inp, group=group)\n"
    path, line = _mutate(tmp_path, "distributed/collectives.py", old,
                         "    dist.all_to_all_single(out, inp)\n")
    assert ("S401", line) in _codes_lines(_at(path, tmp_path))


def test_inplace_mutant_stale_view_in_adopt(tmp_path):
    old = ("            _copy_into((arena.t_cache, arena.p_state, "
           "arena.last_token),\n"
           "                       (t_cache, p_state, last_token))\n")
    new = ("            before = arena.last_token[:1]\n" + old
           + "            print(before)\n")
    path, line = _mutate(tmp_path, "core/spec_decode.py", old, new)
    found = _codes_lines(_at(path, tmp_path))
    assert ("D601", line + 3) in found


# ------------------------------------------------------------ waiver model
def test_waiver_suppresses_only_named_code_nearby():
    src = ("x = 1\n"
           "y = 2  # lint: allow[T103] trusted host boundary\n"
           "z = 3\n")
    waivers = {"m.py": parse_waivers(src)}
    f_hit = Finding("m.py", 2, "T103", "a")
    f_below = Finding("m.py", 3, "T103", "b")
    f_other = Finding("m.py", 2, "T101", "c")
    f_far = Finding("m.py", 1, "T103", "d")
    kept = apply_waivers([f_hit, f_below, f_other, f_far], waivers)
    assert kept == [f_other, f_far]


def test_waiver_without_reason_is_w001():
    waivers = {"m.py": parse_waivers("y = 2  # lint: allow[T103]\n")}
    kept = apply_waivers([Finding("m.py", 1, "T103", "a")], waivers)
    assert [f.code for f in kept] == ["W001"]


# ------------------------------------------------------------------ ratchet
def test_ratchet_roundtrip_and_stale_detection(tmp_path):
    base = str(tmp_path / "baseline.txt")
    old = Finding("a.py", 3, "T101", "legacy branch")
    write_baseline(base, [old])
    entries = load_baseline(base)
    assert old.fingerprint in entries
    moved = Finding("a.py", 99, "T101", "legacy branch")
    fresh = Finding("a.py", 5, "T103", "new coercion")
    rep = ratchet([moved, fresh], entries)
    assert rep.baselined == [moved] and rep.new == [fresh] and not rep.ok
    rep2 = ratchet([fresh], entries)
    assert rep2.stale and not rep2.ok


def test_shipped_baseline_is_empty():
    assert load_baseline(os.path.join(REPO, "scripts",
                                      "lint_torch_baseline.txt")) == {}


def test_baseline_stable_under_line_drift(tmp_path):
    target = str(tmp_path / "generator_bad.py")
    base = str(tmp_path / "b.txt")
    shutil.copy(os.path.join(FIX, "generator_bad.py"), target)
    before = analyze_paths([target], repo_root=str(tmp_path))
    assert before
    write_baseline(base, before)
    with open(target) as fh:
        src = fh.read()
    with open(target, "w") as fh:
        fh.write("# drift\n" * 7 + src)
    after = analyze_paths([target], repo_root=str(tmp_path))
    assert {f.line for f in after} != {f.line for f in before}
    rep = ratchet(after, load_baseline(base))
    assert rep.ok and not rep.new and not rep.stale


# ---------------------------------------------------------------------- CLI
def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    return env


def test_cli_exit_codes_json_and_per_pass():
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis",
         os.path.join(FIX, "collective_bad.py"),
         os.path.join(FIX, "generator_bad.py"),
         os.path.join(FIX, "inplace_bad.py"), "--no-baseline", "--json"],
        capture_output=True, text=True, cwd=REPO, env=_env())
    assert r.returncode == 1, r.stderr
    payload = json.loads(r.stdout)
    assert not payload["ok"]
    assert payload["per_pass"] == {
        "capture_lint": 0, "graph_keys": 0, "launch_lint": 0,
        "collective_lint": 6, "generator_lint": 6, "inplace_lint": 3,
        "waivers": 0}


def test_cli_clean_exit_and_static_passes_import_no_torch_jax_repro():
    code = (
        "import sys\n"
        "from repro_torch.analysis.__main__ import main\n"
        "from repro_torch.analysis import (capture_lint, graph_keys,\n"
        "    launch_lint, collective_lint, generator_lint, inplace_lint)\n"
        f"rc = main([{os.path.join(FIX, 'clean.py')!r}, '--no-baseline'])\n"
        "print('LOADED', sorted(m for m in sys.modules\n"
        "      if m.split('.')[0] in ('torch', 'jax', 'repro')))\n"
        "sys.exit(rc)\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=REPO, env=_env())
    assert r.returncode == 0, r.stdout + r.stderr
    assert "LOADED []" in r.stdout


def test_cli_update_baseline(tmp_path, capsys):
    base = str(tmp_path / "b.txt")
    bad = os.path.join(FIX, "capture_bad.py")
    assert main([bad, "--update-baseline", "--baseline", base]) == 0
    capsys.readouterr()
    assert main([bad, "--baseline", base]) == 0
    assert "0 new finding(s)" in capsys.readouterr().out
    assert main([bad, "--no-baseline"]) == 1


# ----------------------------------------------------------- the port's tree
def test_port_tree_is_clean():
    """The port and its drivers pass their own analyzer against the
    shipped (empty) baseline; what is right on purpose is waived inline
    with its reason."""
    paths = default_paths(REPO)
    assert os.path.join(REPO, "chip_smoke.py") in paths
    findings = analyze_paths(paths, repo_root=REPO)
    report = ratchet(findings, load_baseline(
        os.path.join(REPO, "scripts", "lint_torch_baseline.txt")))
    assert report.ok, report.render()


def test_port_tree_waivers_all_carry_reasons():
    for path in default_paths(REPO):
        files = ([path] if path.endswith(".py") else
                 [os.path.join(d, f) for d, _, fs in os.walk(path)
                  for f in fs if f.endswith(".py")])
        for f in files:
            for line, (codes, reason) in parse_waivers(open(f).read()
                                                       ).items():
                assert reason, f"{f}:{line} waives {codes} without a reason"
                assert all(c in CODES for c in codes), (f, line, codes)


# --------------------------------------------------------------------- docs
def test_docs_list_every_finding_code_and_the_reference_codes():
    with open(os.path.join(REPO, "docs", "analysis_torch.md")) as fh:
        text = fh.read()
    missing = [c for c in CODES if f"`{c}`" not in text]
    assert not missing, f"docs/analysis_torch.md misses codes: {missing}"
    # every one of the reference's codes has its counterpart or its reason
    table = text.split("## The reference's codes", 1)[1]
    rows = {line.split("|")[1].strip().strip("`"): line
            for line in table.splitlines() if line.startswith("| `")}
    assert sorted(rows) == sorted(ref.CODES)
    for code, row in rows.items():
        cells = [c.strip() for c in row.split("|")[2:-1]]
        assert all(cells), row


def test_docs_links_resolve():
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        import check_docs
    finally:
        sys.path.pop(0)
    errors = [e for e in check_docs.check_links() if "analysis_torch" in e
              or "README" in e]
    assert not errors, errors
