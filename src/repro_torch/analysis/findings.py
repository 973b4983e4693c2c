"""Finding model, inline waivers and the ratchet baseline.

Port of ``repro.analysis.findings`` with the port's codes.  Every pass
emits ``Finding``s; the driver (``__main__``) renders them as
``path:line: CODE message``, drops the ones the repo has accepted, and
fails on the rest.

Two acceptance mechanisms, as in the reference:

* **Inline waiver**: a ``# lint: allow[CODE] reason`` comment on (or one
  line above) the flagged line, for findings that are *intended
  behaviour* (a launch counter bumped at capture and credited by
  ``RoundGraphs`` on every replay; the engine's trace-log appends that
  tests assert on).  The reason is mandatory: a waiver without one is
  itself a finding (``W001``).
* **Ratchet baseline**: ``scripts/lint_torch_baseline.txt``, a list of
  ``path:CODE:fingerprint`` entries for legacy debt.  It only shrinks: a
  finding not in it fails, and an entry whose finding is gone is
  reported stale.  Fingerprints hash the message, not the line, so edits
  above a baselined site do not churn the file.
"""
from __future__ import annotations

import hashlib
import json
import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Tuple

#: code -> one-line description (docs/analysis_torch.md lists each; a test
#: holds the two together)
CODES: Dict[str, str] = {
    # capture safety (capture_lint.py)
    "T101": "Python `if` on a device tensor inside a captured stage",
    "T102": "Python `while` on a device tensor inside a captured stage",
    "T103": "int()/float()/bool() of a device tensor inside a captured "
            "stage",
    "T104": "host sync of a device tensor inside a captured stage "
            "(.item()/.tolist()/.cpu()/.numpy()/np.asarray)",
    "T105": "f-string/str.format/print of a device tensor inside a "
            "captured stage",
    "T106": "mutation of host state inside a captured stage (runs at "
            "capture, never on replay)",
    "T107": "assert on a device tensor inside a captured stage",
    "T108": "range() bound by a device tensor inside a captured stage",
    # graph-key audit (graph_keys.py)
    "K201": "round key misses a parameter of the stage builder",
    "K202": "builder parameter shapes or branches a captured stage but is "
            "not in the key",
    "K204": "stage closure reads a builder-scope value or self attribute "
            "not derived from the key",
    "K205": "cache .get() key and store key differ",
    # ctypes launch contracts (launch_lint.py)
    "P302": "argtypes count != the extern \"C\" parameter count",
    "P306": "argtypes position of another kind than the C parameter",
    "P307": "restype differs from the C return type, or a non-int return "
            "has no restype",
    "P308": "call passes another number of arguments than the symbol takes",
    "P309": "symbol exported by no extern \"C\" declaration of its library",
    # collective and host-boundary contracts (collective_lint.py)
    "S401": "torch.distributed collective without an explicit group=",
    "S403": "host data becomes a tensor inside a captured stage",
    "S404": "paged cache leaf not covered by an explicit cache_spec rule",
    "S405": "process-global default device/dtype set outside the launchers",
    "S406": "torch.distributed collective issued outside "
            "distributed/collectives.py",
    # generator hygiene (generator_lint.py)
    "R502": "torch.Generator created or seeded and never drawn from",
    "R503": "captured stage draws from a generator not registered with its "
            "graph",
    "R504": "manual_seed with a loop-invariant seed inside a loop",
    "R505": "random draw without generator= (the global RNG)",
    # in-place reuse (inplace_lint.py)
    "D601": "alias read after an in-place write into the buffer it aliases",
    # waiver hygiene
    "W001": "lint waiver without a reason",
}

#: code prefix -> pass name: the ``--json`` per-pass accounting and the
#: sections of docs/analysis_torch.md.  W001 belongs to the waivers.
PASSES: Dict[str, str] = {
    "T1": "capture_lint",
    "K2": "graph_keys",
    "P3": "launch_lint",
    "S4": "collective_lint",
    "R5": "generator_lint",
    "D6": "inplace_lint",
    "W0": "waivers",
}


def pass_of(code: str) -> str:
    """Name of the analysis pass that owns a finding code."""
    return PASSES.get(code[:2], "unknown")


_WAIVER_RE = re.compile(r"#\s*lint:\s*allow\[([A-Z]\d{3}(?:,\s*[A-Z]\d{3})*)\]"
                        r"\s*(.*)")


@dataclass(frozen=True)
class Finding:
    """One analyzer result, anchored to a source location.

    ``path`` is repo-relative, ``line`` 1-indexed, ``code`` one of
    :data:`CODES`.  ``fingerprint`` (path + code + message, line-free) is
    what the baseline stores, so baselined findings survive edits that
    shift line numbers.
    """
    path: str
    line: int
    code: str
    message: str

    def __post_init__(self):
        if self.code not in CODES:
            raise ValueError(f"unknown finding code {self.code}")

    @property
    def fingerprint(self) -> str:
        h = hashlib.sha256(
            f"{self.path}:{self.code}:{self.message}".encode()).hexdigest()
        return h[:12]

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.code} {self.message}"

    def as_json(self) -> dict:
        return {"path": self.path, "line": self.line, "code": self.code,
                "message": self.message, "fingerprint": self.fingerprint}


def parse_waivers(source: str) -> Dict[int, Tuple[Tuple[str, ...], str]]:
    """Map line number -> (waived codes, reason) for ``# lint: allow[...]``
    comments.  A waiver covers its own line and the line below it (so it
    can sit above a long statement)."""
    out: Dict[int, Tuple[Tuple[str, ...], str]] = {}
    for i, text in enumerate(source.splitlines(), start=1):
        m = _WAIVER_RE.search(text)
        if m:
            codes = tuple(c.strip() for c in m.group(1).split(","))
            out[i] = (codes, m.group(2).strip())
    return out


def apply_waivers(findings: Iterable[Finding],
                  waivers_by_path: Dict[str, Dict[int, Tuple[Tuple[str, ...],
                                                             str]]]
                  ) -> List[Finding]:
    """Drop findings covered by an inline waiver; emit W001 for waivers
    that carry no reason."""
    kept: List[Finding] = []
    for f in findings:
        waivers = waivers_by_path.get(f.path, {})
        hit = None
        for ln in (f.line, f.line - 1):
            w = waivers.get(ln)
            if w and f.code in w[0]:
                hit = (ln, w)
                break
        if hit is None:
            kept.append(f)
        elif not hit[1][1]:
            kept.append(Finding(f.path, hit[0], "W001",
                                f"waiver for {f.code} has no reason"))
    return kept


# ------------------------------------------------------------------ baseline
BASELINE_HEADER = (
    "# Ratchet baseline for `python -m repro_torch.analysis`.",
    "# Format: path:CODE:fingerprint — one accepted finding per line.",
    "# Each entry MUST carry a justification comment; entries only ever",
    "# get deleted (fix the finding), never silently added.",
    "",
)


def load_baseline(path: str) -> Dict[str, str]:
    """Parse a baseline file: ``path:CODE:fingerprint`` per line; ``#``
    comments (the justifications) and blanks skipped.  Returns
    fingerprint -> entry line (for stale reporting)."""
    entries: Dict[str, str] = {}
    try:
        with open(path) as fh:
            for raw in fh:
                line = raw.strip()
                if not line or line.startswith("#"):
                    continue
                parts = line.rsplit(":", 2)
                if len(parts) != 3:
                    raise ValueError(f"malformed baseline entry: {line!r}")
                entries[parts[2]] = line
    except FileNotFoundError:
        pass
    return entries


def write_baseline(path: str, findings: Iterable[Finding]) -> None:
    """Regenerate the baseline from current findings
    (``--update-baseline``); every entry gets a justification slot."""
    lines = list(BASELINE_HEADER)
    for f in sorted(set(findings), key=lambda f: (f.path, f.code, f.line)):
        lines.append(f"# JUSTIFY: {f.message}")
        lines.append(f"{f.path}:{f.code}:{f.fingerprint}")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


@dataclass
class Report:
    """Driver outcome: new findings (fail), baselined ones (pass, counted)
    and stale baseline entries (pass, reported)."""
    new: List[Finding] = field(default_factory=list)
    baselined: List[Finding] = field(default_factory=list)
    stale: List[str] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.new

    def render(self) -> str:
        out = [f.render() for f in self.new]
        if self.stale:
            out.append("stale baseline entries (fixed — delete them):")
            out.extend(f"  {e}" for e in self.stale)
        out.append(f"{len(self.new)} new finding(s), "
                   f"{len(self.baselined)} baselined, "
                   f"{len(self.stale)} stale baseline entr(ies)")
        return "\n".join(out)

    def per_pass(self) -> Dict[str, int]:
        """Finding counts (new + baselined) keyed by owning pass, every
        pass present, zero or not."""
        counts = {name: 0 for name in PASSES.values()}
        for f in list(self.new) + list(self.baselined):
            counts[pass_of(f.code)] = counts.get(pass_of(f.code), 0) + 1
        return counts

    def as_json(self) -> str:
        return json.dumps({
            "ok": self.ok,
            "new": [f.as_json() for f in self.new],
            "baselined": [f.as_json() for f in self.baselined],
            "stale_baseline": list(self.stale),
            "per_pass": self.per_pass(),
        }, indent=2)


def ratchet(findings: Iterable[Finding],
            baseline: Dict[str, str]) -> Report:
    """Split findings by baseline membership and spot stale entries."""
    rep = Report()
    seen: set = set()
    for f in findings:
        if f.fingerprint in baseline:
            rep.baselined.append(f)
            seen.add(f.fingerprint)
        else:
            rep.new.append(f)
    rep.stale = [entry for fp, entry in baseline.items() if fp not in seen]
    rep.new.sort(key=lambda f: (f.path, f.line, f.code))
    return rep
