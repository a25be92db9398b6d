"""Findings, baselines and the JSON report of the port's analyzer.

The port's twin of ``repro/analysis/report.py``, with its own format
names.  Every check in the three passes emits :class:`Finding` records
with a stable identity ``rule::path::symbol`` (no line numbers — findings
must survive unrelated edits above them).  A committed baseline file
(``analysis_baseline_torch.json``) holds *waivers*: deliberate exceptions,
each carrying a one-line justification.  The analyzer exits non-zero only on
findings NOT covered by a waiver, so the baseline is the reviewed debt
ledger and any new finding is a hard CI failure.

Waiver ``match`` patterns are ``fnmatch`` globs against ``path::symbol``
(e.g. ``tests/test_torch_*.py::*``), which keeps one waiver stable
across refactors that only move lines around.
"""
from __future__ import annotations

import dataclasses
import fnmatch
import json
from typing import Optional

BASELINE_FORMAT = "repro_torch.analysis.baseline"
REPORT_FORMAT = "repro_torch.analysis.report"
VERSION = 1


@dataclasses.dataclass
class Finding:
    """One rule violation at one site.

    ``path`` is repo-relative; ``symbol`` names the function/class/entry
    the finding anchors to (never a line number — see module docstring).
    """

    rule: str
    path: str
    symbol: str
    message: str
    line: int = 0

    @property
    def key(self) -> str:
        return f"{self.rule}::{self.path}::{self.symbol}"

    @property
    def site(self) -> str:
        return f"{self.path}::{self.symbol}"

    def to_dict(self) -> dict:
        return {
            "rule": self.rule,
            "path": self.path,
            "symbol": self.symbol,
            "line": self.line,
            "message": self.message,
        }


@dataclasses.dataclass(frozen=True)
class Waiver:
    """A deliberate, justified exception recorded in the baseline."""

    rule: str
    match: str       # fnmatch glob against "path::symbol"
    reason: str

    def covers(self, f: Finding) -> bool:
        return self.rule == f.rule and fnmatch.fnmatch(f.site, self.match)


def load_baseline(path: Optional[str]) -> list[Waiver]:
    """Load waivers; a missing/None path is an empty baseline."""
    if path is None:
        return []
    try:
        with open(path) as fh:
            data = json.load(fh)
    except FileNotFoundError:
        return []
    if data.get("format") != BASELINE_FORMAT:
        raise ValueError(f"{path} is not a {BASELINE_FORMAT} file")
    waivers = []
    for w in data.get("waivers", []):
        reason = w.get("reason", "").strip()
        if not reason:
            raise ValueError(
                f"baseline waiver {w.get('rule')}::{w.get('match')} has no "
                "justification — every waiver must say why")
        if reason.upper().startswith("TODO"):
            raise ValueError(
                f"baseline waiver {w.get('rule')}::{w.get('match')} has a "
                f"placeholder justification ({reason!r}) — replace the TODO "
                "with the actual reason this finding is acceptable")
        waivers.append(Waiver(rule=w["rule"], match=w["match"],
                              reason=w["reason"]))
    return waivers


def dump_baseline(path: str, waivers: list[Waiver]) -> None:
    with open(path, "w") as fh:
        json.dump({
            "format": BASELINE_FORMAT,
            "version": VERSION,
            "waivers": [dataclasses.asdict(w) for w in waivers],
        }, fh, indent=2)
        fh.write("\n")


@dataclasses.dataclass
class Report:
    """All findings of one analyzer run plus per-pass structured data."""

    findings: list[Finding] = dataclasses.field(default_factory=list)
    # Pass-specific structured payloads (entry-point inventory, pallas
    # program footprints, ...) — the regression-trajectory part of the
    # report, present even when nothing fires.
    info: dict = dataclasses.field(default_factory=dict)
    waivers: list[Waiver] = dataclasses.field(default_factory=list)

    def extend(self, findings: list[Finding]) -> None:
        self.findings.extend(findings)

    def waiver_for(self, f: Finding) -> Optional[Waiver]:
        for w in self.waivers:
            if w.covers(f):
                return w
        return None

    @property
    def new_findings(self) -> list[Finding]:
        return [f for f in self.findings if self.waiver_for(f) is None]

    @property
    def waived_findings(self) -> list[Finding]:
        return [f for f in self.findings if self.waiver_for(f) is not None]

    def unused_waivers(self) -> list[Waiver]:
        return [w for w in self.waivers
                if not any(w.covers(f) for f in self.findings)]

    def to_dict(self) -> dict:
        entries = []
        for f in self.findings:
            w = self.waiver_for(f)
            e = f.to_dict()
            e["waived"] = w is not None
            if w is not None:
                e["waiver_reason"] = w.reason
            entries.append(e)
        return {
            "format": REPORT_FORMAT,
            "version": VERSION,
            "findings": entries,
            "info": self.info,
            "summary": {
                "total": len(self.findings),
                "waived": len(self.waived_findings),
                "new": len(self.new_findings),
                "unused_waivers": [dataclasses.asdict(w)
                                   for w in self.unused_waivers()],
            },
        }

    def dump_json(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump(self.to_dict(), fh, indent=2, default=_json_default)
            fh.write("\n")

    def format_text(self) -> str:
        lines = []
        for f in self.findings:
            w = self.waiver_for(f)
            tag = "waived" if w is not None else "NEW"
            loc = f"{f.path}:{f.line}" if f.line else f.path
            lines.append(f"[{tag}] {f.rule} {loc} ({f.symbol}): {f.message}")
            if w is not None:
                lines.append(f"         waiver: {w.reason}")
        lines.append(
            f"{len(self.findings)} finding(s): "
            f"{len(self.new_findings)} new, "
            f"{len(self.waived_findings)} waived.")
        return "\n".join(lines)


def _json_default(o):
    import numpy as np

    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    return str(o)
