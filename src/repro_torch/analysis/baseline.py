"""Baseline (ratchet) file handling.

``analysis_baseline_torch.json`` at the repo root carries the port's
findings the team has consciously accepted, each with a one-line
justification. The contract is a two-sided ratchet:

  * a finding whose key is NOT in the baseline fails the run (new debt
    must be fixed or explicitly accepted), and
  * a baseline entry whose finding no longer fires ALSO fails the run
    (stale suppressions must be deleted, so the file never accretes dead
    exemptions that could mask a future regression under the same key).

An entry whose justification is empty or still the ``TODO`` marker that
``write`` leaves is refused when the file loads.

Distinct from the in-code seam allowlist (rules.ALLOWLIST): allowlisted
seams are *correct by design* and never surface as findings; baseline
entries are *known debt* that still prints in every run's summary.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

from .findings import Finding

BASELINE_NAME = "analysis_baseline_torch.json"
TODO = "TODO: justify or fix"


@dataclass(frozen=True)
class BaselineEntry:
    key: str
    justification: str


def load(path: str | Path) -> list[BaselineEntry]:
    p = Path(path)
    if not p.exists():
        return []
    data = json.loads(p.read_text())
    entries = []
    for raw in data.get("entries", []):
        just = str(raw.get("justification", "")).strip()
        if not just or just.upper().startswith("TODO"):
            raise ValueError(
                f"{p}: baseline entry {raw.get('key')!r} has no justification "
                "— every accepted finding must say why"
            )
        entries.append(BaselineEntry(key=str(raw["key"]), justification=just))
    return entries


def write(path: str | Path, findings: list[Finding]) -> None:
    """Seed/refresh the baseline from a sweep. Justifications carried over
    from an existing file are preserved; new entries get a TODO marker that
    ``load`` rejects until a human fills it in."""
    p = Path(path)
    known = {}
    if p.exists():
        known = {e.key: e.justification for e in load(p)}
    entries = [
        {"key": key, "justification": known.get(key, TODO)}
        for key in sorted({f.key for f in findings})
    ]
    p.write_text(json.dumps({"version": 1, "entries": entries}, indent=2) + "\n")


def compare(
    findings: list[Finding], entries: list[BaselineEntry]
) -> tuple[list[Finding], list[BaselineEntry], list[Finding]]:
    """Split a sweep against the baseline.

    Returns (new, stale, accepted): findings not covered by the baseline,
    baseline entries that no longer fire, and findings suppressed by a
    baseline entry. Duplicate keys (one rule firing twice at one seam) are
    covered by a single entry.
    """
    fired = {f.key for f in findings}
    covered = {e.key for e in entries}
    new = [f for f in findings if f.key not in covered]
    stale = [e for e in entries if e.key not in fired]
    accepted = [f for f in findings if f.key in covered]
    return new, stale, accepted
