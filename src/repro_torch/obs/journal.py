"""Structured JSONL run journals (a copy of ``src/repro/obs/journal.py``;
stdlib only, so the port's journals are byte-equal to the reference's).

A :class:`Journal` appends one JSON object per line to a file; every
record carries ``schema`` (version), ``kind`` (``span`` / ``metric`` /
``run`` / ``serve``) and a clock timestamp. Keys are sorted, so a run on
a :class:`~repro_torch.obs.trace.ManualClock` is byte-deterministic — the
journal round-trip and determinism tests rely on this.

Record kinds:

* ``span`` — one finished trace span: name, slash path, depth, t0/t1,
  dur_s, free-form attrs (level stats, chunk counts, error type, ...).
* ``metric`` — a registry snapshot (``MetricsRegistry.collect()``).
* ``run`` — one per run: the final ``timings_s`` view + attrs.
* ``serve`` — one per serving event (delivery, deadline miss, retry,
  dead letter) with the per-request latency breakdown.

``read_journal(path)`` parses the file back into a list of dicts.
"""
from __future__ import annotations

import json
import os

SCHEMA_VERSION = 1


class Journal:
    """Append-only JSONL writer. The file opens lazily on first record, so
    constructing a Journal that never fires leaves no file behind (the
    zero-overhead contract for disabled paths that still build one)."""

    def __init__(self, path: str):
        self.path = str(path)
        self._fh = None

    def record(self, kind: str, **fields):
        rec = {"schema": SCHEMA_VERSION, "kind": kind}
        rec.update(fields)
        if self._fh is None:
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            self._fh = open(self.path, "a", encoding="utf-8")
        self._fh.write(json.dumps(rec, sort_keys=True, default=str) + "\n")
        self._fh.flush()

    def span(self, sp):
        self.record("span", name=sp.name, path=sp.path, depth=sp.depth,
                    t0=sp.t0, t1=sp.t1, dur_s=sp.dur_s, attrs=sp.attrs)

    def metrics(self, registry, ts: float | None = None):
        self.record("metric", ts=ts, metrics=registry.collect())

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def read_journal(path: str) -> list[dict]:
    out = []
    with open(path, encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def phase_summary(records: list[dict], *, depth: int | None = None) -> dict:
    """Aggregate span records into ``{span_name: total_dur_s}`` — the view
    ``benchmarks/check_regression.py`` uses to localize a regression to a
    phase. ``depth`` filters to one nesting level (None = all)."""
    out: dict[str, float] = {}
    for rec in records:
        if rec.get("kind") != "span" or rec.get("dur_s") is None:
            continue
        if depth is not None and rec.get("depth") != depth:
            continue
        name = rec["name"]
        out[name] = out.get(name, 0.0) + float(rec["dur_s"])
    return out
