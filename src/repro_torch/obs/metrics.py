"""Labeled metrics: counters, gauges, histograms, Prometheus exposition
(a copy of ``src/repro/obs/metrics.py``: the same names, labels and text).

A :class:`MetricsRegistry` is a process-local map from metric name to a
family of labeled series. The per-level stats dicts stay the engines'
return contract; :func:`record_level_stats` is the one definition that
folds them into the registry, called from one dispatch seam in the port,
``engines.run_level`` (the reference has a second, its sharded engine,
which the port does not have yet). Tests hold the dict counts, the
registry totals and the reference's registry to each other.

Series are keyed by sorted ``(label, value)`` tuples; ``expose()``
renders the whole registry in the Prometheus text format served by
``launch/pc_serve.py --metrics-port``.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager

from .config import enabled

# Canonical metric names (the single shared definition of each counter).
DISPATCHES = "pc_dispatches_total"          # compiled-program launches
CHUNKS = "pc_chunks_total"                  # rank chunks planned
COL_GATHERS = "pc_col_gathers_total"        # C[:, cols] all-gather collectives
COL_GATHER_BYTES = "pc_col_gather_bytes_total"
LEVELS = "pc_levels_total"                  # levels executed
TESTS_TOTAL = "pc_ci_sets_total"            # candidate (edge, sepset) pairs


def _lkey(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _Series:
    __slots__ = ("kind", "value", "buckets", "sum", "count")

    def __init__(self, kind: str, bounds=None):
        self.kind = kind
        self.value = 0.0
        if kind == "histogram":
            self.buckets = [[b, 0] for b in (bounds or DEFAULT_BUCKETS)]
            self.sum = 0.0
            self.count = 0


DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 30.0)


class MetricsRegistry:
    """Thread-safe registry of labeled counter/gauge/histogram series."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, dict[tuple, _Series]] = {}
        self._kinds: dict[str, str] = {}

    def _series(self, name: str, kind: str, labels: dict, bounds=None) -> _Series:
        prev = self._kinds.setdefault(name, kind)
        if prev != kind:
            raise TypeError(f"metric {name!r} is a {prev}, not a {kind}")
        fam = self._metrics.setdefault(name, {})
        key = _lkey(labels)
        s = fam.get(key)
        if s is None:
            s = fam[key] = _Series(kind, bounds)
        return s

    # -- write side ----------------------------------------------------------
    def inc(self, name: str, amount: float = 1.0, **labels):
        with self._lock:
            self._series(name, "counter", labels).value += amount

    def set_gauge(self, name: str, value: float, **labels):
        with self._lock:
            self._series(name, "gauge", labels).value = float(value)

    def observe(self, name: str, value: float, bounds=None, **labels):
        with self._lock:
            s = self._series(name, "histogram", labels, bounds)
            s.sum += value
            s.count += 1
            for b in s.buckets:
                if value <= b[0]:
                    b[1] += 1

    # -- read side -----------------------------------------------------------
    def value(self, name: str, **labels) -> float:
        """Value of one labeled series (0.0 if never written)."""
        with self._lock:
            s = self._metrics.get(name, {}).get(_lkey(labels))
            return 0.0 if s is None else s.value

    def total(self, name: str, **labels) -> float:
        """Sum across series whose labels are a superset of ``labels``."""
        want = dict((str(k), str(v)) for k, v in labels.items())
        out = 0.0
        with self._lock:
            for key, s in self._metrics.get(name, {}).items():
                kv = dict(key)
                if all(kv.get(k) == v for k, v in want.items()):
                    out += s.sum if s.kind == "histogram" else s.value
        return out

    def collect(self) -> dict:
        """Plain-dict snapshot (JSON-friendly; used by journals and tests)."""
        out = {}
        with self._lock:
            for name, fam in sorted(self._metrics.items()):
                series = []
                for key, s in sorted(fam.items()):
                    rec = {"labels": dict(key)}
                    if s.kind == "histogram":
                        rec.update(sum=s.sum, count=s.count,
                                   buckets=[list(b) for b in s.buckets])
                    else:
                        rec["value"] = s.value
                    series.append(rec)
                out[name] = {"kind": self._kinds[name], "series": series}
        return out

    def expose(self) -> str:
        """Prometheus text exposition format (v0.0.4)."""
        lines = []
        for name, fam in self.collect().items():
            lines.append(f"# TYPE {name} {fam['kind']}")
            for s in fam["series"]:
                lab = ",".join(f'{k}="{v}"' for k, v in sorted(s["labels"].items()))
                body = f"{{{lab}}}" if lab else ""
                if fam["kind"] == "histogram":
                    for bound, cnt in s["buckets"]:
                        blab = lab + ("," if lab else "") + f'le="{bound}"'
                        lines.append(f"{name}_bucket{{{blab}}} {cnt}")
                    inf = lab + ("," if lab else "") + 'le="+Inf"'
                    lines.append(f"{name}_bucket{{{inf}}} {s['count']}")
                    lines.append(f"{name}_sum{body} {s['sum']}")
                    lines.append(f"{name}_count{body} {s['count']}")
                else:
                    lines.append(f"{name}{body} {s['value']}")
        return "\n".join(lines) + "\n"

    def reset(self):
        with self._lock:
            self._metrics.clear()
            self._kinds.clear()


_GLOBAL = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _GLOBAL


@contextmanager
def scoped_registry():
    """Swap in a fresh global registry for the duration of a block (tests)."""
    global _GLOBAL
    prev = _GLOBAL
    _GLOBAL = MetricsRegistry()
    try:
        yield _GLOBAL
    finally:
        _GLOBAL = prev


def record_level_stats(stats: dict, *, level: int, layout: str = "single",
                       registry: MetricsRegistry | None = None):
    """Fold one level's stats dict into the registry — the single shared
    definition of the dispatch/gather counters. Called from one seam
    only (engines.run_level), so wrapped code paths never double-count.
    No-op unless obs is enabled or an explicit registry is passed."""
    if registry is None:
        if not enabled():
            return
        registry = _GLOBAL
    eng = str(stats.get("engine", "?"))
    lab = {"engine": eng, "level": level, "layout": layout}
    registry.inc(LEVELS, 1, **lab)
    registry.inc(DISPATCHES, int(stats.get("dispatches", 0)), **lab)
    registry.inc(CHUNKS, int(stats.get("chunks", 0)), **lab)
    registry.inc(TESTS_TOTAL, int(stats.get("total_sets", 0)), **lab)
    if "col_gathers" in stats:
        registry.inc(COL_GATHERS, int(stats["col_gathers"]), **lab)
        registry.inc(COL_GATHER_BYTES, int(stats.get("col_gather_bytes", 0)),
                     **lab)
