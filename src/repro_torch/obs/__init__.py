"""repro_torch.obs: spans, metrics and journals (the port of
``src/repro/obs``).

* :mod:`~repro_torch.obs.trace`: nestable trace spans with injectable
  clocks, ``sync`` that waits for the card, optional
  ``torch.profiler.record_function`` annotation;
* :mod:`~repro_torch.obs.metrics`: a labeled counter/gauge/histogram
  registry with Prometheus text exposition; ``record_level_stats`` is the
  one definition of the per-level dispatch counters;
* :mod:`~repro_torch.obs.journal`: JSONL run journals, deterministic on a
  virtual clock.

The PC entry points' own tracers are always on (they are ``timings_s``); what
has a side effect beyond a float (journal files, the global registry,
profiler annotation) stays off unless ``obs.configure(enabled=True, ...)``
or ``REPRO_OBS=1`` turns it on. With obs off no file is written and
results are bitwise those of a run with it on.
"""
from __future__ import annotations

from .config import ObsConfig, configure, disable, enable, enabled, get_config, scoped
from .journal import SCHEMA_VERSION, Journal, phase_summary, read_journal
from .metrics import (CHUNKS, COL_GATHER_BYTES, COL_GATHERS, DISPATCHES, LEVELS, TESTS_TOTAL,
                      MetricsRegistry, get_registry, record_level_stats, scoped_registry)
from .trace import NULL_CTX, NULL_SPAN, ManualClock, MonotonicClock, Span, Tracer

__all__ = [
    "ObsConfig", "configure", "enable", "disable", "enabled", "get_config",
    "scoped", "Journal", "read_journal", "phase_summary", "SCHEMA_VERSION",
    "MetricsRegistry", "get_registry", "scoped_registry", "record_level_stats",
    "DISPATCHES", "CHUNKS", "COL_GATHERS", "COL_GATHER_BYTES", "LEVELS",
    "TESTS_TOTAL", "ManualClock", "MonotonicClock", "Span", "Tracer",
    "NULL_SPAN", "NULL_CTX", "span", "journal_for", "run_tracer",
]


def journal_for(path: str | None = None) -> Journal | None:
    """A Journal at the given (or configured) path, or None; only when obs
    is enabled (the zero-overhead contract)."""
    cfg = get_config()
    if not cfg.enabled:
        return None
    p = path or cfg.journal_path
    return Journal(p) if p else None


def run_tracer(name: str, *, clock=None, journal_path: str | None = None) -> Tracer:
    """A PC run's tracer: always enabled (it fills ``timings_s``); its
    journal and profiler annotation engage only when obs is on."""
    cfg = get_config()
    return Tracer(name, clock=clock or cfg.clock, enabled=True,
                  journal=journal_for(journal_path), profiler=cfg.enabled and cfg.profiler)


def span(name: str, **attrs):
    """An ad-hoc span on a global tracer, for call sites with no run
    tracer in reach (``pc_scan_batch``); a no-op context when obs is off."""
    if not enabled():
        return NULL_CTX
    return _global_tracer().span(name, **attrs)


_TRACER: Tracer | None = None


def _global_tracer() -> Tracer:
    global _TRACER
    cfg = get_config()
    if _TRACER is None or (_TRACER.journal.path if _TRACER.journal else None) \
            != cfg.journal_path:
        _TRACER = Tracer("global", clock=cfg.clock, journal=journal_for(),
                         profiler=cfg.profiler)
    return _TRACER
