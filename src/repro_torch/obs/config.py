"""Process-wide observability configuration (the port of
``src/repro/obs/config.py``).

One mutable singleton (:func:`get_config`) gates everything that is not
free: journal files, the global metrics registry and profiler span
annotation. Timing itself (the runs' tracers feeding ``timings_s``) is
always on, so enabling obs changes what is visible, never results.

Enable it in code::

    from repro_torch import obs
    obs.configure(enabled=True, journal_path="runs/pc.jsonl")

or by environment (read once at import)::

    REPRO_OBS=1 REPRO_OBS_JOURNAL=runs/pc.jsonl python -m repro_torch.launch.pc_run

``REPRO_OBS_PROFILER=1`` wraps every span in
``torch.profiler.record_function``. ``obs.scoped(...)`` applies a change
inside a ``with`` block and restores the previous state on exit.
"""
from __future__ import annotations

import os
from contextlib import contextmanager
from dataclasses import dataclass, replace


@dataclass
class ObsConfig:
    enabled: bool = False  # master switch for journal, registry and profiler
    journal_path: str | None = None  # JSONL sink for run journals
    profiler: bool = False  # wrap spans in torch.profiler.record_function
    clock: object | None = None  # injectable clock (ManualClock in tests)


def _from_env() -> ObsConfig:
    on = os.environ.get("REPRO_OBS", "").lower() in ("1", "true", "on", "yes")
    path = os.environ.get("REPRO_OBS_JOURNAL") or None
    prof = os.environ.get("REPRO_OBS_PROFILER", "").lower() in ("1", "true")
    return ObsConfig(enabled=on or path is not None, journal_path=path, profiler=prof)


_CONFIG = _from_env()


def get_config() -> ObsConfig:
    return _CONFIG


def configure(**kw) -> ObsConfig:
    """Update fields of the global config; returns the new config."""
    global _CONFIG
    _CONFIG = replace(_CONFIG, **kw)
    return _CONFIG


def enable(journal_path: str | None = None, **kw) -> ObsConfig:
    return configure(enabled=True, journal_path=journal_path, **kw)


def disable() -> ObsConfig:
    return configure(enabled=False, journal_path=None, profiler=False)


def enabled() -> bool:
    return _CONFIG.enabled


@contextmanager
def scoped(**kw):
    """Override config fields inside a block; the prior config comes back
    on exit. Pair with ``metrics.scoped_registry()`` where ``enabled`` is
    flipped, so that counters do not leak between cases."""
    global _CONFIG
    prev = _CONFIG
    _CONFIG = replace(_CONFIG, **kw)
    try:
        yield _CONFIG
    finally:
        _CONFIG = prev
