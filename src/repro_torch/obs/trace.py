"""Trace spans: nestable, exception-safe, device-time-aware timing (the
port of ``src/repro/obs/trace.py``).

* ``with tracer.span("level2", level=2) as sp`` opens a nested span; a
  span records its name, slash-joined path, depth, start and end time and
  free-form attributes, and closes on exceptions too (the error type is
  stamped into its attrs, so a journal shows where a run died).
* Time flows only through an injectable clock: :class:`MonotonicClock`
  in production, :class:`ManualClock` in tests, which makes span
  timelines and JSONL journals byte-deterministic.
* ``sp.sync(*tensors)`` registers tensors whose device work the span
  waits for at exit: for CUDA tensors the span calls
  ``torch.cuda.synchronize`` on their devices, so a span's duration
  covers the work done on the card and not only the launches. A disabled
  tracer's no-op span ignores the registration and never synchronises.
* ``profiler=True`` also wraps every span in
  ``torch.profiler.record_function``, so host spans line up with the
  card's kernels in a ``torch.profiler`` trace taken around the run.

``Tracer.timings()`` renders the span list as the ``{name: seconds}``
dict that ``PCRun.timings_s`` carries.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field


class MonotonicClock:
    """Real time: the production clock."""

    def now(self) -> float:
        return time.monotonic()


class ManualClock:
    """Virtual time the caller advances by hand; ``advance`` is also how
    injected slot delays take effect in the serving layer."""

    def __init__(self, t0: float = 0.0):
        self._t = float(t0)

    def now(self) -> float:
        return self._t

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"cannot advance time backwards (dt={dt})")
        self._t += float(dt)
        return self._t


@dataclass
class Span:
    """One finished (or open, while ``t1 is None``) trace span."""

    name: str
    path: str  # slash-joined ancestry, e.g. "total/level2"
    depth: int
    t0: float
    t1: float | None = None
    attrs: dict = field(default_factory=dict)
    _sync: tuple = ()

    @property
    def dur_s(self) -> float | None:
        return None if self.t1 is None else self.t1 - self.t0

    def set(self, **attrs) -> "Span":
        """Attach attributes found mid-span (e.g. the level's stats)."""
        self.attrs.update(attrs)
        return self

    def sync(self, *tensors) -> "Span":
        """Register tensors whose device work the span waits for at exit."""
        self._sync = self._sync + tuple(tensors)
        return self


class _NullSpan:
    """The disabled span: every method returns at once, and ``sync`` does
    not synchronise, so a disabled tracer leaves the card's queue alone."""

    __slots__ = ()

    def set(self, **attrs):
        return self

    def sync(self, *tensors):
        return self


NULL_SPAN = _NullSpan()


class _NullCtx:
    """Allocation-free context manager yielding the shared no-op span."""

    __slots__ = ()

    def __enter__(self):
        return NULL_SPAN

    def __exit__(self, *exc):
        return False


NULL_CTX = _NullCtx()


def _synchronize(tensors) -> None:
    """Wait for the work queued on every CUDA device among ``tensors``."""
    devices = {t.device for t in tensors
               if getattr(getattr(t, "device", None), "type", None) == "cuda"}
    if devices:
        import torch

        for dev in devices:
            torch.cuda.synchronize(dev)


class Tracer:
    """Collects a run's spans (in completion order) and streams each
    finished span to a :class:`~repro_torch.obs.journal.Journal` if given."""

    def __init__(self, name: str = "run", *, clock=None, enabled: bool = True,
                 journal=None, profiler: bool = False):
        self.name = name
        self.clock = clock or MonotonicClock()
        self.enabled = bool(enabled)
        self.journal = journal
        self.profiler = bool(profiler)
        self.spans: list[Span] = []
        self._stack: list[Span] = []

    @contextmanager
    def span(self, name: str, **attrs):
        if not self.enabled:
            yield NULL_SPAN
            return
        parent = self._stack[-1] if self._stack else None
        path = f"{parent.path}/{name}" if parent is not None else name
        sp = Span(name=name, path=path, depth=len(self._stack), t0=self.clock.now(),
                  attrs=dict(attrs))
        self._stack.append(sp)
        ann = None
        if self.profiler:
            import torch

            ann = torch.profiler.record_function(path)
            ann.__enter__()
        try:
            yield sp
        except BaseException as e:
            sp.attrs.setdefault("error", type(e).__name__)
            raise
        finally:
            if ann is not None:
                ann.__exit__(None, None, None)
            _synchronize(sp._sync)
            sp.t1 = self.clock.now()
            self._stack.pop()
            self.spans.append(sp)
            if self.journal is not None:
                self.journal.span(sp)

    # -- derived views -------------------------------------------------------
    def timings(self) -> dict:
        """``{span name: seconds}``, repeated names summed, ordered by first
        completion: ``PCRun.timings_s``."""
        out: dict[str, float] = {}
        for sp in self.spans:
            if sp.t1 is None:
                continue
            out[sp.name] = out.get(sp.name, 0.0) + sp.dur_s
        return out

    def finish(self, **attrs):
        """Write the closing ``run`` record (timings and the caller's attrs)
        and release the journal; nothing without a journal."""
        if self.journal is not None:
            self.journal.record("run", name=self.name, ts=self.clock.now(),
                                timings_s=self.timings(), attrs=attrs)
            self.journal.close()
