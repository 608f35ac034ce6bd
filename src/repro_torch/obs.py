"""Minimal trace spans for the port's drivers: the subset of
``src/repro/obs/trace.py`` that ``core/pc.py`` uses.

``sp.sync(*tensors)`` registers tensors whose device work the span waits
for at exit: for CUDA tensors the span calls ``torch.cuda.synchronize``,
so a span's duration covers the work done on the card and not only the
launches (PyTorch, like JAX, returns before the device finishes).
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field

import torch


@dataclass
class Span:
    name: str
    t0: float
    t1: float | None = None
    attrs: dict = field(default_factory=dict)
    _sync: tuple = ()

    @property
    def dur_s(self) -> float | None:
        return None if self.t1 is None else self.t1 - self.t0

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def sync(self, *tensors) -> "Span":
        self._sync = self._sync + tuple(tensors)
        return self


class Tracer:
    """Collects a run's spans in completion order."""

    def __init__(self):
        self.spans: list[Span] = []

    @contextmanager
    def span(self, name: str, **attrs):
        sp = Span(name=name, t0=time.monotonic(), attrs=dict(attrs))
        try:
            yield sp
        except BaseException as e:
            sp.attrs.setdefault("error", type(e).__name__)
            raise
        finally:
            devices = {t.device for t in sp._sync
                       if isinstance(t, torch.Tensor) and t.device.type == "cuda"}
            for dev in devices:
                torch.cuda.synchronize(dev)
            sp.t1 = time.monotonic()
            self.spans.append(sp)

    def timings(self) -> dict:
        """{span name: seconds}, repeated names summed — ``PCRun.timings_s``."""
        out: dict[str, float] = {}
        for sp in self.spans:
            if sp.t1 is not None:
                out[sp.name] = out.get(sp.name, 0.0) + sp.dur_s
        return out
