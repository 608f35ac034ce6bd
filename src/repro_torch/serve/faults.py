"""Deterministic fault injection + virtual time for the serving layer (a
copy of ``src/repro/serve/faults.py``).

Every recovery path in serve/service.py — validation rejects, certificate
misses, in-flight corruption, slot overruns, deadline expiry — must be
unit-testable WITHOUT flaky timing or hand-crafted pathological datasets.
Two pieces make that possible:

* :class:`ManualClock` — the service reads time only through its injected
  clock, so tests advance time explicitly (``clock.advance(5.0)``) and a
  "slot that ran past the deadline" is a deterministic assertion, not a
  sleep. Production uses :class:`MonotonicClock`. The clock classes live
  in ``repro_torch.obs.trace`` (the observability layer shares them, so
  trace spans and journals are deterministic under the same virtual
  time); this module re-exports them.

* :class:`FaultPlan` — a declarative schedule of faults keyed by request
  id and attempt number. The service consults it at each decision point;
  an empty plan (the default) is a no-op on every path. Faults are
  *attempt-bounded* ("fail the first k attempts") so tests exercise both
  the recovery (k < ladder length → the retry succeeds) and the
  exhaustion (k ≥ ladder length → dead letter) arms of every path.

The plan injects at the same seams real faults occur: ``reject`` models a
poisoned payload caught at admission; ``corrupt_nan`` models post-admission
memory corruption of slot storage (the service's finite-check at assembly
catches it, and the retry re-assembles from the lane's pristine copy);
``cert_miss`` models a width schedule that undershot the live degree;
``slot_delay`` models a straggler dispatch.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..obs.trace import ManualClock, MonotonicClock  # noqa: F401


@dataclass
class FaultPlan:
    """Declarative fault schedule; all maps are keyed by request id.

    reject:       rids whose admission is forced to fail (typed Rejection
                  with code "injected", never an exception).
    cert_miss:    rid -> k: force the exactness certificate to read False
                  on attempts 0..k-1, regardless of the real ``ok``.
    corrupt_nan:  rid -> k: overwrite the lane's SLOT copy (never the
                  pristine admission copy) with a NaN on attempts 0..k-1.
    slot_delay:   rid -> seconds of virtual time the lane's slot takes
                  (max over the slot's lanes; needs a ManualClock).
    """

    reject: set = field(default_factory=set)
    cert_miss: dict = field(default_factory=dict)
    corrupt_nan: dict = field(default_factory=dict)
    slot_delay: dict = field(default_factory=dict)

    def force_reject(self, rid: str) -> bool:
        return rid in self.reject

    def force_cert_miss(self, rid: str, attempt: int) -> bool:
        return attempt < self.cert_miss.get(rid, 0)

    def corrupt(self, rid: str, attempt: int, c: np.ndarray) -> np.ndarray:
        if attempt < self.corrupt_nan.get(rid, 0):
            c = c.copy()
            c[0, min(1, c.shape[1] - 1)] = np.nan
        return c

    def delay_for(self, rids) -> float:
        return max((self.slot_delay.get(r, 0.0) for r in rids), default=0.0)


#: Shared no-op plan for the default (fault-free) service.
NO_FAULTS = FaultPlan()
