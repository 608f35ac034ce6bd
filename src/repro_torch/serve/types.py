"""Record types of the serving layer — the request/response vocabulary
(a copy of ``src/repro/serve/types.py``).

Everything the endpoint ingests or emits is a plain host-side record
(numpy + dataclasses): requests arrive before any device work is planned,
and results outlive the slots that computed them. Device tensors appear
only inside the dispatch loop (serve/service.py).

Lifecycle:   Request ──submit──▶ Rejection            (typed, never a crash)
                         │
                         └──▶ Lane(s) in a Bucket ──slot dispatch──▶
                                  GraphResult          (ok certificate True)
                                  retry lane           (wider bucket, backoff)
                                  DeadLetter           (deadline / exhausted)

A Request with ``alphas`` (a sweep over one dataset) fans out into one
Lane per alpha — lanes are the unit of batching, retry, and delivery;
the request id plus lane index addresses every record downstream.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np

#: Escalation tiers a lane can be resolved by, in ladder order.
TIER_SLOT = "slot"  # batched pc_scan_batch at the bucket schedule
TIER_WIDER = "slot-wider"  # batched retry at an escalated width schedule
TIER_SOLO = "solo-exact"  # single-graph pc_scan, n_prime=None (always exact)
TIER_STABLE = "stable-ref"  # host-loop reference oracle (degraded service)


@dataclass
class Request:
    """One unit of admission. Provide EITHER raw samples ``x`` (m, n) —
    the endpoint builds the correlation matrix — OR a prebuilt ``c``
    (n, n) with its sample count ``m``. ``alphas`` turns the request into
    an alpha sweep: one lane per significance level over the SAME data
    (the ParallelPC workload), all riding one bucket.

    ``timeout_s`` is the per-request deadline measured from admission on
    the service clock; a lane that misses it is dead-lettered even if its
    slot later completes (slot-mates are unaffected).
    """

    rid: str
    x: np.ndarray | None = None
    c: np.ndarray | None = None
    m: int | None = None
    alpha: float = 0.01
    alphas: tuple | None = None
    max_level: int | None = None
    timeout_s: float = 60.0


class BucketKey(NamedTuple):
    """Slot-compatibility key. Lanes sharing a key can ride one batched
    dispatch: same n / level cap (static shapes) and same planned level-0
    width bucket (same schedule plan). ``alpha`` is the request's loosest
    significance level; keeping it in the key stratifies slots by expected
    density, which is what makes the planned schedule tight for everyone
    in the slot. (On the card each slot's τ vector is also part of its
    recorded program's key: ``batch/scan_pc.py``.)"""

    n: int
    max_level: int
    width0: int
    alpha: float


@dataclass
class Lane:
    """One graph occupying one batch lane: the retry/accounting unit.

    Holds the PRISTINE host copy of the correlation matrix — slots are
    assembled from copies, so an injected (or real) in-flight corruption
    of slot memory never damages the source of a retry."""

    rid: str
    lane: int  # index within the request's alpha sweep (0 for plain)
    key: BucketKey
    c: np.ndarray  # (n, n) float32, validated
    m: int
    alpha: float
    taus: tuple  # per-level thresholds, len max_level+1
    submitted_at: float
    deadline: float
    attempt: int = 0
    not_before: float = 0.0  # backoff gate for retries
    # telemetry: when the lane (re-)entered its bucket, and the latency
    # breakdown accumulated across attempts (service clock seconds)
    enqueued_at: float = 0.0
    queue_wait_s: float = 0.0
    dispatch_s: float = 0.0


@dataclass
class Rejection:
    """Typed admission failure: the request never reached a bucket, so no
    slot saw it. ``code`` comes from core/validate.py (or "injected" from
    the fault harness)."""

    rid: str
    code: str
    message: str


@dataclass
class DeadLetter:
    """A lane the service gave up on — with the full story of why.

    code: "deadline" (expired in queue or while its slot ran) or
    "retries_exhausted" (every ladder tier failed its certificate).
    ``stage`` records where the deadline tripped ("queued" vs
    "completed"); ``attempts`` how many dispatches the lane consumed."""

    rid: str
    lane: int
    code: str
    message: str
    stage: str = ""
    attempts: int = 0


@dataclass
class GraphResult:
    """One delivered graph. ``exact`` is the honest flag: True means the
    scan's ok certificate held (bit-identical to an unconstrained
    pc_scan); a ``tier`` of TIER_STABLE marks degraded-but-served results
    from the reference path."""

    rid: str
    lane: int
    alpha: float
    adj: np.ndarray
    cpdag: np.ndarray
    sepsets: np.ndarray
    exact: bool
    tier: str
    attempts: int
    latency_s: float
    # latency breakdown (sums across attempts, service clock): time queued
    # behind the bucket, time inside slot dispatches, and host assembly
    queue_wait_s: float = 0.0
    dispatch_s: float = 0.0
    assembly_s: float = 0.0


@dataclass
class ServiceReport:
    """Aggregate outcome of a drain: every lane accounted for exactly once
    across delivered / dead_letters, plus admission rejections and the
    ordered event log (the fault-injection tests assert on it)."""

    delivered: dict = field(default_factory=dict)  # rid -> {lane: GraphResult}
    rejections: dict = field(default_factory=dict)  # rid -> Rejection
    dead_letters: list = field(default_factory=list)
    events: list = field(default_factory=list)
    steps: int = 0

    def result(self, rid: str, lane: int = 0) -> GraphResult:
        return self.delivered[rid][lane]

    def latencies(self) -> list:
        return sorted(
            r.latency_s for by in self.delivered.values() for r in by.values()
        )
