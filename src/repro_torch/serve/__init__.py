"""PC as a service: a fault-tolerant online endpoint over the batch
subsystem (the port of ``src/repro/serve``).

    svc = PCService()                   # the CUDA card; device="cpu" for the plain versions
    svc.submit(Request(rid="r1", x=samples, alpha=0.01))
    report = svc.drain()
    graph = report.result("r1")         # GraphResult: adj/cpdag/sepsets, exact

Layers: admission (validate and bucket) → service (slots, deadlines,
escalation ladder, degrade) → ``batch/scan_pc.py`` (the batched scan, on
the card one recorded program a slot key). ``serve/faults.py`` holds the
deterministic fault-injection harness and the clocks.
"""
from .admission import AdmissionPolicy, AdmissionQueue
from .faults import NO_FAULTS, FaultPlan, ManualClock, MonotonicClock
from .service import PCService, ServeConfig
from .types import (
    TIER_SLOT,
    TIER_SOLO,
    TIER_STABLE,
    TIER_WIDER,
    BucketKey,
    DeadLetter,
    GraphResult,
    Lane,
    Rejection,
    Request,
    ServiceReport,
)

__all__ = [
    "AdmissionPolicy",
    "AdmissionQueue",
    "BucketKey",
    "DeadLetter",
    "FaultPlan",
    "GraphResult",
    "Lane",
    "ManualClock",
    "MonotonicClock",
    "NO_FAULTS",
    "PCService",
    "Rejection",
    "Request",
    "ServeConfig",
    "ServiceReport",
    "TIER_SLOT",
    "TIER_SOLO",
    "TIER_STABLE",
    "TIER_WIDER",
]
