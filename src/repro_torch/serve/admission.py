"""Admission queue: validate at the door, then bucket (the port of
``src/repro/serve/admission.py``).

Nothing enters a batch slot that could crash or silently poison it. Each
submitted request is validated on the host (``core/validate.py``, strict
mode: a multi-tenant endpoint rejects rank-deficient panels rather than
serve biased graphs), its correlation matrix is built (if samples were
sent) or re-checked, and only then is it fanned out into Lanes and filed
under a :class:`~repro_torch.serve.types.BucketKey`.

C of a sample request comes from the corr kernel on the card
(``kernels.ops.correlation``, as ``pc``'s "auto" picks it) and from the
plain ``cit.correlation_from_samples`` on the CPU. The lane keeps it as a
host float32 array (the pristine copy), so the service's finite screen
runs on the host and costs no sync a lane.

Bucketing is the batching policy. Lanes under one key share (n, level
cap), the static shapes of a slot's program, and a planned level-0 width
bucket from ``plan_n_prime``, so a slot drawn from one bucket has one
planned schedule that is tight for every occupant. Alpha sweeps fan into
sibling lanes of one bucket, planned at the loosest alpha, which bounds
every lane (see ``alpha_sweep``).

Rejected requests are recorded (and optionally quarantined with their
payload), never raised: ``submit`` always returns, and a rejection costs
no device time.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass

import numpy as np
import torch

from .. import device as D
from ..batch.scan_pc import DEFAULT_MAX_LEVEL, plan_n_prime, taus_for
from ..core import validate as V
from ..core.cit import correlation_of
from .faults import NO_FAULTS
from .types import BucketKey, Lane, Rejection, Request


def sample_correlation(x: np.ndarray, device: torch.device) -> np.ndarray:
    """C (n, n) of samples x (m, n) as a host float32 array: the corr
    kernel on a CUDA device, the plain version on the CPU."""
    return correlation_of(torch.tensor(np.asarray(x, np.float32), device=device)).cpu().numpy()


@dataclass
class AdmissionPolicy:
    """Knobs of the front door. ``strict_rank`` escalates m < n to a
    typed reject (the serving default; ``pc`` merely warns);
    ``quarantine`` keeps rejected requests' payloads for inspection
    instead of dropping them; ``sepset_depth`` caps the admissible level
    range (a request deeper than the slot tensors can record is a config
    error worth rejecting loudly)."""

    strict_rank: bool = True
    quarantine: bool = False
    sepset_depth: int = 8
    default_max_level: int = DEFAULT_MAX_LEVEL


class AdmissionQueue:
    """Validating front door and bucketed FIFO of admitted lanes.

    device: None means the CUDA card (raises without one); "cpu" builds C
    and plans widths with the plain versions."""

    def __init__(self, policy: AdmissionPolicy | None = None, *, clock=None,
                 faults=NO_FAULTS, device=None):
        from .faults import MonotonicClock

        self.policy = policy or AdmissionPolicy()
        self.clock = clock or MonotonicClock()
        self.faults = faults
        self.device = D.resolve_device(device)
        self.buckets: OrderedDict[BucketKey, list[Lane]] = OrderedDict()
        self.rejections: dict[str, Rejection] = {}
        self.quarantined: list[Request] = []
        self._seen: set[str] = set()

    # -- submission ---------------------------------------------------------
    def submit(self, req: Request):
        """Validate and admit one request. Returns the list of admitted
        Lanes, or a :class:`Rejection`; never raises for bad data."""
        if req.rid in self._seen:
            return self._reject(req, "duplicate", f"rid {req.rid!r} already submitted")
        self._seen.add(req.rid)
        if self.faults.force_reject(req.rid):
            return self._reject(req, "injected", "fault plan forced a validation failure")
        try:
            c, m, lmax = self._validated(req)
        except V.ValidationError as e:
            return self._reject(req, e.code, str(e))

        alphas = tuple(float(a) for a in (req.alphas or (req.alpha,)))
        if not alphas or any(not (0.0 < a < 1.0) for a in alphas):
            return self._reject(req, "bad_alpha", f"alphas must lie in (0, 1); got {alphas}")

        # plan the bucket width at the loosest alpha: its level-0 keep-set
        # is a superset of every lane's, so one width serves the sweep
        a_plan = max(alphas)
        w0 = plan_n_prime(c, m, alpha=a_plan, device=self.device)
        key = BucketKey(n=int(c.shape[0]), max_level=lmax, width0=w0, alpha=a_plan)

        now = self.clock.now()
        lanes = [
            Lane(rid=req.rid, lane=k, key=key, c=c, m=m, alpha=a,
                 taus=taus_for(m, a, lmax), submitted_at=now,
                 deadline=now + float(req.timeout_s), enqueued_at=now)
            for k, a in enumerate(alphas)
        ]
        self.buckets.setdefault(key, []).extend(lanes)
        return lanes

    def _validated(self, req: Request):
        lmax = (self.policy.default_max_level if req.max_level is None
                else int(req.max_level))
        if not 0 <= lmax <= self.policy.sepset_depth:
            raise V.ValidationError(
                f"max_level={lmax} outside the servable range "
                f"[0, {self.policy.sepset_depth}] (slot sepset tensors are "
                f"{self.policy.sepset_depth} deep)")
        strict = self.policy.strict_rank
        if req.x is not None:
            m, _ = V.validate_samples(req.x, max_level=lmax, strict_rank=strict)
            c = sample_correlation(req.x, self.device)
        elif req.c is not None:
            if req.m is None:
                raise V.ValidationError("a correlation-matrix request needs m (sample count)")
            m = int(req.m)
            V.validate_corr(req.c, m, max_level=lmax, strict_rank=strict)
            c = np.asarray(req.c, np.float32)
        else:
            raise V.ValidationError("request carries neither samples x nor a correlation c")
        return np.ascontiguousarray(c, np.float32), m, lmax

    def _reject(self, req: Request, code: str, message: str) -> Rejection:
        rej = Rejection(rid=req.rid, code=code, message=message)
        self.rejections[req.rid] = rej
        if self.policy.quarantine:
            self.quarantined.append(req)
        return rej

    # -- draining -----------------------------------------------------------
    def requeue(self, lane: Lane):
        """Return a retry lane to its bucket (the service's escalation)."""
        lane.enqueued_at = self.clock.now()  # queue wait restarts per attempt
        self.buckets.setdefault(lane.key, []).append(lane)

    def pending(self) -> int:
        return sum(len(v) for v in self.buckets.values())

    def next_slot(self, now: float, slot_size: int):
        """Pop the next dispatchable slot: the ready lanes (backoff gate
        passed) of one (bucket, attempt) group, FIFO by bucket insertion.
        Lanes in a slot share the attempt number so they share an
        escalated width schedule. Returns (key, attempt, lanes) or None
        if nothing is ready (distinct from pending() == 0: lanes may all
        be backing off)."""
        for key in list(self.buckets):
            lanes = self.buckets[key]
            ready = [ln for ln in lanes if ln.not_before <= now]
            if not ready:
                if not lanes:
                    del self.buckets[key]
                continue
            attempt = min(ln.attempt for ln in ready)
            take = [ln for ln in ready if ln.attempt == attempt][:slot_size]
            taken = set(map(id, take))
            self.buckets[key] = [ln for ln in lanes if id(ln) not in taken]
            if not self.buckets[key]:
                del self.buckets[key]
            return key, attempt, take
        return None

    def next_ready_at(self) -> float | None:
        """Earliest backoff expiry among queued lanes (drives idle waits)."""
        times = [ln.not_before for v in self.buckets.values() for ln in v]
        return min(times) if times else None
