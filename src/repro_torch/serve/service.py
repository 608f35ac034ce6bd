"""PCService — the dispatch loop: slots, deadlines, escalation, degrade
(the port of ``src/repro/serve/service.py``).

One service owns an :class:`~repro_torch.serve.admission.AdmissionQueue`
and drains it slot by slot. Each step pops the ready lanes of one
(bucket, attempt) group (same static shapes, same escalation tier) and
runs them as one ``pc_scan_batch`` dispatch: on the card one recorded
program (CUDA graphs) a (slot size, τ vector, schedule), replayed. What
comes back is never trusted blindly: every lane carries the scan's ``ok``
exactness certificate, and a lane whose certificate fails is retried at
a wider width schedule instead of being delivered approximately or
failed. The ScanResult retry contract (``batch/scan_pc.py``) makes this
sound: the first ``ok=True`` attempt is the exact answer.

The escalation ladder, per lane (attempt number == rung):

  rung 0            batched slot at the bucket's planned schedule
  rungs 1..W        batched retry, widths doubled per rung and the
                    Tikhonov jitter ladder escalated in step (W =
                    ``ServeConfig.widen_attempts``), after exponential
                    backoff
  rung W+1          solo ``pc_scan`` with ``n_prime=None``: the graph's
                    own exact level-0 bound
  rung W+2          ``stable_ref`` host oracle: degraded (slow) service,
                    marked ``tier="stable-ref"``, still a real graph
  beyond            dead letter ("retries_exhausted")

Deadlines trip at two places: lanes whose deadline passed while queued
are dead-lettered without taking a slot seat, and lanes whose slot
completed after their deadline are dead-lettered at delivery; slot-mates
are untouched either way. Each lane's slot copy of C is finite-checked on
the host before dispatch (admission validated the pristine copy; this
catches corruption after admission, the seam ``serve/faults.py`` injects
NaNs into), and corrupt lanes are re-queued from their pristine copy.

After a slot the service reads ``ok`` once and copies the slot's adj,
cpdag and sepsets to the host once, not once a lane.

All timing flows through an injectable clock; on a ManualClock the whole
loop is deterministic. Telemetry: every service owns a
:class:`repro_torch.obs.MetricsRegistry` (queue-depth and in-flight
gauges; request, delivery, retry, deadline-miss and dead-letter counters;
a latency histogram), and every delivered :class:`GraphResult` carries
its latency breakdown (queue wait, slot dispatch, host assembly, summed
over attempts). ``metrics_text()`` renders the registry in the Prometheus
text format (``launch/pc_serve.py --metrics-port``); with obs enabled and
a journal path, every service event is also journaled as a ``serve``
record.

device: None means the CUDA card (raises without one); "cpu" runs the
plain versions of the kernels. ``ServeConfig.mesh`` (``core/sharding.py``)
shards every slot's batch axis over its devices, with graphs bitwise
equal to an unsharded service's; the service's own work (admission, the
solo and float64 rungs) stays on ``device``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from .. import obs
from ..batch.scan_pc import pc_scan, pc_scan_batch, plan_schedule
from ..core import levels as L
from ..core.stable_ref import pc_stable_skeleton
from .admission import AdmissionPolicy, AdmissionQueue
from .faults import NO_FAULTS, MonotonicClock
from .types import (
    TIER_SLOT,
    TIER_SOLO,
    TIER_STABLE,
    TIER_WIDER,
    DeadLetter,
    GraphResult,
    Lane,
    Rejection,
    Request,
    ServiceReport,
)


@dataclass
class ServeConfig:
    """Dispatch-loop knobs. ``jitter_ladder[k]`` is the regularisation of
    widening rung k (rung 0 = every engine's baseline, so fault-free
    slots stay bitwise the offline path); ``backoff_s`` seeds the
    exponential retry backoff; ``mesh`` shards every slot's batch axis
    over a device mesh (``core/sharding.py``)."""

    slot_size: int = 8
    widen_attempts: int = 2
    jitter_ladder: tuple = (L.DEFAULT_JITTER, 1e-6, 1e-4)
    backoff_s: float = 0.05
    cell_budget: int = L.DEFAULT_CELL_BUDGET
    orient: bool = True
    mesh: object = None


class PCService:
    """Fault-tolerant online PC endpoint over the batch subsystem."""

    def __init__(self, config: ServeConfig | None = None,
                 policy: AdmissionPolicy | None = None, *,
                 clock=None, faults=NO_FAULTS, journal=None, device=None):
        self.config = config or ServeConfig()
        self.clock = clock or MonotonicClock()
        self.faults = faults
        self.queue = AdmissionQueue(policy, clock=self.clock, faults=faults, device=device)
        self.device = self.queue.device
        self.report = ServiceReport()
        self._schedules: dict = {}  # BucketKey -> planned base width tuple
        # per-service registry: dict bumps only, no I/O, always on; the
        # journal (file I/O) engages only when obs is on or one is passed
        self.metrics = obs.MetricsRegistry()
        self.journal = journal if journal is not None else obs.journal_for()

    def metrics_text(self) -> str:
        """Prometheus text exposition of the service registry (scraped by
        the ``--metrics-port`` endpoint of ``launch/pc_serve.py``)."""
        self.metrics.set_gauge("pc_serve_queue_depth", self.queue.pending())
        return self.metrics.expose()

    # ladder geometry -------------------------------------------------------
    @property
    def _solo_rung(self) -> int:
        return self.config.widen_attempts + 1

    @property
    def _stable_rung(self) -> int:
        return self.config.widen_attempts + 2

    # -- intake -------------------------------------------------------------
    def submit(self, req: Request):
        out = self.queue.submit(req)
        if isinstance(out, Rejection):
            self.report.rejections[req.rid] = out
            self.metrics.inc("pc_serve_requests_total", outcome="rejected", code=out.code)
            self._log("reject", rid=req.rid, code=out.code)
        else:
            self.metrics.inc("pc_serve_requests_total", outcome="admitted")
            self._log("admit", rid=req.rid, lanes=len(out), key=out[0].key)
        self.metrics.set_gauge("pc_serve_queue_depth", self.queue.pending())
        return out

    # -- the loop -----------------------------------------------------------
    def step(self) -> bool:
        """Dispatch one slot (or reap one batch of expired lanes). Returns
        False when nothing was ready."""
        now = self.clock.now()
        slot = self.queue.next_slot(now, self.config.slot_size)
        if slot is None:
            return False
        key, attempt, lanes = slot
        self.report.steps += 1
        for ln in lanes:  # the slot seat ends this attempt's queue wait
            ln.queue_wait_s += max(0.0, now - ln.enqueued_at)
        self.metrics.set_gauge("pc_serve_queue_depth", self.queue.pending())

        lanes = self._reap_expired(lanes, now, stage="queued")
        lanes = self._screen_corruption(lanes, attempt, now)
        if not lanes:
            return True

        self.metrics.set_gauge("pc_serve_inflight", len(lanes))
        try:
            if attempt >= self._stable_rung:
                self._run_stable(lanes)
            elif attempt >= self._solo_rung:
                self._run_solo(lanes)
            else:
                self._run_slot(key, attempt, lanes)
        finally:
            self.metrics.set_gauge("pc_serve_inflight", 0)
        return True

    def drain(self, max_steps: int = 10_000) -> ServiceReport:
        """Run until every admitted lane is delivered or dead-lettered,
        waiting out retry backoffs (virtually on a ManualClock, by sleeping
        on the real one); ``max_steps`` bounds pathological fault plans."""
        for _ in range(max_steps):
            if self.step():
                continue
            if self.queue.pending() == 0:
                break
            wake = self.queue.next_ready_at()
            wait = max(0.0, (wake or 0.0) - self.clock.now()) + 1e-9
            if hasattr(self.clock, "advance"):
                self.clock.advance(wait)
            else:
                time.sleep(min(wait, 1.0))
        return self.report

    # -- slot guards --------------------------------------------------------
    def _reap_expired(self, lanes, now, stage):
        live = []
        for ln in lanes:
            if now > ln.deadline:
                self._dead(ln, "deadline",
                           f"deadline exceeded while {stage} ({now - ln.deadline:.3f}s past)",
                           stage=stage)
            else:
                live.append(ln)
        return live

    def _screen_corruption(self, lanes, attempt, now):
        """Finite-check the slot copies on the host; corrupt lanes re-queue
        from their pristine admission copy (bounded by the same ladder)."""
        clean = []
        for ln in lanes:
            c = self.faults.corrupt(ln.rid, attempt, ln.c)
            if np.isfinite(c).all():
                ln._slot_c = c  # the copy this dispatch will consume
                clean.append(ln)
                continue
            self._log("corruption_detected", rid=ln.rid, lane=ln.lane, attempt=attempt)
            self._retry(ln, now, reason="corruption")
        return clean

    # -- escalation tiers ---------------------------------------------------
    def _base_schedule(self, key, lanes) -> tuple:
        """Per-bucket tight width schedule, planned once on the bucket's
        first slot (one pilot pass) and reused by every later slot."""
        sched = self._schedules.get(key)
        if sched is None:
            cs = np.stack([ln._slot_c for ln in lanes])
            taus = np.asarray([ln.taus for ln in lanes], np.float32)
            sched = plan_schedule(
                cs, lanes[0].m, max_level=key.max_level,
                sepset_depth=self.queue.policy.sepset_depth,
                cell_budget=self.config.cell_budget, taus=taus, mesh=self.config.mesh,
                device=self.device)
            self._schedules[key] = sched
            self._log("plan", key=key, schedule=sched)
        return sched

    def _run_slot(self, key, attempt, lanes):
        """Batched tier: one dispatch for the whole slot at the (possibly
        widened) bucket schedule."""
        cfg = self.config
        base = self._base_schedule(key, lanes)
        widened = tuple(min(key.n, w << attempt) for w in base) or None
        jitter = cfg.jitter_ladder[min(attempt, len(cfg.jitter_ladder) - 1)]
        self._log("slot_dispatch", key=key, attempt=attempt, size=len(lanes),
                  schedule=widened, jitter=jitter, rids=[ln.rid for ln in lanes])
        t_disp = self.clock.now()
        res = pc_scan_batch(
            np.stack([ln._slot_c for ln in lanes]), lanes[0].m,
            max_level=key.max_level, sepset_depth=self.queue.policy.sepset_depth,
            n_prime=widened if widened is not None else 1,
            cell_budget=cfg.cell_budget, orient=cfg.orient, mesh=cfg.mesh,
            taus=np.asarray([ln.taus for ln in lanes], np.float32), jitter=jitter,
            device=self.device)
        # one read of the certificates and one host copy for the whole slot
        ok = res.ok.cpu().numpy().reshape(len(lanes))
        adj, cpdag, sep = (t.cpu().numpy() for t in (res.adj, res.cpdag, res.sepsets))
        now = self._after_dispatch(lanes, t_disp)
        for i, ln in enumerate(lanes):
            ok_i = bool(ok[i]) and not self.faults.force_cert_miss(ln.rid, attempt)
            if not ok_i:
                self._log("cert_miss", rid=ln.rid, lane=ln.lane, attempt=attempt)
                self._retry(ln, now, reason="cert_miss")
                continue
            self._deliver(ln, now, attempt, tier=TIER_SLOT if attempt == 0 else TIER_WIDER,
                          adj=adj[i], cpdag=cpdag[i], sepsets=sep[i], exact=True)

    def _run_solo(self, lanes):
        """Second-to-last rung: the per-graph exact run (``n_prime=None``
        plans this graph's own level-0 bound; the certificate holds by the
        retry contract unless the fault plan says otherwise)."""
        attempt = self._solo_rung
        for ln in lanes:
            self._log("solo_dispatch", rid=ln.rid, lane=ln.lane)
            t_disp = self.clock.now()
            res = pc_scan(
                ln._slot_c, ln.m, max_level=ln.key.max_level,
                sepset_depth=self.queue.policy.sepset_depth, n_prime=None,
                cell_budget=self.config.cell_budget, orient=self.config.orient,
                taus=np.asarray(ln.taus, np.float32), device=self.device)
            ok = bool(res.ok) and not self.faults.force_cert_miss(ln.rid, attempt)
            adj, cpdag, sep = (t.cpu().numpy() for t in (res.adj, res.cpdag, res.sepsets))
            now = self._after_dispatch([ln], t_disp)
            if not ok:
                self._log("cert_miss", rid=ln.rid, lane=ln.lane, attempt=attempt)
                self._retry(ln, now, reason="cert_miss")
                continue
            self._deliver(ln, now, attempt, tier=TIER_SOLO, adj=adj, cpdag=cpdag, sepsets=sep,
                          exact=True)

    def _run_stable(self, lanes):
        """Last rung before the dead-letter box: the serial float64 host
        oracle. Slow and certificate-free, but it cannot cap widths:
        degraded service beats none."""
        attempt = self._stable_rung
        depth = self.queue.policy.sepset_depth
        for ln in lanes:
            if self.faults.force_cert_miss(ln.rid, attempt):
                self._dead(ln, "retries_exhausted",
                           "every escalation tier (incl. stable-ref) failed", stage="exhausted")
                continue
            self._log("stable_dispatch", rid=ln.rid, lane=ln.lane)
            t_disp = self.clock.now()
            ref = pc_stable_skeleton(np.asarray(ln._slot_c, np.float64), ln.m, alpha=ln.alpha,
                                     max_level=ln.key.max_level)
            adj = np.asarray(ref.adj, bool)
            sep = _sepsets_to_tensor(ref.sepsets, adj, depth)
            cpdag = _orient_host(adj, sep) if self.config.orient else adj
            now = self._after_dispatch([ln], t_disp)
            self._log("degraded", rid=ln.rid, lane=ln.lane)
            self._deliver(ln, now, attempt, tier=TIER_STABLE, adj=adj, cpdag=cpdag, sepsets=sep,
                          exact=False)

    # -- outcomes -----------------------------------------------------------
    def _after_dispatch(self, lanes, t_disp: float | None = None) -> float:
        """Advance virtual time by any injected slot delay; charge the
        dispatch window to each lane's breakdown; return now."""
        delay = self.faults.delay_for([ln.rid for ln in lanes])
        if delay > 0 and hasattr(self.clock, "advance"):
            self.clock.advance(delay)
        now = self.clock.now()
        if t_disp is not None:
            for ln in lanes:
                ln.dispatch_s += max(0.0, now - t_disp)
        return now

    def _retry(self, ln: Lane, now: float, reason: str):
        nxt = ln.attempt + 1
        if nxt > self._stable_rung:
            self._dead(ln, "retries_exhausted",
                       f"ladder exhausted after {nxt} attempts ({reason})", stage="exhausted")
            return
        ln.attempt = nxt
        ln.not_before = now + self.config.backoff_s * (2 ** (nxt - 1))
        self.metrics.inc("pc_serve_retries_total", reason=reason)
        self._log("retry", rid=ln.rid, lane=ln.lane, attempt=nxt, not_before=ln.not_before,
                  reason=reason)
        self.queue.requeue(ln)
        self.metrics.set_gauge("pc_serve_queue_depth", self.queue.pending())

    def _deliver(self, ln: Lane, now: float, attempt: int, *, tier, adj, cpdag, sepsets,
                 exact):
        expired = self._reap_expired([ln], now, stage="completed")
        if not expired:  # the deadline tripped at delivery; result discarded
            return
        assembly_s = max(0.0, self.clock.now() - now)
        res = GraphResult(
            rid=ln.rid, lane=ln.lane, alpha=ln.alpha, adj=adj, cpdag=cpdag, sepsets=sepsets,
            exact=exact, tier=tier, attempts=attempt + 1, latency_s=now - ln.submitted_at,
            queue_wait_s=ln.queue_wait_s, dispatch_s=ln.dispatch_s, assembly_s=assembly_s)
        self.report.delivered.setdefault(ln.rid, {})[ln.lane] = res
        self.metrics.inc("pc_serve_deliveries_total", tier=tier)
        self.metrics.observe("pc_serve_latency_seconds", res.latency_s)
        self._log("delivered", rid=ln.rid, lane=ln.lane, tier=tier, attempts=attempt + 1,
                  latency_s=res.latency_s, queue_wait_s=res.queue_wait_s,
                  dispatch_s=res.dispatch_s, assembly_s=res.assembly_s)

    def _dead(self, ln: Lane, code: str, message: str, stage: str):
        self.report.dead_letters.append(DeadLetter(
            rid=ln.rid, lane=ln.lane, code=code, message=message, stage=stage,
            attempts=ln.attempt))
        self.metrics.inc("pc_serve_dead_letters_total", code=code)
        if code == "deadline":
            self.metrics.inc("pc_serve_deadline_miss_total", stage=stage)
        self._log("dead_letter", rid=ln.rid, lane=ln.lane, code=code, stage=stage)

    def _log(self, event: str, **info):
        self.report.events.append({"event": event, **info})
        if self.journal is not None:
            self.journal.record("serve", event=event, ts=self.clock.now(),
                                **{k: v for k, v in info.items()
                                   if not isinstance(v, np.ndarray)})


def _sepsets_to_tensor(sepsets: dict, adj: np.ndarray, depth: int) -> np.ndarray:
    """stable_ref's {(i, j) -> tuple} sepsets in the engines' tensor
    convention: -1 padded, -2 sentinel in slot 0 for empty (level-0)
    sepsets of removed edges."""
    n = adj.shape[0]
    sep = np.full((n, n, depth), -1, np.int32)
    sep[..., 0] = np.where(adj, -1, -2)
    for (i, j), s in sepsets.items():
        row = [-2] if not s else list(s[:depth])
        sep[i, j, : len(row)] = row
        sep[j, i, : len(row)] = row
    return sep


def _orient_host(adj: np.ndarray, sep: np.ndarray) -> np.ndarray:
    """The CPDAG of a host skeleton, on CPU tensors."""
    from ..core.orient import cpdag_from_skeleton

    return cpdag_from_skeleton(torch.from_numpy(adj), torch.from_numpy(sep)).numpy()
