"""Online PC serving launcher: stream synthetic requests through
``serve.PCService`` on the CUDA card (the port of
``src/repro/launch/pc_serve.py``).

    python -m repro_torch.launch.pc_serve --requests 16 --rate 50
    python -m repro_torch.launch.pc_serve --faults          # recovery demo
    python -m repro_torch.launch.pc_serve --faults --device cpu

Builds the service, feeds it an open-loop Poisson arrival schedule, and
prints sustained requests/s, latency percentiles and the robustness
ledger (rejections, retries, dead letters). ``--faults`` runs the same
stream under an injected fault plan on a ManualClock (a forced validation
failure, a certificate miss that must escalate, an in-flight NaN and a
slot overrun past a deadline) and shows every request still ending as a
typed outcome.

Observability: ``--journal PATH`` turns obs on and streams every service
event as a JSONL ``serve`` record; ``--metrics-port N`` serves the
service registry in the Prometheus text format at
``http://localhost:N/metrics`` for the run's duration; ``--dump-metrics``
prints the same exposition on exit. ``--shard`` shards every slot's
batch axis over a device mesh (``core/sharding.py``): all visible cards,
or ``--devices K`` logical shards (K CPU shards with ``--device cpu``).

:func:`serve` is the arrival loop; it returns the service and its report,
so that a caller (``chip_smoke.py``) can inspect them.
"""
from __future__ import annotations

import argparse
import contextlib
import sys
import time

import numpy as np

from ..obs import MonotonicClock

_CLK = MonotonicClock()  # the obs timing seam


def fault_plan():
    """The demo fault plan of ``--faults``."""
    from ..serve import FaultPlan

    return FaultPlan(reject={"req-2"}, cert_miss={"req-4": 1}, corrupt_nan={"req-6": 1},
                     slot_delay={"req-8": 3.0})


def stream(args) -> list:
    """[(arrival second, Request)]: Poisson arrivals at ``args.rate``, two
    bucket shapes (n and n // 2, alternating), one α sweep (request 1)."""
    from ..data.synthetic_dag import sample_gaussian_dag
    from ..serve import Request

    rng = np.random.default_rng(args.seed)
    arrivals = np.cumsum(rng.exponential(1.0 / args.rate, size=args.requests))
    out = []
    for i, t in enumerate(arrivals):
        n = args.n if i % 2 else max(8, args.n // 2)  # two bucket shapes
        x, _ = sample_gaussian_dag(n=n, m=args.m, density=args.density, seed=args.seed + 1 + i)
        alphas = (0.005, args.alpha, 0.05) if (args.sweep and i == 1) else None
        out.append((float(t), Request(
            rid=f"req-{i}", x=np.asarray(x, np.float32), alpha=args.alpha, alphas=alphas,
            max_level=args.max_level, timeout_s=args.timeout_s)))
    if args.faults:  # only the overrun victim runs a tight deadline
        for _, r in out:
            if r.rid == "req-8":
                r.timeout_s = 2.0
    return out


def make_service(args):
    """The PCService of ``args``: on a ManualClock with the demo fault plan
    under ``--faults``, else on the real clock with no faults; with
    ``--shard`` its slots sharded over the mesh of :func:`shard_mesh`."""
    from ..serve import ManualClock, PCService, ServeConfig

    kw = dict(clock=ManualClock(), faults=fault_plan()) if args.faults else {}
    mesh = shard_mesh(args) if args.shard else None
    return PCService(ServeConfig(slot_size=args.slot_size, mesh=mesh), device=args.device, **kw)


def shard_mesh(args):
    """``--shard``'s mesh: ``--devices K`` shards on ``--device`` (K CPU
    shards on the CPU), else every visible card."""
    from ..core import sharding as S

    mesh = S.make_mesh(args.devices or None, device=args.device)
    print(f"[pc_serve] sharding slots over {S.mesh_size(mesh)} devices")
    return mesh


def serve(svc, reqs, *, submit_all: bool = False):
    """The arrival loop: submit each request at its arrival second (all at
    once with ``submit_all``), step the service whenever a slot is ready,
    wait out backoffs (virtually on a ManualClock). Returns (service,
    report, wall seconds)."""
    t0 = _CLK.now()
    i = 0
    while i < len(reqs) or svc.queue.pending():
        now = _CLK.now() - t0
        while i < len(reqs) and (reqs[i][0] <= now or submit_all):
            svc.submit(reqs[i][1])
            i += 1
        if svc.step():
            continue
        if svc.queue.pending():
            clock = svc.clock
            if hasattr(clock, "advance"):
                wake = svc.queue.next_ready_at() or clock.now()
                clock.advance(max(0.0, wake - clock.now()) + 1e-9)
            else:
                time.sleep(1e-3)
        elif i < len(reqs):
            time.sleep(max(0.0, min(reqs[i][0] - now, 1e-3)))
    return svc, svc.report, _CLK.now() - t0


def summary(svc, rep, n_requests: int, total: float) -> list:
    """The printed summary's lines."""
    lats = rep.latencies()
    graphs = sum(len(v) for v in rep.delivered.values())
    tiers = {}
    for by in rep.delivered.values():
        for g in by.values():
            tiers[g.tier] = tiers.get(g.tier, 0) + 1
    out = [f"[pc_serve] {n_requests} requests in {total:.2f}s "
           f"({len(rep.delivered) / total:.1f} req/s, {graphs} graphs)"]
    if lats:
        out.append(f"  latency p50={np.percentile(lats, 50) * 1e3:.0f}ms "
                   f"p99={np.percentile(lats, 99) * 1e3:.0f}ms (service clock)")
    out.append(f"  dispatches={rep.steps} tiers={tiers}")
    out.append(f"  rejected={len(rep.rejections)} "
               f"{[(r.rid, r.code) for r in rep.rejections.values()]}")
    out.append(f"  dead_letters={len(rep.dead_letters)} "
               f"{[(d.rid, d.code, d.stage) for d in rep.dead_letters]}")
    retries = [e for e in rep.events if e["event"] == "retry"]
    if retries:
        out.append(f"  retries={len(retries)} "
                   f"{[(e['rid'], e['reason'], e['attempt']) for e in retries]}")
    brk = [(g.queue_wait_s, g.dispatch_s, g.assembly_s)
           for by in rep.delivered.values() for g in by.values()]
    if brk:
        q, d, a = (float(np.mean(col)) for col in zip(*brk))
        out.append(f"  breakdown (mean): queue_wait={q * 1e3:.1f}ms "
                   f"dispatch={d * 1e3:.1f}ms assembly={a * 1e3:.1f}ms")
    misses = svc.metrics.total("pc_serve_deadline_miss_total")
    if misses:
        out.append(f"  deadline_misses={int(misses)}")
    return out


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.pc_serve")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--rate", type=float, default=50.0,
                    help="open-loop arrival rate (requests/s)")
    ap.add_argument("--n", type=int, default=32)
    ap.add_argument("--m", type=int, default=1200)
    ap.add_argument("--density", type=float, default=0.05)
    ap.add_argument("--alpha", type=float, default=0.01)
    ap.add_argument("--max-level", type=int, default=2)
    ap.add_argument("--slot-size", type=int, default=8)
    ap.add_argument("--timeout-s", type=float, default=60.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sweep", action="store_true", default=True,
                    help="include one alpha-sweep request (default on)")
    ap.add_argument("--device", default=None,
                    help="torch device; default the CUDA card (cpu runs the plain versions)")
    ap.add_argument("--shard", action="store_true",
                    help="shard every slot's batch axis over all visible devices")
    ap.add_argument("--devices", type=int, default=0,
                    help="with --shard: K logical shards (K CPU shards with --device cpu) "
                         "instead of every visible card")
    ap.add_argument("--faults", action="store_true",
                    help="inject the demo fault plan (ManualClock)")
    ap.add_argument("--journal", default=None, metavar="PATH",
                    help="enable obs and journal service events to PATH (JSONL)")
    ap.add_argument("--metrics-port", type=int, default=None, metavar="N",
                    help="serve Prometheus metrics at localhost:N/metrics")
    ap.add_argument("--dump-metrics", action="store_true",
                    help="print the Prometheus exposition on exit")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    from .. import obs

    scope = (obs.scoped(enabled=True, journal_path=args.journal) if args.journal
             else contextlib.nullcontext())
    with scope:
        svc = make_service(args)
        if args.faults:
            print("[pc_serve] fault plan: reject req-2, cert-miss req-4, "
                  "NaN-corrupt req-6, 3s overrun on req-8's slot (2s deadline)")
        httpd = None
        if args.metrics_port:
            httpd = serve_metrics(svc, args.metrics_port)
            print(f"[pc_serve] metrics at http://localhost:{args.metrics_port}/metrics")
        try:
            reqs = stream(args)
            svc, rep, total = serve(svc, reqs, submit_all=args.faults)
            for line in summary(svc, rep, len(reqs), total):
                print(line)
            if args.journal:
                print(f"  journal: {args.journal}")
            if args.dump_metrics:
                print(svc.metrics_text(), end="")
        finally:
            if httpd is not None:
                httpd.shutdown()
                httpd.server_close()
    return 0


def serve_metrics(svc, port: int):
    """A Prometheus text endpoint on a stdlib HTTP server in a daemon
    thread; stop it with ``shutdown()`` and ``server_close()``."""
    import threading
    from http.server import BaseHTTPRequestHandler, HTTPServer

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 (stdlib handler API)
            if self.path.rstrip("/") not in ("", "/metrics"):
                self.send_error(404)
                return
            body = svc.metrics_text().encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):  # keep the launcher's stdout clean
            pass

    httpd = HTTPServer(("127.0.0.1", port), Handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


if __name__ == "__main__":
    sys.exit(main())
