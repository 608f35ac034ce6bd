"""The port's observability layer (``repro_torch.obs``) on its own and
against the JAX package's ``repro.obs``.

* tests/test_obs.py's unit cases on the port: span paths and nesting,
  exception safety, the disabled no-op, labelled aggregation, the kind
  conflict, ``record_level_stats``;
* the same ``inc``/``set_gauge``/``observe`` sequence gives a byte-equal
  Prometheus ``expose()`` text in both packages, and the same span
  sequence on a ManualClock byte-equal JSONL journals;
* the entry points: ``pc`` journal spans reconcile with ``timings_s``; with
  obs off no file is written and results are bitwise those with it on;
  after ``pc_from_corr(engine="S")`` on one C the registry's per-level
  counters equal the JAX package's (labels and values);
* ``pc_scan_batch``'s global span, the profiler annotation and the
  service's ``serve`` journal records.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import obs as jobs  # noqa: E402
from repro.core.cit import correlation_from_samples as jcorr  # noqa: E402
from repro.core.pc import pc_from_corr as jpc_from_corr  # noqa: E402
from repro.data.synthetic_dag import sample_gaussian_dag  # noqa: E402
from repro_torch import obs, pc, pc_from_corr  # noqa: E402
from repro_torch.batch import scan_pc  # noqa: E402

pytestmark = [pytest.mark.torch, pytest.mark.obs]

M = 400
CPU = "cpu"


def _x(n=12, seed=0, m=M):
    x, _ = sample_gaussian_dag(n=n, m=m, density=0.15, seed=seed)
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------- spans
def test_span_nesting_paths_and_durations():
    clk = obs.ManualClock()
    tr = obs.Tracer("t", clock=clk)
    with tr.span("total"):
        clk.advance(1.0)
        with tr.span("level1", level=1):
            clk.advance(2.0)
        with tr.span("level2"):
            clk.advance(3.0)
    done = {s.name: s for s in tr.spans}
    assert done["level1"].path == "total/level1"
    assert done["level1"].depth == 1
    assert done["level1"].attrs["level"] == 1
    assert (done["level1"].dur_s, done["level2"].dur_s, done["total"].dur_s) == (2.0, 3.0, 6.0)
    assert tr.timings() == {"level1": 2.0, "level2": 3.0, "total": 6.0}


def test_span_repeated_names_sum_in_timings():
    clk = obs.ManualClock()
    tr = obs.Tracer(clock=clk)
    for _ in range(3):
        with tr.span("chunk"):
            clk.advance(0.5)
    assert tr.timings() == {"chunk": 1.5}


def test_span_exception_safety():
    clk = obs.ManualClock()
    tr = obs.Tracer(clock=clk)
    with pytest.raises(ValueError):
        with tr.span("outer"):
            with tr.span("inner"):
                clk.advance(1.0)
                raise ValueError("boom")
    assert [s.name for s in tr.spans] == ["inner", "outer"]
    assert all(s.t1 is not None for s in tr.spans)
    assert tr.spans[0].attrs["error"] == "ValueError"
    assert tr._stack == []
    with tr.span("after"):
        pass
    assert tr.spans[-1].path == "after"


def test_disabled_tracer_yields_noop_span():
    tr = obs.Tracer(enabled=False)
    with tr.span("x") as sp:
        assert sp is obs.NULL_SPAN
        sp.set(a=1).sync(torch.zeros(3))
    assert tr.spans == [] and tr.timings() == {}
    with obs.span("global") as sp:  # obs is off: the module-level span is a no-op
        assert sp is obs.NULL_SPAN


def test_manual_clock_refuses_to_go_back():
    with pytest.raises(ValueError):
        obs.ManualClock(5.0).advance(-1.0)


# -------------------------------------------------------------- metrics
def test_metrics_labeled_aggregation():
    reg = obs.MetricsRegistry()
    reg.inc(obs.DISPATCHES, 3, engine="S", level=1)
    reg.inc(obs.DISPATCHES, 5, engine="S", level=2)
    reg.inc(obs.DISPATCHES, 7, engine="S-grid", level=1)
    assert reg.value(obs.DISPATCHES, engine="S", level=1) == 3
    assert reg.total(obs.DISPATCHES, engine="S") == 8
    assert reg.total(obs.DISPATCHES) == 15
    reg.set_gauge("depth", 4)
    reg.set_gauge("depth", 2)
    assert reg.value("depth") == 2
    reg.observe("lat", 0.003)
    reg.observe("lat", 2.0)
    fam = reg.collect()["lat"]["series"][0]
    assert fam["count"] == 2 and fam["sum"] == 2.003


def test_metrics_kind_conflict_raises():
    reg = obs.MetricsRegistry()
    reg.inc("x")
    with pytest.raises(TypeError):
        reg.set_gauge("x", 1.0)


def test_record_level_stats_single_definition():
    reg = obs.MetricsRegistry()
    st = {"engine": "S", "dispatches": 6, "chunks": 3, "total_sets": 100,
          "col_gathers": 3, "col_gather_bytes": 1200}
    obs.record_level_stats(st, level=2, layout="sharded", registry=reg)
    assert reg.total(obs.DISPATCHES) == 6
    assert reg.total(obs.COL_GATHERS) == 3
    assert reg.total(obs.COL_GATHER_BYTES) == 1200
    assert reg.value(obs.LEVELS, engine="S", level=2, layout="sharded") == 1
    reg2 = obs.MetricsRegistry()
    obs.record_level_stats({"engine": "E", "dispatches": 2}, level=1, registry=reg2)
    assert obs.COL_GATHERS not in reg2.collect()
    assert not obs.enabled()  # off and no registry given: nothing is recorded
    with obs.scoped_registry() as glob:
        obs.record_level_stats(st, level=2)
        assert glob.collect() == {}


def _metrics_sequence(pkg):
    reg = pkg.MetricsRegistry()
    reg.inc("pc_dispatches_total", 4, engine="S", level=1)
    reg.inc("pc_dispatches_total", 2, engine="S-grid", level=3)
    reg.inc("pc_serve_requests_total", outcome="rejected", code="non_finite")
    reg.set_gauge("pc_serve_queue_depth", 3)
    reg.set_gauge("pc_serve_inflight", 0)
    for v in (0.02, 0.0004, 7.5, 31.0):
        reg.observe("pc_serve_latency_seconds", v)
    reg.observe("custom_seconds", 0.3, bounds=(0.1, 1.0), lane=2)
    pkg.record_level_stats({"engine": "S", "dispatches": 6, "chunks": 3, "total_sets": 90},
                           level=2, registry=reg)
    return reg


def test_exposition_byte_equal_to_reference():
    got, want = _metrics_sequence(obs), _metrics_sequence(jobs)
    assert got.expose() == want.expose()
    assert got.collect() == want.collect()
    text = got.expose()
    assert 'pc_dispatches_total{engine="S",level="1"} 4.0' in text
    assert 'pc_serve_latency_seconds_bucket{le="+Inf"} 4' in text


def _journal_sequence(pkg, path):
    clk = pkg.ManualClock(10.0)
    tr = pkg.Tracer("run", clock=clk, journal=pkg.Journal(path))
    with tr.span("total", cfg="x", n=12):
        clk.advance(2.0)
        with tr.span("level1", chunks=2, engine="S"):
            clk.advance(0.25)
        with pytest.raises(KeyError):
            with tr.span("level2"):
                clk.advance(1.0)
                raise KeyError("x")
        tr.journal.metrics(_metrics_sequence(pkg), ts=clk.now())
        tr.journal.record("serve", event="delivered", rid="r1", ts=clk.now(), latency_s=0.5)
    tr.finish(seed=0, driver="test")
    with open(path, encoding="utf-8") as fh:
        return fh.read()


def test_journal_byte_equal_to_reference(tmp_path):
    got = _journal_sequence(obs, str(tmp_path / "port.jsonl"))
    want = _journal_sequence(jobs, str(tmp_path / "ref.jsonl"))
    assert got == want
    recs = obs.read_journal(str(tmp_path / "port.jsonl"))
    assert [r["kind"] for r in recs] == ["span", "span", "metric", "serve", "span", "run"]
    assert recs[1]["attrs"]["error"] == "KeyError"
    assert obs.phase_summary(recs, depth=1) == {"level1": 0.25, "level2": 1.0}


def test_journal_lazy_open_leaves_no_file(tmp_path):
    path = str(tmp_path / "never.jsonl")
    obs.Journal(path).close()
    assert not os.path.exists(path)


# ---------------------------------------------- pc integration + gating
def test_pc_journal_spans_reconcile_with_total(tmp_path):
    path = str(tmp_path / "pc.jsonl")
    with obs.scoped(enabled=True, journal_path=path), obs.scoped_registry():
        run = pc(_x(), alpha=0.01, device=CPU)
    recs = obs.read_journal(path)
    phases = obs.phase_summary(recs, depth=1)
    for k, v in run.timings_s.items():
        if k != "total":
            assert phases[k] == pytest.approx(v)
    assert sum(phases.values()) <= run.timings_s["total"] + 1e-6
    run_rec = [r for r in recs if r["kind"] == "run"]
    assert len(run_rec) == 1 and run_rec[0]["timings_s"] == run.timings_s
    assert run_rec[0]["attrs"] == {"driver": "pc_from_corr", "engine": "auto", "n": 12,
                                   "levels_run": run.levels_run}


def test_zero_overhead_contract_disabled_obs(tmp_path):
    """Obs off: no journal file, and bitwise the outputs of a run with it on."""
    x = _x(seed=3)
    assert not obs.enabled()
    base = pc(x, alpha=0.01, device=CPU)
    path = str(tmp_path / "on.jsonl")
    with obs.scoped(enabled=True, journal_path=path), obs.scoped_registry():
        on = pc(x, alpha=0.01, device=CPU)
    off = pc(x, alpha=0.01, device=CPU)
    for a, b in ((base, on), (base, off)):
        for f in ("adj", "cpdag", "sepsets"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert list(tmp_path.iterdir()) == [tmp_path / "on.jsonl"]


def test_timings_populated_without_obs():
    run = pc(_x(), alpha=0.01, device=CPU)
    assert {"level0", "orient", "total"} <= set(run.timings_s)
    assert run.timings_s["total"] >= run.timings_s["level0"]


@pytest.mark.parametrize("engine", ["S", "auto"])
def test_registry_counts_match_reference(engine):
    """The per-level counters after ``pc_from_corr`` on one C: the port's
    registry equals the JAX package's (labels and values) and the summed
    level_stats dicts."""
    c = np.asarray(jcorr(jnp.asarray(_x(seed=5))))
    with obs.scoped(enabled=True), obs.scoped_registry() as reg:
        run = pc_from_corr(c, M, alpha=0.01, engine=engine, device=CPU)
    with jobs.scoped(enabled=True), jobs.scoped_registry() as jreg:
        jpc_from_corr(c, M, alpha=0.01, engine=engine)
    assert reg.collect() == jreg.collect()
    assert reg.total(obs.DISPATCHES, layout="single") == sum(
        st["dispatches"] for st in run.level_stats)
    assert reg.total(obs.LEVELS) == len(run.level_stats)


def test_pc_scan_batch_global_span(tmp_path):
    """``pc_scan_batch`` opens the module-level span when obs is on."""
    c = np.asarray(jcorr(jnp.asarray(_x(seed=7))))
    path = str(tmp_path / "scan.jsonl")
    with obs.scoped(enabled=True, journal_path=path):
        scan_pc.pc_scan_batch(np.stack([c, c]), M, max_level=2, device=CPU)
    (rec,) = [r for r in obs.read_journal(path) if r.get("name") == "pc_scan_batch"]
    assert rec["attrs"]["batch"] == 2 and rec["attrs"]["n"] == 12
    assert len(rec["attrs"]["schedule"]) == 2


def test_profiler_annotation_wraps_spans():
    """``profiler=True`` names each span's path in a torch.profiler trace."""
    from torch.profiler import ProfilerActivity, profile

    tr = obs.Tracer("p", profiler=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tr.span("outer"):
            with tr.span("inner"):
                torch.ones(4).sum()
    keys = {e.key for e in prof.key_averages()}
    assert {"outer", "outer/inner"} <= keys


# ---------------------------------------------------------------- serving
def _service(**scope):
    from repro_torch.serve import ManualClock, PCService, ServeConfig

    with obs.scoped(**scope):
        return PCService(ServeConfig(slot_size=4), clock=ManualClock(), device=CPU)


def test_service_latency_breakdown_and_counters():
    from repro_torch.serve import Request

    svc = _service()
    svc.submit(Request(rid="r1", x=_x(seed=1), alpha=0.01, max_level=2))
    svc.clock.advance(0.25)
    g = svc.drain().result("r1")
    assert g.queue_wait_s == pytest.approx(0.25)
    assert svc.metrics.value("pc_serve_requests_total", outcome="admitted") == 1
    assert svc.metrics.value("pc_serve_queue_depth") == 0
    assert 'pc_serve_deliveries_total{tier="slot"} 1.0' in svc.metrics_text()


def test_service_journal_serve_records(tmp_path):
    from repro_torch.serve import Request

    path = str(tmp_path / "serve.jsonl")
    svc = _service(enabled=True, journal_path=path)
    svc.submit(Request(rid="r1", x=_x(seed=4), max_level=2))
    svc.drain()
    recs = obs.read_journal(path)
    assert {"admit", "plan", "slot_dispatch", "delivered"} <= {
        r["event"] for r in recs if r["kind"] == "serve"}
    dl = next(r for r in recs if r.get("event") == "delivered")
    for field in ("queue_wait_s", "dispatch_s", "assembly_s", "latency_s"):
        assert field in dl
    assert all(json.dumps(r) for r in recs)


def test_service_outputs_identical_with_obs_on_off(tmp_path):
    from repro_torch.serve import Request

    x = _x(seed=6)
    got = []
    for scope in (dict(enabled=False), dict(enabled=True, journal_path=str(tmp_path / "s.jl"))):
        svc = _service(**scope)
        svc.submit(Request(rid="r", x=x, max_level=2))
        got.append(svc.drain().result("r"))
    for f in ("adj", "cpdag", "sepsets"):
        np.testing.assert_array_equal(getattr(got[0], f), getattr(got[1], f))
    assert got[0].latency_s == got[1].latency_s
