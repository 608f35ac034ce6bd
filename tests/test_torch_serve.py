"""The port's serving layer (``repro_torch.serve``) against the JAX
package's ``repro.serve`` on the same requests.

Every scenario of tests/test_serve.py but the sharded one runs through
both services on a ManualClock with the same FaultPlan and the same
Requests; the port runs on the CPU (``device="cpu"``), three of them
also with its slots sharded over two CPU shards (``ServeConfig(mesh=)``;
the sharded scenario itself is in tests/test_torch_sharding.py). Both services
build C from the samples the same way: the port's admission is handed
the JAX package's ``correlation_from_samples`` (the two frameworks' fp32
matmuls round differently in the last bits, and a bit of C may move a
decision in the τ band); ``test_port_admission_correlation`` holds the
port's own C to it at atol 2e-6 and runs the port unpatched. Given the
same C, the reports must be equal:

* rejections (rid, code) and dead letters (rid, lane, code, stage,
  attempts);
* per delivered lane: tier, attempts, ``exact``, α and the four latency
  fields (virtual time makes them exact);
* the event list, arrays by value;
* adj, cpdag and sepsets, bitwise (the port's CPU scan is bitwise the JAX
  scan: tests/test_torch_batch.py);
* ``metrics_text()``, byte for byte.
"""
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.serve as jserve  # noqa: E402
import repro_torch.serve as tserve  # noqa: E402
from repro.core import stable_ref as jstable  # noqa: E402
from repro.core.cit import correlation_from_samples as jcorr  # noqa: E402
from repro.data.synthetic_dag import sample_gaussian_dag  # noqa: E402
from repro_torch.batch import scan_pc  # noqa: E402
from repro_torch.core import stable_ref  # noqa: E402
from repro_torch.serve import admission  # noqa: E402

pytestmark = [pytest.mark.torch, pytest.mark.serve]

M = 400
CPU = "cpu"


def _x(n, seed, m=M):
    x, _ = sample_gaussian_dag(n=n, m=m, density=0.12, seed=seed)
    return np.asarray(x, np.float32)


def _jax_c(x):
    return np.asarray(jcorr(jnp.asarray(np.asarray(x, np.float32))))


@pytest.fixture
def same_c(monkeypatch):
    """The port's admission builds C with the JAX package's function."""
    monkeypatch.setattr(admission, "sample_correlation", lambda x, device: _jax_c(x))


def _maker(pkg):
    """mk(faults=None, policy=None, **cfg) → a service of ``pkg`` on a
    ManualClock, as tests/test_serve.py's ``_svc`` builds it."""
    port = pkg is tserve

    def mk(faults=None, policy=None, backoff=True, **cfg):
        if backoff:
            cfg.setdefault("backoff_s", 0.01)
        kw = {"clock": pkg.ManualClock()}
        if faults is not None:
            kw["faults"] = pkg.FaultPlan(**faults)
        if policy is not None:
            kw["policy"] = pkg.AdmissionPolicy(**policy)
        if port:
            kw["device"] = CPU
        return pkg.PCService(pkg.ServeConfig(**cfg), **kw)

    return mk


# ------------------------------------------------------------- scenarios
# each takes (package, service maker) and returns the drained service
def sc_invalid_requests(S, mk):
    svc = mk()
    good = _x(12, 1)
    nan = good.copy()
    nan[3, 4] = np.nan
    const = good.copy()
    const[:, 2] = 1.0
    svc.submit(S.Request(rid="good", x=good))
    svc.submit(S.Request(rid="nan", x=nan))
    svc.submit(S.Request(rid="const", x=const))
    svc.submit(S.Request(rid="thin", x=_x(12, 2, m=10), max_level=1))
    bad_c = _jax_c(good).copy()
    bad_c[0, 1] += 0.1
    svc.submit(S.Request(rid="asym", c=bad_c, m=M))
    svc.submit(S.Request(rid="no_m", c=np.eye(12, dtype=np.float32)))
    svc.drain()
    assert {r.code for r in svc.report.rejections.values()} == {
        "non_finite", "constant_column", "rank_deficient", "bad_correlation", "invalid"}
    return svc


def sc_duplicate_rid(S, mk):
    svc = mk()
    svc.submit(S.Request(rid="r", x=_x(10, 1)))
    rej = svc.submit(S.Request(rid="r", x=_x(10, 2)))
    assert isinstance(rej, S.Rejection) and rej.code == "duplicate"
    svc.drain()
    return svc


def sc_quarantine(S, mk):
    svc = mk(policy=dict(quarantine=True), backoff=False)
    bad = _x(10, 1)
    bad[0, 0] = np.inf
    svc.submit(S.Request(rid="q", x=bad))
    assert [r.rid for r in svc.queue.quarantined] == ["q"]
    svc.drain()
    return svc


def sc_bucketing(S, mk):
    svc = mk()
    svc.submit(S.Request(rid="a", x=_x(10, 1)))
    svc.submit(S.Request(rid="b", x=_x(10, 1)))
    svc.submit(S.Request(rid="c", x=_x(14, 2)))
    assert {k.n for k in svc.queue.buckets} == {10, 14}
    svc.drain()
    return svc


def sc_forced_cert_miss(S, mk):
    x = _x(12, 3)
    svc = mk(faults=dict(cert_miss={"miss": 1}))
    svc.submit(S.Request(rid="miss", x=x))
    svc.submit(S.Request(rid="mate", x=x))
    svc.drain()
    assert svc.report.result("miss").tier == S.TIER_WIDER
    return svc


def sc_natural_cert_miss(S, mk):
    svc = mk()
    lanes = svc.submit(S.Request(rid="n", x=_x(14, 4)))
    svc._schedules[lanes[0].key] = (1, 1)  # width 1 cannot bound level 1
    svc.drain()
    assert any(e["event"] == "cert_miss" for e in svc.report.events)
    return svc


def sc_exhausted_ladder(S, mk):
    svc = mk(faults=dict(cert_miss={"x": 99}), widen_attempts=1)
    svc.submit(S.Request(rid="x", x=_x(10, 5)))
    svc.drain()
    assert svc.report.dead_letters[0].code == "retries_exhausted"
    return svc


def sc_degrade_to_stable_ref(S, mk):
    svc = mk(faults=dict(cert_miss={"d": 3}), widen_attempts=1)
    svc.submit(S.Request(rid="d", x=_x(10, 6)))
    svc.drain()
    assert svc.report.result("d").tier == S.TIER_STABLE
    return svc


def sc_jitter_ladder(S, mk):
    svc = mk(faults=dict(cert_miss={"j": 2}), jitter_ladder=(1e-8, 1e-6, 1e-4),
             widen_attempts=2)
    svc.submit(S.Request(rid="j", x=_x(10, 7)))
    svc.drain()
    return svc


def sc_deadline_in_queue(S, mk):
    svc = mk()
    svc.submit(S.Request(rid="late", x=_x(10, 8), timeout_s=5.0))
    svc.clock.advance(10.0)
    svc.drain()
    return svc


def sc_deadline_during_slot(S, mk):
    x = _x(12, 9)
    svc = mk(faults=dict(slot_delay={"late": 10.0}))
    svc.submit(S.Request(rid="late", x=x, timeout_s=5.0))
    svc.submit(S.Request(rid="mate", x=x, timeout_s=60.0))
    svc.drain()
    return svc


def sc_transient_corruption(S, mk):
    svc = mk(faults=dict(corrupt_nan={"p": 1}))
    svc.submit(S.Request(rid="p", x=_x(10, 10)))
    svc.drain()
    return svc


def sc_persistent_corruption(S, mk):
    svc = mk(faults=dict(corrupt_nan={"p": 99}), widen_attempts=0)
    svc.submit(S.Request(rid="p", x=_x(10, 10)))
    svc.drain()
    return svc


def sc_alpha_sweep(S, mk):
    svc = mk()
    svc.submit(S.Request(rid="sw", x=_x(12, 11), alphas=(0.001, 0.01, 0.05)))
    assert len(svc.queue.buckets) == 1
    svc.drain()
    assert svc.report.steps == 1
    return svc


SCENARIOS = [sc_invalid_requests, sc_duplicate_rid, sc_quarantine, sc_bucketing,
             sc_forced_cert_miss, sc_natural_cert_miss, sc_exhausted_ladder,
             sc_degrade_to_stable_ref, sc_jitter_ladder, sc_deadline_in_queue,
             sc_deadline_during_slot, sc_transient_corruption, sc_persistent_corruption,
             sc_alpha_sweep]


# ------------------------------------------------------------ comparison
def _plain(v):
    """Events' values as comparable Python data (arrays by value)."""
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (tuple, list)):
        return [_plain(x) for x in v]
    if isinstance(v, (np.ndarray, np.generic)):
        return np.asarray(v).tolist()
    return v


def _assert_reports_equal(port, ref):
    p, r = port.report, ref.report
    assert {k: v.code for k, v in p.rejections.items()} == \
        {k: v.code for k, v in r.rejections.items()}
    dead = [(d.rid, d.lane, d.code, d.stage, d.attempts)
            for d in r.dead_letters]
    assert [(d.rid, d.lane, d.code, d.stage, d.attempts) for d in p.dead_letters] == dead
    assert p.steps == r.steps
    assert {k: sorted(v) for k, v in p.delivered.items()} == \
        {k: sorted(v) for k, v in r.delivered.items()}
    for rid, lanes in r.delivered.items():
        for lane, want in lanes.items():
            got = p.delivered[rid][lane]
            for f in ("tier", "attempts", "exact", "alpha", "latency_s", "queue_wait_s",
                      "dispatch_s", "assembly_s"):
                assert getattr(got, f) == getattr(want, f), (rid, lane, f)
            for f in ("adj", "cpdag", "sepsets"):
                np.testing.assert_array_equal(getattr(got, f), np.asarray(getattr(want, f)),
                                              err_msg=f"{rid}/{lane} {f}")
    assert _plain(p.events) == _plain(r.events)
    assert port.metrics_text() == ref.metrics_text()


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__[3:])
def test_service_matches_reference(scenario, same_c):
    ref = scenario(jserve, _maker(jserve))
    port = scenario(tserve, _maker(tserve))
    _assert_reports_equal(port, ref)


# -------------------------------------------------------- beside the scenarios
def test_port_admission_correlation():
    """Unpatched, the port builds C with its own plain version: within
    2e-6 of the JAX package's, and a delivered graph equals the port's
    solo pc_scan on the lane's own C, bitwise (co-tenancy never changes an
    answer)."""
    x = _x(12, 3)
    svc = _maker(tserve)()
    (lane,) = svc.submit(tserve.Request(rid="a", x=x))
    svc.submit(tserve.Request(rid="b", x=_x(12, 4)))
    np.testing.assert_allclose(lane.c, _jax_c(x), rtol=0, atol=2e-6)
    rep = svc.drain()
    solo = scan_pc.pc_scan(lane.c, M, alpha=0.01, max_level=3, device=CPU)
    g = rep.result("a")
    for f in ("adj", "cpdag", "sepsets"):
        np.testing.assert_array_equal(getattr(g, f), getattr(solo, f).numpy(), err_msg=f)


@pytest.mark.parametrize("scenario", [sc_forced_cert_miss, sc_deadline_during_slot,
                                      sc_alpha_sweep], ids=lambda f: f.__name__[3:])
def test_sharded_service_matches_reference(scenario, same_c):
    """``ServeConfig(mesh=)``: slots sharded over 2 CPU shards give the
    reference's unsharded report (graphs bitwise, events, latencies and
    metrics text equal)."""
    from repro_torch.core.sharding import make_mesh

    mk = _maker(tserve)
    mesh = make_mesh(2, device=CPU)
    port = scenario(tserve, lambda **kw: mk(mesh=mesh, **kw))
    _assert_reports_equal(port, scenario(jserve, _maker(jserve)))


def test_service_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.PCService()


@pytest.mark.parametrize("n,seed,max_level", [(10, 6, None), (14, 21, 2)])
def test_stable_skeleton_matches_reference(n, seed, max_level):
    """The Gaussian float64 oracle, the service's bottom rung: adjacency,
    sepsets, ci_tests and max_level equal to the JAX package's."""
    c = _jax_c(_x(n, seed)).astype(np.float64)
    got = stable_ref.pc_stable_skeleton(c, M, alpha=0.01, max_level=max_level)
    want = jstable.pc_stable_skeleton(c, M, alpha=0.01, max_level=max_level)
    np.testing.assert_array_equal(got.adj, want.adj)
    assert got.sepsets == want.sepsets
    assert (got.ci_tests, got.max_level) == (want.ci_tests, want.max_level)


@settings(max_examples=2, deadline=None)
@given(st.data())
def test_property_bucketed_slots_match_reference(data):
    """tests/test_serve.py's property, through both services: a random
    mix of shapes, alphas, a forced certificate miss and a deadline
    expiry gives equal reports, and every lane ends as exactly one typed
    outcome."""
    n_req = data.draw(st.integers(2, 4), label="n_req")
    ns = [10, 12, 14]
    reqs = []
    for i in range(n_req):
        n = ns[data.draw(st.integers(0, 2), label=f"n{i}")]
        alpha = (0.005, 0.01, 0.05)[data.draw(st.integers(0, 2), label=f"a{i}")]
        reqs.append((f"r{i}", _x(n, 40 + i), alpha))
    miss_rid = f"r{data.draw(st.integers(0, n_req - 1), label='miss')}"
    expire = data.draw(st.integers(0, 1), label="expire") == 1
    faults = dict(cert_miss={miss_rid: 1}, slot_delay={})
    expired_rid = None
    if expire and n_req > 1:
        expired_rid = next(r for r, _, _ in reqs if r != miss_rid)
        faults["slot_delay"][expired_rid] = 10.0

    def scenario(S, mk):
        svc = mk(faults=faults)
        for rid, x, alpha in reqs:
            svc.submit(S.Request(rid=rid, x=x, alpha=alpha,
                                 timeout_s=5.0 if rid == expired_rid else 1e6))
        svc.drain()
        return svc

    ref = scenario(jserve, _maker(jserve))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(admission, "sample_correlation", lambda x, device: _jax_c(x))
        port = scenario(tserve, _maker(tserve))
    _assert_reports_equal(port, ref)
    rep = port.report
    outcomes = {rid: ("delivered" if rid in rep.delivered else None) for rid, _, _ in reqs}
    for dl in rep.dead_letters:
        assert outcomes[dl.rid] is None, "lane delivered AND dead-lettered"
        outcomes[dl.rid] = "dead"
    assert all(outcomes.values()), f"unaccounted lanes: {outcomes}"
    if expired_rid is not None:
        assert outcomes[expired_rid] == "dead"
