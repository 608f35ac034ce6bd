"""The port's batch subsystem (``repro_torch.batch``) and engine "scan"
against the JAX package's ``repro.batch`` on the same inputs.

The fixtures are tests/test_batch.py's: seeded Gaussian-DAG samples made
with numpy, their correlation matrix computed once by the JAX package and
fed to both. The port runs on the CPU (``device="cpu"``), where its scan
sweeps with the "S" engine's ``levels.chunk_s`` and runs the reference's
dense ℓ = 1 cube op for op. Tolerances:

* scan results (adj, sepsets, cpdag, ok, ok_levels, max_degs) and the
  schedules: bitwise equal to the JAX package's and to the port's own
  "S" engine at the same level cap;
* bootstrap: the replicate correlation matrices to atol 2e-6 (corr's
  contract); the replicate skeletons equal outside the τ ± 1e-4 band (an
  edge may differ only where the port's own runs at τ − 1e-4 and
  τ + 1e-4 disagree), and frequencies, stability skeleton and CPDAG
  equal when no replicate differs;
* the aggregate on the reference's replicates: bitwise;
* discrete scan: bitwise equal to the JAX scan and to the port's "G2".

The ``cuda`` tests need the card and skip without one: a replay of the
recorded CUDA graph bitwise equal to the eager run and to the port's
"S-kernel" engine, and the launch counts a replay adds.
"""
import functools
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.batch import ensemble as jensemble, scan_pc as jscan  # noqa: E402
from repro.core import cit as jcit  # noqa: E402
from repro.core import orient as jorient  # noqa: E402
from repro.core.pc import pc as jpc, pc_from_corr as jpc_from_corr  # noqa: E402
from repro.data.synthetic_dag import sample_gaussian_dag  # noqa: E402
from repro_torch import pc, pc_from_corr  # noqa: E402
from repro_torch.batch import ensemble, scan_pc  # noqa: E402
from repro_torch.core import cit, engines, orient  # noqa: E402
from repro_torch.data import synthetic_dag  # noqa: E402
from repro_torch.kernels import build  # noqa: E402

pytestmark = [pytest.mark.torch, pytest.mark.batch]

CPU = "cpu"
BAND = 1e-4
FIELDS = ("adj", "sepsets", "cpdag", "ok", "max_degs", "ok_levels")


def _corr(n, m, density, seed):
    x, _ = sample_gaussian_dag(n=n, m=m, density=density, seed=seed)
    return np.asarray(jcit.correlation_from_samples(jnp.asarray(x)))


def _assert_scan_equal(port, ref, fields=FIELDS):
    for f in fields:
        np.testing.assert_array_equal(getattr(port, f).numpy(), np.asarray(getattr(ref, f)),
                                      err_msg=f)


def _assert_run_equal(port, ref):
    """A ScanResult (or PCRun) against a PCRun: skeleton, sepsets, CPDAG."""
    for f in ("adj", "sepsets", "cpdag"):
        got = getattr(port, f)
        got = got.numpy() if isinstance(got, torch.Tensor) else got
        np.testing.assert_array_equal(got, getattr(ref, f), err_msg=f)


# ---------------------------------------------------- B=1 parity vs S engine
@pytest.mark.parametrize(
    "n,density,seed", [(15, 0.2, 0), (20, 0.15, 1), (18, 0.3, 3), (25, 0.1, 2)]
)
def test_scan_b1_matches_reference_and_s_engine(n, density, seed):
    """pc_scan equals the JAX pc_scan in every field and the port's "S"
    engine in skeleton, sepsets and CPDAG, bitwise, up to the cap."""
    m = 3000
    c = _corr(n, m, density, seed)
    ref = jscan.pc_scan(jnp.asarray(c), m, alpha=0.01, max_level=3)
    res = scan_pc.pc_scan(c, m, alpha=0.01, max_level=3, device=CPU)
    assert bool(res.ok)
    _assert_scan_equal(res, ref)
    _assert_run_equal(res, pc_from_corr(c, m, alpha=0.01, engine="S", max_level=3, device=CPU))


def test_dense_l1_cube_matches_s_level1():
    """The copied dense ℓ = 1 cube equals one "S" level at ℓ = 1 bitwise
    (the fixtures above run it: their widths make ℓ = 1 dense)."""
    from repro_torch.core import levels as L

    m = 3000
    c = torch.tensor(_corr(15, m, 0.2, 0))
    assert scan_pc._use_dense_l1(15, scan_pc.plan_n_prime(c, m, device=CPU), 2**24)
    adj, sep, _ = L.level0_span(c, cit.threshold(m, 0, 0.01), 8)
    tau1 = cit.threshold(m, 1, 0.01)
    got = scan_pc._level1_dense(c, adj, sep, tau1)
    want = L.run_level(c, adj, sep, 1, tau1, engine="S")[:2]
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# ----------------------------------------------------- batched vs loop parity
def test_scan_batch_matches_loop_s_engine_and_reference():
    m = 2000
    cs = np.stack([_corr(16, m, 0.2, seed) for seed in range(4)])
    schedule = scan_pc.plan_schedule(cs, m, max_level=2, device=CPU)
    assert schedule == jscan.plan_schedule(jnp.asarray(cs), m, max_level=2)
    batch = scan_pc.pc_scan_batch(cs, m, max_level=2, n_prime=schedule, device=CPU)
    assert batch.adj.shape == (4, 16, 16)
    assert bool(batch.ok.all())
    _assert_scan_equal(batch, jscan.pc_scan_batch(jnp.asarray(cs), m, max_level=2,
                                                  n_prime=schedule))
    for b in range(4):
        single = scan_pc.pc_scan(cs[b], m, max_level=2, n_prime=schedule, device=CPU)
        for f in FIELDS:
            assert torch.equal(getattr(batch, f)[b], getattr(single, f)), f
        _assert_run_equal(single, pc_from_corr(cs[b], m, engine="S", max_level=2, device=CPU))


def test_scan_levels_batch_schedule_and_one_program():
    """The level-synced driver finds the reference's schedule, and the
    schedule reproduces its results through pc_scan_batch."""
    m = 2000
    cs = np.stack([_corr(18, m, 0.25, seed + 20) for seed in range(3)])
    res_sync, schedule = scan_pc.scan_levels_batch(cs, m, max_level=3, device=CPU)
    ref_sync, ref_schedule = jscan.scan_levels_batch(jnp.asarray(cs), m, max_level=3)
    assert schedule == ref_schedule and len(schedule) == 3
    _assert_scan_equal(res_sync, ref_sync)
    res_prog = scan_pc.pc_scan_batch(cs, m, max_level=3, n_prime=schedule, device=CPU)
    for f in ("adj", "sepsets", "cpdag"):
        assert torch.equal(getattr(res_sync, f), getattr(res_prog, f)), f
    assert bool(res_prog.ok.all())
    # bucket=False plans exact widths, as the reference's does
    assert scan_pc.plan_schedule(cs, m, max_level=3, bucket=False, device=CPU) == \
        jscan.plan_schedule(jnp.asarray(cs), m, max_level=3, bucket=False)


def test_ok_flags_under_a_narrow_width_match_reference():
    """A too-narrow width flags (not corrupts) the graph, with the
    reference's ok and ok_levels, and the exact rerun is the unconstrained
    run (the retry contract)."""
    m = 2500
    c = _corr(20, m, 0.3, 7)
    capped = scan_pc.pc_scan(c, m, max_level=2, n_prime=2, device=CPU)
    _assert_scan_equal(capped, jscan.pc_scan(jnp.asarray(c), m, max_level=2, n_prime=2))
    assert capped.ok_levels.shape == (2,)
    assert bool(capped.ok) == bool(capped.ok_levels.all()) is False
    exact = scan_pc.pc_scan(c, m, max_level=2, device=CPU)
    assert bool(exact.ok)
    _assert_scan_equal(exact, jscan.pc_scan(jnp.asarray(c), m, max_level=2))


def test_taus_as_data_and_their_errors():
    """Explicit τ vectors reproduce the (m, alpha) run; taus_for equals the
    reference's; a wrong length and a level past the sepset depth raise."""
    m = 2000
    c = _corr(16, m, 0.2, 5)
    taus = scan_pc.taus_for(m, 0.03, 2)
    assert taus == jscan.taus_for(m, 0.03, 2)
    base = scan_pc.pc_scan(c, m, alpha=0.03, max_level=2, device=CPU)
    via_taus = scan_pc.pc_scan(c, m, max_level=2, taus=taus, device=CPU)
    for f in FIELDS:
        assert torch.equal(getattr(base, f), getattr(via_taus, f)), f
    with pytest.raises(ValueError, match="max_level\\+1=3"):
        scan_pc.pc_scan(c, m, max_level=2, taus=taus[:2], device=CPU)
    with pytest.raises(ValueError, match="exceeds sepset_depth"):
        scan_pc.pc_scan(c, m, max_level=4, sepset_depth=3, device=CPU)


@pytest.mark.parametrize("jitter", [1e-3, 5e-2])
def test_scan_jitter_matches_reference_and_s_engine(jitter):
    """A jitter other than the default, which moves this fixture's ℓ ≥ 2
    sepsets: every field equal to the JAX pc_scan at the same jitter, and
    skeleton, sepsets and CPDAG to the port's "S" with the jittered chunk
    as its hook, bitwise."""
    from repro_torch.core import levels as L

    m = 200
    x, _ = sample_gaussian_dag(n=18, m=m, density=0.4, seed=1)
    c = np.asarray(jcit.correlation_from_samples(jnp.asarray(x)))
    res = scan_pc.pc_scan(c, m, max_level=3, jitter=jitter, device=CPU)
    _assert_scan_equal(res, jscan.pc_scan(jnp.asarray(c), m, max_level=3, jitter=jitter))
    hook = functools.partial(L.chunk_s, jitter=jitter)
    _assert_run_equal(res, pc_from_corr(c, m, engine="S", max_level=3, chunk_fn_s=hook,
                                        device=CPU))
    assert not torch.equal(res.sepsets, scan_pc.pc_scan(c, m, max_level=3, device=CPU).sepsets)


def test_mixed_alpha_lanes_match_solo_runs_and_reference():
    m = 2000
    c = _corr(16, m, 0.2, 6)
    alphas = (0.005, 0.05)
    taus = np.asarray([scan_pc.taus_for(m, a, 2) for a in alphas], np.float32)
    npr = scan_pc.plan_n_prime(c, m, alpha=max(alphas), device=CPU)
    res = scan_pc.pc_scan_batch(np.stack([c, c]), m, max_level=2, n_prime=npr, taus=taus,
                                device=CPU)
    _assert_scan_equal(res, jscan.pc_scan_batch(jnp.stack([c, c]), m, max_level=2,
                                                n_prime=npr, taus=taus))
    assert bool(res.ok.all())
    for k, a in enumerate(alphas):
        solo = scan_pc.pc_scan(c, m, alpha=a, max_level=2, device=CPU)
        for f in ("adj", "sepsets", "cpdag"):
            assert torch.equal(getattr(res, f)[k], getattr(solo, f)), (f, a)


def test_alpha_sweep_lanes_match_solo_runs_and_reference():
    m = 2500
    c = _corr(18, m, 0.25, 8)
    alphas = (0.001, 0.01, 0.1)
    res = scan_pc.alpha_sweep(c, m, alphas, max_level=2, device=CPU)
    _assert_scan_equal(res, jscan.alpha_sweep(jnp.asarray(c), m, alphas, max_level=2))
    assert bool(res.ok.all())
    for k, a in enumerate(alphas):
        solo = scan_pc.pc_scan(c, m, alpha=a, max_level=2, device=CPU)
        for f in ("adj", "sepsets", "cpdag"):
            assert torch.equal(getattr(res, f)[k], getattr(solo, f)), (f, a)
    with pytest.raises(ValueError, match="at least one alpha"):
        scan_pc.alpha_sweep(c, m, (), device=CPU)


def test_plan_n_prime_matches_reference_and_bounds_level0():
    from repro_torch.core import levels as L

    m = 2000
    cs = np.stack([_corr(16, m, 0.25, seed) for seed in range(3)])
    npr = scan_pc.plan_n_prime(cs, m, device=CPU)
    assert npr == jscan.plan_n_prime(jnp.asarray(cs), m)
    tau0 = cit.threshold(m, 0, 0.01)
    degs = [int(L.max_degree(L.level0(torch.tensor(c), tau0))) for c in cs]
    assert max(degs) <= npr <= 16
    # per-lane level-0 thresholds, as alpha sweeps plan them
    tau_b = np.asarray([cit.threshold(m, 0, a) for a in (0.001, 0.01, 0.2)], np.float32)
    assert scan_pc.plan_n_prime(cs, m, tau0=tau_b, device=CPU) == \
        jscan.plan_n_prime(jnp.asarray(cs), m, tau0=tau_b)


def test_mesh_runs_equal_mesh_none():
    """Every batch entry with ``mesh=`` (3 CPU shards, B = 5: one identity
    pad lane) is bitwise its ``mesh=None`` run; the bootstrap's replicate
    axis (n_boot = 7) too."""
    from repro_torch.core.sharding import make_mesh

    mesh = make_mesh(3, device=CPU)
    m = 1500
    cs = np.stack([_corr(16, m, 0.2, seed) for seed in range(5)])
    calls = {
        "pc_scan_batch": lambda **kw: scan_pc.pc_scan_batch(cs, m, max_level=3, **kw),
        "scan_levels_batch": lambda **kw: scan_pc.scan_levels_batch(cs, m, max_level=3, **kw)[0],
        "alpha_sweep": lambda **kw: scan_pc.alpha_sweep(cs[0], m, (0.001, 0.01, 0.05, 0.1),
                                                        **kw),
        "batch_run": lambda **kw: engines.batch_run(cs, m, level_sync=True, max_level=2, **kw)[0],
    }
    for call in calls.values():
        _assert_scan_equal(call(mesh=mesh), call(device=CPU))
    x, _ = sample_gaussian_dag(n=14, m=1000, density=0.15, seed=2)
    one = ensemble.bootstrap_pc(x, n_boot=7, max_level=2, seed=0, device=CPU)
    sharded = ensemble.bootstrap_pc(x, n_boot=7, max_level=2, seed=0, mesh=mesh)
    for f in ("edge_freq", "adj", "cpdag", "replicate_adj", "replicate_ok"):
        np.testing.assert_array_equal(getattr(sharded, f), getattr(one, f), err_msg=f)
    assert sharded.schedule == one.schedule


# ----------------------------------------------------------- orientation
def test_cpdag_from_membership_matches_reference():
    """On random skeletons with random separator sets."""
    rng = np.random.default_rng(0)
    for n in (7, 12, 20):
        a = np.triu(rng.random((n, n)) < 0.35, 1)
        adj = a | a.T
        member = rng.random((n, n, n)) < 0.3
        member &= np.swapaxes(member, 0, 1)
        got = orient.cpdag_from_membership(torch.tensor(adj), torch.tensor(member))
        want = jorient.cpdag_from_membership(jnp.asarray(adj), jnp.asarray(member))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------------ ensemble
def _jax_draws(seed, n_boot, m):
    """The reference's resample indices: split(PRNGKey(seed), B), then
    randint(k, (m,), 0, m) a replicate (ensemble.py:69-73)."""
    keys = jax.random.split(jax.random.PRNGKey(seed), n_boot)
    return keys, np.stack([np.asarray(jax.random.randint(k, (m,), 0, m)) for k in keys])


def test_aggregate_matches_reference_and_any_vote_chunking():
    x, _ = sample_gaussian_dag(n=13, m=900, density=0.2, seed=6)
    keys, _ = _jax_draws(3, 7, 900)
    cs = jensemble.bootstrap_corr(x, keys, corr="jnp")
    res, _ = jscan.scan_levels_batch(cs, x.shape[0], max_level=2, orient=False)
    ref = [np.asarray(o) for o in jensemble._aggregate(res.adj, res.sepsets, 0.5)]
    adj_b = torch.tensor(np.asarray(res.adj))
    sep_b = torch.tensor(np.asarray(res.sepsets))
    for chunk in (None, 1, 2, 3, 7, 64):
        got = ensemble._aggregate(adj_b, sep_b, 0.5, vote_chunk=chunk)
        for r, g in zip(ref, got):
            np.testing.assert_array_equal(g.numpy(), r)
    for b, n in ((32, 100), (32, 1000), (32, 500), (5, 13)):
        assert ensemble._vote_chunk(b, n) == jensemble._vote_chunk(b, n)
    assert ensemble.AGG_MEMBERSHIP_BUDGET == jensemble.AGG_MEMBERSHIP_BUDGET


def test_bootstrap_pc_fed_the_reference_draws():
    m, b = 1000, 8
    x, _ = sample_gaussian_dag(n=14, m=m, density=0.15, seed=2)
    keys, idx = _jax_draws(0, b, m)
    cs = ensemble.bootstrap_corr(x, idx, corr="plain")
    ref_cs = np.asarray(jensemble.bootstrap_corr(x, keys, corr="jnp"))
    np.testing.assert_allclose(cs.numpy(), ref_cs, rtol=0, atol=2e-6)
    np.testing.assert_allclose(ensemble.bootstrap_corr(x, idx, corr="kernel").numpy(), ref_cs,
                               rtol=0, atol=2e-6)

    ref = jensemble.bootstrap_pc(x, n_boot=b, alpha=0.01, max_level=2, seed=0)
    run = ensemble.bootstrap_pc(x, n_boot=b, alpha=0.01, max_level=2, indices=idx, device=CPU)
    assert run.schedule == ref.schedule
    assert set(run.timings_s) == {"total", "bootstrap_corr", "scan_levels_batch", "aggregate"}
    # a replicate edge may differ only where the decision moves within the band
    taus = np.asarray(scan_pc.taus_for(m, 0.01, 2), np.float32)
    lo, hi = (scan_pc.scan_levels_batch(cs, m, max_level=2, taus=taus + d, device=CPU)[0].adj
              for d in (-BAND, BAND))
    diff = run.replicate_adj != ref.replicate_adj
    assert not (diff & ~(lo != hi).numpy()).any()
    if not diff.any():
        for f in ("edge_freq", "adj", "cpdag", "replicate_ok"):
            np.testing.assert_array_equal(getattr(run, f), getattr(ref, f), err_msg=f)
    with pytest.raises(ValueError, match="auto\\|kernel\\|plain"):
        ensemble.bootstrap_corr(x, idx, corr="jnp")


def test_bootstrap_pc_invariants_and_seeded_reproducibility():
    x, _ = sample_gaussian_dag(n=14, m=1000, density=0.15, seed=2)
    n = 14
    run = ensemble.bootstrap_pc(x, n_boot=8, alpha=0.01, max_level=2, seed=0, device=CPU)
    assert run.replicate_adj.shape == (8, n, n)
    assert run.replicate_ok.shape == (8,) and run.replicate_ok.all()
    np.testing.assert_array_equal(run.edge_freq, run.edge_freq.T)
    expect = (run.edge_freq >= run.stability_threshold) & ~np.eye(n, dtype=bool)
    np.testing.assert_array_equal(run.adj, expect)
    np.testing.assert_array_equal(run.cpdag | run.cpdag.T, run.adj)
    # the mean as the reference forms it: the f32 count times the f32 1/B
    np.testing.assert_array_equal(
        run.edge_freq, run.replicate_adj.sum(axis=0).astype(np.float32) * np.float32(1 / 8))
    # same seed, same result; a caller's generator seeded alike draws alike
    again = ensemble.bootstrap_pc(x, n_boot=8, alpha=0.01, max_level=2, seed=0, device=CPU)
    gen = ensemble.bootstrap_pc(x, n_boot=8, alpha=0.01, max_level=2, device=CPU,
                                generator=torch.Generator().manual_seed(0))
    for other in (again, gen):
        np.testing.assert_array_equal(run.replicate_adj, other.replicate_adj)
        np.testing.assert_array_equal(run.cpdag, other.cpdag)
    other = ensemble.bootstrap_pc(x, n_boot=8, alpha=0.01, max_level=2, seed=1, device=CPU)
    assert not np.array_equal(run.replicate_adj, other.replicate_adj)
    # a planned width runs the one-program path with the same replicates
    planned = ensemble.bootstrap_pc(x, n_boot=8, alpha=0.01, max_level=2, seed=0,
                                    n_prime=run.schedule, device=CPU)
    np.testing.assert_array_equal(planned.replicate_adj, run.replicate_adj)
    assert "pc_scan_batch" in planned.timings_s
    with pytest.warns(UserWarning, match="degree-capped"):
        ensemble.bootstrap_pc(x, n_boot=4, max_level=2, seed=0, n_prime=1, device=CPU)
    with pytest.raises(ValueError, match="indices must be"):
        ensemble.bootstrap_pc(x, n_boot=4, indices=np.zeros((3, 1000), np.int64), device=CPU)


# ---------------------------------------------------- the "scan" engine
def test_scan_engine_matches_reference_through_pc_and_pc_from_corr():
    """levels_run, level_stats and results equal the JAX "scan" engine's
    and the port's "S" at the same cap; the DEFAULT_MAX_LEVEL warning."""
    m = 2500
    c = _corr(16, m, 0.2, 5)
    run = pc_from_corr(c, m, engine="scan", max_level=3, device=CPU)
    ref = jpc_from_corr(jnp.asarray(c), m, engine="scan", max_level=3)
    _assert_run_equal(run, ref)
    assert run.levels_run == ref.levels_run
    assert run.level_stats == ref.level_stats
    assert all(st["engine"] == "scan" for st in run.level_stats)
    s_run = pc_from_corr(c, m, engine="S", max_level=3, device=CPU)
    _assert_run_equal(run, s_run)
    assert run.levels_run == s_run.levels_run
    assert run.sepset_dict() == s_run.sepset_dict()
    assert "scan" in run.timings_s

    x, _ = sample_gaussian_dag(n=14, m=2000, density=0.2, seed=6)
    run_x = pc(x, engine="scan", max_level=2, device=CPU)
    ref_x = jpc(x, engine="scan", max_level=2)
    _assert_run_equal(run_x, ref_x)
    assert run_x.level_stats == ref_x.level_stats

    with pytest.warns(UserWarning, match="STATIC level cap of 3"):
        deflt = pc_from_corr(c, m, engine="SCAN", device=CPU)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref_d = jpc_from_corr(jnp.asarray(c), m, engine="scan")
    assert deflt.level_stats == ref_d.level_stats
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        pc_from_corr(c, m, engine="scan", sepset_depth=3, device=CPU)  # depth ≤ cap: silent


def test_scan_engine_registry_and_batch_run():
    assert engines.is_whole_run("scan") and engines.is_whole_run("SCAN")
    assert not engines.is_whole_run("S") and not engines.is_whole_run(lambda ell: "scan")
    assert engines.ENGINE_NAMES == ("S", "E", "S-kernel", "S-grid", "L1-dense", "auto", "scan",
                                    "G2", "G2-kernel")
    assert engines.WHOLE_RUN_ENGINES == ("scan",)
    assert not hasattr(engines, "NOT_PORTED")
    for test in (None, cit.DiscreteCITest(m=200, r=3)):
        with pytest.raises(ValueError, match="whole-run engine"):
            engines.resolve("scan", 1, test)
    m = 2000
    cs = np.stack([_corr(16, m, 0.2, seed) for seed in range(3)])
    synced, schedule = engines.batch_run(cs, m, level_sync=True, max_level=2, device=CPU)
    one = engines.batch_run(cs, m, n_prime=schedule, max_level=2, device=CPU)
    for f in ("adj", "sepsets", "cpdag"):
        assert torch.equal(getattr(synced, f), getattr(one, f)), f
    _assert_scan_equal(one, jscan.pc_scan_batch(jnp.asarray(cs), m, max_level=2,
                                                n_prime=schedule))


def _discrete_x(n, m, seed, arity=3, density=0.35):
    """tests/test_cit.py's fixture maker."""
    x, _ = synthetic_dag.sample_discrete_dag(n=n, m=m, density=density, arity=arity, seed=seed)
    for k in range(n):
        if len(np.unique(x[:, k])) < 2:
            x[0, k] = (x[1, k] + 1) % arity
    return x


def test_scan_discrete_matches_reference_and_g2_host_loop():
    """tests/test_cit.py:171's fixture: the discrete scan equals the JAX
    scan (level stats too) and the port's "G2" host loop, bitwise; the
    default cap is the scan's."""
    x = _discrete_x(9, 260, seed=7)
    run = pc(x, alpha=0.05, test="discrete", engine="scan", max_level=2, device=CPU)
    ref = jpc(x, alpha=0.05, test="discrete", engine="scan", max_level=2)
    _assert_run_equal(run, ref)
    assert run.levels_run == ref.levels_run and run.level_stats == ref.level_stats
    host = pc(x, alpha=0.05, test="discrete", engine="G2", max_level=2, device=CPU)
    _assert_run_equal(run, host)
    deflt = pc(x, alpha=0.05, test="discrete", engine="scan", device=CPU)
    assert deflt.level_stats == jpc(x, alpha=0.05, test="discrete", engine="scan").level_stats
    assert deflt.level_stats[-1]["max_level_static"] == scan_pc.DEFAULT_MAX_LEVEL

    test, stats = cit.DiscreteCITest.from_samples(x, alpha=0.05)
    direct = scan_pc.pc_scan(stats, test.m, max_level=2, test=test, device=CPU)
    _assert_run_equal(direct, host)
    assert bool(direct.ok)
    with pytest.raises(NotImplementedError, match="Gaussian-only"):
        scan_pc.pc_scan_batch(np.zeros((2, 4, 4), np.float32), 100,
                              test=cit.DiscreteCITest(m=100), device=CPU)


# ----------------------------------------------------------------- the card
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_scan_batch_replays_one_graph_equal_to_s_kernel():
    """pc_scan_batch records one CUDA graph (its first replay is checked
    bitwise against the eager run) and replays it: a second call equals
    the first and every lane equals the port's "S-kernel" engine at the
    same cap, bitwise; the replay adds the recorded launches."""
    from repro_torch.batch import capture

    dev = _card()
    m, n, b = 3000, 64, 4
    cs = np.stack([_corr(n, m, 0.08, seed) for seed in range(b)])
    schedule = scan_pc.plan_schedule(cs, m, max_level=3, device=dev)
    capture.clear()
    first = scan_pc.pc_scan_batch(cs, m, max_level=3, n_prime=schedule, orient=False,
                                  device=dev)
    (prog,) = capture.programs()
    build.reset_launches()
    again = scan_pc.pc_scan_batch(cs, m, max_level=3, n_prime=schedule, orient=False,
                                  device=dev)
    assert build.LAUNCHES == {k: prog.launches.get(k, 0) for k in build.LAUNCHES}
    assert build.LAUNCHES["level0"] == b and build.LAUNCHES["skernel"] > 0
    assert len(capture.programs()) == 1
    for f in FIELDS:
        assert torch.equal(getattr(first, f), getattr(again, f)), f
    assert bool(first.ok.all())
    for k in range(b):
        ref = pc_from_corr(cs[k], m, engine="S-kernel", max_level=3, orient=False, device=dev)
        np.testing.assert_array_equal(first.adj[k].cpu().numpy(), ref.adj)
        np.testing.assert_array_equal(first.sepsets[k].cpu().numpy(), ref.sepsets)


@pytest.mark.cuda
def test_cuda_scan_levels_batch_equals_one_program_and_pc_scan_auto():
    """The per-level graphs give the one-program results; a single graph
    whose ℓ = 1 runs dense equals the port's "auto" bitwise."""
    dev = _card()
    m = 2000
    cs = np.stack([_corr(18, m, 0.25, seed + 20) for seed in range(3)])
    synced, schedule = scan_pc.scan_levels_batch(cs, m, max_level=3, device=dev)
    prog = scan_pc.pc_scan_batch(cs, m, max_level=3, n_prime=schedule, device=dev)
    for f in ("adj", "sepsets", "cpdag"):
        assert torch.equal(getattr(synced, f), getattr(prog, f)), f
    c = _corr(15, 3000, 0.2, 0)
    assert scan_pc._use_dense_l1(15, scan_pc.plan_n_prime(c, 3000, device=dev), 2**24)
    build.reset_launches()
    res = scan_pc.pc_scan(c, 3000, max_level=3, device=dev)
    assert build.LAUNCHES["level1"] >= 1
    ref = pc_from_corr(c, 3000, engine="auto", max_level=3, device=dev)
    np.testing.assert_array_equal(res.adj.cpu().numpy(), ref.adj)
    np.testing.assert_array_equal(res.sepsets.cpu().numpy(), ref.sepsets)
    np.testing.assert_array_equal(res.cpdag.cpu().numpy(), ref.cpdag)


@pytest.mark.cuda
def test_cuda_program_cut_into_graphs_and_the_node_bound(monkeypatch):
    """A program recorded as many graphs (cut at step boundaries past
    capture.SEGMENT_NODES) gives the one-graph results and launch counts
    bitwise; a graph with more nodes than capture.MAX_NODES is refused
    before it is instantiated, and nothing is cached."""
    from repro_torch.batch import capture

    dev = _card()
    m, n = 3000, 64
    c = _corr(n, m, 0.08, 1)
    kw = dict(max_level=3, n_prime=16, cell_budget=2**16, orient=False, device=dev)
    capture.clear()
    whole = scan_pc.pc_scan(c, m, **kw)
    (one,) = capture.programs()
    assert len(one.nodes) <= 2 and 0 < max(one.nodes) <= capture.MAX_NODES
    capture.clear()
    monkeypatch.setattr(capture, "SEGMENT_NODES", 100)
    cut = scan_pc.pc_scan(c, m, **kw)
    (many,) = capture.programs()
    assert len(many.nodes) > 3
    assert many.launches == one.launches
    build.reset_launches()
    again = scan_pc.pc_scan(c, m, **kw)
    assert build.LAUNCHES == one.launches
    for res in (cut, again):
        for f in FIELDS:
            assert torch.equal(getattr(whole, f), getattr(res, f)), f
    capture.clear()
    monkeypatch.setattr(capture, "SEGMENT_NODES", 10**9)
    monkeypatch.setattr(capture, "MAX_NODES", max(one.nodes) - 1)
    with pytest.raises(capture.GraphTooLarge, match="MAX_NODES"):
        scan_pc.pc_scan(c, m, **kw)
    assert capture.programs() == []
