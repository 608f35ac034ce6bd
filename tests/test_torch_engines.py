"""The port's "S", "E" and "S-grid" engines and the pipelined "S" worklist
against the JAX package on the same inputs.

Module by module: ``_inv_spd`` elementwise (exact at ℓ = 2, rtol 1e-5 and
atol 1e-6 above, where both sides take an LU inverse of their own);
``ci_sweep`` decisions equal outside τ ± 1e-4 (tests/test_kernels.py:
102-108's band); ``chunk_e`` and ``chunk_s_tests`` exactly; ``plan_level``
with its engine and bucket switches exactly.

End to end, on the fixtures of tests/test_engines.py's
``test_grid_engine_bit_parity`` (n = 15 and 18), ``test_grid_engine_
multi_launch_parity`` (n = 22, cell_budget 2^10) and ``test_engine_matrix_
gaussian_citest_bit_identity`` (n = 20, through an explicit
GaussianCITest): every port engine gives JAX "S"'s skeleton; "S",
"S-grid" and the pipelined "S" also its sepsets and CPDAG. "E" ranks the
sets of a row without the target slot, so where several sets separate an
edge its least-rank winner can be another set than "S"'s; the port's "E"
is held to JAX's "E" in sepsets and CPDAG instead (on the n = 18 fixture
the two JAX engines record different sepsets). The per-level stats
(engine, chunks, dispatches, n_chunk, npr_bucket, …) equal those of the
JAX run of the same engine and depth. The pipelined JAX runs are made on
the n = 22 fixture, the one whose levels take several chunks, so that the
tests run ahead of the commits; on the single-chunk fixtures the port's
pipelined stats are held to JAX "S"'s, with two dispatches a chunk and
the depth recorded (the reference's ``run_level`` contract). The JAX
"S-grid" stats come from its own level dispatch (``engines.run_level``:
budget raise, plan, launch loop) with ``chunk_fn_s=levels.chunk_s`` in
the launch slot, which the reference's tests hold bit-identical to its
sgrid launches; the stats do not depend on the chunk function, and
interpret-mode sgrid would cost minutes here (tests/test_torch_sgrid.py
holds the sgrid math to it instead).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import levels as jlevels  # noqa: E402
from repro.core.cit import correlation_from_samples, threshold as jthreshold  # noqa: E402
from repro.core.compact import compact_rows as jcompact_rows  # noqa: E402
from repro.core.pc import pc_from_corr as jpc_from_corr  # noqa: E402
from repro.data.synthetic_dag import sample_gaussian_dag  # noqa: E402
from repro_torch import pc_from_corr  # noqa: E402
from repro_torch.core import levels as L  # noqa: E402
from repro_torch.core.cit import GaussianCITest  # noqa: E402

pytestmark = pytest.mark.torch

BAND = 1e-4
FIXTURES = {
    "grid15": dict(n=15, density=0.2, alpha=0.01, seed=0, m=3000),
    "grid18": dict(n=18, density=0.3, alpha=0.05, seed=3, m=3000),
    "multi22": dict(n=22, density=0.25, alpha=0.01, seed=9, m=2000, cell_budget=2**10),
    "matrix20": dict(n=20, density=0.25, alpha=0.01, seed=9, m=2500),
}
CASES = {
    "S": dict(engine="S"),
    "E": dict(engine="E"),
    "S-grid": dict(engine="S-grid"),
    "S-depth2": dict(engine="S", pipeline_depth=2),
    "S-depth3": dict(engine="S", pipeline_depth=3),
}
STAT_KEYS = ("level", "engine", "skipped", "chunks", "dispatches", "n_chunk", "npr",
             "npr_bucket", "total_sets", "compile_key", "pipeline_depth")


@functools.lru_cache(maxsize=None)
def corr(name):
    f = FIXTURES[name]
    x, _ = sample_gaussian_dag(n=f["n"], m=f["m"], density=f["density"], seed=f["seed"])
    return np.array(correlation_from_samples(jnp.asarray(x)))


def _call_kw(name):
    f = FIXTURES[name]
    kw = dict(alpha=f["alpha"])
    if "cell_budget" in f:
        kw["cell_budget"] = f["cell_budget"]
    return kw


@functools.lru_cache(maxsize=None)
def jax_run(name, case):
    """The JAX run of one case on one fixture, computed once per module."""
    kw = dict(CASES[case], **_call_kw(name))
    if case == "S-grid":
        kw["chunk_fn_s"] = jlevels.chunk_s
    return jpc_from_corr(jnp.asarray(corr(name)), FIXTURES[name]["m"], **kw)


def _stats(run):
    return [{k: st.get(k) for k in STAT_KEYS} for st in run.level_stats]


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("name", list(FIXTURES))
def test_engines_match_reference(name, case):
    f = FIXTURES[name]
    kw = dict(CASES[case], **_call_kw(name))
    if name == "matrix20":
        kw["test"] = GaussianCITest(m=f["m"], alpha=f["alpha"])
    port = pc_from_corr(corr(name), f["m"], device="cpu", **kw)
    ref_s = jax_run(name, "S")
    np.testing.assert_array_equal(port.adj, ref_s.adj)
    ref = jax_run(name, "E") if case == "E" else ref_s
    np.testing.assert_array_equal(port.sepsets, ref.sepsets)
    np.testing.assert_array_equal(port.cpdag, ref.cpdag)
    assert port.levels_run == ref_s.levels_run
    if case.startswith("S-depth") and name != "multi22":
        depth = CASES[case]["pipeline_depth"]
        want = [dict(st, dispatches=2 * st["chunks"], pipeline_depth=depth)
                for st in _stats(ref_s)]
    else:
        want = _stats(jax_run(name, case))
    assert _stats(port) == want
    assert any(st["level"] >= 2 for st in port.level_stats)
    if case == "S-grid" and name != "multi22":
        assert all(st["dispatches"] == 1 for st in port.level_stats)
    if name == "multi22":
        assert any(st["chunks"] > 1 for st in port.level_stats), "budget did not force chunks"


# ------------------------------------------------------------ module by module
def _spd(rng, shape, ell):
    a = rng.normal(size=shape + (ell, ell)).astype(np.float32)
    return a @ np.swapaxes(a, -1, -2) + 0.5 * np.eye(ell, dtype=np.float32)


@pytest.mark.parametrize("ell", [2, 3, 4, 6, 8])
def test_inv_spd_matches_reference(ell):
    m = _spd(np.random.default_rng(100 + ell), (500,), ell)
    got = L._inv_spd(torch.tensor(m)).numpy()
    want = np.asarray(jlevels._inv_spd(jnp.asarray(m)))
    if ell == 2:
        np.testing.assert_array_equal(got, want)  # the same adjugate, op for op
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("ell", [1, 2, 3, 8])
def test_ci_sweep_matches_reference(ell):
    rng = np.random.default_rng(ell)
    n_l, t_len, npr = 30, 6, 11
    m2 = _spd(rng, (n_l, t_len), ell) / (ell + 0.5)
    ci_s = (rng.normal(size=(n_l, t_len, ell)) * 0.3).astype(np.float32)
    cj_s = (rng.normal(size=(n_l, t_len, npr, ell)) * 0.3).astype(np.float32)
    cij = (rng.normal(size=(n_l, t_len, npr)) * 0.4).astype(np.float32)
    mask = rng.random((n_l, t_len, npr)) < 0.8
    args = (m2, ci_s, cj_s, cij, mask)
    tau = 0.1
    want = np.asarray(jlevels.ci_sweep(*(jnp.asarray(a) for a in args), tau, ell=ell))
    targs = [torch.tensor(a) for a in args]
    got, lo, hi = (L.ci_sweep(*targs, t, ell=ell).numpy() for t in (tau, tau - BAND, tau + BAND))
    diff = got != want
    assert not (diff & (lo == hi)).any(), "decisions differ outside the τ band"
    assert diff.sum() <= 2
    assert 0 < got.sum() < mask.sum()


def _level_state(name, ell):
    """JAX's (c, adj, sep) at the start of level ℓ of fixture ``name`` (the
    "S" engine), and the level's τ."""
    f = FIXTURES[name]
    c = jnp.asarray(corr(name))
    run = jpc_from_corr(c, f["m"], alpha=f["alpha"], engine="S", max_level=ell - 1)
    adj, sep = run.adj, run.sepsets
    return c, adj, sep, jthreshold(f["m"], ell, f["alpha"])


@pytest.mark.parametrize("ell", [1, 2])
def test_chunk_e_and_chunk_s_tests_match_reference(ell):
    """One chunk of "E" and the tests half of "S" on the grid18 fixture's
    real level state, at a chunk length that leaves ranks for later chunks."""
    c, adj, sep, tau = _level_state("grid18", ell)
    npr = int(adj.sum(1).max())
    n = adj.shape[0]
    t = lambda a: torch.tensor(np.asarray(a))  # noqa: E731
    npr_b, _, _ = jlevels.plan_level(npr, ell, n, engine="E", n_cols=n)
    comp, counts = jcompact_rows(jnp.asarray(adj), n_prime=npr_b)
    for t0, n_chunk in ((0, 4), (3, 8)):
        kw = dict(ell=ell, n_chunk=n_chunk, n_max=npr_b)
        a_j, s_j = jlevels.chunk_e(c, jnp.asarray(adj), jnp.asarray(sep), comp, counts,
                                   jnp.asarray(t0, jnp.int32), tau, **kw)
        a_t, s_t = L.chunk_e(t(c), t(adj), t(sep), t(comp), t(counts),
                             torch.tensor(t0, dtype=torch.int32), tau, **kw)
        assert np.array_equal(a_t.numpy(), np.asarray(a_j))
        assert np.array_equal(s_t.numpy(), np.asarray(s_j))
        w_j = jlevels.chunk_s_tests(c, jnp.asarray(adj), comp, counts,
                                    jnp.asarray(t0, jnp.int32), tau, **kw)
        w_t = L.chunk_s_tests(t(c), t(adj), t(comp), t(counts),
                              torch.tensor(t0, dtype=torch.int32), tau, **kw)
        for got, want in zip(w_t, w_j):
            assert np.array_equal(got.numpy(), np.asarray(want))
    assert not np.array_equal(a_t.numpy(), adj), "the chunks removed nothing"


def test_plan_level_engine_and_bucket_match_reference():
    for engine in ("S", "E"):
        for bucket in (True, False):
            for npr in (2, 5, 9, 17, 40, 129):
                for ell in (1, 2, 3):
                    for budget in (2**10, 2**24, 2**26):
                        kw = dict(engine=engine, cell_budget=budget, bucket=bucket, n_cols=300)
                        got = L.plan_level(npr, ell, 64, **kw)
                        assert got == jlevels.plan_level(npr, ell, 64, **kw), (kw, npr, ell)


def test_unrank_closed_form_at_ell1_matches_reference():
    """ℓ = 1 unranks in closed form; equal to the reference's walk for valid
    and out-of-range ranks and for empty and short rows."""
    t = np.arange(0, 40, dtype=np.int32)
    for n_max in (1, 5, 16):
        table = L._jtable(n_max, torch.int32, torch.device("cpu"))
        for n_dyn in (-1, 0, 1, 3, n_max):
            got = L._unrank_dyn(torch.tensor(t)[None, :], torch.tensor([[n_dyn]]), n_max, 1,
                                table)
            want = jlevels._unrank_dyn(jnp.asarray(t)[None, :], jnp.asarray([[n_dyn]]), n_max,
                                       1, jlevels._jtable(n_max))
            assert np.array_equal(got.numpy(), np.asarray(want)), (n_max, n_dyn)
