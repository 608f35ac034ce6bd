"""The port's discrete G² path against the JAX package on the same inputs.

The JAX side runs its jnp reference ("G2" engine, ``gsq.gsq_ref``); the
JAX suite already holds its Pallas "G2-kernel" bitwise equal to it. The
port gets CPU tensors, so its wrappers run their plain PyTorch versions.
Tolerances:

* G²: rtol 1e-5, atol 1e-4 across frameworks (XLA contracts and rounds
  its own logs); bitwise between the port's kernel and its plain version
  on the card (``test_cuda_gsq_and_level0_match_plain``);
* decisions (p ≥ α): equal except cells whose reference p-value lies
  within |p/α − 1| ≤ 1e-4; those are counted and asserted few;
* skeleton, sepsets and CPDAG of whole runs: equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import cit as jcit, engines as jengines, levels as jlevels  # noqa: E402
from repro.core import validate as jvalidate  # noqa: E402
from repro.core.pc import pc as jpc  # noqa: E402
from repro.data import synthetic_dag as jdag  # noqa: E402
from repro.kernels import gsq as jgsq  # noqa: E402
from repro.kernels import ops as jops, ref as jref  # noqa: E402
from repro_torch import pc, pc_from_corr  # noqa: E402
from repro_torch.core import cit, engines, levels as L, stable_ref  # noqa: E402
from repro_torch.core import validate as V  # noqa: E402
from repro_torch.data import synthetic_dag  # noqa: E402
from repro_torch.kernels import build, gsq, ops  # noqa: E402
from repro_torch.state import run_to_numpy, state_from_numpy  # noqa: E402

pytestmark = pytest.mark.torch

P_BAND = 1e-4


def _discrete_x(n, m, seed, arity=3, density=0.35):
    """tests/test_cit.py's fixture maker: seeded DAG codes with no
    constant column."""
    x, _ = synthetic_dag.sample_discrete_dag(n=n, m=m, density=density, arity=arity, seed=seed)
    for k in range(n):
        if len(np.unique(x[:, k])) < 2:
            x[0, k] = (x[1, k] + 1) % arity
    return x


def _jp(g2, dof):
    """The reference's p-value epilogue (levels.py:432)."""
    return np.asarray(jax.scipy.special.gammaincc(jnp.asarray(dof, jnp.float32) / 2.0,
                                                  jnp.maximum(jnp.asarray(g2), 0.0) / 2.0))


# ------------------------------------------------------------------- data
def test_sample_discrete_dag_is_bit_identical():
    for args in ((9, 260, 0.35, 3, 2), (441, 50, 0.0061, 3, 0)):
        a, da = synthetic_dag.sample_discrete_dag(*args)
        b, db = jdag.sample_discrete_dag(*args)
        assert a.dtype == b.dtype and np.array_equal(a, b)
        assert np.array_equal(da.adj, db.adj)


# -------------------------------------------------------------------- gsq
@pytest.mark.parametrize("r,q,m,b", [
    (2, 1, 100, 50), (3, 1, 257, 130), (2, 2, 300, 200), (3, 9, 640, 128), (4, 4, 64, 300),
])
def test_gsq_ref_matches_reference(r, q, m, b):
    """The cases of test_gsq_cells_matches_ref_bitwise (tests/test_kernels.py):
    the port's plain G² against JAX's gsq_ref, fed the transpose (the port
    is cell-major)."""
    rng = np.random.default_rng(r * 1000 + q)
    jc = rng.integers(0, q * r * r, size=(m, b)).astype(np.int32)
    jc[rng.random(size=jc.shape) < 0.1] = -1
    got = gsq.gsq_ref(torch.tensor(jc.T.copy()), r=r, q=q).numpy()
    want = np.asarray(jgsq.gsq_ref(jnp.asarray(jc), r=r, q=q))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(ops.gsq(torch.tensor(jc.T.copy()), r=r, q=q).numpy(), got)


def test_gsq_known_value():
    """test_gsq_known_value's hand-checked 2×2 table N = [[30, 10], [10, 30]]."""
    from scipy.stats import chi2_contingency

    tab = np.array([[30, 10], [10, 30]])
    codes = np.repeat(np.arange(4), tab.flatten()).astype(np.int32)
    g2 = float(gsq.gsq_ref(torch.tensor(codes[None, :]), r=2, q=1)[0])
    want = chi2_contingency(tab, correction=False, lambda_="log-likelihood").statistic
    assert g2 == pytest.approx(want, rel=1e-5)


def test_gsq_wrapper_checks():
    with pytest.raises(ValueError):
        gsq.gsq_ref(torch.zeros((3, 4), dtype=torch.int64), r=2, q=1)
    with pytest.raises(ValueError, match="CUDA"):
        gsq.gsq_cells(torch.zeros((3, 4), dtype=torch.int32), r=2, q=1)
    build.reset_launches()
    ops.gsq(torch.zeros((3, 4), dtype=torch.int32), r=2, q=1)
    assert build.LAUNCHES["gsq"] == 0


def test_chi2_sf_f32_against_reference():
    """p-values of torch's float32 gammaincc against the reference's, in
    the decision region p ∈ [0.001, 0.2]: within 2e-5 relative up to dof 36
    (every level ≤ 2 at arity 3), drifting apart above (past the 1e-4 p
    band at dof 972, ℓ = 5 at arity 3), where the reference's own error
    against float64 is the larger one."""
    from scipy.special import gammaincc
    from scipy.stats import chi2

    rng = np.random.default_rng(0)
    for dof, tol in ((1, 2e-5), (4, 2e-5), (12, 2e-5), (36, 2e-5), (108, 1e-4), (972, 1e-3)):
        g2 = rng.uniform(chi2.isf(0.2, dof), chi2.isf(0.001, dof), 4000).astype(np.float32)
        dofs = np.full_like(g2, dof)
        got = cit.chi2_sf_f32(torch.tensor(g2), torch.tensor(dofs)).numpy()
        want = _jp(g2, dofs)
        f64 = gammaincc(dof / 2.0, g2.astype(np.float64) / 2.0)
        assert np.abs(got / want - 1).max() <= tol, dof
        assert np.abs(got / f64 - 1).max() <= np.abs(want / f64 - 1).max() + 2e-6, dof
        if dof == 972:
            assert np.abs(got / want - 1).max() > P_BAND  # ROADMAP Queue 3


# --------------------------------------------------------- test objects
def test_encode_and_citest_scalars_match_reference():
    x = _discrete_x(7, 120, seed=4)
    stats, r_max = cit.encode_discrete(x)
    jstats, jr_max = jcit.encode_discrete(x)
    assert r_max == jr_max
    assert stats.codes.dtype == torch.int32 and stats.arities.dtype == torch.int32
    np.testing.assert_array_equal(stats.codes.numpy(), np.asarray(jstats.codes))
    np.testing.assert_array_equal(stats.arities.numpy(), np.asarray(jstats.arities))
    small, r2 = cit.encode_discrete(np.array([[0, 2], [1, 0], [0, 1]]))
    assert small.arities.tolist() == [2, 3] and r2 == 3
    for r in (2, 3, 4, 16):
        t, jt = cit.DiscreteCITest(m=400, alpha=0.05, r=r), jcit.DiscreteCITest(m=400, alpha=0.05, r=r)
        assert t.tau(0) == t.tau(5) == jt.tau(3) == 0.05
        assert t.taus(3) == jt.taus(3)
        assert [t.table_width(e) for e in range(4)] == [jt.table_width(e) for e in range(4)]
        assert t.max_supported_level() == jt.max_supported_level()
        with pytest.raises(ValueError, match="MAX_G2_TABLE"):
            t.check_level(t.max_supported_level() + 1)
    assert cit.MAX_G2_TABLE == jcit.MAX_G2_TABLE
    t, st = cit.DiscreteCITest.from_samples(x, alpha=0.02)
    jt_, _ = jcit.DiscreteCITest.from_samples(x, alpha=0.02)
    assert (t.m, t.alpha, t.r) == (jt_.m, jt_.alpha, jt_.r)
    assert cit.resolve_citest("discrete", 300, 0.05) == cit.DiscreteCITest(m=300, alpha=0.05)
    inst = cit.DiscreteCITest(m=100, alpha=0.1, r=4)
    assert cit.resolve_citest(inst, 999, 0.01) is inst
    with pytest.raises(ValueError):
        cit.resolve_citest("kci", 100, 0.01)


def _bad_discrete_inputs():
    base = _discrete_x(5, 200, seed=1)
    nan = base.astype(np.float64)
    nan[3, 2] = np.nan
    frac = base.astype(np.float64)
    frac[0, 1] = 0.5
    neg = base.copy()
    neg[2, 0] = -1
    const = base.copy()
    const[:, 3] = 1
    wide = base.copy()
    wide[0, 4] = 20
    return [("nonfinite", nan, "NonFiniteDataError"), ("fraction", frac, "BadDiscreteDataError"),
            ("negative", neg, "BadDiscreteDataError"), ("constant", const, "ConstantColumnError"),
            ("arity", wide, "BadDiscreteDataError"),
            ("shape", base[:, 0], "ValidationError")]


@pytest.mark.parametrize("case", range(6))
def test_validate_discrete_errors_match_reference(case):
    name, x, err = _bad_discrete_inputs()[case]
    with pytest.raises(getattr(jvalidate, err)):
        jvalidate.validate_discrete(x)
    with pytest.raises(getattr(V, err)) as info:
        V.validate_discrete(x)
    assert type(info.value).__name__ == err and info.value.code == getattr(jvalidate, err).code
    with pytest.raises(getattr(V, err)):
        pc(x, test="discrete", device="cpu")


def test_validate_discrete_accepts_and_warns():
    x = _discrete_x(6, 300, seed=0)
    assert V.validate_discrete(x) == jvalidate.validate_discrete(x) == (300, 6)
    with pytest.warns(UserWarning, match="samples per unconditional"):
        V.validate_discrete(x[:50])


# ------------------------------------------------------------------ levels
@pytest.mark.parametrize("alpha", [0.01, 0.05])
def test_level0_g2_matches_reference(alpha):
    """Decisions equal to JAX's level0_g2 outside the p band; band cells
    counted; the row blocking changes nothing."""
    x = _discrete_x(24, 400, seed=6, arity=3, density=0.25)
    x[:, 5] = np.minimum(x[:, 5], 1)  # one binary column: per-pair dof
    stats, r = cit.encode_discrete(x)
    jstats, _ = jcit.encode_discrete(x)
    got = L.level0_g2(stats, alpha, r=r).numpy()
    want = np.asarray(jlevels.level0_g2(jstats, alpha, r=r))
    n, m = 24, 400
    jc = (x[:, :, None] * r + x[:, None, :]).reshape(m, n * n).astype(np.int32)
    g2 = np.asarray(jgsq.gsq_ref(jnp.asarray(jc), r=r, q=1)).reshape(n, n)
    ar = stats.arities.numpy()
    p_ref = _jp(g2, np.maximum((ar[:, None] - 1) * (ar[None, :] - 1), 1))
    band = np.abs(p_ref / alpha - 1) <= P_BAND
    diff = got != want
    assert not (diff & ~band).any()
    assert diff.sum() <= 2
    old = L.LEVEL0_JC_BYTES
    try:
        L.LEVEL0_JC_BYTES = 4 * n * m * 5  # 5 rows a block
        np.testing.assert_array_equal(L.level0_g2(stats, alpha, r=r).numpy(), got)
    finally:
        L.LEVEL0_JC_BYTES = old


def test_level0_plain_matches_reference_level0_exactly():
    """The Gaussian level-0 plain version (the level-0 kernel's yardstick)
    against JAX's ops.level0 and ref.level0_ref."""
    for n in (16, 100, 300):
        rng = np.random.default_rng(n)
        c = np.clip(rng.normal(0, 0.4, size=(n, n)), -0.99, 0.99).astype(np.float32)
        c = (c + c.T) / 2
        np.fill_diagonal(c, 1.0)
        for tau in (0.01, 0.1, 0.5):
            got = ops.level0(torch.tensor(c), tau).numpy()
            np.testing.assert_array_equal(got, np.asarray(jops.level0(jnp.asarray(c), tau)))
            np.testing.assert_array_equal(got, np.asarray(jref.level0_ref(jnp.asarray(c), tau)))


def test_chunk_g2_replayed_from_reference_state():
    """Levels 1 and 2 of the port started from JAX's state after the level
    before, through state.py; each must end where JAX's level ends."""
    x = _discrete_x(10, 300, seed=3)
    alpha = 0.05
    jstats, r = jcit.encode_discrete(x)
    jt = jcit.DiscreteCITest(m=300, alpha=alpha, r=r)
    t = cit.DiscreteCITest(m=300, alpha=alpha, r=r)
    adj = jt.level0(jstats, alpha)
    sep = jnp.full((10, 10, 8), -1, jnp.int32).at[:, :, 0].set(jnp.where(adj, -1, -2))
    for ell in (1, 2):
        st = state_from_numpy(codes=np.asarray(jstats.codes), arities=np.asarray(jstats.arities),
                              adj=np.asarray(adj), sep=np.asarray(sep), device="cpu")
        for name in ("G2", "G2-kernel"):
            padj, psep, pst = engines.run_level(st.stats, st.adj, st.sep, ell, alpha,
                                                engine=name, test=t)
            if name == "G2":
                adj, sep, jst = jengines.run_level(jstats, adj, sep, ell, alpha, engine="G2",
                                                   test=jt)
            np.testing.assert_array_equal(padj.numpy(), np.asarray(adj))
            np.testing.assert_array_equal(psep.numpy(), np.asarray(sep))
            assert pst["engine"] == name and pst["test"] == "discrete"
            keys = ("chunks", "npr", "npr_bucket", "n_chunk", "total_sets", "compile_key")
            assert {k: pst[k] for k in keys} == {k: jst[k] for k in keys}
    back = run_to_numpy(st)
    assert back["codes"].dtype == np.int32 and np.array_equal(back["codes"], x)
    assert np.array_equal(back["arities"], np.asarray(jstats.arities))
    with pytest.raises(ValueError, match="together"):
        state_from_numpy(codes=x, device="cpu")
    with pytest.raises(ValueError):
        state_from_numpy(codes=x.astype(float), arities=np.asarray(jstats.arities), device="cpu")


def test_engine_resolution_under_the_discrete_test():
    d = cit.DiscreteCITest(m=200, r=3)
    for eng, want in (("S", "G2"), ("E", "G2"), ("auto", "G2-kernel"),
                      ("S-kernel", "G2-kernel"), ("G2", "G2"), ("g2-kernel", "G2-kernel")):
        assert engines.resolve(eng, 2, d) == want == jengines.resolve(eng, 2, jcit.DiscreteCITest(m=200, r=3))
    for eng in ("L1-dense", "S-grid"):
        with pytest.raises(ValueError, match="no discrete-test path"):
            engines.resolve(eng, 1, d)
    for eng in ("G2", "G2-kernel"):
        with pytest.raises(ValueError, match="discrete"):
            engines.resolve(eng, 1)
    with pytest.raises(ValueError, match="Queue 1 item 9"):
        engines.resolve("scan", 1, d)


# -------------------------------------------------------------- end to end
def _assert_same(port, ref):
    np.testing.assert_array_equal(port.adj, ref.adj)
    np.testing.assert_array_equal(port.sepsets, ref.sepsets)
    np.testing.assert_array_equal(port.cpdag, ref.cpdag)
    assert port.levels_run == ref.levels_run
    keys = ("level", "skipped", "chunks", "npr", "compile_key", "test")
    assert [{k: s.get(k) for k in keys} for s in port.level_stats] == \
        [{k: s.get(k) for k in keys} for s in ref.level_stats]


@pytest.mark.parametrize("fixture", ["engine_matrix", "g2_parity"])
def test_pc_discrete_matches_reference(fixture):
    """The fixtures of test_engine_matrix_discrete_all_names_agree
    (tests/test_engines.py:290) and test_g2_vs_g2_kernel_bit_parity
    (tests/test_cit.py:157): every engine name of the port equal to JAX's
    "G2", with the engine names the reference records."""
    if fixture == "engine_matrix":
        x = _discrete_x(9, 260, seed=2)
    else:
        x = _discrete_x(10, 300, seed=3)
    ref = jpc(x, alpha=0.05, test="discrete", engine="G2", max_level=2)
    for eng, want in (("G2", "G2"), ("S", "G2"), ("E", "G2"), ("auto", "G2-kernel"),
                      ("S-kernel", "G2-kernel"), ("G2-kernel", "G2-kernel")):
        run = pc(x, alpha=0.05, test="discrete", engine=eng, max_level=2, device="cpu")
        _assert_same(run, ref)
        ran = {s["engine"] for s in run.level_stats if not s.get("skipped")}
        assert ran == {want}, (eng, ran)
        if eng == "G2":
            assert ran == {s["engine"] for s in ref.level_stats if not s.get("skipped")}
    assert set(run.timings_s) >= {"level0", "level1", "orient", "total"}


@pytest.mark.parametrize("n,m,arity,seed", [(8, 300, 3, 0), (10, 200, 2, 1), (7, 400, 3, 2),
                                            (9, 250, 2, 5)])
def test_discrete_skeleton_matches_port_oracle(n, m, arity, seed):
    """test_discrete_engine_matches_oracle's cases (tests/test_cit.py:134),
    against the port's float64 oracle, whose sepsets must also hold."""
    x = _discrete_x(n, m, seed, arity=arity)
    run = pc(x, alpha=0.05, test="discrete", max_level=2, device="cpu")
    ref = stable_ref.pc_stable_skeleton_discrete(x, alpha=0.05, max_level=2)
    np.testing.assert_array_equal(run.adj, ref.adj)
    ar = x.max(axis=0) + 1
    for (i, j), s in run.sepset_dict().items():
        assert stable_ref.g2_test(x, ar, i, j, s)[2] >= 0.05 * (1 - P_BAND), (i, j, s)


def test_port_oracle_matches_reference_oracle():
    from repro.core.stable_ref import g2_test as jg2_test

    x = _discrete_x(8, 300, seed=0)
    ar = x.max(axis=0) + 1
    for s in ((), (2,), (2, 5)):
        assert stable_ref.g2_test(x, ar, 0, 1, s) == jg2_test(x, ar, 0, 1, s)


def test_discrete_entry_points():
    x = _discrete_x(6, 200, seed=0)
    with pytest.raises(ValueError, match="corr"):
        pc(x, test="discrete", corr="kernel", device="cpu")
    with pytest.raises(ValueError, match="raw samples"):
        pc_from_corr(np.eye(4, dtype=np.float32), 100, test="discrete", device="cpu")
    with pytest.raises(ValueError, match="no discrete-test path"):
        pc(x, test="discrete", engine="L1-dense", device="cpu")
    with pytest.raises(ValueError, match="MAX_G2_TABLE"):
        pc(x, test="discrete", max_level=6, device="cpu")
    run = pc(torch.tensor(x), test=cit.DiscreteCITest(m=1, alpha=0.05), device="cpu")
    assert run.adj.shape == (6, 6)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            pc(x, test="discrete")


# ------------------------------------------------------------ on the card
@pytest.mark.cuda
def test_cuda_gsq_and_level0_match_plain():
    """gsq bitwise and level0 exactly against their plain versions on the
    card, and the discrete "auto" run through the gsq kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    build.reset_launches()
    for r, q, m, b in ((2, 1, 100, 50), (3, 1, 5000, 3000), (3, 9, 640, 128), (3, 729, 300, 40),
                       (16, 16, 64, 20)):
        rng = np.random.default_rng(r * 1000 + q)
        jc = torch.tensor(rng.integers(-1, q * r * r, size=(b, m)), dtype=torch.int32, device=dev)
        assert torch.equal(gsq.gsq_cells(jc, r=r, q=q), gsq.gsq_ref(jc, r=r, q=q))
    # K from 9 to 2187 (32 and 36 among them), M % 4 ≠ 0 (4-byte loads),
    # padding codes below 0 and at or above K, an all-padding row and rows
    # whose samples all carry one code (every sample of the cell in one bin)
    cases = ((3, 1, 5000), (3, 1, 4999), (3, 3, 1001), (2, 8, 5000), (3, 4, 5000), (6, 1, 777),
             (3, 9, 5000), (3, 9, 4998), (3, 243, 5000))
    for r, q, m in cases:
        k = q * r * r
        rng = np.random.default_rng(k * 7 + m)
        codes = rng.integers(-3, k + 3, size=(64, m))
        codes[0] = -1
        codes[1] = k // 2
        codes[2] = k - 1
        codes[3, : m // 2] = 0
        jc = torch.tensor(codes, dtype=torch.int32, device=dev)
        got = gsq.gsq_cells(jc, r=r, q=q)
        assert torch.equal(got, gsq.gsq_ref(jc, r=r, q=q)), (r, q, m)
        assert float(got[0]) == 0.0 and float(got[1]) == 0.0
    rng = np.random.default_rng(0)
    c = np.clip(rng.normal(0, 0.4, size=(300, 300)), -0.99, 0.99).astype(np.float32)
    ct = torch.tensor((c + c.T) / 2, device=dev).fill_diagonal_(1.0)
    for tau in (0.01, 0.1, 0.5):
        assert torch.equal(ops.level0(ct, tau), L.level0(ct, tau))
    torch.cuda.synchronize()
    assert build.LAUNCHES["gsq"] == 5 + len(cases) and build.LAUNCHES["level0"] == 3
    x = _discrete_x(12, 600, seed=4)
    build.reset_launches()
    run = pc(x, alpha=0.05, test="discrete", max_level=2)
    assert build.LAUNCHES["gsq"] > 0
    ref = stable_ref.pc_stable_skeleton_discrete(x, alpha=0.05, max_level=2)
    np.testing.assert_array_equal(run.adj, ref.adj)
