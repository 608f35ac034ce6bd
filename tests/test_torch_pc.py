"""End to end: the port's ``pc_from_corr`` on the CPU against the JAX
package's engine "auto", fed the same correlation matrix, on the four
fixtures of ``test_auto_engine_parity`` (tests/test_engines.py:37), and the
per-level replay: each port level started from JAX's (adj, sep).

Skeleton, sepsets and CPDAG must be equal, and the level stats must name
the same engines and compile keys. ``pc(x)`` from samples runs on the
first fixture's data. tests/test_torch_e2e.py covers the certify and
engine-matrix fixtures and the other entry points.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import cit as jcit, engines as jengines  # noqa: E402
from repro.core.pc import pc_from_corr as jpc_from_corr  # noqa: E402
from repro.data.synthetic_dag import sample_gaussian_dag  # noqa: E402
from repro_torch import pc, pc_from_corr  # noqa: E402
from repro_torch.core import cit, engines, levels as L  # noqa: E402
from repro_torch.state import run_to_numpy, state_from_numpy  # noqa: E402

pytestmark = pytest.mark.torch


def assert_same_run(port, ref):
    np.testing.assert_array_equal(port.adj, ref.adj)
    np.testing.assert_array_equal(port.sepsets, ref.sepsets)
    np.testing.assert_array_equal(port.cpdag, ref.cpdag)
    assert port.levels_run == ref.levels_run
    keys = ("level", "engine", "skipped", "chunks", "npr", "compile_key")
    assert [{k: st.get(k) for k in keys} for st in port.level_stats] == \
        [{k: st.get(k) for k in keys} for st in ref.level_stats]
    assert port.sepset_dict() == ref.sepset_dict()


def corr_of(n, density, seed, m):
    x, _ = sample_gaussian_dag(n=n, m=m, density=density, seed=seed)
    return np.array(jcit.correlation_from_samples(jnp.asarray(x)))


@pytest.mark.parametrize("n,density,alpha,seed",
                         [(15, 0.2, 0.01, 0), (20, 0.15, 0.01, 1), (18, 0.3, 0.05, 3),
                          (25, 0.1, 0.01, 2)])
def test_pc_from_corr_matches_reference_auto(n, density, alpha, seed):
    m = 3000
    c = corr_of(n, density, seed, m)
    ref = jpc_from_corr(jnp.asarray(c), m, alpha=alpha, engine="auto")
    port = pc_from_corr(c, m, alpha=alpha, engine="auto", device="cpu")
    assert_same_run(port, ref)
    ran = {st["level"]: st["engine"] for st in port.level_stats if not st["skipped"]}
    assert ran.get(1) == "L1-dense"
    assert all(e == "S-kernel" for lvl, e in ran.items() if lvl >= 2)
    assert any(lvl >= 2 for lvl in ran)
    assert set(port.timings_s) >= {"level0", "level1", "orient", "total"}


def test_per_level_replay():
    """Start each port level from JAX's state after the level before (via
    repro_torch.state) and compare with JAX's next state, adj and sepsets
    exact; the deep fixture reaches ℓ = 4."""
    m, alpha, n = 3000, 0.05, 18
    c = corr_of(n, 0.3, 3, m)
    test = jcit.GaussianCITest(m=m, alpha=alpha)
    adj = test.level0(jnp.asarray(c), test.tau(0))
    st = state_from_numpy(c=c, device="cpu")
    assert np.array_equal(L.level0(st.c, cit.threshold(m, 0, alpha)).numpy(), np.asarray(adj))
    sep = jnp.full((n, n, 8), -1, jnp.int32).at[:, :, 0].set(jnp.where(adj, -1, -2))
    ell = 1
    while int(np.asarray(adj).sum(1).max()) - 1 >= ell:
        st = state_from_numpy(c=c, adj=np.asarray(adj), sep=np.asarray(sep), device="cpu")
        adj, sep, st_j = jengines.run_level(jnp.asarray(c), adj, sep, ell, test.tau(ell),
                                            engine="auto")
        st.adj, st.sep, st_t = engines.run_level(st.c, st.adj, st.sep, ell,
                                                 cit.threshold(m, ell, alpha))
        got = run_to_numpy(st)
        assert np.array_equal(got["adj"], np.asarray(adj)), ell
        assert np.array_equal(got["sep"], np.asarray(sep)), ell
        assert st_t["engine"] == st_j["engine"]
        assert st_t.get("compile_key") == st_j.get("compile_key")
        ell += 1
    assert ell - 1 >= 4


def test_pc_from_samples_matches_reference():
    """pc(x) on the CPU (plain correlation) against JAX's pc(x)."""
    from repro.core.pc import pc as jpc

    x, _ = sample_gaussian_dag(n=15, m=3000, density=0.2, seed=0)
    ref = jpc(x, alpha=0.01)
    for corr in ("auto", "kernel", "plain"):
        assert_same_run(pc(x, alpha=0.01, device="cpu", corr=corr), ref)
    with pytest.raises(ValueError):
        pc(x, device="cpu", corr="mxu")
