"""The port's level machinery, orientation and state handover against the
JAX package on the same inputs (CPU tensors, plain PyTorch versions).

Exact, given the same inputs: compact_rows, plan_sets / gather_s,
_global_commit, commit_dense_l1, plan_level (with its rank-capacity
refusal), the threshold τ and orientation. The per-level replay lives in
tests/test_torch_pc.py, beside the end-to-end run of its fixture.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import cit as jcit, levels as jlevels  # noqa: E402
from repro.core import orient as jorient  # noqa: E402
from repro.core.compact import compact_rows as jcompact_rows, compact_rows_np  # noqa: E402
from repro.data import synthetic_dag as jdag  # noqa: E402
from repro_torch.core import cit, levels as L, orient  # noqa: E402
from repro_torch.core.compact import compact_rows  # noqa: E402
from repro_torch.data import synthetic_dag  # noqa: E402
from repro_torch.state import run_to_numpy, state_from_numpy  # noqa: E402

pytestmark = pytest.mark.torch


def _rand_adj(rng, n, p):
    a = np.triu(rng.random((n, n)) < p, 1)
    return a | a.T


def _t(a):
    return torch.as_tensor(np.array(a))


# ------------------------------------------------------------- primitives
@pytest.mark.parametrize("alpha", [0.01, 0.05])
@pytest.mark.parametrize("m", [47, 900, 1500, 2000, 2500, 3000])
def test_threshold_equals_reference(m, alpha):
    from scipy.special import ndtri

    for ell in range(9):
        assert cit.threshold(m, ell, alpha) == jcit.threshold(m, ell, alpha)
    exact = ndtri(1.0 - alpha / 2.0) / math.sqrt(m - 3)
    assert abs(cit.threshold(m, 0, alpha) - exact) < 4 * np.spacing(np.float32(exact))
    with pytest.raises(cit.InsufficientSamplesError):
        cit.threshold(5, 3, alpha)


def test_synthetic_dag_is_bit_identical():
    for args in ((30, 100, 0.2, 3), (12, 47, 0.02, 0)):
        x_t, d_t = synthetic_dag.sample_gaussian_dag(*args[:3], seed=args[3])
        x_j, d_j = jdag.sample_gaussian_dag(*args[:3], seed=args[3])
        assert np.array_equal(x_t, x_j) and np.array_equal(d_t.weights, d_j.weights)


@pytest.mark.parametrize("n,p,width", [(1, 0.0, None), (9, 0.4, None), (33, 0.2, 16)])
def test_compact_rows_exact(n, p, width):
    adj = _rand_adj(np.random.default_rng(n), n, p)
    comp, counts = compact_rows(_t(adj), n_prime=width)
    comp_j, counts_j = jcompact_rows(jnp.asarray(adj), n_prime=width)
    assert comp.dtype == torch.int32 and counts.dtype == torch.int32
    assert np.array_equal(comp.numpy(), np.asarray(comp_j))
    assert np.array_equal(counts.numpy(), np.asarray(counts_j))
    comp_np, counts_np = compact_rows_np(adj)
    assert np.array_equal(comp.numpy(), comp_np[:, :comp.shape[1]])
    assert np.array_equal(counts.numpy(), counts_np)


@pytest.mark.parametrize("ell", [2, 3])
def test_gather_s_exact(ell):
    rng = np.random.default_rng(ell)
    n = 14
    c = np.clip(rng.normal(0, 0.3, (n, n)), -0.9, 0.9).astype(np.float32)
    c = (c + c.T) / 2
    np.fill_diagonal(c, 1.0)
    adj = _rand_adj(rng, n, 0.5)
    npr = int(adj.sum(1).max())
    npr_b = L.bucket_npr(npr)
    t0, n_chunk = 3, 16  # spans valid and past-the-end ranks
    comp, counts = jcompact_rows(jnp.asarray(adj), n_prime=npr_b)
    rows = np.arange(n, dtype=np.int32)
    ranks_j = t0 + jnp.arange(n_chunk, dtype=jnp.int32)
    want = jlevels.gather_s(jnp.asarray(c), jnp.asarray(adj), comp, counts, jnp.asarray(rows),
                            ranks_j, ell=ell, n_max=npr_b)
    ranks = t0 + torch.arange(n_chunk, dtype=torch.int32)
    got = L.gather_s(_t(c), _t(adj), _t(comp), _t(counts), _t(rows), ranks, ell=ell,
                     n_max=npr_b)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_unrank_matches_reference():
    table_j = jlevels._jtable(12)
    table = L._jtable(12, torch.int32, torch.device("cpu"))
    assert np.array_equal(table.numpy(), np.asarray(table_j))
    t = np.arange(0, 220, dtype=np.int32)  # every rank of C(12, 3)
    got = L._unrank_dyn(_t(t), torch.tensor(12), 12, 3, table)
    want = jlevels._unrank_dyn(jnp.asarray(t), 12, 12, 3, table_j)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_global_commit_exact(seed):
    rng = np.random.default_rng(seed)
    n, ell, n_chunk = 12, 2, 8
    adj = _rand_adj(rng, n, 0.6)
    npr_b = min(L.bucket_npr(int(adj.sum(1).max())), n)
    comp, counts = jcompact_rows(jnp.asarray(adj), n_prime=npr_b)
    sep = rng.integers(-2, n, size=(n, n, 4)).astype(np.int32)
    sep_found = rng.random((n, n_chunk, npr_b)) < 0.15
    s_ids = rng.integers(0, n, size=(n, n_chunk, ell)).astype(np.int32)
    ranks = 5 + np.arange(n_chunk, dtype=np.int32)
    adj_j, sep_j = jlevels._commit(None, jnp.asarray(adj), jnp.asarray(sep), comp, counts,
                                   jnp.asarray(sep_found), jnp.asarray(ranks),
                                   jnp.asarray(s_ids), None, ell)
    adj_t, sep_t = L._commit(_t(adj), _t(sep), _t(comp), _t(sep_found), _t(ranks),
                             _t(s_ids), ell)
    assert np.array_equal(adj_t.numpy(), np.asarray(adj_j))
    assert np.array_equal(sep_t.numpy(), np.asarray(sep_j))


@pytest.mark.parametrize("seed", [0, 1])
def test_commit_dense_l1_exact(seed):
    rng = np.random.default_rng(seed)
    n = 20
    adj = _rand_adj(rng, n, 0.5)
    kwin = np.where(rng.random((n, n)) < 0.3, rng.integers(0, n, (n, n)), 2**30).astype(np.int32)
    sep = np.full((n, n, 8), -1, np.int32)
    sep[:, :, 0] = np.where(adj, -1, -2)
    adj_j, sep_j = jlevels.commit_dense_l1(jnp.asarray(adj), jnp.asarray(sep), jnp.asarray(kwin))
    adj_t, sep_t = L.commit_dense_l1(_t(adj), _t(sep), _t(kwin))
    assert np.array_equal(adj_t.numpy(), np.asarray(adj_j))
    assert np.array_equal(sep_t.numpy(), np.asarray(sep_j))


def test_plan_level_matches_reference():
    for npr in (1, 2, 5, 9, 17, 40, 129, 300):
        for ell in (1, 2, 3):
            for budget in (2**10, 2**24):
                for n_cols in (64, 400):
                    got = L.plan_level(npr, ell, 64, cell_budget=budget, n_cols=n_cols)
                    want = jlevels.plan_level(npr, ell, 64, cell_budget=budget, n_cols=n_cols)
                    assert got == want, (npr, ell, budget, n_cols)
    assert [L.bucket_npr(v) for v in (1, 2, 3, 8, 9, 17, 127, 128, 129, 300)] == \
        [1, 2, 4, 8, 16, 32, 128, 128, 256, 384]


def test_plan_level_caps_and_rejects_unrepresentable_ranks():
    """The reference's int32 capacity guard reproduces (tests/test_engines.py:168):
    int32 ranks refuse what the reference refuses; int64 ranks plan it."""
    with pytest.raises(ValueError, match="rank capacity"):
        L.plan_level(3000, 8, 3000)
    with pytest.raises(ValueError, match="rank capacity"):
        jlevels.plan_level(3000, 8, 3000)
    npr, ell = 4000, 3
    total = math.comb(npr, ell)
    assert total > L._imax(torch.int32) // 2
    with pytest.raises(ValueError, match="rank capacity"):
        L.plan_level(npr, ell, 64)
    _, n_chunk, planned = L.plan_level(npr, ell, 64, rank_dtype=torch.int64)
    assert planned == total and total + n_chunk <= L._imax(torch.int64)
    # just under the int32 commit-key capacity: plans, and the chunk stays in range
    imax = L._imax(torch.int32)
    npr = max(k for k in range(2000) if math.comb(k, 3) <= imax // 2)
    got = L.plan_level(npr, 3, 64)
    assert got == jlevels.plan_level(npr, 3, 64)
    assert math.comb(npr, 3) + got[1] <= imax


# ------------------------------------------------------------ orientation
def _skeleton_fixture(seed, n):
    """A PC-like skeleton with sepsets: a random sparse graph whose removed
    pairs carry random separating sets (and some level-0 sentinels)."""
    rng = np.random.default_rng(seed)
    adj = _rand_adj(rng, n, 0.2)
    sep = np.full((n, n, 4), -1, np.int32)
    for i in range(n):
        for j in range(i + 1, n):
            if adj[i, j]:
                continue
            if rng.random() < 0.3:
                sep[i, j, 0] = sep[j, i, 0] = -2
            else:
                k = rng.integers(0, 3)
                ids = rng.choice(n, size=k, replace=False)
                sep[i, j, :k] = sep[j, i, :k] = ids
    return adj, sep


@pytest.mark.parametrize("seed,n", [(0, 8), (1, 15), (2, 24), (3, 40)])
def test_orientation_exact(seed, n):
    adj, sep = _skeleton_fixture(seed, n)
    a_j, s_j = jnp.asarray(adj), jnp.asarray(sep)
    member = orient.sepset_membership(_t(sep))
    assert np.array_equal(member.numpy(), np.asarray(jorient.sepset_membership(s_j)))
    v_j = np.asarray(jorient.orient_v_structures(a_j, s_j))
    assert np.array_equal(orient.orient_v_structures(_t(adj), _t(sep)).numpy(), v_j)
    assert np.array_equal(orient.orient_v_structures_membership(_t(adj), member, block=5).numpy(),
                          v_j)
    step_j = np.asarray(jorient._meek_step(jnp.asarray(v_j)))
    assert np.array_equal(orient._meek_step(_t(v_j)).numpy(), step_j)
    cp = orient.cpdag_from_skeleton(_t(adj), _t(sep)).numpy()
    assert np.array_equal(cp, np.asarray(jorient.cpdag_from_skeleton(a_j, s_j)))


@pytest.mark.parametrize("seed", range(6))
def test_meek_rules_exact_on_partially_directed_graphs(seed):
    """Random partially directed graphs exercise R1–R4 (R3 through the
    neighbour-blocked contraction)."""
    rng = np.random.default_rng(seed)
    n = 16
    skel = _rand_adj(rng, n, 0.35)
    d = skel & ~(np.triu(rng.random((n, n)) < 0.3, 1) & skel).T  # orient some edges
    got = orient.meek_rules(_t(d)).numpy()
    assert np.array_equal(got, np.asarray(jorient.meek_rules(jnp.asarray(d))))
    old = orient.R3_CELL_BUDGET
    try:
        orient.R3_CELL_BUDGET = 1  # one vertex a per block
        assert np.array_equal(orient.meek_rules(_t(d)).numpy(), got)
    finally:
        orient.R3_CELL_BUDGET = old


# --------------------------------------------------------- state and replay
def test_state_round_trip():
    rng = np.random.default_rng(0)
    arrays = dict(x=rng.normal(size=(6, 4)), c=np.eye(4), adj=np.eye(4, dtype=bool),
                  sep=np.full((4, 4, 2), -1))
    st = state_from_numpy(**arrays, device="cpu")
    assert (st.x.dtype, st.c.dtype, st.adj.dtype, st.sep.dtype) == \
        (torch.float32, torch.float32, torch.bool, torch.int32)
    back = run_to_numpy(st)
    assert back["x"].dtype == np.float32 and back["sep"].dtype == np.int32
    assert np.array_equal(back["adj"], arrays["adj"])
    with pytest.raises(ValueError):
        state_from_numpy(adj=np.eye(3), device="cpu")
