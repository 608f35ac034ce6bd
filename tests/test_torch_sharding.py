"""The port's sharding layer (``repro_torch.core.sharding``), the levels
functions of the row-sharded layouts, and the sharded batch and serving
paths, against the JAX package on the same numpy inputs (in-process; K
logical CPU shards stand in for the reference's forced host devices).

* padding helpers, ``make_mesh`` and its error, the layout descriptors;
* ``gather_s_cols``, ``subset_cols``, ``commit_adj`` and
  ``commit_sep_rows`` against the JAX functions, pad rows included;
* ``pc_scan_batch`` and ``scan_levels_batch`` with ``mesh=`` (B % K ≠ 0
  included) against the JAX ``mesh=None`` runs on the JAX C;
* ``ServeConfig(mesh=)``: tests/test_serve.py's sharded scenario
  (``test_sharded_slots_bit_identical``), every delivered graph equal to
  its solo ``pc_scan``;
* the card's ``ci_sweep`` terms (``levels._sweep_terms_in_order``): a row
  block's bitwise the whole batch's, and the einsums' within fp32
  rounding.

Tolerance: bitwise everywhere but the last test's einsum comparison.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.batch import scan_pc as jscan  # noqa: E402
from repro.core import levels as jlevels  # noqa: E402
from repro.core.cit import correlation_from_samples, threshold  # noqa: E402
from repro.core.compact import compact_rows as jcompact_rows  # noqa: E402
from repro.data.synthetic_dag import sample_gaussian_dag  # noqa: E402
from repro_torch.batch import scan_pc  # noqa: E402
from repro_torch.core import levels as L  # noqa: E402
from repro_torch.core import sharding as S  # noqa: E402
from repro_torch.launch.mesh import make_pc_mesh  # noqa: E402

pytestmark = [pytest.mark.torch, pytest.mark.distributed]

CPU = torch.device("cpu")
FIELDS = ("adj", "cpdag", "sepsets", "ok", "max_degs", "ok_levels")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These runs are thousands of small ops: with one intra-op thread a
    worker does not oversubscribe the cores it shares with the other test
    workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jc(n, m, density, seed):
    x, _ = sample_gaussian_dag(n=n, m=m, density=density, seed=seed)
    return np.asarray(correlation_from_samples(jnp.asarray(x)))


def _t(a):
    return torch.tensor(np.asarray(a))


# ------------------------------------------------------------- mesh & padding
def test_padding_helpers_roundtrip():
    mesh = S.make_mesh(devices=("cpu",) * 4)
    assert S.mesh_size(mesh) == 4 and mesh.devices == (CPU,) * 4 and mesh.distinct() == (CPU,)
    assert (S.pad_amount(7, mesh), S.per_device_rows(7, mesh)) == (1, 2)
    assert (S.pad_amount(8, mesh), S.per_device_rows(8, mesh)) == (0, 2)
    x = torch.arange(7)
    padded, pad = S.pad_leading(x, mesh, fill=-1)
    assert pad == 1 and padded.tolist() == list(range(7)) + [-1]
    assert torch.equal(S.unpad_leading(padded, pad), x)
    assert S.pad_leading(torch.arange(8), mesh)[1] == 0
    rows, pad = S.shard_rows(torch.ones((9, 3), dtype=torch.bool), mesh, fill=False)
    assert pad == 3 and rows.shape == (12, 3) and [tuple(b.shape) for b in rows] == [(3, 3)] * 4
    assert rows.gather().sum() == 27 and not rows[3][1:].any()
    one = S.make_mesh(devices=("cpu",))
    assert S.pad_leading(x, one) == (x, 0)


def test_make_mesh_devices_and_actionable_error():
    assert S.make_mesh(3, device="cpu") == S.Mesh(["cpu"] * 3)
    assert S.make_mesh(device="cpu") == S.Mesh(["cpu"])
    assert make_pc_mesh(2, device="cpu") == S.Mesh(["cpu"] * 2)
    assert S.make_mesh(devices=("cpu", "cpu")).devices == (CPU, CPU)
    want = (torch.cuda.device_count() if torch.cuda.is_available() else 0) + 1
    with pytest.raises(ValueError, match=r"devices=\('cuda:0',\) \* %d" % want):
        S.make_mesh(want)
    with pytest.raises(ValueError, match="at least one device"):
        S.Mesh([])


def test_layout_descriptors():
    """The reference's specs as descriptors: row blocks of (n_pad/K, …) on
    the shard's device, batch blocks, one whole copy a distinct device."""
    mesh = S.make_mesh(devices=("cpu",) * 4)
    assert S.row_spec(mesh).spec == (S.AXIS,) and not S.row_spec(mesh).replicated
    assert S.batch_spec(mesh).spec == (S.AXIS, None, None)
    assert S.batch_spec(mesh, 2).spec == (S.AXIS, None)
    assert S.replicated_spec(mesh).spec == () and S.replicated_spec(mesh).replicated
    cs = torch.zeros((6, 10, 10))
    sh, pad = S.shard_batch(cs, mesh)
    assert pad == 2 and sh.shape == (8, 10, 10) and sh.sharding == S.batch_spec(mesh, 3)
    assert [tuple(b.shape) for b in sh] == [(2, 10, 10)] * 4
    rep = S.replicate(torch.arange(5), mesh)
    assert rep.sharding == S.replicated_spec(mesh) and rep.shape == (5,)
    assert all(b is rep[0] for b in rep)  # one copy a distinct device
    assert S.AXIS in str(S.row_spec(mesh))
    sep = torch.full((33, 33, 8), -1, dtype=torch.int32)
    sep_sh, _ = S.shard_rows(sep, S.make_mesh(devices=("cpu",) * 8), fill=-1)
    assert [tuple(b.shape) for b in sep_sh] == [(5, 33, 8)] * 8  # O(n²·depth / K)


# ------------------------------------------------- levels of the sharded layouts
def _level1_state(n=22, seed=5, m=2000, density=0.15):
    c = _jc(n, m, density, seed)
    adj = np.asarray(jlevels.level0(jnp.asarray(c), threshold(m, 0, 0.01)))
    npr = int(adj.sum(1).max())
    counts = adj.sum(1)
    cols = np.flatnonzero(counts > 0).astype(np.int32)
    col_pos = np.zeros(n, np.int32)
    col_pos[cols] = np.arange(len(cols), dtype=np.int32)
    return c, adj, npr, cols, col_pos


@pytest.mark.parametrize("ell", [1, 2, 3])
def test_gather_s_cols_matches_reference(ell):
    """One shard's block of the row-sharded layout, its last rows past n
    (pad rows: count 0, lists −1): every gathered value, the mask and the
    sets equal the JAX ``gather_s_cols``'s, and the sweep's decisions equal
    the dense gather's."""
    c, adj, npr, cols, col_pos = _level1_state()
    n = c.shape[0]
    compact, counts = (np.asarray(a) for a in jcompact_rows(jnp.asarray(adj), n_prime=npr))
    lo, n_l = 18, 6  # rows 18..23 of n = 22: two pad rows
    blk_c = np.full((n_l, npr), -1, np.int32)
    blk_n = np.zeros(n_l, np.int32)
    blk_c[:n - lo], blk_n[:n - lo] = compact[lo:], counts[lo:]
    rows = np.arange(lo, lo + n_l, dtype=np.int32)
    c_rows = np.zeros((n_l, n), np.float32)
    c_rows[:n - lo] = c[lo:]
    c_cols = c[:, cols]
    ranks = np.arange(6, dtype=np.int32)
    want = jlevels.gather_s_cols(jnp.asarray(c_rows), jnp.asarray(c_cols), jnp.asarray(col_pos),
                                 jnp.asarray(adj), jnp.asarray(blk_c), jnp.asarray(blk_n),
                                 jnp.asarray(rows), jnp.asarray(ranks), ell=ell, n_max=npr)
    got = L.gather_s_cols(_t(c_rows), _t(c_cols), _t(col_pos), _t(adj), _t(blk_c), _t(blk_n),
                          _t(rows), _t(ranks), ell=ell, n_max=npr)
    for name, g, w in zip(("m2", "ci_s", "cj_s", "cij", "mask", "s_ids"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert not got[4][n - lo:].any()  # pad rows test nothing
    dense = L.gather_s(_t(c), _t(adj), _t(blk_c), _t(blk_n), _t(rows), _t(ranks), ell=ell,
                       n_max=npr)
    tau = threshold(2000, ell, 0.01)
    assert torch.equal(L.ci_sweep(*dense[:5], tau, ell=ell), L.ci_sweep(*got[:5], tau, ell=ell))


def test_subset_cols_matches_reference():
    c, _, _, cols, col_pos = _level1_state()
    block = c[:, cols]
    keep = cols[::2]
    pos = col_pos[keep]
    got = L.subset_cols(_t(block), _t(pos))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jlevels.subset_cols(
        jnp.asarray(block), jnp.asarray(pos))))
    np.testing.assert_array_equal(got.numpy(), c[:, keep])


@pytest.mark.parametrize("n_shards", [3, 4])
def test_commit_adj_and_sep_rows_match_reference(n_shards):
    """Random full-width winners over a level-1 state: ``commit_adj`` and
    every shard's ``commit_sep_rows`` (pad rows included) equal the JAX
    functions, and the shards' rows together equal ``_global_commit``."""
    c, adj, npr, _, _ = _level1_state()
    n = c.shape[0]
    rng = np.random.default_rng(n_shards)
    ell, depth = 2, 8
    compact = np.asarray(jcompact_rows(jnp.asarray(adj), n_prime=npr)[0])
    rem = (rng.random((n, npr)) < 0.3) & (compact >= 0)
    t_win = np.where(rem, rng.integers(0, 40, (n, npr)), jlevels._imax()).astype(np.int32)
    s_win = rng.integers(0, n, (n, npr, ell)).astype(np.int32)
    sep = rng.integers(-2, n, (n, n, depth)).astype(np.int32)
    rows = np.arange(n, dtype=np.int32)
    _, jkey = jlevels._commit_key_mat(jnp.asarray(compact), jnp.asarray(rows),
                                      jnp.asarray(t_win), jnp.asarray(rem), n)
    _, key = L._commit_key_mat(_t(compact), _t(rows), _t(t_win), _t(rem), n)
    np.testing.assert_array_equal(key.numpy(), np.asarray(jkey))
    np.testing.assert_array_equal(L.commit_adj(_t(adj), key).numpy(),
                                  np.asarray(jlevels.commit_adj(jnp.asarray(adj), jkey)))

    mesh = S.make_mesh(devices=("cpu",) * n_shards)
    sep_sh, _ = S.shard_rows(_t(sep), mesh, fill=-1)
    n_l = S.per_device_rows(n, mesh)
    blocks = []
    for k, blk in enumerate(sep_sh):
        row_ids = np.arange(k * n_l, (k + 1) * n_l, dtype=np.int32)
        got = L.commit_sep_rows(blk, _t(row_ids), _t(adj), key, _t(compact), _t(rem), _t(s_win),
                                ell)
        want = jlevels.commit_sep_rows(jnp.asarray(blk.numpy()), jnp.asarray(row_ids),
                                       jnp.asarray(adj), jkey, jnp.asarray(compact),
                                       jnp.asarray(rem), jnp.asarray(s_win), ell)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f"shard {k}")
        blocks.append(got)
    _, full = L._global_commit(_t(adj), _t(sep), _t(compact), _t(rows), _t(t_win), _t(rem),
                               _t(s_win), ell)
    assert torch.equal(torch.cat(blocks)[:n], full)


# ------------------------------------------------------- sharded batch axis
@pytest.fixture(scope="module")
def batch():
    m = 1500
    cs = np.stack([_jc(20, m, 0.2, s) for s in range(6)])
    ref = jscan.pc_scan_batch(jnp.asarray(cs), m, max_level=3)
    lv_ref, sched = jscan.scan_levels_batch(jnp.asarray(cs), m, max_level=3)
    return m, cs, ref, lv_ref, sched


@pytest.mark.parametrize("k", [4, 8])
def test_pc_scan_batch_sharded_matches_reference(k, batch):
    """B = 6 on K = 4 and 8 shards (identity-lane pad, two of them empty
    shards at K = 8): bitwise the JAX unsharded batch."""
    m, cs, ref, _, _ = batch
    got = scan_pc.pc_scan_batch(cs, m, max_level=3, mesh=S.make_mesh(devices=("cpu",) * k))
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                      err_msg=f)


@pytest.mark.parametrize("k", [4, 8])
def test_scan_levels_batch_sharded_matches_reference(k, batch):
    m, cs, _, ref, sched = batch
    mesh = S.make_mesh(devices=("cpu",) * k)
    got, got_sched = scan_pc.scan_levels_batch(cs, m, max_level=3, mesh=mesh)
    assert got_sched == sched
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                      err_msg=f)
    assert scan_pc.plan_schedule(cs, m, max_level=3, mesh=mesh) == sched


# ------------------------------------------------------------ sharded serving
def test_sharded_slots_bit_identical():
    """tests/test_serve.py's sharded scenario: a service whose slots shard
    over a mesh (2 CPU shards) delivers every graph bitwise equal to its
    solo ``pc_scan`` on the lane's C."""
    import repro_torch.serve as tserve

    def x_of(seed):
        x, _ = sample_gaussian_dag(n=12, m=400, density=0.12, seed=seed)
        return np.asarray(x, np.float32)

    svc = tserve.PCService(tserve.ServeConfig(mesh=S.make_mesh(devices=("cpu",) * 2)),
                           clock=tserve.ManualClock(), device="cpu")
    lanes = {rid: svc.submit(tserve.Request(rid=rid, x=x_of(seed)))[0]
             for rid, seed in (("a", 12), ("b", 13))}
    rep = svc.drain()
    assert not rep.dead_letters and not rep.rejections
    for rid, lane in lanes.items():
        g = rep.result(rid)
        solo = scan_pc.pc_scan(lane.c, 400, alpha=g.alpha, max_level=3, device="cpu")
        for f in ("adj", "cpdag", "sepsets"):
            np.testing.assert_array_equal(getattr(g, f), getattr(solo, f).numpy(),
                                          err_msg=f"{rid} {f}")


@pytest.mark.parametrize("ell", [1, 2, 3, 5, 8])
def test_sweep_terms_in_order_are_shape_independent(ell):
    """On the card ``ci_sweep`` sums its contractions in index order
    (``_sweep_terms_in_order``), because batched products pick their
    summation order by the batch's shape: a shard's or a smaller chunk's
    rows must decide as the whole batch does. The in-order terms of a row
    block equal the whole batch's rows bitwise, and agree with the einsums
    within fp32 rounding (rtol 1e-5, atol 1e-6)."""
    g = torch.Generator().manual_seed(ell)
    n, t, p = 9, 6, 5
    a = torch.randn(n, t, ell, ell, generator=g)
    m2 = a @ a.transpose(-1, -2) + ell * torch.eye(ell)
    ci = 0.3 * torch.randn(n, t, ell, generator=g)
    cj = 0.3 * torch.randn(n, t, p, ell, generator=g)
    cij = (0.3 * torch.randn(n, 1, p, generator=g)).expand(n, t, p)
    inv = L._set_inverse(m2, ell)
    whole = L._sweep_terms_in_order(inv, ci, cj, cij, ell)
    block = L._sweep_terms_in_order(inv[3:7, :4], ci[3:7, :4], cj[3:7, :4], cij[3:7, :4], ell)
    for w, b in zip(whole, block):
        assert torch.equal(w[3:7, :4], b)
    u = torch.einsum("ntab,ntb->nta", inv, ci)
    want = (cij - torch.einsum("ntpl,ntl->ntp", cj, u),
            1.0 - torch.einsum("nta,nta->nt", ci, u),
            1.0 - torch.einsum("ntpa,ntpa->ntp", cj, torch.einsum("ntab,ntpb->ntpa", inv, cj)))
    for got, ref in zip(whole, want):
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6)
