"""The port's grid-resident cuPC-S (``repro_torch.kernels.sgrid``) against
the JAX package's ``ops.ci_shared_grid``, which runs the Pallas
``sgrid_kernel`` in interpret mode here: the gathered entry on the same
random gathered launches (SPD m2, a per-rank cij, a random mask and set
ids), the fused entry (C, adjacency, neighbour lists and planned sets)
on a small correlation matrix against JAX's ``levels.gather_s`` feeding
``ci_shared_grid``.

The winners (t_loc, s_win) must be equal in every (row, slot) whose
winner does not move when the port's plain version is re-run at
τ ± 1e-4 (tests/test_kernels.py:102-108's band); the band cells are
counted and asserted few. The ``cuda`` tests hold both kernel entries to
their plain versions on the card and skip without one.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import levels as jlevels  # noqa: E402
from repro.core.cit import correlation_from_samples, threshold  # noqa: E402
from repro.core.compact import compact_rows as jcompact_rows  # noqa: E402
from repro.data.synthetic_dag import sample_gaussian_dag  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import levels as L  # noqa: E402
from repro_torch.core.compact import compact_rows  # noqa: E402
from repro_torch.kernels import build, ops, sgrid  # noqa: E402

pytestmark = pytest.mark.torch

BAND = 1e-4
TAU = 0.05


def _launch(rng, n_l, t_len, npr, ell, expand_cij=False):
    """A random gathered launch in the batch-first layout."""
    a = rng.normal(size=(n_l, t_len, ell, ell)).astype(np.float32)
    m2 = a @ np.swapaxes(a, -1, -2) / ell + 0.5 * np.eye(ell, dtype=np.float32)
    ci_s = (rng.normal(size=(n_l, t_len, ell)) * 0.3).astype(np.float32)
    cj_s = (rng.normal(size=(n_l, t_len, npr, ell)) * 0.3).astype(np.float32)
    if expand_cij:
        cij = np.broadcast_to((rng.normal(size=(n_l, 1, npr)) * 0.3).astype(np.float32),
                              (n_l, t_len, npr))
    else:
        cij = (rng.normal(size=(n_l, t_len, npr)) * 0.3).astype(np.float32)
    mask = rng.random((n_l, t_len, npr)) < 0.7
    s_ids = rng.integers(0, 1000, size=(n_l, t_len, ell)).astype(np.int32)
    return m2, ci_s, cj_s, cij, mask, s_ids


def _band_counts(got, want, lo, hi):
    """(# (row, slot) cells that differ, # of them outside the band, # band
    cells): a cell is in the band when its winner moves between τ − 1e-4
    and τ + 1e-4."""
    (t_g, s_g), (t_w, s_w) = got, want
    diff = (np.asarray(t_g) != np.asarray(t_w)) | (np.asarray(s_g) != np.asarray(s_w)).any(-1)
    band = np.asarray(lo[0]) != np.asarray(hi[0])
    return int(diff.sum()), int((diff & ~band).sum()), int(band.sum())


@pytest.mark.parametrize("ell", [1, 2, 3, 4, 6, 8])
def test_sgrid_plain_matches_reference(ell):
    """40 rows × 13 ranks × 9 slots: ragged against the reference's
    (8, 128) tiles, so its padding is exercised too."""
    args = _launch(np.random.default_rng(ell), 40, 13, 9, ell)
    t_j, s_j = jops.ci_shared_grid(*(jnp.asarray(a) for a in args), TAU, ell=ell)
    targs = [torch.tensor(np.ascontiguousarray(a)) for a in args]
    got = ops.ci_shared_grid(*targs, TAU, ell=ell)
    lo = sgrid.sgrid_plain(*targs, TAU - BAND)
    hi = sgrid.sgrid_plain(*targs, TAU + BAND)
    n_diff, outside, n_band = _band_counts(got, (t_j, s_j), lo, hi)
    assert outside == 0, f"{outside} winners differ outside the τ band"
    assert n_diff <= n_band <= 8, (n_diff, n_band)
    t_loc, s_win = (t.numpy() for t in got)
    found = t_loc < sgrid.SENTINEL
    assert 0 < found.sum() < found.size, "the fixture should separate some slots, not all"
    assert (s_win[~found] == 0).all()
    assert ((t_loc[found] >= 0) & (t_loc[found] < 13)).all()


def test_sgrid_plain_expanded_cij_and_mask_dtypes():
    """cij as the gather hands it over (an expanded view) and the mask as
    uint8 give the same winners as materialised bool inputs."""
    args = _launch(np.random.default_rng(7), 12, 20, 6, 2, expand_cij=True)
    m2, ci_s, cj_s, cij, mask, s_ids = (torch.tensor(np.ascontiguousarray(a)) for a in args)
    view = cij[:, :1, :].expand(-1, 20, -1)
    a = sgrid.sgrid(m2, ci_s, cj_s, view, mask.to(torch.uint8), s_ids, TAU)
    b = sgrid.sgrid(m2, ci_s, cj_s, cij, mask, s_ids, TAU)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_sgrid_rejects_bad_inputs():
    m2, ci_s, cj_s, cij, mask, s_ids = (torch.tensor(np.ascontiguousarray(a))
                                        for a in _launch(np.random.default_rng(0), 3, 4, 5, 2))
    with pytest.raises(ValueError, match="shapes"):
        sgrid.sgrid(m2, ci_s, cj_s[:, :, :4], cij, mask, s_ids, TAU)
    with pytest.raises(ValueError, match="float32"):
        sgrid.sgrid(m2.double(), ci_s, cj_s, cij, mask, s_ids, TAU)
    with pytest.raises(ValueError, match="int32"):
        sgrid.sgrid(m2, ci_s, cj_s, cij, mask, s_ids.long(), TAU)
    with pytest.raises(ValueError, match="ℓ"):
        ops.ci_shared_grid(m2, ci_s, cj_s, cij, mask, s_ids, TAU, ell=3)


def _fused_launch(ell, seed, n=14, m=40):
    """A small C from seeded samples, a random symmetric adjacency whose
    degrees run from 0 to most of the row (so some rows have fewer sets
    than the launch has ranks), and its neighbour lists."""
    x, _ = sample_gaussian_dag(n=n, m=m, density=0.4, seed=seed)
    c = np.array(correlation_from_samples(jnp.asarray(x)))
    rng = np.random.default_rng(seed)
    p = np.linspace(0.0, 0.9, n)[:, None]
    adj = rng.random((n, n)) < np.maximum(p, p.T)
    adj = np.triu(adj, 1)
    adj = adj | adj.T
    adj[0, :] = adj[:, 0] = False  # a row with no edge
    npr_b = L.bucket_npr(int(adj.sum(1).max()))
    comp, counts = jcompact_rows(jnp.asarray(adj), n_prime=npr_b)
    return c, adj, np.asarray(comp), np.asarray(counts), npr_b


# ell, first rank, ranks, first row: the row blocks are the whole C or a
# part of it; every case leaves some rows with invalid ranks
FUSED_CASES = [(1, 0, 12, 0), (2, 5, 20, 3), (3, 0, 30, 0)]


@pytest.mark.parametrize("ell,t0,t_len,row0", FUSED_CASES)
def test_sgrid_fused_plain_matches_reference(ell, t0, t_len, row0):
    """The fused entry's plain version (planned sets → gather_sets →
    sgrid_plain) against JAX's gather_s → ci_shared_grid."""
    c, adj, comp, counts, npr_b = _fused_launch(ell, seed=10 + ell)
    n = c.shape[0]
    rows = np.arange(row0, n, dtype=np.int32)
    comp, counts = comp[row0:], counts[row0:]
    tau = threshold(40, ell, 0.05)
    ranks = np.arange(t0, t0 + t_len, dtype=np.int32)
    gathered = jlevels.gather_s(jnp.asarray(c), jnp.asarray(adj), jnp.asarray(comp),
                                jnp.asarray(counts), jnp.asarray(rows), jnp.asarray(ranks),
                                ell=ell, n_max=npr_b)
    want = jops.ci_shared_grid(*gathered, tau, ell=ell)
    t = torch.tensor
    _, valid = L.plan_sets(t(comp), t(counts), t(ranks), ell=ell, n_max=npr_b, n=n)
    assert not bool(valid.all()) and bool(valid.any()), "the launch needs invalid ranks too"
    args = (t(c), t(adj), t(comp), t(counts), t(rows), torch.tensor(t0, dtype=torch.int32))
    kw = dict(ell=ell, n_chunk=t_len, n_max=npr_b)
    got, lo, hi = (sgrid.sgrid_fused(*args, tau + d, **kw) for d in (0.0, -BAND, BAND))
    n_diff, outside, n_band = _band_counts(got, want, lo, hi)
    assert outside == 0, f"{outside} winners differ outside the τ band"
    assert n_diff <= n_band <= 4, (n_diff, n_band)
    t_loc = got[0].numpy()
    found = t_loc < sgrid.SENTINEL
    assert 0 < found.sum() < (comp >= 0).sum(), "some slots should separate, not all"
    assert not found[rows == 0].any(), "a row with no edge has no winner"


def test_s_grid_path_forms_no_gather(monkeypatch):
    """ops.chunk_s_grid hands C, the neighbour lists and the first rank to
    the fused entry: levels.gather_s, which forms the (n, T, n′) tensors,
    is never called on the "S-grid" path (on the card neither is
    plan_sets nor gather_sets: ``test_cuda_sgrid_fused_matches_plain``)."""
    c, adj, comp, counts, npr_b = _fused_launch(2, seed=4)
    t = torch.tensor
    sep = torch.full(adj.shape + (8,), -1, dtype=torch.int32)
    kw = dict(ell=2, n_chunk=8, n_max=npr_b)
    t0 = torch.tensor(0, dtype=torch.int32)
    want = L.chunk_s(t(c), t(adj), sep, t(comp), t(counts), t0, 0.3, **kw)
    calls = []
    fused = sgrid.sgrid_fused
    monkeypatch.setattr(sgrid, "sgrid_fused", lambda *a, **k: calls.append(1) or fused(*a, **k))

    def no_gather(*a, **k):
        raise AssertionError("levels.gather_s called on the S-grid path")

    monkeypatch.setattr(L, "gather_s", no_gather)
    got = ops.chunk_s_grid(t(c), t(adj), sep, t(comp), t(counts), t0, 0.3, **kw)
    assert calls == [1]
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# ------------------------------------------------------------- on the card
@pytest.mark.cuda
def test_cuda_sgrid_matches_plain():
    """The sgrid kernel against its plain version on the card, ℓ ∈ {1, 2, 3,
    8}, at a few shapes (one tile, several tiles, more slots than a block
    has threads), with the gather's expanded cij; counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the sgrid kernel has no CPU mode")
    dev = torch.device("cuda")
    build.reset_launches()
    cases = [(1, 50, 32, 300), (2, 30, 70, 9), (3, 17, 40, 33), (8, 9, 35, 12)]
    for k, (ell, n_l, t_len, npr) in enumerate(cases):
        args = _launch(np.random.default_rng(100 + k), n_l, t_len, npr, ell, expand_cij=True)
        m2, ci_s, cj_s, cij, mask, s_ids = (torch.tensor(np.ascontiguousarray(a), device=dev)
                                            for a in args)
        cij = cij[:, :1, :].expand(-1, t_len, -1)
        got = sgrid.sgrid(m2, ci_s, cj_s, cij, mask, s_ids, TAU)
        want = sgrid.sgrid_plain(m2, ci_s, cj_s, cij, mask, s_ids, TAU)
        lo = sgrid.sgrid_plain(m2, ci_s, cj_s, cij, mask, s_ids, TAU - BAND)
        hi = sgrid.sgrid_plain(m2, ci_s, cj_s, cij, mask, s_ids, TAU + BAND)
        cpu = [tuple(t.cpu() for t in r) for r in (got, want, lo, hi)]
        n_diff, outside, _ = _band_counts(*cpu)
        assert outside == 0 and n_diff <= 2, (ell, n_diff, outside)
    torch.cuda.synchronize()
    assert build.LAUNCHES["sgrid"] == len(cases)


@pytest.mark.cuda
def test_cuda_sgrid_fused_matches_plain(monkeypatch):
    """The fused entry against its plain version on the card, ℓ ∈ {1, 2, 3,
    8}: a launch of one tile with n′ ≥ 128 (one lane a slot), small n′
    (several lanes a slot), more ranks than a tile, a row block, int64
    ranks, rows with invalid ranks and a row with no edge; counted under
    "sgrid". Neither the unrank nor the gather of ``levels`` runs, and the
    launch allocates its outputs and Cᵀ alone."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the sgrid kernel has no CPU mode")
    dev = torch.device("cuda")
    cases = [(1, 0, 32, 0, 160, 1190, torch.int32), (2, 3, 300, 5, 14, 20, torch.int64),
             (3, 0, 200, 0, 40, 33, torch.int32), (8, 10, 40, 2, 30, 24, torch.int32)]
    build.reset_launches()
    for ell, t0, t_len, row0, n, deg, rank_dtype in cases:
        x, _ = sample_gaussian_dag(n=n, m=60, density=0.3, seed=ell)
        c = torch.tensor(np.array(correlation_from_samples(jnp.asarray(x))), device=dev)
        rng = np.random.default_rng(ell)
        adj = np.triu(rng.random((n, n)) < min(0.9, deg / n), 1)
        adj = adj | adj.T
        adj[1, :] = adj[:, 1] = False
        adj = torch.tensor(adj, device=dev)
        npr_b = L.bucket_npr(int(adj.sum(1).max()))
        comp, counts = compact_rows(adj, n_prime=npr_b)
        comp, counts = comp[row0:].contiguous(), counts[row0:].contiguous()
        rows = torch.arange(row0, n, dtype=torch.int32, device=dev)
        t0_t = torch.tensor(t0, dtype=rank_dtype, device=dev)
        tau = threshold(60, ell, 0.05)
        args = (c, adj, comp, counts, rows, t0_t)
        kw = dict(ell=ell, n_chunk=t_len, n_max=npr_b)
        L._jtable(npr_b, torch.int64, c.device)  # the cached binomial table, made before
        monkeypatch.setattr(L, "plan_sets", None)
        monkeypatch.setattr(L, "gather_sets", None)
        monkeypatch.setattr(L, "gather_s", None)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        got = sgrid.sgrid_fused(*args, tau, c_t=c.T.contiguous(), **kw)
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated() - base
        monkeypatch.undo()
        # the outputs and Cᵀ, in 512-byte blocks
        n_l = comp.shape[0]
        small = sum(-(-b // 512) * 512 for b in (n_l * npr_b * 4, n_l * npr_b * ell * 4,
                                                   n * n * 4))
        assert extra <= small < n_l * t_len * npr_b * 4, (extra, small)
        plain = [sgrid.sgrid_fused(*(a.cpu() for a in args), tau + d, **kw)
                 for d in (0, -BAND, BAND)]
        n_diff, outside, _ = _band_counts(tuple(a.cpu() for a in got), *plain)
        assert outside == 0 and n_diff <= 2, (ell, n_diff, outside)
        assert bool((got[0] < sgrid.SENTINEL).any()), ell
    torch.cuda.synchronize()
    assert build.LAUNCHES["sgrid"] == len(cases)
