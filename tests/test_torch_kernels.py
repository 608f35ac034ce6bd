"""The port's kernel modules against the JAX kernels on the same inputs.

The JAX kernels run in Pallas interpret mode (``repro.kernels.ops``) or
through their oracles (``repro.kernels.ref``); the port's wrappers get CPU
tensors and so run their plain PyTorch versions. Tolerances:

* correlation: atol 2e-6 (tests/test_kernels.py:26); on the card the kernel
  is also bitwise symmetric and bitwise equal from call to call;
* cholinv g/u/var: rtol 1e-5, atol 1e-6;
* decisions (level 0, level 1 removed/kwin, ci_shared): equal except
  cells whose statistic lies within τ ± 1e-4, found by re-running the
  port at τ ± 1e-4 as tests/test_kernels.py:102-108 does; those cells
  are counted and asserted few.

``test_cuda_kernels_match_plain`` needs the card and skips without one.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import cit as jcit, levels as jlevels  # noqa: E402
from repro.kernels import cholinv as jcholinv, ops as jops, ref as jref  # noqa: E402
from repro_torch.core import cit, levels as L  # noqa: E402
from repro_torch.kernels import build, cholinv, cisweep, corr, level1, ops  # noqa: E402

pytestmark = pytest.mark.torch

BAND = 1e-4


def _corr_like(rng, n, scale):
    c = np.clip(rng.normal(0, scale, size=(n, n)), -0.99, 0.99).astype(np.float32)
    c = (c + c.T) / 2
    np.fill_diagonal(c, 1.0)
    return c


def _spd_batch(rng, b, p, ell):
    a = rng.normal(size=(b, ell, ell)).astype(np.float32)
    m2 = a @ a.transpose(0, 2, 1) + 0.5 * np.eye(ell, dtype=np.float32)
    ci_s = (rng.normal(size=(b, ell)) * 0.3).astype(np.float32)
    cj_s = (rng.normal(size=(b, p, ell)) * 0.3).astype(np.float32)
    cij = (rng.normal(size=(b, p)) * 0.5).astype(np.float32)
    mask = rng.random((b, p)) < 0.8
    return m2, ci_s, cj_s, cij, mask


def _assert_band_only(got, want, lo, hi, max_band):
    """got/want differ only where the decision moves inside τ ± BAND."""
    diff = np.asarray(got) != np.asarray(want)
    moves = np.asarray(lo) != np.asarray(hi)
    assert not (diff & ~moves).any(), f"{int((diff & ~moves).sum())} cells differ outside the band"
    assert diff.sum() <= max_band, f"{int(diff.sum())} band cells differ"


# ------------------------------------------------------------------ corr
@pytest.mark.parametrize("m,n", [(64, 32), (300, 70), (100, 257)])
def test_correlation_matches_reference(m, n):
    x = np.random.default_rng(m * n).normal(size=(m, n)).astype(np.float32)
    got = ops.correlation(torch.tensor(x)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(jops.correlation(jnp.asarray(x))), atol=2e-6)
    np.testing.assert_allclose(got, np.asarray(jref.corr_ref(jnp.asarray(x))), atol=2e-6)
    plain = cit.correlation_from_samples(torch.tensor(x)).numpy()
    np.testing.assert_allclose(
        plain, np.asarray(jcit.correlation_from_samples(jnp.asarray(x))), atol=2e-6)


def test_corr_matmul_plain_is_the_product():
    xn = np.random.default_rng(3).normal(size=(50, 20)).astype(np.float32)
    got = corr.corr_matmul(torch.tensor(xn)).numpy()
    want = (xn.astype(np.float64).T @ xn.astype(np.float64)) / 50
    np.testing.assert_allclose(got, want, atol=1e-6)


# --------------------------------------------------------------- level 0
@pytest.mark.parametrize("n", [16, 300])
@pytest.mark.parametrize("tau", [0.01, 0.1, 0.5])
def test_level0_matches_reference(n, tau):
    c = _corr_like(np.random.default_rng(n), n, 0.4)
    ct = torch.tensor(c)
    got = L.level0(ct, tau).numpy()
    lo, hi = L.level0(ct, tau - BAND).numpy(), L.level0(ct, tau + BAND).numpy()
    _assert_band_only(got, np.asarray(jops.level0(jnp.asarray(c), tau)), lo, hi, 2)
    _assert_band_only(got, np.asarray(jref.level0_ref(jnp.asarray(c), tau)), lo, hi, 2)
    _assert_band_only(got, np.asarray(jlevels.level0(jnp.asarray(c), tau)), lo, hi, 2)


# --------------------------------------------------------------- level 1
@pytest.mark.parametrize("n", [16, 64, 130])
@pytest.mark.parametrize("tau", [0.02, 0.2])
def test_level1_matches_reference(n, tau):
    rng = np.random.default_rng(100 + n)
    c = _corr_like(rng, n, 0.35)
    adj = np.triu(rng.random((n, n)) < 0.4, 1)
    adj = adj | adj.T
    ct, at = torch.tensor(c), torch.tensor(adj)
    rem, kwin = ops.level1_dense(ct, at, tau)
    assert rem.dtype == torch.bool and kwin.dtype == torch.int32
    rem_j, kwin_j = jops.level1_dense(jnp.asarray(c), jnp.asarray(adj), tau)
    rem_lo, kwin_lo = ops.level1_dense(ct, at, tau - BAND)
    rem_hi, kwin_hi = ops.level1_dense(ct, at, tau + BAND)
    _assert_band_only(rem.numpy(), rem_j, rem_lo.numpy(), rem_hi.numpy(), 2)
    _assert_band_only(kwin.numpy(), kwin_j, kwin_lo.numpy(), kwin_hi.numpy(), 2)
    # the block size of the chunked plain version changes nothing
    r2, k2 = level1.level1_dense_plain(ct, at, tau, block=7)
    assert torch.equal(r2, rem) and torch.equal(k2, kwin)


# ------------------------------------------------------- cholinv + cisweep
def _jax_cholinv(m2, ci_s, ell):
    """The Pallas cholinv kernel on a batch-first batch (identity-padded
    SoA layout of ops.ci_shared), returned batch-first."""
    b = m2.shape[0]
    b_pad = -(-b // 1024) * 1024
    m2p = np.broadcast_to(np.eye(ell, dtype=np.float32), (b_pad, ell, ell)).copy()
    m2p[:b] = m2
    cip = np.zeros((b_pad, ell), np.float32)
    cip[:b] = ci_s
    m2_k = m2p.transpose(1, 2, 0).reshape(ell, ell, b_pad // 128, 128)
    ci_k = cip.T.reshape(ell, b_pad // 128, 128)
    g, u, var = jcholinv.cholinv_kernel(jnp.asarray(m2_k), jnp.asarray(ci_k), ell=ell,
                                        interpret=True)
    g = np.asarray(g).reshape(ell, ell, b_pad).transpose(2, 0, 1)[:b]
    return g, np.asarray(u).reshape(ell, b_pad).T[:b], np.asarray(var).reshape(b_pad)[:b]


@pytest.mark.parametrize("ell", [1, 2, 3, 4, 6, 8])
@pytest.mark.parametrize("b", [64, 500])
def test_cholinv_matches_reference(ell, b):
    m2, ci_s, *_ = _spd_batch(np.random.default_rng(ell * 1000 + b), b, 1, ell)
    g, u, var = cholinv.cholinv(torch.tensor(m2), torch.tensor(ci_s))
    g_j, u_j, var_j = _jax_cholinv(m2, ci_s, ell)
    for got, want in ((g, g_j), (u, u_j), (var, var_j)):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("ell", [2, 3, 8])
@pytest.mark.parametrize("b,p", [(500, 11)])
def test_ci_shared_matches_reference(ell, b, p):
    m2, ci_s, cj_s, cij, mask = _spd_batch(np.random.default_rng(ell * 7 + b + p), b, p, ell)
    args = [torch.tensor(a) for a in (m2, ci_s, cj_s, cij, mask)]
    tau = 0.2
    got = ops.ci_shared(*args, tau, ell=ell).numpy()
    want = np.asarray(jops.ci_shared(*(jnp.asarray(a) for a in (m2, ci_s, cj_s, cij, mask)),
                                     tau, ell=ell))
    lo = ops.ci_shared(*args, tau - BAND, ell=ell).numpy()
    hi = ops.ci_shared(*args, tau + BAND, ell=ell).numpy()
    _assert_band_only(got, want, lo, hi, 2)
    # the sweep alone, fed the reference's own g/u/var, against cisweep_ref
    g, u, var = jref.cholinv_ref(jnp.asarray(m2), jnp.asarray(ci_s))
    shared = [torch.tensor(np.asarray(a)) for a in (g, u, var)]
    sweep = [cisweep.cisweep(*shared, *args[2:], t).numpy() for t in (tau, tau - BAND, tau + BAND)]
    want = np.asarray(jref.cisweep_ref(g, u, var, jnp.asarray(cj_s), jnp.asarray(cij),
                                       jnp.asarray(mask), tau))
    _assert_band_only(sweep[0], want, sweep[1], sweep[2], 2)


def test_wrappers_reject_bad_inputs():
    c = torch.zeros((4, 4))
    with pytest.raises(ValueError):
        level1.level1_dense_kernel(c.double(), torch.zeros((4, 4), dtype=torch.bool), 0.1)
    with pytest.raises(ValueError):
        level1.level1_dense_kernel(c, torch.zeros((4, 4), dtype=torch.int32), 0.1)
    with pytest.raises(ValueError):
        cholinv.cholinv(torch.zeros((3, 9, 9)), torch.zeros((3, 9)))
    with pytest.raises(ValueError):
        cisweep.cisweep(torch.zeros((2, 2, 2)), torch.zeros((2, 2)), torch.zeros(2),
                        torch.zeros((2, 3, 2)), torch.zeros((2, 3)), torch.zeros((2, 4)), 0.1)
    with pytest.raises(ValueError):
        corr.corr_matmul(torch.zeros((3, 4), dtype=torch.float64))
    with pytest.raises(ValueError, match="CUDA"):
        build.require_cuda(torch.zeros(2))


@pytest.mark.parametrize("m,n", [(47, 1190), (10000, 1000), (10000, 300), (1003, 517), (1, 1),
                                 (200, 70), (100000, 4000)])
@pytest.mark.parametrize("sms", [1, 132])
def test_corr_plan_covers_every_slab(m, n, sms):
    """The split plan of the corr kernel: every upper tile, every sample
    slab in exactly one split, none empty, at most MAX_SPLITS; 64-wide tiles
    and one split (a direct launch) exactly where m ≤ 512."""
    tile, tiles, splits, sps = corr.plan(m, n, sms)
    nt = -(-n // tile)
    slabs = -(-m // corr.SLAB[tile])
    assert tiles == nt * (nt + 1) // 2
    assert 1 <= splits <= corr.MAX_SPLITS
    assert (splits - 1) * sps < slabs <= splits * sps
    assert (tile == corr.SMALL_TILE) == (m <= corr.DIRECT_MAX_M)
    assert tile == corr.TILE or splits == 1
    if sms == 1:  # one block at a time: splitting only adds overhead
        assert splits == 1


def test_corr_plan_fills_the_card_at_the_paper_shapes():
    assert corr.plan(10000, 1000, 132) == (128, 36, 11, 29)  # 396 blocks: 3 full waves
    assert corr.plan(47, 1190, 132) == (64, 190, 1, 3)
    assert corr.plan(100, 2000, 132) == (64, 528, 1, 7)
    assert corr.plan(513, 1000, 132) == (128, 36, 3, 6)  # the smallest split-K m


# ------------------------------------------------------------- on the card
@pytest.mark.cuda
def test_cuda_kernels_match_plain():
    """Each hand kernel against its plain version on the card, counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    rng = np.random.default_rng(5)
    build.reset_launches()
    # corr: atol 2e-6, bitwise symmetric and bitwise equal across two calls;
    # ragged m and n (16-byte and 4-byte copies), m = 1, n = 1, written
    # directly (m ≤ 512, 64-wide tiles; one launch), split-K (two launches),
    # and splits of several 512-sample groups each (m = 20 000 over one tile)
    corr_shapes = ((200, 70), (1003, 517), (999, 260), (1, 40), (50, 1), (1, 1), (47, 1190),
                   (100, 2000), (64, 2050), (300, 256), (513, 1000), (10000, 300), (20000, 64))
    for m, n in corr_shapes:
        x = torch.tensor(rng.normal(size=(m, n)), dtype=torch.float32, device=dev)
        xn = ops.standardize(x).contiguous() if m > 1 else x
        got = corr.corr_matmul(xn)
        assert (got - corr.corr_matmul_plain(xn)).abs().max() <= 2e-6, (m, n)
        assert torch.equal(got, got.T), (m, n)
        assert torch.equal(got, corr.corr_matmul(xn)), (m, n)
    c = torch.tensor(_corr_like(rng, 70, 0.35), device=dev)
    adj = torch.tensor(rng.random((70, 70)) < 0.4, device=dev)
    adj = (adj | adj.T) & ~torch.eye(70, dtype=torch.bool, device=dev)
    for tau in (0.02, 0.2):
        got = level1.level1_dense_kernel(c, adj, tau)
        want = level1.level1_dense_plain(c, adj, tau)
        lo = level1.level1_dense_plain(c, adj, tau - BAND)
        hi = level1.level1_dense_plain(c, adj, tau + BAND)
        for k in range(2):
            _assert_band_only(got[k].cpu(), want[k].cpu(), lo[k].cpu(), hi[k].cpu(), 2)
    for ell in (1, 2, 3, 8):
        m2, ci_s, cj_s, cij, mask = (torch.tensor(a, device=dev)
                                     for a in _spd_batch(rng, 300, 9, ell))
        gk = cholinv.cholinv(m2, ci_s)
        gp = cholinv.cholinv_plain(m2, ci_s)
        for a, b in zip(gk, gp):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
        got = cisweep.cisweep(*gk, cj_s, cij, mask, 0.2).cpu()
        want = cisweep.cisweep_plain(*gk, cj_s, cij, mask, 0.2).cpu()
        lo = cisweep.cisweep_plain(*gk, cj_s, cij, mask, 0.2 - BAND).cpu()
        hi = cisweep.cisweep_plain(*gk, cj_s, cij, mask, 0.2 + BAND).cpu()
        _assert_band_only(got, want, lo, hi, 2)
    torch.cuda.synchronize()
    corr_launches = sum(2 * (1 if m <= corr.DIRECT_MAX_M else 2) for m, _ in corr_shapes)
    assert build.LAUNCHES == {"corr": corr_launches, "level0": 0, "level1": 2,
                              "cholinv": 4, "cisweep": 4,
                              "gsq": 0, "sgrid": 0}
