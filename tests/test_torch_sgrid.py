"""The port's grid-resident cuPC-S (``repro_torch.kernels.sgrid``) against
the JAX package's ``ops.ci_shared_grid``, which runs the Pallas
``sgrid_kernel`` in interpret mode here, on the same random gathered
launches (SPD m2, a per-rank cij, a random mask and set ids).

The winners (t_loc, s_win) must be equal in every (row, slot) whose
winner does not move when the port's plain version is re-run at
τ ± 1e-4 (tests/test_kernels.py:102-108's band); the band cells are
counted and asserted few. ``test_cuda_sgrid_matches_plain`` holds the
kernel to its plain version on the card and skips without one.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
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
