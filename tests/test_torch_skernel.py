"""The port's fused S-kernel (``repro_torch.kernels.skernel``) against the
JAX package: the plain version (planned sets → gathered operands → the
plain cholinv and cisweep → least rank per slot) against JAX's
``levels.gather_s`` feeding ``ops.ci_shared``, which runs the Pallas
cholinv and cisweep kernels in interpret mode here, followed by the least
separating rank of each (row, slot); and ``ops.chunk_s_kernel`` against
JAX's ``ops.chunk_s_kernel`` and the port's ``levels.chunk_s``.

The fixtures hold rows with fewer than ℓ + 1 neighbours, a row with no
edge, padded slots (n′ bucketed past the row's count) and dead edges
(slots whose edge an earlier chunk removed: in the neighbour list, not in
the adjacency). Winners must be equal in every (row, slot) whose winner
does not move when the port's plain version is re-run at τ ± 1e-4
(tests/test_kernels.py:102-108's band); the band cells are counted and
asserted few. The ``cuda`` tests hold the kernel bitwise to the two
gathered kernels it replaces and skip without a card.
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
from repro_torch.core import engines, levels as L  # noqa: E402
from repro_torch.core.compact import compact_rows  # noqa: E402
from repro_torch.kernels import build, ops, skernel  # noqa: E402

pytestmark = pytest.mark.torch

BAND = 1e-4


def _fixture(seed, n=16, m=40, dead=0.15):
    """(C, alive adjacency, neighbour lists and counts of the adjacency
    before the dead edges were removed, n′ bucket): a small C from seeded
    samples; a random symmetric adjacency whose degrees run from 0 to most
    of the row, with row 0 edgeless and the last rows of degree 1–4; then
    a share of its edges removed from the adjacency but kept in the lists,
    as a level's later chunks see the edges its earlier chunks removed."""
    x, _ = sample_gaussian_dag(n=n, m=m, density=0.4, seed=seed)
    c = np.array(correlation_from_samples(jnp.asarray(x)))
    rng = np.random.default_rng(seed)
    p = np.linspace(0.0, 0.9, n)[:, None]
    adj = np.triu(rng.random((n, n)) < np.maximum(p, p.T), 1)
    adj[0, :] = False
    adj = adj | adj.T
    for d in range(1, 5):  # the last rows keep d neighbours among the first rows
        k = n - d
        keep = np.flatnonzero(adj[k, : n - 4])[:d]
        adj[k, :] = adj[:, k] = False
        adj[k, keep] = adj[keep, k] = True
    npr_b = L.bucket_npr(int(adj.sum(1).max()))
    comp, counts = jcompact_rows(jnp.asarray(adj), n_prime=npr_b)
    kill = np.triu(rng.random((n, n)) < dead, 1)
    alive = adj & ~(kill | kill.T)
    return c, alive, np.asarray(comp), np.asarray(counts), npr_b


def _jax_winners(c, adj, comp, counts, rows, ranks, tau, ell, npr_b):
    """JAX's gather_s → ci_shared (interpret-mode Pallas cholinv and
    cisweep) → the least separating launch-local rank per (row, slot) and
    its set, in the kernel's form (SENTINEL and 0 where none)."""
    m2, ci_s, cj_s, cij, mask, s_ids = jlevels.gather_s(
        jnp.asarray(c), jnp.asarray(adj), jnp.asarray(comp), jnp.asarray(counts),
        jnp.asarray(rows), jnp.asarray(ranks), ell=ell, n_max=npr_b)
    n_l, t_len, npr = mask.shape
    b = n_l * t_len
    found = np.asarray(jops.ci_shared(m2.reshape(b, ell, ell), ci_s.reshape(b, ell),
                                      cj_s.reshape(b, npr, ell), cij.reshape(b, npr),
                                      mask.reshape(b, npr), tau, ell=ell)).reshape(n_l, t_len, npr)
    any_ = found.any(axis=1)
    first = np.argmax(found, axis=1)
    t_loc = np.where(any_, first, skernel.SENTINEL).astype(np.int32)
    s_win = np.take_along_axis(np.asarray(s_ids), first[..., None], axis=1)
    return t_loc, np.where(any_[..., None], s_win, 0).astype(np.int32)


def _band_counts(got, want, lo, hi):
    """(# differing (row, slot) cells, # of them outside the band, # band
    cells): a cell is in the band when its winner moves between τ − 1e-4
    and τ + 1e-4."""
    (t_g, s_g), (t_w, s_w) = got, want
    diff = (np.asarray(t_g) != np.asarray(t_w)) | (np.asarray(s_g) != np.asarray(s_w)).any(-1)
    band = np.asarray(lo[0]) != np.asarray(hi[0])
    return int(diff.sum()), int((diff & ~band).sum()), int(band.sum())


# ell, first rank, its dtype, ranks in the launch, first row of the block
CASES = [(1, 0, torch.int32, 12, 0), (1, 3, torch.int64, 8, 2), (2, 0, torch.int32, 24, 0),
         (2, 9, torch.int64, 30, 5), (3, 0, torch.int32, 40, 0), (3, 21, torch.int32, 40, 3),
         (4, 0, torch.int32, 40, 0), (4, 13, torch.int64, 50, 1)]


@pytest.mark.parametrize("ell,t0,rank_dtype,t_len,row0", CASES)
def test_skernel_plain_matches_reference(ell, t0, rank_dtype, t_len, row0):
    c, alive, comp, counts, npr_b = _fixture(seed=20 + ell)
    n = c.shape[0]
    rows = np.arange(row0, n, dtype=np.int32)
    comp, counts = comp[row0:], counts[row0:]
    tau = threshold(40, ell, 0.05)
    ranks = np.arange(t0, t0 + t_len, dtype=np.int32)
    want = _jax_winners(c, alive, comp, counts, rows, ranks, tau, ell, npr_b)
    t = torch.tensor
    args = (t(c), t(alive), t(comp), t(counts), t(rows), torch.tensor(t0, dtype=rank_dtype))
    kw = dict(ell=ell, n_chunk=t_len, n_max=npr_b)
    got, lo, hi = (skernel.skernel_fused(*args, tau + d, **kw) for d in (0.0, -BAND, BAND))
    n_diff, outside, n_band = _band_counts(got, want, lo, hi)
    assert outside == 0, f"{outside} winners differ outside the τ band"
    assert n_diff <= n_band <= 4, (n_diff, n_band)
    # the fixture's edge cases: some slots separate, not all; rows with
    # fewer than ℓ + 1 neighbours, padded slots and dead edges never win
    t_loc = got[0].numpy()
    found = t_loc < skernel.SENTINEL
    assert 0 < found.sum() < (comp >= 0).sum()
    short = counts < ell + 1
    assert short.any() and not found[short].any()
    assert (comp < 0).any() and not found[comp < 0].any()
    dead = (comp >= 0) & ~alive[rows[:, None], np.clip(comp, 0, n - 1)]
    assert dead.any() and not found[dead].any()
    assert (got[1].numpy()[~found] == 0).all()
    # the two-launch composition is the plain version on CPU tensors
    two = skernel.skernel_two_launch(*args, tau, **kw)
    assert all(torch.equal(a, b) for a, b in zip(two, got))


@pytest.mark.parametrize("ell", [2, 3])
def test_chunk_s_kernel_matches_reference(ell):
    """ops.chunk_s_kernel on CPU tensors (the fused entry's plain version
    and the commit) against JAX's chunk_s_kernel (gather_s, interpret-mode
    Pallas cholinv and cisweep, commit) and the port's levels.chunk_s, over
    two chunks of a level, the second on the first's adjacency."""
    c, alive, comp, counts, npr_b = _fixture(seed=30 + ell)
    n = c.shape[0]
    tau = threshold(40, ell, 0.05)
    sep0 = np.full((n, n, 4), -1, dtype=np.int32)
    kw = dict(ell=ell, n_chunk=16, n_max=npr_b)
    t = torch.tensor
    state_t = (t(alive), t(sep0))
    state_j = (jnp.asarray(alive), jnp.asarray(sep0))
    state_s = state_t
    for t0 in (0, 16):
        t0_t = torch.tensor(t0, dtype=torch.int32)
        got = ops.chunk_s_kernel(t(c), *state_t, t(comp), t(counts), t0_t, tau, **kw)
        two = ops.chunk_s_two_launch(t(c), *state_t, t(comp), t(counts), t0_t, tau, **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, two))
        state_j = jops.chunk_s_kernel(jnp.asarray(c), *state_j, jnp.asarray(comp),
                                      jnp.asarray(counts), jnp.int32(t0), tau, **kw)
        state_s = L.chunk_s(t(c), *state_s, t(comp), t(counts), t0_t, tau, **kw)
        for a, b, s in zip(got, state_j, state_s):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            assert torch.equal(a, s)
        state_t = got
    assert (state_t[0].numpy() != alive).any(), "the chunks should remove edges"


def test_s_kernel_level_calls_the_fused_entry_once_a_chunk(monkeypatch):
    """engines.run_level's "S-kernel" route calls skernel_fused once a
    chunk (stats["dispatches"] = chunks, the plan of levels.plan_level) and
    never levels.gather_s; the level equals the two-launch hook's."""
    c, alive, _, _, _ = _fixture(seed=41)
    n = c.shape[0]
    t = torch.tensor
    sep = torch.full((n, n, 4), -1, dtype=torch.int32)
    tau = threshold(40, 2, 0.05)
    want = engines.run_level(t(c), t(alive), sep, 2, tau, engine="S-kernel", cell_budget=2**12,
                             chunk_fn_s=ops.chunk_s_two_launch)
    calls = []
    fused = skernel.skernel_fused
    monkeypatch.setattr(skernel, "skernel_fused",
                        lambda *a, **k: calls.append(1) or fused(*a, **k))

    def no_gather(*a, **k):
        raise AssertionError("levels.gather_s called on the S-kernel path")

    monkeypatch.setattr(L, "gather_s", no_gather)
    got = engines.run_level(t(c), t(alive), sep, 2, tau, engine="S-kernel", cell_budget=2**12)
    st = got[2]
    assert st["engine"] == "S-kernel" and st["chunks"] > 1
    assert len(calls) == st["chunks"] == st["dispatches"] == want[2]["chunks"]
    assert st["n_chunk"] == L.plan_level(st["npr"], 2, n, cell_budget=2**12, n_cols=n)[1]
    for a, b in zip(got[:2], want[:2]):
        assert torch.equal(a, b)


def test_skernel_rejects_bad_inputs():
    c, alive, comp, counts, npr_b = _fixture(seed=5)
    n = c.shape[0]
    t = torch.tensor
    rows = torch.arange(n, dtype=torch.int32)
    t0 = torch.tensor(0, dtype=torch.int32)
    args = [t(c), t(alive), t(comp), t(counts), rows, t0]
    kw = dict(ell=2, n_chunk=4, n_max=npr_b)
    for k, bad, match in ((0, t(c).double(), "float32"), (2, t(comp).long(), "int32"),
                          (4, rows[1:], "shapes"), (5, t0.float(), "t0"),
                          (5, t0[None], "shapes")):
        a = list(args)
        a[k] = bad
        with pytest.raises(ValueError, match=match):
            skernel.skernel_fused(*a, 0.1, **kw)
    with pytest.raises(ValueError, match="ℓ"):
        skernel.skernel_fused(*args, 0.1, ell=9, n_chunk=4, n_max=npr_b)
    with pytest.raises(ValueError, match="CUDA"):
        build.require_cuda(t(c))


# ------------------------------------------------------------- on the card
def _cuda_level(n, deg, seed, dev):
    """A ragged n, a row with no edge, rows of every degree up to ~deg,
    and dead edges; C from seeded samples, on the card."""
    x, _ = sample_gaussian_dag(n=n, m=60, density=0.3, seed=seed)
    c = torch.tensor(np.array(correlation_from_samples(jnp.asarray(x))), device=dev)
    rng = np.random.default_rng(seed)
    adj = np.triu(rng.random((n, n)) < min(0.9, deg / n), 1)
    adj[1, :] = False
    adj = adj | adj.T
    npr_b = L.bucket_npr(int(adj.sum(1).max()))
    comp, counts = compact_rows(torch.tensor(adj, device=dev), n_prime=npr_b)
    kill = np.triu(rng.random((n, n)) < 0.1, 1)
    alive = torch.tensor(adj & ~(kill | kill.T), device=dev)
    return c, alive, comp, counts, npr_b


# ell, n, degree, first rank, its dtype, ranks, first row
CUDA_CASES = [(1, 1190, 160, 0, torch.int32, 32, 0), (2, 133, 20, 5, torch.int64, 300, 3),
              (3, 61, 40, 0, torch.int32, 200, 0), (4, 45, 14, 17, torch.int32, 64, 2),
              (5, 37, 12, 0, torch.int32, 160, 0), (6, 29, 11, 3, torch.int64, 40, 0),
              (7, 23, 11, 0, torch.int32, 130, 1), (8, 31, 12, 10, torch.int32, 40, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("ell,n,deg,t0,rank_dtype,t_len,row0", CUDA_CASES)
def test_cuda_skernel_bitwise_two_launch(monkeypatch, ell, n, deg, t0, rank_dtype, t_len, row0):
    """The fused kernel against the two gathered kernels it replaces
    (gather, cholinv, cisweep, _winners) on the card, bitwise, at every
    ℓ = 1…8 and ragged n (one tile and several, slots of one lane and of
    many, int64 ranks, a row block); against its plain version in the τ
    band; one launch, counted under "skernel", with no unrank or gather of
    ``levels`` running."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the skernel kernel has no CPU mode")
    dev = torch.device("cuda")
    c, alive, comp, counts, npr_b = _cuda_level(n, deg, ell, dev)
    comp, counts = comp[row0:].contiguous(), counts[row0:].contiguous()
    rows = torch.arange(row0, n, dtype=torch.int32, device=dev)
    args = (c, alive, comp, counts, rows, torch.tensor(t0, dtype=rank_dtype, device=dev))
    tau = threshold(60, ell, 0.05)
    kw = dict(ell=ell, n_chunk=t_len, n_max=npr_b)
    build.reset_launches()
    with monkeypatch.context() as mp:
        for name in ("plan_sets", "gather_sets", "gather_s"):
            mp.setattr(L, name, None)
        got = skernel.skernel_fused(*args, tau, **kw)
        torch.cuda.synchronize()
    assert build.LAUNCHES["skernel"] == 1 and build.LAUNCHES["cholinv"] == 0
    two = skernel.skernel_two_launch(*args, tau, **kw)
    assert build.LAUNCHES["cholinv"] == build.LAUNCHES["cisweep"] == 1
    assert torch.equal(got[0], two[0]) and torch.equal(got[1], two[1])
    plain = [tuple(a.cpu() for a in skernel.skernel_plain(*args, tau + d, **kw))
             for d in (0.0, -BAND, BAND)]
    n_diff, outside, _ = _band_counts(tuple(a.cpu() for a in got), *plain)
    assert outside == 0 and n_diff <= 2, (ell, n_diff, outside)
    found = got[0] < skernel.SENTINEL
    assert bool(found.any()) and not bool(found.all())


@pytest.mark.cuda
@pytest.mark.parametrize("jitter", [1e-3, 5e-2])
@pytest.mark.parametrize("ell,n,deg", [(2, 133, 20), (3, 61, 40)])
def test_cuda_skernel_jitter_bitwise_two_launch(ell, n, deg, jitter):
    """A jitter other than the default reaches the fused kernel as it
    reaches cholinv: bitwise equal to the two-launch chunk at the same
    jitter, and to its plain version at that jitter outside the τ band."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the skernel kernel has no CPU mode")
    dev = torch.device("cuda")
    c, alive, comp, counts, npr_b = _cuda_level(n, deg, ell, dev)
    rows = torch.arange(n, dtype=torch.int32, device=dev)
    args = (c, alive, comp, counts, rows, torch.tensor(0, dtype=torch.int32, device=dev))
    tau = threshold(60, ell, 0.05)
    kw = dict(ell=ell, n_chunk=200, n_max=npr_b, jitter=jitter)
    got = skernel.skernel_fused(*args, tau, **kw)
    two = skernel.skernel_two_launch(*args, tau, **kw)
    assert torch.equal(got[0], two[0]) and torch.equal(got[1], two[1])
    plain = [tuple(a.cpu() for a in skernel.skernel_plain(*args, tau + d, **kw))
             for d in (0.0, -BAND, BAND)]
    n_diff, outside, _ = _band_counts(tuple(a.cpu() for a in got), *plain)
    assert outside == 0 and n_diff <= 2, (ell, jitter, n_diff, outside)


@pytest.mark.cuda
def test_cuda_s_kernel_level_one_launch_a_chunk(monkeypatch):
    """A level of the "S-kernel" engine on the card, several chunks: one
    skernel launch a chunk, no cholinv or cisweep launch and no unrank or
    gather of ``levels``; the same (adj, sep) as the two-launch hook's
    level, bitwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the skernel kernel has no CPU mode")
    dev = torch.device("cuda")
    c, alive, _, _, _ = _cuda_level(300, 40, 7, dev)
    n = c.shape[0]
    sep = torch.full((n, n, 8), -1, dtype=torch.int32, device=dev)
    tau = threshold(60, 2, 0.05)
    kw = dict(engine="S-kernel", cell_budget=2**16)
    build.reset_launches()
    want = engines.run_level(c, alive, sep, 2, tau, chunk_fn_s=ops.chunk_s_two_launch, **kw)
    assert build.LAUNCHES["cholinv"] == want[2]["chunks"] > 1
    build.reset_launches()
    with monkeypatch.context() as mp:
        for name in ("plan_sets", "gather_sets", "gather_s"):
            mp.setattr(L, name, None)
        got = engines.run_level(c, alive, sep, 2, tau, **kw)
        torch.cuda.synchronize()
    assert build.LAUNCHES["skernel"] == got[2]["chunks"] == got[2]["dispatches"]
    assert build.LAUNCHES["cholinv"] == build.LAUNCHES["cisweep"] == 0
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
