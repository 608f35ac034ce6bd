"""The port's level-0 span (adjacency, level-0 sepsets and ℓ = 1's max
degree) against the JAX package's on the same inputs.

On the CPU the port's wrappers take the plain version,
``levels.level0_span``; the JAX package's ``pc_from_corr(...,
max_level=0)`` runs its level-0 span. Adjacency, sepsets and CPDAG must
be equal, at seeded C of n ∈ {1, 2, 11, 64} and on a C with entries at
the clip (±0.9999999, ±1) and one ulp either side of tanh τ, for sepset
depths 1, 3 and 8. ``levels.level0_span`` must equal ``levels.level0``
plus the reference's fill, and its max degree ``adj.sum(1).max()``.

``test_cuda_level0_span_matches_plain`` needs the card and skips without
one: the fused kernel entry (one launch a call) bitwise equal to its
plain version at n ∈ {1, 2, 5, 517, 1190} × depth ∈ {1, 3, 8}, at the
clip and one ulp either side of tanh τ.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.pc import pc_from_corr as jpc_from_corr  # noqa: E402
from repro_torch import pc, pc_from_corr  # noqa: E402
from repro_torch.core import cit, levels as L  # noqa: E402
from repro_torch.kernels import build, level0, ops  # noqa: E402

pytestmark = pytest.mark.torch

DEPTHS = (1, 3, 8)
M = 100  # samples: τ ≈ 0.26, so seeded C at scale 0.3 keeps and removes edges


def _corr(n, seed, scale=0.3):
    rng = np.random.default_rng(seed)
    c = np.clip(rng.normal(0, scale, size=(n, n)), -0.99, 0.99).astype(np.float32)
    c = (c + c.T) / 2
    np.fill_diagonal(c, 1.0)
    return c


def _edge_values(tau):
    """float32 values at the clip and one ulp either side of tanh τ, both
    signs."""
    t = np.float32(np.tanh(np.float32(tau)))
    near = [np.nextafter(t, np.float32(0)), t, np.nextafter(t, np.float32(1))]
    clip = [np.float32(0.9999999), np.nextafter(np.float32(0.9999999), np.float32(0)),
            np.float32(1.0)]
    vals = np.array(near + clip, dtype=np.float32)
    return np.concatenate([vals, -vals])


def _edge_corr(n, tau, seed):
    """A symmetric C whose off-diagonal cells cycle through ``_edge_values``
    in its first rows and are seeded elsewhere."""
    c = _corr(n, seed)
    vals = _edge_values(tau)
    iu, ju = np.triu_indices(n, 1)
    k = min(len(iu), 4 * len(vals))
    c[iu[:k], ju[:k]] = np.resize(vals, k)
    c[ju[:k], iu[:k]] = c[iu[:k], ju[:k]]
    return c


def _plain_fill(adj, depth):
    """The reference's fill: -1 everywhere, slot 0 where(adj, -1, -2)."""
    n = adj.shape[0]
    sep = np.full((n, n, depth), -1, dtype=np.int32)
    sep[:, :, 0] = np.where(adj, -1, -2)
    return sep


def _assert_same(port, ref):
    np.testing.assert_array_equal(port.adj, np.asarray(ref.adj))
    np.testing.assert_array_equal(port.sepsets, np.asarray(ref.sepsets))
    np.testing.assert_array_equal(port.cpdag, np.asarray(ref.cpdag))
    assert port.levels_run == ref.levels_run == 0


# ------------------------------------------------ against the JAX package
@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("n", [1, 2, 11, 64])
def test_level0_span_matches_reference(n, depth):
    c = _corr(n, seed=n)
    port = pc_from_corr(c, M, max_level=0, sepset_depth=depth, device="cpu")
    ref = jpc_from_corr(jnp.asarray(c), M, max_level=0, sepset_depth=depth)
    _assert_same(port, ref)
    assert port.sepsets.shape == (n, n, depth) and port.sepsets.dtype == np.int32


@pytest.mark.parametrize("depth", DEPTHS)
def test_level0_span_at_the_clip_matches_reference(depth):
    """Entries at ±0.9999999 and ±1 and one ulp either side of ±tanh τ."""
    tau = cit.threshold(M, 0, 0.01)
    c = _edge_corr(24, tau, seed=7)
    port = pc_from_corr(c, M, max_level=0, sepset_depth=depth, device="cpu")
    ref = jpc_from_corr(jnp.asarray(c), M, max_level=0, sepset_depth=depth)
    _assert_same(port, ref)
    # the edge cells decide both ways, so the fixture tests the boundary
    flat = port.adj[np.triu_indices(24, 1)][: 4 * len(_edge_values(tau))]
    assert flat.any() and not flat.all()


# ------------------------------------------------------ the plain version
@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("n", [0, 1, 5, 40])
def test_plain_span_is_level0_and_fill(n, depth):
    tau = cit.threshold(M, 0, 0.01)
    ct = torch.tensor(_edge_corr(n, tau, seed=n + 1) if n > 1 else _corr(n, seed=n))
    adj, sep, max_deg = L.level0_span(ct, tau, depth)
    want = L.level0(ct, tau)
    assert torch.equal(adj, want)
    assert sep.dtype == torch.int32 and sep.shape == (n, n, depth)
    np.testing.assert_array_equal(sep.numpy(), _plain_fill(want.numpy(), depth))
    assert max_deg.dtype == torch.int32 and max_deg.shape == ()
    assert int(max_deg) == (int(want.sum(1).max()) if n else 0)
    got = ops.level0_span(ct, tau, depth)  # a CPU C takes the plain version
    assert all(torch.equal(a, b) for a, b in zip(got, (adj, sep, max_deg)))


def test_discrete_span_is_level0_g2_and_fill():
    rng = np.random.default_rng(5)
    x = rng.integers(0, 3, size=(400, 7))
    x[:, 1] = (x[:, 0] + (rng.random(400) < 0.1)) % 3  # one dependent pair
    test, stats = cit.DiscreteCITest.from_samples(x, alpha=0.05)
    adj, sep, max_deg = test.level0_span(stats, 0.05, 3)
    want = test.level0(stats, 0.05)
    assert torch.equal(adj, want) and want.any()
    np.testing.assert_array_equal(sep.numpy(), _plain_fill(want.numpy(), 3))
    assert int(max_deg) == int(want.sum(1).max())


def test_driver_takes_one_span_call(monkeypatch):
    """The host loop gets adj, sepsets and ℓ = 1's max degree from one
    ``ops.level0_span`` call and computes no level-0 adjacency besides."""
    calls = []
    span = ops.level0_span

    def counted(*args):
        calls.append(args[2])
        return span(*args)

    def refused(*args):
        raise AssertionError("level0 called outside the span")

    monkeypatch.setattr(ops, "level0_span", counted)
    monkeypatch.setattr(ops, "level0", refused)
    c = _corr(16, seed=3)
    run = pc_from_corr(c, M, sepset_depth=5, device="cpu")
    assert calls == [5]
    ref = jpc_from_corr(jnp.asarray(c), M, engine="S", sepset_depth=5)
    np.testing.assert_array_equal(run.adj, np.asarray(ref.adj))
    np.testing.assert_array_equal(run.sepsets, np.asarray(ref.sepsets))
    assert run.levels_run == ref.levels_run


def test_kernel_entries_refuse_cpu_tensors():
    """No plain-version fallback in the kernel wrappers: a CPU C raises."""
    c = torch.tensor(_corr(8, seed=0))
    with pytest.raises(ValueError, match="CUDA"):
        level0.level0_span(c, 0.2, 8)
    with pytest.raises(ValueError, match="CUDA"):
        level0.level0_kernel(c, 0.2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            pc(np.random.default_rng(0).normal(size=(50, 6)))


# ------------------------------------------------------------ on the card
@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 5, 517, 1190])
def test_cuda_level0_span_matches_plain(n):
    """The fused entry bitwise equal to ``levels.level0_span``, one launch
    a call; the adjacency entry equal to ``levels.level0``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    tau = cit.threshold(47, 0, 0.01)
    ct = torch.tensor(_edge_corr(n, tau, seed=n) if n > 1 else _corr(n, seed=n), device=dev)
    for depth in DEPTHS:
        torch.cuda.synchronize()
        before = build.LAUNCHES["level0"]
        got = level0.level0_span(ct, tau, depth)
        torch.cuda.synchronize()
        assert build.LAUNCHES["level0"] == before + 1
        want = L.level0_span(ct, tau, depth)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b), (n, depth)
        assert torch.equal(ops.level0_span(ct, tau, depth)[1], want[1])
    assert torch.equal(level0.level0_kernel(ct, tau), L.level0(ct, tau))
    if n > 4:  # a view that starts 4 bytes off C's 16-byte alignment
        buf = torch.empty(n * n + 1, device=dev)
        view = buf[1:].view(n, n)
        view.copy_(ct)
        assert torch.equal(level0.level0_span(view, tau, 3)[1], L.level0_span(ct, tau, 3)[1])
