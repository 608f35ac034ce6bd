"""The arguments of the port's ``pc``/``pc_from_corr`` and validation
against the JAX package's, on the same inputs: ``sepset_depth``,
``orient``, ``chunk_fn_s`` and
``chunk_fn_e`` of ``pc_from_corr`` and ``pc`` (Gaussian and discrete),
and ``strict_rank`` and ``sym_tol`` of ``validate_samples`` and
``validate_corr``.

The Gaussian runs use the engine-parity fixtures of tests/test_engines.py
(``test_grid_engine_bit_parity``'s n = 15 and 18), the discrete ones
``test_g2_vs_g2_kernel_bit_parity``'s (tests/test_cit.py:157). Results must
be equal: skeleton, sepsets (of the requested depth) and CPDAG (the
skeleton itself with ``orient=False``).
"""
import functools
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import levels as jlevels, validate as jvalidate  # noqa: E402
from repro.core.cit import correlation_from_samples  # noqa: E402
from repro.core.pc import pc as jpc, pc_from_corr as jpc_from_corr  # noqa: E402
from repro.data.synthetic_dag import sample_gaussian_dag  # noqa: E402
from repro_torch import pc, pc_from_corr  # noqa: E402
from repro_torch.core import levels as L, validate as V  # noqa: E402
from repro_torch.data import synthetic_dag  # noqa: E402

pytestmark = pytest.mark.torch

FIXTURES = {
    "grid15": dict(n=15, density=0.2, alpha=0.01, seed=0, m=3000),
    "grid18": dict(n=18, density=0.3, alpha=0.05, seed=3, m=3000),
}


@functools.lru_cache(maxsize=None)
def corr(name):
    f = FIXTURES[name]
    x, _ = sample_gaussian_dag(n=f["n"], m=f["m"], density=f["density"], seed=f["seed"])
    return np.array(correlation_from_samples(jnp.asarray(x)))


@functools.lru_cache(maxsize=None)
def jax_run(name, sepset_depth, orient):
    f = FIXTURES[name]
    return jpc_from_corr(jnp.asarray(corr(name)), f["m"], alpha=f["alpha"], engine="S",
                         sepset_depth=sepset_depth, orient=orient)


def _assert_same(port, ref):
    np.testing.assert_array_equal(port.adj, ref.adj)
    np.testing.assert_array_equal(port.sepsets, ref.sepsets)
    np.testing.assert_array_equal(port.cpdag, ref.cpdag)
    assert port.levels_run == ref.levels_run


@pytest.mark.parametrize("orient", [True, False])
@pytest.mark.parametrize("sepset_depth", [1, 2, 8])
@pytest.mark.parametrize("name", list(FIXTURES))
def test_pc_from_corr_depth_and_orient_match_reference(name, sepset_depth, orient):
    """Port "auto" and "S-grid" against JAX "S" at each depth, both ways."""
    f = FIXTURES[name]
    ref = jax_run(name, sepset_depth, orient)
    assert ref.sepsets.shape == (f["n"], f["n"], sepset_depth)
    for engine in ("auto", "S-grid"):
        port = pc_from_corr(corr(name), f["m"], alpha=f["alpha"], engine=engine,
                            sepset_depth=sepset_depth, orient=orient, device="cpu")
        _assert_same(port, ref)
        assert port.levels_run <= sepset_depth
    if not orient:
        np.testing.assert_array_equal(ref.cpdag, ref.adj)


def test_pc_discrete_sepset_depth_matches_reference():
    x, _ = synthetic_dag.sample_discrete_dag(n=10, m=300, density=0.35, arity=3, seed=3)
    for k in range(x.shape[1]):
        if len(np.unique(x[:, k])) < 2:
            x[0, k] = (x[1, k] + 1) % 3
    for orient in (True, False):
        ref = jpc(x, alpha=0.05, test="discrete", engine="G2", sepset_depth=2, orient=orient)
        port = pc(x, alpha=0.05, test="discrete", sepset_depth=2, orient=orient, device="cpu")
        assert port.sepsets.shape[-1] == 2
        _assert_same(port, ref)


class _Spy:
    """A chunk function that records its calls and runs ``levels.chunk_s``."""

    def __init__(self):
        self.calls = 0

    def __call__(self, *args, **kw):
        self.calls += 1
        return L.chunk_s(*args, **kw)


@pytest.mark.parametrize("engine", ["S", "S-kernel", "S-grid", "E"])
def test_chunk_hooks_replace_the_engines_chunk_function(engine):
    """As in the reference's engines.run_level: ``chunk_fn_s`` stands in for
    the chunk function of "S", "S-kernel" and "S-grid", ``chunk_fn_e`` for
    that of "E"; the results equal JAX's with the same hooks."""
    f = FIXTURES["grid18"]
    spy_s, spy_e = _Spy(), _Spy()
    port = pc_from_corr(corr("grid18"), f["m"], alpha=f["alpha"], engine=engine,
                        chunk_fn_s=spy_s, chunk_fn_e=spy_e, device="cpu")
    ref = jpc_from_corr(jnp.asarray(corr("grid18")), f["m"], alpha=f["alpha"], engine=engine,
                        chunk_fn_s=jlevels.chunk_s, chunk_fn_e=jlevels.chunk_s)
    _assert_same(port, ref)
    chunks = sum(st["chunks"] for st in port.level_stats)
    assert chunks > 0
    # "E" plans its worklist with the "E" shape and calls the E hook
    assert (spy_e.calls, spy_s.calls) == ((chunks, 0) if engine == "E" else (0, chunks))


# ------------------------------------------------------------- validation
def _validation_cases():
    rng = np.random.default_rng(0)
    wide = rng.normal(size=(20, 30)).astype(np.float32)  # m < n
    c = np.corrcoef(rng.normal(size=(200, 6)), rowvar=False).astype(np.float32)
    skew = c.copy()
    skew[0, 1] += 5e-4  # |C − Cᵀ| = 5e-4
    return wide, c, skew


@pytest.mark.parametrize("strict_rank", [False, True])
def test_strict_rank_matches_reference(strict_rank):
    wide, c, _ = _validation_cases()
    # C of 6 variables from m = 5 samples, admitted at max_level 1 (m > ℓ + 3)
    for port_fn, ref_fn, args in ((V.validate_samples, jvalidate.validate_samples, (wide,)),
                                  (V.validate_corr, jvalidate.validate_corr, (c, 5, 1))):
        if strict_rank:
            with pytest.raises(jvalidate.RankDeficientError, match="rank-deficient"):
                ref_fn(*args, strict_rank=True)
            with pytest.raises(V.RankDeficientError, match="rank-deficient"):
                port_fn(*args, strict_rank=True)
        else:
            with pytest.warns(UserWarning, match="rank-deficient"):
                ref = ref_fn(*args, strict_rank=False)
            with pytest.warns(UserWarning, match="rank-deficient"):
                assert port_fn(*args, strict_rank=False) == ref


@pytest.mark.parametrize("sym_tol,passes", [(1e-4, False), (1e-3, True)])
def test_sym_tol_moves_the_symmetry_verdict_as_in_reference(sym_tol, passes):
    _, _, skew = _validation_cases()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        if passes:
            assert V.validate_corr(skew, 200, sym_tol=sym_tol) == \
                jvalidate.validate_corr(skew, 200, sym_tol=sym_tol) == 6
        else:
            with pytest.raises(jvalidate.BadCorrelationError, match="symmetric"):
                jvalidate.validate_corr(skew, 200, sym_tol=sym_tol)
            with pytest.raises(V.BadCorrelationError, match="symmetric"):
                V.validate_corr(skew, 200, sym_tol=sym_tol)
