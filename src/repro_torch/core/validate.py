"""Admission checks for samples, categorical samples and correlation
matrices, with the typed errors of ``src/repro/core/validate.py`` (the
subset ``pc`` and ``pc_from_corr`` call). All checks are host-side numpy,
before any work is sent to the card.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch


class ValidationError(ValueError):
    """Base class of every admission failure; ``code`` is a stable tag."""

    code = "invalid"


class NonFiniteDataError(ValidationError):
    code = "non_finite"


class ConstantColumnError(ValidationError):
    code = "constant_column"


class RankDeficientError(ValidationError):
    code = "rank_deficient"


class BadCorrelationError(ValidationError):
    code = "bad_correlation"


class InsufficientSamplesError(ValidationError):
    """A Fisher-z threshold asked for at a level the sample count cannot
    support (m − ℓ − 3 ≤ 0)."""

    code = "insufficient_samples"


class BadDiscreteDataError(ValidationError):
    code = "bad_discrete_data"


def _as_host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _check_m(m: int, n: int, max_level: int | None, strict_rank: bool):
    lmax = 3 if max_level is None else int(max_level)
    if m <= lmax + 3:
        raise RankDeficientError(
            f"m={m} samples cannot support conditional-independence tests up "
            f"to level {lmax}: the Fisher-z threshold needs m - level - 3 > 0 "
            f"(got {m - lmax - 3}). Collect more samples or lower max_level "
            f"to at most {max(m - 4, 0)}."
        )
    if m < n:
        msg = (
            f"m={m} samples < n={n} variables: the sample correlation matrix "
            "is rank-deficient, so conditioning sets larger than the true "
            "rank are tested against a singular block (regularised, but "
            "biased). Prefer more samples or a lower max_level."
        )
        if strict_rank:
            raise RankDeficientError(msg)
        warnings.warn(msg, stacklevel=3)


def validate_samples(x, max_level: int | None = None,
                     strict_rank: bool = False) -> tuple[int, int]:
    """Validate a raw sample matrix x: (m, n). Returns (m, n).
    ``strict_rank`` turns the m < n warning into a ``RankDeficientError``
    (the serving layer's admission policy)."""
    x = _as_host(x)
    if x.ndim != 2:
        raise ValidationError(f"expected a (m, n) sample matrix; got shape {x.shape}")
    m, n = int(x.shape[0]), int(x.shape[1])
    finite = np.isfinite(x)
    if not finite.all():
        bad = np.argwhere(~finite)
        r, c = int(bad[0][0]), int(bad[0][1])
        raise NonFiniteDataError(
            f"samples contain {len(bad)} non-finite value(s) (first at row "
            f"{r}, column {c}: {x[r, c]!r}). Impute or drop the affected "
            "rows/columns before calling pc()."
        )
    span = x.max(axis=0) - x.min(axis=0)
    const = np.flatnonzero(span == 0)
    if const.size:
        cols = ", ".join(str(int(k)) for k in const[:8])
        more = "" if const.size <= 8 else f" (+{const.size - 8} more)"
        raise ConstantColumnError(
            f"column(s) [{cols}]{more} are constant: correlation with a "
            "zero-variance variable is undefined. Drop the constant columns "
            "or add measurement noise before calling pc()."
        )
    _check_m(m, n, max_level, strict_rank)
    return m, n


def validate_corr(c, m: int, max_level: int | None = None, strict_rank: bool = False,
                  sym_tol: float = 1e-4) -> int:
    """Validate a correlation matrix c: (n, n) plus its sample count m.
    Returns n. ``strict_rank`` as in ``validate_samples``; ``sym_tol`` is
    the largest |C − Cᵀ| admitted."""
    c = _as_host(c)
    if c.ndim != 2 or c.shape[0] != c.shape[1]:
        raise BadCorrelationError(
            f"expected a square (n, n) correlation matrix; got shape {c.shape}")
    n = int(c.shape[0])
    finite = np.isfinite(c)
    if not finite.all():
        bad = np.argwhere(~finite)
        i, j = int(bad[0][0]), int(bad[0][1])
        raise NonFiniteDataError(
            f"correlation matrix contains {len(bad)} non-finite value(s) "
            f"(first at C[{i}, {j}] = {c[i, j]!r})."
        )
    if not np.allclose(c, c.T, atol=sym_tol, rtol=0.0):
        ij = np.unravel_index(np.abs(c - c.T).argmax(), c.shape)
        raise BadCorrelationError(
            f"correlation matrix is not symmetric (max |C - Cᵀ| at "
            f"{tuple(int(v) for v in ij)}: {abs(c - c.T).max():.3g})."
        )
    diag = np.diagonal(c)
    if np.abs(diag - 1.0).max(initial=0.0) > 1e-3:
        k = int(np.abs(diag - 1.0).argmax())
        raise BadCorrelationError(
            f"correlation diagonal must be 1 (C[{k}, {k}] = {diag[k]:.6g}).")
    if np.abs(c).max(initial=0.0) > 1.0 + 1e-5:
        ij = np.unravel_index(np.abs(c).argmax(), c.shape)
        raise BadCorrelationError(
            f"correlation entries must lie in [-1, 1]; C{tuple(int(v) for v in ij)} "
            f"= {c[ij]:.6g}.")
    _check_m(int(m), n, max_level, strict_rank)
    return n


def validate_discrete(x, max_level: int | None = None,
                      max_arity: int = 16) -> tuple[int, int]:
    """Validate a categorical sample matrix x: (m, n) of integer level
    codes. Returns (m, n).

    Codes must be finite non-negative integers, every column needs two
    observed levels (a one-level variable has zero degrees of freedom and
    fabricates independence), and the largest arity is capped at
    ``max_arity``. Fewer than ~10 samples per unconditional cell only
    warns. ``max_level`` is accepted for the signature's sake, as in the
    reference."""
    del max_level
    x = _as_host(x)
    if x.ndim != 2:
        raise ValidationError(
            f"expected a (m, n) categorical sample matrix; got shape {x.shape}")
    m, n = int(x.shape[0]), int(x.shape[1])
    finite = np.isfinite(x)
    if not finite.all():
        bad = np.argwhere(~finite)
        r, c = int(bad[0][0]), int(bad[0][1])
        raise NonFiniteDataError(
            f"categorical samples contain {len(bad)} non-finite value(s) "
            f"(first at row {r}, column {c}: {x[r, c]!r}). Impute or drop "
            "before calling pc(test='discrete')."
        )
    if not np.issubdtype(x.dtype, np.integer) and not np.array_equal(x, np.floor(x)):
        bad = np.argwhere(x != np.floor(x))
        r, c = int(bad[0][0]), int(bad[0][1])
        raise BadDiscreteDataError(
            f"categorical samples must be integer level codes; found "
            f"non-integer value {x[r, c]!r} at row {r}, column {c}. "
            "Discretise continuous variables (e.g. quantile binning) or use "
            "the Gaussian test."
        )
    if x.min(initial=0) < 0:
        bad = np.argwhere(x < 0)
        r, c = int(bad[0][0]), int(bad[0][1])
        raise BadDiscreteDataError(
            f"categorical level codes must be non-negative; found "
            f"{x[r, c]!r} at row {r}, column {c}. Re-encode levels as "
            "0..arity-1 (e.g. np.unique(col, return_inverse=True))."
        )
    n_levels = np.array([np.unique(x[:, k]).size for k in range(n)])
    const = np.flatnonzero(n_levels < 2)
    if const.size:
        cols = ", ".join(str(int(k)) for k in const[:8])
        more = "" if const.size <= 8 else f" (+{const.size - 8} more)"
        raise ConstantColumnError(
            f"column(s) [{cols}]{more} take a single observed level: a "
            "one-level variable has zero degrees of freedom, so every G² "
            "test involving it is vacuous (fabricated independence). Drop "
            "the constant columns before calling pc(test='discrete')."
        )
    arity = int(x.max()) + 1
    if arity > max_arity:
        k = int(np.argmax(x.max(axis=0)))
        raise BadDiscreteDataError(
            f"maximum arity {arity} (column {k}) exceeds the cap "
            f"{max_arity}: every conditioning variable multiplies the "
            "contingency-table width by its arity, so high-cardinality "
            "columns blow up the G² worklist. Re-bin the column or raise "
            "max_arity explicitly if the table budget allows."
        )
    if m < 10 * arity * arity:
        warnings.warn(
            f"m={m} samples for arity-{arity} variables gives fewer than "
            f"~10 samples per unconditional contingency cell "
            f"({arity * arity} cells); sparse tables bias G² toward "
            "independence. Prefer more samples or coarser bins.",
            stacklevel=3,
        )
    return m, n
