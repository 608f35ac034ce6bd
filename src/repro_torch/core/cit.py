"""Conditional-independence tests of the port (``src/repro/core/cit.py``):
the Gaussian Fisher-z test (``fisher_z``, the per-level threshold τ, the
sample correlation matrix, ``GaussianCITest``) and the discrete G²/χ²
test (``DiscreteStats``, ``encode_discrete``, ``DiscreteCITest`` and its
p-value ``chi2_sf_f32``).

τ = Φ⁻¹(1 − α/2) / √(m − ℓ − 3). The reference evaluates Φ⁻¹ (``ndtri``)
in float32 through ``jax.scipy``, whose Cephes rational approximation
differs from the correctly rounded value by an ulp at common α (at
α = 0.01: 2.5758295 against scipy's 2.5758293). A one-ulp τ would shift
decisions that sit exactly on the threshold, so :func:`_ndtri_f32`
evaluates the same approximation in numpy float32, with the polynomial
steps fused as XLA fuses them; scipy's float64 ``ndtri`` stays the
yardstick it is tested against.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import ClassVar, NamedTuple

import numpy as np
import torch

from .validate import InsufficientSamplesError

#: Largest contingency table (cells per test) a level may need; deeper
#: levels are refused (the reference's cap).
MAX_G2_TABLE = 4096

_F = np.float32
# Cephes ndtri coefficients (the constants of the reference's jax.scipy)
_P0 = (-5.99633501014107895267E1, 9.80010754185999661536E1, -5.66762857469070293439E1,
       1.39312609387279679503E1, -1.23916583867381258016E0)
_Q0 = (1.0, 1.95448858338141759834E0, 4.67627912898881538453E0, 8.63602421390890590575E1,
       -2.25462687854119370527E2, 2.00260212380060660359E2, -8.20372256168333339912E1,
       1.59056225126211695515E1, -1.18331621121330003142E0)
_P1 = (4.05544892305962419923E0, 3.15251094599893866154E1, 5.71628192246421288162E1,
       4.40805073893200834700E1, 1.46849561928858024014E1, 2.18663306850790267539E0,
       -1.40256079171354495875E-1, -3.50424626827848203418E-2, -8.57456785154685413611E-4)
_Q1 = (1.0, 1.57799883256466749731E1, 4.53907635128879210584E1, 4.13172038254672030440E1,
       1.50425385692907503408E1, 2.50464946208309415979E0, -1.42182922854787788574E-1,
       -3.80806407691578277194E-2, -9.33259480895457427372E-4)
_P2 = (3.23774891776946035970E0, 6.91522889068984211695E0, 3.93881025292474443415E0,
       1.33303460815807542389E0, 2.01485389549179081538E-1, 1.23716634817820021358E-2,
       3.01581553508235416007E-4, 2.65806974686737550832E-6, 6.23974539184983293730E-9)
_Q2 = (1.0, 6.02427039364742014255E0, 3.67983563856160859403E0, 1.37702099489081330271E0,
       2.16236993594496635890E-1, 1.34204006088543189037E-2, 3.28014464682127739104E-4,
       2.89247864745380683936E-6, 6.79019408009981274425E-9)


def _polyval_f32(coef, x):
    """Horner in float32 with each step fused (one rounding per y·x + c)."""
    y = _F(0.0)
    for c in coef:
        y = _F(np.float64(y) * np.float64(x) + np.float64(_F(c)))
    return y


def _ndtri_f32(p: float) -> float:
    """Φ⁻¹(p) for p ∈ (0, 1) as float32 Cephes, the reference's arithmetic."""
    p = _F(p)
    if p <= 0.0 or p >= 1.0:
        raise ValueError(f"ndtri needs 0 < p < 1, got {p}")
    mcp = _F(_F(1.0) - p) if p > _F(-np.expm1(-2.0)) else p
    if mcp > _F(np.exp(-2.0)):
        w = _F(mcp - _F(0.5))
        ww = _F(w * w)
        ratio = _F(_polyval_f32(_P0, ww) / _polyval_f32(_Q0, ww))
        x = _F(w + _F(_F(w * ww) * ratio))
        x = _F(x * _F(-np.sqrt(2.0 * np.pi)))
    else:
        z = _F(np.sqrt(_F(_F(-2.0) * _F(np.log(mcp)))))
        first = _F(z - _F(_F(np.log(z)) / z))
        iz = _F(_F(1.0) / z)
        pc, qc = (_P2, _Q2) if z >= _F(8.0) else (_P1, _Q1)
        second = _F(_F(_polyval_f32(pc, iz) / _polyval_f32(qc, iz)) / z)
        x = _F(first - second)
    return float(x if p > _F(1.0 - np.exp(-2.0)) else -x)


def fisher_z(rho: torch.Tensor) -> torch.Tensor:
    """|atanh ρ| with ρ clipped to ±0.9999999 (Eq. 6)."""
    return torch.abs(torch.atanh(torch.clamp(rho, -0.9999999, 0.9999999)))


def threshold(m: int, ell: int, alpha: float, *, insufficient: str = "raise") -> float:
    """τ = Φ⁻¹(1 − α/2)/√(m − ℓ − 3) (Eq. 7), a host-side scalar.

    ``insufficient`` picks what happens when m − ℓ − 3 ≤ 0: "raise"
    (:class:`InsufficientSamplesError`) or "warn" (warn and clamp the
    denominator to 1, as ``pc``'s level loop does)."""
    denom = m - ell - 3
    if denom <= 0:
        if insufficient not in ("raise", "warn"):
            raise ValueError(f"insufficient must be raise|warn, got {insufficient!r}")
        msg = (
            f"m={m} samples cannot support a level-{ell} Fisher-z test: the "
            f"threshold needs m - ell - 3 > 0 (got {denom}). The clamped τ "
            "rejects (keeps) every edge at this level. Collect more samples "
            f"or cap max_level at {max(m - 4, 0)}."
        )
        if insufficient == "raise":
            raise InsufficientSamplesError(msg)
        warnings.warn(msg, stacklevel=2)
        denom = 1
    return _ndtri_f32(1.0 - alpha / 2.0) / float(denom) ** 0.5


def correlation_from_samples(x: torch.Tensor) -> torch.Tensor:
    """Sample correlation matrix, x: (m, n) → (n, n) fp32, clipped to
    [-1, 1] with an exact unit diagonal — the plain definition the kernel
    path (``kernels.ops.correlation``) is held against."""
    x = x.to(torch.float32)
    xc = x - torch.mean(x, dim=0, keepdim=True)
    std = torch.sqrt(torch.mean(xc * xc, dim=0, keepdim=True))
    xn = xc / torch.clamp(std, min=1e-30)
    c = torch.clamp((xn.T @ xn) / x.shape[0], -1.0, 1.0)
    c.fill_diagonal_(1.0)
    return c


CORR_PATHS = ("auto", "kernel", "plain")


def check_corr(corr: str) -> None:
    if corr not in CORR_PATHS:
        raise ValueError(f"corr must be auto|kernel|plain, got {corr!r}")


def correlation_of(x: torch.Tensor, corr: str = "auto") -> torch.Tensor:
    """C (n, n) of samples x (m, n) by ``corr``: "kernel" through the
    corr kernel (``kernels.ops.correlation``, whose CPU tensors take its
    plain version), "plain" through :func:`correlation_from_samples`,
    "auto" the kernel for a CUDA x and the plain version for a CPU one."""
    check_corr(corr)
    if corr == "kernel" or (corr == "auto" and x.device.type == "cuda"):
        from ..kernels.ops import correlation

        return correlation(x)
    return correlation_from_samples(x)


@dataclasses.dataclass(frozen=True)
class GaussianCITest:
    """The Fisher-z partial-correlation test: the statistic is C, the
    per-level scalar the threshold τ."""

    m: int
    alpha: float = 0.01
    kind: ClassVar[str] = "gaussian"

    def tau(self, ell: int, *, insufficient: str = "raise") -> float:
        return threshold(self.m, ell, self.alpha, insufficient=insufficient)

    def taus(self, max_level: int, *, insufficient: str = "raise") -> tuple:
        return tuple(self.tau(ell, insufficient=insufficient) for ell in range(max_level + 1))

    def level0(self, stats, tau):
        """The level-0 kernel for a CUDA C, the plain ``levels.level0`` for
        a CPU one (``ops.level0`` picks by device)."""
        from repro_torch.kernels import ops

        return ops.level0(stats, tau)

    def level0_span(self, stats, tau, sepset_depth):
        """(adj, sep, max_deg) of level 0: the fused level-0 kernel, one
        launch, for a CUDA C, the plain ``levels.level0_span`` for a CPU
        one (``ops.level0_span`` picks by device)."""
        from repro_torch.kernels import ops

        return ops.level0_span(stats, tau, sepset_depth)


# ------------------------------------------------------------- discrete G²
class DiscreteStats(NamedTuple):
    """Sufficient statistics of the G² test, carried in the slot the
    Gaussian path uses for C.

    codes:   (m, n) int32 level codes in [0, arity_k) per column k;
    arities: (n,)   int32 per-variable arity (observed max + 1). It feeds
             the dof; the code stride is the run-wide max arity r."""

    codes: torch.Tensor
    arities: torch.Tensor


def encode_discrete(x, device=None) -> tuple:
    """Categorical samples (m, n) → (DiscreteStats on ``device``, r_max).
    Codes are kept verbatim (validation guarantees 0-based integers);
    arities are per-column max + 1. ``device=None`` keeps the CPU."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    codes = np.asarray(x).astype(np.int32)
    arities = codes.max(axis=0).astype(np.int32) + 1
    r_max = int(arities.max(initial=1))
    dev = torch.device("cpu") if device is None else torch.device(device)
    return DiscreteStats(codes=torch.tensor(codes, device=dev),
                         arities=torch.tensor(arities, device=dev)), r_max


def chi2_sf_f32(g2: torch.Tensor, dof: torch.Tensor) -> torch.Tensor:
    """χ² tail probability P(X ≥ G²) with ``dof`` degrees of freedom, in
    float32: gammaincc(dof/2, max(G², 0)/2), as the reference's epilogue.

    ``torch.special.gammaincc`` and the reference's
    ``jax.scipy.special.gammaincc`` are different float32 algorithms. In
    the decision region (p ∈ [0.001, 0.2]) they agree to a relative 2e-5
    for dof ≤ 36 (every level ≤ 2 at arity 3) and drift apart as the dof
    grows, past 1e-4 at dof 972, where the reference's own error against
    float64 is the larger one (tests/test_torch_discrete.py, ROADMAP
    Queue 3)."""
    g2 = g2.to(torch.float32)
    dof = dof.to(torch.float32)
    return torch.special.gammaincc(dof / 2.0, torch.clamp(g2, min=0.0) / 2.0)


@dataclasses.dataclass(frozen=True)
class DiscreteCITest:
    """Contingency-table G²/χ² test over integer level codes.

    The per-level decision scalar is α itself: each test computes its own
    dof-aware p-value and declares independence when p ≥ α (the boundary
    counts as independent, as Z ≤ τ does). ``r`` is the run-wide maximum
    arity, the code stride of every variable: a level-ℓ table has
    K = r^(ℓ+2) cells, and dof uses the true per-variable arities."""

    m: int
    alpha: float = 0.01
    r: int = 2
    kind: ClassVar[str] = "discrete"

    @classmethod
    def from_samples(cls, x, alpha: float = 0.01, device=None):
        """(test, stats) from raw categorical samples (validated upstream)."""
        stats, r_max = encode_discrete(x, device=device)
        return cls(m=int(stats.codes.shape[0]), alpha=float(alpha), r=r_max), stats

    def tau(self, ell: int, *, insufficient: str = "raise") -> float:
        del ell, insufficient  # the dof lives per test, not per level
        return float(self.alpha)

    def taus(self, max_level: int, *, insufficient: str = "raise") -> tuple:
        return tuple(self.tau(ell, insufficient=insufficient) for ell in range(max_level + 1))

    def level0(self, stats, tau):
        from . import levels as L

        return L.level0_g2(stats, tau, r=self.r)

    def level0_span(self, stats, tau, sepset_depth):
        """(adj, sep, max_deg) of level 0: ``level0_g2`` and the plain
        sepset fill."""
        from . import levels as L

        return L.level0_fill(self.level0(stats, tau), sepset_depth)

    def table_width(self, ell: int) -> int:
        """K = r^(ℓ+2) cells per test at level ℓ."""
        return self.r ** (ell + 2)

    def max_supported_level(self) -> int:
        """Deepest ℓ whose table fits MAX_G2_TABLE: ``pc``'s level cap when
        the caller leaves max_level unset."""
        ell = 0
        while self.table_width(ell + 1) <= MAX_G2_TABLE:
            ell += 1
        return ell

    def check_level(self, ell: int):
        """Refuse a level whose table exceeds MAX_G2_TABLE."""
        k = self.table_width(ell)
        if k > MAX_G2_TABLE:
            raise ValueError(
                f"level {ell} needs a {k}-cell contingency table per test "
                f"(max arity {self.r}) — beyond MAX_G2_TABLE={MAX_G2_TABLE}. "
                "Cap max_level, re-bin high-arity columns, or raise the cap "
                "if the table budget allows."
            )


def resolve_citest(test, m: int, alpha: float):
    """None / "gaussian" / "discrete" / a test instance → a test instance.
    String forms bind (m, α) from the call; instances are returned as they
    are."""
    if test is None or test == "gaussian":
        return GaussianCITest(m=int(m), alpha=float(alpha))
    if test == "discrete":
        return DiscreteCITest(m=int(m), alpha=float(alpha))
    if isinstance(test, (GaussianCITest, DiscreteCITest)):
        return test
    raise ValueError(
        f"test must be None, 'gaussian', 'discrete' or a GaussianCITest / "
        f"DiscreteCITest; got {test!r}")
