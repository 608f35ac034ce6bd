"""Serial float64 PC-stable oracles (paper Algorithm 1), a copy of
``src/repro/core/stable_ref.py``: numpy and scipy, one test at a time.

* Gaussian: ``pc_stable_skeleton`` (Fisher z on partial correlations),
  the bottom rung of the serving layer's degrade ladder
  (``serve/service.py``);
* discrete: ``g2_test`` and ``pc_stable_skeleton_discrete``, which the
  CPU tests and ``chip_smoke.py``'s certificate hold the port to."""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass, field

import numpy as np


@dataclass
class PCResult:
    adj: np.ndarray  # (n, n) bool undirected skeleton
    sepsets: dict = field(default_factory=dict)  # (i, j) with i < j → separating set
    max_level: int = 0
    ci_tests: int = 0


def _partial_corr(c: np.ndarray, i: int, j: int, s: tuple[int, ...]) -> float:
    if len(s) == 0:
        return float(c[i, j])
    s = list(s)
    m2 = c[np.ix_(s, s)]
    ci_s = c[i, s]
    cj_s = c[j, s]
    # the Moore-Penrose inverse of C[S, S] (paper Alg. 7 takes it through
    # a Cholesky factor; numpy's pinv equals it on full-rank sets)
    g = np.linalg.pinv(m2)
    h01 = c[i, j] - ci_s @ g @ cj_s
    h00 = c[i, i] - ci_s @ g @ ci_s
    h11 = c[j, j] - cj_s @ g @ cj_s
    denom = math.sqrt(max(h00 * h11, 1e-30))
    return float(h01 / denom)


def fisher_z(rho: float) -> float:
    rho = min(max(rho, -0.9999999), 0.9999999)
    return abs(math.atanh(rho))


def threshold(m: int, ell: int, alpha: float) -> float:
    from scipy.stats import norm

    return norm.ppf(1.0 - alpha / 2.0) / math.sqrt(max(m - ell - 3, 1))


def pc_stable_skeleton(c: np.ndarray, m: int, alpha: float = 0.01,
                       max_level: int | None = None) -> PCResult:
    """The skeleton and separating sets of PC-stable (Algorithm 1) from a
    correlation matrix c (n, n) of m samples: an edge goes at the first
    set S (in ``itertools.combinations`` order of its endpoint's level-start
    neighbours) whose Fisher z is ≤ τ."""
    n = c.shape[0]
    adj = ~np.eye(n, dtype=bool)
    sepsets: dict[tuple[int, int], tuple[int, ...]] = {}
    tests = 0
    ell = 0
    hard_cap = n - 2 if max_level is None else max_level
    while True:
        tau = threshold(m, ell, alpha)
        adj_prev = adj.copy()  # G', fixed for the whole level (PC-stable)
        for i in range(n):
            nbrs_i_prev = [int(v) for v in np.flatnonzero(adj_prev[i])]
            for j in nbrs_i_prev:
                if not adj[i, j]:
                    continue  # removed earlier in this level
                cand = [v for v in nbrs_i_prev if v != j]
                if len(cand) < ell:
                    continue
                for s in itertools.combinations(cand, ell):
                    tests += 1
                    if fisher_z(_partial_corr(c, i, j, s)) <= tau:
                        adj[i, j] = adj[j, i] = False
                        sepsets[(min(i, j), max(i, j))] = tuple(s)
                        break
        ell += 1
        max_deg = int(adj.sum(axis=1).max()) if adj.any() else 0
        if max_deg - 1 < ell or ell > hard_cap:
            break
    return PCResult(adj=adj, sepsets=sepsets, max_level=ell - 1, ci_tests=tests)


def g2_test(codes: np.ndarray, arities: np.ndarray, i: int, j: int,
            s: tuple[int, ...]) -> tuple[float, int, float]:
    """One conditional G² test on integer level codes → (G², dof, p):

        G² = 2 Σ_abc N_abc · log(N_abc · N_++c / (N_a+c · N_+bc))
        dof = (r_i − 1)(r_j − 1) · Π_{k∈S} r_k          (true arities)
        p   = chi2.sf(G², dof)

    The table is an np.bincount over a joint code strided by each
    variable's own arity, in float64."""
    from scipy.stats import chi2

    ri, rj = int(arities[i]), int(arities[j])
    q = 1
    code = np.zeros(codes.shape[0], dtype=np.int64)
    for k in s:  # MSB-first fold, the engines' cfg order
        code = code * int(arities[k]) + codes[:, k].astype(np.int64)
        q *= int(arities[k])
    code = (code * ri + codes[:, i].astype(np.int64)) * rj + codes[:, j].astype(np.int64)
    tab = np.bincount(code, minlength=q * ri * rj).astype(np.float64).reshape(q, ri, rj)
    n_c = tab.sum(axis=(1, 2), keepdims=True)
    n_ac = tab.sum(axis=2, keepdims=True)
    n_bc = tab.sum(axis=1, keepdims=True)
    with np.errstate(divide="ignore", invalid="ignore"):
        term = tab * (np.log(tab) + np.log(n_c) - np.log(n_ac) - np.log(n_bc))
    g2 = 2.0 * float(np.where(tab > 0, term, 0.0).sum())
    dof = max((ri - 1) * (rj - 1) * q, 1)
    return g2, dof, float(chi2.sf(g2, dof))


def pc_stable_skeleton_discrete(codes: np.ndarray, alpha: float = 0.05,
                                max_level: int | None = None) -> PCResult:
    """PC-stable skeleton on categorical data (paper Algorithm 1 with the
    G² test): the edge goes when p ≥ α (the boundary counts as
    independent). Arities are the per-column observed max + 1."""
    codes = np.asarray(codes, dtype=np.int64)
    n = codes.shape[1]
    arities = codes.max(axis=0) + 1
    adj = ~np.eye(n, dtype=bool)
    sepsets: dict[tuple[int, int], tuple[int, ...]] = {}
    tests = 0
    ell = 0
    hard_cap = n - 2 if max_level is None else max_level
    while True:
        adj_prev = adj.copy()
        for i in range(n):
            nbrs_i_prev = [int(v) for v in np.flatnonzero(adj_prev[i])]
            for j in nbrs_i_prev:
                if not adj[i, j]:
                    continue
                cand = [v for v in nbrs_i_prev if v != j]
                if len(cand) < ell:
                    continue
                for s in itertools.combinations(cand, ell):
                    tests += 1
                    _, _, p = g2_test(codes, arities, i, j, s)
                    if p >= alpha:
                        adj[i, j] = adj[j, i] = False
                        sepsets[(min(i, j), max(i, j))] = tuple(s)
                        break
        ell += 1
        max_deg = int(adj.sum(axis=1).max()) if adj.any() else 0
        if max_deg - 1 < ell or ell > hard_cap:
            break
    return PCResult(adj=adj, sepsets=sepsets, max_level=ell - 1, ci_tests=tests)
