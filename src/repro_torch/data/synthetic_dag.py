"""Synthetic DAG data, the paper's §5.6 generator: a copy of
``random_dag``, ``sample_gaussian_dag`` and ``sample_discrete_dag`` from
``src/repro/data/synthetic_dag.py`` (same seed → bit-identical numpy data).

"We first generate a random adjacency matrix A_G with independent
realizations of Bernoulli(d) in the lower triangle ... replace the ones by
independent U[0.1, 1] ... samples are generated as V_i = N_i + Σ_j A[i,j]·V_j"
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class GaussianDAG:
    weights: np.ndarray  # (n, n) lower-triangular, W[i, j]: Vj → Vi
    adj: np.ndarray  # adj[i, j] True iff Vj → Vi

    @property
    def n(self) -> int:
        return self.adj.shape[0]

    def skeleton(self) -> np.ndarray:
        return self.adj | self.adj.T

    def parents(self, i: int) -> np.ndarray:
        return np.flatnonzero(self.adj[i])


def random_dag(n: int, density: float, rng: np.random.Generator) -> GaussianDAG:
    mask = np.tril(rng.random((n, n)) < density, k=-1)
    w = np.where(mask, rng.uniform(0.1, 1.0, (n, n)), 0.0)
    return GaussianDAG(weights=w, adj=mask)


def sample_gaussian_dag(n: int, m: int, density: float = 0.1, seed: int = 0,
                        noise_std: float = 1.0):
    """Returns (x: (m, n) float64 samples, dag). Topological order =
    variable order."""
    rng = np.random.default_rng(seed)
    dag = random_dag(n, density, rng)
    noise = rng.normal(0.0, noise_std, size=(m, n))
    x = np.zeros((m, n))
    for i in range(n):
        x[:, i] = noise[:, i] + x[:, :i] @ dag.weights[i, :i]
    return x, dag


def sample_discrete_dag(n: int, m: int, density: float = 0.2, arity: int = 3, seed: int = 0,
                        concentration: float = 0.5):
    """Categorical samples from a random DAG with Dirichlet CPTs: one
    conditional table per joint parent configuration, rows drawn
    Dirichlet(concentration), ancestral sampling in variable order.
    Returns (x: (m, n) int64 codes in [0, arity), dag)."""
    rng = np.random.default_rng(seed)
    dag = random_dag(n, density, rng)
    x = np.zeros((m, n), dtype=np.int64)
    for i in range(n):
        ps = dag.parents(i)
        q = arity ** len(ps)
        cpt = rng.dirichlet([concentration] * arity, size=q)  # (q, arity)
        cfg = np.zeros(m, dtype=np.int64)
        for p in ps:  # MSB-first fold, the engines' convention
            cfg = cfg * arity + x[:, p]
        u = rng.random(m)
        x[:, i] = (cpt[cfg].cumsum(axis=1) < u[:, None]).sum(axis=1)
    return x, dag
