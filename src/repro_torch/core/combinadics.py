"""Binomial table for lexicographic combination unranking (a copy of
``MAX_LEVEL`` and ``binom_table`` from ``src/repro/core/combinadics.py``).
"""
from __future__ import annotations

import functools

import numpy as np

#: Maximum supported conditioning-set size.
MAX_LEVEL = 16


@functools.lru_cache(maxsize=64)
def binom_table(n_max: int, l_max: int = MAX_LEVEL) -> np.ndarray:
    """Pascal-triangle table T[n, k] = C(n, k), shape (n_max+1, l_max+2),
    int64, saturating at int64 max // 2. Consumers clip it to the rank
    dtype's capacity; ``levels.plan_level`` refuses levels whose ranks
    could reach clipped entries."""
    t = np.zeros((n_max + 1, l_max + 2), dtype=np.int64)
    t[:, 0] = 1
    for n in range(1, n_max + 1):
        for k in range(1, l_max + 2):
            v = t[n - 1, k - 1] + t[n - 1, k]
            t[n, k] = min(v, np.iinfo(np.int64).max // 2)
    return t
