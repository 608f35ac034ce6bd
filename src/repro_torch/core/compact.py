"""Row compaction of the adjacency matrix (paper §3.3, Fig. 2): port of
``src/repro/core/compact.py::compact_rows``."""
from __future__ import annotations

import torch


def compact_rows(adj: torch.Tensor, n_prime: int | None = None):
    """Compact each row of a boolean adjacency matrix.

    Returns (compact (n, n′) int32 — neighbour ids left-justified, -1
    padded; counts (n,) int32 — n′_i). Non-neighbours sort behind the
    neighbours under the sentinel key n."""
    n = adj.shape[0]
    width = n if n_prime is None else n_prime
    adj = adj.to(torch.bool)
    counts = adj.sum(dim=1, dtype=torch.int32)
    col = torch.arange(n, dtype=torch.int32, device=adj.device).expand(n, n)
    key = torch.where(adj, col, n)
    order = torch.sort(key, dim=1).values[:, :width]
    compact = torch.where(order == n, -1, order)
    return compact, counts
