"""Engine registry of the port: which code path runs a PC-stable level
(port of the "auto" part of ``src/repro/core/engines.py``).

  "L1-dense"  ℓ = 1 only: the dense level-1 kernel (``ops.level1_dense``)
              and ``levels.commit_dense_l1``.
  "S-kernel"  any ℓ ≥ 1: chunked cuPC-S through cholinv + cisweep
              (``ops.chunk_s_kernel``).
  "auto"      L1-dense at ℓ = 1, S-kernel at ℓ ≥ 2.

The reference's other engines are not ported yet; naming one raises a
``ValueError`` that says which ROADMAP item ports it.
"""
from __future__ import annotations

import torch

from . import levels as L
from .levels import DEFAULT_CELL_BUDGET

ENGINE_NAMES = ("auto", "L1-dense", "S-kernel")
#: engines of the reference still to port → the ROADMAP item that ports them
NOT_PORTED = {
    "S": "ROADMAP Queue 1 item 3 (the torch \"S\" engine)",
    "E": "ROADMAP Queue 1 item 7 (the rest of the Gaussian engines)",
    "S-grid": "ROADMAP Queue 1 item 7 and Queue 2 item 6 (sgrid)",
    "G2": "ROADMAP Queue 1 item 8 (the discrete test)",
    "G2-kernel": "ROADMAP Queue 1 item 8 and Queue 2 item 7 (gsq)",
    "scan": "ROADMAP Queue 1 item 9 (the batch subsystem)",
}
_CANON = {name.lower(): name for name in ENGINE_NAMES + tuple(NOT_PORTED)}


def resolve(engine, ell: int) -> str:
    """Concrete engine for level ℓ; ``engine`` is a name or callable(ℓ)."""
    if callable(engine):
        engine = engine(ell)
    name = _CANON.get(str(engine).lower())
    if name is None:
        raise ValueError(f"unknown engine {engine!r}; the port runs {ENGINE_NAMES}")
    if name == "auto":
        name = "L1-dense" if ell == 1 else "S-kernel"
    elif name == "L1-dense" and ell != 1:
        name = "S"  # the dense cube exists at ℓ = 1 only, as in the reference
    if name in NOT_PORTED:
        raise ValueError(f"engine {name!r} is not ported yet: {NOT_PORTED[name]}")
    return name


def run_level(c, adj, sep, ell: int, tau: float, engine="auto",
              cell_budget: int = DEFAULT_CELL_BUDGET, rank_dtype: torch.dtype = torch.int32):
    """Run one level on the resolved engine: returns (adj, sep, stats),
    stats["engine"] naming the concrete path taken."""
    from repro_torch.kernels import ops

    name = resolve(engine, ell)
    if name == "L1-dense":
        return _run_level_dense_l1(c, adj, sep, tau, rank_dtype)
    adj, sep, st = L.run_level(c, adj, sep, ell, tau, chunk_fn=ops.chunk_s_kernel,
                               cell_budget=cell_budget, rank_dtype=rank_dtype)
    st["engine"] = "S-kernel"
    return adj, sep, st


def _run_level_dense_l1(c, adj, sep, tau, rank_dtype):
    """ℓ = 1 as one dense kernel launch and its commit."""
    from repro_torch.kernels import ops

    npr = int(adj.sum(dim=1, dtype=torch.int32).max()) if adj.shape[0] else 0
    if npr - 1 < 1:
        return adj, sep, {"skipped": True, "chunks": 0, "dispatches": 0,
                          "npr": npr, "engine": "L1-dense"}
    _removed, kwin = ops.level1_dense(c, adj, tau)
    adj_new, sep_new = L.commit_dense_l1(adj, sep, kwin, rank_dtype)
    return adj_new, sep_new, {
        "skipped": False, "chunks": 1, "dispatches": 1, "npr": npr,
        "npr_bucket": npr, "total_sets": npr, "engine": "L1-dense", "dense": True,
    }
