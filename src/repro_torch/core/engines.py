"""Engine registry of the port: which code path runs a PC-stable level
(port of the "auto" and discrete parts of ``src/repro/core/engines.py``).

  "L1-dense"  ℓ = 1 only: the dense level-1 kernel (``ops.level1_dense``)
              and ``levels.commit_dense_l1``.
  "S-kernel"  any ℓ ≥ 1: chunked cuPC-S through cholinv + cisweep
              (``ops.chunk_s_kernel``).
  "auto"      L1-dense at ℓ = 1, S-kernel at ℓ ≥ 2.
  "G2"        the discrete G² test (``levels.chunk_g2``) on the plain
              ``gsq_ref``, on any device; needs a ``DiscreteCITest``.
  "G2-kernel" the same worklist through ``ops.gsq``: the gsq kernel on
              the card. Under a discrete test "S"/"E" name "G2" and
              "auto"/"S-kernel" name "G2-kernel", as in the reference.

The reference's other engines are not ported yet; naming one raises a
``ValueError`` that says which ROADMAP item ports it.
"""
from __future__ import annotations

import functools

import torch

from . import levels as L
from .levels import DEFAULT_CELL_BUDGET

#: engines of the discrete G² test
DISCRETE_ENGINES = ("G2", "G2-kernel")
ENGINE_NAMES = ("auto", "L1-dense", "S-kernel") + DISCRETE_ENGINES
#: engines of the reference still to port → the ROADMAP item that ports them
NOT_PORTED = {
    "S": "ROADMAP Queue 1 item 3 (the torch \"S\" engine)",
    "E": "ROADMAP Queue 1 item 7 (the rest of the Gaussian engines)",
    "S-grid": "ROADMAP Queue 1 item 7 and Queue 2 item 6 (sgrid)",
    "scan": "ROADMAP Queue 1 item 9 (the batch subsystem)",
}
_CANON = {name.lower(): name for name in ENGINE_NAMES + tuple(NOT_PORTED)}
#: generic names → the G² engines, under a discrete test
_DISCRETE_REMAP = {"S": "G2", "E": "G2", "auto": "G2-kernel", "S-kernel": "G2-kernel",
                   "G2": "G2", "G2-kernel": "G2-kernel"}


def resolve(engine, ell: int, test=None) -> str:
    """Concrete engine for level ℓ; ``engine`` is a name or callable(ℓ).
    ``test`` (a CI test object, None for Gaussian) gates the (engine ×
    test) matrix as in the reference."""
    if callable(engine):
        engine = engine(ell)
    name = _CANON.get(str(engine).lower())
    if name is None:
        raise ValueError(f"unknown engine {engine!r}; the port runs {ENGINE_NAMES}")
    if name == "scan":
        raise ValueError(f"engine 'scan' is not ported yet: {NOT_PORTED['scan']}")
    if getattr(test, "kind", "gaussian") == "discrete":
        if name not in _DISCRETE_REMAP:
            raise ValueError(
                f"engine {name!r} has no discrete-test path: the dense ℓ=1 cube and "
                "the grid-resident sweep are partial-correlation layouts. Use S/auto "
                "(remapped onto the G2 engines) or name G2/G2-kernel directly.")
        return _DISCRETE_REMAP[name]
    if name in DISCRETE_ENGINES:
        raise ValueError(
            f"engine {name!r} runs the discrete G² test and needs a discrete CI test "
            "(pass test='discrete' with categorical samples); the Gaussian path uses "
            "L1-dense/S-kernel/auto.")
    if name == "auto":
        name = "L1-dense" if ell == 1 else "S-kernel"
    elif name == "L1-dense" and ell != 1:
        name = "S"  # the dense cube exists at ℓ = 1 only, as in the reference
    if name in NOT_PORTED:
        raise ValueError(f"engine {name!r} is not ported yet: {NOT_PORTED[name]}")
    return name


def run_level(c, adj, sep, ell: int, tau: float, engine="auto",
              cell_budget: int = DEFAULT_CELL_BUDGET, rank_dtype: torch.dtype = torch.int32,
              test=None):
    """Run one level on the resolved engine: returns (adj, sep, stats),
    stats["engine"] naming the concrete path taken. Under a discrete
    ``test`` the C slot carries its ``DiscreteStats`` and τ is α."""
    from repro_torch.kernels import ops

    name = resolve(engine, ell, test)
    if name in DISCRETE_ENGINES:
        from repro_torch.kernels.gsq import gsq_ref

        test.check_level(ell)
        # the (n·T·n′, m) joint codes dominate a G² chunk: rescale the
        # budget so plan_level's ℓ²-cell model gives the chunk m affords
        budget = max(1, int(cell_budget) * max(ell, 1) ** 2 // max(int(test.m), 1))
        fn = functools.partial(L.chunk_g2, r=int(test.r),
                               gsq_fn=ops.gsq if name == "G2-kernel" else gsq_ref)
        adj, sep, st = L.run_level(c, adj, sep, ell, tau, chunk_fn=fn, cell_budget=budget,
                                   rank_dtype=rank_dtype)
        st["engine"] = name
        st["test"] = "discrete"
        return adj, sep, st
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
