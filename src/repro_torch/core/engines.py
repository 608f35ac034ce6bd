"""Engine registry of the port: which code path runs a PC-stable level
(port of ``src/repro/core/engines.py``).

  "S"         cuPC-S as PyTorch ops (``levels.chunk_s``), the correctness
              anchor; ``pipeline_depth`` ≥ 2 queues that many chunks'
              tests ahead of their commits.
  "E"         cuPC-E as PyTorch ops (``levels.chunk_e``): one independent
              test per (row, slot, rank), no shared inverse.
  "S-kernel"  any ℓ ≥ 1: chunked cuPC-S with cholinv's and cisweep's
              arithmetic (``ops.chunk_s_kernel``): on the card one fused
              skernel launch a chunk, which unranks its sets and reads C.
  "S-grid"    any ℓ ≥ 1: grid-resident cuPC-S, each launch of ranks one
              sgrid kernel that sweeps them all and keeps only the winners
              (``ops.chunk_s_grid``), planned at ``levels.GRID_CELL_BUDGET``
              so a level usually takes one launch.
  "L1-dense"  ℓ = 1 only: the dense level-1 kernel (``ops.level1_dense``)
              and ``levels.commit_dense_l1``; "S" at ℓ ≥ 2.
  "auto"      L1-dense at ℓ = 1, S-kernel at ℓ ≥ 2.
  "G2"        the discrete G² test (``levels.chunk_g2``) on the plain
              ``gsq_ref``, on any device; needs a ``DiscreteCITest``.
  "G2-kernel" the same worklist through ``ops.gsq``: the gsq kernel on
              the card. Under a discrete test "S"/"E" name "G2" and
              "auto"/"S-kernel" name "G2-kernel", as in the reference.

  "scan"      the fixed-shape batch path (``batch/scan_pc.py``): the
              whole skeleton phase up to a static level cap, one CUDA
              graph on the card. A whole-run engine: ``pc_from_corr``
              dispatches it before the level loop, and ``resolve`` rejects
              it at level granularity. ``batch_run`` runs it over a batch.
"""
from __future__ import annotations

import functools

import torch

from .. import obs
from . import levels as L
from .levels import DEFAULT_CELL_BUDGET

#: engines of the discrete G² test
DISCRETE_ENGINES = ("G2", "G2-kernel")
ENGINE_NAMES = ("S", "E", "S-kernel", "S-grid", "L1-dense", "auto", "scan") + DISCRETE_ENGINES
#: engines that take over the whole run (level loop included) instead of
#: a level; pc_from_corr dispatches them before its level loop
WHOLE_RUN_ENGINES = ("scan",)
_CANON = {name.lower(): name for name in ENGINE_NAMES}
#: generic names → the G² engines, under a discrete test
_DISCRETE_REMAP = {"S": "G2", "E": "G2", "auto": "G2-kernel", "S-kernel": "G2-kernel",
                   "G2": "G2", "G2-kernel": "G2-kernel"}


def is_whole_run(engine) -> bool:
    """True when the engine name replaces pc_from_corr's host level loop
    (only "scan")."""
    return not callable(engine) and str(engine).lower() in (
        name.lower() for name in WHOLE_RUN_ENGINES)


def resolve(engine, ell: int, test=None) -> str:
    """Concrete engine for level ℓ; ``engine`` is a name or callable(ℓ).
    ``test`` (a CI test object, None for Gaussian) gates the (engine ×
    test) matrix as in the reference."""
    if callable(engine):
        engine = engine(ell)
    name = _CANON.get(str(engine).lower())
    if name is None:
        raise ValueError(f"unknown engine {engine!r}; the port runs {ENGINE_NAMES}")
    if name in WHOLE_RUN_ENGINES:
        raise ValueError(
            f"{name!r} is a whole-run engine (batch/scan_pc.py); it is dispatched by "
            "pc_from_corr before the level loop and cannot be selected per level")
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
            "S/E/S-kernel/S-grid/L1-dense/auto.")
    if name == "auto":
        return "L1-dense" if ell == 1 else "S-kernel"
    if name == "L1-dense" and ell != 1:
        return "S"  # the dense cube exists at ℓ = 1 only, as in the reference
    return name


def run_level(c, adj, sep, ell: int, tau: float, engine="auto",
              cell_budget: int = DEFAULT_CELL_BUDGET, rank_dtype: torch.dtype = torch.int32,
              test=None, bucket: bool = True, chunk_fn_s=None, chunk_fn_e=None,
              pipeline_depth: int = 1):
    """Run one level on the resolved engine: returns (adj, sep, stats),
    stats["engine"] naming the concrete path taken. Under a discrete
    ``test`` the C slot carries its ``DiscreteStats`` and τ is α.
    ``pipeline_depth`` ≥ 2 pipelines the "S" worklist only; the other
    engines run depth 1, as in the reference. ``chunk_fn_s`` replaces the
    chunk function of "S", "S-kernel" and "S-grid", ``chunk_fn_e`` that
    of "E"; the G² and dense ℓ = 1 engines ignore both, as the
    reference's do."""
    from repro_torch.kernels import ops

    name = resolve(engine, ell, test)
    kw = dict(cell_budget=cell_budget, bucket=bucket, rank_dtype=rank_dtype)
    if name in DISCRETE_ENGINES:
        from repro_torch.kernels.gsq import gsq_ref

        test.check_level(ell)
        # the (n·T·n′, m) joint codes dominate a G² chunk: rescale the
        # budget so plan_level's ℓ²-cell model gives the chunk m affords
        kw["cell_budget"] = max(1, int(cell_budget) * max(ell, 1) ** 2 // max(int(test.m), 1))
        fn = functools.partial(L.chunk_g2, r=int(test.r),
                               gsq_fn=ops.gsq if name == "G2-kernel" else gsq_ref)
        adj, sep, st = L.run_level(c, adj, sep, ell, tau, chunk_fn_s=fn, **kw)
        st["test"] = "discrete"
    elif name == "L1-dense":
        adj, sep, st = _run_level_dense_l1(c, adj, sep, tau, rank_dtype)
    elif name == "S-kernel":
        adj, sep, st = L.run_level(c, adj, sep, ell, tau,
                                   chunk_fn_s=chunk_fn_s or ops.chunk_s_kernel, **kw)
    elif name == "S-grid":
        # the launch plan keeps the reference's per-launch budget (each
        # level's launch count equals the reference's); an explicit budget
        # is kept (tests force several launches a level with it)
        if cell_budget == DEFAULT_CELL_BUDGET:
            kw["cell_budget"] = L.GRID_CELL_BUDGET
        if chunk_fn_s is None:
            # the fused sgrid reads C[j, S] along rows of Cᵀ: one copy a level
            chunk_fn_s = functools.partial(ops.chunk_s_grid, c_t=c.T.contiguous())
        adj, sep, st = L.run_level(c, adj, sep, ell, tau, chunk_fn_s=chunk_fn_s, **kw)
    else:
        adj, sep, st = L.run_level(c, adj, sep, ell, tau, engine=name, chunk_fn_s=chunk_fn_s,
                                   chunk_fn_e=chunk_fn_e, pipeline_depth=pipeline_depth, **kw)
    st["engine"] = name
    # the one seam where per-level counters enter the metrics registry
    # (levels.run_level stays registry-free, so nothing counts twice)
    obs.record_level_stats(st, level=ell, layout="single")
    return adj, sep, st


def batch_run(cs, m, *, mesh=None, level_sync: bool = False, **kw):
    """A many-graph workload through the whole-run "scan" engine.

    cs: (B, n, n) float32 correlation matrices; m: the sample count behind
    them (it sets the Fisher-z thresholds). ``level_sync=True`` runs
    ``scan_levels_batch`` (one host sync a level for the batch, tight
    widths found on the fly) and returns (ScanResult, schedule); otherwise
    ``pc_scan_batch`` (no level syncs) returns a ScanResult with a leading
    B axis. Both give the same results, equal to the single-graph engines
    up to the static level cap whenever ``ok`` is True. ``mesh``
    (``core/sharding.py``) shards the batch axis over its devices, with
    results bitwise equal to mesh=None."""
    from repro_torch.batch.scan_pc import pc_scan_batch, scan_levels_batch

    if level_sync:
        return scan_levels_batch(cs, m, mesh=mesh, **kw)
    return pc_scan_batch(cs, m, mesh=mesh, **kw)


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
