"""Top-level PC-stable driver of the port (``src/repro/core/pc.py``'s
``pc`` / ``pc_from_corr`` over the Gaussian engines, and the discrete G²
route).

    run = pc(x, alpha=0.01)                       # the CUDA card
    run = pc(x, alpha=0.01, device="cpu")         # plain PyTorch versions
    run = pc_from_corr(c, m, alpha=0.01, device="cpu")
    run = pc(x, engine="S-grid")                  # one sgrid launch a level
    run = pc(codes, alpha=0.01, test="discrete")  # categorical samples

Host loop over levels (paper Algorithm 2). Gaussian: level 0 (adjacency,
level-0 sepsets and ℓ = 1's max degree) in one launch of the level-0
kernel, then each level on the engine ``engines.resolve`` names; "auto"
runs ℓ = 1 on the dense level-1 kernel and ℓ ≥ 2 on chunked cuPC-S (the
fused skernel, one launch a chunk). Discrete: every level on the G²
worklist through the gsq kernel. Then orientation to the CPDAG. Results come back
as numpy arrays in the reference's dtypes.

engine="scan" replaces the host level loop with the fixed-shape batch
path (``batch/scan_pc.py``): the same results up to its static level cap,
and on the card one CUDA graph for the whole skeleton phase.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import device as D
from .. import obs
from . import engines as E
from . import levels as L
from . import validate as V
from .cit import check_corr, correlation_of, encode_discrete, resolve_citest
from .combinadics import MAX_LEVEL
from .orient import cpdag_from_skeleton

#: default slots per sepset (-1 padded), as the reference's ``sepset_depth``
SEPSET_DEPTH = 8


@dataclass
class PCRun:
    adj: np.ndarray  # skeleton (n, n) bool
    cpdag: np.ndarray  # digraph (n, n) bool
    sepsets: np.ndarray  # (n, n, Lmax) int32, -1 padded, -2 = removed at level 0
    levels_run: int
    level_stats: list = field(default_factory=list)
    timings_s: dict = field(default_factory=dict)

    def sepset_dict(self) -> dict:
        """{(i, j) with i < j: separator ids} for removed edges with a
        recorded sepset; level-0 removals (the -2 sentinel) are excluded."""
        n = self.adj.shape[0]
        iu, ju = np.triu_indices(n, 1)
        srows = self.sepsets[iu, ju]
        has_ids = (srows >= 0).any(axis=1)
        keep = ~self.adj[iu, ju] & (has_ids | (srows[:, 0] != -2))
        return {
            (int(i), int(j)): tuple(int(v) for v in row[row >= 0])
            for i, j, row in zip(iu[keep], ju[keep], srows[keep])
        }


def _tensor(a) -> torch.Tensor:
    """A tensor as given, or a copy of array data (which may be read-only)."""
    return a if isinstance(a, torch.Tensor) else torch.tensor(np.asarray(a))


def pc_from_corr(c, m: int, alpha: float = 0.01, engine="auto",
                 max_level: int | None = None, sepset_depth: int = SEPSET_DEPTH,
                 cell_budget: int = E.DEFAULT_CELL_BUDGET, orient: bool = True,
                 chunk_fn_s=None, chunk_fn_e=None, validate: bool = True, test=None,
                 device=None, wide_ranks: bool = False, bucket: bool = True,
                 pipeline_depth: int = 1) -> PCRun:
    """PC-stable from a correlation matrix c (n, n) and its sample count m.

    device: None means the CUDA card (raises without one); "cpu" runs the
    plain PyTorch versions of the kernels. wide_ranks=True carries combo
    ranks in int64 (the reference needs jax_enable_x64 for that).
    bucket=False plans each level at its exact max degree;
    pipeline_depth ≥ 2 keeps that many rank chunks' tests queued ahead of
    their commits on the "S" worklist (equal results).

    sepset_depth: slots per recorded sepset; it also caps the levels run.
    orient=False skips orientation: the returned "CPDAG" is the skeleton.
    chunk_fn_s / chunk_fn_e replace the chunk function of the "S" and "E"
    worklists (and of "S-kernel" and "S-grid", whose own kernels they
    stand in for), with ``levels.run_level``'s chunk contract."""
    dev = D.resolve_device(device)
    test = resolve_citest(test, m, alpha)
    if test.kind != "gaussian":
        raise ValueError(
            f"pc_from_corr runs the Gaussian partial-correlation test; a {test.kind!r} "
            "CI test needs raw samples — call pc(x, test=...) instead")
    _check_engine(engine, test)
    tracer = obs.run_tracer("pc_from_corr")
    with tracer.span("total", engine=str(engine)):
        if validate:
            V.validate_corr(c, m, max_level=max_level)
        c = _tensor(c).to(dev, torch.float32).contiguous()
        lmax = min(max_level if max_level is not None else MAX_LEVEL, sepset_depth)
        if E.is_whole_run(engine):
            run = _pc_run_scan(c, m, alpha=alpha, max_level=max_level,
                               sepset_depth=sepset_depth, cell_budget=cell_budget,
                               orient=orient, tracer=tracer)
        else:
            run = _pc_run_host_loop(c, test, engine=engine, lmax=lmax,
                                    sepset_depth=sepset_depth, cell_budget=cell_budget,
                                    orient=orient, chunk_fn_s=chunk_fn_s,
                                    chunk_fn_e=chunk_fn_e, tracer=tracer,
                                    rank_dtype=D.rank_dtype(wide_ranks), bucket=bucket,
                                    pipeline_depth=pipeline_depth)
    run.timings_s = tracer.timings()
    tracer.finish(driver="pc_from_corr", engine=str(engine), n=int(run.adj.shape[0]),
                  levels_run=run.levels_run)
    return run


def _check_engine(engine, test):
    """Refuse an engine name the test cannot run before any work starts (a
    callable is checked level by level, a whole-run engine by its path)."""
    if not callable(engine) and not E.is_whole_run(engine):
        E.resolve(engine, 1, test)


def _pc_run_host_loop(stats, test, *, engine, lmax, sepset_depth, cell_budget, orient,
                      chunk_fn_s, chunk_fn_e, tracer, rank_dtype, bucket=True,
                      pipeline_depth=1):
    """The per-level host loop, one span per level; each span waits for the
    level's work on the card before it closes. ``stats`` is the test's
    sufficient statistic: C (n, n) or ``DiscreteStats`` with (m, n) codes."""
    with tracer.span("level0", level=0) as sp:
        # on the card for a Gaussian C: one fused launch, adj, the level-0
        # sepsets and ℓ = 1's max degree
        adj, sep, max_deg = test.level0_span(stats, test.tau(0, insufficient="warn"),
                                             sepset_depth)
        sp.sync(adj)

    stats_out = []
    ell = 1
    while ell <= lmax:
        if ell > 1:
            max_deg = L.max_degree(adj)
        if int(max_deg) - 1 < ell:
            break
        with tracer.span(f"level{ell}", level=ell) as sp:
            adj, sep, st = E.run_level(
                stats, adj, sep, ell, test.tau(ell, insufficient="warn"), engine=engine,
                cell_budget=cell_budget, rank_dtype=rank_dtype, test=test, bucket=bucket,
                chunk_fn_s=chunk_fn_s, chunk_fn_e=chunk_fn_e, pipeline_depth=pipeline_depth)
            sp.sync(adj).set(**{k: st[k] for k in ("engine", "chunks", "dispatches",
                                                   "total_sets", "npr_bucket") if k in st})
        stats_out.append({"level": ell, **st})
        ell += 1

    with tracer.span("orient") as sp:
        cpdag = cpdag_from_skeleton(adj, sep) if orient else adj
        sp.sync(cpdag)

    return PCRun(adj=adj.cpu().numpy(), cpdag=cpdag.cpu().numpy(),
                 sepsets=sep.cpu().numpy(), levels_run=ell - 1, level_stats=stats_out)


def _pc_run_scan(stats, m, *, alpha, max_level, sepset_depth, cell_budget, orient, tracer,
                 test=None):
    """engine="scan": the whole run as the fixed-shape program of
    ``batch/scan_pc.py``, in the PCRun contract.

    max_level=None uses the scan's static DEFAULT_MAX_LEVEL (warned when
    ``sepset_depth`` allows deeper levels); results equal the host loop's
    at the same cap. levels_run counts the levels that had work (the host
    driver's stopping rule on the recorded per-level max degrees), not
    the cap."""
    import warnings

    from repro_torch.batch.scan_pc import DEFAULT_MAX_LEVEL, pc_scan

    if max_level is None and sepset_depth > DEFAULT_MAX_LEVEL:
        warnings.warn(
            f"engine='scan' runs a STATIC level cap of {DEFAULT_MAX_LEVEL} "
            "by default, while the host-loop engines iterate until "
            "convergence — on deep graphs the skeletons differ. Pass "
            "max_level explicitly to choose the cap (and silence this).",
            stacklevel=4,
        )
    lmax = min(DEFAULT_MAX_LEVEL if max_level is None else max_level, sepset_depth)
    dev = stats.codes.device if test is not None else stats.device
    with tracer.span("scan", max_level=lmax) as sp:
        res = pc_scan(stats, m, alpha=alpha, max_level=lmax, sepset_depth=sepset_depth,
                      cell_budget=cell_budget, orient=orient, test=test, device=dev)
        sp.sync(res.cpdag)
    # the host driver stops at the first level with max_deg - 1 < ell
    degs = res.max_degs.cpu().numpy()
    levels_run = 0
    for ell in range(1, lmax + 1):
        if degs[ell - 1] - 1 < ell:
            break
        levels_run = ell
    return PCRun(
        adj=res.adj.cpu().numpy(), cpdag=res.cpdag.cpu().numpy(),
        sepsets=res.sepsets.cpu().numpy(), levels_run=levels_run,
        level_stats=[{"level": ell, "engine": "scan", "skipped": ell > levels_run,
                      "npr": int(degs[ell - 1]), "max_level_static": lmax}
                     for ell in range(1, lmax + 1)],
    )


def _pc_discrete(x, test, *, engine="auto", max_level=None, sepset_depth=SEPSET_DEPTH,
                 cell_budget=E.DEFAULT_CELL_BUDGET, orient=True, chunk_fn_s=None,
                 chunk_fn_e=None, validate=True, device=None, wide_ranks=False, bucket=True,
                 pipeline_depth=1) -> PCRun:
    """The discrete G² route of ``pc``: encode the level codes, bind the
    test's (m, r) to the data (r, the run-wide max arity, is the code
    stride), then run the same host loop with ``DiscreteStats`` in the
    statistic's slot."""
    if validate:
        V.validate_discrete(x, max_level=max_level)
    stats, r_max = encode_discrete(x, device=device)
    test = dataclasses.replace(test, m=int(stats.codes.shape[0]), r=max(int(test.r), r_max))
    _check_engine(engine, test)
    tracer = obs.run_tracer("pc_discrete")
    with tracer.span("total", engine=str(engine)):
        if max_level is None:
            # cap where the table still fits; an explicit deeper max_level
            # is refused by check_level
            lmax = min(MAX_LEVEL, sepset_depth, test.max_supported_level())
        else:
            lmax = min(max_level, sepset_depth)
        test.check_level(lmax)
        if E.is_whole_run(engine):
            if max_level is None:
                # scan's static default cap, still bounded by the table cap
                from repro_torch.batch.scan_pc import DEFAULT_MAX_LEVEL

                lmax = min(lmax, DEFAULT_MAX_LEVEL)
            run = _pc_run_scan(stats, test.m, alpha=test.alpha, max_level=lmax,
                               sepset_depth=sepset_depth, cell_budget=cell_budget,
                               orient=orient, tracer=tracer, test=test)
        else:
            run = _pc_run_host_loop(stats, test, engine=engine, lmax=lmax,
                                    sepset_depth=sepset_depth, cell_budget=cell_budget,
                                    orient=orient, chunk_fn_s=chunk_fn_s,
                                    chunk_fn_e=chunk_fn_e, tracer=tracer,
                                    rank_dtype=D.rank_dtype(wide_ranks), bucket=bucket,
                                    pipeline_depth=pipeline_depth)
    run.timings_s = tracer.timings()
    tracer.finish(driver="pc_discrete", engine=str(engine), n=int(run.adj.shape[0]),
                  levels_run=run.levels_run)
    return run


def pc(x, alpha: float = 0.01, engine="auto", max_level: int | None = None,
       corr: str = "auto", validate: bool = True, test=None, device=None, **kw) -> PCRun:
    """PC-stable from raw samples x: (m, n).

    corr: "kernel" computes C with the GEMM kernel (kernels/ops.correlation,
    whose CPU tensors take the plain version), "plain" with
    ``cit.correlation_from_samples``; "auto" picks the kernel on the CUDA
    card and the plain version on the CPU.

    test: None/"gaussian" (Fisher z on C), "discrete" (G²/χ² on integer
    level codes; x must be categorical and corr left at "auto") or a test
    instance."""
    dev = D.resolve_device(device)
    t = resolve_citest(test, int(np.shape(x)[0]), alpha)
    if t.kind == "discrete":
        if corr != "auto":
            raise ValueError("corr= selects a correlation backend; the discrete G² test "
                             "does not compute correlations")
        return _pc_discrete(x, t, engine=engine, max_level=max_level, validate=validate,
                            device=dev, **kw)
    check_corr(corr)
    x = _tensor(x).to(torch.float32)
    if validate:
        V.validate_samples(x, max_level=max_level)
    c = correlation_of(x.to(dev), corr)
    return pc_from_corr(c, int(x.shape[0]), alpha=alpha, engine=engine,
                        max_level=max_level, validate=False, test=t, device=dev, **kw)
