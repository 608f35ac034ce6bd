"""Top-level PC-stable driver of the port (``src/repro/core/pc.py``'s
``pc`` / ``pc_from_corr`` with engine "auto").

    run = pc(x, alpha=0.01)                       # the CUDA card
    run = pc(x, alpha=0.01, device="cpu")         # plain PyTorch versions
    run = pc_from_corr(c, m, alpha=0.01, device="cpu")

Host loop over levels (paper Algorithm 2): level 0 fused, ℓ = 1 on the
dense level-1 kernel, ℓ ≥ 2 on chunked cuPC-S (cholinv + cisweep), then
orientation to the CPDAG. Results come back as numpy arrays in the
reference's dtypes.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .. import device as D
from ..obs import Tracer
from . import engines as E
from . import validate as V
from .cit import correlation_from_samples, resolve_citest
from .combinadics import MAX_LEVEL
from .orient import cpdag_from_skeleton

#: slots per sepset (-1 padded): the reference's default depth
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
                 max_level: int | None = None, cell_budget: int = E.DEFAULT_CELL_BUDGET,
                 validate: bool = True, test=None, device=None,
                 wide_ranks: bool = False) -> PCRun:
    """PC-stable from a correlation matrix c (n, n) and its sample count m.

    device: None means the CUDA card (raises without one); "cpu" runs the
    plain PyTorch versions of the kernels. wide_ranks=True carries combo
    ranks in int64 (the reference needs jax_enable_x64 for that)."""
    dev = D.resolve_device(device)
    test = resolve_citest(test, m, alpha)
    tracer = Tracer()
    with tracer.span("total", engine=str(engine)):
        if validate:
            V.validate_corr(c, m, max_level=max_level)
        c = _tensor(c).to(dev, torch.float32).contiguous()
        lmax = min(max_level if max_level is not None else MAX_LEVEL, SEPSET_DEPTH)
        run = _pc_run_host_loop(c, test, engine=engine, lmax=lmax, cell_budget=cell_budget,
                                tracer=tracer, rank_dtype=D.rank_dtype(wide_ranks))
    run.timings_s = tracer.timings()
    return run


def _pc_run_host_loop(c, test, *, engine, lmax, cell_budget, tracer, rank_dtype):
    """The per-level host loop, one span per level; each span waits for the
    level's work on the card before it closes."""
    n = c.shape[0]
    with tracer.span("level0", level=0) as sp:
        adj = test.level0(c, test.tau(0, insufficient="warn"))
        sep = torch.full((n, n, SEPSET_DEPTH), -1, dtype=torch.int32, device=c.device)
        sep[:, :, 0] = torch.where(adj, -1, -2).to(torch.int32)
        sp.sync(adj)

    stats_out = []
    ell = 1
    while ell <= lmax:
        max_deg = int(adj.sum(dim=1, dtype=torch.int32).max()) if n else 0
        if max_deg - 1 < ell:
            break
        with tracer.span(f"level{ell}", level=ell) as sp:
            adj, sep, st = E.run_level(
                c, adj, sep, ell, test.tau(ell, insufficient="warn"), engine=engine,
                cell_budget=cell_budget, rank_dtype=rank_dtype)
            sp.sync(adj).set(**{k: st[k] for k in ("engine", "chunks", "dispatches",
                                                   "total_sets", "npr_bucket") if k in st})
        stats_out.append({"level": ell, **st})
        ell += 1

    with tracer.span("orient") as sp:
        cpdag = cpdag_from_skeleton(adj, sep)
        sp.sync(cpdag)

    return PCRun(adj=adj.cpu().numpy(), cpdag=cpdag.cpu().numpy(),
                 sepsets=sep.cpu().numpy(), levels_run=ell - 1, level_stats=stats_out)


def pc(x, alpha: float = 0.01, engine="auto", max_level: int | None = None,
       corr: str = "auto", validate: bool = True, test=None, device=None, **kw) -> PCRun:
    """PC-stable from raw samples x: (m, n).

    corr: "kernel" computes C with the GEMM kernel (kernels/ops.correlation,
    whose CPU tensors take the plain version), "plain" with
    ``cit.correlation_from_samples``; "auto" picks the kernel on the CUDA
    card and the plain version on the CPU."""
    dev = D.resolve_device(device)
    if corr not in ("auto", "kernel", "plain"):
        raise ValueError(f"corr must be auto|kernel|plain, got {corr!r}")
    x = _tensor(x).to(torch.float32)
    t = resolve_citest(test, int(x.shape[0]), alpha)
    if validate:
        V.validate_samples(x, max_level=max_level)
    x = x.to(dev)
    if corr == "kernel" or (corr == "auto" and dev.type == "cuda"):
        from repro_torch.kernels.ops import correlation

        c = correlation(x)
    else:
        c = correlation_from_samples(x)
    return pc_from_corr(c, int(x.shape[0]), alpha=alpha, engine=engine,
                        max_level=max_level, validate=False, test=t, device=dev, **kw)
