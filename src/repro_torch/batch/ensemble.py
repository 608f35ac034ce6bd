"""Bootstrap ensemble PC: resample → correlate → batched scan → aggregate
(port of ``src/repro/batch/ensemble.py``).

PC on finite samples is brittle: edges near the CI threshold flip with
the draw. The practitioner's fix (stability selection, bootstrap
aggregation; ParallelPC's many-runs workload) runs PC on B bootstrap
resamples and keeps the edges that recur:

  1. resampling: B index vectors of m draws with replacement;
  2. per-replicate correlation: the corr kernel on the card
     (``ops.correlation``, one a replicate), the plain
     ``correlation_from_samples`` on the CPU;
  3. B skeletons through ``scan_pc.scan_levels_batch`` (one recorded
     program a level on the card) or, with a planned ``n_prime``,
     ``scan_pc.pc_scan_batch`` (one program for the whole phase);
  4. aggregation: edge frequencies, the stability-selected skeleton
     (freq ≥ threshold), a per-(i, j, k) majority vote over the
     replicates' separating sets and the aggregate CPDAG
     (``orient.cpdag_from_membership``).

The resample indices differ from the reference's: it draws them with
``jax.random.randint``, which torch's generator cannot reproduce. The
port draws them from a ``torch.Generator`` seeded by ``seed`` (or the
caller's ``generator``) and accepts ``indices=`` (B, m) from outside,
which is how the tests hand it the reference's draws (ROADMAP Queue 3,
standing deviations).

Memory: the sepset vote needs an (n, n, n) membership tensor a
replicate. It is chunked over the replicate axis under a byte cap
(``AGG_MEMBERSHIP_BUDGET``): a step forms ``vote_chunk`` replicates'
membership and folds it into the (n, n, n) int32 vote counts. Integer
counts accumulate in ascending replicate order, so every chunking gives
the same result.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import obs
from ..core.cit import check_corr, correlation_of
from ..core.levels import DEFAULT_CELL_BUDGET
from ..core.orient import cpdag_from_membership, sepset_membership
from .scan_pc import DEFAULT_MAX_LEVEL, _home, pc_scan_batch, scan_levels_batch


@dataclass
class EnsembleRun:
    """Aggregated result of a bootstrap PC ensemble (host numpy arrays)."""

    edge_freq: np.ndarray  # (n,n) float32 — fraction of replicates with the edge
    adj: np.ndarray  # (n,n) bool — stability-selected skeleton
    cpdag: np.ndarray  # (n,n) bool — CPDAG of the aggregated skeleton
    replicate_adj: np.ndarray  # (B,n,n) bool — per-replicate skeletons
    replicate_ok: np.ndarray  # (B,) bool — per-replicate exactness (scan `ok`);
    # False marks a degree-capped replicate (only possible with a
    # user-supplied n_prime narrower than that replicate's live degrees)
    n_boot: int
    stability_threshold: float
    schedule: tuple  # per-level static widths the replicate batch ran at
    timings_s: dict = field(default_factory=dict)

    def stable_edges(self) -> list[tuple[int, int]]:
        """(i, j), i < j, of the stability-selected skeleton."""
        i, j = np.nonzero(np.triu(self.adj, 1))
        return list(zip(i.tolist(), j.tolist()))


def resample_indices(n_boot: int, m: int, seed: int = 0,
                     generator: torch.Generator | None = None) -> torch.Tensor:
    """(n_boot, m) int64 bootstrap draws with replacement: ``torch.randint``
    from ``generator`` or, without one, from a CPU ``torch.Generator``
    seeded by ``seed`` (the same draws on every host and device)."""
    gen = generator if generator is not None else torch.Generator().manual_seed(seed)
    return torch.randint(0, m, (n_boot, m), generator=gen, device=gen.device)


def bootstrap_corr(x, indices, corr: str = "auto") -> torch.Tensor:
    """B bootstrap-resampled correlation matrices (B, n, n) float32 from
    samples x (m, n) and resample indices (B, m) int64.

    corr follows ``core/pc.pc``: "kernel" takes ``ops.correlation`` (the
    corr kernel for a CUDA x, its plain version for a CPU one), "plain"
    ``cit.correlation_from_samples``, "auto" the kernel on the card and
    the plain version on the CPU."""
    check_corr(corr)
    x = x if isinstance(x, torch.Tensor) else torch.tensor(np.asarray(x))
    x = x.to(torch.float32)
    indices = torch.as_tensor(indices, dtype=torch.int64).to(x.device)
    return torch.stack([correlation_of(x[idx], corr) for idx in indices])


#: Byte cap on the sepset-vote membership tensor formed per aggregation
#: step (bool cells): 2²⁸ B = 256 MB → vote_chunk = 256 MB / n³, e.g. 256
#: replicates at n = 100 and single-replicate steps from n ≈ 645 up.
AGG_MEMBERSHIP_BUDGET = 2**28


def _vote_chunk(n_boot: int, n: int, budget: int = AGG_MEMBERSHIP_BUDGET) -> int:
    """Replicates whose (n, n, n) membership tensors fit the byte budget."""
    return max(1, min(int(n_boot), budget // max(n * n * n, 1)))


def _aggregate(adj_b, sep_b, thresh, *, vote_chunk: int | None = None):
    """Edge frequencies, stability skeleton and voted-sepset CPDAG.

    Sepset vote: k ∈ SepSet(i, j) for the aggregate iff a strict majority
    of the replicates that removed (i, j) recorded k as a separator.
    Replicates keeping the edge abstain; level-0 removals vote "empty
    set" (their sentinel slots name no variable).

    vote_chunk: replicates whose membership tensors are formed per vote
    step (None: all at once). The int32 votes of each step are added in
    ascending replicate order, so any chunking gives the same result."""
    b_total, n = adj_b.shape[0], adj_b.shape[-1]
    eye = torch.eye(n, dtype=torch.bool, device=adj_b.device)
    # the reference's mean is the f32 sum times the f32 reciprocal of B
    inv_b = torch.tensor(np.float32(1.0) / np.float32(b_total), device=adj_b.device)
    freq = adj_b.sum(dim=0, dtype=torch.float32) * inv_b
    skel = (freq >= thresh) & ~eye

    removed = ~adj_b & ~eye[None]  # (B, n, n)
    step = b_total if vote_chunk is None else min(vote_chunk, b_total)
    votes = torch.zeros((n, n, n), dtype=torch.int32, device=adj_b.device)
    for b0 in range(0, b_total, step):
        member = torch.stack([sepset_membership(s) for s in sep_b[b0:b0 + step]])
        votes += (removed[b0:b0 + step, :, :, None] & member).sum(dim=0, dtype=torch.int32)
        del member
    denom = removed.sum(dim=0, dtype=torch.int32)[..., None]
    member = votes * 2 > denom
    del votes
    return freq, skel, cpdag_from_membership(skel, member)


def bootstrap_pc(
    x,
    n_boot: int = 32,
    alpha: float = 0.01,
    stability_threshold: float = 0.5,
    max_level: int | None = None,
    sepset_depth: int = 8,
    seed: int = 0,
    generator: torch.Generator | None = None,
    indices=None,
    corr: str = "auto",
    n_prime: int | None = None,
    cell_budget: int = DEFAULT_CELL_BUDGET,
    mesh=None,
    device=None,
) -> EnsembleRun:
    """Bootstrap-ensemble PC-stable on samples x (m, n).

    Resample indices: ``indices`` (n_boot, m) int64 when given, else
    ``resample_indices(n_boot, m, seed, generator)``. The reference draws
    them with ``jax.random`` from a ``key``, which torch cannot reproduce;
    pass its draws as ``indices`` for its replicates.

    ``n_prime=None`` runs the level-synced ``scan_levels_batch`` (one host
    sync a level for all replicates, always exact); a planned schedule (or
    int width) runs the one-program ``pc_scan_batch``. device: None means
    the CUDA card (raises without one); "cpu" runs the plain versions.
    ``mesh`` (``core/sharding.py``) shards the replicate axis of the scan
    over its devices (the correlations and the aggregate run on its first
    device, which ``device`` then names); bitwise equal to mesh=None.
    """
    dev = _home(mesh, device)
    tracer = obs.run_tracer("bootstrap_pc")
    with tracer.span("total", n_boot=int(n_boot)):
        x = (x if isinstance(x, torch.Tensor) else torch.tensor(np.asarray(x)))
        x = x.to(dev, torch.float32)
        m, n = int(x.shape[0]), int(x.shape[1])
        if max_level is None:
            max_level = DEFAULT_MAX_LEVEL
        if indices is None:
            indices = resample_indices(n_boot, m, seed, generator)
        indices = torch.as_tensor(indices, dtype=torch.int64)
        if tuple(indices.shape) != (n_boot, m):
            raise ValueError(f"indices must be (n_boot, m) = ({n_boot}, {m}); got "
                             f"{tuple(indices.shape)}")

        with tracer.span("bootstrap_corr") as sp:
            cs = bootstrap_corr(x, indices, corr=corr)
            sp.sync(cs)

        scan_phase = "scan_levels_batch" if n_prime is None else "pc_scan_batch"
        with tracer.span(scan_phase) as sp:
            if n_prime is None:
                res, schedule = scan_levels_batch(
                    cs, m, alpha=alpha, max_level=max_level, sepset_depth=sepset_depth,
                    cell_budget=cell_budget, orient=False, mesh=mesh, device=dev,
                )
            else:
                res = pc_scan_batch(
                    cs, m, alpha=alpha, max_level=max_level, sepset_depth=sepset_depth,
                    n_prime=n_prime, cell_budget=cell_budget, orient=False, mesh=mesh,
                    device=dev,
                )
                schedule = (tuple(n_prime) if isinstance(n_prime, (tuple, list))
                            else (int(n_prime),) * max_level)
            sp.sync(res.adj).set(schedule=list(schedule))

        replicate_ok = res.ok.cpu().numpy()
        if not replicate_ok.all():
            warnings.warn(
                f"{int((~replicate_ok).sum())}/{n_boot} bootstrap replicates "
                f"were degree-capped by n_prime={n_prime!r} (scan ok=False) — "
                "their skeletons are approximate; pass n_prime=None for exact "
                "widths",
                stacklevel=2,
            )

        with tracer.span("aggregate") as sp:
            freq, skel, cpdag = _aggregate(res.adj, res.sepsets, float(stability_threshold),
                                           vote_chunk=_vote_chunk(n_boot, n))
            sp.sync(cpdag)

    run = EnsembleRun(
        edge_freq=freq.cpu().numpy(),
        adj=skel.cpu().numpy(),
        cpdag=cpdag.cpu().numpy(),
        replicate_adj=res.adj.cpu().numpy(),
        replicate_ok=replicate_ok,
        n_boot=int(n_boot),
        stability_threshold=float(stability_threshold),
        schedule=schedule,
        timings_s=tracer.timings(),
    )
    tracer.finish(driver="bootstrap_pc", n_boot=int(n_boot))
    return run
