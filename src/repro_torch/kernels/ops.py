"""Public wrappers around the hand kernels, with the contracts of
``src/repro/kernels/ops.py``: ``correlation``, ``level0`` (and
``level0_span``, the driver's whole level-0 span),
``level1_dense``, ``ci_shared``, ``chunk_s_kernel``, ``ci_shared_grid``,
``chunk_s_grid`` and ``gsq``; the sharded grid engine's tests halves
``chunk_s_grid_tests`` (replicated C) and ``chunk_s_grid_tests_cols``
(row-sharded C); and ``chunk_s_two_launch``, the reference's two-kernel
chunk.

Each wrapper runs its CUDA kernel for CUDA tensors and the kernel's plain
PyTorch version for CPU tensors. Unlike the reference, nothing is padded
to TPU tiles: the kernels mask their own ragged edges.
"""
from __future__ import annotations

import functools

import torch

from . import cholinv as _cholinv
from . import cisweep as _cisweep
from . import corr as _corr
from . import gsq as _gsq
from . import level0 as _level0
from . import level1 as _level1
from . import sgrid as _sgrid
from . import skernel as _skernel


def standardize(x: torch.Tensor) -> torch.Tensor:
    """(m, n) samples → zero-mean, unit-std fp32 columns (population std)."""
    x = x.to(torch.float32)
    xc = x - torch.mean(x, dim=0, keepdim=True)
    std = torch.sqrt(torch.mean(xc * xc, dim=0, keepdim=True))
    return xc / torch.clamp(std, min=1e-30)


def correlation(x: torch.Tensor) -> torch.Tensor:
    """Correlation matrix (n, n) fp32 of samples x (m, n) through the GEMM
    kernel, clipped to [-1, 1] with an exact unit diagonal."""
    xn = standardize(x).contiguous()
    c = torch.clamp(_corr.corr_matmul(xn), -1.0, 1.0)
    c.fill_diagonal_(1.0)
    return c


def level0(c: torch.Tensor, tau: float) -> torch.Tensor:
    """Level 0 of the Gaussian test, (n, n) bool: the level-0 kernel for a
    CUDA C, the plain ``levels.level0`` for a CPU one."""
    if c.device.type == "cpu":
        from repro_torch.core import levels as L

        return L.level0(c, tau)
    return _level0.level0_kernel(c.contiguous(), tau)


def level0_span(c: torch.Tensor, tau: float, sepset_depth: int):
    """The driver's level-0 span, (adj (n, n) bool, sep (n, n,
    sepset_depth) int32, max_deg 0-d int32): the fused level-0 kernel, one
    launch, for a CUDA C; the plain ``levels.level0_span`` for a CPU one."""
    if c.device.type == "cpu":
        from repro_torch.core import levels as L

        return L.level0_span(c, tau, sepset_depth)
    return _level0.level0_span(c.contiguous(), tau, sepset_depth)


def gsq(jc: torch.Tensor, *, r: int, q: int) -> torch.Tensor:
    """G² (B,) float32 of cell-major joint codes jc (B, M) int32: the gsq
    kernel for a CUDA tensor, its plain version ``gsq_ref`` for a CPU one."""
    if jc.device.type == "cpu":
        return _gsq.gsq_ref(jc, r=r, q=q)
    return _gsq.gsq_cells(jc.contiguous(), r=r, q=q)


def level1_dense(c: torch.Tensor, adj: torch.Tensor, tau: float):
    """(removed (n, n) bool — a separator in adj(i) ∪ adj(j); kwin (n, n)
    int32 — least separating k ∈ adj(i) \\ {j}, else 2^30)."""
    return _level1.level1_dense_kernel(c.contiguous(), adj.contiguous(), tau)


def ci_shared(m2, ci_s, cj_s, cij, mask, tau: float, *, ell: int) -> torch.Tensor:
    """Batch-first: m2 (B,ℓ,ℓ), ci_s (B,ℓ), cj_s (B,P,ℓ), cij/mask (B,P)
    → independence ∧ mask (B, P) bool, through cholinv then cisweep."""
    if m2.shape[-1] != ell:
        raise ValueError(f"m2 is {m2.shape[-1]}×{m2.shape[-1]}, expected ℓ = {ell}")
    f32 = torch.float32
    g, u, var = _cholinv.cholinv(m2.to(f32).contiguous(), ci_s.to(f32).contiguous())
    return _cisweep.cisweep(g, u, var, cj_s.to(f32).contiguous(), cij.to(f32).contiguous(),
                            mask.contiguous(), tau)


def ci_shared_grid(m2, ci_s, cj_s, cij, mask, s_ids, tau: float, *, ell: int):
    """Grid-resident cuPC-S over one gathered launch (the sgrid kernel's
    gathered entry; the "S-grid" engine takes the fused one), batch-first: m2
    (n_l,T,ℓ,ℓ), ci_s (n_l,T,ℓ), cj_s (n_l,T,n′,ℓ), cij/mask (n_l,T,n′),
    s_ids (n_l,T,ℓ) → (t_loc (n_l, n′) int32, the least separating
    launch-local rank or ``sgrid.SENTINEL``; s_win (n_l, n′, ℓ) int32, its
    set). The same winners as ``levels._winners`` over the same chunk."""
    if m2.shape[-1] != ell:
        raise ValueError(f"m2 is {m2.shape[-1]}×{m2.shape[-1]}, expected ℓ = {ell}")
    return _sgrid.sgrid(m2, ci_s, cj_s, cij, mask, s_ids.to(torch.int32), tau)


def _grid_winners(t_loc, s_win, t0):
    """Launch-local winners → (t_win, removed_slot, s_win) in the rank dtype
    the commit reads: the launch base t0 is added back outside the kernel."""
    from repro_torch.core import levels as L

    found = t_loc < _sgrid.SENTINEL
    t_win = torch.where(found, t0 + t_loc.to(t0.dtype), L._imax(t0.dtype))
    return t_win, found, s_win


def chunk_s_grid_tests(c, adj, compact, counts, rows, t0, tau, *, ell, n_chunk, n_max,
                       c_t=None):
    """The tests half of the grid engine for a row block (a shard's rows,
    global ids ``rows``; ids ≥ n are pad rows with count 0): ranks
    [t0, t0 + n_chunk) in one fused sgrid launch over the whole C (and Cᵀ,
    ``c_t``, made per call when not given). Returns the ``chunk_s_tests``
    contract (t_win (n_l, n′), removed_slot (n_l, n′) bool, s_win
    (n_l, n′, ℓ)); the plain version on the CPU."""
    t_loc, s_win = _sgrid.sgrid_fused(c, adj, compact, counts, rows, t0, tau, ell=ell,
                                      n_chunk=n_chunk, n_max=n_max, c_t=c_t)
    return _grid_winners(t_loc, s_win, t0)


def chunk_s_grid_tests_cols(c_rows, c_cols, col_pos, adj, compact, counts, rows, t0, tau, *,
                            ell, n_chunk, n_max):
    """``chunk_s_grid_tests`` for the ROW-SHARDED C layout: the fused entry
    reads a whole C, which no shard holds, so the sets and values come from
    ``levels.gather_s_cols`` (the shard's rows of C and the gathered active
    columns) and go through sgrid's gathered entry (``ci_shared_grid``),
    the reference's own route. The same contract and winners."""
    from repro_torch.core import levels as L

    ranks = L._chunk_ranks(t0, n_chunk)
    m2, ci_s, cj_s, cij, mask, s_ids = L.gather_s_cols(c_rows, c_cols, col_pos, adj, compact,
                                                       counts, rows, ranks, ell=ell,
                                                       n_max=n_max)
    t_loc, s_win = ci_shared_grid(m2, ci_s, cj_s, cij, mask, s_ids, tau, ell=ell)
    return _grid_winners(t_loc, s_win, t0)


def _commit_winners(winners_fn, c, adj, sep, compact, counts, t0, tau, *, ell, n_chunk, n_max):
    """One chunk of every row through ``winners_fn`` (an sgrid or skernel
    entry: launch-local winners) and the engines' commit; returns the
    updated (adj, sep)."""
    from repro_torch.core import levels as L

    n = compact.shape[0]
    rows = torch.arange(n, dtype=torch.int32, device=c.device)
    t_loc, s_win = winners_fn(c, adj, compact, counts, rows, t0, tau, ell=ell, n_chunk=n_chunk,
                              n_max=n_max)
    t_win, removed_slot, s_win = _grid_winners(t_loc, s_win, t0)
    return L._global_commit(adj, sep, compact, rows, t_win, removed_slot, s_win, ell)


def chunk_s_grid(c, adj, sep, compact, counts, t0, tau, *, ell, n_chunk, n_max, c_t=None):
    """Same contract as ``levels.chunk_s``, with ranks [t0, t0 + n_chunk)
    in one fused sgrid launch, which unranks the sets and reads C itself
    (no gather), and its commit; returns the updated (adj, sep).
    ``engines.run_level`` hands over ``c_t`` (Cᵀ) made once a level; it
    is made per call when not given."""
    return _commit_winners(functools.partial(_sgrid.sgrid_fused, c_t=c_t), c, adj, sep, compact,
                           counts, t0, tau, ell=ell, n_chunk=n_chunk, n_max=n_max)


def chunk_s_kernel(c, adj, sep, compact, counts, t0, tau, *, ell, n_chunk, n_max,
                   jitter: float = _cholinv.JITTER):
    """Same contract as the reference ``chunk_s_kernel``: combo-ranks
    [t0, t0 + n_chunk) of every row, tested by cholinv's and cisweep's
    arithmetic and committed; returns the updated (adj, sep). On the card
    one fused skernel launch unranks, inverts, sweeps and keeps the
    winners (no ``gather_s``); on the CPU its plain version gathers and
    runs the plain cholinv and cisweep. ``jitter`` scales the Tikhonov
    term of the per-set inverse."""
    return _commit_winners(functools.partial(_skernel.skernel_fused, jitter=jitter), c, adj,
                           sep, compact, counts, t0, tau, ell=ell, n_chunk=n_chunk, n_max=n_max)


def chunk_s_two_launch(c, adj, sep, compact, counts, t0, tau, *, ell, n_chunk, n_max):
    """``chunk_s_kernel`` as the reference runs it: ``levels.gather_s``,
    the gathered cholinv and cisweep kernels (two launches a chunk) and
    ``levels._winners``; the same (adj, sep). A ``chunk_fn_s`` hook for
    comparing the fused kernel with the two kernels it replaces."""
    return _commit_winners(_skernel.skernel_two_launch, c, adj, sep, compact, counts, t0, tau,
                           ell=ell, n_chunk=n_chunk, n_max=n_max)
