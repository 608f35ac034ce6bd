"""Per-level PC-stable machinery: port of ``src/repro/core/levels.py``.

* ``level0`` / ``level0_g2``: the unconditional pass (paper Alg. 3), for
  the Gaussian and the discrete test.
* ``plan_sets`` / ``gather_s`` (``gather_sets`` for planned sets): unrank
  each chunk's conditioning sets and gather what the CI math reads, with
  the full validity mask; ``gather_s_cols`` / ``subset_cols`` do it from
  a shard's rows of C and the gathered active columns (the row-sharded C
  layout of ``core/distributed.py``).
* ``_inv_spd`` / ``ci_sweep`` / ``chunk_s``: the "S" engine, cuPC-S as
  PyTorch ops, the correctness anchor; ``chunk_s_tests`` /
  ``chunk_s_commit`` split it for the pipelined host loop.
* ``chunk_e``: the "E" engine, cuPC-E (one independent test per
  (row, slot, rank), no shared inverse).
* ``_winners`` / ``_global_commit`` / ``_commit``: the deterministic
  (rank, endpoint-order) winner per undirected edge, for shared and
  per-edge sets; ``commit_adj`` / ``commit_sep_rows`` split that commit
  for a row-sharded sepset tensor; ``commit_dense_l1`` replays the rule
  for the dense ℓ = 1 kernel's ``kwin``.
* ``plan_level`` / ``run_level``: the bucketed chunk plan and the host
  loop over rank chunks, with dispatch-ahead of depth ``pipeline_depth``
  on the plain "S" worklist.
* ``g2_worklist`` / ``chunk_g2``: a chunk of the discrete G² test, the
  cuPC-S worklist with contingency tables in place of partial
  correlations.

Ranks are int32 by default and int64 on request (``rank_dtype``); the
capacity guard refuses a level at ``imax // 2`` as the reference does.
Every integer reduction names its dtype: PyTorch would otherwise promote
sums of bool or int32 to int64 and silently accept levels the reference
refuses.

What the "S" and "E" engines rely on: float32 matrix products at full
precision, ``torch.backends.cuda.matmul.allow_tf32 = False`` (PyTorch's
default). TF32 keeps 10 mantissa bits and would move partial
correlations far past the decision band, so ``ci_sweep`` and ``chunk_e``
refuse CUDA inputs while it is on.
"""
from __future__ import annotations

import functools
import math
from collections import deque

import numpy as np
import torch
import torch.nn.functional as F

from ..device import imax as _imax
from ..kernels.cholinv import JITTER as DEFAULT_JITTER
from .cit import chi2_sf_f32, fisher_z
from .combinadics import binom_table
from .compact import compact_rows

#: Cells a single chunk may materialise (the (n·T, n′, ℓ) gather dominates):
#: 2^24 cells ≈ 64 MB of fp32, the reference's default.
DEFAULT_CELL_BUDGET = 2**24
_BIG = 2**30  # kwin's "no separator" value
#: Per-launch cell budget of the "S-grid" engine: a launch sweeps all its
#: ranks inside one kernel and never writes the (n·T, n′) decisions, so
#: the gather alone sets its memory, and 4× the chunked budget fits it.
GRID_CELL_BUDGET = 2**26
#: Bytes of joint codes ``level0_g2`` forms at once: it walks row blocks
#: of the (n, n, m) codes so that the peak stays near this size.
LEVEL0_JC_BYTES = 2**30


def _f32(x: float) -> float:
    """A Python float exactly representable in fp32, so that comparing it
    with an fp32 tensor means the same in any promotion."""
    return float(np.float32(x))


# --------------------------------------------------------------------- level 0
def level0(c: torch.Tensor, tau: float) -> torch.Tensor:
    """Adjacency after the unconditional tests: |atanh C_ij| > τ, i ≠ j."""
    n = c.shape[0]
    keep = fisher_z(c) > _f32(tau)
    return keep & ~torch.eye(n, dtype=torch.bool, device=c.device)


def max_degree(adj: torch.Tensor) -> torch.Tensor:
    """The largest row degree of adj (n, n) bool, a 0-d int32 tensor (0
    for n = 0)."""
    if adj.shape[0] == 0:
        return torch.zeros((), dtype=torch.int32, device=adj.device)
    return adj.sum(dim=1, dtype=torch.int32).max()


def level0_fill(adj: torch.Tensor, sepset_depth: int):
    """The rest of the level-0 span after the adjacency: (adj, sep (n, n,
    sepset_depth) int32 with slot 0 −1 for a kept edge and −2 for a
    removed one, the diagonal too, and −1 elsewhere, max_degree(adj))."""
    n = adj.shape[0]
    sep = torch.full((n, n, sepset_depth), -1, dtype=torch.int32, device=adj.device)
    sep[:, :, 0] = torch.where(adj, -1, -2).to(torch.int32)
    return adj, sep, max_degree(adj)


def level0_span(c: torch.Tensor, tau: float, sepset_depth: int):
    """The plain version of the fused level-0 kernel (kernels/level0.py::
    level0_span): ``level0`` and ``level0_fill``."""
    return level0_fill(level0(c, tau), sepset_depth)


def level0_g2(stats, alpha: float, *, r: int) -> torch.Tensor:
    """Unconditional discrete pass: keep edge (i, j) when the pairwise G²
    test rejects independence, chi2.sf(G², dof) < α, i ≠ j.

    stats: ``cit.DiscreteStats``; r: the run-wide max arity (the code
    stride; the dof uses the true arities). G² comes from ``ops.gsq``: the
    kernel on the card, its plain version on the CPU (the reference calls
    its plain ``gsq_ref`` here; the two are bitwise equal by contract).
    Row blocks of at most ``LEVEL0_JC_BYTES`` of joint codes go through it
    in turn; the result does not depend on the blocking."""
    from repro_torch.kernels.ops import gsq

    codes, arities = stats
    m, n = codes.shape
    codes_t = codes.T.contiguous()  # (n, m)
    g2 = torch.empty((n, n), dtype=torch.float32, device=codes.device)
    rows = max(1, LEVEL0_JC_BYTES // max(4 * n * m, 1))
    for i0 in range(0, n, rows):
        i1 = min(n, i0 + rows)
        jc = codes_t[i0:i1, None, :] * r + codes_t[None, :, :]  # (rows, n, m) int32
        g2[i0:i1] = gsq(jc.reshape(-1, m), r=r, q=1).reshape(i1 - i0, n)
        del jc
    dof = torch.clamp((arities[:, None] - 1) * (arities[None, :] - 1), min=1)
    keep = chi2_sf_f32(g2, dof) < _f32(alpha)
    return keep & ~torch.eye(n, dtype=torch.bool, device=codes.device)


# ------------------------------------------------------- combination unranking
@functools.lru_cache(maxsize=16)
def _jtable(n_max: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """Binomial table clipped to the rank dtype's capacity, on the device
    (read-only; cached per level shape)."""
    t = np.minimum(binom_table(n_max), _imax(dtype)).astype(np.int64)
    return torch.as_tensor(t, dtype=dtype, device=device)


def _unrank_dyn(t, n_dyn, n_max: int, ell: int, table):
    """t-th lexicographic ℓ-subset of {0..n_dyn-1} over candidates
    k = 0..n_max-1. t and n_dyn broadcast; returns (..., ℓ) int32 positions.
    Ranks t ≥ C(n_dyn, ℓ) give junk the callers mask.

    The reference walks the candidates (``unrank.cuh`` still does, in
    sgrid and skernel): at k, with c of ℓ taken, it takes k if the rank
    left is below C(n_dyn − k − 1, ℓ − c − 1), the sets that start so,
    and else subtracts that count. Here each slot is one round over every
    k at once: the first k after the previous pick whose running count
    (int64 sums of the clipped table, the walk's subtractions exactly)
    exceeds the rank left. ℓ rounds of a few ops, not n_max rounds, and
    the walk's result for every rank: a slot the walk never fills stays 0.
    At ℓ = 1 every candidate counts one set, so rank t takes position t
    while t < n_dyn and the walk leaves 0 otherwise."""
    dev = table.device
    if ell == 1:
        t = t.to(table.dtype)
        n_dyn = torch.as_tensor(n_dyn, dtype=torch.int32, device=dev)
        shape = torch.broadcast_shapes(t.shape, n_dyn.shape)
        first = torch.where((t < n_dyn) & (t < n_max), t, 0)
        return first.to(torch.int32).expand(shape)[..., None].clone()
    t = t.to(torch.int64)
    n_dyn = torch.as_tensor(n_dyn, dtype=torch.int64, device=dev)
    shape = torch.broadcast_shapes(t.shape, n_dyn.shape)
    rem = t.expand(shape)
    nd = n_dyn.expand(shape)[..., None]
    ks = torch.arange(n_max, dtype=torch.int64, device=dev)
    tail = torch.clamp(nd - ks - 1, 0, n_max)  # (..., n_max)
    flat = table.to(torch.int64).reshape(-1)
    width = table.shape[1]
    start = torch.zeros(shape + (1,), dtype=torch.int64, device=dev)
    alive = torch.ones(shape, dtype=torch.bool, device=dev)
    out = []
    for c in range(ell):
        cnt = flat[tail * width + (ell - c - 1)]
        cnt = torch.where((ks >= start) & (ks < nd), cnt, 0)
        cum = torch.cumsum(cnt, -1)
        hit = rem[..., None] < cum
        alive = alive & hit.any(-1)
        k = torch.argmax(hit.to(torch.uint8), -1, keepdim=True)  # the first hit
        below = torch.where(k > 0, torch.gather(cum, -1, (k - 1).clamp(min=0)), 0)
        out.append(torch.where(alive, k[..., 0], 0))
        rem = rem - below[..., 0]
        start = k + 1
    return torch.stack(out, -1).to(torch.int32)


# ------------------------------------------------------------- cuPC-S gathers
def plan_sets(compact, counts, ranks, *, ell: int, n_max: int, n: int):
    """Unrank one chunk's conditioning sets: (s_ids (n_l, T, ℓ) int32 clipped
    to [0, n-1], valid_set (n_l, T) bool)."""
    n_l, npr = compact.shape
    n_chunk = ranks.shape[0]
    table = _jtable(n_max, ranks.dtype, ranks.device)
    total = table[torch.clamp(counts, 0, n_max).long(), ell]  # C(n'_i, ℓ)
    valid_set = ranks[None, :] < total[:, None]
    pos = _unrank_dyn(ranks[None, :], counts[:, None], npr, ell, table)
    pos = torch.where(valid_set[..., None], pos, 0)
    s_ids = torch.gather(compact, 1, pos.reshape(n_l, -1).long()).reshape(n_l, n_chunk, ell)
    return torch.clamp(s_ids, 0, n - 1), valid_set


def _set_mask(adj, compact, rows, s_ids, valid_set, n):
    """Validity mask (n_l, T, n′): rank in range, j ∉ S, edge alive. Row
    ids ≥ n (a sharded block's pad rows, whose lists are all −1) read row
    n − 1, as the reference's clamped gather does, and stay masked."""
    j_ids = torch.clamp(compact, 0, n - 1)
    in_s = (j_ids[:, None, :, None] == s_ids[:, :, None, :]).any(dim=-1)
    alive = adj[rows.clamp(max=n - 1)[:, None].long(), j_ids.long()] & (compact >= 0)
    return valid_set[:, :, None] & ~in_s & alive[:, None, :]


def gather_s(c, adj, compact, counts, rows, ranks, *, ell: int, n_max: int):
    """The cuPC-S worklist prologue: returns (m2 (n_l,T,ℓ,ℓ), ci_s (n_l,T,ℓ),
    cj_s (n_l,T,n′,ℓ), cij (n_l,T,n′), mask (n_l,T,n′), s_ids (n_l,T,ℓ))."""
    s_ids, valid_set = plan_sets(compact, counts, ranks, ell=ell, n_max=n_max, n=c.shape[0])
    return (*gather_sets(c, adj, compact, rows, s_ids, valid_set), s_ids)


def gather_sets(c, adj, compact, rows, s_ids, valid_set):
    """``gather_s`` for sets already planned by ``plan_sets``: (m2, ci_s,
    cj_s, cij, mask). cij is an expanded view, stride 0 over T. Row ids
    ≥ n (pad rows of a sharded block) read row n − 1 and are masked."""
    n = c.shape[0]
    n_l, npr = compact.shape
    n_chunk = s_ids.shape[1]
    s = s_ids.long()
    r = rows.clamp(max=n - 1).long()
    j_ids = torch.clamp(compact, 0, n - 1).long()
    m2 = c[s[..., :, None], s[..., None, :]]
    ci_s = c[r[:, None, None], s]
    cj_s = c[j_ids[:, None, :, None], s[:, :, None, :]]
    cij = c[r[:, None], j_ids][:, None, :].expand(n_l, n_chunk, npr)
    mask = _set_mask(adj, compact, rows, s_ids, valid_set, n)
    return m2, ci_s, cj_s, cij, mask


def subset_cols(c_cols, positions):
    """Slice a gathered column block C[:, cols_old] down to a shrunk
    candidate set: ``positions`` (k_new,) are the new ids' places in
    cols_old (``col_pos_old[cols_new]``; the caller checked cols_new ⊆
    cols_old, which degree monotonicity guarantees). Returns exactly
    C[:, cols_new] with no gather across shards: C is constant for a run
    and the active set only shrinks, so a block gathered once stays a
    superset (``distributed.ColumnCache`` keeps it)."""
    return c_cols[:, positions.long()]


def gather_s_cols(c_rows, c_cols, col_pos, adj, compact, counts, rows, ranks, *, ell: int,
                  n_max: int):
    """``gather_s`` for the ROW-SHARDED C layout. In place of the whole C
    the caller gives c_rows (n_l, n), this shard's rows of C; c_cols
    (≥ n, k), the gathered active columns C[:, cols] (or a
    ``subset_cols`` of a cached block: the same values); col_pos (n,),
    each id's place in cols (arbitrary for ids outside cols, which only
    masked cells read). Every value the CI math reads has its row in the
    shard or its column in cols: C[S,S] and C[j,S] from c_cols, C[i,S]
    and C[i,j] from c_rows; the values equal the dense gather's, so the
    sweep's decisions are bitwise the dense layout's."""
    n = adj.shape[0]
    n_l, npr = compact.shape
    n_chunk = ranks.shape[0]
    s_ids, valid_set = plan_sets(compact, counts, ranks, ell=ell, n_max=n_max, n=n)
    s = s_ids.long()
    loc = torch.arange(n_l, device=compact.device)
    s_pos = col_pos[s].long()  # (n_l, T, ℓ) places in the k gathered columns
    j_ids = torch.clamp(compact, 0, n - 1).long()
    m2 = c_cols[s[..., :, None], s_pos[..., None, :]]
    ci_s = c_rows[loc[:, None, None], s]
    cj_s = c_cols[j_ids[:, None, :, None], s_pos[:, :, None, :]]
    cij = c_rows[loc[:, None], j_ids][:, None, :].expand(n_l, n_chunk, npr)
    mask = _set_mask(adj, compact, rows, s_ids, valid_set, n)
    return m2, ci_s, cj_s, cij, mask, s_ids


# ------------------------------------------------------------- the "S" engine
def _require_fp32_matmul(t: torch.Tensor) -> None:
    """The S and E engines' products must run in full float32 (see the
    module docstring)."""
    if t.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "the S and E engines need full-precision float32 matmuls: set "
            "torch.backends.cuda.matmul.allow_tf32 = False (PyTorch's default)")


def _inv_spd(m, jitter: float = DEFAULT_JITTER):
    """Batched SPD inverse (..., ℓ, ℓ) with Tikhonov jitter scaled by each
    block's mean |diagonal|: the closed-form adjugate at ℓ = 2, a batched
    LU inverse (``torch.linalg.inv_ex``, which like the reference's
    ``jnp.linalg.inv`` returns non-finite values for a singular block
    instead of raising) above it."""
    ell = m.shape[-1]
    eye = torch.eye(ell, dtype=m.dtype, device=m.device)
    diag = torch.abs(torch.diagonal(m, dim1=-2, dim2=-1))
    diag_scale = (_sum_in_order([diag[..., i] for i in range(ell)]) / ell if m.is_cuda
                  else torch.mean(diag, dim=-1))
    m = m + (jitter * diag_scale)[..., None, None] * eye
    if ell == 2:
        a, b = m[..., 0, 0], m[..., 0, 1]
        c, d = m[..., 1, 0], m[..., 1, 1]
        det = a * d - b * c
        adj2 = torch.stack([torch.stack([d, -b], dim=-1), torch.stack([-c, a], dim=-1)], dim=-2)
        return adj2 / det[..., None, None]
    return torch.linalg.inv_ex(m)[0]


def _set_inverse(m2, ell: int, jitter: float = DEFAULT_JITTER):
    """The per-set "inverse" of the S and E engines: 1/x at ℓ = 1."""
    if ell == 1:
        return 1.0 / torch.clamp(m2, min=1e-8)
    return _inv_spd(m2, jitter)


def _sum_in_order(terms):
    """terms[0] + terms[1] + … left to right, each sum rounded on its own."""
    acc = terms[0]
    for t in terms[1:]:
        acc = acc + t
    return acc


def _sweep_terms_in_order(g, ci_s, cj_s, cij, ell: int):
    """``ci_sweep``'s (num, var_i, var_j) with every contraction over ℓ
    summed in index order from products rounded on their own. On the card
    torch's batched products (cuBLAS) choose kernels, and with them fused
    multiply-adds and summation orders, by the batch's shape, so one test
    decided differently in chunks of another size (another budget, or a
    shard's rows); elementwise ops round the same at any shape."""
    ci = [ci_s[..., b] for b in range(ell)]
    cj = [cj_s[..., b] for b in range(ell)]
    u = [_sum_in_order([g[..., a, b] * ci[b] for b in range(ell)]) for a in range(ell)]
    var_i = 1.0 - _sum_in_order([ci[a] * u[a] for a in range(ell)])
    num = cij - _sum_in_order([cj[a] * u[a][..., None] for a in range(ell)])
    gw = [_sum_in_order([g[..., a, b][..., None] * cj[b] for b in range(ell)])
          for a in range(ell)]
    var_j = 1.0 - _sum_in_order([cj[a] * gw[a] for a in range(ell)])
    return num, var_i, var_j


def ci_sweep(m2, ci_s, cj_s, cij, mask, tau, *, ell: int, jitter: float = DEFAULT_JITTER):
    """The cuPC-S CI math on a gathered chunk: per-set inverse and shared
    vectors, then the neighbour sweep as einsums (the reference's; on the
    card in index order, ``_sweep_terms_in_order``, so that a test's
    decision does not depend on the chunk's shape). Returns independence ∧
    mask, (n_l, T, n′) bool. ``jitter`` scales the Tikhonov term of the
    ℓ ≥ 2 inverses (the reference's ``ci_sweep`` parameter)."""
    _require_fp32_matmul(m2)
    g = _set_inverse(m2, ell, jitter)
    if m2.is_cuda:
        num, var_i, var_j = _sweep_terms_in_order(g, ci_s, cj_s, cij, ell)
    else:
        u_i = torch.einsum("ntab,ntb->nta", g, ci_s)
        var_i = 1.0 - torch.einsum("nta,nta->nt", ci_s, u_i)
        num = cij - torch.einsum("ntpl,ntl->ntp", cj_s, u_i)
        gw = torch.einsum("ntab,ntpb->ntpa", g, cj_s)
        var_j = 1.0 - torch.einsum("ntpa,ntpa->ntp", cj_s, gw)
    rho = num / torch.sqrt(torch.clamp(var_i[..., None] * var_j, min=1e-20))
    return (fisher_z(rho) <= _f32(tau)) & mask


def _tests_s(c, adj, compact, counts, rows, ranks, tau, *, ell: int, n_max: int,
             jitter: float = DEFAULT_JITTER):
    """cuPC-S CI tests of the row block ``rows`` (global ids; the block's
    compact and counts): (sep_found (n_l, T, n′) bool, s_ids (n_l, T, ℓ))."""
    m2, ci_s, cj_s, cij, mask, s_ids = gather_s(c, adj, compact, counts, rows, ranks, ell=ell,
                                                n_max=n_max)
    return ci_sweep(m2, ci_s, cj_s, cij, mask, tau, ell=ell, jitter=jitter), s_ids


def _tests_s_cols(c_rows, c_cols, col_pos, adj, compact, counts, rows, ranks, tau, *, ell: int,
                  n_max: int):
    """``_tests_s`` reading the row-sharded C layout (``gather_s_cols``)."""
    m2, ci_s, cj_s, cij, mask, s_ids = gather_s_cols(c_rows, c_cols, col_pos, adj, compact,
                                                     counts, rows, ranks, ell=ell, n_max=n_max)
    return ci_sweep(m2, ci_s, cj_s, cij, mask, tau, ell=ell), s_ids


def _chunk_ranks(t0, n_chunk: int):
    return t0 + torch.arange(n_chunk, dtype=t0.dtype, device=t0.device)


def chunk_s(c, adj, sep, compact, counts, t0, tau, *, ell: int, n_chunk: int, n_max: int,
            jitter: float = DEFAULT_JITTER):
    """Combo-ranks [t0, t0 + n_chunk) of every row, cuPC-S style; returns
    the updated (adj, sep)."""
    winners = chunk_s_tests(c, adj, compact, counts, t0, tau, ell=ell, n_chunk=n_chunk,
                            n_max=n_max, jitter=jitter)
    return chunk_s_commit(adj, sep, compact, *winners, ell=ell)


def chunk_s_tests(c, adj, compact, counts, t0, tau, *, ell: int, n_chunk: int, n_max: int,
                  jitter: float = DEFAULT_JITTER):
    """The tests half of ``chunk_s``: (t_win, removed_slot, s_win) of ranks
    [t0, t0 + n_chunk), not committed. ``adj`` only masks which cells may
    claim a removal, so a snapshot that lags the commits adds claims on
    removed edges alone, which ``chunk_s_commit`` discards: the tests may
    run ahead of the commits at any depth with equal results."""
    rows = torch.arange(compact.shape[0], dtype=torch.int32, device=adj.device)
    ranks = _chunk_ranks(t0, n_chunk)
    sep_found, s_ids = _tests_s(c, adj, compact, counts, rows, ranks, tau, ell=ell, n_max=n_max,
                                jitter=jitter)
    return _winners(sep_found, ranks, s_ids)


def chunk_s_commit(adj, sep, compact, t_win, removed_slot, s_win, *, ell: int):
    """The commit half of ``chunk_s``; chunks commit in ascending rank order."""
    rows = torch.arange(adj.shape[0], dtype=torch.int32, device=adj.device)
    return _global_commit(adj, sep, compact, rows, t_win, removed_slot, s_win, ell)


# ------------------------------------------------------------- the "E" engine
def chunk_e(c, adj, sep, compact, counts, t0, tau, *, ell: int, n_chunk: int, n_max: int):
    """Combo-ranks [t0, t0 + n_chunk) of every (row, neighbour slot p), each
    cell an independent CI test over the sets of the row without p (the
    paper's cuPC-E, no shared inverse). Returns the updated (adj, sep)."""
    _require_fp32_matmul(c)
    n, npr = compact.shape
    dev = adj.device
    table = _jtable(n_max, t0.dtype, dev)
    rows = torch.arange(n, dtype=torch.int32, device=dev)
    ranks = _chunk_ranks(t0, n_chunk)
    totals = table[torch.clamp(counts - 1, 0, n_max).long(), ell]  # C(n'_i - 1, ℓ)
    valid_rank = ranks[None, None, :] < totals[:, None, None]  # (n, 1, T)

    # sets exclude the target slot p: unrank from C(n'_i - 1, ℓ), shift ≥ p
    p_slots = torch.arange(npr, dtype=torch.int32, device=dev)
    pos = _unrank_dyn(ranks[None, None, :], (counts - 1)[:, None, None], npr, ell, table)
    pos = pos.expand(n, npr, n_chunk, ell)
    pos = pos + (pos >= p_slots[None, :, None, None]).to(pos.dtype)
    pos = torch.clamp(pos, 0, npr - 1)
    s = torch.clamp(compact[rows.long()[:, None, None, None], pos.long()], 0, n - 1).long()

    r = rows.long()
    j_ids = torch.clamp(compact, 0, n - 1).long()
    g = _set_inverse(c[s[..., :, None], s[..., None, :]], ell)  # (n, n′, T, ℓ, ℓ)
    ci_s = c[r[:, None, None, None], s]
    cj_s = c[j_ids[:, :, None, None], s]
    u_i = torch.einsum("nptab,nptb->npta", g, ci_s)
    var_i = 1.0 - torch.einsum("npta,npta->npt", ci_s, u_i)
    gw = torch.einsum("nptab,nptb->npta", g, cj_s)
    var_j = 1.0 - torch.einsum("npta,npta->npt", cj_s, gw)
    num = c[r[:, None], j_ids][:, :, None] - torch.einsum("npta,npta->npt", cj_s, u_i)
    rho = num / torch.sqrt(torch.clamp(var_i * var_j, min=1e-20))
    indep = fisher_z(rho) <= _f32(tau)  # (n, n′, T)

    alive = adj[r[:, None], j_ids] & (compact >= 0)
    p_valid = p_slots[None, :] < counts[:, None]
    mask = valid_rank & alive[:, :, None] & p_valid[:, :, None]
    sep_found = (indep & mask).transpose(1, 2)  # (n, T, n′), the commit's layout
    s_per_edge = s.to(torch.int32).transpose(1, 2)  # (n, T, n′, ℓ)
    return _commit(adj, sep, compact, sep_found, ranks, None, ell, s_ids_per_edge=s_per_edge)


# ---------------------------------------------------------------------- commit
def _winners(sep_found, ranks, s_ids_shared, s_ids_per_edge=None):
    """Per-(row, slot) least separating rank of the chunk: (t_win (n_l, n′),
    removed_slot (n_l, n′) bool, s_win (n_l, n′, ℓ)). The sets come shared
    per rank, s_ids_shared (n_l, T, ℓ), or per edge, s_ids_per_edge
    (n_l, T, n′, ℓ) with s_ids_shared None."""
    n_l, _, npr = sep_found.shape
    big = _imax(ranks.dtype)
    rank_mat = torch.where(sep_found, ranks[None, :, None], big)
    t_win, t_arg = torch.min(rank_mat, dim=1)
    removed_slot = t_win < big
    loc = torch.arange(n_l, device=ranks.device)
    if s_ids_shared is not None:
        return t_win, removed_slot, s_ids_shared[loc[:, None], t_arg]
    slots = torch.arange(npr, device=ranks.device)
    return t_win, removed_slot, s_ids_per_edge[loc[:, None], t_arg, slots[None, :]]


def _commit_key_mat(compact_full, rows_full, t_win, removed_slot, n):
    """Scatter per-(row, slot) winner keys rank·2 + endpoint-order into the
    dense (n, n) key matrix (imax elsewhere), by a min-reduction."""
    rd = t_win.dtype
    big = _imax(rd)
    j_ids = torch.clamp(compact_full, 0, n - 1)
    order_bit = (rows_full[:, None] > j_ids).to(rd)
    key = torch.where(removed_slot, t_win * 2 + order_bit, big)
    idx = (rows_full[:, None].long() * n + j_ids.long()).reshape(-1)
    key_mat = torch.full((n * n,), big, dtype=rd, device=t_win.device)
    key_mat = key_mat.scatter_reduce(0, idx, key.reshape(-1), reduce="amin")
    return j_ids, key_mat.reshape(n, n)


def _global_commit(adj, sep, compact_full, rows_full, t_win, removed_slot, s_win, ell):
    """Apply a chunk's removals and sepsets to the global (adj, sep). Only
    winner slots scatter sepsets; losers write the dump column n, the one
    place duplicate writes may land."""
    n = adj.shape[0]
    big = _imax(t_win.dtype)
    j_ids, key_mat = _commit_key_mat(compact_full, rows_full, t_win, removed_slot, n)
    j_write = torch.where(removed_slot, j_ids, n)
    s_mat = torch.zeros((n, n + 1, ell), dtype=torch.int32, device=adj.device)
    s_mat[rows_full[:, None].long(), j_write.long()] = s_win.to(torch.int32)
    s_mat = s_mat[:, :n]
    key_t = key_mat.T
    newly_removed = torch.minimum(key_mat, key_t) < big
    use_own = key_mat <= key_t
    s_final = torch.where(use_own[..., None], s_mat, s_mat.transpose(0, 1))
    adj_new = adj & ~newly_removed
    lmax = sep.shape[-1]
    write = (newly_removed & adj)[..., None]
    slot_ok = torch.arange(lmax, device=adj.device) < ell
    padded = F.pad(s_final, (0, lmax - ell), value=-1)
    return adj_new, torch.where(write & slot_ok, padded, sep)


def commit_adj(adj, key_mat):
    """The replicated half of the commit: symmetric edge removal from the
    dense winner-key matrix (it sees both endpoints' claims, so it stays
    replicated when the sepset tensor is row-sharded)."""
    return adj & ~(torch.minimum(key_mat, key_mat.T) < _imax(key_mat.dtype))


def commit_sep_rows(sep_rows, row_ids, adj, key_mat, compact_full, removed_slot, s_win, ell):
    """Shard-local sepset commit: this shard's block of the (n, n, Lmax)
    sepset tensor from the full-width winners, ``_global_commit``'s writes
    restricted to its rows. A local row i takes its own winner slots
    (scattered by target j) and every row g's winner slot that targets i
    (the transposed claim); the tie-break ``key_own <= key_oth`` is
    ``_global_commit``'s ``use_own``, so both layouts commit equal sepsets.

    sep_rows (n_l, n, Lmax); row_ids (n_l,) global ids, contiguous (ids
    ≥ n are pad rows, whose writes are masked); adj (n, n) the pre-commit
    adjacency; key_mat (n, n) from ``_commit_key_mat``; compact_full,
    removed_slot (n, n′) and s_win (n, n′, ℓ) the gathered winners.
    Returns the updated (n_l, n, Lmax) block."""
    n = adj.shape[0]
    n_l = sep_rows.shape[0]
    dev = sep_rows.device
    big = _imax(key_mat.dtype)
    rid = row_ids.clamp(0, n - 1).long()
    valid_row = row_ids < n
    key_own = key_mat[rid]  # (n_l, n): the local rows' claims
    key_oth = key_mat.T[rid]  # (n_l, n): the other endpoints' claims
    use_own = key_own <= key_oth
    newly_removed = torch.minimum(key_own, key_oth) < big

    # own claims by target column; losers write the dump column n
    loc = torch.arange(n_l, device=dev)
    j_write = torch.where(removed_slot[rid], torch.clamp(compact_full[rid], 0, n - 1), n)
    s_own = torch.zeros((n_l, n + 1, ell), dtype=torch.int32, device=dev)
    s_own[loc[:, None], j_write.long()] = s_win[rid].to(torch.int32)
    s_own = s_own[:, :n]

    # transposed claims: row g's winner slot targets compact_full[g, p];
    # those landing in this shard scatter to (target − first row, g), the
    # rest to the dump row n_l
    t_loc = torch.clamp(compact_full, 0, n - 1) - row_ids[0]
    in_shard = removed_slot & (t_loc >= 0) & (t_loc < n_l)
    t_loc = torch.where(in_shard, t_loc, n_l).long()
    g = torch.arange(compact_full.shape[0], device=dev)[:, None].expand_as(t_loc)
    s_oth = torch.zeros((n_l + 1, n, ell), dtype=torch.int32, device=dev)
    s_oth[t_loc, g] = s_win.to(torch.int32)
    s_oth = s_oth[:n_l]

    s_final = torch.where(use_own[..., None], s_own, s_oth)
    write = (newly_removed & adj[rid] & valid_row[:, None])[..., None]
    lmax = sep_rows.shape[-1]
    slot_ok = torch.arange(lmax, device=dev) < ell
    return torch.where(write & slot_ok, F.pad(s_final, (0, lmax - ell), value=-1), sep_rows)


def _commit(adj, sep, compact, sep_found, ranks, s_ids_shared, ell, s_ids_per_edge=None):
    """sep_found (n, T, n′) of a chunk over every row → updated (adj, sep);
    the sets as in ``_winners``."""
    n = adj.shape[0]
    rows = torch.arange(n, dtype=torch.int32, device=adj.device)
    t_win, removed_slot, s_win = _winners(sep_found, ranks, s_ids_shared, s_ids_per_edge)
    return _global_commit(adj, sep, compact, rows, t_win, removed_slot, s_win, ell)


def commit_dense_l1(adj, sep, kwin, rank_dtype: torch.dtype = torch.int32):
    """Commit the dense ℓ = 1 kernel's kwin: the rank of kwin[i, j] inside
    row i's sorted neighbour list is the combo-rank the chunked engine
    would find, so the same (rank·2 + endpoint-order) rule per undirected
    edge gives the chunked engine's sepsets."""
    n = adj.shape[0]
    rd = rank_dtype
    big = _imax(rd)
    adji = adj.to(rd)
    prefix = torch.cumsum(adji, dim=1, dtype=rd) - adji  # exclusive rank of k in row
    kwin_c = torch.clamp(kwin, 0, n - 1).to(torch.int32)
    rank = torch.gather(prefix, 1, kwin_c.long())
    rows = torch.arange(n, dtype=torch.int32, device=adj.device)
    order_bit = (rows[:, None] > rows[None, :]).to(rd)
    own = (kwin < _BIG) & adj
    key = torch.where(own, rank * 2 + order_bit, big)
    newly_removed = (torch.minimum(key, key.T) < big) & adj
    use_own = key <= key.T
    s_win = torch.where(use_own, kwin_c, kwin_c.T)
    sep_new = sep.clone()
    sep_new[:, :, 0] = torch.where(newly_removed, s_win, sep[:, :, 0])
    return adj & ~newly_removed, sep_new


# ------------------------------------------------------------ discrete chunk
def g2_worklist(stats, adj, compact, counts, ranks, *, ell: int, n_max: int, r: int,
                sets=None):
    """The G² worklist of combo-ranks ``ranks`` of every row: (jc (n·T·n′,
    m) int32 cell-major joint codes, dof (n, T, n′) float32, mask (n, T, n′),
    s_ids (n, T, ℓ)). The set plan and validity mask are the Gaussian
    engines' (``plan_sets``, ``_set_mask``), so a (row, rank, slot) cell
    names the same test in every engine. ``sets`` takes ``plan_sets``'s
    (s_ids, valid_set) of these ranks when a caller unranked them already."""
    codes, arities = stats
    n = adj.shape[0]
    mm = codes.shape[0]
    n_chunk = ranks.shape[0]
    rows = torch.arange(n, dtype=torch.int32, device=adj.device)
    s_ids, valid_set = sets if sets is not None else plan_sets(compact, counts, ranks, ell=ell,
                                                               n_max=n_max, n=n)
    mask = _set_mask(adj, compact, rows, s_ids, valid_set, n)
    j_ids = torch.clamp(compact, 0, n - 1).long()
    codes_t = codes.T.contiguous()  # (n, m)
    cfg = torch.zeros((n, n_chunk, mm), dtype=torch.int32, device=adj.device)
    for k in range(ell):  # MSB-first fold of the conditioning codes
        cfg = cfg * r + codes_t[s_ids[..., k].long()]
    # jc = cfg·r² + x_i·r + x_j, the layout the G² fold unpacks
    jc = (cfg[:, :, None, :] * r + codes_t[:, None, None, :]) * r + codes_t[j_ids][:, None, :, :]
    del cfg
    f32 = torch.float32
    dof_cfg = (torch.prod(arities[s_ids.long()].to(f32), dim=-1) if ell
               else torch.ones((n, n_chunk), dtype=f32, device=adj.device))
    dof = ((arities - 1).to(f32)[:, None, None] * (arities[j_ids] - 1).to(f32)[:, None, :]
           * dof_cfg[:, :, None])
    return jc.reshape(-1, mm), torch.clamp(dof, min=1.0), mask, s_ids


def chunk_g2(stats, adj, sep, compact, counts, t0, alpha, *, ell: int, n_chunk: int,
             n_max: int, r: int, gsq_fn, sets=None):
    """Combo-ranks [t0, t0 + n_chunk) of every row under the discrete G²
    test, with ``run_level``'s chunk contract (``cit.DiscreteStats`` in the
    C slot, α in the τ slot): G² per cell through ``gsq_fn`` (cell-major
    codes → (B,) float32), independence where chi2.sf(G², dof) ≥ α, then
    the engines' (rank, endpoint-order) commit. Returns (adj, sep).
    ``sets``: the chunk's unranked sets, as ``g2_worklist`` takes them."""
    ranks = _chunk_ranks(t0, n_chunk)
    jc, dof, mask, s_ids = g2_worklist(stats, adj, compact, counts, ranks, ell=ell,
                                       n_max=n_max, r=r, sets=sets)
    g2 = gsq_fn(jc, r=r, q=r**ell).reshape(dof.shape)
    del jc
    indep = chi2_sf_f32(g2, dof) >= _f32(alpha)  # the boundary counts as independent
    return _commit(adj, sep, compact, indep & mask, ranks, s_ids, ell)


# -------------------------------------------------------------- chunk planning
def _check_rank_capacity(total: int, n_chunk: int, ell: int, rank_dtype: torch.dtype):
    """Refuse a level whose ranks the dtype cannot carry: commit keys are
    rank·2 + bit against the imax sentinel, so the capacity is imax // 2.
    Returns n_chunk, halved until every rank a chunk touches fits."""
    big = _imax(rank_dtype)
    if total > big // 2:
        name = str(rank_dtype).removeprefix("torch.")
        raise ValueError(
            f"level with {total} conditioning sets (ell={ell}) exceeds the "
            f"rank capacity of {name}: the commit-key capacity is {big // 2} "
            f"(keys are rank*2+bit vs the {big} sentinel); pass "
            "wide_ranks=True for int64 ranks, or cap max_level"
        )
    while n_chunk > 1 and total + n_chunk > big:
        n_chunk //= 2
    return n_chunk


def _pow2_ceil(x: int) -> int:
    return 1 if x <= 1 else 1 << (x - 1).bit_length()


def _pow2_floor(x: int) -> int:
    return 1 if x <= 1 else 1 << (x.bit_length() - 1)


def bucket_npr(npr: int, lane: int = 128) -> int:
    """n′ rounded up to a power of two below ``lane``, to lane multiples
    above, so level shapes recur across levels and runs."""
    if npr <= 1:
        return npr
    return _pow2_ceil(npr) if npr < lane else -(-npr // lane) * lane


def plan_level(npr: int, ell: int, n_rows: int, engine: str = "S",
               cell_budget: int = DEFAULT_CELL_BUDGET, bucket: bool = True,
               n_cols: int | None = None, rank_dtype: torch.dtype = torch.int32):
    """One level's shapes: (npr_bucket, n_chunk, total_ranks). With
    ``bucket`` n′ is bucketed and the chunk is a power of two; either way
    the chunk is sized so the dominant gather stays within ``cell_budget``:
    (n·T, n′, ℓ) for "S", n′ times that for "E", whose C(n′ − 1, ℓ) ranks
    each test every slot with its own set."""
    npr_b = bucket_npr(npr) if bucket else npr
    if n_cols is not None:
        npr_b = min(npr_b, n_cols)
    per_rank_cells = n_rows * npr_b * max(ell, 1) * max(ell, 1)
    if engine.upper() == "S":
        total = math.comb(npr, ell)
    else:
        total = math.comb(max(npr - 1, 0), ell)
        per_rank_cells *= npr_b
    budget_chunk = max(1, cell_budget // max(per_rank_cells, 1))
    if bucket:
        n_chunk = min(_pow2_ceil(total), _pow2_floor(budget_chunk))
    else:
        n_chunk = max(1, min(total, budget_chunk))
    return npr_b, _check_rank_capacity(total, n_chunk, ell, rank_dtype), total


# ------------------------------------------------------------ host level loop
def run_level(c, adj, sep, ell: int, tau: float, engine: str = "S",
              cell_budget: int = DEFAULT_CELL_BUDGET, chunk_fn_s=None, chunk_fn_e=None,
              bucket: bool = True, pipeline_depth: int = 1,
              rank_dtype: torch.dtype = torch.int32):
    """Run one PC-stable level as a host loop over rank chunks. ``engine``
    "S" or "E" picks the worklist shape and its plain chunk function
    (``chunk_s`` / ``chunk_e``); ``chunk_fn_s`` / ``chunk_fn_e`` replace
    them, each ``fn(c, adj, sep, compact, counts, t0, tau, *, ell,
    n_chunk, n_max)`` → (adj, sep). Edges removed by a chunk drop out of
    later chunks through the alive mask.

    ``pipeline_depth`` ≥ 2 splits each plain "S" chunk into
    ``chunk_s_tests`` and ``chunk_s_commit`` and keeps up to that many
    chunks' tests queued before the oldest commit: equal results at any
    depth (see ``chunk_s_tests``); other chunk functions run depth 1.
    Returns (adj, sep, stats); stats["dispatches"] counts the chunk
    programs issued, two per pipelined chunk."""
    n = adj.shape[0]
    npr = int(adj.sum(dim=1, dtype=torch.int32).max()) if n else 0
    if npr - 1 < ell:
        return adj, sep, {"skipped": True, "chunks": 0, "dispatches": 0,
                          "npr": npr, "engine": engine}
    npr_b, n_chunk, total = plan_level(npr, ell, n, engine=engine, cell_budget=cell_budget,
                                       bucket=bucket, n_cols=n, rank_dtype=rank_dtype)
    compact, counts = compact_rows(adj, n_prime=npr_b)
    depth = max(1, pipeline_depth)
    is_s = engine.upper() == "S"
    pipelined = depth > 1 and is_s and chunk_fn_s is None
    kw = dict(ell=ell, n_chunk=n_chunk, n_max=npr_b)

    def t0s():
        # every chunk's first rank made on the device at once: a host scalar
        # copied a chunk is a blocking copy, which drains the stream a chunk
        firsts = torch.arange(0, total, n_chunk, dtype=rank_dtype, device=adj.device)
        for k in range(firsts.shape[0]):
            yield firsts[k]

    chunks = 0
    if pipelined:
        pending: deque = deque()
        for t0 in t0s():
            pending.append(chunk_s_tests(c, adj, compact, counts, t0, tau, **kw))
            chunks += 1
            if len(pending) >= depth:
                adj, sep = chunk_s_commit(adj, sep, compact, *pending.popleft(), ell=ell)
        while pending:
            adj, sep = chunk_s_commit(adj, sep, compact, *pending.popleft(), ell=ell)
    else:
        fn = (chunk_fn_s or chunk_s) if is_s else (chunk_fn_e or chunk_e)
        for t0 in t0s():
            adj, sep = fn(c, adj, sep, compact, counts, t0, tau, **kw)
            chunks += 1
    return adj, sep, {
        "skipped": False, "chunks": chunks, "npr": npr, "npr_bucket": npr_b,
        "n_chunk": n_chunk, "total_sets": total, "engine": engine,
        "compile_key": (ell, n_chunk, npr_b), "pipeline_depth": depth if pipelined else 1,
        "dispatches": chunks * (2 if pipelined else 1),
    }
