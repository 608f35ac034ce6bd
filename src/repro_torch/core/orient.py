"""Skeleton → CPDAG: v-structures, then the Meek rules to a fixpoint (port
of ``src/repro/core/orient.py``).

Representation: directed adjacency D (n, n) bool; an undirected edge has
D[i,j] = D[j,i] = True, a directed edge i→j only D[i,j].

The reference forms (n, n, n, Lmax) compares and a 5-operand O(n⁴)
einsum, which do not fit at n ≈ 1200. The port computes the same sets as
counts: 0/1 fp32 matrix products (counts up to n are exact in fp32), a
scatter of the recorded sepset members, and Meek R3 blocked over the
vertex a, contracting over a's undirected neighbours only, so no tensor
of size n⁴ (or n³ in the default path) is ever formed.
"""
from __future__ import annotations

import torch

#: rows of `a` per block in Meek R3 (bounds the (block, K, n) gather)
R3_CELL_BUDGET = 2**26


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Count matrix of two 0/1 bool matrices, exact in fp32."""
    return a.to(torch.float32) @ b.to(torch.float32)


def _eye(n, device):
    return torch.eye(n, dtype=torch.bool, device=device)


def sepset_membership(sep: torch.Tensor) -> torch.Tensor:
    """sep (n, n, Lmax) int32 id lists → (n, n, n) bool, [i,j,k] = k ∈
    SepSet(i,j). Sentinels (-1 / -2) are not members. Built by a scatter of
    the recorded ids, not by an (n, n, n, Lmax) compare."""
    n = sep.shape[0]
    out = torch.zeros((n, n, n), dtype=torch.bool, device=sep.device)
    i, j, slot = torch.nonzero(sep >= 0, as_tuple=True)
    out[i, j, sep[i, j, slot].long()] = True
    return out


def _separated_counts(adj: torch.Tensor, sep: torch.Tensor) -> torch.Tensor:
    """excl[i, k] = #{j : i, j distinct non-adjacent, adj[j, k], k ∈ SepSet(i, j)}."""
    n = adj.shape[0]
    nonadj = ~adj & ~_eye(n, adj.device)
    i, j, slot = torch.nonzero(sep >= 0, as_tuple=True)
    k = sep[i, j, slot].long()
    keep = nonadj[i, j] & adj[j, k]
    # one count per distinct (i, j, k): membership is a set
    triple = torch.unique((i[keep] * n + j[keep]) * n + k[keep])
    ik = (triple // (n * n)) * n + triple % n
    excl = torch.zeros(n * n, dtype=torch.float32, device=adj.device)
    excl.index_add_(0, ik, torch.ones_like(ik, dtype=torch.float32))
    return excl.reshape(n, n)


def _orient_into(adj: torch.Tensor, into_k: torch.Tensor) -> torch.Tensor:
    """Apply v-structure arrows: into_k[i, k] means some j completes
    i→k←j. Conflicting demands leave the edge undirected."""
    drop = into_k.T & adj
    both = into_k & into_k.T
    d = adj & ~(drop & ~both.T)
    return torch.where(both | both.T, adj, d)


def orient_v_structures(adj: torch.Tensor, sep: torch.Tensor) -> torch.Tensor:
    """For every unshielded triple i—k—j (i, j non-adjacent) with
    k ∉ SepSet(i, j): orient i→k←j."""
    adj = adj.to(torch.bool)
    n = adj.shape[0]
    nonadj = ~adj & ~_eye(n, adj.device)
    open_paths = _mm(nonadj, adj) - _separated_counts(adj, sep)
    return _orient_into(adj, adj & (open_paths > 0))


def orient_v_structures_membership(adj: torch.Tensor, in_sep: torch.Tensor,
                                   block: int = 64) -> torch.Tensor:
    """v-structures from a membership tensor in_sep (n, n, n), [i,j,k] =
    k ∈ SepSet(i, j); reduced over j in blocks of i."""
    adj = adj.to(torch.bool)
    n = adj.shape[0]
    nonadj = ~adj & ~_eye(n, adj.device)
    into = torch.zeros((n, n), dtype=torch.bool, device=adj.device)
    for i0 in range(0, n, block):
        i1 = min(n, i0 + block)
        trip = nonadj[i0:i1, :, None] & adj[None, :, :] & ~in_sep[i0:i1]
        into[i0:i1] = trip.any(dim=1)
    return _orient_into(adj, adj & into)


def _meek_r3(und: torch.Tensor, dir_: torch.Tensor, nonadj: torch.Tensor) -> torch.Tensor:
    """R3 count > 0: a—c, a—d, c→b, d→b, c, d non-adjacent. For each a the
    sum runs over a's undirected neighbours only: with N = und-neighbours
    of a, count[a, b] = Σ_{c,d ∈ N} dir[c,b]·nonadj[c,d]·dir[d,b]."""
    n = und.shape[0]
    deg = und.sum(dim=1, dtype=torch.int32)
    width = int(deg.max()) if n else 0
    hit = torch.zeros((n, n), dtype=torch.bool, device=und.device)
    if width < 2:
        return hit
    key = torch.where(und, torch.arange(n, device=und.device), n)
    nb = torch.sort(key, dim=1).values[:, :width]  # (n, K) neighbour ids, n = pad
    valid = nb < n
    nb_c = torch.clamp(nb, max=n - 1)
    dir_f = dir_.to(torch.float32)
    nonadj_f = nonadj.to(torch.float32)
    block = max(1, R3_CELL_BUDGET // max(width * n, 1))
    for a0 in range(0, n, block):
        a1 = min(n, a0 + block)
        ids, ok = nb_c[a0:a1], valid[a0:a1].to(torch.float32)
        d_blk = dir_f[ids] * ok[:, :, None]  # (b, K, n): dir[c, b] for c ∈ N(a)
        m_blk = nonadj_f[ids[:, :, None], ids[:, None, :]] * ok[:, :, None] * ok[:, None, :]
        count = (torch.bmm(m_blk, d_blk) * d_blk).sum(dim=1)  # (b, n)
        hit[a0:a1] = count > 0
    return hit


def _meek_step(d: torch.Tensor) -> torch.Tensor:
    """One parallel sweep of Meek rules R1–R4; returns the updated digraph."""
    n = d.shape[0]
    und = d & d.T
    dir_ = d & ~d.T
    adj_any = d | d.T
    nonadj = ~adj_any & ~_eye(n, d.device)
    r1 = (_mm(dir_.T, nonadj) > 0) & und  # a→b, b—c, a,c non-adjacent ⇒ b→c
    r2 = (_mm(dir_, dir_) > 0) & und  # a→b→c, a—c ⇒ a→c
    r3 = _meek_r3(und, dir_, nonadj) & und
    two_step = (_mm(und, dir_) > 0) & adj_any  # a—d→c with a adj c
    r4 = (_mm(two_step, dir_) > 0) & und
    orient = r1 | r2 | r3 | r4
    orient = orient & ~(orient & orient.T)
    return d & ~orient.T


def meek_rules(d: torch.Tensor, max_iter: int | None = None) -> torch.Tensor:
    """Meek sweeps to a fixpoint (at most n² sweeps; usually a handful)."""
    n = d.shape[0]
    iters = max_iter or (n * n)
    prev, cur, i = d, _meek_step(d), 1
    while i < iters and not torch.equal(prev, cur):
        prev, cur, i = cur, _meek_step(cur), i + 1
    return cur


def cpdag_from_skeleton(adj: torch.Tensor, sep: torch.Tensor) -> torch.Tensor:
    """v-structures, then the Meek closure → the CPDAG digraph."""
    return meek_rules(orient_v_structures(adj, sep))


def cpdag_from_membership(adj: torch.Tensor, in_sep: torch.Tensor) -> torch.Tensor:
    """The CPDAG from a membership tensor in_sep (n, n, n) in place of
    sepset id lists: the bootstrap ensemble's aggregated skeleton and voted
    sepsets."""
    return meek_rules(orient_v_structures_membership(adj, in_sep))
