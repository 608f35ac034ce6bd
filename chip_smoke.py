#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one CUDA card and check them.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. build: compile ``src/repro_torch/csrc/*.cu`` with nvcc for sm_90a;
2. Gaussian kernels: each hand kernel against its plain PyTorch version
   on the card, at the shapes the Gaussian main path gives it on the
   paper's NCI-60 workload (n = 1190 variables, m = 47 samples, density
   0.02, α = 0.01; seeded Gaussian-DAG stand-in data): corr (plus the
   §5.6 shape m = 10000, n = 1000 and a ragged m = 1003, n = 517; each
   bitwise symmetric and bitwise equal across two calls, and timed in
   turns with ``torch.matmul``, also inside a CUDA graph), level0 on C
   (exact), level1 on the
   level-0 adjacency, cholinv and cisweep on the first ℓ = 2 chunk, sgrid
   on the first level-1 launch of "S-grid" and on seeded SPD launches at
   ℓ = 3 and ℓ = 8. Decisions (sgrid: winners) may differ only in cells
   whose decision moves within τ ± 1e-4 (found by re-running the plain
   version at τ ± 1e-4); cholinv must agree to rtol 1e-5, atol 1e-6; corr
   to atol 2e-6;
3. Gaussian end to end: ``pc(x)`` on NCI-60 with the launch counts reset
   just before and read just after (every kernel of the path must have
   launched), a float64 certificate of every recorded sepset, and
   equality with the port's own CPU run on an n = 200 instance fed the
   same C, under "auto" and under "S-grid". A test whose float64
   statistic lies past τ by less than the forward-error bound of its fp32
   evaluation (see ``z_of``) is not decidable in fp32, the reference's
   arithmetic as much as the port's; the certificate counts such tests
   and does not fail them. Then ``pc(x, engine=e)`` for "S", "E",
   "S-grid" and "S" at ``pipeline_depth=3``, each with its own counts
   (S-grid: one sgrid launch per planned launch and no chunked kernel;
   S and E: no kernel but corr and level0), compared with "auto" (every
   differing edge explained by the band or the fp32 bound; for "E" the
   skeleton only, as its sets rank differently) and certified;
   the paper's §5.6 instance (n = 1000, m = 10 000, density 0.1, α = 0.01,
   seed 0): sgrid on its first ℓ = 2 launch, then "auto" and "S-grid"
   with per-level chunks and spans, "S-grid" against "auto" and
   certified;
4. discrete kernel: gsq against its plain version, bitwise, at the level-0
   shape of a bnlearn-PIGS-shaped stand-in (n = 441 ternary variables,
   m = 5000 samples, density 0.0061 ≈ 592 arcs, α = 0.01, seeded
   Dirichlet-CPT DAG data) and on the first chunk of every level ℓ = 1…5
   (K = 27 … 2187), each level's adjacency from running the one before;
5. discrete end to end: ``pc(x, test="discrete")`` on that stand-in with
   the counts reset just before and read just after (gsq must have
   launched), per-level times, and a float64 certificate (scipy's χ²
   tail) of every recorded sepset at ℓ ≥ 1: p ≥ α, except p within
   |p/α − 1| ≤ 1e-4 (the p band) or within the first-order error bound of
   the fp32 G² (see ``g2_of``), both counted; then equality with the
   port's CPU run on an n = 40 instance outside the p band, and with the
   float64 serial oracle's skeleton on an n = 12 instance.

The last two lines are a ``{"kernels": [...]}`` record and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP32_OPS_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores
BAND = 1e-4
NCI60 = dict(n=1190, m=47, density=0.02, alpha=0.01, seed=0)
SMALL = dict(n=200, m=47, density=0.02, alpha=0.01, seed=1)
# the paper's §5.6 grid instance (src/repro/configs/cupc_datasets.py:31-33)
S56 = dict(n=1000, m=10000, density=0.1, alpha=0.01, seed=0)
# the NCI-60 runs of the other Gaussian engines, compared with "auto"
ENGINE_RUNS = (("S", dict(engine="S")), ("E", dict(engine="E")),
               ("S-grid", dict(engine="S-grid")), ("S depth 3", dict(engine="S", pipeline_depth=3)))
# bnlearn's PIGS network: 441 variables, all ternary, 592 arcs
PIGS = dict(n=441, m=5000, density=0.0061, arity=3, alpha=0.01, seed=0)
D_SMALL = dict(n=40, m=2000, density=0.1, arity=3, alpha=0.01, seed=1)
D_ORACLE = dict(n=12, m=600, density=0.3, arity=3, alpha=0.05, seed=4)
P_BAND = 1e-4
U32 = 2.0**-24
# fp32 operations per tested level-1 cell: num 2, den 5, max 1, rsqrt 1,
# mul 1, clip 2, atanh ≈ 5 (sub, div, log1p, mul), abs+compare 1
L1_OPS_PER_CELL = 18
# per level-0 cell: clip 2, atanh ≈ 5, abs 1, compare 1, i ≠ j and the and 2
LEVEL0_OPS_PER_CELL = 11
# per G² term: 4 logs ≈ 4 × 5, max 4, add/sub 3, mul 1, select and the
# in-order add 2; per sample: bounds check and count 2
G2_OPS_PER_TERM = 30
G2_OPS_PER_SAMPLE = 2


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def cuda_ms(torch, fn, reps=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(torch, fn, reps=20):
    """Device time per call of ``fn``: ``reps`` calls captured in one CUDA
    graph and replayed, so the host's time between launches drops out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return cuda_ms(torch, graph.replay, reps=5, warmup=1) / reps


def bound(bytes_moved, ops):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cholinv_ops(ell):
    """fp32 operations of one set in csrc/cholinv.cu, counted from its loops."""
    ops = (ell - 1) + 2 + ell  # scale, jit_eff, diagonal jitter
    for j in range(ell):
        ops += 2 * j + 3  # diagonal: j mul-sub pairs, max, sqrt, reciprocal
        ops += (ell - j - 1) * (2 * j + 1)  # below-diagonal entries
    for j in range(ell):
        ops += 1
        for i in range(j + 1, ell):
            ops += 1 + 2 * (i - j - 1) + 1
    for i in range(ell):
        for j in range(i, ell):
            ops += 2 * (ell - j) + 2 + (2 if i != j else 0)
    return ops + 2 * ell  # var


def cisweep_ops(ell):
    return 5 * ell + 4 * (ell * (ell - 1) // 2) + 12


def band_diff(got, want, lo, hi):
    """(# differing cells, # differing cells whose decision does not move
    between τ − 1e-4 and τ + 1e-4)."""
    diff = got != want
    outside = diff & (lo == hi)
    return int(diff.sum()), int(outside.sum())


def gather_tests(c64, i, j, sets):
    """What CI test (i, j | S) reads of C, for index arrays i, j (k,) and
    sets (k, ℓ): (C_ij, C(i,S), C(j,S), C[S,S])."""
    return (c64[i, j], c64[i[:, None], sets], c64[j[:, None], sets],
            c64[sets[:, :, None], sets[:, None, :]])


def z_of(cij, ci, cj, m2):
    """(|atanh ρ(i, j | S)| in float64, and a first-order bound on how far
    the fp32 evaluation of the same test can stray from it).

    The bound: a Cholesky-based solve in fp32 is backward stable with
    error about (ℓ + 1)·u·‖M2⁻¹‖ (u = 2^-24), so the residual variances
    var = 1 − cᵀM2⁻¹c and the numerator C_ij − C(i,S)ᵀM2⁻¹C(j,S) carry
    absolute errors up to e = 2(ℓ + 1)·u·(1 + ‖M2⁻¹‖·‖c‖²); these move ρ
    by e_num/√(var_i·var_j) + |ρ|·(e_i/2var_i + e_j/2var_j) and z by that
    over 1 − ρ². Tests on nearly collinear variables (|C| → 1) have small
    residual variances and a large bound: fp32 cannot decide them. A test
    whose C[S,S] is singular (variables of S perfectly correlated in the
    fp32 C) has no partial correlation at all: z and its bound are +inf."""
    import numpy as np

    ell = ci.shape[1]
    singular = np.zeros(cij.shape, dtype=bool)
    if ell == 0:
        rho, drho = cij, np.zeros_like(cij)
    else:
        lam = np.linalg.eigvalsh(m2)[:, 0]
        singular = lam <= 1e-12
        m2 = np.where(singular[:, None, None], np.eye(ell), m2)
        gi = np.linalg.solve(m2, ci[..., None])[..., 0]
        gj = np.linalg.solve(m2, cj[..., None])[..., 0]
        num = cij - np.einsum("ka,ka->k", ci, gj)
        vi = 1.0 - np.einsum("ka,ka->k", ci, gi)
        vj = 1.0 - np.einsum("ka,ka->k", cj, gj)
        den = np.sqrt(np.maximum(vi * vj, 1e-300))
        rho = num / den
        inv_norm = 1.0 / np.maximum(lam, 1e-300)
        k = 2 * (ell + 1) * 2.0**-24
        ni, nj = (ci * ci).sum(1), (cj * cj).sum(1)
        e_i, e_j = k * (1 + inv_norm * ni), k * (1 + inv_norm * nj)
        e_num = k * (np.abs(cij) + inv_norm * np.sqrt(ni * nj))
        with np.errstate(divide="ignore", invalid="ignore"):
            drho = e_num / den + np.abs(rho) * (e_i / (2 * vi) + e_j / (2 * vj))
        drho = np.where((vi > e_i) & (vj > e_j), drho, np.inf)
    rho = np.clip(rho, -0.9999999, 0.9999999)
    z, err = np.abs(np.arctanh(rho)), drho / (1 - rho * rho)
    return np.where(singular, np.inf, z), np.where(singular, np.inf, err)


def certify(run, c64, m, alpha, threshold):
    """Every recorded sepset must pass its CI test recomputed in float64:
    z ≤ τ, or within the band τ + 1e-4, or (ill-conditioned for fp32)
    within τ + 1e-4 + its fp32 error bound. Returns per-ℓ counts; raises
    on a failure."""
    import numpy as np

    n = run.adj.shape[0]
    iu, ju = np.triu_indices(n, 1)
    srows = run.sepsets[iu, ju]
    keep = ~run.adj[iu, ju] & (srows[:, 0] >= 0)
    iu, ju, srows = iu[keep], ju[keep], srows[keep]
    sizes = (srows >= 0).sum(axis=1)
    counts = {}
    for ell in np.unique(sizes):
        sel = sizes == ell
        tau = threshold(m, int(ell), alpha)
        z, err = z_of(*gather_tests(c64, iu[sel], ju[sel], srows[sel, :ell].astype(np.int64)))
        bad = z > tau + BAND + err
        if bad.any():
            raise PhaseError(f"sepset certificate failed at ℓ={ell}: {int(bad.sum())} sets "
                             f"with z > τ + {BAND} + fp32 error bound (worst z - τ = "
                             f"{float((z - tau)[bad].max()):.3g})")
        singular = np.isinf(z)
        if singular.any():
            k = int(np.flatnonzero(singular)[0])
            ids = srows[sel][k, :ell].astype(np.int64)
            block = c64[np.ix_(ids, ids)]
            print(f"  note: {int(singular.sum())} ℓ={ell} sepsets have a singular C[S,S], e.g. "
                  f"({iu[sel][k]}, {ju[sel][k]} | {ids.tolist()}) with max |C| off its "
                  f"diagonal {float(np.abs(block - np.diag(np.diag(block))).max())!r}")
        counts[int(ell)] = dict(checked=int(sel.sum()),
                                band=int(((z > tau) & (z <= tau + BAND)).sum()),
                                fp32_undecidable=int((z > tau + BAND).sum()),
                                singular=int(singular.sum()))
    return counts


def explain_diffs(a, b, c64, m, alpha, threshold, sepsets=True):
    """Edges where two runs differ in adjacency or (with ``sepsets``) in
    sepset; each must be explained by a CI test of either run's sepset
    lying within the band (plus its fp32 error bound) of τ."""
    import numpy as np

    n = a.adj.shape[0]
    iu, ju = np.triu_indices(n, 1)
    differ = a.adj[iu, ju] != b.adj[iu, ju]
    if sepsets:
        differ |= (a.sepsets[iu, ju] != b.sepsets[iu, ju]).any(1)
    unexplained = 0
    for i, j in zip(iu[differ], ju[differ]):
        near = False
        for run in (a, b):
            s = run.sepsets[i, j]
            if run.adj[i, j] or s[0] < 0:
                continue
            ids = s[s >= 0].astype(np.int64)
            z, err = z_of(*gather_tests(c64, np.array([i]), np.array([j]), ids[None, :]))
            near |= abs(z[0] - threshold(m, len(ids), alpha)) <= BAND + err[0]
        unexplained += not near
    return int(differ.sum()), unexplained


def discrete_codes(sample_discrete_dag, cfg):
    """Seeded categorical samples for ``cfg``; a column the generator left
    constant gets one flipped code, as the repository's test fixtures do
    (validation refuses one-level columns)."""
    x, dag = sample_discrete_dag(cfg["n"], cfg["m"], cfg["density"], cfg["arity"],
                                 seed=cfg["seed"])
    for k in range(cfg["n"]):
        if (x[:, k] == x[0, k]).all():
            x[0, k] = (x[1, k] + 1) % cfg["arity"]
    return x, dag


def g2_of(codes, arities, r, i, j, s):
    """(p of the G² test (i, j | S) in float64, and a first-order bound on
    how far the port's fp32 p can stray from it).

    The fp32 G² sums K = r^(ℓ+2) terms N·(((log N + log N_c) − log N_a) −
    log N_b): each log is within an ulp, each add and the product round
    once, and the in-order sum of K terms adds at most K·u·Σ|term|, so
    e_G² ≤ 2·(4u·Σ N·(|log N| + |log N_c| + |log N_a| + |log N_b|) +
    (K + 1)·u·Σ|term|), and p moves by at most chi2.pdf(G², dof)·e_G².
    Tables with large, nearly cancelling terms have a large bound."""
    import numpy as np
    from scipy.stats import chi2

    ri, rj = int(arities[i]), int(arities[j])
    q = 1
    code = np.zeros(codes.shape[0], dtype=np.int64)
    for k in s:
        code = code * int(arities[k]) + codes[:, k]
        q *= int(arities[k])
    code = (code * ri + codes[:, i]) * rj + codes[:, j]
    tab = np.bincount(code, minlength=q * ri * rj).astype(np.float64).reshape(q, ri, rj)
    logs = [np.log(np.maximum(v, 1.0)) for v in
            (tab, tab.sum(axis=(1, 2), keepdims=True), tab.sum(axis=2, keepdims=True),
             tab.sum(axis=1, keepdims=True))]
    term = np.where(tab > 0, tab * (logs[0] + logs[1] - logs[2] - logs[3]), 0.0)
    g2 = 2.0 * float(term.sum())
    dof = max((ri - 1) * (rj - 1) * q, 1)
    k_total = r ** (len(s) + 2)
    e_g2 = 2.0 * (4 * U32 * float((tab * sum(np.abs(v) for v in logs)).sum())
                  + (k_total + 1) * U32 * float(np.abs(term).sum()))
    return float(chi2.sf(g2, dof)), float(chi2.pdf(g2, dof)) * e_g2


def certify_g2(run, codes, r, alpha):
    """Every sepset recorded at ℓ ≥ 1 must pass its G² test in float64:
    p ≥ α, or p in the band |p/α − 1| ≤ 1e-4, or (fp32 cannot decide it)
    within the band plus its fp32 error bound. Returns per-ℓ counts; raises
    on a failure."""
    arities = codes.max(axis=0) + 1
    counts = {}
    for (i, j), ids in run.sepset_dict().items():
        if not ids:
            continue
        p, dp = g2_of(codes, arities, r, i, j, ids)
        cnt = counts.setdefault(len(ids), dict(checked=0, band=0, fp32_undecidable=0))
        cnt["checked"] += 1
        if p >= alpha:
            continue
        if p >= alpha * (1 - P_BAND):
            cnt["band"] += 1
        elif p >= alpha * (1 - P_BAND) - dp:
            cnt["fp32_undecidable"] += 1
        else:
            raise PhaseError(f"G² certificate failed: ({i}, {j} | {ids}) has float64 p = {p:.6g} "
                             f"< α = {alpha} beyond the band and its fp32 bound {dp:.3g}")
    return dict(sorted(counts.items()))


def explain_g2_diffs(a, b, codes, r, alpha):
    """Edges where two discrete runs differ in adjacency or sepset; each
    must be explained by a test of either run's sepset (the empty set for
    a level-0 removal) whose float64 p lies within the p band (plus its
    fp32 bound) of α."""
    import numpy as np

    arities = codes.max(axis=0) + 1
    n = a.adj.shape[0]
    iu, ju = np.triu_indices(n, 1)
    differ = (a.adj[iu, ju] != b.adj[iu, ju]) | (a.sepsets[iu, ju] != b.sepsets[iu, ju]).any(1)
    unexplained = 0
    for i, j in zip(iu[differ], ju[differ]):
        near = False
        for run in (a, b):
            if run.adj[i, j]:
                continue
            s = run.sepsets[i, j]
            p, dp = g2_of(codes, arities, r, i, j, tuple(int(v) for v in s[s >= 0]))
            near |= abs(p - alpha) <= alpha * P_BAND + dp
        unexplained += not near
    return int(differ.sum()), unexplained


def sgrid_phase(torch, label, args, tau):
    """The sgrid kernel against its plain version on one gathered launch:
    winners equal in every (row, slot) whose winner does not move between
    τ − 1e-4 and τ + 1e-4; timed; its bound counted from what this launch's
    data needs (each (row, slot) tests its masked-in ranks up to its winner,
    each row inverts the sets up to its last winner)."""
    from repro_torch.kernels import sgrid

    m2, ci_s, cj_s, cij, mask, s_ids = args
    n_l, t_len, npr = mask.shape
    ell = m2.shape[-1]
    t_k, s_k = sgrid.sgrid(*args, tau)
    t_p, s_p = sgrid.sgrid_plain(*args, tau)
    t_lo, _ = sgrid.sgrid_plain(*args, tau - BAND)
    t_hi, _ = sgrid.sgrid_plain(*args, tau + BAND)
    diff = (t_k != t_p) | (s_k != s_p).any(-1)
    outside = diff & (t_lo == t_hi)
    err = float(torch.where(outside, (t_k - t_p).abs(), 0).max()) if npr else 0.0
    k_ms = cuda_ms(torch, lambda: sgrid.sgrid(*args, tau))
    p_ms = cuda_ms(torch, lambda: sgrid.sgrid_plain(*args, tau), reps=3, warmup=1)
    found = t_p < sgrid.SENTINEL
    limit = torch.where(found, t_p, t_len - 1)
    local = torch.arange(t_len, device=mask.device)
    visited = local[None, :, None] <= limit[:, None, :]
    cells = int(visited.sum())
    tested = int((visited & mask.to(torch.bool)).sum())
    ranks = int((limit.max(dim=1).values + 1).sum()) if npr else 0
    bytes_moved = (ranks * (ell * ell + ell) * 4 + cells + tested * 4 * ell + n_l * npr * 4
                   + int(found.sum()) * ell * 4 + n_l * npr * (ell + 1) * 4)
    b_ms, b_by = bound(bytes_moved, ranks * cholinv_ops(ell) + tested * cisweep_ops(ell))
    print(f"kernel sgrid {label}: n_l={n_l} T={t_len} n′={npr} ℓ={ell}: {int(found.sum())} of "
          f"{found.numel()} slots separated; winners differ in {int(diff.sum())} cells "
          f"({int(outside.sum())} outside the τ band, {int((t_lo != t_hi).sum())} band cells); "
          f"kernel {k_ms:.4f} ms plain {p_ms:.4f} ms bound {b_ms:.5f} ms ({b_by}: {tested} "
          f"tested of {cells} visited cells, {ranks} set inverses)")
    check(not bool(outside.any()), f"sgrid {label} winners differ outside the τ band")
    return dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None)


def gathered_launch(torch, c, adj, ell, budget):
    """The first launch of a level as "S-grid" plans it: the gathered
    (m2, ci_s, cj_s, cij, mask, s_ids) of its ranks."""
    from repro_torch.core import levels as L
    from repro_torch.core.compact import compact_rows

    n = c.shape[0]
    npr = int(adj.sum(1).max())
    npr_b, n_chunk, total = L.plan_level(npr, ell, n, cell_budget=budget, n_cols=n)
    compact, counts = compact_rows(adj, n_prime=npr_b)
    ranks = torch.arange(n_chunk, dtype=torch.int32, device=c.device)
    rows = torch.arange(n, dtype=torch.int32, device=c.device)
    print(f"ℓ={ell} S-grid launch: max degree {npr} (bucket {npr_b}), {total} ranks, "
          f"{n_chunk} a launch, {-(-total // n_chunk)} launches")
    return L.gather_s(c, adj, compact, counts, rows, ranks, ell=ell, n_max=npr_b)


def synthetic_launch(torch, n_l, t_len, npr, ell, seed, dev):
    """A seeded random launch with SPD m2, made on ``dev``."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def normal(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    a = normal(n_l, t_len, ell, ell)
    m2 = a @ a.transpose(-1, -2) / ell + 0.5 * torch.eye(ell, device=dev)
    return (m2, 0.3 * normal(n_l, t_len, ell), 0.3 * normal(n_l, t_len, npr, ell),
            0.3 * normal(n_l, t_len, npr), torch.rand(n_l, t_len, npr, generator=g, device=dev)
            < 0.7, torch.randint(0, 1000, (n_l, t_len, ell), generator=g, device=dev,
                                 dtype=torch.int32))


def level_lines(run):
    for st in run.level_stats:
        print(f"  level {st['level']}: engine {st['engine']} max degree {st['npr']} "
              f"chunks {st['chunks']} dispatches {st.get('dispatches')} n_chunk "
              f"{st.get('n_chunk')} {run.timings_s.get('level%d' % st['level'], 0.0):.4f} s")


def nci60_engines(torch, x_np, auto, c64, launches, dev):
    """``pc(x, engine=e)`` on NCI-60 for the other Gaussian engines, each
    with the counts reset just before it and read just after, against
    "auto" on the same C and certified in float64."""
    from repro_torch import pc
    from repro_torch.core.cit import threshold
    from repro_torch.kernels import build

    cfg = NCI60
    chunked = ("cholinv", "cisweep", "level1")
    for label, kw in ENGINE_RUNS:
        torch.cuda.synchronize()
        build.reset_launches()
        t0 = time.monotonic()
        run = pc(x_np, alpha=cfg["alpha"], device=dev, **kw)
        torch.cuda.synchronize()
        secs = time.monotonic() - t0
        counts = dict(build.LAUNCHES)
        chunks = sum(st["chunks"] for st in run.level_stats)
        print(f"e2e pc(x, {', '.join(f'{k}={v!r}' for k, v in kw.items())}) NCI-60: {secs:.3f} s, "
              f"{run.levels_run} levels, {int(run.adj.sum()) // 2} edges, {chunks} chunks, "
              f"launches {json.dumps(counts)}")
        level_lines(run)
        if kw["engine"] == "S-grid":
            launches["sgrid"] = counts["sgrid"]
            check(counts["sgrid"] == chunks > 0 and not any(counts[k] for k in chunked),
                  f"S-grid launched sgrid {counts['sgrid']} times for {chunks} launches "
                  f"planned, or a chunked kernel: {counts}")
        else:
            check(not any(counts[k] for k in chunked + ("sgrid",)),
                  f"{label} launched a kernel of another engine: {counts}")
        # "E" ranks other sets than the shared-set engines: where several
        # separate an edge it records another one, so only its skeleton is
        # held to "auto"; its sepsets are certified below like every run's
        n_diff, unexplained = explain_diffs(run, auto, c64, cfg["m"], cfg["alpha"], threshold,
                                            sepsets=kw["engine"] != "E")
        print(f"  against auto: {n_diff} edges differ ({unexplained} outside the τ band and "
              "fp32 bound)")
        check(unexplained == 0, f"{label} differs from auto outside the τ band and fp32 bound")
        for ell, cnt in certify(run, c64, cfg["m"], cfg["alpha"], threshold).items():
            print(f"  certificate ℓ={ell}: {cnt['checked']} pass, {cnt['band']} in the τ band, "
                  f"{cnt['fp32_undecidable']} within their fp32 bound ({cnt['singular']} "
                  "with a singular C[S,S])")


def section56(torch, dev):
    """The §5.6 grid instance at full n and m: sgrid at its first ℓ = 2
    launch, then "S-grid" against "auto" with per-level chunks and spans."""
    from repro_torch import pc
    from repro_torch.core import engines, levels as L
    from repro_torch.core.cit import threshold
    from repro_torch.data.synthetic_dag import sample_gaussian_dag
    from repro_torch.kernels import build, ops

    cfg = S56
    n, m, alpha = cfg["n"], cfg["m"], cfg["alpha"]
    x_np, _ = sample_gaussian_dag(n, m, cfg["density"], seed=cfg["seed"])
    c = ops.correlation(torch.tensor(x_np, dtype=torch.float32, device=dev))
    tau = [threshold(m, ell, alpha) for ell in range(3)]
    adj0 = ops.level0(c, tau[0])
    sep0 = torch.full((n, n, 8), -1, dtype=torch.int32, device=dev)
    sep0[:, :, 0] = torch.where(adj0, -1, -2).to(torch.int32)
    adj1, _, _ = engines.run_level(c, adj0, sep0, 1, tau[1])
    print(f"§5.6 instance n={n} m={m} density {cfg['density']}: level 0 keeps "
          f"{int(adj0.sum()) // 2} edges, level 1 {int(adj1.sum()) // 2}")
    sgrid_phase(torch, "§5.6 first ℓ=2 launch",
                gathered_launch(torch, c, adj1, 2, L.GRID_CELL_BUDGET), tau[2])

    runs, c64 = {}, c.double().cpu().numpy()
    for label, run_kw in (("auto", {}), ("S-grid", dict(engine="S-grid"))):
        build.reset_launches()
        t0 = time.monotonic()
        run = pc(x_np, alpha=alpha, device=dev, **run_kw)
        torch.cuda.synchronize()
        secs = time.monotonic() - t0
        print(f"e2e pc(x{', engine=' + repr(label) if run_kw else ''}) §5.6: {secs:.3f} s, "
              f"{run.levels_run} levels, {int(run.adj.sum()) // 2} edges, launches "
              f"{json.dumps(build.LAUNCHES)}, total span {run.timings_s['total']:.4f} s")
        level_lines(run)
        runs[label] = run
        if run_kw:
            chunks = sum(st["chunks"] for st in run.level_stats)
            check(build.LAUNCHES["sgrid"] == chunks > 0,
                  f"§5.6 S-grid launched sgrid {build.LAUNCHES['sgrid']} times for {chunks}")
            n_diff, unexplained = explain_diffs(run, runs["auto"], c64, m, alpha, threshold)
            print(f"  against auto: {n_diff} edges differ ({unexplained} outside the τ band "
                  "and fp32 bound)")
            check(unexplained == 0, "§5.6 S-grid differs from auto outside the τ band")
        for ell, cnt in certify(run, c64, m, alpha, threshold).items():
            print(f"  certificate ℓ={ell}: {cnt['checked']} pass, {cnt['band']} in the τ "
                  f"band, {cnt['fp32_undecidable']} within their fp32 bound "
                  f"({cnt['singular']} with a singular C[S,S])")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: the repro_torch package is missing under {SRC}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    warnings.simplefilter("ignore", UserWarning)  # m < n is NCI-60's regime
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    # ---------------------------------------------------------------- build
    t0 = time.monotonic()
    built = build.library()
    print(f"build: {built.seconds:.1f} s nvcc ({time.monotonic() - t0:.1f} s with load) "
          f"-> {built.path.name}")
    for line in built.ptxas.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print("  ptxas " + line.strip())

    rows, launches = {}, {}
    gaussian(torch, rows, launches)
    section56(torch, torch.device("cuda"))
    discrete(torch, rows, launches)

    sources = {"corr": ("src/repro_torch/csrc/corr.cu", "src/repro/kernels/corr.py:38"),
               "level0": ("src/repro_torch/csrc/level0.cu", "src/repro/kernels/level0.py:28"),
               "level1": ("src/repro_torch/csrc/level1.cu", "src/repro/kernels/level1.py:78"),
               "cholinv": ("src/repro_torch/csrc/cholinv.cu", "src/repro/kernels/cholinv.py:81"),
               "cisweep": ("src/repro_torch/csrc/cisweep.cu", "src/repro/kernels/cisweep.py:50"),
               "sgrid": ("src/repro_torch/csrc/sgrid.cu", "src/repro/kernels/sgrid.py:170"),
               "gsq": ("src/repro_torch/csrc/gsq.cu", "src/repro/kernels/gsq.py:129")}
    kernels = [dict(name=name, route="cuda", source=src, replaces=rep, launches=launches[name],
                    **rows[name]) for name, (src, rep) in sources.items()]
    for k in kernels:
        check(all(isinstance(v, (int, float)) and math.isfinite(v)
                  for key, v in k.items() if key in ("ms", "plain_ms", "bound_ms")),
              f"non-finite timing in {k}")
    print(smi.stdout.strip())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def gaussian(torch, rows, launches):
    """Phases 2 and 3: the Gaussian kernels and ``pc(x)`` on NCI-60."""
    from repro_torch import pc, pc_from_corr
    from repro_torch.core import engines, levels as L
    from repro_torch.core.cit import threshold
    from repro_torch.core.compact import compact_rows
    from repro_torch.data.synthetic_dag import sample_gaussian_dag
    from repro_torch.kernels import build, cholinv, cisweep, corr, level0, level1, ops

    dev = torch.device("cuda")
    cfg = NCI60
    x_np, _ = sample_gaussian_dag(cfg["n"], cfg["m"], cfg["density"], seed=cfg["seed"])
    x = torch.tensor(x_np, dtype=torch.float32, device=dev)
    m, n, alpha = cfg["m"], cfg["n"], cfg["alpha"]
    tau = [threshold(m, ell, alpha) for ell in range(3)]

    # -------------------------------------------------------------- kernels
    # corr, at the main path's shape, the paper's §5.6 shape, a ragged one
    # (m not a multiple of the 32-sample slab or of its split, n not of the
    # 128-wide tile nor of 4) and the paper's two other small-m datasets with
    # many tiles (S.cerevisiae, S.aureus: src/repro/configs/cupc_datasets.py:
    # 26-27): atol 2e-6, bitwise symmetric, bitwise equal across two calls;
    # timed in turns with torch.matmul, and in a CUDA graph for the device
    # time alone (at m = 47 both calls are host-bound)
    corr_shapes = (("nci60", m, n, None), ("s5.6", 10000, 1000, (0.1, 1)),
                   ("ragged", 1003, 517, (0.1, 2)), ("S.cerevisiae", 63, 5361, (0.01, 3)),
                   ("S.aureus", 160, 2810, (0.01, 4)))
    for label, mm, nn, gen in corr_shapes:
        xs = x if gen is None else torch.tensor(
            sample_gaussian_dag(nn, mm, gen[0], seed=gen[1])[0], dtype=torch.float32, device=dev)
        xn = ops.standardize(xs).contiguous()
        got = corr.corr_matmul(xn)
        want = corr.corr_matmul_plain(xn)
        err = float((got - want).abs().max())
        symmetric = torch.equal(got, got.T)
        same = torch.equal(got, corr.corr_matmul(xn))
        reps = 50 if mm * nn * nn > 1e9 else 20
        l1_ms = cuda_ms(torch, lambda: torch.matmul(xn.T, xn), reps=reps)
        k1_ms = cuda_ms(torch, lambda: corr.corr_matmul(xn), reps=reps)
        k2_ms = cuda_ms(torch, lambda: corr.corr_matmul(xn), reps=reps)
        l2_ms = cuda_ms(torch, lambda: torch.matmul(xn.T, xn), reps=reps)
        k_ms, lib_ms = (k1_ms + k2_ms) / 2, (l1_ms + l2_ms) / 2
        kg_ms = graph_ms(torch, lambda: corr.corr_matmul(xn))
        lg_ms = graph_ms(torch, lambda: torch.matmul(xn.T, xn))
        p_ms = cuda_ms(torch, lambda: corr.corr_matmul_plain(xn))
        # the least work of XᵀX is its symmetric half: m·n·(n + 1) FLOPs
        b_ms, b_by = bound((mm * nn + nn * nn) * 4, mm * nn * (nn + 1))
        tile, tiles, splits, sps = corr.plan(mm, nn, torch.cuda.get_device_properties(dev)
                                             .multi_processor_count)
        print(f"kernel corr {label} m={mm} n={nn} ({tiles} tiles of {tile} x {splits} splits of "
              f"{sps} slabs): max_abs_err {err:.3g} (tol 2e-6), bitwise symmetric {symmetric}, "
              f"bitwise equal across calls {same}; kernel {k1_ms:.4f}/{k2_ms:.4f} ms, "
              f"torch.matmul {l1_ms:.4f}/{l2_ms:.4f} ms (kernel faster: {k_ms < lib_ms}); "
              f"in a CUDA graph kernel {kg_ms:.4f} ms, torch.matmul {lg_ms:.4f} ms; "
              f"plain {p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}; the full 2·m·n² product: "
              f"{bound((mm * nn + nn * nn) * 4, 2 * mm * nn * nn)[0]:.4f} ms)")
        check(err <= 2e-6, f"corr m={mm} n={nn} disagrees with its plain version: {err}")
        check(symmetric and same, f"corr m={mm} n={nn} is not bitwise symmetric and repeatable")
        if label == "nci60":
            rows["corr"] = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                                bound_by=b_by, library_ms=lib_ms)

    # level0 on C, exact against its plain version (core/levels.level0)
    c = ops.correlation(x)
    adj0 = L.level0(c, tau[0])
    n_diff = int((level0.level0_kernel(c, tau[0]) != adj0).sum())
    k_ms = cuda_ms(torch, lambda: level0.level0_kernel(c, tau[0]))
    p_ms = cuda_ms(torch, lambda: L.level0(c, tau[0]))
    b_ms, b_by = bound(5 * n * n, LEVEL0_OPS_PER_CELL * n * n)
    print(f"kernel level0 n={n}: {int(adj0.sum()) // 2} edges, max degree "
          f"{int(adj0.sum(1).max())}; differs from the plain version in {n_diff} cells (exact "
          f"required); kernel {k_ms:.4f} ms plain {p_ms:.4f} ms bound {b_ms:.5f} ms ({b_by})")
    check(n_diff == 0, f"level0 differs from its plain version in {n_diff} cells")
    rows["level0"] = dict(max_abs_err=float(n_diff), ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                          bound_by=b_by, library_ms=None)

    # level1 on the level-0 adjacency
    rem_k, kwin_k = level1.level1_dense_kernel(c, adj0, tau[1])
    rem_p, kwin_p = level1.level1_dense_plain(c, adj0, tau[1])
    rem_lo, kwin_lo = level1.level1_dense_plain(c, adj0, tau[1] - BAND)
    rem_hi, kwin_hi = level1.level1_dense_plain(c, adj0, tau[1] + BAND)
    d_rem, o_rem = band_diff(rem_k, rem_p, rem_lo, rem_hi)
    d_kw, o_kw = band_diff(kwin_k, kwin_p, kwin_lo, kwin_hi)
    outside = ((rem_k != rem_p) | (kwin_k != kwin_p)) & (rem_lo == rem_hi) & (kwin_lo == kwin_hi)
    err = float(torch.where(outside, (kwin_k - kwin_p).abs().float(), 0.0).max()) if o_kw else 0.0
    err = max(err, 1.0 if o_rem else 0.0)
    k_ms = cuda_ms(torch, lambda: level1.level1_dense_kernel(c, adj0, tau[1]), reps=10)
    p_ms = cuda_ms(torch, lambda: level1.level1_dense_plain(c, adj0, tau[1]), reps=3, warmup=1)
    # cells the data needs: masked-in k of alive edges, up to the least own
    # separator when there is one (after it neither output can change)
    cells = 0
    ks = torch.arange(n, device=dev)
    for i0 in range(0, n, 64):
        i1 = min(n, i0 + 64)
        ri = torch.arange(i0, i1, device=dev)
        alive = adj0[i0:i1] & (ri[:, None] != ks[None, :])
        kmask = (adj0[i0:i1, None, :] | adj0[None, :, :]) & (ks[None, None, :] != ri[:, None, None])
        kmask &= ks[None, None, :] != ks[None, :, None]
        stop = torch.where(kwin_p[i0:i1] < level1.BIG, kwin_p[i0:i1], n - 1)
        cells += int((kmask & alive[:, :, None] & (ks[None, None, :] <= stop[:, :, None])).sum())
    b_ms, b_by = bound(10 * n * n, L1_OPS_PER_CELL * cells)
    print(f"kernel level1 n={n}: removed differs in {d_rem} cells ({o_rem} outside the τ band), "
          f"kwin differs in {d_kw} ({o_kw} outside); kernel {k_ms:.4f} ms plain {p_ms:.4f} ms "
          f"bound {b_ms:.4f} ms ({b_by}, {cells} tested cells)")
    check(o_rem == 0 and o_kw == 0, "level1 decisions differ outside the τ band")
    rows["level1"] = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                          bound_by=b_by, library_ms=None)

    # cholinv and cisweep on the first ℓ = 2 chunk of the run
    sep0 = torch.full((n, n, 8), -1, dtype=torch.int32, device=dev)
    sep0[:, :, 0] = torch.where(adj0, -1, -2).to(torch.int32)
    adj1, _sep1, _ = engines.run_level(c, adj0, sep0, 1, tau[1])
    ell = 2
    npr = int(adj1.sum(1).max())
    npr_b, n_chunk, total = L.plan_level(npr, ell, n, n_cols=n)
    compact, counts = compact_rows(adj1, n_prime=npr_b)
    ranks = torch.arange(n_chunk, dtype=torch.int32, device=dev)
    rows_i = torch.arange(n, dtype=torch.int32, device=dev)
    m2, ci_s, cj_s, cij, mask, _ = L.gather_s(c, adj1, compact, counts, rows_i, ranks,
                                              ell=ell, n_max=npr_b)
    b = n * n_chunk
    m2 = m2.reshape(b, ell, ell).contiguous()
    ci_s = ci_s.reshape(b, ell).contiguous()
    cj_s = cj_s.reshape(b, npr_b, ell).contiguous()
    cij = cij.reshape(b, npr_b).contiguous()
    mask = mask.reshape(b, npr_b).contiguous()
    print(f"ℓ=2 chunk: max degree {npr} (bucket {npr_b}), {total} ranks, chunk {n_chunk}, "
          f"B={b} sets x P={npr_b} slots, {int(mask.sum())} masked-in cells")
    g_k, u_k, v_k = cholinv.cholinv(m2, ci_s)
    g_p, u_p, v_p = cholinv.cholinv_plain(m2, ci_s)
    err = max(float((a - p).abs().max()) for a, p in ((g_k, g_p), (u_k, u_p), (v_k, v_p)))
    close = all(torch.allclose(a, p, rtol=1e-5, atol=1e-6)
                for a, p in ((g_k, g_p), (u_k, u_p), (v_k, v_p)))
    k_ms = cuda_ms(torch, lambda: cholinv.cholinv(m2, ci_s))
    p_ms = cuda_ms(torch, lambda: cholinv.cholinv_plain(m2, ci_s))
    b_ms, b_by = bound(b * (2 * ell * ell + 2 * ell + 1) * 4, b * cholinv_ops(ell))
    print(f"kernel cholinv ℓ={ell} B={b}: max_abs_err {err:.3g} (rtol 1e-5, atol 1e-6) "
          f"kernel {k_ms:.4f} ms plain {p_ms:.4f} ms bound {b_ms:.5f} ms ({b_by})")
    check(close, f"cholinv disagrees with its plain version: max_abs_err {err}")
    rows["cholinv"] = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                           bound_by=b_by, library_ms=None)

    got = cisweep.cisweep(g_k, u_k, v_k, cj_s, cij, mask, tau[2])
    want = cisweep.cisweep_plain(g_k, u_k, v_k, cj_s, cij, mask, tau[2])
    lo = cisweep.cisweep_plain(g_k, u_k, v_k, cj_s, cij, mask, tau[2] - BAND)
    hi = cisweep.cisweep_plain(g_k, u_k, v_k, cj_s, cij, mask, tau[2] + BAND)
    d_sw, o_sw = band_diff(got, want, lo, hi)
    k_ms = cuda_ms(torch, lambda: cisweep.cisweep(g_k, u_k, v_k, cj_s, cij, mask, tau[2]))
    p_ms = cuda_ms(torch, lambda: cisweep.cisweep_plain(g_k, u_k, v_k, cj_s, cij, mask, tau[2]))
    cells_sw = b * npr_b
    b_ms, b_by = bound(b * (ell * ell + ell + 1) * 4 + cells_sw * (4 * ell + 4 + 1 + 1),
                       int(mask.sum()) * cisweep_ops(ell))
    print(f"kernel cisweep ℓ={ell}: decisions differ in {d_sw} cells ({o_sw} outside the τ band) "
          f"kernel {k_ms:.4f} ms plain {p_ms:.4f} ms bound {b_ms:.5f} ms ({b_by})")
    check(o_sw == 0, "cisweep decisions differ outside the τ band")
    rows["cisweep"] = dict(max_abs_err=1.0 if o_sw else 0.0, ms=k_ms, plain_ms=p_ms,
                           bound_ms=b_ms, bound_by=b_by, library_ms=None)

    # sgrid at the first level-1 launch of "S-grid", and on seeded SPD
    # launches at ℓ = 3 and ℓ = 8
    rows["sgrid"] = sgrid_phase(torch, "NCI-60 first ℓ=1 launch",
                                gathered_launch(torch, c, adj0, 1, L.GRID_CELL_BUDGET), tau[1])
    for ell, seed in ((3, 3), (8, 8)):
        sgrid_phase(torch, f"synthetic SPD ℓ={ell}",
                    synthetic_launch(torch, 1000, 64, 64, ell, seed, dev), 0.05)

    # ----------------------------------------------------------- end to end
    # a first run loads PyTorch's own CUDA modules (sort, unique, bmm, ...)
    # on first use; the measured run after it is the steady state
    t0 = time.monotonic()
    first = pc(x_np, alpha=alpha)
    first_s = time.monotonic() - t0
    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.monotonic()
    run = pc(x_np, alpha=alpha)
    torch.cuda.synchronize()
    e2e_s = time.monotonic() - t0
    path = ("corr", "level0", "level1", "cholinv", "cisweep")
    launches.update({k: build.LAUNCHES[k] for k in path})
    check((run.adj == first.adj).all() and (run.sepsets == first.sepsets).all(),
          "two runs of pc(x) on the card disagree")
    print(f"e2e pc(x) NCI-60 n={n} m={m}: {e2e_s:.3f} s (first run {first_s:.3f} s), "
          f"{run.levels_run} levels, {int(run.adj.sum()) // 2} edges, "
          f"timings {json.dumps(run.timings_s)}")
    for st in run.level_stats:
        print(f"  level {st['level']}: engine {st['engine']} max degree {st['npr']} "
              f"chunks {st['chunks']} {run.timings_s.get('level%d' % st['level'], 0.0):.4f} s")
    print(f"  launches {json.dumps(build.LAUNCHES)}")
    check(all(launches[k] > 0 for k in path),
          f"a kernel of the Gaussian path never launched: {build.LAUNCHES}")
    c64 = ops.correlation(x).double().cpu().numpy()
    for ell, cnt in certify(run, c64, m, alpha, threshold).items():
        print(f"  certificate ℓ={ell}: {cnt['checked']} recorded sepsets pass in float64, "
              f"{cnt['band']} of them in the τ band, {cnt['fp32_undecidable']} past it but "
              "within their fp32 error bound (nearly collinear variables)")

    # the same C on the card and on the host CPU: decisions may differ only
    # through the ulps of rsqrtf/atanhf, so only inside the band
    sx, _ = sample_gaussian_dag(SMALL["n"], SMALL["m"], SMALL["density"], seed=SMALL["seed"])
    gpu = pc(sx, alpha=SMALL["alpha"])
    sc = ops.correlation(torch.tensor(sx, dtype=torch.float32, device=dev))
    cpu = pc_from_corr(sc.cpu(), SMALL["m"], alpha=SMALL["alpha"], device="cpu")
    sc64 = sc.double().cpu().numpy()
    n_diff, unexplained = explain_diffs(gpu, cpu, sc64, SMALL["m"], SMALL["alpha"], threshold)
    same_cpdag = bool((gpu.cpdag == cpu.cpdag).all())
    print(f"  n={SMALL['n']} CUDA vs CPU: {n_diff} edges differ ({unexplained} outside the τ band), "
          f"cpdag equal {same_cpdag}, {gpu.levels_run} levels")
    check(unexplained == 0, "CUDA and CPU runs differ outside the τ band")
    check(same_cpdag or n_diff > 0, "CPDAGs differ although skeleton and sepsets agree")
    gpu = pc(sx, alpha=SMALL["alpha"], engine="S-grid")
    cpu = pc_from_corr(sc.cpu(), SMALL["m"], alpha=SMALL["alpha"], device="cpu", engine="S-grid")
    n_diff, unexplained = explain_diffs(gpu, cpu, sc64, SMALL["m"], SMALL["alpha"], threshold)
    same_cpdag = bool((gpu.cpdag == cpu.cpdag).all())
    print(f"  n={SMALL['n']} S-grid CUDA vs CPU: {n_diff} edges differ ({unexplained} outside the "
          f"τ band), cpdag equal {same_cpdag}, {gpu.levels_run} levels")
    check(unexplained == 0, "S-grid CUDA and CPU runs differ outside the τ band")
    check(same_cpdag or n_diff > 0, "CPDAGs differ although skeleton and sepsets agree")

    nci60_engines(torch, x_np, run, c64, launches, dev)


def discrete(torch, rows, launches):
    """Phases 4 and 5: the gsq kernel and ``pc(x, test="discrete")`` on the
    PIGS-shaped stand-in."""
    from repro_torch import pc
    from repro_torch.core import cit, engines, levels as L, stable_ref
    from repro_torch.core.compact import compact_rows
    from repro_torch.data.synthetic_dag import sample_discrete_dag
    from repro_torch.kernels import build, gsq

    dev = torch.device("cuda")
    cfg = PIGS
    n, m, alpha = cfg["n"], cfg["m"], cfg["alpha"]
    x_np, dag = discrete_codes(sample_discrete_dag, cfg)
    test, stats = cit.DiscreteCITest.from_samples(x_np, alpha=alpha, device=dev)
    r = test.r
    print(f"discrete stand-in (bnlearn PIGS shape): n={n} m={m} arity {r}, "
          f"{int(dag.adj.sum())} true arcs, α={alpha}")

    def gsq_phase(label, jc, q):
        """gsq against its plain version on jc, bitwise; timed."""
        b, mm = jc.shape
        got = gsq.gsq_cells(jc, r=r, q=q)
        want = gsq.gsq_ref(jc, r=r, q=q)
        n_diff = int((got.view(torch.int32) != want.view(torch.int32)).sum())
        k_ms = cuda_ms(torch, lambda: gsq.gsq_cells(jc, r=r, q=q), reps=10)
        p_ms = cuda_ms(torch, lambda: gsq.gsq_ref(jc, r=r, q=q), reps=2, warmup=1)
        k_total = q * r * r
        b_ms, b_by = bound(4 * b * mm + 4 * b,
                           b * (mm * G2_OPS_PER_SAMPLE + k_total * G2_OPS_PER_TERM))
        print(f"kernel gsq {label}: M={mm} B={b} K={k_total}: {n_diff} cells differ from the "
              f"plain version (bitwise required); kernel {k_ms:.4f} ms plain {p_ms:.4f} ms "
              f"bound {b_ms:.4f} ms ({b_by})")
        check(n_diff == 0, f"gsq {label} differs from its plain version in {n_diff} cells")
        return dict(max_abs_err=float((got - want).abs().max()), ms=k_ms, plain_ms=p_ms,
                    bound_ms=b_ms, bound_by=b_by, library_ms=None)

    # ------------------------------------------------------- kernel: gsq
    codes_t = stats.codes.T.contiguous()
    jc = (codes_t[:, None, :] * r + codes_t[None, :, :]).reshape(n * n, m)
    rows["gsq"] = gsq_phase("level 0", jc, 1)
    flat = (jc.to(torch.int64) + torch.arange(n * n, device=dev)[:, None] * (r * r)).reshape(-1)
    print(f"  note: torch.bincount of the same codes (the counts alone, no G²) "
          f"{cuda_ms(torch, lambda: torch.bincount(flat, minlength=n * n * r * r), reps=5):.4f} ms")
    del jc, flat

    # the first chunk of every level ℓ = 1…5 of the run, each level's
    # adjacency from the level before it
    adj = test.level0(stats, alpha)
    sep = torch.full((n, n, 8), -1, dtype=torch.int32, device=dev)
    sep[:, :, 0] = torch.where(adj, -1, -2).to(torch.int32)
    for ell in range(1, test.max_supported_level() + 1):
        npr = int(adj.sum(1).max())
        if npr - 1 < ell:
            print(f"ℓ={ell}: max degree {npr}, no conditioning set of size {ell}")
            break
        budget = L.DEFAULT_CELL_BUDGET * ell * ell // m  # engines.run_level's rescale
        npr_b, n_chunk, total = L.plan_level(npr, ell, n, cell_budget=budget, n_cols=n)
        compact, counts = compact_rows(adj, n_prime=npr_b)
        ranks = torch.arange(n_chunk, dtype=torch.int32, device=dev)
        jc, _dof, mask, _ = L.g2_worklist(stats, adj, compact, counts, ranks, ell=ell,
                                          n_max=npr_b, r=r)
        print(f"ℓ={ell} chunk: max degree {npr} (bucket {npr_b}), {total} ranks, "
              f"chunk {n_chunk}, {int(mask.sum())} masked-in of {jc.shape[0]} cells")
        gsq_phase(f"ℓ={ell} chunk", jc, r**ell)
        del jc
        adj, sep, _ = engines.run_level(stats, adj, sep, ell, alpha, test=test)

    # ---------------------------------------------------------- end to end
    t0 = time.monotonic()
    first = pc(x_np, alpha=alpha, test="discrete")
    first_s = time.monotonic() - t0
    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.monotonic()
    run = pc(x_np, alpha=alpha, test="discrete")
    torch.cuda.synchronize()
    e2e_s = time.monotonic() - t0
    launches["gsq"] = build.LAUNCHES["gsq"]
    check((run.adj == first.adj).all() and (run.sepsets == first.sepsets).all(),
          "two runs of pc(x, test='discrete') on the card disagree")
    print(f"e2e pc(x, test='discrete') n={n} m={m}: {e2e_s:.3f} s (first run {first_s:.3f} s), "
          f"{run.levels_run} levels (cap {test.max_supported_level()}), "
          f"{int(run.adj.sum()) // 2} edges, timings {json.dumps(run.timings_s)}")
    for st in run.level_stats:
        print(f"  level {st['level']}: engine {st['engine']} max degree {st['npr']} "
              f"chunks {st['chunks']} {run.timings_s.get('level%d' % st['level'], 0.0):.4f} s")
    print(f"  launches {json.dumps(build.LAUNCHES)}")
    check(launches["gsq"] > 0 and all(st["engine"] == "G2-kernel" for st in run.level_stats),
          f"the discrete path did not run through gsq: {build.LAUNCHES}")
    for ell, cnt in certify_g2(run, x_np, r, alpha).items():
        print(f"  certificate ℓ={ell}: {cnt['checked']} recorded sepsets pass in float64, "
              f"{cnt['band']} of them in the p band, {cnt['fp32_undecidable']} past it but "
              "within their fp32 error bound")

    # the same codes on the card and on the host CPU
    ds = D_SMALL
    sx, _ = discrete_codes(sample_discrete_dag, ds)
    gpu = pc(sx, alpha=ds["alpha"], test="discrete")
    cpu = pc(sx, alpha=ds["alpha"], test="discrete", device="cpu")
    n_diff, unexplained = explain_g2_diffs(gpu, cpu, sx, int(sx.max()) + 1, ds["alpha"])
    same_cpdag = bool((gpu.cpdag == cpu.cpdag).all())
    print(f"  n={ds['n']} m={ds['m']} CUDA vs CPU: {n_diff} edges differ ({unexplained} outside "
          f"the p band), cpdag equal {same_cpdag}, {gpu.levels_run} levels, "
          f"{int(gpu.adj.sum()) // 2} edges")
    check(unexplained == 0, "discrete CUDA and CPU runs differ outside the p band")
    check(same_cpdag or n_diff > 0, "CPDAGs differ although skeleton and sepsets agree")

    do = D_ORACLE
    ox, _ = discrete_codes(sample_discrete_dag, do)
    got = pc(ox, alpha=do["alpha"], test="discrete", max_level=2)
    want = stable_ref.pc_stable_skeleton_discrete(ox, alpha=do["alpha"], max_level=2)
    same = bool((got.adj == want.adj).all())
    print(f"  n={do['n']} m={do['m']} against the float64 serial oracle at max_level 2: "
          f"skeleton equal {same}, {int(got.adj.sum()) // 2} edges")
    check(same, "the discrete skeleton differs from the float64 serial oracle")

if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseError as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
