"""Fixed-shape PC-stable over one graph or a batch: port of
``src/repro/batch/scan_pc.py``.

``core/pc.pc_from_corr`` is a host loop: each level reads the max degree
back, plans its chunks and dispatches them. For many-graph workloads
(bootstrap replicates, α sweeps, per-module datasets) that per-run host
work dominates, so ``pc_scan`` states the whole skeleton phase with
static shapes:

* the levels ℓ = 1..max_level run in order at a static width ``w_ℓ``
  (``n_prime``: one int, or a per-level schedule from ``plan_schedule``);
* each level is a masked sweep over all ``C(w_ℓ, ℓ)`` combo-ranks of the
  width-``w_ℓ`` compacted adjacency, in ``steps`` chunks of ``n_chunk``
  ranks (``_plan_chunk``, the reference's plan);
* the tests and the commit are the engines' own: on the card the fused
  skernel (``ops.chunk_s_kernel``, one launch a chunk and lane), the
  fused level-0 kernel and, where ``_use_dense_l1`` picks it, the dense
  level-1 kernel; on the CPU the "S" engine's ``levels.chunk_s`` and the
  reference's dense ℓ = 1 cube op for op. Results equal
  ``pc_from_corr(engine="S-kernel")`` on the card ("auto" when ℓ = 1 is
  dense) and ``engine="S"`` on the CPU, up to the level cap.

Chunk boundaries do not change results: the per-edge winner is the
whole-level least (rank, endpoint-order) key, so any chunking commits
the same sepsets (``core/levels.py``).

Exactness is certified per graph: ``ok`` is True iff every level's width
bounded the graph's live max degree (or the level was a no-op). Rows
wider than the schedule are degree-capped deterministically (their
sorted neighbour lists truncated at compaction); re-run flagged graphs
with ``n_prime=None`` for the exact result.

On the card each fixed-shape program is recorded once per static key as
CUDA graphs (``batch/capture.py``) and replayed with no host sync:
``pc_scan`` and ``pc_scan_batch`` record the whole skeleton phase of
every lane (level 0 and each level's sweeps); ``scan_levels_batch``
records one program per level, keyed like the reference's
``_build_level``, with one host sync per level for the whole batch. The
lanes of a batch run in turn. A program longer than one graph may hold
is cut into several at step boundaries (``capture.boundary``). Two
things differ from the reference: the kernels take τ as a launch
argument, so a graph bakes its τ vector in and one program is recorded
per τ vector (the reference's thresholds are trace data that serve
every α from one program); and orientation runs eagerly after the
replay, because the port's orientation synchronises with the host
(``torch.nonzero``, the Meek fixpoint's test).

Multi-device: the batch entries take ``mesh`` (``core/sharding.py``).
The batch axis is then padded to a shard multiple with identity-
correlation lanes (level 0 removes every edge, so each level is a masked
no-op for them) and split over the mesh; each shard runs its lanes on its
device (its own recorded program on the card) and the pad is dropped
from every output, which lands on the mesh's first device. Every shard's
program is queued before any host sync, so distinct cards overlap; the
level-synced driver still reads one max degree a level for the whole
batch. The cell budget divides by a shard's lanes, as in the reference,
and results are bitwise equal to ``mesh=None`` (chunking never changes
the committed winners). Shards on one card share its stream, so a
program recorded for one of them is replayed for the next only after
the last replay's outputs were copied out.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .. import device as D
from .. import obs
from ..core import levels as L
from ..core import sharding as S
from ..core.cit import DiscreteStats, fisher_z, threshold
from ..core.compact import compact_rows
from ..core.levels import DEFAULT_CELL_BUDGET, DEFAULT_JITTER
from ..core.orient import cpdag_from_skeleton
from ..kernels import ops
from . import capture

#: Default static level cap of the scan path. PC on bounded-degree graphs
#: rarely needs more; deeper runs pass max_level explicitly.
DEFAULT_MAX_LEVEL = 3


class ScanResult(NamedTuple):
    """Result of the scan (leading batch axis from the batch entries).

    adj:     (..., n, n) bool   skeleton
    cpdag:   (..., n, n) bool   CPDAG digraph (== adj when orient=False)
    sepsets: (..., n, n, Lmax) int32, -1 padded, -2 in slot 0 for level-0
             removals, as in ``core/pc.PCRun``.
    ok:      (...,) bool        per-graph exactness certificate: True iff
             the width schedule bounded this graph's live max degree at
             every level; False marks a degree-capped (approximate) run.
    max_degs: (..., max_level) int32, the live max degree at each level's
             start; max_degs[ℓ-1] - 1 < ℓ means the host driver would
             have stopped before level ℓ.
    ok_levels: (..., max_level) bool, the per-level factors of ``ok``;
             levels run through the dense ℓ = 1 cube are exact at any
             degree and report True.

    Retry contract: an ``ok=False`` graph was not silently corrupted, and
    re-running it with a schedule that bounds every level (or
    ``n_prime=None``) gives ``ok=True`` and the results of the
    unconstrained single-graph ``pc_scan``.
    """

    adj: torch.Tensor
    cpdag: torch.Tensor
    sepsets: torch.Tensor
    ok: torch.Tensor
    max_degs: torch.Tensor
    ok_levels: torch.Tensor


def _home(mesh, device) -> torch.device:
    """Where a batch entry's inputs and results live: the mesh's first
    device, or ``device`` (None: the CUDA card) without a mesh."""
    return mesh[0] if mesh is not None else D.resolve_device(device)


def _pad_shard_batch(cs, taus, mesh):
    """Pad the batch to a shard multiple with identity-correlation lanes
    (τ 1 at every level) and split it over the mesh. Returns (the shards'
    lanes, their (b_local, max_level+1) τ arrays, pad); without a mesh one
    shard of every lane."""
    if mesh is None:
        return [cs], [taus], 0
    pad = S.pad_amount(cs.shape[0], mesh)
    if pad:
        n = cs.shape[-1]
        eye = torch.eye(n, dtype=cs.dtype, device=cs.device).expand(pad, n, n)
        cs = torch.cat([cs, eye])
        taus = np.concatenate([taus, np.ones((pad, taus.shape[-1]), np.float32)])
    per = cs.shape[0] // S.mesh_size(mesh)
    return (list(S.shard_batch(cs, mesh)[0]),
            [taus[k * per:(k + 1) * per] for k in range(S.mesh_size(mesh))], pad)


def _unshard(parts, dev: torch.device, pad: int) -> torch.Tensor:
    """The shards' (b_local, ...) outputs as one batch on ``dev``, pad
    lanes dropped."""
    out = parts[0] if len(parts) == 1 else torch.cat([p.to(dev) for p in parts])
    return S.unpad_leading(out, pad)


def _lanes(cs, dev: torch.device) -> torch.Tensor:
    """Correlation matrices (..., n, n) as float32 on ``dev``."""
    t = cs if isinstance(cs, torch.Tensor) else torch.tensor(np.asarray(cs))
    return t.to(dev, torch.float32).contiguous()


# --------------------------------------------------------------------------
# static planning
# --------------------------------------------------------------------------
def plan_n_prime(cs, m: int, alpha: float = 0.01, tau0=None, device=None) -> int:
    """One static compact width valid for a whole batch of correlation
    matrices: the bucketed level-0 max degree over every graph. Always
    exact (``ok`` True) but conservative; ``plan_schedule`` finds tight
    per-level widths. One level-0 pass a lane and one host sync.

    ``tau0`` overrides the level-0 threshold of (m, alpha): a scalar or a
    (B,) vector of per-graph thresholds."""
    dev = D.resolve_device(device)
    cs = _lanes(cs, dev)
    if cs.ndim == 2:
        cs = cs[None]
    b, n = cs.shape[0], cs.shape[-1]
    tau0 = threshold(m, 0, alpha) if tau0 is None else tau0
    if isinstance(tau0, torch.Tensor):
        tau0 = tau0.cpu().numpy()
    tau0 = np.broadcast_to(np.asarray(tau0, np.float32), (b,))
    degs = torch.stack([L.max_degree(ops.level0(cs[k], float(tau0[k]))) for k in range(b)])
    npr = int(degs.max())
    return max(1, min(L.bucket_npr(npr), n))


def _plan_chunk(n: int, w: int, ell: int, cell_budget: int, m: int = 0):
    """Static (n_chunk, steps) of one level's rank sweep: the budget math
    of ``levels.plan_level``'s "S" branch with power-of-two chunks, or the
    exact length when the sweep fits one chunk. ``m > 0`` switches to the
    discrete G² cost model, whose (m, n·n_chunk·w) joint codes dominate."""
    total = math.comb(w, ell)
    if total == 0:
        return 0, 0
    if m > 0:
        per_rank_cells = n * w * m
    else:
        per_rank_cells = n * w * max(ell, 1) * max(ell, 1)
    budget_chunk = max(1, cell_budget // max(per_rank_cells, 1))
    if budget_chunk >= total:
        return total, 1
    n_chunk = max(1, min(L._pow2_ceil(total), L._pow2_floor(budget_chunk)))
    steps = -(-total // n_chunk)
    return n_chunk, steps


def _use_dense_l1(n: int, w: int, cell_budget: int) -> bool:
    """Level 1 on the dense (i, j, k) cube when compaction saves little
    (w near n) and n³ fits the (already B-divided) budget. Exact at any
    degree, so it never trips ``ok``."""
    return w * 2 >= n and n ** 3 <= cell_budget


def _level1_dense(c, adj, sep, tau):
    """Level 1 as one elementwise pass over the dense (i, j, k) cube, the
    reference's arithmetic op for op: ``levels.ci_sweep`` at ℓ = 1, where
    C[k, k] = 1 makes the inverse exact, then ``levels.commit_dense_l1``.
    Bitwise equal to ``levels.chunk_s`` at ℓ = 1 (the CPU path)."""
    n = c.shape[0]
    cik = c[:, None, :]  # C[i,k] over j
    cjk = c[None, :, :]  # C[j,k] over i
    g = 1.0 / torch.clamp(torch.ones((), dtype=c.dtype, device=c.device), min=1e-8)
    u_i = g * cik
    var_i = 1.0 - cik * u_i
    num = c[:, :, None] - cjk * u_i
    var_j = 1.0 - cjk * (g * cjk)
    rho = num / torch.sqrt(torch.clamp(var_i * var_j, min=1e-20))
    indep = fisher_z(rho) <= L._f32(tau)

    ks = torch.arange(n, dtype=torch.int32, device=c.device)
    mask = adj[:, None, :] & adj[:, :, None] & (ks[None, None, :] != ks[None, :, None])
    kwin = torch.where(indep & mask, ks, L._BIG).amin(dim=-1)
    return L.commit_dense_l1(adj, sep, kwin)


def _dense_l1(c, adj, sep, tau):
    """ℓ = 1 on the cube: the level-1 kernel and its commit on the card,
    the reference's cube on the CPU."""
    if c.device.type == "cpu":
        return _level1_dense(c, adj, sep, tau)
    _removed, kwin = ops.level1_dense(c, adj, tau)
    return L.commit_dense_l1(adj, sep, kwin)


def _as_schedule(n_prime, max_level: int, n: int) -> tuple:
    """Normalise int-or-tuple n_prime to a max_level-long width tuple."""
    if isinstance(n_prime, (tuple, list)):
        ws = [int(w) for w in n_prime]
        if len(ws) < max_level:
            ws += [ws[-1] if ws else n] * (max_level - len(ws))
        ws = ws[:max_level]
    else:
        ws = [int(n_prime)] * max_level
    return tuple(max(1, min(w, n)) for w in ws)


# --------------------------------------------------------------------------
# level sweeps
# --------------------------------------------------------------------------
def _sweep_plan(adj, w: int, steps: int, n_chunk: int):
    """The width-w compaction with counts clamped to w (rows wider than w
    are degree-capped) and every step's first rank, made on the device so
    that a capture copies nothing from the host."""
    compact, counts = compact_rows(adj, n_prime=w)
    t0s = torch.arange(steps, dtype=D.rank_dtype(), device=adj.device) * n_chunk
    return compact, counts.clamp(max=w), t0s


def _level_sweep(c, adj, sep, tau, *, ell: int, w: int, n_chunk: int, steps: int,
                 jitter: float = DEFAULT_JITTER):
    """One level's masked rank sweep at static width w: the fused skernel
    a step on the card, ``levels.chunk_s`` on the CPU."""
    compact, counts, t0s = _sweep_plan(adj, w, steps, n_chunk)
    chunk = L.chunk_s if c.device.type == "cpu" else ops.chunk_s_kernel
    for step in range(steps):
        adj, sep = chunk(c, adj, sep, compact, counts, t0s[step], tau, ell=ell,
                         n_chunk=n_chunk, n_max=w, jitter=jitter)
        capture.boundary()
    return adj, sep


def _level_sweep_g2(stats, adj, sep, alpha, *, ell: int, w: int, n_chunk: int, steps: int,
                    r: int):
    """Discrete twin of :func:`_level_sweep`: the G² worklist
    (``levels.chunk_g2``) through ``ops.gsq``, the gsq kernel on the card
    and its plain version on the CPU. The sets of every step are unranked
    once for the level (they depend on the ranks and the level's counts
    only): the unrank walk is w rounds of small ops, which a step would
    otherwise repeat, and a CUDA graph records every op of every step."""
    n = adj.shape[0]
    compact, counts, t0s = _sweep_plan(adj, w, steps, n_chunk)
    ranks = (t0s[:, None] + torch.arange(n_chunk, dtype=t0s.dtype, device=adj.device)).flatten()
    s_ids, valid = L.plan_sets(compact, counts, ranks, ell=ell, n_max=w, n=n)
    for step in range(steps):
        part = slice(step * n_chunk, (step + 1) * n_chunk)
        adj, sep = L.chunk_g2(stats, adj, sep, compact, counts, t0s[step], alpha, ell=ell,
                              n_chunk=n_chunk, n_max=w, r=r, gsq_fn=ops.gsq,
                              sets=(s_ids[:, part], valid[:, part]))
        capture.boundary()
    return adj, sep


def _level_ok(max_deg, ell: int, w: int):
    """Exactness of one level at width w: the width bounded the live max
    degree, or no row had enough neighbours for a test at this level."""
    return (max_deg <= w) | (max_deg <= ell)


# --------------------------------------------------------------------------
# the whole skeleton phase of one graph
# --------------------------------------------------------------------------
def _scan_core(c, taus: tuple, *, schedule: tuple, sepset_depth: int, cell_budget: int,
               jitter: float, test=None):
    """One graph's skeleton phase with static shapes and no host sync:
    (adj, sep, max_degs, ok_levels). ``taus`` holds the per-level decision
    scalars (Fisher-z thresholds; α per level for a discrete ``test``,
    whose ``DiscreteStats`` then ride in ``c`` and whose levels run the G²
    sweep, with no dense-ℓ=1 shortcut)."""
    discrete = test is not None
    if discrete:
        n = c.codes.shape[1]
        adj, sep, _ = test.level0_span(c, taus[0], sepset_depth)
    else:
        n = c.shape[0]
        adj, sep, _ = ops.level0_span(c, taus[0], sepset_depth)

    max_degs, ok_levels = [], []
    for ell, w in enumerate(schedule, start=1):
        max_deg = L.max_degree(adj)
        max_degs.append(max_deg)
        if not discrete and ell == 1 and _use_dense_l1(n, w, cell_budget):
            ok_levels.append(torch.ones((), dtype=torch.bool, device=adj.device))
            adj, sep = _dense_l1(c, adj, sep, taus[1])
            continue
        ok_levels.append(_level_ok(max_deg, ell, w))
        n_chunk, steps = _plan_chunk(n, w, ell, cell_budget, m=int(test.m) if discrete else 0)
        if steps == 0:
            continue  # C(w, ℓ) == 0: no work (ok still checked)
        if discrete:
            adj, sep = _level_sweep_g2(c, adj, sep, taus[ell], ell=ell, w=w, n_chunk=n_chunk,
                                       steps=steps, r=test.r)
        else:
            adj, sep = _level_sweep(c, adj, sep, taus[ell], ell=ell, w=w, n_chunk=n_chunk,
                                    steps=steps, jitter=jitter)

    dev = adj.device
    max_degs = (torch.stack(max_degs) if max_degs
                else torch.zeros((0,), dtype=torch.int32, device=dev))
    ok_levels = (torch.stack(ok_levels) if ok_levels
                 else torch.ones((0,), dtype=torch.bool, device=dev))
    return adj, sep, max_degs, ok_levels


def _stack_lanes(per_lane) -> tuple:
    return tuple(torch.stack(parts) for parts in zip(*per_lane))


def _execute(key: tuple, fn, inputs, widths=()) -> tuple:
    """``fn(*inputs)``: eagerly on the CPU; on the card through the CUDA
    graph recorded for ``key`` (plus the device). The binomial tables of
    the sweep widths are held by the program, since its graph reads them
    from ``levels._jtable``'s cache."""
    dev = inputs[0].device
    if dev.type == "cpu":
        return tuple(fn(*inputs))
    keep = [L._jtable(w, dt, dev) for w in sorted(set(widths))
            for dt in (torch.int32, torch.int64)]
    return capture.run(key + (str(dev),), fn, inputs, keep=keep)


def _as_key(a):
    return tuple(_as_key(v) for v in a) if isinstance(a, list) else a


def _lane_program(name: str, per_lane, lane_tau, arrays: tuple, widths=(), *key_extra) -> tuple:
    """``per_lane(*lane_arrays, τ)`` over every lane of the batched
    ``arrays``, stacked, as one program (CUDA graphs on the card) keyed
    by ``name``, ``key_extra``, the arrays' shapes and the lanes' τ (a
    scalar or a vector a lane), which the graphs bake in."""
    lane_tau = _as_key(np.asarray(lane_tau, np.float32).tolist())

    def program(*batched):
        return _stack_lanes(per_lane(*lane, t) for *lane, t in zip(*batched, lane_tau))

    key = (name, *key_extra, tuple(tuple(a.shape) for a in arrays), lane_tau)
    return _execute(key, program, arrays, widths)


def _orient_lanes(adj, sep):
    """Orientation of every lane (eager: it synchronises with the host)."""
    if adj.ndim == 2:
        return cpdag_from_skeleton(adj, sep)
    return torch.stack([cpdag_from_skeleton(a, s) for a, s in zip(adj, sep)])


def taus_for(m: int, alpha: float, max_level: int) -> tuple:
    """Per-level Fisher-z thresholds of one (m, alpha): max_level+1 floats."""
    return tuple(threshold(m, ell, alpha) for ell in range(max_level + 1))


def _levels_and_taus(max_level, sepset_depth: int, taus, default) -> tuple:
    """The level cap (None: DEFAULT_MAX_LEVEL) and the per-level τ as
    float32 (``default(max_level)`` when None), with the reference's
    errors: a cap past the sepset depth, a τ vector of the wrong length."""
    if max_level is None:
        max_level = DEFAULT_MAX_LEVEL
    if max_level > sepset_depth:
        raise ValueError(
            f"max_level={max_level} exceeds sepset_depth={sepset_depth}: "
            "sepsets of the deepest level would not fit"
        )
    if taus is None:
        taus = default(max_level)
    if isinstance(taus, torch.Tensor):
        taus = taus.cpu().numpy()
    taus = np.asarray(taus, np.float32)
    if taus.shape[-1] != max_level + 1:
        raise ValueError(
            f"taus must carry max_level+1={max_level + 1} per-level "
            f"thresholds; got shape {taus.shape}"
        )
    return max_level, taus


def _prep(c, m, alpha, max_level, sepset_depth, n_prime, taus=None, test=None, dev=None):
    discrete = test is not None
    n = int(c.codes.shape[-1]) if discrete else int(c.shape[-1])
    default = test.taus if discrete else (lambda lmax: taus_for(m, alpha, lmax))
    max_level, taus = _levels_and_taus(max_level, sepset_depth, taus, default)
    if n_prime is None:
        if discrete:
            test.check_level(max_level)
            adj0 = L.level0_g2(c, float(taus[0]), r=test.r)
            n_prime = max(1, min(L.bucket_npr(int(L.max_degree(adj0))), n))
        else:
            n_prime = plan_n_prime(c, m, alpha, tau0=taus[..., 0], device=dev)
    return taus, max_level, _as_schedule(n_prime, max_level, n)


def pc_scan(
    c,
    m: int,
    alpha: float = 0.01,
    max_level: int | None = None,
    sepset_depth: int = 8,
    n_prime=None,
    cell_budget: int = DEFAULT_CELL_BUDGET,
    orient: bool = True,
    taus=None,
    jitter: float = DEFAULT_JITTER,
    test=None,
    device=None,
) -> ScanResult:
    """PC-stable on one correlation matrix c (n, n) with static shapes.

    Equal skeleton and sepsets to ``pc_from_corr(engine="S-kernel",
    max_level=max_level)`` on the card ("auto" where ℓ = 1 runs dense) and
    to ``engine="S"`` on the CPU whenever ``ok`` is True, which the
    default ``n_prime=None`` guarantees (the exact level-0 degree bound,
    one host sync). ``n_prime`` may be an int or a per-level tuple from
    ``plan_schedule``; ``max_level=None`` uses DEFAULT_MAX_LEVEL.

    ``taus`` overrides the (m, alpha) thresholds with an explicit
    (max_level+1,) vector. ``jitter`` scales the Tikhonov term of the
    ℓ ≥ 2 inverses. A discrete ``test`` (``cit.DiscreteCITest``) switches
    to the G² sweep: ``c`` is then its ``DiscreteStats`` and ``taus``
    carry α per level.

    device: None means the CUDA card (raises without one), where the
    skeleton phase is recorded once per static key as CUDA graphs and
    replayed; "cpu" runs the plain versions eagerly.
    """
    dev = D.resolve_device(device)
    if test is not None and getattr(test, "kind", "gaussian") != "discrete":
        test = None  # Gaussian rides the default path
    if test is not None:
        c = DiscreteStats(codes=c.codes.to(dev, torch.int32),
                          arities=c.arities.to(dev, torch.int32))
        inputs = (c.codes, c.arities)
    else:
        c = _lanes(c, dev)
        if c.ndim != 2:
            raise ValueError(f"pc_scan expects one (n, n) matrix; got shape {tuple(c.shape)}")
        inputs = (c,)
    taus, max_level, schedule = _prep(c, m, alpha, max_level, sepset_depth, n_prime, taus,
                                      test=test, dev=dev)
    taus = tuple(float(t) for t in taus)
    static = dict(schedule=schedule, sepset_depth=int(sepset_depth),
                  cell_budget=int(cell_budget), jitter=float(jitter), test=test)

    def program(*arrays):
        stats = DiscreteStats(*arrays) if test is not None else arrays[0]
        return _scan_core(stats, taus, **static)

    key = ("pc_scan", tuple(inputs[0].shape), taus, *static.values())
    adj, sep, max_degs, ok_levels = _execute(key, program, inputs, schedule)
    cpdag = _orient_lanes(adj, sep) if orient else adj
    return ScanResult(adj=adj, cpdag=cpdag, sepsets=sep, ok=ok_levels.all(),
                      max_degs=max_degs, ok_levels=ok_levels)


def _run_batch(shards, shard_taus, pad, dev, *, schedule, sepset_depth, cell_budget, jitter,
               orient):
    """Every shard's lanes through one program each (CUDA graphs on the
    card), all queued before orientation, whose host syncs then wait on
    one shard's device at a time; the results as one batch on ``dev``."""
    static = dict(schedule=schedule, sepset_depth=int(sepset_depth),
                  cell_budget=int(cell_budget), jitter=float(jitter))
    parts = [_lane_program("pc_scan_batch", lambda c, t: _scan_core(c, t, **static), taus,
                           (cs,), schedule, *static.values())
             for cs, taus in zip(shards, shard_taus)]
    parts = [(*p, _orient_lanes(p[0], p[1]) if orient else p[0]) for p in parts]
    adj, sep, max_degs, ok_levels, cpdag = (_unshard(list(f), dev, pad) for f in zip(*parts))
    return ScanResult(adj=adj, cpdag=cpdag, sepsets=sep, ok=ok_levels.all(dim=-1),
                      max_degs=max_degs, ok_levels=ok_levels)


def pc_scan_batch(
    cs,
    m: int,
    alpha: float = 0.01,
    max_level: int | None = None,
    sepset_depth: int = 8,
    n_prime=None,
    cell_budget: int = DEFAULT_CELL_BUDGET,
    orient: bool = True,
    mesh=None,
    taus=None,
    jitter: float = DEFAULT_JITTER,
    test=None,
    device=None,
) -> ScanResult:
    """``pc_scan`` over a leading batch axis: cs (B, n, n).

    One program a (B, n, static arguments) learns all B graphs; on the
    card it is recorded once as CUDA graphs, replayed per call. Pass
    ``n_prime=plan_schedule(...)`` for tight per-level widths (per-graph
    ``ok`` certifies exactness) or None for the always-exact level-0
    bound. The cell budget is divided by B (floor 2¹⁶), as in the
    reference, so plans and schedules equal the reference's.

    ``taus``: per-graph per-level thresholds, (B, max_level+1) or
    (max_level+1,) for every lane: lanes may carry different (m, alpha).

    ``mesh`` (``core/sharding.py``): shard the batch axis over the mesh
    (identity lanes pad B to a shard multiple; results on the mesh's first
    device, bitwise equal to mesh=None); the budget then divides by a
    shard's lanes. ``device`` is ignored with a mesh.
    """
    if test is not None and getattr(test, "kind", "gaussian") == "discrete":
        raise NotImplementedError(
            "pc_scan_batch is Gaussian-only for now: batching the discrete "
            "G² sweep needs a per-lane DiscreteStats layout — run graphs "
            "through pc_scan(test=...) individually"
        )
    dev = _home(mesh, device)
    cs = _lanes(cs, dev)
    if cs.ndim != 3:
        raise ValueError(f"pc_scan_batch expects (B, n, n); got shape {tuple(cs.shape)}")
    b = int(cs.shape[0])
    with obs.span("pc_scan_batch", batch=b, n=int(cs.shape[1]),
                  sharded=mesh is not None) as sp:
        taus, max_level, schedule = _prep(cs, m, alpha, max_level, sepset_depth, n_prime, taus,
                                          dev=dev)
        shards, shard_taus, pad = _pad_shard_batch(
            cs, np.broadcast_to(taus, (b, max_level + 1)), mesh)
        budget = max(int(cell_budget) // max(shards[0].shape[0], 1), 2**16)
        res = _run_batch(shards, shard_taus, pad, dev, schedule=schedule,
                         sepset_depth=sepset_depth, cell_budget=budget, jitter=jitter,
                         orient=orient)
        sp.set(schedule=list(schedule)).sync(res.adj)
    return res


def alpha_sweep(
    c,
    m: int,
    alphas,
    max_level: int | None = None,
    sepset_depth: int = 8,
    n_prime=None,
    cell_budget: int = DEFAULT_CELL_BUDGET,
    orient: bool = True,
    mesh=None,
    jitter: float = DEFAULT_JITTER,
    device=None,
) -> ScanResult:
    """Significance-level sweep over one correlation matrix: lane k equals
    ``pc_scan(c, m, alpha=alphas[k])``, with C shared by the lanes of one
    program. ``n_prime=None`` plans the level-0 bound at ``max(alphas)``:
    the loosest test keeps a superset of every lane's level-0 edges, so
    the sweep is exact (``ok`` all True). The ParallelPC workload
    (PAPERS.md, arXiv 1510.03042). ``mesh`` shards the α lanes."""
    dev = _home(mesh, device)
    c = _lanes(c, dev)
    if c.ndim != 2:
        raise ValueError(f"alpha_sweep expects one (n, n) matrix; got {tuple(c.shape)}")
    alphas = [float(a) for a in alphas]
    if not alphas:
        raise ValueError("alpha_sweep needs at least one alpha")
    lmax = DEFAULT_MAX_LEVEL if max_level is None else max_level
    taus = np.asarray([taus_for(m, a, lmax) for a in alphas], np.float32)
    if n_prime is None:
        n_prime = plan_n_prime(c, m, alpha=max(alphas), device=dev)
    return pc_scan_batch(
        c.expand(len(alphas), *c.shape), m, max_level=lmax, sepset_depth=sepset_depth,
        n_prime=n_prime, cell_budget=cell_budget, orient=orient, mesh=mesh, taus=taus,
        jitter=jitter, device=dev,
    )


# --------------------------------------------------------------------------
# level-synced batch driver + schedule planning
# --------------------------------------------------------------------------
def _batch_init(cs, tau0, depth: int):
    """Level 0 and the sepset tensor of every lane (one fused level-0
    launch a lane on the card); tau0 (B,) floats."""
    return _lane_program("batch_init", lambda c, t: ops.level0_span(c, t, depth)[:2], tau0,
                         (cs,), (), int(depth))


def _batch_level(cs, adj, sep, lane_tau, *, ell: int, w: int, n_chunk: int, steps: int):
    """One level of every lane as one program (CUDA graphs on the card),
    keyed like the reference's ``_build_level`` plus the batch shape and
    the lanes' τ."""
    def sweep(c, a, s, t):
        return _level_sweep(c, a, s, t, ell=ell, w=w, n_chunk=n_chunk, steps=steps)

    return _lane_program("scan_level", sweep, lane_tau, (cs, adj, sep), (w,), ell, w, n_chunk,
                         steps)


def _batch_dense_l1(cs, adj, sep, lane_tau):
    return _lane_program("dense_l1", _dense_l1, lane_tau, (cs, adj, sep))


def scan_levels_batch(
    cs,
    m: int,
    alpha: float = 0.01,
    max_level: int | None = None,
    sepset_depth: int = 8,
    cell_budget: int = DEFAULT_CELL_BUDGET,
    orient: bool = True,
    bucket: bool = True,
    mesh=None,
    taus=None,
    device=None,
):
    """Batch PC with per-level re-planning: one host sync per level for all
    B graphs (the sequential loop pays B a level).

    Each level's static width is the (bucketed, or exact with
    ``bucket=False``) live max degree across the batch, so every result is
    exact (``ok`` all True), and each level's program recurs across calls
    through its (ℓ, w, n_chunk, steps) key. Returns ``(ScanResult,
    schedule)``; the schedule replays the same workload through
    ``pc_scan_batch`` with no level syncs. ``taus``: per-graph (B,
    max_level+1) thresholds, as in :func:`pc_scan_batch`. ``mesh`` shards
    the batch axis as :func:`pc_scan_batch` does; a level's width is still
    one read of the whole batch's max degree.
    """
    dev = _home(mesh, device)
    cs = _lanes(cs, dev)
    if cs.ndim != 3:
        raise ValueError(f"scan_levels_batch expects (B, n, n); got {tuple(cs.shape)}")
    b, n = int(cs.shape[0]), int(cs.shape[-1])
    max_level, taus = _levels_and_taus(max_level, sepset_depth, taus,
                                       lambda lmax: taus_for(m, alpha, lmax))
    shards, shard_taus, pad = _pad_shard_batch(cs, np.broadcast_to(taus, (b, max_level + 1)),
                                               mesh)
    budget = max(int(cell_budget) // max(shards[0].shape[0], 1), 2**16)

    state = [_batch_init(c, t[:, 0], sepset_depth) for c, t in zip(shards, shard_taus)]

    schedule, max_degs = [], []
    for ell in range(1, max_level + 1):
        degs = [a.sum(dim=-1, dtype=torch.int32).amax(dim=-1) for a, _ in state]  # (b_local,)
        max_degs.append(degs)
        # the level's one host sync, over every shard
        max_deg = int(torch.stack([d.max().to(dev) for d in degs]).max())
        w = max(1, min(L.bucket_npr(max_deg) if bucket else max_deg, n))
        schedule.append(w)
        if max_deg - 1 < ell:
            continue  # no graph can run this level; keep probing widths
        if ell == 1 and _use_dense_l1(n, w, budget):
            state = [_batch_dense_l1(c, a, s, t[:, 1])
                     for c, t, (a, s) in zip(shards, shard_taus, state)]
            continue
        n_chunk, steps = _plan_chunk(n, w, ell, budget)
        if steps == 0:
            continue
        state = [_batch_level(c, a, s, t[:, ell], ell=ell, w=w, n_chunk=n_chunk, steps=steps)
                 for c, t, (a, s) in zip(shards, shard_taus, state)]

    adj = _unshard([a for a, _ in state], dev, pad)
    sep = _unshard([s for _, s in state], dev, pad)
    cpdag = _unshard([_orient_lanes(a, s) if orient else a for a, s in state], dev, pad)
    ok = torch.ones((b,), dtype=torch.bool, device=dev)  # widths track the live bound
    ok_levels = torch.ones((b, len(schedule)), dtype=torch.bool, device=dev)
    max_degs = (torch.stack([_unshard(d, dev, pad) for d in max_degs], dim=-1) if max_degs
                else torch.zeros((b, 0), dtype=torch.int32, device=dev))
    return ScanResult(adj=adj, cpdag=cpdag, sepsets=sep, ok=ok, max_degs=max_degs,
                      ok_levels=ok_levels), tuple(schedule)


def plan_schedule(
    cs,
    m: int,
    alpha: float = 0.01,
    max_level: int | None = None,
    sepset_depth: int = 8,
    cell_budget: int = DEFAULT_CELL_BUDGET,
    bucket: bool = True,
    mesh=None,
    taus=None,
    device=None,
) -> tuple:
    """Tight per-level width schedule for a batched workload: the widths
    the level-synced driver discovers in one run. Plan on a pilot batch,
    then serve later batches through ``pc_scan_batch`` and re-run the rare
    ``ok=False`` stragglers with ``n_prime=None``. ``mesh`` shards the
    planning pass's batch axis."""
    _, schedule = scan_levels_batch(
        cs, m, alpha=alpha, max_level=max_level, sepset_depth=sepset_depth,
        cell_budget=cell_budget, orient=False, bucket=bucket, mesh=mesh, taus=taus,
        device=device,
    )
    return schedule
