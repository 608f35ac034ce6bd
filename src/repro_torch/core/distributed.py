"""Multi-device PC-stable: row-sharded cuPC-S (port of
``src/repro/core/distributed.py``).

One process owns the mesh (``core/sharding.py``), as the reference's
single controller does, and returns whole results to one caller. Rows of
the compacted adjacency are sharded over the mesh; within a level the
tests of different rows are independent, so the only traffic is

  1. the all-gather of each chunk's per-row winner arrays (t_win,
     removed_slot, s_win), a ``torch.cat`` of the shards' blocks moved to
     each device of the mesh: O(n · n′ · ℓ) ints;
  2. the replicated adjacency commit (a removal must reach both
     endpoints' rows), which every device computes from the gathered
     winners.

Each shard's tensors live on its own device, and launches are
asynchronous, so one host thread keeps every card busy; each distinct
device runs on its own (current) stream, and shards that share a device
share its stream, in mesh order. A mesh may repeat a device: K logical
shards on one card or on the CPU run every sharded code path.

Every chunk is two dispatches, the tests over all shards and the commit,
so ``pipeline_depth`` chunks' tests may run ahead of the commits: tests
read only an alive snapshot of the adjacency, and a stale snapshot adds
claims on removed edges alone, which the chained commit discards. With
``engine="S-grid"`` each launch sweeps all its ranks in one sgrid kernel
a shard (the fused entry; ``ops.chunk_s_grid_tests_cols`` with sharded
C) and commits at once: normally one dispatch a level. ``speculate=True``
sends level ℓ+1's first grid launch out under level ℓ's width while the
level's max-degree read is in flight (:func:`_speculative_dispatch`).

State layouts, every combination bitwise equal to the single-device "S"
engine:

* C replicated (default): one (n, n) C a device;
* C row-sharded (``shard_c``): each shard keeps its (n_pad/K, n) rows of
  C, and the active columns C[:, cols] (cols: the vertices of degree ≥ 1,
  every id a test reads through a column) are gathered once a run into
  the :class:`ColumnCache` and subset at later levels;
* sepsets row-sharded (``shard_sep``): each shard keeps its
  (n_pad/K, n, depth) rows and commits them locally
  (``levels.commit_sep_rows``); the (n, n) bool adjacency commit is the
  one replicated commit left. The n-row global view is assembled for
  ``checkpoint_cb`` and the result.

Fault tolerance: (adj, sep) after a level is a complete checkpoint, and
``resume=`` replays from it.
"""
from __future__ import annotations

from collections import deque

import numpy as np
import torch

from .. import device as D
from .. import obs
from . import levels as L
from . import sharding as S
from .compact import compact_rows
from .sharding import Mesh, Sharded


def pc_mesh(devices=None) -> Mesh:
    """Flat mesh over ``devices`` (default: every visible card); the PC
    row axis."""
    return S.make_mesh(devices=devices)


def shard_correlation(c: torch.Tensor, mesh: Mesh) -> Sharded:
    """C row-sharded for ``shard_c`` runs: rows padded to a shard multiple,
    in the compacted adjacency's layout; (n_pad/K, n) a shard."""
    return S.shard_rows(c.to(torch.float32), mesh)[0]


def _rep(x, mesh: Mesh) -> Sharded:
    """x replicated on the mesh (as given when it already is)."""
    return x if isinstance(x, Sharded) else S.replicate(x, mesh)


def _per_device(mesh: Mesh, make) -> Sharded:
    """A replicated value built once a distinct device by ``make(dev)``."""
    made = {dev: make(dev) for dev in mesh.distinct()}
    first = made[mesh[0]]
    return Sharded([made[dev] for dev in mesh], S.replicated_spec(mesh), first.shape)


def _transposes(c: Sharded, mesh: Mesh):
    """Cᵀ on each distinct device of a replicated C, which the fused sgrid
    reads C[j, S] along the rows of; None on the CPU, whose plain version
    reads C itself."""
    if mesh[0].type != "cuda":
        return None
    return _per_device(mesh, lambda dev: c[mesh.index(dev)].T.contiguous())


def _all_gather(blocks, mesh: Mesh) -> dict:
    """The shards' row blocks concatenated in mesh order, one copy a
    distinct device: {device: tensor}."""
    return {dev: torch.cat([b.to(dev) for b in blocks], dim=0) for dev in mesh.distinct()}


def _active_columns(counts_host: np.ndarray, n: int):
    """Host plan of the sharded-C column gather: every id a test reads
    through a column (set members and tested neighbours j) has degree ≥ 1.
    cols is that set, padded to a bucketed width k with copies of cols[0]
    (whose gathered values are identical, so they change nothing).
    Returns (cols (k,) int32, col_pos (n,) int32, k)."""
    cols = np.flatnonzero(counts_host[:n] > 0).astype(np.int32)
    k = max(1, min(L.bucket_npr(len(cols)), n))
    col_pos = np.zeros(n, np.int32)
    col_pos[cols] = np.arange(len(cols), dtype=np.int32)
    if len(cols) < k:
        cols = np.concatenate([cols, np.full(k - len(cols), cols[0], np.int32)])
    return cols[:k], col_pos, k


def _gather_cols(c_rows: Sharded, mesh: Mesh, cols: np.ndarray) -> Sharded:
    """The column all-gather: each shard's (n_l, k) slice C[rows, cols],
    concatenated to the replicated (n_pad, k) block C[:, cols]."""
    cols_t = S.replicate(torch.from_numpy(cols), mesh)
    made = _all_gather([blk[:, idx.long()] for blk, idx in zip(c_rows, cols_t)], mesh)
    return Sharded([made[dev] for dev in mesh], S.replicated_spec(mesh),
                   (c_rows.shape[0], len(cols)))


class ColumnCache:
    """A run's active-column block for the row-sharded C layout.

    C is constant for a run and the active set (degree ≥ 1) only shrinks,
    so a block gathered once stays a superset: each level recomputes cols
    from the fresh degrees and, when they lie inside the cached set
    (always, by degree monotonicity), subsets the block locally
    (``levels.subset_cols``); the first level (or a resume) pays the one
    gather. The values are a fresh gather's, so results are unchanged.
    ``gathers`` counts the column gathers of the run."""

    def __init__(self):
        self.c_cols = None  # replicated (n_pad, k) block
        self.member = None  # (n,) bool: ids in the cached cols
        self.col_pos = None  # (n,) int32: id → place in the block
        self.col_pos_dev = None  # col_pos on every device
        self.gathers = 0

    def level_block(self, c_rows: Sharded, mesh: Mesh, counts_host: np.ndarray, n: int):
        """The level's (c_cols, col_pos, k, level_gathers): a subset of the
        cache when it covers the level, else one gather (counted)."""
        cols, col_pos, k = _active_columns(counts_host, n)
        real = np.flatnonzero(counts_host[:n] > 0)
        level_gathers = 0
        if self.c_cols is not None and bool(np.all(self.member[real])):
            pos = S.replicate(torch.from_numpy(self.col_pos[cols]), mesh)
            c_cols = Sharded([L.subset_cols(blk, p) for blk, p in zip(self.c_cols, pos)],
                             S.replicated_spec(mesh), (self.c_cols.shape[0], k))
        else:
            c_cols = _gather_cols(c_rows, mesh, cols)
            self.gathers += 1
            level_gathers = 1
        self.c_cols = c_cols
        self.member = np.zeros(n, bool)
        self.member[real] = True
        self.col_pos = col_pos
        self.col_pos_dev = S.replicate(torch.from_numpy(col_pos), mesh)
        return c_cols, col_pos, k, level_gathers


def _shard_rows_ids(mesh: Mesh, n_l: int) -> list:
    """Each shard's global row ids, int32 on its device."""
    return [torch.arange(k * n_l, (k + 1) * n_l, dtype=torch.int32, device=dev)
            for k, dev in enumerate(mesh)]


def _gather_winners(per_shard, mesh: Mesh) -> dict:
    """The all-gather of the tests' per-row winners: {device: (t_win,
    removed_slot, s_win)} at full (n_pad, …) width on every device, the
    only per-chunk traffic besides a cached column gather."""
    parts = list(zip(*per_shard))
    gathered = [_all_gather(p, mesh) for p in parts]
    return {dev: tuple(g[dev] for g in gathered) for dev in mesh.distinct()}


class _Level:
    """One level's placement: the compaction of every device's adjacency
    copy at width ``npr_b``, its row blocks and the shards' row ids."""

    def __init__(self, adj: Sharded, mesh: Mesh, npr_b: int):
        n = adj.shape[0]
        per = {}
        for dev, a in zip(mesh, adj):
            if dev not in per:
                compact, counts = compact_rows(a, n_prime=npr_b)
                per[dev] = (compact, S.pad_leading(compact, mesh, fill=-1)[0],
                            S.pad_leading(counts, mesh)[0])
        n_l = S.per_device_rows(n, mesh)
        self.compact_rep = [per[dev][0] for dev in mesh]
        self.compact = [per[dev][1][k * n_l:(k + 1) * n_l] for k, dev in enumerate(mesh)]
        self.counts = [per[dev][2][k * n_l:(k + 1) * n_l] for k, dev in enumerate(mesh)]
        self.rows = _shard_rows_ids(mesh, n_l)


def _commit(adj: Sharded, sep: Sharded, mesh: Mesh, lv: _Level, winners: dict, *, ell: int,
            shard_sep: bool, npr_b: int | None = None):
    """Apply one chunk's gathered winners (sliced to width ``npr_b`` when
    given) to the chained (adj, sep). Replicated sepsets: every device runs
    ``levels._global_commit``. Row-sharded sepsets: every device computes
    the key matrix and the adjacency commit (``levels.commit_adj``), and
    each shard its own sepset rows (``levels.commit_sep_rows``) against
    the pre-commit adjacency. Gathered rows past n (pad) hold no claims."""
    n = adj.shape[0]
    new_adj, new_sep, keys = {}, {}, {}
    for k, dev in enumerate(mesh):
        if dev in new_adj:
            continue
        t_win, rem, s_win = (w[:n, :npr_b] if npr_b is not None else w[:n]
                             for w in winners[dev])
        rows = torch.arange(n, dtype=torch.int32, device=dev)
        if not shard_sep:
            new_adj[dev], new_sep[dev] = L._global_commit(adj[k], sep[k], lv.compact_rep[k], rows,
                                                          t_win, rem, s_win, ell)
        else:
            _, key_mat = L._commit_key_mat(lv.compact_rep[k], rows, t_win, rem, n)
            keys[dev] = (key_mat, rem, s_win)
            new_adj[dev] = L.commit_adj(adj[k], key_mat)
    if shard_sep:
        blocks = []
        for k, dev in enumerate(mesh):
            key_mat, rem, s_win = keys[dev]
            blocks.append(L.commit_sep_rows(sep[k], lv.rows[k], adj[k], key_mat,
                                            lv.compact_rep[k], rem, s_win, ell))
        sep_out = Sharded(blocks, sep.sharding, sep.shape)
    else:
        sep_out = Sharded([new_sep[dev] for dev in mesh], sep.sharding, sep.shape)
    return Sharded([new_adj[dev] for dev in mesh], adj.sharding, adj.shape), sep_out


def _grid_tests(c, adj, lv: _Level, t0s: dict, i: int, tau, *, ell, n_chunk, npr_b, shard_c,
                c_cols=None, col_pos=None, c_t=None):
    """Every shard's grid launch of ranks [t0, t0 + n_chunk): the fused
    sgrid entry over the replicated C, or the gathered entry over the
    shard's rows of C and the column block."""
    from repro_torch.kernels import ops

    out = []
    for k, dev in enumerate(c.sharding.mesh):
        kw = dict(ell=ell, n_chunk=n_chunk, n_max=npr_b)
        t0 = t0s[dev][i]
        if shard_c:
            out.append(ops.chunk_s_grid_tests_cols(c[k], c_cols[k], col_pos[k], adj[k],
                                                   lv.compact[k], lv.counts[k], lv.rows[k], t0,
                                                   tau, **kw))
        else:
            out.append(ops.chunk_s_grid_tests(c[k], adj[k], lv.compact[k], lv.counts[k],
                                              lv.rows[k], t0, tau,
                                              c_t=None if c_t is None else c_t[k], **kw))
    return out


def _s_tests(c, adj, lv: _Level, t0s: dict, i: int, tau, *, ell, n_chunk, npr_b, shard_c,
             c_cols=None, col_pos=None):
    """Every shard's "S" tests of ranks [t0, t0 + n_chunk): (t_win,
    removed_slot, s_win) of its rows, from the replicated C or from its
    rows of C and the column block (``levels._tests_s_cols``)."""
    out = []
    for k, dev in enumerate(c.sharding.mesh):
        ranks = L._chunk_ranks(t0s[dev][i], n_chunk)
        if shard_c:
            found, s_ids = L._tests_s_cols(c[k], c_cols[k], col_pos[k], adj[k], lv.compact[k],
                                           lv.counts[k], lv.rows[k], ranks, tau, ell=ell,
                                           n_max=npr_b)
        else:
            found, s_ids = L._tests_s(c[k], adj[k], lv.compact[k], lv.counts[k], lv.rows[k],
                                      ranks, tau, ell=ell, n_max=npr_b)
        out.append(L._winners(found, ranks, s_ids))
    return out


def _rank_starts(mesh: Mesh, start: int, total: int, step: int, rank_dtype) -> dict:
    """Every launch's first rank as a device tensor a distinct device (made
    on the device: no host copy in the chunk loop)."""
    return {dev: torch.arange(start, max(total, start), step, dtype=rank_dtype, device=dev)
            for dev in mesh.distinct()}


def run_level_sharded(c, adj, sep, ell: int, tau: float, mesh: Mesh,
                      cell_budget: int = L.DEFAULT_CELL_BUDGET, bucket: bool = True,
                      shard_c: bool = False, shard_sep: bool = False, pipeline_depth: int = 1,
                      col_cache: ColumnCache | None = None, engine: str = "S",
                      spec: dict | None = None, rank_dtype: torch.dtype = torch.int32,
                      c_t=None):
    """The sharded counterpart of ``levels.run_level`` on the same chunk
    planner, sized by a shard's rows. Returns (adj, sep, stats) with adj
    replicated and sep in its layout.

    c: the replicated C (a tensor is replicated here), or with ``shard_c``
    the row-sharded C of :func:`shard_correlation`. adj: the adjacency (a
    tensor, or replicated). sep: the sepset tensor, or with ``shard_sep``
    the row-sharded one (``sharding.shard_rows(sep, mesh, fill=-1)``).
    pipeline_depth: chunks' tests issued before the oldest commit (equal
    results at any depth). col_cache: the run's :class:`ColumnCache`
    (``shard_c``); None gathers the columns in every chunk. engine: "S"
    (chunked tests and commits, pipelined) or "S-grid" (one sgrid launch a
    shard and its commit per launch, normally one a level). spec: a
    speculative first launch from :func:`_speculative_dispatch`, made
    under the previous level's width; its winners are sliced to this
    level's (equal or narrower) width, exact because slots past a row's
    degree hold no claims. c_t: Cᵀ on each device (replicated), which the
    fused sgrid reads; made here when needed and not given."""
    n = adj.shape[0]
    n_dev = S.mesh_size(mesh)
    adj = _rep(adj, mesh)
    if not shard_c:
        c = _rep(c, mesh)
    if not shard_sep:
        sep = _rep(sep, mesh)
    grid = str(engine).upper() == "S-GRID"
    if grid and cell_budget == L.DEFAULT_CELL_BUDGET:
        cell_budget = L.GRID_CELL_BUDGET  # see levels.GRID_CELL_BUDGET
    counts_host = adj[0].sum(dim=1, dtype=torch.int32).cpu().numpy()
    npr = int(counts_host.max(initial=0))
    if npr - 1 < ell:
        return adj, sep, {"skipped": True, "chunks": 0, "dispatches": 0, "npr": npr}

    pad = S.pad_amount(n, mesh)
    npr_b, n_chunk, total = L.plan_level(npr, ell, max((n + pad) // n_dev, 1), engine="S",
                                         cell_budget=cell_budget, bucket=bucket, n_cols=n,
                                         rank_dtype=rank_dtype)
    lv = _Level(adj, mesh, npr_b)
    depth = max(1, int(pipeline_depth))
    stats = {"skipped": False, "npr": npr, "npr_bucket": npr_b, "n_chunk": n_chunk,
             "total_sets": total, "shard_c": shard_c, "shard_sep": shard_sep,
             "pipeline_depth": 1 if grid else depth, "engine": "S-grid" if grid else "S",
             "compile_key": (ell, n_chunk, npr_b)}
    kw = dict(ell=ell, n_chunk=n_chunk, npr_b=npr_b, shard_c=shard_c)
    cols = None
    if shard_c:
        if col_cache is not None:
            kw["c_cols"], _, k, stats["col_gathers"] = col_cache.level_block(c, mesh,
                                                                             counts_host, n)
            kw["col_pos"] = col_cache.col_pos_dev
        else:
            cols, col_pos, k = _active_columns(counts_host, n)
            kw["col_pos"] = S.replicate(torch.from_numpy(col_pos), mesh)
        stats["k_cols"] = k
        stats["c_sharding"] = str(c.sharding)
    elif grid and c_t is None:
        c_t = _transposes(c, mesh)

    def tests(t0s, i):
        if cols is not None:  # the per-chunk column gather (no cache)
            kw["c_cols"] = _gather_cols(c, mesh, cols)
        if grid:
            return _grid_tests(c, adj, lv, t0s, i, tau, c_t=c_t, **kw)
        return _s_tests(c, adj, lv, t0s, i, tau, **kw)

    chunks = 0
    dispatches = 0
    if grid:
        t_next = 0
        if spec is not None and spec.get("ell") == ell and spec["npr_b"] >= npr_b:
            adj, sep = _commit(adj, sep, mesh, lv, spec["winners"], ell=ell,
                               shard_sep=shard_sep, npr_b=npr_b)
            chunks += 1
            dispatches += 1  # the commit; the tests ran under the sync
            t_next = spec["n_chunk"]
            stats["speculative"] = True
        t0s = _rank_starts(mesh, t_next, total, n_chunk, rank_dtype)
        for i in range(t0s[mesh[0]].shape[0]):
            adj, sep = _commit(adj, sep, mesh, lv, _gather_winners(tests(t0s, i), mesh),
                               ell=ell, shard_sep=shard_sep)
            chunks += 1
            dispatches += 1
    else:
        t0s = _rank_starts(mesh, 0, total, n_chunk, rank_dtype)
        pending: deque = deque()
        for i in range(t0s[mesh[0]].shape[0]):
            pending.append(_gather_winners(tests(t0s, i), mesh))
            chunks += 1
            if len(pending) >= depth:
                adj, sep = _commit(adj, sep, mesh, lv, pending.popleft(), ell=ell,
                                   shard_sep=shard_sep)
        while pending:
            adj, sep = _commit(adj, sep, mesh, lv, pending.popleft(), ell=ell,
                               shard_sep=shard_sep)
        dispatches = 2 * chunks  # one tests and one commit program a chunk

    stats["chunks"] = chunks
    stats["dispatches"] = dispatches
    if shard_c:
        if col_cache is None:
            stats["col_gathers"] = chunks  # one column gather a chunk
        # bytes the column gathers moved this level (fp32)
        stats["col_gather_bytes"] = stats["col_gathers"] * (n + pad) * k * 4
    obs.record_level_stats(stats, level=ell, layout="sharded")
    return adj, sep, stats


def _speculative_dispatch(c, adj: Sharded, ell: int, tau: float, mesh: Mesh, prev_npr_b: int,
                          n: int, shard_c: bool, col_cache, cell_budget: int, bucket: bool,
                          rank_dtype: torch.dtype = torch.int32, c_t=None):
    """Level ``ell``'s first grid launch issued BEFORE its max-degree read
    resolves, at the previous level's width (degrees only shrink, so it
    bounds this level's). Nothing here reads the device: the compaction,
    its row blocks, the first rank and the launches are all queued, so the
    read overlaps this work. :func:`run_level_sharded` consumes the
    winners (sliced to the level's width) or the run drops them.

    With ``shard_c`` the launches read the run's cached column block (a
    superset of this level's columns, with a fresh gather's values); no
    cache means no speculation. Returns the spec dict or None."""
    n_dev = S.mesh_size(mesh)
    pad = S.pad_amount(n, mesh)
    if cell_budget == L.DEFAULT_CELL_BUDGET:
        cell_budget = L.GRID_CELL_BUDGET  # run_level_sharded's budget
    try:
        npr_b, n_chunk, _ = L.plan_level(prev_npr_b, ell, max((n + pad) // n_dev, 1),
                                         engine="S", cell_budget=cell_budget, bucket=bucket,
                                         n_cols=n, rank_dtype=rank_dtype)
    except ValueError:  # rank capacity: the level itself raises or stops
        return None
    kw = dict(ell=ell, n_chunk=n_chunk, npr_b=npr_b, shard_c=shard_c)
    if shard_c:
        if col_cache is None or col_cache.c_cols is None:
            return None
        kw.update(c_cols=col_cache.c_cols, col_pos=col_cache.col_pos_dev)
    lv = _Level(adj, mesh, npr_b)
    t0s = {dev: torch.zeros((1,), dtype=rank_dtype, device=dev) for dev in mesh.distinct()}
    winners = _gather_winners(_grid_tests(c, adj, lv, t0s, 0, tau, c_t=c_t, **kw), mesh)
    return {"ell": ell, "npr_b": npr_b, "n_chunk": n_chunk, "winners": winners}


def _degree_reader(deg: torch.Tensor):
    """Start reading a 0-d device int: on the card a ``non_blocking`` copy
    into pinned memory behind an event recorded now, so work queued after
    this call does not delay the read. Returns a function giving the int."""
    if deg.device.type != "cuda":
        value = int(deg)
        return lambda: value
    host = torch.empty((), dtype=deg.dtype, pin_memory=True)
    host.copy_(deg, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(deg.device))

    def read() -> int:
        done.synchronize()
        return int(host)

    return read


def pc_distributed(x=None, c=None, m: int | None = None, alpha: float = 0.01,
                   mesh: Mesh | None = None, max_level: int | None = None,
                   sepset_depth: int = 8, cell_budget: int = L.DEFAULT_CELL_BUDGET,
                   checkpoint_cb=None, resume=None, bucket: bool = True,
                   shard_c: bool = False, shard_sep: bool = False, cache_cols: bool = True,
                   pipeline_depth: int = 1, engine: str = "S", speculate: bool = False,
                   corr: str = "auto", wide_ranks: bool = False):
    """Distributed PC-stable over ``mesh`` (default: every visible card).
    Give samples x (m, n), or C (n, n) with its m.

    Every combination of the options below is bitwise equal (skeleton,
    sepsets, CPDAG) to the replicated layout and to the single-device "S"
    engine, n % K ≠ 0 included:

    shard_c=True row-shards C: a device keeps O(n·k + n²/K) of it.
    shard_sep=True row-shards the sepset tensor and commits its rows
    locally: O(n²·depth/K) a device; the (n, n) bool adjacency commit is
    the one replicated commit.
    cache_cols (shard_c only): gather the active columns once a run into a
    :class:`ColumnCache` and subset them later, instead of a gather in
    every chunk (False).
    pipeline_depth ≥ 2 issues that many chunks' tests before the oldest
    commit ("S").
    engine="S-grid" sweeps each launch's ranks in one sgrid kernel a shard,
    fused with its commit: normally one dispatch a level (pipeline_depth
    is then moot).
    speculate=True (S-grid only) issues level ℓ+1's first launch under
    level ℓ's width before the max-degree read resolves.

    checkpoint_cb(level, adj, sep): a per-level snapshot hook, handed the
    (n, n) adjacency and the n-row global view of the sepset tensor (the
    pad rows dropped) as tensors on the mesh's first device, so that a
    snapshot feeds back into ``resume=(level, adj, sep)``, which restarts
    after that level. corr picks the correlation path for x as ``pc``
    does ("auto": the corr kernel on the card, the plain version on the
    CPU); wide_ranks=True carries combo ranks in int64.

    The result is a ``PCRun`` of numpy arrays, as from ``pc``."""
    from .cit import correlation_of, threshold
    from .combinadics import MAX_LEVEL
    from .orient import cpdag_from_skeleton
    from .pc import PCRun, _tensor
    from ..kernels import ops

    if str(engine).upper() not in ("S", "S-GRID"):
        raise ValueError(f"pc_distributed engine must be 'S' or 'S-grid', got {engine!r}")
    grid = str(engine).upper() == "S-GRID"
    if speculate and not grid:
        raise ValueError("speculate=True requires engine='S-grid'")
    rank_dtype = D.rank_dtype(wide_ranks)
    tracer = obs.run_tracer("pc_distributed")
    with tracer.span("total", engine=str(engine), shard_c=shard_c, shard_sep=shard_sep,
                     pipeline_depth=pipeline_depth, speculate=speculate):
        mesh = mesh or pc_mesh()
        dev0 = mesh[0]
        if c is None:
            assert x is not None
            x = _tensor(x)
            m = int(x.shape[0])
            c = correlation_of(x.to(dev0, torch.float32), corr)
        c = _tensor(c).to(dev0, torch.float32).contiguous()
        n = c.shape[0]
        lmax = min(max_level if max_level is not None else MAX_LEVEL, sepset_depth)

        if resume is not None:
            start_level, adj0, sep0 = resume
            adj = _tensor(adj0).to(dev0, torch.bool)
            sep = _tensor(sep0).to(dev0, torch.int32)
            first_level = start_level + 1
        else:
            adj, sep, _ = ops.level0_span(c, threshold(m, 0, alpha), sepset_depth)
            first_level = 1

        c_t = None
        if shard_c:
            # one placement for the run: each shard keeps its rows of C
            c = shard_correlation(c, mesh)
        else:
            c = S.replicate(c, mesh)
            if grid:
                c_t = _transposes(c, mesh)  # one copy a device for the run
        adj = S.replicate(adj, mesh)
        sep = S.shard_rows(sep, mesh, fill=-1)[0] if shard_sep else S.replicate(sep, mesh)
        col_cache = ColumnCache() if (shard_c and cache_cols) else None

        def global_sep():
            return sep.gather(dev0)[:n] if shard_sep else sep[0]

        stats = []
        ell = first_level
        spec = None
        prev_npr_b = None
        while ell <= lmax:
            read = _degree_reader(L.max_degree(adj[0]))
            if speculate and prev_npr_b is not None:
                # the level barrier overlaps level ℓ's first grid launch,
                # issued under level ℓ-1's width before the read resolves
                spec = _speculative_dispatch(c, adj, ell, threshold(m, ell, alpha), mesh,
                                             prev_npr_b, n, shard_c, col_cache, cell_budget,
                                             bucket, rank_dtype, c_t)
            if read() - 1 < ell:
                break  # a pending speculative launch is dropped
            with tracer.span(f"level{ell}", level=ell) as sp:
                adj, sep, st = run_level_sharded(
                    c, adj, sep, ell, threshold(m, ell, alpha), mesh, cell_budget=cell_budget,
                    bucket=bucket, shard_c=shard_c, shard_sep=shard_sep,
                    pipeline_depth=pipeline_depth, col_cache=col_cache, engine=engine,
                    spec=spec, rank_dtype=rank_dtype, c_t=c_t)
                spec = None
                sp.sync(*adj, *sep).set(
                    **{k: st[k] for k in ("engine", "chunks", "dispatches", "total_sets",
                                          "npr_bucket", "col_gathers", "speculative")
                       if k in st})
            stats.append({"level": ell, **st})
            prev_npr_b = st.get("npr_bucket") if not st.get("skipped") else None
            if checkpoint_cb is not None:
                checkpoint_cb(ell, adj[0], global_sep())
            ell += 1

        adj_f, sep_f = adj[0], global_sep()
        cpdag = cpdag_from_skeleton(adj_f, sep_f)
        run = PCRun(adj=adj_f.cpu().numpy(), cpdag=cpdag.cpu().numpy(),
                    sepsets=sep_f.cpu().numpy(), levels_run=ell - 1, level_stats=stats)
    run.timings_s = tracer.timings()
    tracer.finish(driver="pc_distributed", engine=str(engine), n=n, n_dev=S.mesh_size(mesh),
                  levels_run=run.levels_run)
    return run
