"""The train step on a named mesh in which each rank computes its own share
(the SPMD program the reference's GSPMD builds from the planner's specs,
``src/repro/models/sharding.py:49-99`` and ``meshops.py:51-58``), for the
families whose every layer is attention and a dense MLP: ``dense`` and
``vlm`` (:data:`FAMILIES`). ``registry.make_train_step(cfg, tcfg, mesh=)``
picks it by family; the others keep ``registry._sharded_step``.

One process drives every rank (or, under ``core.sharding.lead_rank_only``
on a ``meta`` mesh, rank 0 alone: the dry run), in lockstep: each stage of
the program runs on every rank (``RankSet.each``, under ``on_rank``), and
the ranks meet only in the collectives of ``core.sharding``.

* Rows. Each (pod, data) rank runs its share of each microbatch: the
  reference's microbatch i is rows [i·B/accum, (i+1)·B/accum) of the global
  batch, and data rank d takes its d-th slice of it, moved from the rank
  that holds it (an all-to-all; none at ``grad_accum`` 1). No rank holds
  the global batch.
* Parameters (FSDP over ``data``, tensor parallelism over ``model``). Each
  leaf's blocks are all-gathered over ``data`` just before the layer that
  uses them (their gradient reduce-scattered back), and freed after it; a
  layer runs under ``remat``, so the backward gathers again. The ``model``
  split stays: where the planner puts ``model`` on a leaf decides its
  product. ``wq``/``wk``/``wv`` heads, ``w_up``/``w_gate`` columns and the
  vocabulary are column-parallel; ``wo`` heads and ``w_down`` rows
  row-parallel, their outputs all-reduced over ``model`` (Megatron's *g*),
  and the input of a column-parallel product is Megatron's *f* (its
  gradient all-reduced over ``model``). A dimension that does not divide
  stays whole and every ``model`` rank computes it: the whole attention
  where the heads do not divide (qwen2's 12 and paligemma's 8 at 16); where
  the kv heads do not divide but the heads do, each rank takes the kv head
  its query heads read from the whole ``wk``/``wv``. ``gqa_forward`` and
  ``mlp`` read their head and hidden counts from the weights, so a rank
  runs the one-device model functions on its blocks.
* Activations. The residual stream is replicated over ``model``
  (``shard_residual`` checks each rank's rows); the embedding looks up the
  rank's vocabulary block and all-reduces over ``model``; the logits are
  the rank's (rows, T, V/model) block, and the cross-entropy all-reduces
  the max, the sum of exponentials and the target logit over ``model``
  (``vocab_valid`` masks the padding ids), with ``perf_flags.CHUNKED_CE``
  streaming the block's chunks. The token mean is the reference's global
  one: the numerators and the counts of labelled tokens summed over (pod,
  data).
* Gradients. Each block's gradient is reduce-scattered over ``data`` (in
  the parameters' fp32, rank order) in the backward, summed over the
  microbatches in block-sized fp32 accumulators and divided by
  ``grad_accum``; then all-reduced over ``pod``, over ``data`` for a leaf
  that ``data`` does not split, and over ``model`` for a whole leaf that a
  split attention reads in part (``q_norm``, ``k_norm``, and the kv
  weights and biases when the kv heads do not divide). The clip and AdamW
  are ``_sharded_step``'s.

No rank holds a whole parameter of a leaf split over ``model``, the whole
gradient or the global batch.
"""
from __future__ import annotations

import contextlib

import torch
from torch.utils.checkpoint import set_checkpoint_early_stop

from .. import tree as T
from ..core.sharding import (RankSet, all_gather, all_reduce, all_reduce_max, all_reduce_sum,
                             block_index, copy_to, move, on_rank, spec_axes)
from . import perf_flags
from .attention import gqa_forward
from .layers import _ce_chunk, _chunk_logits, mlp
from .meshops import shard_logits, shard_residual, use_mesh
from .transformer import _norm, program, remat_apply

#: the families whose train step on a mesh computes each rank's share
FAMILIES = ("dense", "vlm")


def splits(cfg) -> bool:
    """Whether ``make_train_step(cfg, ..., mesh=)`` is this module's step."""
    return cfg.family in FAMILIES and [s.kind for s in program(cfg)] == ["attn_mlp"]


class Layout:
    """What the planner's specs make of the program on a mesh: the axes, and
    which products split over ``model``."""

    def __init__(self, cfg, mesh, specs):
        names = mesh.axis_names
        self.dp = tuple(a for a in ("pod", "data") if a in names)
        self.fs = "data" if "data" in names else None
        self.tp = "model" if "model" in names else None
        self.tie = cfg.tie_embed
        layer = specs["segments"][0][0]
        self.attn = self.on_tp(layer["attn"]["wq"])
        self.mlp = self.on_tp(layer["ffn"]["w_up"])
        table = specs["embed"] if cfg.tie_embed else specs["unembed"]
        self.vocab = self.on_tp(table)
        self.vocab_dim = 0 if cfg.tie_embed else 1
        self.kv_whole = self.attn and not self.on_tp(layer["attn"]["wk"])
        if self.kv_whole:
            group = cfg.n_heads // cfg.n_kv
            local = cfg.n_heads // mesh.axis_size(self.tp)
            if group % local:
                raise ValueError(f"{cfg.name}: {local} query heads a rank do not read one kv "
                                 f"head (groups of {group})")

    def on_tp(self, spec) -> bool:
        return self.tp is not None and any(self.tp in spec_axes(e) for e in spec)


# ----------------------------------------------------------------- blocks
def _fetch(rs: RankSet, layout: Layout, nodes: list, spec):
    """Each driven rank's compute blocks of a subtree (``nodes`` the ranks'
    modules): every leaf all-gathered over ``data`` where ``data`` splits
    it, the ``model`` split kept. Returns one plain dict tree a rank."""
    if isinstance(spec, dict):
        cols = {k: _fetch(rs, layout, [n[k] for n in nodes], s) for k, s in spec.items()
                if s is not None}
        return [{k: c[i] for k, c in cols.items()} for i in range(len(nodes))]
    dims = [i for i, e in enumerate(spec) if layout.fs in spec_axes(e)]
    return all_gather(rs, nodes, layout.fs, dims[0]) if dims else list(nodes)


def _kv_head(p: dict, cfg, layout: Layout, mesh, rank: int) -> dict:
    """A rank's attention blocks with the one kv head its query heads read
    (the kv heads whole, the query heads split)."""
    if not layout.kv_whole:
        return p
    local = p["wq"].shape[1]
    j = mesh.coords(rank)[layout.tp] * local // (cfg.n_heads // cfg.n_kv)
    out = dict(p)
    for name in ("wk", "wv"):
        out[name] = p[name][:, j:j + 1]
    for name in ("bk", "bv"):
        if name in p:
            out[name] = p[name][j:j + 1]
    return out


def _vocab_start(spec, dim: int, size: int, mesh, rank: int) -> int:
    idx, n = block_index(spec, mesh, rank)[dim]
    return idx * (size // n)


# ------------------------------------------------------------------ loss
def _lookup(table: torch.Tensor, tok: torch.Tensor, v0: int, split: bool, dt) -> torch.Tensor:
    """The embedding rows of ``tok`` in the rank's vocabulary block (zero
    for an id outside it)."""
    if not split:
        return table[tok].to(dt)
    local = tok - v0
    inside = (local >= 0) & (local < table.shape[0])
    x = table[local.clamp(0, table.shape[0] - 1)].to(dt)
    return torch.where(inside[..., None], x, torch.zeros((), dtype=dt, device=x.device))


def _masked_logits(logits: torch.Tensor, v0: int, vocab: int) -> torch.Tensor:
    """The block's padding ids (≥ ``vocab``) at the dtype's least value, as
    ``layers.cross_entropy`` masks them."""
    if v0 + logits.shape[-1] <= vocab:
        return logits
    ids = v0 + torch.arange(logits.shape[-1], device=logits.device)
    return torch.where(ids >= vocab, torch.finfo(logits.dtype).min, logits)


def _target(logits: torch.Tensor, labels: torch.Tensor, v0: int) -> torch.Tensor:
    """Each position's target logit where the target lies in the block,
    else 0."""
    local = labels.clamp_min(0).long() - v0
    inside = (local >= 0) & (local < logits.shape[-1])
    got = logits.gather(-1, local.clamp(0, logits.shape[-1] - 1)[..., None])[..., 0]
    return torch.where(inside, got, 0.0)


class _ChunkedVocabCE(torch.autograd.Function):
    """``layers.chunked_ce`` over each rank's vocabulary block: a rank
    streams its block's chunks for the running max, sum of exponentials and
    target logit, which are all-reduced over ``model``; the output is each
    rank's sum of NLL over its valid rows (the token mean is taken
    outside). The backward recomputes each chunk from the row
    log-sum-exp."""

    @staticmethod
    def forward(ctx, rs, tp, vocab, chunk, v0s, *args):
        n_r = len(rs.ranks)
        xs, ws, labs, valids = (list(args[k * n_r:(k + 1) * n_r]) for k in range(4))
        ms, ls, lls = [], [], []
        for i, r in enumerate(rs.ranks):
            x, w, lab = xs[i], ws[i], labs[i].long() - v0s[i]
            dev, n = x.device, x.shape[0]
            with on_rank(r):
                m = torch.full((n,), float("-inf"), dtype=torch.float32, device=dev)
                l = torch.zeros((n,), dtype=torch.float32, device=dev)
                ll = torch.zeros((n,), dtype=torch.float32, device=dev)
                for c0 in range(0, w.shape[1], chunk):
                    logits = _chunk_logits(x, w, c0, chunk, vocab - v0s[i])
                    m_new = torch.maximum(m, logits.amax(-1))
                    l = l * torch.exp(m - m_new) + torch.exp(logits - m_new[:, None]).sum(-1)
                    m = m_new
                    inside = (lab >= c0) & (lab < c0 + chunk)
                    local = (lab - c0).clamp(0, chunk - 1)
                    ll = torch.where(inside, logits.gather(1, local[:, None])[:, 0], ll)
            ms.append(m)
            ls.append(l)
            lls.append(ll)
        mg = all_reduce_max(rs, ms, tp)
        ls = rs.each(lambda l, m, g: l * torch.exp(m - g), ls, ms, mg)
        ls = all_reduce_sum(rs, ls, tp)
        lls = all_reduce_sum(rs, lls, tp)
        lses = rs.each(lambda m, l: m + torch.log(l.clamp_min(1e-30)), mg, ls)
        out = rs.each(lambda lse, ll, v: torch.where(v, lse - ll, 0.0).sum(), lses, lls, valids)
        ctx.save_for_backward(*xs, *ws, *labs, *valids, *lses)
        ctx.rs, ctx.vocab, ctx.chunk, ctx.v0s = rs, vocab, chunk, v0s
        return tuple(out)

    @staticmethod
    def backward(ctx, *gs):
        rs, chunk = ctx.rs, ctx.chunk
        n_r = len(rs.ranks)
        saved = ctx.saved_tensors
        xs, ws, labs, valids, lses = (saved[k * n_r:(k + 1) * n_r] for k in range(5))
        dxs, dws = [], []
        for i, r in enumerate(rs.ranks):
            x, w, v0 = xs[i], ws[i], ctx.v0s[i]
            lab = labs[i].long() - v0
            with on_rank(r):
                scale = (gs[i] * valids[i].float())[:, None]
                dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
                parts = []
                for c0 in range(0, w.shape[1], chunk):
                    wc = w[:, c0:c0 + chunk]
                    p = torch.exp(_chunk_logits(x, w, c0, chunk, ctx.vocab - v0)
                                  - lses[i][:, None])
                    ids = c0 + torch.arange(chunk, device=x.device)
                    dlog = (p - (lab[:, None] == ids[None, :]).float()) * scale
                    dx = dx + (dlog.to(wc.dtype) @ wc.T).float()
                    parts.append(x.T @ dlog.to(x.dtype))
                dxs.append(dx.to(x.dtype))
                dws.append(torch.cat(parts, 1).to(w.dtype))
        return (None,) * 5 + (*dxs, *dws) + (None,) * (2 * n_r)


def _ce_sums(rs: RankSet, layout: Layout, cfg, hs: list, tables: list, v0s: list, labels: list,
             dt) -> tuple[list, list]:
    """Each rank's (sum of NLL over its labelled positions, their count),
    from its final-norm hidden states ``hs`` (text positions) and its block
    of the unembedding ``tables`` ((V/model, D) tied, (D, V/model) else)."""
    split = layout.vocab
    valids = rs.each(lambda lab: lab >= 0, labels)
    counts = rs.each(lambda v: v.sum(), valids)
    if perf_flags.CHUNKED_CE:
        ws = rs.each(lambda t: (t.T if layout.tie else t).to(dt), tables)
        chunk = _ce_chunk(ws[0].shape[1], perf_flags.CHUNKED_CE)
        flat = rs.each(lambda h: h.reshape(-1, h.shape[-1]).to(dt), hs)
        labs = rs.each(lambda lab: lab.reshape(-1), labels)
        vals = rs.each(lambda v: v.reshape(-1), valids)
        nums = _ChunkedVocabCE.apply(rs, layout.tp if split else None, cfg.vocab, chunk,
                                     v0s, *flat, *ws, *labs, *vals)
        return list(nums), counts

    def block(h, t, v0):
        logits = (h @ (t.T if layout.tie else t).to(dt)).float()
        return _masked_logits(shard_logits(logits), v0, cfg.vocab)

    logits = rs.each(block, hs, tables, v0s)
    ms = all_reduce_max(rs, rs.each(lambda z: z.detach().amax(-1), logits),
                        layout.tp if split else None)
    parts = rs.each(lambda z, m, lab, v0: torch.stack(
        [torch.exp(z - m[..., None]).sum(-1), _target(z, lab, v0)], -1), logits, ms, labels, v0s)
    if split:
        parts = all_reduce(rs, parts, layout.tp)
    nums = rs.each(lambda st, m, v: ((m + torch.log(st[..., 0]) - st[..., 1]) * v).sum(),
                   parts, ms, valids)
    return nums, counts


def _microbatch(rs: RankSet, layout: Layout, batch, i: int, accum: int) -> list:
    """Each driven rank's rows of microbatch ``i``: data rank d's slice d of
    the reference's microbatch, moved from the rank that holds it."""
    n_dp = rs.size(layout.dp)
    rows = batch.shapes[0][0]
    per = rows // accum // n_dp
    blocks = [batch.ranks[r] for r in rs.ranks]
    out = []
    for r in rs.ranks:
        grp = rs.group(r, layout.dp)
        k = i * n_dp + grp.index(r)
        src, lo = grp[k // accum], (k % accum) * per
        out.append({name: move(x[lo:lo + per], rs.devices[r], src, r, "all-to-all")
                    for name, x in rs.value(blocks, src).items()})
    for j, dst in enumerate(rs.others(layout.dp), 1):
        k = i * n_dp + j
        if k // accum == 0:
            lo = (k % accum) * per
            for x in blocks[0].values():
                move(x[lo:lo + per], rs.devices[dst], 0, dst, "all-to-all")
    return out


def split_loss(rs: RankSet, layout: Layout, cfg, params, batches: list, dt, remat: bool
               ) -> list:
    """Each driven rank's loss of one microbatch, the CE (these families
    have no aux loss): ``batches`` one dict of rows a rank, ``params`` the
    ``ShardedTree``. The loss is the global token mean on every rank."""
    mesh = rs.mesh
    specs = params.specs
    mods = [params.ranks[r] for r in rs.ranks]
    table_spec = specs["embed"] if layout.tie else specs["unembed"]
    v0s = [_vocab_start(table_spec, layout.vocab_dim, cfg.padded_vocab, mesh, r)
           for r in rs.ranks]
    tp = layout.tp

    # the embedding: the rank's vocabulary block, all-reduced over model
    table = _fetch(rs, layout, [m["embed"] for m in mods], specs["embed"])
    emb_split = layout.on_tp(specs["embed"])
    emb_v0s = [_vocab_start(specs["embed"], 0, cfg.padded_vocab, mesh, r) for r in rs.ranks]
    xs = rs.each(lambda t, b, v0: _lookup(t, b["tokens"], v0, emb_split, dt), table, batches,
                 emb_v0s)
    del table
    if emb_split:
        xs = all_reduce(rs, xs, tp)
    if cfg.vis_ctx:
        proj = _fetch(rs, layout, [m["vis_proj"] for m in mods], specs["vis_proj"])
        xs = rs.each(lambda x, b, w: torch.cat([b["vis"].to(dt) @ w.to(dt), x], dim=1), xs,
                     batches, proj)
        del proj
    xs = rs.each(shard_residual, xs)
    b, t = xs[0].shape[:2]
    mask = ("prefix", cfg.vis_ctx) if cfg.vis_ctx else ("causal", 0)
    positions = rs.each(lambda x: torch.arange(t, dtype=torch.int32, device=x.device
                                               ).expand(b, t), xs)

    def layer(li, *xs):
        p = _fetch(rs, layout, [m["segments"][0][li] for m in mods], specs["segments"][0][li])
        attn = [_kv_head(q["attn"], cfg, layout, mesh, r) for q, r in zip(p, rs.ranks)]
        h = rs.each(lambda q, x: _norm(cfg, q["norm1"], x), p, xs)
        if layout.attn:
            h = copy_to(rs, h, tp)
        a = rs.each(lambda q, x, pos: gqa_forward(q, cfg, x, pos, mask)[0], attn, h, positions)
        if layout.attn:
            a = all_reduce(rs, a, tp)
        xs = rs.each(torch.add, xs, a)
        h = rs.each(lambda q, x: _norm(cfg, q["norm2"], x), p, xs)
        if layout.mlp:
            h = copy_to(rs, h, tp)
        o = rs.each(lambda q, x: mlp(q["ffn"], x, cfg.act), p, h)
        if layout.mlp:
            o = all_reduce(rs, o, tp)
        return tuple(rs.each(lambda x, y: shard_residual(x + y), xs, o))

    # remat recomputes the whole layer, its last all-reduce included, on
    # every rank alike (an early stop would end the recompute at the last
    # rank's last saved input, so rank 0 alone would recompute less)
    whole = set_checkpoint_early_stop(False) if remat else contextlib.nullcontext()
    with whole:
        for li in range(cfg.n_layers):
            xs = list(remat_apply(lambda *x, li=li: layer(li, *x), remat, *xs))

    fnorm = _fetch(rs, layout, [m["final_norm"] for m in mods], specs["final_norm"])
    hs = rs.each(lambda q, x: _norm(cfg, q, x[:, cfg.vis_ctx:] if cfg.vis_ctx else x), fnorm, xs)
    del xs
    if layout.vocab:
        hs = copy_to(rs, hs, tp)
    tables = _fetch(rs, layout, [m["embed" if layout.tie else "unembed"] for m in mods],
                    table_spec)
    labels = [bt["labels"] for bt in batches]
    nums, counts = _ce_sums(rs, layout, cfg, hs, tables, v0s, labels, dt)
    nums = all_reduce(rs, nums, layout.dp)
    counts = all_reduce_sum(rs, counts, layout.dp)
    return rs.each(lambda n, c: n / c.clamp_min(1), nums, counts)


def model_partial(layout: Layout, specs) -> list[bool]:
    """For each leaf (flatten order): a whole leaf that a split attention
    reads in part on each ``model`` rank, whose gradient is summed over
    ``model``."""
    return [layout.attn and "attn" in path and not layout.on_tp(spec)
            for path, spec in T.flatten_with_path(specs)]


def grad_sum_axes(layout: Layout, mesh, specs) -> list[tuple]:
    """For each leaf (flatten order), the axes its gradient block is summed
    over after the backward: ``pod``, ``data`` where it does not split the
    leaf, ``model`` where :func:`model_partial`."""
    partial = model_partial(layout, specs)
    out = []
    for spec, part in zip(T.leaves(specs), partial):
        named = {a for e in spec for a in spec_axes(e)}
        out.append(tuple(a for a in mesh.axis_names
                         if a == "pod" or (a == layout.fs and a not in named)
                         or (a == layout.tp and part)))
    return out


def grads(rs: RankSet, layout: Layout, cfg, params, batch, accum: int, dt, remat: bool):
    """Each driven rank's fp32 gradient blocks of the step's batch (summed
    over microbatches and ``pod``, ``data`` and ``model`` as the module
    docstring says), the loss and the metrics, on every rank."""
    mesh = rs.mesh
    rows = batch.shapes[0][0]
    n_dp = rs.size(layout.dp)
    if rows % (accum * n_dp):
        raise ValueError(f"{rows} rows do not split into {accum} microbatches over the mesh's "
                         f"{layout.dp} ({n_dp} ranks)")
    leaves = [[x.requires_grad_(True) for x in params.leaves(r)] for r in rs.ranks]
    flat = [x for ls in leaves for x in ls]
    n_leaf = len(leaves[0])
    gacc, ces = None, []
    for i in range(accum):
        mbs = _microbatch(rs, layout, batch, i, accum)
        with use_mesh(mesh, rows // accum, local=True):
            losses = split_loss(rs, layout, cfg, params, mbs, dt, remat)
        gs = torch.autograd.grad(losses, flat, grad_outputs=[torch.ones_like(x) for x in losses],
                                 allow_unused=True, materialize_grads=True)
        gs = [[g.float() for g in gs[k * n_leaf:(k + 1) * n_leaf]] for k in range(len(rs.ranks))]
        with torch.no_grad():
            if gacc is None:
                gacc = gs  # the first microbatch's blocks are the accumulators
            else:
                rs.each(torch._foreach_add_, gacc, gs)
        del gs
        ces.append(losses[0].detach())
    with torch.no_grad():
        if accum > 1:
            rs.each(lambda a: torch._foreach_div_(a, accum), gacc)
        for j, axes in enumerate(grad_sum_axes(layout, mesh, params.specs)):
            if rs.size(axes) > 1:
                for k, g in enumerate(all_reduce_sum(rs, [ga[j] for ga in gacc], axes)):
                    gacc[k][j] = g
        ce = ces[0] if accum == 1 else torch.stack(ces).mean()
        loss = ces[0] if accum == 1 else sum(ces[1:], ces[0]) / accum  # in order
        aux = torch.zeros((), dtype=torch.float32, device=loss.device)
    return gacc, loss, {"ce": ce, "aux": aux}
