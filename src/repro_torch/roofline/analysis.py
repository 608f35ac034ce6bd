"""Three-term roofline of a dry-run cell on one NVIDIA H100 SXM (the
counterpart of ``src/repro/roofline/analysis.py``):

  compute term    = per-card FLOPs / 989 TFLOP/s (dense bf16)
  memory term     = per-card bytes accessed / 3.35 TB/s (HBM3)
  collective term = per-card bytes crossing ranks / 900 GB/s (NVLink)

``HW`` holds NVIDIA's data-sheet peaks for the H100 SXM5 80 GB at 700 W,
dense rates (no 2:4 sparsity). The NVLink figure, 900 GB/s, is the data
sheet's total over its 18 links in both directions (450 GB/s each way);
a collective's bytes are counted once, as rank 0 sends or receives them,
so the term assumes the two directions share the load evenly: a lower
bound, as every term here is.

The per-card FLOPs and bytes come from ``launch.dryrun``'s counter at the
dispatcher (the port's counterpart of ``compiled.cost_analysis()``). The
port has no HLO to parse: :func:`collective_bytes` describes the crossings
of the port's own sharded train step from the planner's specs, in the shape
the reference's HLO walk gives: what rank 0 sends and receives
(``core.sharding.count_seams()`` counts the same moves). For the
dense and vlm families that is the step in which each rank computes its
share (``models/spmd.py``): the FSDP all-gathers of each leaf over
``data`` (in the forward, and again under remat in the backward) and
their reduce-scatters, the ``model`` all-reduces of each layer's
row-parallel outputs (again under remat) and of the gradients of the
inputs of its column-parallel products, the vocabulary all-reduces of the
embedding and the loss, the token mean's over (pod, data), the batch rows
each rank takes of a microbatch (all-to-all), the gradient sums over
``pod`` (and ``data`` and ``model`` for the leaves that need them), and
the clip. An all-reduce over n ranks moves n pieces of the flattened
tensor as a ring would: rank 0 sends and receives 2 (n − 1) / n of it each
way. For the other families it is the gathered step
(``registry._sharded_step``), every crossing of which has rank 0 at one
end.
"""
from __future__ import annotations

import math

from .. import tree as T
from ..core.sharding import SEAM_KINDS, distinct_ranks

HW = {
    "peak_flops": 989e12,   # dense bf16 FLOP/s, H100 SXM5 data sheet
    "hbm_bw": 3.35e12,      # HBM3 bytes/s
    "link_bw": 900e9,       # NVLink bytes/s, both directions together
    "hbm_bytes": 80e9,      # device memory, the data sheet's 80 GB
}


def _block_numel(shape, spec, mesh) -> int:
    return math.prod(d // mesh.axis_size(e) for d, e in zip(shape, spec))


def _ring_pieces(numel: int, n: int) -> list[int]:
    """The sizes of ``torch.tensor_split``'s n pieces of ``numel`` elements."""
    q, r = divmod(numel, n)
    return [q + (1 if j < r else 0) for j in range(n)]


def collective_bytes(mesh=None, params=None, pspecs=None, batch=None, bspecs=None, cfg=None,
                     tcfg=None) -> dict:
    """The crossings rank 0 sends or receives in one sharded train step on
    ``mesh``, as ``{kind: {"count", "bytes"}, "total_bytes"}``, from the
    parameters' and the batch's global shapes and their specs (``meta``
    trees do); with ``cfg`` of a family whose step computes each rank's
    share (``models.spmd.splits``), that step's under ``tcfg`` (the module
    docstring). The gathered step's:

      all-gather      each distinct block of the parameters and of the
                      batch that rank 0 does not hold, to rank 0
      reduce-scatter  every other rank's fp32 gradient block, from rank 0
      all-reduce      each distinct gradient block's squared sum (fp32
                      scalar) to rank 0, and the clip factor to every rank

    ``count`` is the number of tensors that cross. Without a mesh (a step
    on one device) every count is 0."""
    out = {k: {"count": 0, "bytes": 0} for k in SEAM_KINDS}

    def add(kind, n, nbytes):
        out[kind]["count"] += n
        out[kind]["bytes"] += nbytes

    if mesh is not None and cfg is not None:
        from ..models import spmd

        if spmd.splits(cfg):
            _split_crossings(add, mesh, params, pspecs, batch, cfg, tcfg)
            out["total_bytes"] = sum(out[k]["bytes"] for k in SEAM_KINDS)
            return out
    if mesh is not None:
        for tree, specs in ((params, pspecs), (batch, bspecs)):
            for leaf, spec in zip(T.leaves(tree), T.leaves(specs)):
                n = len(distinct_ranks(spec, mesh)) - 1  # rank 0 holds the first
                add("all-gather", n, n * _block_numel(leaf.shape, spec, mesh)
                    * leaf.element_size())
        for leaf, spec in zip(T.leaves(params), T.leaves(pspecs)):
            add("reduce-scatter", mesh.size - 1,
                (mesh.size - 1) * _block_numel(leaf.shape, spec, mesh) * 4)
            n = len(distinct_ranks(spec, mesh)) - 1
            add("all-reduce", n, 4 * n)
        add("all-reduce", mesh.size - 1, 4 * (mesh.size - 1))
    out["total_bytes"] = sum(out[k]["bytes"] for k in SEAM_KINDS)
    return out


def _split_crossings(add, mesh, params, pspecs, batch, cfg, tcfg) -> None:
    """Rank 0's crossings in ``models/spmd.py``'s step (the module
    docstring), through ``add(kind, count, bytes)``."""
    import torch

    from ..core.sharding import spec_axes
    from ..models import perf_flags, spmd

    layout = spmd.Layout(cfg, mesh, pspecs)
    accum, remat = max(tcfg.grad_accum, 1), tcfg.remat
    act = getattr(torch, tcfg.compute_dtype).itemsize
    n_dp = mesh.axis_size(layout.dp)
    n_fs = mesh.axis_size(layout.fs) if layout.fs else 1
    n_tp = mesh.axis_size(layout.tp) if layout.tp else 1

    def ring(numel, esize, n):  # one all-reduce over n ranks (core.sharding._all_reduce)
        if n == 1:
            return
        s = _ring_pieces(numel, n)
        moved = sum(1 for x in s[1:] if x)
        add("all-reduce", 2 * moved + 2 * (n - 1) * (s[0] > 0),
            (2 * (numel - s[0]) + 2 * (n - 1) * s[0]) * esize)

    def fsdp(leaf, spec, gathers):  # a leaf's all-gathers over data and its reduce-scatter
        if n_fs == 1 or not any(layout.fs in spec_axes(e) for e in spec):
            return
        nbytes = 2 * (n_fs - 1) * _block_numel(leaf.shape, spec, mesh) * leaf.element_size()
        add("all-gather", gathers * 2 * (n_fs - 1), gathers * nbytes)
        add("reduce-scatter", 2 * (n_fs - 1), nbytes)

    p_leaves, s_leaves = T.leaves(params), T.leaves(pspecs)
    by_path = {path: (leaf, spec) for (path, leaf), spec in
               zip(T.flatten_with_path(params), s_leaves)}
    b_leaves = T.leaves(batch)
    rows = b_leaves[0].shape[0]
    per = rows // accum // n_dp
    t_text = batch["tokens"].shape[1]
    t = t_text + (cfg.vis_ctx or 0)
    d = cfg.d_model
    for i in range(accum):
        # the rows of microbatch i rank 0 takes and gives (all-to-all)
        row_bytes = sum(x[0].numel() * x.element_size() for x in b_leaves)
        if (i * n_dp) // accum != 0:
            add("all-to-all", len(b_leaves), per * row_bytes)
        for j in range(1, n_dp):
            if (i * n_dp + j) // accum == 0:
                add("all-to-all", len(b_leaves), per * row_bytes)
        # the embedding: the table's gather, the vocabulary all-reduce
        fsdp(*by_path[("embed",)], 1)
        if layout.on_tp(by_path[("embed",)][1]):
            ring(per * t_text * d, act, n_tp)
        if cfg.vis_ctx:
            fsdp(*by_path[("vis_proj",)], 1)
        # the layers: gathers and g forward (again under remat), f backward
        for path, (leaf, spec) in by_path.items():
            if path[0] == "segments":
                fsdp(leaf, spec, 2 if remat else 1)
        for _ in range(cfg.n_layers):
            for split in (layout.attn, layout.mlp):
                for _ in range((3 if remat else 2) if split else 0):
                    ring(per * t * d, act, n_tp)
        # the logits and the loss
        for path, (leaf, spec) in by_path.items():
            if path[0] == "final_norm":
                fsdp(leaf, spec, 1)
        fsdp(*by_path[("embed",) if layout.tie else ("unembed",)], 1)
        if layout.vocab:
            ring(per * t_text * d, act, n_tp)  # f's backward on the hidden states
            if perf_flags.CHUNKED_CE:
                for _ in range(3):
                    ring(per * t_text, 4, n_tp)
            else:
                ring(per * t_text, 4, n_tp)
                ring(per * t_text * 2, 4, n_tp)
        ring(1, 4, n_dp)
        ring(1, 8, n_dp)
    # the gradients' sums over pod, data (where it does not split a leaf) and
    # model (a whole leaf a split attention reads in part)
    for leaf, spec, axes in zip(p_leaves, s_leaves, spmd.grad_sum_axes(layout, mesh, pspecs)):
        ring(_block_numel(leaf.shape, spec, mesh), 4, mesh.axis_size(axes))
    # the clip
    for spec in s_leaves:
        n = len(distinct_ranks(spec, mesh)) - 1
        add("all-reduce", n, 4 * n)
    add("all-reduce", mesh.size - 1, 4 * (mesh.size - 1))


def roofline_terms(cost: dict, coll: dict) -> dict:
    """cost: the counter's per-card ``flops`` and ``bytes accessed``; coll:
    :func:`collective_bytes`' shape. The ``hlo_*`` keys keep the
    reference's names; here they are the dispatcher's counts."""
    flops = float(cost.get("flops", 0.0))
    byts = float(cost.get("bytes accessed", 0.0))
    cbytes = float(coll["total_bytes"])
    t_compute = flops / HW["peak_flops"]
    t_memory = byts / HW["hbm_bw"]
    t_coll = cbytes / HW["link_bw"]
    dominant = max(
        ("compute", t_compute), ("memory", t_memory), ("collective", t_coll),
        key=lambda kv: kv[1],
    )[0]
    denom = max(t_compute, t_memory, t_coll, 1e-30)
    return {
        "hlo_flops_per_chip": flops,
        "hlo_bytes_per_chip": byts,
        "collective_bytes_per_chip": cbytes,
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "dominant": dominant,
        "roofline_fraction_compute": t_compute / denom,
    }


# ------------------------------------------------------------- model flops
def _routed_params(params) -> int:
    """The routed experts' (e, d, f) / (e, f, d) matrices. The reference
    finds them as rank-4 leaves (stacked over layers); the port holds a
    layer a ``Block``, so the same rule reads each leaf's stacked rank."""
    return sum(leaf.numel() for path, leaf in T.flatten_with_path(params)
               if any(k in ("w_up", "w_gate", "w_down") for k in path if isinstance(k, str))
               and T.stacked_ndim(path, leaf) == 4)


def model_flops(cfg, cell, params_abstract) -> dict:
    """MODEL_FLOPS = 6·N·D (train) or 2·N·D (serve), N the active parameters
    without the embedding lookup table (not a matmul), D the tokens."""
    n_total = sum(leaf.numel() for leaf in T.leaves(params_abstract))
    routed = _routed_params(params_abstract)
    n_embed = cfg.padded_vocab * cfg.d_model
    active_routed = routed * (cfg.moe.top_k / cfg.moe.padded) if cfg.moe else routed
    n_active = n_total - routed + active_routed - n_embed
    tokens = cell.global_batch * (1 if cell.kind == "decode" else cell.seq_len)
    mult = 6 if cell.kind == "train" else 2
    return {
        "n_params_total": n_total,
        "n_params_active": n_active,
        "tokens": tokens,
        "model_flops": mult * n_active * tokens,
    }


def roofline_report(cost, coll, cfg, cell, params_abstract, n_chips: int,
                    global_flops: float | None = None) -> dict:
    """The terms, :func:`model_flops` and the useful share of the FLOPs run
    on every card: ``global_flops`` where the cards' programs differ (the
    port's gathered step runs the products on rank 0 alone), else the
    per-card count times ``n_chips`` (an SPMD program: the reference's, and
    the port's step for the dense and vlm families)."""
    terms = roofline_terms(cost, coll)
    mf = model_flops(cfg, cell, params_abstract)
    if global_flops is None:
        global_flops = terms["hlo_flops_per_chip"] * n_chips
    terms.update(mf)
    terms["useful_flops_ratio"] = mf["model_flops"] / max(global_flops, 1e-30)
    terms["n_chips"] = n_chips
    return terms
