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
port has no HLO to parse: :func:`collective_bytes` counts the crossings of
the port's own sharded step (``models/registry.py::_sharded_step``) from
the planner's specs, by rank, in the shape the reference's HLO walk gives.
Every crossing of that step has rank 0 at one end (it gathers the compute
copy and the batch, sends each rank its gradient block and the clip
factor, and receives each rank's squared sums), so the total is rank 0's.
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


def collective_bytes(mesh=None, params=None, pspecs=None, batch=None, bspecs=None) -> dict:
    """The crossings of one sharded train step on ``mesh`` as
    ``{kind: {"count", "bytes"}, "total_bytes"}``, from the parameters'
    and the batch's global shapes and their specs (``meta`` trees do):

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
    port's sharded step runs the products on rank 0 alone), else the
    per-card count times ``n_chips`` (the reference's SPMD program)."""
    terms = roofline_terms(cost, coll)
    mf = model_flops(cfg, cell, params_abstract)
    if global_flops is None:
        global_flops = terms["hlo_flops_per_chip"] * n_chips
    terms.update(mf)
    terms["useful_flops_ratio"] = mf["model_flops"] / max(global_flops, 1e-30)
    terms["n_chips"] = n_chips
    return terms
