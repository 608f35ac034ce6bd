"""Model registry: one API over every architecture family (the
counterpart of ``src/repro/models/registry.py:24-141, 184-188``).

``build(cfg)`` returns a ``ModelAPI`` of plain functions;
``make_train_step`` the training step: ``grad_accum`` microbatches with
fp32 gradient accumulators, the global-norm clip, the warmup-cosine
learning rate and AdamW, all on the device. ``input_specs`` and
``abstract_*`` give the dry run's stand-ins as ``meta`` tensors (the
port's ``jax.eval_shape``): shapes and dtypes, no allocation.

Given a named mesh (``make_train_step(..., mesh=)``), the step trains on
the mesh's ranks, one process driving them all (logical shards of one
device, or one card a rank). The parameters and the optimizer state are
laid out by ``sharding.param_specs`` and ``opt_specs``
(``state.shard_tree``), the batch by ``batch_specs``. Which step runs is
the family's:

* ``dense`` and ``vlm`` (every layer attention and a dense MLP): each rank
  computes its own share, the reference's GSPMD program
  (``models/spmd.py``): its rows of each microbatch, FSDP over ``data``
  (each layer's blocks gathered just before it, and again under remat in
  the backward), tensor-parallel products over ``model`` with the
  row-parallel outputs all-reduced, a vocabulary-parallel embedding and
  loss, the gradient reduce-scattered over ``data`` and all-reduced over
  ``pod``. No rank holds a whole split parameter, the whole gradient or
  the global batch.
* every other family (MoE, MLA, Mamba2, RWKV6, zamba2's sites, Whisper):
  the gathered step (:func:`_sharded_step`). It gathers the parameters'
  blocks into one compute copy and the batch's rows, in rank order, into
  the global batch, both on the mesh's first device, and runs the
  single-device loss and gradients on it (``grad_accum`` microbatches of
  the global batch, fp32 accumulators; the anchors of ``meshops`` check
  that each microbatch splits over (pod, data)). That is the maths of the
  reference's GSPMD step: one token mean over every labelled token of a
  microbatch, MoE capacity, slots and the aux loss over all of its tokens.
  Each shard's block of the gradient is its slice of the one gradient (the
  reduce-scatter). So for these families the mesh shards storage, the
  batch and the update, not the products.

Both steps end alike: the clip adds each leaf's distinct blocks' squared
sums in rank order, and AdamW updates every block on its own shard.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from .. import tree as T
from ..configs.base import ModelConfig, ShapeCell, TrainConfig
from ..device import resolve_device
from ..optim import adamw_init, adamw_update, clip_by_global_norm, warmup_cosine
from ..optim.adamw import norm_and_scale
from . import transformer as tf
from . import whisper as wh


@dataclass
class ModelAPI:
    cfg: ModelConfig
    init: Callable[[], Any]         # () -> LM | Whisper
    loss: Callable[..., Any]        # (params, batch) -> (loss, metrics)
    prefill: Callable[..., Any]     # (params, batch, t_max) -> (logits, cache)
    decode: Callable[..., Any]      # (params, batch, cache) -> (logits, cache')
    cache_init: Callable[..., Any]  # (batch, t_max) -> cache


def build(cfg: ModelConfig, compute_dtype=torch.bfloat16, param_dtype=torch.float32,
          remat: bool = True, device=None, generator: torch.Generator | None = None
          ) -> ModelAPI:
    """The model's functions on ``device`` (None: the CUDA card). ``init``
    draws from ``generator`` (None: a generator on the device seeded 0)."""
    dev = resolve_device(device)
    gen = generator or torch.Generator("cpu" if dev.type == "meta" else dev).manual_seed(0)
    if cfg.family == "audio":
        return ModelAPI(
            cfg=cfg,
            init=lambda: wh.whisper_init(gen, cfg, param_dtype),
            loss=lambda p, b: wh.whisper_loss(p, cfg, b, compute_dtype, remat),
            prefill=lambda p, b, t_max: wh.whisper_prefill(p, cfg, b, t_max, compute_dtype),
            decode=lambda p, b, c: wh.whisper_decode_step(p, cfg, b, c, compute_dtype),
            cache_init=lambda batch, t_max: wh.whisper_cache_init(cfg, batch, t_max, device=dev),
        )
    return ModelAPI(
        cfg=cfg,
        init=lambda: tf.lm_init(gen, cfg, param_dtype),
        loss=lambda p, b: tf.lm_loss(p, cfg, b, compute_dtype, remat),
        prefill=lambda p, b, t_max: tf.lm_prefill(p, cfg, b, t_max, compute_dtype),
        decode=lambda p, b, c: tf.lm_decode_step(p, cfg, b, c, compute_dtype),
        cache_init=lambda batch, t_max: tf.lm_cache_init(cfg, batch, t_max, device=dev),
    )


# ------------------------------------------------------------------- steps
def _detached(metrics: dict) -> dict:
    return {k: v.detach() for k, v in metrics.items()}


def _grads(api: ModelAPI, accum: int, params, leaves: list, batch: dict):
    """(fp32 gradients of ``leaves``, the loss, the metrics) of ``batch``:
    ``accum`` microbatches, microbatch i rows [i·B/accum, (i+1)·B/accum),
    fp32 accumulators of the parameters' size (activations scale 1/accum)."""
    if accum == 1:
        loss, metrics = api.loss(params, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
        return [g.float() for g in grads], loss.detach(), _detached(metrics)
    gacc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in leaves]
    lsum = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    ms = []
    for i in range(accum):
        b1 = {k: v.reshape(accum, v.shape[0] // accum, *v.shape[1:])[i]
              for k, v in batch.items()}
        loss, metrics = api.loss(params, b1)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
        gacc = [a + g.float() for a, g in zip(gacc, grads)]
        lsum = lsum + loss.detach()
        ms.append(_detached(metrics))
    metrics = {k: torch.stack([m[k] for m in ms]).mean() for k in ms[0]}
    return [g / accum for g in gacc], lsum / accum, metrics


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, device=None, mesh=None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the parameters and the optimizer state are updated in
    place (and returned); the metrics (``loss``, ``gnorm``, ``lr``, ``ce``,
    ``aux``) are () fp32 device tensors. Nothing is read back to the
    host. With a named ``mesh`` the three are ``state.ShardedTree``s on it
    (the module docstring) and the metrics lie on its first rank's device
    (``device`` defaults to it)."""
    if mesh is not None and device is None:
        device = mesh.require_devices()[0]
    api = build(cfg, compute_dtype=getattr(torch, tcfg.compute_dtype),
                param_dtype=getattr(torch, tcfg.param_dtype), remat=tcfg.remat, device=device)
    accum = max(tcfg.grad_accum, 1)
    if mesh is not None:
        from . import spmd

        if spmd.splits(cfg):
            return _split_step(api, tcfg, accum, mesh)
        return _sharded_step(api, tcfg, accum, mesh)

    def train_step(params, opt_state, batch):
        params.requires_grad_(True)
        leaves = T.leaves(params)
        grads, loss, metrics = _grads(api, accum, params, leaves, batch)
        grads, gnorm = clip_by_global_norm(grads, tcfg.grad_clip, like=params)
        lr = warmup_cosine(opt_state["step"], tcfg.lr, tcfg.warmup, tcfg.total_steps)
        params, opt_state = adamw_update(params, grads, opt_state, lr,
                                         weight_decay=tcfg.weight_decay)
        return params, opt_state, {"loss": loss, "gnorm": gnorm, "lr": lr, **metrics}

    return train_step


def _sum_in_order(xs: list) -> torch.Tensor:
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return out


def _check_placed(mesh, params, opt_state, batch) -> None:
    from ..core.sharding import spec_axes
    from .sharding import mesh_axes

    if not params.mesh == opt_state.mesh == batch.mesh == mesh:
        raise ValueError("the parameters, the optimizer state and the batch must lie on "
                         "the step's mesh")
    dp, _ = mesh_axes(mesh)
    if any(spec_axes(spec[0] if spec else None) != dp for spec in batch.spec_leaves()):
        raise ValueError(f"the batch's rows must be split over the mesh's {dp} axes "
                         "(models.sharding.batch_specs)")


def _clip_and_update(rs, tcfg: TrainConfig, params, opt_state, blocks: list,
                     own: bool = False):
    """The clip and AdamW on a mesh: ``blocks`` each driven rank's fp32
    gradient blocks (``own``: each a tensor of its own, scaled in place;
    else they may share storage, as views of one gradient do). Each rank
    squares and sums its distinct blocks, rank 0 adds each leaf's sums in
    rank order and sends every rank the clip factor, and each rank updates
    its blocks. Returns (the global norm, rank 0's learning rate)."""
    from ..core.sharding import distinct_ranks, move, on_rank

    devs, dev0 = rs.devices, rs.devices[0]
    specs = params.spec_leaves()
    owners = [distinct_ranks(spec, rs.mesh) for spec in specs]
    sums = {}
    for k, r in enumerate(rs.ranks):
        with on_rank(r):
            for i, holders in enumerate(owners):
                if r in holders:
                    sums[r, i] = blocks[k][i].float().square().sum()
    sq = [_sum_in_order([move(sums[0 if rs.lead else r, i], dev0, r, 0, "all-reduce")
                         for r in holders]) for i, holders in enumerate(owners)]
    gn, scale = norm_and_scale(sq, T.stacked_groups(params.ranks[0]), tcfg.grad_clip)
    lr0 = None
    for r in range(rs.mesh.size):
        s_r = move(scale, devs[r], 0, r, "all-reduce")
        if r not in rs.ranks:
            continue
        k = rs.ranks.index(r)
        with on_rank(r):
            if own:
                torch._foreach_mul_(blocks[k], s_r)
                grads_r = blocks[k]
            else:
                grads_r = list(torch._foreach_mul(blocks[k], s_r))  # fp32 blocks
            lr = warmup_cosine(opt_state.ranks[r]["step"], tcfg.lr, tcfg.warmup, tcfg.total_steps)
            lr0 = lr if lr0 is None else lr0
            adamw_update(params.ranks[r], grads_r, opt_state.ranks[r], lr,
                         weight_decay=tcfg.weight_decay)
    return gn, lr0


def _split_step(api: ModelAPI, tcfg: TrainConfig, accum: int, mesh):
    """The train step in which each rank computes its share (the module
    docstring; ``models/spmd.py``)."""
    from ..core.sharding import RankSet
    from . import spmd

    cfg = api.cfg
    dt = getattr(torch, tcfg.compute_dtype)

    def split_train_step(params, opt_state, batch):
        _check_placed(mesh, params, opt_state, batch)
        rs = RankSet(mesh)
        layout = spmd.Layout(cfg, mesh, params.specs)
        blocks, loss, metrics = spmd.grads(rs, layout, cfg, params, batch, accum, dt, tcfg.remat)
        with torch.no_grad():
            gn, lr0 = _clip_and_update(rs, tcfg, params, opt_state, blocks, own=True)
        return params, opt_state, {"loss": loss, "gnorm": gn, "lr": lr0, **metrics}

    return split_train_step


def _sharded_step(api: ModelAPI, tcfg: TrainConfig, accum: int, mesh):
    """The gathered train step on a named mesh (the module docstring)."""
    from ..core.sharding import RankSet, block_slices, move
    from ..state import gather_tree
    from .meshops import use_mesh

    devs = mesh.require_devices()
    dev0 = devs[0]

    def sharded_train_step(params, opt_state, batch):
        _check_placed(mesh, params, opt_state, batch)
        specs, shapes = params.spec_leaves(), params.shapes
        rows = batch.shapes[0][0]
        copy = gather_tree(params, dev0)  # the parameters' all-gather: one compute copy
        leaves = [x.requires_grad_(True) for x in T.leaves(copy)]
        with use_mesh(mesh, rows // accum):
            grads, loss, metrics = _grads(api, accum, copy, leaves, gather_tree(batch, dev0))
        del copy, leaves
        with torch.no_grad():
            # each block its slice of the gradient (the reduce-scatter)
            blocks = [[move(grads[i][block_slices(shapes[i], specs[i], mesh, r)], devs[r], 0, r,
                            "reduce-scatter") for i in range(len(grads))]
                      for r in range(mesh.size)]
            del grads
            gn, lr0 = _clip_and_update(RankSet(mesh), tcfg, params, opt_state, blocks)
        return params, opt_state, {"loss": loss, "gnorm": gn, "lr": lr0, **metrics}

    return sharded_train_step


def make_prefill_step(cfg: ModelConfig, t_max: int, compute_dtype=torch.bfloat16,
                      device=None):
    api = build(cfg, compute_dtype=compute_dtype, remat=False, device=device)

    def prefill_step(params, batch):
        return api.prefill(params, batch, t_max)

    return prefill_step


def make_decode_step(cfg: ModelConfig, compute_dtype=torch.bfloat16, device=None):
    api = build(cfg, compute_dtype=compute_dtype, remat=False, device=device)

    def decode_step(params, batch, cache):
        return api.decode(params, batch, cache)

    return decode_step


# ------------------------------------------------------------- input specs
def _meta(dtype, *shape) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, cell: ShapeCell) -> dict:
    """The batch of a dry-run cell as ``meta`` tensors (shapes and dtypes,
    no allocation)."""
    b, t = cell.global_batch, cell.seq_len
    i32, f32 = torch.int32, torch.float32
    if cell.kind == "decode":
        return {"tokens": _meta(i32, b, 1)}
    if cfg.family == "audio":
        batch = {"tokens": _meta(i32, b, t), "frames": _meta(f32, b, cfg.enc_ctx, cfg.d_model)}
    elif cfg.vis_ctx:
        batch = {"tokens": _meta(i32, b, t - cfg.vis_ctx),
                 "vis": _meta(f32, b, cfg.vis_ctx, cfg.vis_width)}
    else:
        batch = {"tokens": _meta(i32, b, t)}
    if cell.kind == "train":
        batch["labels"] = _meta(i32, b, t) if cfg.family == "audio" else _meta(
            i32, *batch["tokens"].shape)
    return batch


def abstract_params(cfg: ModelConfig, param_dtype=torch.float32):
    """The parameters as ``meta`` tensors: ``init`` runs under fake tensors
    (no storage), and each leaf becomes a ``meta`` tensor of its shape and
    dtype, in the model's module."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        params = build(cfg, param_dtype=param_dtype, device="cpu",
                       generator=torch.Generator("cpu")).init()
    return T.unflatten_like(params, [_meta(x.dtype, *x.shape) for x in T.leaves(params)])


def abstract_opt_state(params, master_fp32: bool = False) -> dict:
    """AdamW's state of ``meta`` parameters (``master`` under
    ``master_fp32``)."""
    return adamw_init(params, master_fp32)


def abstract_cache(cfg: ModelConfig, batch: int, t_max: int) -> dict:
    """The decode cache as ``meta`` tensors."""
    return build(cfg, device="meta", generator=torch.Generator("cpu")).cache_init(batch, t_max)


def supports_cell(cfg: ModelConfig, cell: ShapeCell) -> tuple[bool, str]:
    """Assignment skip rules. Returns (runnable, reason-if-not)."""
    if cell.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("full-attention arch: 500k dense KV decode is the quadratic regime the "
                       "assignment skips")
    return True, ""
