"""Sharding planner: a partition spec for every tensor, from the config and
a named mesh (the counterpart of ``src/repro/models/sharding.py``).

Policy, the reference's:
  * mesh axes: ``model`` tensor parallel; ``data`` FSDP for parameters,
    the batch for activations; ``pod`` pure data parallelism (parameters
    replicated across pods; only the gradient mean crosses pods).
  * a dimension is split over an axis iff the axis size divides it, else
    it is whole (the GQA fallback for few KV heads).
  * optimizer moments inherit the parameter specs (ZeRO-1 by construction).
  * KV caches: the batch over (pod, data) when it divides; for batch-1
    long-context cells the sequence over ``data`` instead; head dimensions
    over ``model`` when they divide.

A spec is a ``core.sharding.Spec``: one entry a dimension, None, an axis
name or a tuple of names. The planner reads a tensor's shape and name
only, so it takes the ``meta`` trees of ``registry.abstract_*`` as well as
real ones, and a planning mesh (``launch.mesh.make_production_mesh``).

The port's trees differ from the reference's in one way: the reference
stacks a segment's (or Whisper's encoder's and decoder's) layers into one
(L, ...) leaf and gives it ``(None, *tail)``; the port holds a ``Block`` a
layer, so a layer's leaf (a ``tree.Layer`` key in its path) takes the
tail rule on its own shape, and no rule reads a leaf's rank to guess
whether it is stacked. ``tree.stacked_groups`` maps the port's leaves onto
the reference's. Every leaf name of the port is the reference's (the rules
fire on the last dict key), so no name is mapped.

Where the planner puts ``model`` on a leaf decides its product in the
train step that computes each rank's share (``models/spmd.py``, the dense
and vlm families): column-parallel for the ``wq``/``wk``/``wv`` heads,
``w_up``/``w_gate`` columns and the vocabulary, row-parallel for the
``wo`` heads and ``w_down`` rows. For the other families the ``model``
axis shards the parameters' storage and the optimizer update, not the
products (``registry._sharded_step``).
"""
from __future__ import annotations

from .. import tree as T
from ..core.sharding import NamedMesh, Spec


def mesh_axes(mesh: NamedMesh):
    """((data-parallel axes), the tensor-parallel axis or None)."""
    names = mesh.axis_names
    dp = tuple(a for a in ("pod", "data") if a in names)
    tp = "model" if "model" in names else None
    return dp, tp


def _if_div(dim: int, axis, mesh: NamedMesh):
    return axis if (axis is not None and dim % mesh.axis_size(axis) == 0) else None


# --------------------------------------------------------------- param plan
def _param_rule(name: str, shape, cfg, mesh: NamedMesh) -> Spec:
    """Spec of the *unstacked* tail of one parameter."""
    fs, tp = "data", "model"
    nd = len(shape)
    if nd <= 1:
        return Spec([None] * nd)
    if name == "embed":
        return Spec((_if_div(shape[0], tp, mesh), _if_div(shape[1], fs, mesh)))
    if name == "unembed":
        return Spec((_if_div(shape[0], fs, mesh), _if_div(shape[1], tp, mesh)))
    if name in ("wq", "wk", "wv") and nd == 3:  # (d, h, dh)
        return Spec((_if_div(shape[0], fs, mesh), _if_div(shape[1], tp, mesh), None))
    if name in ("bq", "bk", "bv"):              # (h, dh)
        return Spec((_if_div(shape[0], tp, mesh), None))
    if name == "wo" and nd == 3:                # (h, dh, d)
        return Spec((_if_div(shape[0], tp, mesh), None, _if_div(shape[2], fs, mesh)))
    if name in ("w_up", "w_gate"):
        if nd == 3:                              # (e, d, f) expert-parallel
            return Spec((_if_div(shape[0], tp, mesh), _if_div(shape[1], fs, mesh), None))
        return Spec((_if_div(shape[0], fs, mesh), _if_div(shape[1], tp, mesh)))
    if name == "w_down":
        if nd == 3:                              # (e, f, d)
            return Spec((_if_div(shape[0], tp, mesh), None, _if_div(shape[2], fs, mesh)))
        return Spec((_if_div(shape[0], tp, mesh), _if_div(shape[1], fs, mesh)))
    if name == "router":                         # (d, e)
        return Spec((_if_div(shape[0], fs, mesh), _if_div(shape[1], tp, mesh)))
    if name in ("wq_b", "wk_b", "wv_b"):         # (lora, h, ·) MLA up-projections
        return Spec((None, _if_div(shape[1], tp, mesh), None))
    if name in ("wq_a", "wkv_a"):                # (d, lora)
        return Spec((_if_div(shape[0], fs, mesh), None))
    if name == "in_proj":                        # (d, packed)
        return Spec((_if_div(shape[0], fs, mesh), _if_div(shape[1], tp, mesh)))
    if name == "out_proj":                       # (d_in, d)
        return Spec((_if_div(shape[0], tp, mesh), _if_div(shape[1], fs, mesh)))
    if name == "conv_w":                         # (k, conv_dim)
        return Spec((None, _if_div(shape[1], tp, mesh)))
    if name in ("wr", "wg"):                     # rwkv square matrices
        return Spec((_if_div(shape[0], fs, mesh), _if_div(shape[1], tp, mesh)))
    if name == "a":                              # site LoRA (sites, d, r)
        return Spec((None, _if_div(shape[1], fs, mesh), None))
    if name == "b" and nd == 3:                  # site LoRA (sites, r, d)
        return Spec((None, None, _if_div(shape[2], fs, mesh)))
    if name == "vis_proj":                       # (vis_width, d)
        return Spec((None, _if_div(shape[1], fs, mesh)))
    if nd == 2:                                  # generic matrix: FSDP × TP
        return Spec((_if_div(shape[0], fs, mesh), _if_div(shape[1], tp, mesh)))
    return Spec([None] * nd)


def _leaf_name(path) -> str:
    for key in reversed(path):
        if isinstance(key, str):
            return key
    return ""


def param_specs(cfg, params, mesh: NamedMesh):
    """A tree of Specs of the parameters' structure (the parameters may be
    ``meta`` tensors: ``registry.abstract_params``)."""

    def one(path, leaf):
        # a layer's leaf (a tree.Layer in its path) is the tail of the
        # reference's stacked leaf, whose spec is (None, *this); zamba2's
        # site leaves are unstacked in both (src/repro/models/sharding.py:117)
        return _param_rule(_leaf_name(path), tuple(leaf.shape), cfg, mesh)

    return T.tree_map_with_path(one, params)


def opt_specs(cfg, opt_state: dict, mesh: NamedMesh, pspecs):
    """Moments (and the fp32 master, when present) inherit the parameter
    specs (ZeRO-1); ``step`` is replicated."""
    out = {"m": pspecs, "v": pspecs, "step": Spec(())}
    if "master" in opt_state:
        out["master"] = pspecs
    return out


# --------------------------------------------------------------- batch plan
def batch_specs(cfg, batch, mesh: NamedMesh):
    """The leading (batch) dimension over (pod, data) when it divides."""
    dp, _ = mesh_axes(mesh)

    def one(path, leaf):
        b = leaf.shape[0] if leaf.ndim else 1
        spec_b = dp if b % mesh.axis_size(dp) == 0 else None
        return Spec((spec_b, *([None] * (leaf.ndim - 1))))

    return T.tree_map_with_path(one, batch)


# --------------------------------------------------------------- cache plan
def cache_specs(cfg, cache, mesh: NamedMesh):
    dp, tp = mesh_axes(mesh)
    dp_size = mesh.axis_size(dp)

    def one(path, leaf):
        name = _leaf_name(path)
        sh = tuple(leaf.shape)
        if leaf.ndim == 0:
            return Spec(())
        if name in ("k", "v", "cross_k", "cross_v"):
            # stacked (L, B, T, heads, dh) or a zamba2 site's unstacked (B, T, heads, dh)
            if leaf.ndim == 5:
                _, b_, t_, h_, _2 = sh
                lead = (None,)
            else:
                b_, t_, h_, _2 = sh
                lead = ()
            if b_ % dp_size == 0:
                return Spec((*lead, dp, None, _if_div(h_, tp, mesh), None))
            return Spec((*lead, None, _if_div(t_, "data", mesh), _if_div(h_, tp, mesh), None))
        if name in ("ckv", "kpe"):                       # (L, B, T, lat)
            _, b_, t_, _2 = sh
            if b_ % dp_size == 0:
                return Spec((None, dp, None, None))
            return Spec((None, None, _if_div(t_, "data", mesh), None))
        if name in ("ssm", "wkv"):                       # (L, B, H, dh, N | dh)
            _, b_, h_, *_2 = sh
            bspec = dp if b_ % dp_size == 0 else None
            return Spec((None, bspec, _if_div(h_, tp, mesh), None, None))
        # conv / tshift / cshift / misc: the batch over dp when it divides
        b_ = sh[1] if leaf.ndim >= 2 else 1
        bspec = dp if b_ % dp_size == 0 else None
        return Spec((None, bspec, *([None] * (leaf.ndim - 2))))

    return T.tree_map_with_path(one, cache)


def replicated(mesh: NamedMesh, tree):
    return T.tree_map_with_path(lambda path, leaf: Spec([None] * leaf.ndim), tree)
