"""Activation anchors (the counterpart of ``src/repro/models/meshops.py``).

In the reference, ``shard_residual`` and ``shard_logits`` pin GSPMD's
choice for the residual stream and the logits: the batch dimension over
(pod, data). The port has no compiler to steer: the sharded train step
(``registry.make_train_step(..., mesh=)``) gathers the batch's row shards
and runs each microbatch of the global batch as one forward, the maths
the reference's anchors leave unchanged. So here the anchors check and
change nothing: under :func:`use_mesh`, the batch dimension of an anchored
tensor must hold the step's microbatch rows, and those must split evenly
over the (pod, data) ranks, else they raise. With no mesh active they do
nothing, as the reference's do on one device.
"""
from __future__ import annotations

import contextlib

BATCH = ("pod", "data")

#: the active (mesh, microbatch rows), innermost last
_ACTIVE: list = []


def current_mesh():
    """The mesh of the innermost :func:`use_mesh`, or None."""
    return _ACTIVE[-1][0] if _ACTIVE else None


@contextlib.contextmanager
def use_mesh(mesh, rows: int):
    """Anchored tensors inside hold ``rows`` rows, the global microbatch,
    which the mesh's (pod, data) axes split."""
    _ACTIVE.append((mesh, int(rows)))
    try:
        yield mesh
    finally:
        _ACTIVE.pop()


def _filter(mesh, axis):
    if axis is None:
        return None
    if isinstance(axis, tuple):
        kept = tuple(a for a in axis if a in mesh.axis_names)
        return kept if kept else None
    return axis if axis in mesh.axis_names else None


def shard_act(x, *spec):
    """``x`` unchanged; under a mesh, each dimension whose spec names
    (pod, data) axes of the mesh must hold the microbatch's rows, a
    multiple of their size. Axis names absent from the mesh are dropped, as the
    reference drops them; ``model`` splits no activation in the port."""
    if not _ACTIVE:
        return x
    mesh, rows = _ACTIVE[-1]
    for dim, axis in enumerate(spec):
        kept = _filter(mesh, axis)
        axes = tuple(a for a in ((kept,) if isinstance(kept, str) else kept or ())
                     if a in BATCH)
        if not axes:
            continue
        n = mesh.axis_size(axes)
        if x.shape[dim] != rows or rows % n:
            raise ValueError(
                f"anchor: dimension {dim} of a {tuple(x.shape)} activation holds "
                f"{x.shape[dim]} rows, but the step's microbatch has {rows}, to be split over "
                f"the mesh's {axes} ({n} ranks)")
    return x


def shard_residual(x):
    """(B, T, D) residual stream: the batch over (pod, data)."""
    return shard_act(x, BATCH, None, None)


def shard_logits(x):
    """(B, T, V) logits: the batch over (pod, data) (the vocabulary over
    ``model`` in the reference; whole in the port)."""
    return shard_act(x, BATCH, None, "model")
