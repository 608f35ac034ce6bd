"""Activation anchors (the counterpart of ``src/repro/models/meshops.py``).

In the reference, ``shard_residual`` and ``shard_logits`` pin GSPMD's
choice for the residual stream and the logits: the batch dimension over
(pod, data), the logits' vocabulary over ``model``. The port has no
compiler to steer: its steps place the work themselves, and the anchors
check it and change nothing. Under :func:`use_mesh` the batch dimension of
an anchored tensor must hold the step's rows, which must split evenly over
the (pod, data) ranks, else they raise:

* ``local=True``: the step in which each rank computes its own share
  (``models/spmd.py``, the dense and vlm families) runs each rank's rows of
  each microbatch, so an anchored tensor holds the microbatch's rows over
  the (pod, data) ranks (its vocabulary block is the rank's, which the
  check does not read);
* else: the gathered step (``registry._sharded_step``, the other families)
  runs each microbatch of the global batch as one forward, so an anchored
  tensor holds the microbatch's global rows.

With no mesh active they do nothing, as the reference's do on one device.
"""
from __future__ import annotations

import contextlib

BATCH = ("pod", "data")

#: the active (mesh, microbatch rows, local), innermost last
_ACTIVE: list = []


def current_mesh():
    """The mesh of the innermost :func:`use_mesh`, or None."""
    return _ACTIVE[-1][0] if _ACTIVE else None


@contextlib.contextmanager
def use_mesh(mesh, rows: int, local: bool = False):
    """Anchored tensors inside hold the rows of a microbatch of ``rows``
    global rows, which the mesh's (pod, data) axes split: a rank's share of
    them with ``local``, all of them without."""
    _ACTIVE.append((mesh, int(rows), local))
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
    (pod, data) axes of the mesh must hold the microbatch's rows (a rank's
    share of them under ``use_mesh(..., local=True)``), a multiple of their
    size. Axis names absent from the mesh are dropped, as the reference
    drops them; a ``model`` entry is not checked."""
    if not _ACTIVE:
        return x
    mesh, rows, local = _ACTIVE[-1]
    for dim, axis in enumerate(spec):
        kept = _filter(mesh, axis)
        axes = tuple(a for a in ((kept,) if isinstance(kept, str) else kept or ())
                     if a in BATCH)
        if not axes:
            continue
        n = mesh.axis_size(axes)
        want = rows // n if local else rows
        if x.shape[dim] != want or rows % n:
            whose = f"a rank's share of the step's microbatch of {rows}" if local else \
                f"the step's microbatch of {rows}"
            raise ValueError(
                f"anchor: dimension {dim} of a {tuple(x.shape)} activation holds "
                f"{x.shape[dim]} rows, but {whose} is {want}, the microbatch to be split over "
                f"the mesh's {axes} ({n} ranks)")
    return x


def shard_residual(x):
    """(B, T, D) residual stream: the batch over (pod, data)."""
    return shard_act(x, BATCH, None, None)


def shard_logits(x):
    """(B, T, V) logits: the batch over (pod, data), the vocabulary over
    ``model`` (a rank's block in the split step; whole in the gathered
    one)."""
    return shard_act(x, BATCH, None, "model")
