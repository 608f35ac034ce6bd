"""Mesh factories (the counterpart of ``src/repro/launch/mesh.py``).
Functions, so that importing this module touches no device."""
from __future__ import annotations


def make_production_mesh(*, multi_pod: bool = False):
    """Single pod: (16, 16) = 256 ranks, axes (data, model). Multi-pod:
    (2, 16, 16) = 512 ranks, axes (pod, data, model); ``pod`` is pure data
    parallelism across the slow inter-pod links. A planning mesh (no
    devices): the sharding planner reads its axis sizes only."""
    from ..core.sharding import NamedMesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return NamedMesh(shape, axes)


def make_lm_mesh(shape, axes, devices=None, device=None):
    """A named mesh of ``shape`` over ``axes`` whose ranks are ``devices``
    (row-major; repeats allowed: ``("cuda:0",) * 4`` is four logical shards
    of one card, ``("cpu",) * 8`` eight of the CPU). Without ``devices``:
    ``device="cpu"`` gives logical CPU shards; None the visible cards, one
    a rank (raises, with the logical-shard hint, when fewer are visible)."""
    import math

    from ..core.sharding import NamedMesh, make_mesh

    if devices is None:
        devices = make_mesh(math.prod(shape), device=device).devices
    return NamedMesh(shape, axes, devices)


def make_pc_mesh(n_devices: int | None = None, device=None):
    """Flat mesh for the PC engines (rows shard over every entry). Goes
    through the one sharding layer (``core/sharding.py``) so that launcher
    and engine meshes cannot disagree. ``device="cpu"`` makes
    ``n_devices`` logical CPU shards; None takes the visible cards."""
    from ..core.sharding import make_mesh

    return make_mesh(n_devices, device=device)
