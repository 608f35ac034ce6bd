"""The PC engines' mesh factory (``make_pc_mesh`` of
``src/repro/launch/mesh.py``). A function, so that importing this module
touches no device."""
from __future__ import annotations


def make_pc_mesh(n_devices: int | None = None, device=None):
    """Flat mesh for the PC engines (rows shard over every entry). Goes
    through the one sharding layer (``core/sharding.py``) so that launcher
    and engine meshes cannot disagree. ``device="cpu"`` makes
    ``n_devices`` logical CPU shards; None takes the visible cards."""
    from ..core.sharding import make_mesh

    return make_mesh(n_devices, device=device)
