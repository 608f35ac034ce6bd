"""Elastic re-meshing: move a sharded state tree onto another mesh (the
counterpart of ``src/repro/distributed/elastic.py``).

On preemption or a scale event the surviving devices form a new (smaller or
larger) mesh, and every tensor is placed again by the new mesh's specs.
The planner derives specs from the config and the mesh alone, so any
change that keeps the dimensions divisible works: shrink 8 → 4, grow, or
reshape the axes. As in the reference (``jax.device_get`` then
``jax.device_put``), every block goes through the host: one copy down, the
leaf assembled and split there, one copy up a block.
"""
from __future__ import annotations

from .. import tree as T
from ..core.sharding import NamedMesh
from ..state import ShardedTree, gather_tree, shard_tree


def _host(mesh: NamedMesh) -> NamedMesh:
    return NamedMesh(tuple(mesh.shape.values()), mesh.axis_names, ("cpu",) * mesh.size)


def _regroup(tree: ShardedTree, down: list, specs, new_mesh: NamedMesh) -> ShardedTree:
    """The host blocks ``down`` (one list a rank of ``tree``'s mesh) as
    each leaf whole, split by ``specs`` over ``new_mesh``'s ranks, still on
    the host."""
    ranks = [T.unflatten_like(tree.ranks[r], blocks) for r, blocks in enumerate(down)]
    whole = gather_tree(ShardedTree(_host(tree.mesh), tree.specs, ranks, tree.shapes), "cpu")
    return shard_tree(whole, specs, _host(new_mesh))


def remesh(tree: ShardedTree, spec_fn, new_mesh: NamedMesh) -> ShardedTree:
    """``spec_fn(new_mesh)`` -> a tree of ``Spec``s of ``tree``'s structure.
    Returns ``tree`` placed on ``new_mesh`` by those specs."""
    specs = spec_fn(new_mesh)
    devs = new_mesh.require_devices()
    down = [[x.cpu() for x in tree.leaves(r)] for r in range(tree.mesh.size)]
    split = _regroup(tree, down, specs, new_mesh)
    ranks = [T.unflatten_like(split.ranks[r], [x.to(devs[r]) for x in split.leaves(r)])
             for r in range(new_mesh.size)]
    return ShardedTree(new_mesh, specs, ranks, split.shapes)
