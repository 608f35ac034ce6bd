"""Trees of tensors: the few pytree operations the reference takes from
``jax.tree_util``, over the port's containers.

A tree is a dict (children in sorted key order, as JAX flattens a dict),
a list or tuple (in order), None (no leaf), a tensor (a leaf), or a model
module: a ``ParamTree`` reads as the dict of its parameters and
submodules, an ``nn.ModuleList`` as a list. The reference stacks a
segment's layers into one leaf of shape (L, ...); the port holds a
``Block`` a layer in a ``ModuleList``. Such a list's indices are
:class:`Layer`\\ s in a leaf's path, and :func:`as_tree` keeps them as a
:class:`Layers` list, so that the optimizer decides weight decay by the
stacked rank and sums the global norm in the reference's leaf order.
"""
from __future__ import annotations

import copy

import torch
from torch import nn


class Layer(int):
    """A layer's index in a stack (a path component)."""


class Layers(list):
    """The layers of one stack: the reference holds each parameter of them
    as one stacked leaf."""


def _is_stack(node) -> bool:
    from .models.transformer import Block

    return isinstance(node, Layers) or (isinstance(node, nn.ModuleList) and len(node) > 0
                                        and isinstance(node[0], Block))


def _children(node):
    """[(key, child)] of a container, or None for a leaf."""
    if isinstance(node, (nn.ModuleList, list, tuple)):
        idx = Layer if _is_stack(node) else int
        return [(idx(i), child) for i, child in enumerate(node)]
    if isinstance(node, nn.Module):
        kids = {k: v for k, v in node._parameters.items() if v is not None}
        kids.update(node._modules)
        return sorted(kids.items())
    if isinstance(node, dict):
        return sorted(node.items())
    return None


def flatten_with_path(tree, path: tuple = ()) -> list[tuple[tuple, torch.Tensor]]:
    """[(path, leaf)] in the flatten order."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(path, tree)]
    return [item for key, child in kids for item in flatten_with_path(child, path + (key,))]


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_path(tree)]


def stacked_ndim(path: tuple, leaf) -> int:
    """The leaf's rank as the reference holds it: one more inside a stack."""
    return leaf.ndim + any(isinstance(k, Layer) for k in path)


def stacked_groups(tree) -> list[list[int]]:
    """The leaves' indices grouped by the reference's stacked leaf (the path
    without its layer index), in the reference's flatten order."""
    groups: dict[tuple, list[int]] = {}
    for i, (path, _) in enumerate(flatten_with_path(tree)):
        groups.setdefault(tuple(k for k in path if not isinstance(k, Layer)), []).append(i)
    return list(groups.values())


def as_tree(node):
    """Modules as plain containers (a ``ParamTree`` a dict, a stack a
    :class:`Layers`), the same leaf tensors."""
    if node is None:
        return None
    if isinstance(node, (nn.ModuleList, list, tuple)):
        out = [as_tree(child) for child in node]
        if _is_stack(node):
            return Layers(out)
        return tuple(out) if isinstance(node, tuple) else out
    if isinstance(node, (nn.Module, dict)):
        items = node.items() if isinstance(node, dict) else (
            [(k, v) for k, v in node._parameters.items()] + list(node._modules.items()))
        return {k: as_tree(v) for k, v in items}
    return node


def tree_map(fn, tree):
    """``fn`` on every leaf; modules come back as plain containers."""
    if tree is None:
        return None
    if isinstance(tree, (nn.Module, list, tuple, dict)):
        tree = as_tree(tree)
        if isinstance(tree, dict):
            return {k: tree_map(fn, v) for k, v in tree.items()}
        out = [tree_map(fn, v) for v in tree]
        return type(tree)(out) if isinstance(tree, (Layers, tuple)) else out
    return fn(tree)


def unflatten_like(template, new_leaves: list):
    """A tree of ``template``'s structure holding ``new_leaves`` (in the
    flatten order). A module comes back as a new module of its class
    (the template is not changed); a parameter keeps its
    ``requires_grad``."""
    it = iter(new_leaves)
    out = _rebuild(template, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def _rebuild(node, it):
    if node is None:
        return None
    kids = _children(node)
    if kids is None:
        leaf = next(it)
        return nn.Parameter(leaf, requires_grad=node.requires_grad) \
            if isinstance(node, nn.Parameter) else leaf
    new = {key: _rebuild(child, it) for key, child in kids}
    if isinstance(node, nn.Module):
        mod = copy.copy(node)
        mod._parameters = {k: new.get(k) for k in node._parameters}
        mod._modules = ({str(i): new[i] for i in range(len(node))}
                        if isinstance(node, nn.ModuleList)
                        else {k: new[k] for k in node._modules})
        return mod
    if isinstance(node, dict):
        return {k: new[k] if k in new else None for k in node}
    out = [new[i] for i in range(len(node))]
    return type(node)(out) if isinstance(node, (Layers, tuple)) else out


def treedef_str(tree) -> str:
    """The structure in the form of ``str(jax.tree_util.tree_structure)``."""
    return f"PyTreeDef({_structure(tree)})"


def _structure(tree) -> str:
    if tree is None:
        return "None"
    if isinstance(tree, nn.Module):
        tree = as_tree(tree)
    if isinstance(tree, dict):
        return "{" + ", ".join(f"'{k}': {_structure(v)}" for k, v in sorted(tree.items())) + "}"
    if isinstance(tree, tuple):
        inner = ", ".join(_structure(v) for v in tree)
        return f"({inner},)" if len(tree) == 1 else f"({inner})"
    if isinstance(tree, list):
        return "[" + ", ".join(_structure(v) for v in tree) + "]"
    return "*"
