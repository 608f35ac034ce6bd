"""Carry a run's state between the JAX package and the port.

The system has no weights: a run's state is the samples x, the
correlation matrix C (or, under the discrete test, the level codes and
arities of ``DiscreteStats``), the adjacency and the sepset tensor. The
JAX package hands them over as numpy arrays; :func:`state_from_numpy`
turns them into port tensors with the reference's dtypes (f32, f32, bool,
int32; int32 codes and arities), and :func:`run_to_numpy` goes the other
way. Together they let a caller start a port level from the reference's
(adj, sep) after level ℓ − 1.

The LM side has weights: :func:`lm_params_from_numpy` carries the JAX
``lm_init`` pytree, as numpy arrays, into the port's ``models.LM``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .core.cit import DiscreteStats
from .device import resolve_device

_DTYPES = {"x": torch.float32, "c": torch.float32, "adj": torch.bool, "sep": torch.int32}


@dataclass
class RunState:
    x: torch.Tensor | None = None  # (m, n) f32 samples
    c: torch.Tensor | None = None  # (n, n) f32 correlation matrix
    adj: torch.Tensor | None = None  # (n, n) bool skeleton
    sep: torch.Tensor | None = None  # (n, n, Lmax) int32 sepsets
    stats: DiscreteStats | None = None  # (m, n) int32 codes, (n,) int32 arities


def state_from_numpy(*, x=None, c=None, adj=None, sep=None, codes=None, arities=None,
                     device=None) -> RunState:
    """numpy arrays (any of x, c, adj, sep, and codes with arities) → a
    RunState on ``device`` (None: the CUDA card)."""
    dev = resolve_device(device)
    if (codes is None) != (arities is None):
        raise ValueError("codes and arities go together")
    stats = None
    if codes is not None:
        codes, arities = np.asarray(codes), np.asarray(arities)
        for name, arr in (("codes", codes), ("arities", arities)):
            if not np.issubdtype(arr.dtype, np.integer):
                raise ValueError(f"{name} must be integer, got {arr.dtype}")
        if codes.ndim != 2 or arities.shape != codes.shape[1:]:
            raise ValueError(f"expected (m, n) codes and (n,) arities, got {codes.shape} "
                             f"and {arities.shape}")
        stats = DiscreteStats(codes=torch.tensor(codes, dtype=torch.int32, device=dev),
                              arities=torch.tensor(arities, dtype=torch.int32, device=dev))
    given = {"x": x, "c": c, "adj": adj, "sep": sep}
    out = {}
    for name, arr in given.items():
        if arr is None:
            out[name] = None
            continue
        arr = np.asarray(arr)
        if name == "adj" and arr.dtype != np.bool_:
            raise ValueError(f"adj must be bool, got {arr.dtype}")
        if name == "sep" and not np.issubdtype(arr.dtype, np.integer):
            raise ValueError(f"sep must be integer, got {arr.dtype}")
        out[name] = torch.tensor(arr, dtype=_DTYPES[name], device=dev)
    return RunState(**out, stats=stats)


def run_to_numpy(state: RunState) -> dict:
    """A RunState → {name: numpy array} for the fields that are set."""
    out = {name: getattr(state, name).cpu().numpy() for name in _DTYPES
           if getattr(state, name) is not None}
    if state.stats is not None:
        out["codes"] = state.stats.codes.cpu().numpy()
        out["arities"] = state.stats.arities.cpu().numpy()
    return out


def _lm_tensor(arr, dev) -> torch.Tensor:
    arr = np.asarray(arr)
    if not np.issubdtype(arr.dtype, np.floating):
        raise ValueError(f"LM parameters must be floating point, got {arr.dtype}")
    return torch.tensor(arr, device=dev)


def _tree_map(fn, tree):
    return ({k: _tree_map(fn, v) for k, v in tree.items()} if isinstance(tree, dict)
            else fn(tree))


def lm_params_from_numpy(cfg, tree: dict, device=None):
    """The reference's ``lm_init`` pytree as numpy arrays (``embed``,
    ``segments`` each stacked (L, ...), ``final_norm``, and ``unembed`` and
    ``vis_proj`` where present) → the port's ``models.transformer.LM`` on
    ``device`` (None: the CUDA card), one ``Block`` a layer. The layouts are
    the reference's, so each array is copied, and a segment's only
    unstacked; the dtypes are kept."""
    from .models.transformer import LM, program

    dev = resolve_device(device)
    segs = program(cfg)
    if len(tree["segments"]) != len(segs):
        raise ValueError(f"{cfg.name}: {len(tree['segments'])} segments given, the program "
                         f"has {len(segs)}")
    layers = []
    for spec, stacked in zip(segs, tree["segments"]):
        flat = _tree_map(lambda a: _lm_tensor(a, dev), stacked)
        if any(t.shape[0] != spec.count for t in _leaves(flat)):
            raise ValueError(f"{cfg.name}: a {spec.kind} segment stacks {spec.count} layers")
        layers.append([_tree_map(lambda t, i=i: t[i].clone(), flat)
                       for i in range(spec.count)])
    rest = {k: _tree_map(lambda a: _lm_tensor(a, dev), v) for k, v in tree.items()
            if k != "segments"}
    return LM(cfg, {**rest, "segments": layers})


def _leaves(tree):
    return [x for v in tree.values() for x in _leaves(v)] if isinstance(tree, dict) else [tree]
