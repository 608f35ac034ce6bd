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
``lm_init`` (or ``whisper_init``) pytree, as numpy arrays, into the port's
``models.LM`` (or ``models.whisper.Whisper``), and
:func:`opt_state_from_numpy` the reference's AdamW state into the port's.
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
    if tree is None:
        return None
    return ({k: _tree_map(fn, v) for k, v in tree.items()} if isinstance(tree, dict)
            else fn(tree))


def _unstack(cfg, what: str, stacked, count: int, dev) -> list:
    flat = _tree_map(lambda a: _lm_tensor(a, dev), stacked)
    if any(t.shape[0] != count for t in _leaves(flat)):
        raise ValueError(f"{cfg.name}: a {what} stacks {count} layers")
    return [_tree_map(lambda t, i=i: t[i].clone(), flat) for i in range(count)]


def lm_params_from_numpy(cfg, tree: dict, device=None):
    """The reference's ``lm_init`` pytree as numpy arrays (``embed``,
    ``segments`` each stacked (L, ...) and None for a zamba2 ``site``,
    ``final_norm``, and ``unembed``, ``vis_proj`` and ``site`` (``shared``
    and ``lora``, or ``lora`` None) where present) → the port's
    ``models.transformer.LM`` on ``device`` (None: the CUDA card), one
    ``Block`` a layer. For the audio family, ``whisper_init``'s tree
    (``enc_blocks`` and ``dec_blocks`` stacked, ``enc_norm``, ``dec_norm``,
    ``embed``) → ``models.whisper.Whisper``. The layouts are the
    reference's, so each array is copied, and a stack's only unstacked; the
    dtypes are kept."""
    from .models.transformer import LM, program

    dev = resolve_device(device)
    if cfg.family == "audio":
        from .models.whisper import Whisper

        counts = {"enc_blocks": cfg.n_enc_layers, "dec_blocks": cfg.n_layers}
        return Whisper(cfg, {k: (_unstack(cfg, k, v, counts[k], dev) if k in counts
                                 else _tree_map(lambda a: _lm_tensor(a, dev), v))
                             for k, v in tree.items()})
    segs = program(cfg)
    if len(tree["segments"]) != len(segs):
        raise ValueError(f"{cfg.name}: {len(tree['segments'])} segments given, the program "
                         f"has {len(segs)}")
    layers = []
    for spec, stacked in zip(segs, tree["segments"]):
        if spec.kind == "site":
            if stacked is not None:
                raise ValueError(f"{cfg.name}: a site segment holds no parameters (the "
                                 "shared block is the tree's 'site')")
            layers.append([])
            continue
        layers.append(_unstack(cfg, f"{spec.kind} segment", stacked, spec.count, dev))
    rest = {k: _tree_map(lambda a: _lm_tensor(a, dev), v) for k, v in tree.items()
            if k != "segments"}
    return LM(cfg, {**rest, "segments": layers})


def opt_state_from_numpy(cfg, state: dict, device=None) -> dict:
    """The reference's ``adamw_init`` state as numpy arrays (``m``, ``v``
    and, under ``master_fp32``, ``master``: trees of the parameters' shapes;
    ``step``) → the port's (``optim.adamw_init``'s layout: each tree as
    the plain containers of the parameter module, a stack's layers
    unstacked; ``step`` a () int32 tensor) on ``device``."""
    from .tree import tree_map

    dev = resolve_device(device)
    out = {name: tree_map(lambda t: t.detach(), lm_params_from_numpy(cfg, state[name], dev))
           for name in ("m", "v", "master") if name in state}
    out["step"] = torch.tensor(np.asarray(state["step"]), dtype=torch.int32, device=dev)
    return out


def _leaves(tree):
    if tree is None:
        return []
    return [x for v in tree.values() for x in _leaves(v)] if isinstance(tree, dict) else [tree]
