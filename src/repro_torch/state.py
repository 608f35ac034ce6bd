"""Carry a run's state between the JAX package and the port.

The system has no weights: a run's state is the samples x, the
correlation matrix C (or, under the discrete test, the level codes and
arities of ``DiscreteStats``), the adjacency and the sepset tensor. The
JAX package hands them over as numpy arrays; :func:`state_from_numpy`
turns them into port tensors with the reference's dtypes (f32, f32, bool,
int32; int32 codes and arities), and :func:`run_to_numpy` goes the other
way. Together they let a caller start a port level from the reference's
(adj, sep) after level ℓ − 1.
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
