"""Carry a run's state between the JAX package and the port.

The system has no weights: a run's state is the samples x, the
correlation matrix C, the adjacency and the sepset tensor. The JAX package
hands them over as numpy arrays; :func:`state_from_numpy` turns them into
port tensors with the reference's dtypes (f32, f32, bool, int32), and
:func:`run_to_numpy` goes the other way. Together they let a caller start
a port level from the reference's (adj, sep) after level ℓ − 1.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .device import resolve_device

_DTYPES = {"x": torch.float32, "c": torch.float32, "adj": torch.bool, "sep": torch.int32}


@dataclass
class RunState:
    x: torch.Tensor | None = None  # (m, n) f32 samples
    c: torch.Tensor | None = None  # (n, n) f32 correlation matrix
    adj: torch.Tensor | None = None  # (n, n) bool skeleton
    sep: torch.Tensor | None = None  # (n, n, Lmax) int32 sepsets


def state_from_numpy(*, x=None, c=None, adj=None, sep=None, device=None) -> RunState:
    """numpy arrays (any of x, c, adj, sep) → a RunState on ``device``
    (None: the CUDA card)."""
    dev = resolve_device(device)
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
    return RunState(**out)


def run_to_numpy(state: RunState) -> dict:
    """A RunState → {name: numpy array} for the fields that are set."""
    return {name: getattr(state, name).cpu().numpy() for name in _DTYPES
            if getattr(state, name) is not None}
