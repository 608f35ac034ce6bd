"""Level 0 of the Gaussian test: the kernel of ``csrc/level0.cu``.

Port of ``src/repro/kernels/level0.py::level0_kernel``: adj = |atanh(clip
C)| > τ ∧ i ≠ j. Two entries share the kernel: ``level0_kernel``, the
adjacency alone, and ``level0_span``, the driver's whole level-0 span
(adjacency, level-0 sepsets and max degree) in one launch. Their plain
PyTorch versions are the level loop's own ``core/levels.level0`` and
``core/levels.level0_span``, which the kernel equals exactly.
"""
from __future__ import annotations

import torch

from . import build


def _check(c: torch.Tensor) -> torch.Tensor:
    """The kernel reads C's rows in aligned 16-byte loads: a view that
    starts off a 16-byte boundary is copied first."""
    n = c.shape[0]
    if c.shape != (n, n) or c.dtype != torch.float32:
        raise ValueError(f"expected (n, n) float32 C, got {tuple(c.shape)} {c.dtype}")
    build.require_cuda(c)
    return c.clone() if c.data_ptr() % 16 else c


def level0_kernel(c: torch.Tensor, tau: float) -> torch.Tensor:
    """c: (n, n) float32 on the card → (n, n) bool adjacency. Raises for a
    tensor that is not on a CUDA device."""
    c = _check(c)
    n = c.shape[0]
    adj = torch.empty((n, n), dtype=torch.uint8, device=c.device)
    if n:
        build.launch("level0", "repro_level0", c.device, c.data_ptr(), adj.data_ptr(), n,
                     float(tau))
    return adj.view(torch.bool)


def level0_span(c: torch.Tensor, tau: float, sepset_depth: int):
    """c: (n, n) float32 on the card → (adj (n, n) bool, sep (n, n,
    sepset_depth) int32 with slot 0 −1 where the edge is kept and −2 where
    it is removed (the diagonal too) and −1 elsewhere, max_deg: 0-d int32,
    the largest row degree of adj), all on the card, in one launch."""
    c = _check(c)
    if sepset_depth < 1:
        raise ValueError(f"sepset_depth must be at least 1, got {sepset_depth}")
    n = c.shape[0]
    adj = torch.empty((n, n), dtype=torch.uint8, device=c.device)
    sep = torch.empty((n, n, sepset_depth), dtype=torch.int32, device=c.device)
    max_deg = torch.empty((), dtype=torch.int32, device=c.device)
    build.launch("level0", "repro_level0_span", c.device, c.data_ptr(), adj.data_ptr(),
                 sep.data_ptr(), max_deg.data_ptr(), n, int(sepset_depth), float(tau))
    return adj.view(torch.bool), sep, max_deg
