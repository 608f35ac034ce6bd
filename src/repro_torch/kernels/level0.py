"""Level 0 of the Gaussian test: the kernel of ``csrc/level0.cu``.

Port of ``src/repro/kernels/level0.py::level0_kernel``: adj = |atanh(clip
C)| > τ ∧ i ≠ j. Its plain PyTorch version is the level loop's own
``core/levels.level0``, which the kernel equals exactly.
"""
from __future__ import annotations

import torch

from . import build


def level0_kernel(c: torch.Tensor, tau: float) -> torch.Tensor:
    """c: (n, n) float32 on the card → (n, n) bool adjacency. Raises for a
    tensor that is not on a CUDA device."""
    n = c.shape[0]
    if c.shape != (n, n) or c.dtype != torch.float32:
        raise ValueError(f"expected (n, n) float32 C, got {tuple(c.shape)} {c.dtype}")
    build.require_cuda(c)
    adj = torch.empty((n, n), dtype=torch.uint8, device=c.device)
    if n:
        build.launch("level0", "repro_level0", c.device, c.data_ptr(), adj.data_ptr(), n,
                     float(tau))
    return adj.view(torch.bool)
