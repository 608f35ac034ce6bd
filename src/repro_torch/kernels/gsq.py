"""Discrete G² per worklist cell: the kernel of ``csrc/gsq.cu`` and its
plain PyTorch version.

Port of ``src/repro/kernels/gsq.py::gsq_cells``. Each cell carries one
joint code per sample, jc = (cfg·r + x_i)·r + x_j ∈ [0, K), K = q·r²
(anything outside [0, K) is padding). Its K-cell contingency table reduces
to G² = 2 Σ N·log(N·N₊₊c / (N_a+c·N₊bc)) through the fold of the
reference's ``_g2_from_counts``.

The layout is cell-major, jc (B, M), the transpose of the reference's
(M, B): the port's callers build each cell's samples contiguously, which
is what the kernel reads best. Kernel and plain version follow the same
fold with the same roundings, so on one device they are bitwise equal;
across frameworks the values agree to float32 rounding only.
"""
from __future__ import annotations

import torch

from . import build


def _check(jc: torch.Tensor, r: int, q: int) -> int:
    if jc.ndim != 2 or jc.dtype != torch.int32:
        raise ValueError(f"expected (B, M) int32 joint codes, got {tuple(jc.shape)} {jc.dtype}")
    if r < 1 or q < 1:
        raise ValueError(f"r and q must be positive, got r={r} q={q}")
    return q * r * r


def gsq_ref(jc: torch.Tensor, *, r: int, q: int) -> torch.Tensor:
    """Plain version: jc (B, M) int32 → G² (B,) float32. Exact integer
    histograms, margins as exact float sums, then the terms and their sum
    in the kernel's (and the reference's) order, k = (c·r + a)·r + b."""
    k_total = _check(jc, r, q)
    b, m = jc.shape
    dev = jc.device
    valid = (jc >= 0) & (jc < k_total)
    base = torch.arange(b, dtype=torch.int64, device=dev)[:, None] * k_total
    idx = (torch.where(valid, jc, 0).to(torch.int64) + base).reshape(-1)
    cnt = torch.zeros(b * k_total, dtype=torch.int32, device=dev)
    cnt.index_add_(0, idx, valid.reshape(-1).to(torch.int32))
    cnt = cnt.reshape(b, q, r, r).to(torch.float32)
    log_nc = torch.log(torch.clamp(cnt.sum(dim=(2, 3)), min=1.0))[:, :, None, None]
    log_na = torch.log(torch.clamp(cnt.sum(dim=3), min=1.0))[:, :, :, None]
    log_nb = torch.log(torch.clamp(cnt.sum(dim=2), min=1.0))[:, :, None, :]
    term = cnt * (((torch.log(torch.clamp(cnt, min=1.0)) + log_nc) - log_na) - log_nb)
    term = torch.where(cnt > 0, term, 0.0).reshape(b, k_total)
    g2 = torch.zeros(b, dtype=torch.float32, device=dev)
    for k in range(k_total):
        g2 = g2 + term[:, k]
    return 2.0 * g2


def gsq_cells(jc: torch.Tensor, *, r: int, q: int) -> torch.Tensor:
    """The hand kernel: jc (B, M) int32 on the card → G² (B,) float32.
    Raises for a tensor that is not on a CUDA device."""
    k_total = _check(jc, r, q)
    build.require_cuda(jc)
    b, m = jc.shape
    out = torch.empty(b, dtype=torch.float32, device=jc.device)
    if b:
        build.launch("gsq", "repro_gsq", jc.device, jc.data_ptr(), out.data_ptr(), b, m,
                     k_total, r)
    return out
