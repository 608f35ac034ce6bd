"""C = Xnᵀ Xn / m: the tiled fp32 GEMM of ``csrc/corr.cu`` and its plain
PyTorch version.

Port of ``src/repro/kernels/corr.py::corr_matmul``. The standardisation,
clipping and unit diagonal stay in the ops wrapper (``ops.correlation``),
as they stay in jnp in the reference.
"""
from __future__ import annotations

import torch

from . import build


def corr_matmul_plain(xn: torch.Tensor) -> torch.Tensor:
    """Plain version: Xnᵀ Xn / m accumulated in float64, rounded once to
    fp32 — the value the fp32 kernel approximates."""
    x64 = xn.to(torch.float64)
    return ((x64.T @ x64) / xn.shape[0]).to(torch.float32)


def corr_matmul(xn: torch.Tensor) -> torch.Tensor:
    """xn: (m, n) fp32 standardised samples → (n, n) fp32 XnᵀXn/m.

    A CUDA tensor runs the hand kernel; a CPU tensor the plain version."""
    if xn.ndim != 2 or xn.dtype != torch.float32:
        raise ValueError(f"expected (m, n) float32 samples, got {tuple(xn.shape)} {xn.dtype}")
    if xn.device.type == "cpu":
        return corr_matmul_plain(xn)
    build.require_cuda(xn)
    m, n = xn.shape
    out = torch.empty((n, n), dtype=torch.float32, device=xn.device)
    if m and n:
        build.launch("corr", "repro_corr_xtx", xn.device, xn.data_ptr(), out.data_ptr(),
                     m, n, 1.0 / m)
    return out
