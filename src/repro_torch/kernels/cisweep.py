"""cuPC-S neighbour sweep: the kernel of ``csrc/cisweep.cu`` and its plain
PyTorch version.

Port of ``src/repro/kernels/cisweep.py::cisweep_kernel`` in the natural
batch-first layout: g (B, ℓ, ℓ), u (B, ℓ), var (B,) from cholinv, cj_s
(B, P, ℓ), cij (B, P), mask (B, P) → (B, P) bool, independence ∧ mask.
"""
from __future__ import annotations

import numpy as np
import torch

from . import build
from .cholinv import MAX_ELL


def cisweep_plain(g, u, var, cj_s, cij, mask, tau: float) -> torch.Tensor:
    """Plain version, in ``_cisweep_kernel``'s order of operations."""
    ell = u.shape[-1]
    tau32 = float(np.float32(tau))
    w = [cj_s[:, :, i] for i in range(ell)]
    num = cij
    var_j = None
    for i in range(ell):
        num = num - w[i] * u[:, i, None]
        t = w[i] * w[i] * g[:, i, i, None]
        var_j = 1.0 - t if var_j is None else var_j - t
        for j in range(i + 1, ell):
            var_j = var_j - 2.0 * w[i] * w[j] * g[:, i, j, None]
    rho = num * torch.rsqrt(torch.clamp(var[:, None] * var_j, min=1e-20))
    rho = torch.clamp(rho, -0.9999999, 0.9999999)
    return (torch.abs(torch.atanh(rho)) <= tau32) & mask.to(torch.bool)


def cisweep(g, u, var, cj_s, cij, mask, tau: float) -> torch.Tensor:
    """A CUDA tensor runs the hand kernel; a CPU tensor the plain version."""
    b, p, ell = cj_s.shape
    if (g.shape != (b, ell, ell) or u.shape != (b, ell) or var.shape != (b,)
            or cij.shape != (b, p) or mask.shape != (b, p)):
        raise ValueError("cisweep shapes disagree: g (B,ℓ,ℓ), u (B,ℓ), var (B,), "
                         "cj_s (B,P,ℓ), cij/mask (B,P)")
    if any(t.dtype != torch.float32 for t in (g, u, var, cj_s, cij)):
        raise ValueError("cisweep float inputs must be float32")
    if mask.dtype not in (torch.bool, torch.uint8):
        raise ValueError(f"mask must be bool or uint8, got {mask.dtype}")
    if not 1 <= ell <= MAX_ELL:
        raise ValueError(f"ℓ must lie in 1..{MAX_ELL}, got {ell}")
    if g.device.type == "cpu":
        return cisweep_plain(g, u, var, cj_s, cij, mask, tau)
    mask8 = mask.view(torch.uint8) if mask.dtype == torch.bool else mask
    build.require_cuda(g, u, var, cj_s, cij, mask8)
    out = torch.empty((b, p), dtype=torch.uint8, device=g.device)
    if b and p:
        build.launch("cisweep", "repro_cisweep", g.device, g.data_ptr(), u.data_ptr(),
                     var.data_ptr(), cj_s.data_ptr(), cij.data_ptr(), mask8.data_ptr(),
                     out.data_ptr(), b, p, ell, float(tau))
    return out.view(torch.bool)
