"""Per-set SPD inverse for cuPC-S: the kernel of ``csrc/cholinv.cu`` and
its plain PyTorch version.

Port of ``src/repro/kernels/cholinv.py::cholinv_kernel`` in the natural
batch-first layout: m2 (B, ℓ, ℓ), ci (B, ℓ) → g (B, ℓ, ℓ), u (B, ℓ),
var (B,). Both versions keep ``_cholinv_kernel``'s order of operations,
with each product that feeds a running sum fused into one multiply-add,
as XLA evaluates the reference on the CPU.
"""
from __future__ import annotations

import torch

from . import build

MAX_ELL = 8  # template instantiations of csrc/cholinv.cu and csrc/cisweep.cu
JITTER = 1e-8  # Tikhonov jitter, scaled by the block's mean diagonal


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a·b + c rounded once to fp32: the product of two fp32 values is exact
    in float64, so this is a fused multiply-add up to a rare double
    rounding of the float64 sum."""
    return (a.double() * b.double() + c.double()).float()


def cholinv_plain(m2: torch.Tensor, ci: torch.Tensor, jitter: float = JITTER):
    """Plain version: the unrolled Cholesky → L⁻¹ → Gram recurrence of the
    reference kernel, one elementwise op over the batch per scalar step."""
    ell = m2.shape[-1]
    f32 = torch.float32
    jit = torch.tensor(jitter, dtype=f32, device=m2.device)
    inv_l = torch.tensor(1.0 / ell, dtype=f32, device=m2.device)
    scale = m2[:, 0, 0]
    for i in range(1, ell):
        scale = scale + m2[:, i, i]
    jit_eff = jit * (scale * inv_l)
    a = [[m2[:, i, j] + jit_eff if i == j else m2[:, i, j] for j in range(ell)]
         for i in range(ell)]
    l = [[None] * ell for _ in range(ell)]
    for j in range(ell):
        s = a[j][j]
        for k in range(j):
            s = _fma(-l[j][k], l[j][k], s)
        l[j][j] = torch.sqrt(torch.clamp(s, min=1e-20))
        inv_ljj = 1.0 / l[j][j]
        for i in range(j + 1, ell):
            s = a[i][j]
            for k in range(j):
                s = _fma(-l[i][k], l[j][k], s)
            l[i][j] = s * inv_ljj
    minv = [[None] * ell for _ in range(ell)]
    for j in range(ell):
        minv[j][j] = 1.0 / l[j][j]
        for i in range(j + 1, ell):
            s = l[i][j] * minv[j][j]
            for k in range(j + 1, i):
                s = _fma(l[i][k], minv[k][j], s)
            minv[i][j] = -s / l[i][i]
    cv = [ci[:, i] for i in range(ell)]
    g = torch.empty_like(m2)
    u = [None] * ell
    for i in range(ell):
        for j in range(i, ell):
            s = minv[j][i] * minv[j][j]
            for k in range(j + 1, ell):
                s = _fma(minv[k][i], minv[k][j], s)
            g[:, i, j] = s
            g[:, j, i] = s
            u[i] = s * cv[j] if u[i] is None else _fma(s, cv[j], u[i])
            if i != j:
                u[j] = s * cv[i] if u[j] is None else _fma(s, cv[i], u[j])
    var = torch.ones_like(cv[0])
    for i in range(ell):
        var = _fma(-cv[i], u[i], var)
    return g, torch.stack(u, dim=-1), var


def cholinv(m2: torch.Tensor, ci: torch.Tensor, jitter: float = JITTER):
    """m2: (B, ℓ, ℓ) fp32 SPD blocks, ci: (B, ℓ) fp32 → (g, u, var), with
    the Tikhonov term ``jitter`` × the block's mean diagonal. A CUDA
    tensor runs the hand kernel; a CPU tensor the plain version."""
    b, ell = ci.shape
    if m2.shape != (b, ell, ell) or m2.dtype != torch.float32 or ci.dtype != torch.float32:
        raise ValueError(f"expected m2 (B, ℓ, ℓ) and ci (B, ℓ) float32, got "
                         f"{tuple(m2.shape)} {m2.dtype} and {tuple(ci.shape)} {ci.dtype}")
    if not 1 <= ell <= MAX_ELL:
        raise ValueError(f"ℓ must lie in 1..{MAX_ELL}, got {ell}")
    if m2.device.type == "cpu":
        return cholinv_plain(m2, ci, jitter)
    build.require_cuda(m2, ci)
    g = torch.empty_like(m2)
    u = torch.empty_like(ci)
    var = torch.empty((b,), dtype=torch.float32, device=m2.device)
    if b:
        build.launch("cholinv", "repro_cholinv", m2.device, m2.data_ptr(), ci.data_ptr(),
                     g.data_ptr(), u.data_ptr(), var.data_ptr(), b, ell, float(jitter))
    return g, u, var
