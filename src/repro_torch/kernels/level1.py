"""Dense level-1 cube: the kernel of ``csrc/level1.cu`` and its plain
PyTorch version.

Port of ``src/repro/kernels/level1.py::level1_dense_kernel``:
removed[i, j] says some k ∈ adj(i) ∪ adj(j), k ∉ {i, j}, separates the
alive edge (i, j) at ℓ = 1; kwin[i, j] is the least separating k in
adj(i) \\ {j}, else 2^30 (row-local, for ``levels.commit_dense_l1``).
"""
from __future__ import annotations

import numpy as np
import torch

from . import build

BIG = 2**30
#: half-width of the kernel's atanh window around τ, relative, in z
WINDOW = 2.0**-16


def atanh_window(tau: float) -> tuple[float, float]:
    """(lo, hi), float32 values with lo < tanh τ < hi: the level-1 and
    sgrid kernels decide |ρ| < lo independent and |ρ| > hi dependent
    without an atanh (``csrc/window.cuh``). They sit
    τ·2^-16 inside and outside the threshold in z, computed in float64
    from the float32 τ the kernel compares against and rounded outward,
    so every |ρ| outside [lo, hi] has |atanh ρ| at least that far from τ:
    more than 40 times atanhf's documented 3-ulp error."""
    t = float(np.float32(tau))
    lo = np.float32(np.tanh(t * (1.0 - WINDOW)))
    if float(lo) > np.tanh(t * (1.0 - WINDOW)):
        lo = np.nextafter(lo, np.float32(0))
    hi = np.float32(np.tanh(t * (1.0 + WINDOW)))
    if float(hi) < np.tanh(t * (1.0 + WINDOW)):
        hi = np.nextafter(hi, np.float32(2))
    return float(lo), float(hi)


def atanh_window_check(rho: torch.Tensor, tau: float):
    """The kernel's level-1 decision on CUDA float32 ρ values, with and
    without the atanh window: (windowed, |atanhf ρ| ≤ τ), uint8 each. A
    check of the window, not counted as a level-1 launch."""
    build.require_cuda(rho)
    pref = torch.empty(rho.shape, dtype=torch.uint8, device=rho.device)
    direct = torch.empty_like(pref)
    if rho.numel():
        build.launch("level1", "repro_atanh_window", rho.device, rho.data_ptr(),
                     pref.data_ptr(), direct.data_ptr(), rho.numel(), float(tau),
                     *atanh_window(tau), kernels=0)
    return pref, direct


def level1_dense_plain(c: torch.Tensor, adj: torch.Tensor, tau: float, *,
                       block: int = 64):
    """Plain version, chunked over blocks of i so that no (n, n, n)
    intermediate is formed. Same arithmetic as the kernel: products,
    differences and the rsqrt in fp32, |atanh| ≤ τ in fp32."""
    n = c.shape[0]
    adj = adj.to(torch.bool)
    tau32 = float(np.float32(tau))
    dev = c.device
    ks = torch.arange(n, device=dev)
    removed = torch.zeros((n, n), dtype=torch.bool, device=dev)
    kwin = torch.full((n, n), BIG, dtype=torch.int32, device=dev)
    one_m_cc = 1.0 - c * c  # (j, k)
    for i0 in range(0, n, block):
        i1 = min(n, i0 + block)
        rows = torch.arange(i0, i1, device=dev)
        cik = c[i0:i1, None, :]  # (b, 1, k)
        num = c[i0:i1, :, None] - cik * c[None, :, :]
        den2 = (1.0 - cik * cik) * one_m_cc[None, :, :]
        rho = num * torch.rsqrt(torch.clamp(den2, min=1e-20))
        rho = torch.clamp(rho, -0.9999999, 0.9999999)
        indep = torch.abs(torch.atanh(rho)) <= tau32  # (b, j, k)
        k_own = adj[i0:i1, None, :]
        neq = (ks[None, None, :] != rows[:, None, None]) & (ks[None, None, :] != ks[None, :, None])
        alive = adj[i0:i1] & (rows[:, None] != ks[None, :])
        sep_own = indep & k_own & neq & alive[:, :, None]
        sep = sep_own | (indep & adj[None, :, :] & neq & alive[:, :, None])
        removed[i0:i1] = sep.any(dim=-1)
        kmin = torch.where(sep_own, ks.to(torch.int32)[None, None, :], BIG).amin(dim=-1)
        kwin[i0:i1] = kmin.to(torch.int32)
    return removed, kwin


def level1_dense_kernel(c: torch.Tensor, adj: torch.Tensor, tau: float):
    """c: (n, n) fp32, adj: (n, n) bool or uint8 → (removed (n, n) bool,
    kwin (n, n) int32). A CUDA tensor runs the hand kernel; a CPU tensor
    the plain version."""
    n = c.shape[0]
    if c.shape != (n, n) or adj.shape != (n, n) or c.dtype != torch.float32:
        raise ValueError(f"expected (n, n) float32 C and (n, n) adj, got "
                         f"{tuple(c.shape)} {c.dtype} and {tuple(adj.shape)}")
    if adj.dtype not in (torch.bool, torch.uint8):
        raise ValueError(f"adj must be bool or uint8, got {adj.dtype}")
    if c.device.type == "cpu":
        return level1_dense_plain(c, adj, tau)
    adj8 = adj.view(torch.uint8) if adj.dtype == torch.bool else adj
    build.require_cuda(c, adj8)
    # rows padded with zeros to a multiple of 4 floats: the kernel reads
    # four k a lane in one 16-byte load
    pad = -n % 4
    c_pad = torch.nn.functional.pad(c, (0, pad))
    adj_pad = torch.nn.functional.pad(adj8, (0, pad))
    removed = torch.empty((n, n), dtype=torch.uint8, device=c.device)
    kwin = torch.empty((n, n), dtype=torch.int32, device=c.device)
    if n:
        build.launch("level1", "repro_level1_dense", c.device, c_pad.data_ptr(),
                     adj_pad.data_ptr(), removed.data_ptr(), kwin.data_ptr(), n, n + pad,
                     float(tau), *atanh_window(tau))
    return removed.view(torch.bool), kwin
