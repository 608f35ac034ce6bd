"""Grid-resident cuPC-S: the kernel of ``csrc/sgrid.cu`` and its plain
PyTorch version, behind two entries.

Port of ``src/repro/kernels/sgrid.py::sgrid_kernel``. Both entries return
t_loc (n_l, n′) int32, the least launch-local rank whose set separates
(row, slot), ``SENTINEL`` where none does, and s_win (n_l, n′, ℓ) int32,
that rank's set (0 where none).

* ``sgrid`` takes the reference's ``ops.ci_shared_grid`` inputs, gathered
  batch-first: m2 (n_l, T, ℓ, ℓ), ci_s (n_l, T, ℓ), cj_s (n_l, T, n′, ℓ),
  cij and mask (n_l, T, n′), s_ids (n_l, T, ℓ).
* ``sgrid_fused`` takes C itself with the rows' compacted neighbour lists
  and counts, the adjacency and the launch's first rank; the kernel
  unranks the sets and reads every value the sweep needs from C, so no
  (n_l, T, n′) tensor is formed and no unrank loop runs on the host. Its
  plain version is ``levels.plan_sets``, ``levels.gather_sets`` and
  ``sgrid_plain``.

Both versions follow ``_inverse_tiles`` and the sweep of the reference's
``_sgrid_kernel`` branch for branch: 1/max(x, 1e-8) at ℓ = 1, the
adjugate with diagonal-scaled jitter at ℓ = 2, Cholesky → L⁻¹ → Gram at
ℓ ≥ 3; var_j through the 2·w_i·w_j·g_ij expansion; ρ = num·rsqrt(max(
var_i·var_j, 1e-20)) with a correctly rounded rsqrt, clipped to
±0.9999999; independent where |atanh ρ| ≤ τ. Each step rounds once, in
the same order, so on one card kernel and plain version differ only
through a double rounding of the plain rsqrt (float64, then float32).
"""
from __future__ import annotations

import numpy as np
import torch

from . import build
from .cholinv import JITTER, MAX_ELL
from .level1 import atanh_window

#: t_loc where no rank of the launch separates the (row, slot)
SENTINEL = 2**30


def _inverse(m2: torch.Tensor):
    """g[i][j], each (n_l, T), of the jittered set inverse (``_inverse_tiles``)."""
    ell = m2.shape[-1]
    m = [[m2[..., i, j] for j in range(ell)] for i in range(ell)]
    if ell == 1:
        return [[1.0 / torch.clamp(m[0][0], min=1e-8)]]
    f32 = torch.float32
    scale = m[0][0]
    for i in range(1, ell):
        scale = scale + m[i][i]
    inv_l = torch.tensor(1.0 / ell, dtype=f32, device=m2.device)
    jit = torch.tensor(JITTER, dtype=f32, device=m2.device) * (scale * inv_l)
    if ell == 2:
        a, b, c, d = m[0][0] + jit, m[0][1], m[1][0], m[1][1] + jit
        det = a * d - b * c
        return [[d / det, -b / det], [-c / det, a / det]]
    a = [[m[i][j] + jit if i == j else m[i][j] for j in range(ell)] for i in range(ell)]
    l = [[None] * ell for _ in range(ell)]
    for j in range(ell):
        s = a[j][j]
        for k in range(j):
            s = s - l[j][k] * l[j][k]
        l[j][j] = torch.sqrt(torch.clamp(s, min=1e-20))
        inv_ljj = 1.0 / l[j][j]
        for i in range(j + 1, ell):
            s = a[i][j]
            for k in range(j):
                s = s - l[i][k] * l[j][k]
            l[i][j] = s * inv_ljj
    minv = [[None] * ell for _ in range(ell)]
    for j in range(ell):
        minv[j][j] = 1.0 / l[j][j]
        for i in range(j + 1, ell):
            s = l[i][j] * minv[j][j]
            for k in range(j + 1, i):
                s = s + l[i][k] * minv[k][j]
            minv[i][j] = -s / l[i][i]
    g = [[None] * ell for _ in range(ell)]
    for i in range(ell):
        for j in range(i, ell):
            s = minv[j][i] * minv[j][j]
            for k in range(j + 1, ell):
                s = s + minv[k][i] * minv[k][j]
            g[i][j] = g[j][i] = s
    return g


def _rsqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """1/√x rounded to float32 from a float64 evaluation, as the kernel's
    correctly rounded ``__frsqrt_rn``."""
    return (1.0 / torch.sqrt(x.double())).float()


def sgrid_plain(m2, ci_s, cj_s, cij, mask, s_ids, tau: float):
    """Plain version: every (row, rank, slot) decision, then the least
    separating rank per (row, slot) and its set."""
    n_l, t_len, _ = mask.shape
    ell = m2.shape[-1]
    g = _inverse(m2)
    ci = [ci_s[..., i] for i in range(ell)]
    u = []
    for i in range(ell):
        acc = g[i][0] * ci[0]
        for j in range(1, ell):
            acc = acc + g[i][j] * ci[j]
        u.append(acc[..., None])
    var_i = 1.0 - ci[0] * u[0][..., 0]
    for i in range(1, ell):
        var_i = var_i - ci[i] * u[i][..., 0]
    w = [cj_s[..., i] for i in range(ell)]
    num, var_j = cij, None
    for i in range(ell):
        num = num - w[i] * u[i]
        t = (w[i] * w[i]) * g[i][i][..., None]
        var_j = 1.0 - t if var_j is None else var_j - t
        for j in range(i + 1, ell):
            var_j = var_j - ((2.0 * w[i]) * w[j]) * g[i][j][..., None]
    rho = num * _rsqrt_rn(torch.clamp(var_i[..., None] * var_j, min=1e-20))
    rho = torch.clamp(rho, -0.9999999, 0.9999999)
    indep = (torch.abs(torch.atanh(rho)) <= float(np.float32(tau))) & mask.to(torch.bool)
    local = torch.arange(t_len, dtype=torch.int32, device=mask.device)
    key = torch.where(indep, local[None, :, None], SENTINEL)
    t_loc, t_arg = torch.min(key, dim=1)
    s_win = torch.gather(s_ids, 1, t_arg[..., None].expand(-1, -1, ell))
    return t_loc, torch.where((t_loc < SENTINEL)[..., None], s_win, 0)


def sgrid(m2, ci_s, cj_s, cij, mask, s_ids, tau: float):
    """A CUDA tensor runs the hand kernel; a CPU tensor the plain version.
    cij may be an expanded view with stride 0 over T (``levels.gather_s``
    hands it over so); the kernel reads its (n_l, n′) base."""
    n_l, t_len, npr = mask.shape
    ell = m2.shape[-1]
    if (m2.shape != (n_l, t_len, ell, ell) or ci_s.shape != (n_l, t_len, ell)
            or cj_s.shape != (n_l, t_len, npr, ell) or cij.shape != (n_l, t_len, npr)
            or s_ids.shape != (n_l, t_len, ell)):
        raise ValueError("sgrid shapes disagree: m2 (n_l,T,ℓ,ℓ), ci_s (n_l,T,ℓ), "
                         "cj_s (n_l,T,n′,ℓ), cij/mask (n_l,T,n′), s_ids (n_l,T,ℓ)")
    if any(t.dtype != torch.float32 for t in (m2, ci_s, cj_s, cij)):
        raise ValueError("sgrid float inputs must be float32")
    if s_ids.dtype != torch.int32 or mask.dtype not in (torch.bool, torch.uint8):
        raise ValueError(f"s_ids must be int32 and mask bool or uint8, got {s_ids.dtype} "
                         f"and {mask.dtype}")
    if not 1 <= ell <= MAX_ELL:
        raise ValueError(f"ℓ must lie in 1..{MAX_ELL}, got {ell}")
    if t_len >= SENTINEL:
        raise ValueError(f"a launch holds at most {SENTINEL - 1} ranks, got {t_len}")
    if m2.device.type == "cpu":
        return sgrid_plain(m2, ci_s, cj_s, cij, mask, s_ids, tau)
    m2, ci_s, cj_s, s_ids = (t.contiguous() for t in (m2, ci_s, cj_s, s_ids))
    mask8 = mask.contiguous()
    mask8 = mask8.view(torch.uint8) if mask8.dtype == torch.bool else mask8
    if cij.stride(2) != 1:
        cij = cij.contiguous()
    build.require_cuda(m2, ci_s, cj_s, mask8, s_ids)
    if cij.device != m2.device:
        raise ValueError(f"tensors on different devices: {cij.device} vs {m2.device}")
    t_loc = torch.empty((n_l, npr), dtype=torch.int32, device=m2.device)
    s_win = torch.empty((n_l, npr, ell), dtype=torch.int32, device=m2.device)
    if n_l and npr:
        build.launch("sgrid", "repro_sgrid", m2.device, m2.data_ptr(), ci_s.data_ptr(),
                     cj_s.data_ptr(), cij.data_ptr(), cij.stride(0), cij.stride(1),
                     mask8.data_ptr(), s_ids.data_ptr(), t_loc.data_ptr(), s_win.data_ptr(),
                     n_l, t_len, npr, ell, float(tau), JITTER, *atanh_window(tau))
    return t_loc, s_win


def sgrid_fused(c, adj, compact, counts, rows, t0, tau: float, *, ell: int, n_chunk: int,
                n_max: int, c_t=None):
    """The sweep of ranks [t0, t0 + n_chunk) read straight from C: c (n, n)
    float32, adj (n, n) bool or uint8, the neighbour lists compact
    (n_l, n′) int32 and counts (n_l,) int32 of the global rows ``rows``
    (n_l,) int32, t0 a 0-d int32 or int64 tensor, n_max the unrank bound
    (``levels.plan_sets``'s). The kernel unranks each row's sets itself;
    c_t is Cᵀ made contiguous, which it reads C[j, S] from (made here when
    not given). A CUDA tensor runs the hand kernel; a CPU tensor the plain
    version: ``plan_sets``, ``gather_sets`` and ``sgrid_plain``."""
    from repro_torch.core import levels as L

    n = c.shape[0]
    n_l, npr = compact.shape
    if (c.shape != (n, n) or adj.shape != (n, n) or counts.shape != (n_l,)
            or rows.shape != (n_l,) or t0.dim() != 0):
        raise ValueError("sgrid_fused shapes disagree: c and adj (n, n), compact (n_l, n′), "
                         "counts and rows (n_l,), t0 a scalar")
    if c.dtype != torch.float32 or adj.dtype not in (torch.bool, torch.uint8):
        raise ValueError(f"c must be float32 and adj bool or uint8, got {c.dtype} and "
                         f"{adj.dtype}")
    if any(t.dtype != torch.int32 for t in (compact, counts, rows)):
        raise ValueError("compact, counts and rows must be int32")
    if t0.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"t0 must be int32 or int64, got {t0.dtype}")
    if not 1 <= ell <= MAX_ELL:
        raise ValueError(f"ℓ must lie in 1..{MAX_ELL}, got {ell}")
    if n_chunk >= SENTINEL:
        raise ValueError(f"a launch holds at most {SENTINEL - 1} ranks, got {n_chunk}")
    if c.device.type == "cpu":
        ranks = L._chunk_ranks(t0, n_chunk)
        s_ids, valid = L.plan_sets(compact, counts, ranks, ell=ell, n_max=n_max, n=n)
        m2, ci_s, cj_s, cij, mask = L.gather_sets(c, adj.to(torch.bool), compact, rows, s_ids,
                                                  valid)
        return sgrid_plain(m2, ci_s, cj_s, cij, mask, s_ids, tau)
    if c_t is None:
        c_t = c.T.contiguous()
    if c_t.shape != (n, n) or c_t.dtype != torch.float32:
        raise ValueError("c_t must be Cᵀ, (n, n) float32")
    adj8 = adj.view(torch.uint8) if adj.dtype == torch.bool else adj
    table = L._jtable(n_max, torch.int64, c.device)
    build.require_cuda(c, c_t, adj8, compact, counts, rows, t0, table)
    t_loc = torch.empty((n_l, npr), dtype=torch.int32, device=c.device)
    s_win = torch.empty((n_l, npr, ell), dtype=torch.int32, device=c.device)
    if n_l and npr:
        build.launch("sgrid", "repro_sgrid_fused", c.device, c.data_ptr(), c_t.data_ptr(),
                     adj8.data_ptr(), rows.data_ptr(), compact.data_ptr(), counts.data_ptr(),
                     table.data_ptr(), table.shape[1], t0.data_ptr(),
                     int(t0.dtype == torch.int64), t_loc.data_ptr(), s_win.data_ptr(), n, n_l,
                     n_chunk, npr, n_max, ell, float(tau), JITTER, *atanh_window(tau))
    return t_loc, s_win
