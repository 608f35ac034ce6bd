"""Fused cuPC-S chunk: the kernel of ``csrc/skernel.cu`` and its plain
PyTorch version.

One launch a chunk replaces the "S-kernel" engine's ``levels.gather_s``
→ cholinv → cisweep → ``levels._winners``: the kernel reads C, the
adjacency, the rows' compacted neighbour lists and counts and the chunk's
first rank, unranks each row's sets itself, and keeps only the winners.
It returns t_loc (n_l, n′) int32, the least launch-local rank whose set
separates (row, slot), ``SENTINEL`` where none does, and s_win
(n_l, n′, ℓ) int32, that rank's set (0 where none): the form of
``sgrid.sgrid_fused``, which ``ops._grid_winners`` turns into the
commit's winners.

Its arithmetic is cholinv's and cisweep's own (the device functions of
``csrc/cholinv.cuh`` and ``csrc/cisweep.cuh``), so on one card its
winners are bitwise those of ``skernel_two_launch``: the gather, the two
gathered kernels and ``levels._winners``. ``skernel_plain`` is the same
composition through the kernels' plain versions.
"""
from __future__ import annotations

import functools

import torch

from . import build
from . import cholinv as _cholinv
from . import cisweep as _cisweep
from .cholinv import JITTER, MAX_ELL
from .sgrid import SENTINEL


def _two_step(c, adj, compact, counts, rows, t0, tau, *, ell, n_chunk, n_max, inverse, sweep):
    """plan_sets → gather_sets → inverse → sweep → the least separating
    launch-local rank per (row, slot), in the kernel's output form."""
    from repro_torch.core import levels as L

    n = c.shape[0]
    n_l, npr = compact.shape
    ranks = L._chunk_ranks(t0, n_chunk)
    s_ids, valid = L.plan_sets(compact, counts, ranks, ell=ell, n_max=n_max, n=n)
    m2, ci_s, cj_s, cij, mask = L.gather_sets(c, adj.to(torch.bool), compact, rows, s_ids, valid)
    b = n_l * n_chunk
    g, u, var = inverse(m2.reshape(b, ell, ell).contiguous(), ci_s.reshape(b, ell).contiguous())
    found = sweep(g, u, var, cj_s.reshape(b, npr, ell).contiguous(),
                  cij.reshape(b, npr).contiguous(), mask.reshape(b, npr).contiguous(), tau)
    local = torch.arange(n_chunk, dtype=torch.int32, device=c.device)
    t_win, removed, s_win = L._winners(found.reshape(n_l, n_chunk, npr), local, s_ids)
    return torch.where(removed, t_win, SENTINEL), torch.where(removed[..., None], s_win, 0)


def skernel_plain(c, adj, compact, counts, rows, t0, tau: float, *, ell: int, n_chunk: int,
                  n_max: int, jitter: float = JITTER):
    """Plain version: ``levels.plan_sets`` → ``levels.gather_sets`` →
    ``cholinv_plain`` → ``cisweep_plain`` → ``levels._winners``."""
    return _two_step(c, adj, compact, counts, rows, t0, tau, ell=ell, n_chunk=n_chunk,
                     n_max=n_max,
                     inverse=functools.partial(_cholinv.cholinv_plain, jitter=jitter),
                     sweep=_cisweep.cisweep_plain)


def skernel_two_launch(c, adj, compact, counts, rows, t0, tau: float, *, ell: int,
                       n_chunk: int, n_max: int, jitter: float = JITTER):
    """The reference's two-kernel chunk on the same inputs: the gather, the
    gathered cholinv and cisweep kernels (their plain versions on CPU
    tensors) and ``levels._winners``; what the fused kernel is held to."""
    return _two_step(c, adj, compact, counts, rows, t0, tau, ell=ell, n_chunk=n_chunk,
                     n_max=n_max, inverse=functools.partial(_cholinv.cholinv, jitter=jitter),
                     sweep=_cisweep.cisweep)


def skernel_fused(c, adj, compact, counts, rows, t0, tau: float, *, ell: int, n_chunk: int,
                  n_max: int, jitter: float = JITTER):
    """Ranks [t0, t0 + n_chunk) of the rows ``rows`` (n_l,) int32 read
    straight from C: c (n, n) float32, adj (n, n) bool or uint8, compact
    (n_l, n′) and counts (n_l,) int32, t0 a 0-d int32 or int64 tensor,
    n_max the unrank bound (``levels.plan_sets``'s), ``jitter`` the
    Tikhonov scale of the per-set inverse. A CUDA tensor runs the hand
    kernel, one launch; a CPU tensor the plain version."""
    from repro_torch.core import levels as L

    n = c.shape[0]
    n_l, npr = compact.shape
    if (c.shape != (n, n) or adj.shape != (n, n) or counts.shape != (n_l,)
            or rows.shape != (n_l,) or t0.dim() != 0):
        raise ValueError("skernel_fused shapes disagree: c and adj (n, n), compact (n_l, n′), "
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
        return skernel_plain(c, adj, compact, counts, rows, t0, tau, ell=ell, n_chunk=n_chunk,
                             n_max=n_max, jitter=jitter)
    adj8 = adj.view(torch.uint8) if adj.dtype == torch.bool else adj
    table = L._jtable(n_max, torch.int64, c.device)
    build.require_cuda(c, adj8, compact, counts, rows, t0, table)
    t_loc = torch.empty((n_l, npr), dtype=torch.int32, device=c.device)
    s_win = torch.empty((n_l, npr, ell), dtype=torch.int32, device=c.device)
    if n_l and npr:
        build.launch("skernel", "repro_skernel_fused", c.device, c.data_ptr(), adj8.data_ptr(),
                     rows.data_ptr(), compact.data_ptr(), counts.data_ptr(), table.data_ptr(),
                     table.shape[1], t0.data_ptr(), int(t0.dtype == torch.int64),
                     t_loc.data_ptr(), s_win.data_ptr(), n, n_l, n_chunk, npr, n_max, ell,
                     float(tau), float(jitter))
    return t_loc, s_win
