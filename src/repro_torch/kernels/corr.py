"""C = Xnᵀ Xn / m: the fp32 SYRK of ``csrc/corr.cu`` and its plain
PyTorch version.

Port of ``src/repro/kernels/corr.py::corr_matmul``. The standardisation,
clipping and unit diagonal stay in the ops wrapper (``ops.correlation``),
as they stay in jnp in the reference.
"""
from __future__ import annotations

import functools

import torch

from . import build

TILE = 128  # output tile side of csrc/corr.cu's split-K kernel, 32-sample slabs
SMALL_TILE = 64  # its tile side for a small m, written directly, 16-sample slabs
SLAB = {TILE: 32, SMALL_TILE: 16}
# a direct block sums all its slabs in registers: up to 32 slabs (512
# samples), as short as a group of the split-K kernel
DIRECT_MAX_M = 512
MAX_SPLITS = 32
# in slab-times: a block's fixed cost (prologue, scratch store), and the
# second pass that reduces the splits' scratch tiles into C
BLOCK_OVERHEAD_SLABS = 1
REDUCE_SLABS = 3


def _upper_tiles(n: int, tile: int) -> int:
    nt = -(-n // tile)
    return nt * (nt + 1) // 2


@functools.lru_cache(maxsize=64)
def plan(m: int, n: int, sms: int) -> tuple[int, int, int, int]:
    """(tile, tiles, splits, slabs per split) of the kernel for Xn (m, n)
    on a card of ``sms`` multiprocessors. The upper tiles (bi ≤ bj) of C are
    multiplied by one block each per split of the sample slabs.

    m ≤ 512 takes 64-wide tiles with 16-sample slabs, one split, and the
    blocks write C themselves: one launch, no scratch (m = 47, n = 1190:
    190 tiles). A larger m takes 128-wide tiles of 32-sample slabs split
    over blocks, and a second launch reduces the splits into C. One block
    fits an SM (256 threads of ~230 registers), so tiles·splits blocks take
    ⌈tiles·splits/sms⌉ waves of one split's slabs; the plan takes the split
    count with the fewest slab-times (ties: fewer splits): m = 10 000,
    n = 1000 → 36 tiles × 11 splits of 29 slabs = 3 full waves on 132 SMs."""
    if m <= DIRECT_MAX_M:
        return SMALL_TILE, _upper_tiles(n, SMALL_TILE), 1, -(-m // SLAB[SMALL_TILE])
    slabs = -(-m // SLAB[TILE])
    tiles = _upper_tiles(n, TILE)
    best = None
    for want in range(1, min(slabs, MAX_SPLITS) + 1):
        sps = -(-slabs // want)
        splits = -(-slabs // sps)  # no split left empty
        cost = -(-tiles * splits // sms) * (sps + BLOCK_OVERHEAD_SLABS) + REDUCE_SLABS
        if best is None or cost < best[0]:
            best = (cost, splits, sps)
    return TILE, tiles, best[1], best[2]


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def corr_matmul_plain(xn: torch.Tensor) -> torch.Tensor:
    """Plain version: Xnᵀ Xn / m accumulated in float64, rounded once to
    fp32 — the value the fp32 kernel approximates."""
    x64 = xn.to(torch.float64)
    return ((x64.T @ x64) / xn.shape[0]).to(torch.float32)


def corr_matmul(xn: torch.Tensor) -> torch.Tensor:
    """xn: (m, n) fp32 standardised samples → (n, n) fp32 XnᵀXn/m, bitwise
    symmetric and the same from run to run.

    A CUDA tensor runs the hand kernel; a CPU tensor the plain version."""
    if xn.ndim != 2 or xn.dtype != torch.float32:
        raise ValueError(f"expected (m, n) float32 samples, got {tuple(xn.shape)} {xn.dtype}")
    if xn.device.type == "cpu":
        return corr_matmul_plain(xn)
    build.require_cuda(xn)
    m, n = xn.shape
    device = xn.device
    out = xn.new_empty((n, n))
    if m and n:
        tile, tiles, splits, sps = plan(m, n, _sm_count(device.index))
        direct = tile == SMALL_TILE
        ws = None if direct else xn.new_empty(splits * tiles * TILE * TILE)
        # the split-K path is two kernels: the splits, then their reduction
        build.launch("corr", "repro_corr_xtx", device, xn.data_ptr(), out.data_ptr(),
                     None if ws is None else ws.data_ptr(), m, n, tile, splits, sps,
                     kernels=1 if direct else 2)
    return out
