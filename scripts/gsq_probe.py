#!/usr/bin/env python3
"""What bounds the G² histogram on the card: time variants of its loop.

    python3 scripts/gsq_probe.py            (on a machine with a CUDA card)

Builds the variants below with nvcc (sm_90a) into the port's ignored
``src/repro_torch/_build/`` and times each with CUDA events on the codes
of the PIGS-shaped stand-in that ``chip_smoke.py`` uses (n = 441
ternary, m = 5000): the level-0 shape
(B = 194 481 cells, K = 9) and the first chunk of every level ℓ = 1…5
(K = 27 … 2187).

One warp per cell, the loop of the first gsq kernel (four scalar loads a
lane per step), to find what set its pace:
  match    ``__match_any_sync`` + leader atomics, then the fold (the first kernel)
  nofold   the same counts, no fold
  loads    the loads alone (a warp sum keeps them live)
  atomic   one plain shared ``atomicAdd`` per sample, then the fold
(8 warps a block, fewer where their histograms outgrow 96 KB of shared
memory, as the first kernel's launcher chose.) For K ≤ 32 (K = 9 and 27),
the lane-private register design, one warp per cell, ``int4`` loads:
  regsfull 8-bit counters packed four to a register, a shuffle reduction
           over the lanes, then the fold from shuffled counts: the G² of
           every cell, checked bitwise against the shipped kernel
And ``shipped``: the port's gsq kernel (``kernels/gsq.py::gsq_cells``).

Prints one line per variant and shape: ms, and GB/s of jc read.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "src" / "repro_torch" / "_build" / "gsq_probe"  # ignored by git

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
constexpr unsigned kFull = 0xffffffffu;

__device__ void fold(const int* hist, float* term, int k_total, int r, int lane, int nlanes,
                     float* out) {
  const int rr = r * r;
  for (int k = lane; k < k_total; k += nlanes) {
    const int nab = hist[k];
    float t = 0.f;
    if (nab > 0) {
      const int c = k / rr, a = (k / r) % r, b = k % r;
      const int* tab = hist + c * rr;
      int na = 0, nb = 0, nc = 0;
      for (int x = 0; x < r; ++x) { na += tab[a * r + x]; nb += tab[x * r + b]; }
      for (int x = 0; x < rr; ++x) nc += tab[x];
      const float lab = logf(fmaxf((float)nab, 1.f)), lc = logf(fmaxf((float)nc, 1.f));
      const float la = logf(fmaxf((float)na, 1.f)), lb = logf(fmaxf((float)nb, 1.f));
      t = __fmul_rn((float)nab, __fsub_rn(__fsub_rn(__fadd_rn(lab, lc), la), lb));
    }
    term[k] = t;
  }
}

// MODE 0 match, 1 nofold, 2 loads, 3 atomic
template <int MODE>
__global__ void warp_probe(const int* __restrict__ jc, float* out, long long n_cells, int m,
                           int k_total, int r) {
  extern __shared__ int smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long cell = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (cell >= n_cells) return;
  int* hist = smem + (size_t)warp * 2 * k_total;
  float* term = reinterpret_cast<float*>(hist + k_total);
  for (int k = lane; k < k_total; k += 32) hist[k] = 0;
  __syncwarp();
  const int* row = jc + cell * (long long)m;
  int sum = 0;
  for (int s0 = 0; s0 < m; s0 += 128) {
    int v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) { const int s = s0 + u * 32 + lane; v[u] = s < m ? __ldg(row + s) : -1; }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const bool ok = (unsigned)v[u] < (unsigned)k_total;
      if (MODE == 2) { sum += v[u]; continue; }
      if (MODE == 3) { if (ok) atomicAdd(hist + v[u], 1); continue; }
      const unsigned peers = __match_any_sync(kFull, ok ? v[u] : -1);
      if (ok && lane == __ffs(peers) - 1) atomicAdd(hist + v[u], __popc(peers));
    }
  }
  __syncwarp();
  if (MODE == 2) { sum = __reduce_add_sync(kFull, sum); if (lane == 0) out[cell] = (float)sum; return; }
  if (MODE == 1) { if (lane == 0) out[cell] = (float)hist[0]; return; }
  fold(hist, term, k_total, r, lane, 32, out);
  __syncwarp();
  if (lane == 0) { float g = 0.f; for (int k = 0; k < k_total; ++k) g = __fadd_rn(g, term[k]); out[cell] = 2.f * g; }
}

__device__ __forceinline__ float g2_term(int nab, int na, int nb, int nc) {
  if (nab <= 0) return 0.f;
  const float lab = logf(fmaxf((float)nab, 1.f)), lc = logf(fmaxf((float)nc, 1.f));
  const float la = logf(fmaxf((float)na, 1.f)), lb = logf(fmaxf((float)nb, 1.f));
  return __fmul_rn((float)nab, __fsub_rn(__fsub_rn(__fadd_rn(lab, lc), la), lb));
}

// One step of a reduce-scatter over the warp: bins [0, 2W) of every lane →
// bins [0, W), a lane keeping the half whose bit W matches its own lane's
// and adding its partner's copy. After W = 16, 8, 4, 2, 1 lane k holds the
// warp's total of bin k in tot[0].
template <int W>
__device__ __forceinline__ void scatter_step(int (&tot)[32], int lane) {
  const bool upper = lane & W;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    const int send = upper ? tot[j] : tot[j + W];
    const int keep = upper ? tot[j + W] : tot[j];
    tot[j] = keep + __shfl_xor_sync(kFull, send, W);
  }
}

// kRegs = ⌈K/4⌉ packed registers; bins K ≤ k < 4·kRegs count codes no cell
// holds (padding in [K, 4·kRegs)) and are dropped by the fold.
template <int kRegs>
__global__ void __launch_bounds__(256)
gsq_warp_kernel(const int* __restrict__ jc, float* __restrict__ g2_out, long long n_cells,
                int m, int k_total, int r) {
  const int lane = threadIdx.x & 31;
  const long long cell = static_cast<long long>(blockIdx.x) * 8 + (threadIdx.x >> 5);
  if (cell >= n_cells) return;  // the whole warp leaves together
  const int* row = jc + cell * static_cast<long long>(m);

  unsigned packed[kRegs];
  int tot[32];
#pragma unroll
  for (int p = 0; p < kRegs; ++p) packed[p] = 0u;
#pragma unroll
  for (int k = 0; k < 32; ++k) tot[k] = 0;
  auto count = [&](int code) {  // code < 0 or ≥ 4·kRegs matches no register
    const unsigned inc = 1u << ((code & 3) << 3);
    const int hi = code >> 2;
#pragma unroll
    for (int p = 0; p < kRegs; ++p) packed[p] += hi == p ? inc : 0u;
  };
  auto flush = [&]() {
#pragma unroll
    for (int k = 0; k < 4 * kRegs; ++k) tot[k] += (packed[k >> 2] >> ((k & 3) << 3)) & 255u;
#pragma unroll
    for (int p = 0; p < kRegs; ++p) packed[p] = 0u;
  };

  // 8 samples a lane a step; a flush every 31 steps keeps fields ≤ 248
  constexpr int kFlushSteps = 31;
  int steps = 0;
  const int4* row4 = reinterpret_cast<const int4*>(row);  // m % 4 == 0 here
  const int n4 = m >> 2;
  for (int i0 = 0; i0 < n4; i0 += 64) {
    int4 v[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = i0 + 32 * u + lane;
      v[u] = i < n4 ? __ldg(row4 + i) : make_int4(-1, -1, -1, -1);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      count(v[u].x);
      count(v[u].y);
      count(v[u].z);
      count(v[u].w);
    }
    if (++steps == kFlushSteps) {
      flush();
      steps = 0;
    }
  }
  flush();

  scatter_step<16>(tot, lane);
  scatter_step<8>(tot, lane);
  scatter_step<4>(tot, lane);
  scatter_step<2>(tot, lane);
  scatter_step<1>(tot, lane);
  const int nab = tot[0];  // lane k's bin k

  // margins of lane k = (c·r + a)·r + b from its neighbours' counts
  const int rr = r * r;
  const int c = lane / rr;
  const int a = (lane / r) % r;
  const int b = lane % r;
  int na = 0, nb = 0, nc = 0;
  for (int x = 0; x < r; ++x) {
    na += __shfl_sync(kFull, nab, c * rr + a * r + x);
    nb += __shfl_sync(kFull, nab, c * rr + x * r + b);
  }
  for (int x = 0; x < rr; ++x) nc += __shfl_sync(kFull, nab, c * rr + x);
  const float term = lane < k_total ? g2_term(nab, na, nb, nc) : 0.f;

  float g2 = 0.f;
  for (int k = 0; k < k_total; ++k) g2 = __fadd_rn(g2, __shfl_sync(kFull, term, k));
  if (lane == 0) g2_out[cell] = __fmul_rn(2.f, g2);
}

extern "C" int probe(int variant, const int* jc, float* out, long long n_cells, int m, int k_total,
                     int r, int warps, cudaStream_t stream) {
  size_t smem = (size_t)warps * 2 * k_total * 4;
  if (variant < 4 && smem > 48 * 1024) {  // as the first kernel's launcher did
    cudaError_t err = cudaSuccess;
    switch (variant) {
      case 0: err = cudaFuncSetAttribute(warp_probe<0>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem); break;
      case 1: err = cudaFuncSetAttribute(warp_probe<1>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem); break;
      case 2: err = cudaFuncSetAttribute(warp_probe<2>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem); break;
      default: err = cudaFuncSetAttribute(warp_probe<3>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    }
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned wblocks = (unsigned)((n_cells + warps - 1) / warps);
  switch (variant) {
    case 0: warp_probe<0><<<wblocks, warps * 32, smem, stream>>>(jc, out, n_cells, m, k_total, r); break;
    case 1: warp_probe<1><<<wblocks, warps * 32, smem, stream>>>(jc, out, n_cells, m, k_total, r); break;
    case 2: warp_probe<2><<<wblocks, warps * 32, smem, stream>>>(jc, out, n_cells, m, k_total, r); break;
    case 3: warp_probe<3><<<wblocks, warps * 32, smem, stream>>>(jc, out, n_cells, m, k_total, r); break;
    case 4: gsq_warp_kernel<3><<<wblocks, 256, 0, stream>>>(jc, out, n_cells, m, k_total, r); break;
    case 5: gsq_warp_kernel<7><<<wblocks, 256, 0, stream>>>(jc, out, n_cells, m, k_total, r); break;
    default: return -1;
  }
  return (int)cudaGetLastError();
}
"""

# (name, variant, warps a block)
VARIANTS = (("match", 0, 8), ("nofold", 1, 8), ("loads", 2, 8), ("atomic", 3, 8))
# K → the register design with its fold (the G² of every cell, as the
# shipped kernel computes it)
SMALL = {9: (("regsfull", 4, 8),), 27: (("regsfull", 5, 8),)}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("gsq_probe: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.core import cit, engines, levels as L
    from repro_torch.core.compact import compact_rows
    from repro_torch.data.synthetic_dag import sample_discrete_dag
    from repro_torch.kernels import gsq

    OUT.mkdir(parents=True, exist_ok=True)
    src = OUT / "probe.cu"
    src.write_text(SOURCE)
    lib_path = OUT / "libprobe.so"
    subprocess.run(["nvcc", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-o", str(lib_path), str(src)], check=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.probe.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                          ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.probe.restype = ctypes.c_int

    dev = torch.device("cuda")
    cfg = cs.PIGS
    x_np, _ = cs.discrete_codes(sample_discrete_dag, cfg)
    test, stats = cit.DiscreteCITest.from_samples(x_np, alpha=cfg["alpha"], device=dev)
    n, m, r = cfg["n"], cfg["m"], test.r
    codes_t = stats.codes.T.contiguous()
    shapes = [("level 0", (codes_t[:, None, :] * r + codes_t[None, :, :]).reshape(n * n, m), 1)]
    adj = test.level0(stats, cfg["alpha"])
    sep = torch.full((n, n, 8), -1, dtype=torch.int32, device=dev)
    sep[:, :, 0] = torch.where(adj, -1, -2).to(torch.int32)
    for ell in range(1, 6):
        npr = int(adj.sum(1).max())
        budget = L.DEFAULT_CELL_BUDGET * ell * ell // m  # engines.run_level's rescale
        npr_b, n_chunk, _ = L.plan_level(npr, ell, n, cell_budget=budget, n_cols=n)
        compact, counts = compact_rows(adj, n_prime=npr_b)
        ranks = torch.arange(n_chunk, dtype=torch.int32, device=dev)
        jc = L.g2_worklist(stats, adj, compact, counts, ranks, ell=ell, n_max=npr_b, r=r)[0]
        shapes.append((f"l={ell} chunk", jc, r**ell))
        adj, sep, _ = engines.run_level(stats, adj, sep, ell, cfg["alpha"], test=test)
    stream = torch.cuda.current_stream().cuda_stream

    for label, jc, q in shapes:
        b = jc.shape[0]
        k_total = q * r * r
        out = torch.empty(b, dtype=torch.float32, device=dev)
        gb = 4 * b * m / 1e9
        variants = VARIANTS + SMALL.get(k_total, ())
        for name, variant, warps in variants:
            if name != "regsfull":  # a histogram per warp: the first kernel's 96 KB
                warps = max(1, min(warps, 98304 // (8 * k_total)))
            def run():
                rc = lib.probe(variant, jc.data_ptr(), out.data_ptr(), b, m, k_total, r, warps,
                               stream)
                if rc:
                    raise RuntimeError(f"probe {name} launch failed: {rc}")
            ms = cs.cuda_ms(torch, run, reps=10)
            note = ""
            if name == "regsfull":
                note = f", bitwise equal to shipped: {torch.equal(out, gsq.gsq_cells(jc, r=r, q=q))}"
            print(f"gsq_probe {label} B={b} M={m} K={k_total} {name:9s} warps {warps}: "
                  f"{ms:.4f} ms, {gb / ms * 1e3:.1f} GB/s{note}")
        ms = cs.cuda_ms(torch, lambda: gsq.gsq_cells(jc, r=r, q=q), reps=10)
        print(f"gsq_probe {label} B={b} M={m} K={k_total} shipped   warps 8: {ms:.4f} ms, "
              f"{gb / ms * 1e3:.1f} GB/s")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
