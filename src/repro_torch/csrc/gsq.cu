// Discrete G² per worklist cell: histogram the cell's joint codes
//     jc = (cfg·r + x_i)·r + x_j  ∈ [0, K),  K = q·r²   (out of range = padding)
// over its M samples into a K-cell contingency table, then reduce the
// table to
//     G² = 2 Σ_abc N_abc · log(N_abc · N_++c / (N_a+c · N_+bc)).
//
// Replaces src/repro/kernels/gsq.py::gsq_cells (_gsq_kernel, with the fold
// _g2_from_counts), whose (8, 128) lane tiles carried each cell-tile's
// counts across a sequential sample-grid axis.
//
// Layout: cell-major, jc (B, M) int32, the transpose of the reference's
// (M, B). The port's callers build jc cell by cell (levels.level0_g2 and
// levels.g2_worklist), so each cell's samples are contiguous and a cell
// needs no state from any other block.
//
// What bounds it on an H100: reading the 4·M·B bytes of jc (3.9 GB at
// level 0 of n = 441, m = 5000: about 1.2 ms at 3.35 TB/s); counting is a
// few integer operations a sample. Timed variants of the loop
// (scripts/gsq_probe.py) showed that the first kernel's pace was set by its
// __match_any_sync, not by latency, and that plain shared-memory atomics
// run at the loads' own pace on Hopper, even into level 0's nine bins. The
// design that follows:
//   * one block of 8 warps per cell, sharing one histogram of K int32 in
//     shared memory, filled with one plain atomicAdd a sample (no lane
//     matching); the warps split the cell's samples, so 8 warps' loads are
//     in flight for each cell;
//   * 16-byte int4 loads where the rows are 16-byte aligned (M % 4 == 0 and
//     an aligned base, as PIGS's M = 5000 is), 4-byte loads otherwise;
//   * shared memory per cell is the K counts, overwritten by their terms,
//     and the logs of the margins (2·q·r + q floats): under 2·K·4 bytes for
//     r ≥ 3, so K ≤ 6561 fits a block. Margins and their logs are computed
//     once per (c, a), (c, b) and c, and a term's own log only where its
//     count is not 0;
//   * lane-private counters in registers for K ≤ 32 (8-bit fields packed
//     four to a register, a shuffle butterfly to combine the lanes) were
//     measured too and lost to this at K = 9 and K = 27: selecting the
//     register costs two instructions per register a sample.
//
// The reduction follows the fold of the reference's _g2_from_counts, and
// its plain PyTorch version (kernels/gsq.py::gsq_ref) does the same, so the
// two are bitwise equal: counts and margins are exact integers; every term
//     term = N_ab·(((log max(N_ab,1) + log max(N_c,1)) − log max(N_a,1)) − log max(N_b,1))
// (0 where N_ab = 0) is computed in parallel, with the _rn intrinsics so
// nvcc contracts nothing into an FMA, and the terms are then added one by
// one in the fold's order, k = (c·r + a)·r + b ascending, and doubled. That
// chain of dependent adds is one thread's; it fetches the terms 32 at a time
// so the loads run ahead of the adds.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps per cell

// term = N_ab·(((log N_ab + log N_c) − log N_a) − log N_b), logs of max(·, 1)
__device__ __forceinline__ float g2_term(int nab, float lc, float la, float lb) {
  if (nab <= 0) return 0.f;
  const float lab = logf(fmaxf(static_cast<float>(nab), 1.f));
  return __fmul_rn(static_cast<float>(nab), __fsub_rn(__fsub_rn(__fadd_rn(lab, lc), la), lb));
}

__device__ __forceinline__ float log_count(int n) {
  return logf(fmaxf(static_cast<float>(n), 1.f));
}

// Shared memory of one cell, in 4-byte words: the K counts (overwritten by
// their terms, K rounded up to 4 for float4 reads), then the logs of the
// margins N_a+c (q·r), N_+bc (q·r) and N_++c (q).
__host__ __device__ constexpr int padded_k(int k_total) { return (k_total + 3) & ~3; }
__host__ __device__ constexpr int smem_words(int k_total, int r) {
  return padded_k(k_total) + (2 * r + 1) * (k_total / (r * r));
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
gsq_kernel(const int* __restrict__ jc, float* __restrict__ g2_out, int m, int k_total, int r) {
  extern __shared__ __align__(16) int smem[];
  const int rr = r * r;
  const int q = k_total / rr;
  int* hist = smem;
  float* term = reinterpret_cast<float*>(smem);  // term k replaces count k
  float* log_na = reinterpret_cast<float*>(smem + padded_k(k_total));  // [c·r + a]
  float* log_nb = log_na + q * r;  // [c·r + b]
  float* log_nc = log_nb + q * r;  // [c]
  const int tid = threadIdx.x;
  const long long cell = blockIdx.x;
  for (int k = tid; k < padded_k(k_total); k += kThreads) hist[k] = 0;
  __syncthreads();

  const int* row = jc + cell * static_cast<long long>(m);
  auto count = [&](int code) {
    if (static_cast<unsigned>(code) < static_cast<unsigned>(k_total)) atomicAdd(hist + code, 1);
  };
  if (kVec) {
    const int4* row4 = reinterpret_cast<const int4*>(row);
#pragma unroll 4
    for (int i = tid; i < (m >> 2); i += kThreads) {
      const int4 v = __ldg(row4 + i);
      count(v.x);
      count(v.y);
      count(v.z);
      count(v.w);
    }
  } else {
#pragma unroll 4
    for (int s = tid; s < m; s += kThreads) count(__ldg(row + s));
  }
  __syncthreads();

  // the margins are exact integer sums; only their logs are kept
  for (int i = tid; i < q * r; i += kThreads) {
    const int c = i / r;
    const int x = i - c * r;
    int na = 0, nb = 0;
    for (int y = 0; y < r; ++y) {
      na += hist[i * r + y];           // N_{c, a=x, b=y}
      nb += hist[c * rr + y * r + x];  // N_{c, a=y, b=x}
    }
    log_na[i] = log_count(na);
    log_nb[i] = log_count(nb);
  }
  for (int c = tid; c < q; c += kThreads) {
    int nc = 0;
    for (int y = 0; y < rr; ++y) nc += hist[c * rr + y];
    log_nc[c] = log_count(nc);
  }
  __syncthreads();

  // term k = (c·r + a)·r + b over its own count (one thread reads and
  // writes each k)
  for (int i = tid; i < q * r; i += kThreads) {
    const int c = i / r;
    const float lc = log_nc[c];
    const float la = log_na[i];
    for (int b = 0; b < r; ++b) {
      const int k = i * r + b;
      term[k] = g2_term(hist[k], lc, la, log_nb[c * r + b]);
    }
  }
  __syncthreads();

  if (tid == 0) {
    // the in-order sum, its loads 32 terms ahead of the chain of adds
    const float4* term4 = reinterpret_cast<const float4*>(term);
    float g2 = 0.f;
    int k = 0;
    for (; k + 32 <= k_total; k += 32) {
      float4 t[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) t[j] = term4[(k >> 2) + j];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        g2 = __fadd_rn(g2, t[j].x);
        g2 = __fadd_rn(g2, t[j].y);
        g2 = __fadd_rn(g2, t[j].z);
        g2 = __fadd_rn(g2, t[j].w);
      }
    }
    for (; k < k_total; ++k) g2 = __fadd_rn(g2, term[k]);
    g2_out[cell] = __fmul_rn(2.f, g2);
  }
}

template <bool kVec>
cudaError_t launch(const int* jc, float* g2, long long n_cells, int m, int k_total, int r,
                   cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(smem_words(k_total, r)) * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gsq_kernel<kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  gsq_kernel<kVec><<<static_cast<unsigned>(n_cells), kThreads, smem, stream>>>(jc, g2, m,
                                                                               k_total, r);
  return cudaSuccess;
}

}  // namespace

// jc: (n_cells, m) int32 device pointer; g2: (n_cells,) float32. k_total =
// q·r² (the port caps it at MAX_G2_TABLE = 4096 on its paths; the kernel
// takes any K whose 8·K bytes fit a block's shared memory). Returns the
// launch's cudaError_t.
extern "C" int repro_gsq(const int* jc, float* g2, long long n_cells, int m, int k_total, int r,
                         cudaStream_t stream) {
  if (n_cells <= 0) return 0;
  const bool vec = m % 4 == 0 && reinterpret_cast<uintptr_t>(jc) % 16 == 0;
  const cudaError_t err = vec ? launch<true>(jc, g2, n_cells, m, k_total, r, stream)
                              : launch<false>(jc, g2, n_cells, m, k_total, r, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
