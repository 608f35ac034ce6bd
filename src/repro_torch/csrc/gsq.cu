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
// level 0 of n = 441, m = 5000: about 1.2 ms at 3.35 TB/s); the histogram
// is a few integer operations per sample. The design: one warp per cell,
// 32 lanes reading 32 consecutive samples (one 128-byte line per load, four
// loads in flight per lane), a per-warp histogram of K int32 in shared
// memory. Lanes that hold the same code are grouped with __match_any_sync
// and their leader adds the group's size, so a warp's atomics never
// collide on one address (at level 0 there are only r² = 9 bins).
//
// The reduction follows the fold of the reference's _g2_from_counts, and
// its plain PyTorch version (kernels/gsq.py::gsq_ref) does the same, so the
// two are bitwise equal: counts and margins are exact integers; per cell
// the lanes compute every term
//     term = N_ab·(((log max(N_ab,1) + log max(N_c,1)) − log max(N_a,1)) − log max(N_b,1))
// (0 where N_ab = 0) in parallel, with the _rn intrinsics so nvcc contracts
// nothing into an FMA, and lane 0 then adds them in the fold's order,
// k = (c·r + a)·r + b ascending, and doubles the sum.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kUnroll = 4;
constexpr unsigned kFull = 0xffffffffu;

__global__ void gsq_kernel(const int* __restrict__ jc, float* __restrict__ g2_out,
                           long long n_cells, int m, int k_total, int r) {
  extern __shared__ int smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long cell = static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (cell >= n_cells) return;  // the whole warp leaves together

  int* hist = smem + static_cast<size_t>(warp) * 2 * k_total;
  float* term = reinterpret_cast<float*>(hist + k_total);
  for (int k = lane; k < k_total; k += 32) hist[k] = 0;
  __syncwarp();

  const int* row = jc + cell * static_cast<long long>(m);
  for (int s0 = 0; s0 < m; s0 += 32 * kUnroll) {
    int v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = s0 + u * 32 + lane;
      v[u] = s < m ? __ldg(row + s) : -1;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool ok = static_cast<unsigned>(v[u]) < static_cast<unsigned>(k_total);
      const int key = ok ? v[u] : -1;
      const unsigned peers = __match_any_sync(kFull, key);
      if (ok && lane == __ffs(peers) - 1) atomicAdd(hist + key, __popc(peers));
    }
  }
  __syncwarp();

  const int rr = r * r;
  for (int k = lane; k < k_total; k += 32) {
    const int nab = hist[k];
    float t = 0.f;
    if (nab > 0) {
      const int c = k / rr;
      const int a = (k / r) % r;
      const int b = k % r;
      const int* tab = hist + c * rr;
      int na = 0, nb = 0, nc = 0;
      for (int x = 0; x < r; ++x) {
        na += tab[a * r + x];
        nb += tab[x * r + b];
      }
      for (int x = 0; x < rr; ++x) nc += tab[x];
      const float lab = logf(fmaxf(static_cast<float>(nab), 1.f));
      const float lc = logf(fmaxf(static_cast<float>(nc), 1.f));
      const float la = logf(fmaxf(static_cast<float>(na), 1.f));
      const float lb = logf(fmaxf(static_cast<float>(nb), 1.f));
      t = __fmul_rn(static_cast<float>(nab),
                    __fsub_rn(__fsub_rn(__fadd_rn(lab, lc), la), lb));
    }
    term[k] = t;
  }
  __syncwarp();

  if (lane == 0) {
    float g2 = 0.f;
    for (int k = 0; k < k_total; ++k) g2 = __fadd_rn(g2, term[k]);
    g2_out[cell] = __fmul_rn(2.f, g2);
  }
}

}  // namespace

// jc: (n_cells, m) int32 device pointer; g2: (n_cells,) float32. k_total =
// q·r² (the port caps it at MAX_G2_TABLE = 4096; one warp's 8·k_total bytes
// must fit a block's shared memory). Returns the launch's cudaError_t.
extern "C" int repro_gsq(const int* jc, float* g2, long long n_cells, int m, int k_total,
                         int r, cudaStream_t stream) {
  if (n_cells <= 0) return 0;
  const size_t per_warp = static_cast<size_t>(2) * k_total * sizeof(int);
  int warps = static_cast<int>(98304 / per_warp);
  warps = warps < 1 ? 1 : (warps > 8 ? 8 : warps);
  const size_t smem = per_warp * warps;
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(gsq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long blocks = (n_cells + warps - 1) / warps;
  gsq_kernel<<<static_cast<unsigned>(blocks), warps * 32, smem, stream>>>(jc, g2, n_cells, m,
                                                                         k_total, r);
  return static_cast<int>(cudaGetLastError());
}
