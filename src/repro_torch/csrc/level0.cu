// Level 0 of the Gaussian test (paper Alg. 3), elementwise:
//     adj[i, j] = |atanh(clip(C_ij, ±0.9999999))| > τ  ∧  i ≠ j,
// and, in the fused entry, the rest of the level-0 span of the driver
// (core/pc.py): every cell's sepset row (slot 0 −1 for a kept edge and
// −2 for a removed one, the diagonal counted as removed; the other slots
// −1) and the largest row degree, the ℓ = 1 plan's max degree.
//
// Replaces src/repro/kernels/level0.py::level0_kernel (_level0_kernel),
// whose (256, 256) VMEM tiles masked the diagonal with a 2-D iota against
// the global tile offsets; the reference fills the sepsets and sums the
// degrees in separate XLA ops (src/repro/core/pc.py, the level-0 span).
//
// What bounds it on an H100: bytes. The adjacency alone moves 5·n² (C
// read once, adj written once: 7.1 MB at n = 1190, 2.1 µs at 3.35 TB/s);
// the fused entry 37·n² at sepset_depth 8 (the 32·n² of sepsets dominate:
// 52 MB, 15.6 µs). Its eleven or so fp32 operations a cell (atanhf counted
// as five) need a tenth of the bytes' time.
//
// The design: a block a row, so a row's degree is one block reduction
// and one atomicMax, and no cell needs a division to find its (i, j). A
// row of C starts at element i·n, 16-byte aligned only when i·n % 4 == 0,
// so the row is a head of up to 3 cells, a body of 4-cell groups (one
// float4 load of C and one 4-byte store of adj a thread, both aligned,
// since C's and adj's offsets agree mod 4) and a tail. The fused entry
// keeps the row's adjacency in shared memory and then writes the row's
// n·depth sepset words as one contiguous run: int4 stores when
// depth % 4 == 0 (a store lies within one cell), int stores otherwise,
// consecutive threads on consecutive addresses, as streaming stores
// (`__stcs`, evict-first: the 45 MB at n = 1190 are read again only by
// later levels, and need not displace C from L2); each thread steps its
// (cell, slot) by the block's stride with one compare, without a division.
// The clip, atanhf and compare are those of the plain PyTorch version
// (core/levels.level0), so the two agree exactly.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kLoads = 4;  // 4-cell groups a thread loads at once

__device__ __forceinline__ uint32_t keep(float c, float tau) {
  const float rho = fminf(fmaxf(c, -0.9999999f), 0.9999999f);
  return fabsf(atanhf(rho)) > tau ? 1u : 0u;
}

// sep == nullptr: the adjacency alone (max_deg unused). Otherwise the
// block's dynamic shared memory holds n + 3 bytes: the row's adjacency.
__global__ void __launch_bounds__(kThreads)
level0_kernel(const float* __restrict__ c, uint8_t* __restrict__ adj, int* __restrict__ sep,
              int* __restrict__ max_deg, int n, int depth, float tau) {
  extern __shared__ __align__(16) uint8_t row_adj[];
  __shared__ int warp_deg[kThreads / 32];
  const int i = blockIdx.x;
  const int t = threadIdx.x;
  const bool fused = sep != nullptr;
  const long long r0 = static_cast<long long>(i) * n;
  const float* crow = c + r0;
  uint8_t* arow = adj + r0;
  // cells before the first 16-byte aligned one, then whole 4-cell groups
  const int head = min(n, static_cast<int>((4 - (r0 & 3)) & 3));
  const int groups = (n - head) >> 2;
  const int tail0 = head + 4 * groups;
  // row_adj[j + shift]: the body's groups land on 4-byte aligned words
  const int shift = static_cast<int>(r0 & 3);

  int deg = 0;
  if (t < head || (t >= 4 && t - 4 < n - tail0)) {  // the head's and the tail's ≤ 3 cells
    const int j = t < head ? t : tail0 + t - 4;
    const uint32_t a = keep(crow[j], tau) & (j != i ? 1u : 0u);
    arow[j] = static_cast<uint8_t>(a);
    if (fused) row_adj[j + shift] = static_cast<uint8_t>(a);
    deg += a;
  }
  const float4* c4 = reinterpret_cast<const float4*>(crow + head);
  uint32_t* a4 = reinterpret_cast<uint32_t*>(arow + head);
  // kLoads groups a thread in flight: every load is issued before the
  // first atanhf (a row of n = 1190 is 297 groups, ≤ 3 a thread)
  for (int g0 = t; g0 < groups; g0 += kThreads * kLoads) {
    float4 v[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int g = g0 + u * kThreads;
      if (g < groups) v[u] = c4[g];
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int g = g0 + u * kThreads;
      if (g >= groups) break;
      const int j = head + 4 * g;
      const int d = i - j;  // the diagonal sits in this group when 0 ≤ d < 4
      const uint32_t b0 = keep(v[u].x, tau) & (d != 0 ? 1u : 0u);
      const uint32_t b1 = keep(v[u].y, tau) & (d != 1 ? 1u : 0u);
      const uint32_t b2 = keep(v[u].z, tau) & (d != 2 ? 1u : 0u);
      const uint32_t b3 = keep(v[u].w, tau) & (d != 3 ? 1u : 0u);
      const uint32_t packed = b0 | (b1 << 8) | (b2 << 16) | (b3 << 24);
      a4[g] = packed;
      if (fused) *reinterpret_cast<uint32_t*>(row_adj + j + shift) = packed;
      deg += b0 + b1 + b2 + b3;
    }
  }
  if (!fused) return;

  // the row's degree: a warp sum, then the block's, then one atomicMax
  deg = __reduce_add_sync(0xffffffffu, deg);
  if ((t & 31) == 0) warp_deg[t >> 5] = deg;
  __syncthreads();  // also publishes row_adj
  if (t == 0) {
    int row = 0;
    for (int w = 0; w < kThreads / 32; ++w) row += warp_deg[w];
    atomicMax(max_deg, row);
  }

  // the row's sepsets, n·depth contiguous words: units of 4 words
  // (int4) when depth % 4 == 0, else single words
  int* srow = sep + r0 * depth;
  const int vec = (depth & 3) == 0 ? 4 : 1;
  const int per_cell = depth / vec;  // units a cell
  const int units = n * per_cell;
  int cell = t / per_cell, slot = t - cell * per_cell;
  const int step_cell = kThreads / per_cell, step_slot = kThreads - step_cell * per_cell;
  if (vec == 4) {
    int4* s4 = reinterpret_cast<int4*>(srow);
    for (int u = t; u < units; u += kThreads) {
      const int first = slot == 0 ? (row_adj[cell + shift] ? -1 : -2) : -1;
      __stcs(s4 + u, make_int4(first, -1, -1, -1));
      cell += step_cell;
      slot += step_slot;
      if (slot >= per_cell) { slot -= per_cell; ++cell; }
    }
  } else {
    for (int u = t; u < units; u += kThreads) {
      __stcs(srow + u, slot == 0 ? (row_adj[cell + shift] ? -1 : -2) : -1);
      cell += step_cell;
      slot += step_slot;
      if (slot >= per_cell) { slot -= per_cell; ++cell; }
    }
  }
}

}  // namespace

// c: (n, n) float32, adj: (n, n) uint8, device pointers. Returns the
// launch's cudaError_t.
extern "C" int repro_level0(const float* c, uint8_t* adj, int n, float tau, cudaStream_t stream) {
  if (n == 0) return 0;
  level0_kernel<<<static_cast<unsigned>(n), kThreads, 0, stream>>>(c, adj, nullptr, nullptr, n,
                                                                    0, tau);
  return static_cast<int>(cudaGetLastError());
}

// The fused level-0 span: c (n, n) float32 → adj (n, n) uint8, sep
// (n, n, depth) int32 and max_deg, one int32 (0 for n = 0), which the
// launcher zeroes on the stream first. depth ≥ 1. Returns the first
// failing call's cudaError_t.
extern "C" int repro_level0_span(const float* c, uint8_t* adj, int* sep, int* max_deg, int n,
                                 int depth, float tau, cudaStream_t stream) {
  cudaError_t rc = cudaMemsetAsync(max_deg, 0, sizeof(int), stream);
  if (rc != cudaSuccess || n == 0) return static_cast<int>(rc);
  const size_t smem = (static_cast<size_t>(n) + 3 + 15) & ~static_cast<size_t>(15);
  if (smem > 48 * 1024) {
    rc = cudaFuncSetAttribute(level0_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  level0_kernel<<<static_cast<unsigned>(n), kThreads, smem, stream>>>(c, adj, sep, max_deg, n,
                                                                       depth, tau);
  return static_cast<int>(cudaGetLastError());
}
