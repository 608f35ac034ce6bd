// Dense level-1 cube: for every alive edge (i, j) test every candidate
// k ∈ adj(i) ∪ adj(j), k ∉ {i, j}, with the closed form
//     ρ(i,j|k) = (C_ij − C_ik·C_jk) · rsqrt((1 − C_ik²)(1 − C_jk²)),
// clipped to ±0.9999999, independent when |atanh ρ| ≤ τ. Outputs
// removed[i,j] (some k separates) and kwin[i,j] (the least separating k
// in adj(i) \ {j}, else 2^30).
//
// Replaces src/repro/kernels/level1.py::level1_dense_kernel
// (_level1_kernel), whose (bi, bj, bk) VMEM tiles carried the two
// accumulators across a sequential k grid axis.
//
// What bounds it on an H100: the cells a pair must test, its masked-in k
// up to the point where both outputs are final (about 2.5e8 at NCI-60's
// level-0 adjacency, of about 18 fp32 operations each, one of them an
// atanh), so instruction issue, not bytes (10·n² of input and output).
// A pair's cost varies from one step (an early own-row separator) to the
// whole row (an edge that survives, which tests every k). A tile of
// pairs walking k in lockstep pays its slowest pair's walk for all of
// them. The design: one block per row i and run of 64 j (so a row whose
// pairs walk far is spread over several SMs); its warps take the j from a
// shared counter, one pair a warp, and leave a pair as soon as both
// outputs are final, so a pair's cost is its own walk. A step covers 128
// consecutive k, four a lane (k0 + 4·lane + e), read as one 16-byte load
// of C[j, ·] and one 4-byte load of adj[j, ·] a lane (and the same of
// row i, which stays in L1) from copies whose rows are padded to a
// multiple of 4. The loads are not what sets the pace (prefetching the
// next step changed nothing); the per-cell predicate logic did, so the
// masks stay packed, a byte a k in one word a lane: candidates are
// adj(i) | adj(j) with i and j cleared, the four decisions set bytes of a
// word, and `__ballot_sync` of "some k of mine separates" and of "one of
// my k ∈ adj(i) separates" gives `found` and, through `__ffs` and the
// first such lane's own least k, the least own k of the step; since
// steps ascend, the first such step holds the least one. The atanh is
// skipped away from the threshold (window.cuh).
//
// The arithmetic uses the _rn intrinsics so nvcc does not contract the
// products into FMAs: each step rounds as the plain PyTorch version does.
#include <cuda_runtime.h>
#include <stdint.h>

#include "window.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kPer = 4;     // k a lane tests per step
constexpr int kJ = 64;      // pairs (i, j) a block takes from its row
constexpr int kBig = 1 << 30;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kWarps * 32)
level1_kernel(const float* __restrict__ c, const uint8_t* __restrict__ adj,
              uint8_t* __restrict__ removed, int* __restrict__ kwin, int n, int ld, float tau,
              float lo, float hi) {
  __shared__ int next;
  const int i = blockIdx.x;
  const int j_end = min(n, (static_cast<int>(blockIdx.y) + 1) * kJ);
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) next = blockIdx.y * kJ;
  __syncthreads();
  const float* ci = c + static_cast<size_t>(i) * ld;
  const uint8_t* ai = adj + static_cast<size_t>(i) * ld;

  for (;;) {
    int j = 0;
    if (lane == 0) j = atomicAdd(&next, 1);
    j = __shfl_sync(kFull, j, 0);
    if (j >= j_end) break;
    bool found = false;
    int kmin = kBig;
    if (j != i && ai[j] != 0) {
      const float* cj = c + static_cast<size_t>(j) * ld;
      const uint8_t* aj = adj + static_cast<size_t>(j) * ld;
      const float cij = ci[j];
      for (int k0 = 0; k0 < n; k0 += 32 * kPer) {
        const int kl = k0 + kPer * lane;  // this lane's first k; rows are padded to ld
        float4 cik = make_float4(0.f, 0.f, 0.f, 0.f), cjk = cik;
        unsigned own = 0, oth = 0;
        if (kl < ld) {
          cik = *reinterpret_cast<const float4*>(ci + kl);
          cjk = *reinterpret_cast<const float4*>(cj + kl);
          own = *reinterpret_cast<const unsigned*>(ai + kl);
          oth = *reinterpret_cast<const unsigned*>(aj + kl);
        }
        unsigned cand = own | oth;  // a byte per k
        if (static_cast<unsigned>(i - kl) < 4u) cand &= ~(0xffu << (8 * (i - kl)));
        if (static_cast<unsigned>(j - kl) < 4u) cand &= ~(0xffu << (8 * (j - kl)));
        const float cik_e[kPer] = {cik.x, cik.y, cik.z, cik.w};
        const float cjk_e[kPer] = {cjk.x, cjk.y, cjk.z, cjk.w};
        unsigned sep_bits = 0;
#pragma unroll
        for (int e = 0; e < kPer; ++e) {
          const float num = __fsub_rn(cij, __fmul_rn(cik_e[e], cjk_e[e]));
          const float den2 = __fmul_rn(__fsub_rn(1.f, __fmul_rn(cik_e[e], cik_e[e])),
                                       __fsub_rn(1.f, __fmul_rn(cjk_e[e], cjk_e[e])));
          float rho = __fmul_rn(num, rsqrtf(fmaxf(den2, 1e-20f)));
          rho = fminf(fmaxf(rho, -0.9999999f), 0.9999999f);
          if (independent(rho, tau, lo, hi)) sep_bits |= 0xffu << (8 * e);
        }
        sep_bits &= cand;
        const unsigned own_sep = sep_bits & own;
        const unsigned any = __ballot_sync(kFull, sep_bits != 0);
        const unsigned mine = __ballot_sync(kFull, own_sep != 0);
        const int first_own = (__ffs(own_sep) - 1) >> 3;
        found = found || any != 0;
        if (kmin == kBig && mine != 0) {
          const int src = __ffs(mine) - 1;
          kmin = k0 + kPer * src + __shfl_sync(kFull, first_own, src);
        }
        if (found && kmin != kBig) break;
      }
    }
    if (lane == 0) {
      const size_t ij = static_cast<size_t>(i) * n + j;
      removed[ij] = found ? 1 : 0;
      kwin[ij] = kmin;
    }
  }
}

__global__ void atanh_window_kernel(const float* __restrict__ rho, uint8_t* __restrict__ pref,
                                    uint8_t* __restrict__ direct, int count, float tau,
                                    float lo, float hi) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < count) {
    pref[e] = independent(rho[e], tau, lo, hi) ? 1 : 0;
    direct[e] = fabsf(atanhf(rho[e])) <= tau ? 1 : 0;
  }
}

}  // namespace

// c and adj with rows padded to ld, a multiple of 4 (zero padding: a
// padded k is in neither adjacency), 16-byte aligned
extern "C" int repro_level1_dense(const float* c, const uint8_t* adj, uint8_t* removed,
                                  int* kwin, int n, int ld, float tau, float lo, float hi,
                                  void* stream) {
  const dim3 grid(static_cast<unsigned>(n), static_cast<unsigned>((n + kJ - 1) / kJ));
  level1_kernel<<<grid, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      c, adj, removed, kwin, n, ld, tau, lo, hi);
  return static_cast<int>(cudaGetLastError());
}

// the level-1 decision with and without the atanh prefilter, for a test
extern "C" int repro_atanh_window(const float* rho, uint8_t* pref, uint8_t* direct, int count,
                                  float tau, float lo, float hi, void* stream) {
  atanh_window_kernel<<<static_cast<unsigned>((count + 255) / 256), 256, 0,
                        static_cast<cudaStream_t>(stream)>>>(rho, pref, direct, count, tau,
                                                             lo, hi);
  return static_cast<int>(cudaGetLastError());
}
