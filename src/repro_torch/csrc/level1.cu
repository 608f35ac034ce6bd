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
// What bounds it on an H100: n³ candidate cells (1.7e9 at n = 1190) of
// about 18 fp32 operations each, one of them atanhf, against 10·n² bytes
// of input and output, so arithmetic bounds it, and early in a run
// nearly every cell is masked in. The design: one thread per (i, j) in a
// 16×16 block; the 16 C rows of the i-tile and of the j-tile and their
// adjacency rows are staged through shared memory 32 k at a time (rows
// padded to dodge bank conflicts); `found` and `kmin` stay in registers
// across the k loop. A masked cell costs no atanhf. Because k ascends,
// a thread whose `found` is set and whose `kmin` holds an own-row
// separator can change neither output again, so it stops testing, and a
// block whose threads have all stopped leaves the k loop. Neither
// shortcut changes an output.
//
// The arithmetic uses the _rn intrinsics so nvcc does not contract the
// products into FMAs: each step rounds as the plain PyTorch version does.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTi = 16;
constexpr int kTj = 16;
constexpr int kTk = 32;
constexpr int kBig = 1 << 30;

__global__ void __launch_bounds__(kTi * kTj)
level1_kernel(const float* __restrict__ c, const uint8_t* __restrict__ adj,
              uint8_t* __restrict__ removed, int* __restrict__ kwin, int n, float tau) {
  __shared__ float ci_s[kTi][kTk + 1];
  __shared__ float cj_s[kTj][kTk + 1];
  __shared__ uint8_t ai_s[kTi][kTk + 4];
  __shared__ uint8_t aj_s[kTj][kTk + 4];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kTj + tx;
  const int i0 = blockIdx.y * kTi;
  const int j0 = blockIdx.x * kTj;
  const int i = i0 + ty;
  const int j = j0 + tx;
  const bool in = i < n && j < n;
  const size_t ij = static_cast<size_t>(i) * n + j;
  const bool alive = in && i != j && adj[ij] != 0;
  const float cij = alive ? c[ij] : 0.f;

  bool found = false;
  int kmin = kBig;
  bool active = alive;

  for (int k0 = 0; k0 < n; k0 += kTk) {
    if (!__syncthreads_or(active)) break;
    for (int e = tid; e < kTi * kTk; e += kTi * kTj) {
      const int r = e / kTk;
      const int kk = e % kTk;
      const int k = k0 + kk;
      const int gi = i0 + r;
      const int gj = j0 + r;
      const bool ki = gi < n && k < n;
      const bool kj = gj < n && k < n;
      const size_t oi = static_cast<size_t>(gi) * n + k;
      const size_t oj = static_cast<size_t>(gj) * n + k;
      ci_s[r][kk] = ki ? c[oi] : 0.f;
      ai_s[r][kk] = ki ? adj[oi] : 0;
      cj_s[r][kk] = kj ? c[oj] : 0.f;
      aj_s[r][kk] = kj ? adj[oj] : 0;
    }
    __syncthreads();
    if (active) {
#pragma unroll 4
      for (int kk = 0; kk < kTk; ++kk) {
        const int k = k0 + kk;
        const bool own = ai_s[ty][kk] != 0;
        const bool oth = aj_s[tx][kk] != 0;
        if (!(own || oth) || k == i || k == j) continue;
        const float cik = ci_s[ty][kk];
        const float cjk = cj_s[tx][kk];
        const float num = __fsub_rn(cij, __fmul_rn(cik, cjk));
        const float den2 = __fmul_rn(__fsub_rn(1.f, __fmul_rn(cik, cik)),
                                     __fsub_rn(1.f, __fmul_rn(cjk, cjk)));
        float rho = __fmul_rn(num, rsqrtf(fmaxf(den2, 1e-20f)));
        rho = fminf(fmaxf(rho, -0.9999999f), 0.9999999f);
        if (fabsf(atanhf(rho)) <= tau) {
          found = true;
          if (own && k < kmin) kmin = k;
        }
      }
      active = !(found && kmin < kBig);
    }
    __syncthreads();
  }
  if (in) {
    removed[ij] = found ? 1 : 0;
    kwin[ij] = kmin;
  }
}

}  // namespace

extern "C" int repro_level1_dense(const float* c, const uint8_t* adj, uint8_t* removed,
                                  int* kwin, int n, float tau, void* stream) {
  const dim3 block(kTj, kTi);
  const dim3 grid((n + kTj - 1) / kTj, (n + kTi - 1) / kTi);
  level1_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(c, adj, removed,
                                                                      kwin, n, tau);
  return static_cast<int>(cudaGetLastError());
}
