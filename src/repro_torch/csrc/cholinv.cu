// Per-set ℓ×ℓ SPD inverse for cuPC-S: for every conditioning set S of a
// chunk, G = M2⁻¹ with M2 = C[S,S] (Tikhonov jitter scaled by the mean
// diagonal), plus the vectors the neighbour sweep shares,
// u = G·C(i,S) and var = 1 − C(i,S)·u.
//
// Replaces src/repro/kernels/cholinv.py::cholinv_kernel (_cholinv_kernel),
// where one TPU vector lane inverted one matrix in an (ℓ, ℓ, Bs, 128)
// struct-of-arrays layout with an identity-padded batch tail.
//
// What bounds it on an H100: about ℓ³ operations per set against
// (2ℓ² + 2ℓ + 1)·4 bytes moved, so bytes bound it at every ℓ ≤ 8. The
// design is the original cuPC-S mapping, one thread per set, with ℓ a
// template parameter (1..8) so every loop unrolls and the factor lives in
// registers. The layout is batch-first, (B, ℓ, ℓ), as the gather produces
// it: a warp's 32 sets occupy one contiguous span, so every sector it
// fetches is used and no transpose pass is needed. There is no padded
// tail; threads past B return.
//
// The per-set arithmetic is cholinv_set (cholinv.cuh), which the fused
// S-kernel (skernel.cu) shares: see there for its order of operations.
#include <cuda_runtime.h>

#include "cholinv.cuh"

namespace {

template <int L>
__global__ void __launch_bounds__(128)
cholinv_kernel(const float* __restrict__ m2, const float* __restrict__ ci,
               float* __restrict__ g, float* __restrict__ u, float* __restrict__ var,
               long long b, float jitter, float inv_l) {
  const long long s = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (s >= b) return;
  float a[L][L], cv[L];
#pragma unroll
  for (int i = 0; i < L; ++i) {
#pragma unroll
    for (int j = 0; j < L; ++j) a[i][j] = m2[s * L * L + i * L + j];
    cv[i] = ci[s * L + i];
  }
  float gg[L][L], uu[L], v;
  cholinv_set<L>(a, cv, jitter, inv_l, gg, uu, v);
#pragma unroll
  for (int i = 0; i < L; ++i) {
#pragma unroll
    for (int j = 0; j < L; ++j) g[s * L * L + i * L + j] = gg[i][j];
    u[s * L + i] = uu[i];
  }
  var[s] = v;
}

template <int L>
int launch(const float* m2, const float* ci, float* g, float* u, float* var, long long b,
           float jitter, cudaStream_t stream) {
  const int threads = 128;
  const long long blocks = (b + threads - 1) / threads;
  cholinv_kernel<L><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      m2, ci, g, u, var, b, jitter, static_cast<float>(1.0 / L));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int repro_cholinv(const float* m2, const float* ci, float* g, float* u,
                             float* var, long long b, int ell, float jitter, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (ell) {
    case 1: return launch<1>(m2, ci, g, u, var, b, jitter, st);
    case 2: return launch<2>(m2, ci, g, u, var, b, jitter, st);
    case 3: return launch<3>(m2, ci, g, u, var, b, jitter, st);
    case 4: return launch<4>(m2, ci, g, u, var, b, jitter, st);
    case 5: return launch<5>(m2, ci, g, u, var, b, jitter, st);
    case 6: return launch<6>(m2, ci, g, u, var, b, jitter, st);
    case 7: return launch<7>(m2, ci, g, u, var, b, jitter, st);
    case 8: return launch<8>(m2, ci, g, u, var, b, jitter, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
