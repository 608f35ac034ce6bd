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
// The order of operations mirrors _cholinv_kernel step for step
// (jit_eff = jitter·(scale·(1/ℓ)), eps = 1e-20, the Cholesky, forward
// substitution and Gram loop orders). Every product that feeds a running
// sum is one fused multiply-add (__fmaf_rn), as XLA contracts the
// reference on the CPU, and every other step uses the _rn intrinsics so
// nvcc contracts nothing else: each value rounds as in the plain PyTorch
// version, which emulates the same FMAs in float64.
#include <cuda_runtime.h>

namespace {

template <int L>
__global__ void __launch_bounds__(128)
cholinv_kernel(const float* __restrict__ m2, const float* __restrict__ ci,
               float* __restrict__ g, float* __restrict__ u, float* __restrict__ var,
               long long b, float jitter, float inv_l) {
  const long long s = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (s >= b) return;
  const float* a_in = m2 + s * L * L;

  float a[L][L];
#pragma unroll
  for (int i = 0; i < L; ++i)
#pragma unroll
    for (int j = 0; j < L; ++j) a[i][j] = a_in[i * L + j];

  float scale = a[0][0];
#pragma unroll
  for (int i = 1; i < L; ++i) scale = __fadd_rn(scale, a[i][i]);
  const float jit_eff = __fmul_rn(jitter, __fmul_rn(scale, inv_l));
#pragma unroll
  for (int i = 0; i < L; ++i) a[i][i] = __fadd_rn(a[i][i], jit_eff);
  const float eps = 1e-20f;

  // Cholesky: a = L Lᵀ
  float l[L][L];
#pragma unroll
  for (int j = 0; j < L; ++j) {
    float acc = a[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) acc = __fmaf_rn(-l[j][k], l[j][k], acc);
    l[j][j] = __fsqrt_rn(fmaxf(acc, eps));
    const float inv_ljj = __fdiv_rn(1.f, l[j][j]);
#pragma unroll
    for (int i = j + 1; i < L; ++i) {
      acc = a[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) acc = __fmaf_rn(-l[i][k], l[j][k], acc);
      l[i][j] = __fmul_rn(acc, inv_ljj);
    }
  }

  // M = L⁻¹ by forward substitution
  float minv[L][L];
#pragma unroll
  for (int j = 0; j < L; ++j) {
    minv[j][j] = __fdiv_rn(1.f, l[j][j]);
#pragma unroll
    for (int i = j + 1; i < L; ++i) {
      float acc = __fmul_rn(l[i][j], minv[j][j]);
#pragma unroll
      for (int k = j + 1; k < i; ++k) acc = __fmaf_rn(l[i][k], minv[k][j], acc);
      minv[i][j] = __fdiv_rn(-acc, l[i][i]);
    }
  }

  // G = MᵀM (upper triangle, mirrored) and u = G·C(i,S)
  float cv[L];
#pragma unroll
  for (int i = 0; i < L; ++i) cv[i] = ci[s * L + i];
  float uu[L];
#pragma unroll
  for (int i = 0; i < L; ++i) uu[i] = 0.f;
  float* g_out = g + s * L * L;
#pragma unroll
  for (int i = 0; i < L; ++i) {
#pragma unroll
    for (int j = i; j < L; ++j) {
      float acc = 0.f;
#pragma unroll
      for (int k = j; k < L; ++k) acc = __fmaf_rn(minv[k][i], minv[k][j], acc);
      g_out[i * L + j] = acc;
      g_out[j * L + i] = acc;
      uu[i] = __fmaf_rn(acc, cv[j], uu[i]);
      if (i != j) uu[j] = __fmaf_rn(acc, cv[i], uu[j]);
    }
  }

  float v = 1.f;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    u[s * L + i] = uu[i];
    v = __fmaf_rn(-cv[i], uu[i], v);
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
