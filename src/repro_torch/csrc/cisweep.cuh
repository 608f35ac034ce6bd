// One cell of cuPC-S's neighbour sweep: with a set's shared G, u and var_i
// (cholinv_set, cholinv.cuh) and w = C(j,S),
//     num   = C_ij − w·u
//     var_j = 1 − Σ w_a² g_aa − Σ_{a<b} 2 w_a w_b g_ab
//     ρ     = num · rsqrt(max(var_i·var_j, 1e-20)), clipped to ±0.9999999
//     independent = |atanh ρ| ≤ τ.
// The gathered cisweep kernel (cisweep.cu) and the fused S-kernel
// (skernel.cu) both call it, so the two paths take the same decisions.
//
// The order of operations mirrors src/repro/kernels/cisweep.py's
// _cisweep_kernel, and the _rn intrinsics keep nvcc from contracting
// products into FMAs, so each step rounds as in the plain PyTorch version
// (kernels/cisweep.py); rsqrtf and atanhf differ from the CPU's by a few
// ulps.
#pragma once

// g: the set's ℓ×ℓ G row-major (the upper triangle is read), u: its u
template <int L>
__device__ __forceinline__ bool cisweep_cell(const float w[L], float num, const float* g,
                                             const float* u, float var_i, float tau) {
  float var_j = 1.f;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    num = __fsub_rn(num, __fmul_rn(w[i], u[i]));
    var_j = __fsub_rn(var_j, __fmul_rn(__fmul_rn(w[i], w[i]), g[i * L + i]));
#pragma unroll
    for (int j = i + 1; j < L; ++j) {
      var_j = __fsub_rn(var_j,
                        __fmul_rn(__fmul_rn(__fmul_rn(2.f, w[i]), w[j]), g[i * L + j]));
    }
  }
  float rho = __fmul_rn(num, rsqrtf(fmaxf(__fmul_rn(var_i, var_j), 1e-20f)));
  rho = fminf(fmaxf(rho, -0.9999999f), 0.9999999f);
  return fabsf(atanhf(rho)) <= tau;
}
