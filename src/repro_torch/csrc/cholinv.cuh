// One set's step of cuPC-S's shared inverse: G = M2⁻¹ of M2 = C[S,S]
// (Tikhonov jitter scaled by the mean diagonal), u = G·C(i,S) and
// var = 1 − C(i,S)·u. The gathered cholinv kernel (cholinv.cu) and the
// fused S-kernel (skernel.cu) both call it, so the two paths round every
// value alike.
//
// The order of operations mirrors src/repro/kernels/cholinv.py's
// _cholinv_kernel step for step (jit_eff = jitter·(scale·(1/ℓ)),
// eps = 1e-20, the Cholesky, forward substitution and Gram loop orders).
// Every product that feeds a running sum is one fused multiply-add
// (__fmaf_rn), as XLA contracts the reference on the CPU, and every other
// step uses the _rn intrinsics so nvcc contracts nothing else: each value
// rounds as in the plain PyTorch version (kernels/cholinv.py), which
// emulates the same FMAs in float64.
#pragma once

// a: M2 (overwritten with its jittered copy), cv: C(i,S); out: g (both
// triangles), uu and var
template <int L>
__device__ __forceinline__ void cholinv_set(float a[L][L], const float cv[L], float jitter,
                                            float inv_l, float g[L][L], float uu[L],
                                            float& var) {
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
#pragma unroll
  for (int i = 0; i < L; ++i) uu[i] = 0.f;
#pragma unroll
  for (int i = 0; i < L; ++i) {
#pragma unroll
    for (int j = i; j < L; ++j) {
      float acc = 0.f;
#pragma unroll
      for (int k = j; k < L; ++k) acc = __fmaf_rn(minv[k][i], minv[k][j], acc);
      g[i][j] = acc;
      g[j][i] = acc;
      uu[i] = __fmaf_rn(acc, cv[j], uu[i]);
      if (i != j) uu[j] = __fmaf_rn(acc, cv[i], uu[j]);
    }
  }

  float v = 1.f;
#pragma unroll
  for (int i = 0; i < L; ++i) v = __fmaf_rn(-cv[i], uu[i], v);
  var = v;
}
