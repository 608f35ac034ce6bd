// The CI decision |atanh ρ| ≤ τ of the level-1 and sgrid kernels, with
// the atanh skipped away from the threshold: |ρ| < lo is independent and
// |ρ| > hi dependent, where lo < tanh τ < hi come from the host
// (kernels/level1.py::atanh_window: τ·2^-16 inside and outside the
// threshold in z, in float64, rounded outward). That margin is more than
// 40 times atanhf's documented 3-ulp error, so outside [lo, hi] the
// prefilter takes the decision atanhf would; between them, and for NaN
// (which fails both compares), atanhf decides. repro_atanh_window
// (level1.cu) checks this on the card.
#pragma once

static __device__ __forceinline__ bool independent(float rho, float tau, float lo, float hi) {
  const float a = fabsf(rho);
  if (a < lo) return true;
  if (a > hi) return false;
  return fabsf(atanhf(rho)) <= tau;
}
