// cuPC-S neighbour sweep: for every (set b, neighbour slot p), with the
// set's shared G, u and var_i from cholinv,
//     num   = C_ij − C(j,S)·u
//     var_j = 1 − C(j,S)ᵀ G C(j,S)
//     ρ     = num · rsqrt(max(var_i·var_j, 1e-20)), clipped to ±0.9999999
//     out   = (|atanh ρ| ≤ τ) ∧ mask.
//
// Replaces src/repro/kernels/cisweep.py::cisweep_kernel (_cisweep_kernel),
// where TPU lanes held sets and the slot axis was unrolled per block.
//
// What bounds it on an H100: per cell about ℓ² + 3ℓ + 15 operations
// against 4ℓ + 6 bytes (C(j,S), C_ij, mask in, one byte out), so bytes
// bound it for ℓ ≤ 8: the card's balance point is about 20 fp32
// operations per byte (67 TFLOP/s over 3.35 TB/s). The
// design: one thread per (set, slot); a block holds SB whole sets × PB
// slots (PB the slot count rounded up to a power of two, at most 128), so
// the block's threads read neighbouring C(j,S), C_ij and mask entries and
// write neighbouring bytes. The SB sets' G, u and var are read once per
// block into shared memory with coalesced loads. A masked cell writes 0
// and costs no atanhf.
//
// The per-cell arithmetic is cisweep_cell (cisweep.cuh), which the fused
// S-kernel (skernel.cu) shares.
#include <cuda_runtime.h>
#include <stdint.h>

#include "cisweep.cuh"

namespace {

template <int L>
__global__ void __launch_bounds__(256)
cisweep_kernel(const float* __restrict__ g, const float* __restrict__ u,
               const float* __restrict__ var, const float* __restrict__ cjs,
               const float* __restrict__ cij, const uint8_t* __restrict__ mask,
               uint8_t* __restrict__ out, long long b, int p, float tau) {
  extern __shared__ float smem[];
  const int sb = blockDim.y;
  float* g_s = smem;                // (sb, L, L)
  float* u_s = g_s + sb * L * L;    // (sb, L)
  float* v_s = u_s + sb * L;        // (sb,)

  const long long set0 = static_cast<long long>(blockIdx.x) * sb;
  const long long n_sets = (b - set0) < sb ? (b - set0) : sb;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  for (int e = tid; e < n_sets * L * L; e += nthreads) g_s[e] = g[set0 * L * L + e];
  for (int e = tid; e < n_sets * L; e += nthreads) u_s[e] = u[set0 * L + e];
  for (int e = tid; e < n_sets; e += nthreads) v_s[e] = var[set0 + e];
  __syncthreads();

  const int ls = threadIdx.y;
  const long long s = set0 + ls;
  const int slot = blockIdx.y * blockDim.x + threadIdx.x;
  if (s >= b || slot >= p) return;
  const long long cell = s * p + slot;
  if (mask[cell] == 0) {
    out[cell] = 0;
    return;
  }

  float w[L];
#pragma unroll
  for (int i = 0; i < L; ++i) w[i] = cjs[cell * L + i];
  out[cell] =
      cisweep_cell<L>(w, cij[cell], g_s + ls * L * L, u_s + ls * L, v_s[ls], tau) ? 1 : 0;
}

template <int L>
int launch(const float* g, const float* u, const float* var, const float* cjs,
           const float* cij, const uint8_t* mask, uint8_t* out, long long b, int p,
           float tau, cudaStream_t stream) {
  int pb = 1;
  while (pb < p && pb < 128) pb <<= 1;
  int sb = 256 / pb;
  if (sb > 64) sb = 64;
  const dim3 block(pb, sb);
  const dim3 grid(static_cast<unsigned>((b + sb - 1) / sb),
                  static_cast<unsigned>((p + pb - 1) / pb));
  const size_t smem = static_cast<size_t>(sb) * (L * L + L + 1) * sizeof(float);
  cisweep_kernel<L><<<grid, block, smem, stream>>>(g, u, var, cjs, cij, mask, out, b, p, tau);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int repro_cisweep(const float* g, const float* u, const float* var,
                             const float* cjs, const float* cij, const uint8_t* mask,
                             uint8_t* out, long long b, int p, int ell, float tau,
                             void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (ell) {
    case 1: return launch<1>(g, u, var, cjs, cij, mask, out, b, p, tau, st);
    case 2: return launch<2>(g, u, var, cjs, cij, mask, out, b, p, tau, st);
    case 3: return launch<3>(g, u, var, cjs, cij, mask, out, b, p, tau, st);
    case 4: return launch<4>(g, u, var, cjs, cij, mask, out, b, p, tau, st);
    case 5: return launch<5>(g, u, var, cjs, cij, mask, out, b, p, tau, st);
    case 6: return launch<6>(g, u, var, cjs, cij, mask, out, b, p, tau, st);
    case 7: return launch<7>(g, u, var, cjs, cij, mask, out, b, p, tau, st);
    case 8: return launch<8>(g, u, var, cjs, cij, mask, out, b, p, tau, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
