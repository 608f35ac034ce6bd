// C = Xnᵀ Xn / m for standardised samples Xn (m, n), fp32 in and out.
//
// Replaces src/repro/kernels/corr.py::corr_matmul (_corr_kernel), the
// tiled MXU product whose sample axis was the TPU's sequential grid
// dimension. Here the sample loop runs inside each block instead.
//
// What bounds it on an H100: at the paper's §5.6 shape (m = 10000,
// n = 1000) the product is 2·m·n² = 2e10 FLOPs against 44 MB of input,
// so it is bound by fp32 arithmetic, not bytes. The tolerance of the port
// (atol 2e-6 against the float64 product) rules out TF32 tensor cores,
// so the design is a plain SIMT GEMM: 64×64 output tiles, 256 threads,
// 4×4 outputs per thread, 16-sample slabs of both column blocks staged
// through shared memory so each loaded value feeds 64 FMAs. The sum is
// kept in three levels, per slab (16 samples), per group of 32 slabs
// (512 samples) and overall, so a long sample loop adds small partials to
// the running sum instead of 16-sample slabs to a sum of order m.
// Ragged edges are masked with zeros, so the caller pads nothing.
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;   // output rows and columns per block
constexpr int kSlab = 16;   // samples staged per step
constexpr int kSide = 16;   // threads per block side
constexpr int kReg = kTile / kSide;  // outputs per thread per side
constexpr int kGroup = 32;  // slabs summed before joining the running sum

__global__ void __launch_bounds__(kSide * kSide)
xtx_kernel(const float* __restrict__ x, float* __restrict__ out, int m, int n,
           float inv_m) {
  __shared__ float a_s[kSlab][kTile];
  __shared__ float b_s[kSlab][kTile];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kSide + tx;
  const int i0 = blockIdx.y * kTile;
  const int j0 = blockIdx.x * kTile;

  float acc[kReg][kReg], mid[kReg][kReg];
#pragma unroll
  for (int a = 0; a < kReg; ++a)
#pragma unroll
    for (int b = 0; b < kReg; ++b) acc[a][b] = mid[a][b] = 0.f;

  for (int k0 = 0, slab = 1; k0 < m; k0 += kSlab, ++slab) {
    for (int e = tid; e < kSlab * kTile; e += kSide * kSide) {
      const int kk = e / kTile;
      const int cc = e % kTile;
      const int k = k0 + kk;
      const size_t row = static_cast<size_t>(k) * n;
      a_s[kk][cc] = (k < m && i0 + cc < n) ? x[row + i0 + cc] : 0.f;
      b_s[kk][cc] = (k < m && j0 + cc < n) ? x[row + j0 + cc] : 0.f;
    }
    __syncthreads();

    float part[kReg][kReg];
#pragma unroll
    for (int a = 0; a < kReg; ++a)
#pragma unroll
      for (int b = 0; b < kReg; ++b) part[a][b] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kSlab; ++kk) {
      float av[kReg], bv[kReg];
#pragma unroll
      for (int r = 0; r < kReg; ++r) {
        av[r] = a_s[kk][ty + kSide * r];
        bv[r] = b_s[kk][tx + kSide * r];
      }
#pragma unroll
      for (int a = 0; a < kReg; ++a)
#pragma unroll
        for (int b = 0; b < kReg; ++b) part[a][b] = fmaf(av[a], bv[b], part[a][b]);
    }
#pragma unroll
    for (int a = 0; a < kReg; ++a)
#pragma unroll
      for (int b = 0; b < kReg; ++b) mid[a][b] += part[a][b];
    if (slab % kGroup == 0 || k0 + kSlab >= m) {
#pragma unroll
      for (int a = 0; a < kReg; ++a)
#pragma unroll
        for (int b = 0; b < kReg; ++b) {
          acc[a][b] += mid[a][b];
          mid[a][b] = 0.f;
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int a = 0; a < kReg; ++a) {
    const int i = i0 + ty + kSide * a;
#pragma unroll
    for (int b = 0; b < kReg; ++b) {
      const int j = j0 + tx + kSide * b;
      if (i < n && j < n) out[static_cast<size_t>(i) * n + j] = acc[a][b] * inv_m;
    }
  }
}

}  // namespace

extern "C" int repro_corr_xtx(const float* x, float* out, int m, int n, float inv_m,
                              void* stream) {
  const dim3 block(kSide, kSide);
  const dim3 grid((n + kTile - 1) / kTile, (n + kTile - 1) / kTile);
  xtx_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(x, out, m, n, inv_m);
  return static_cast<int>(cudaGetLastError());
}
