// Level 0 of the Gaussian test (paper Alg. 3), elementwise:
//     adj[i, j] = |atanh(clip(C_ij, ±0.9999999))| > τ  ∧  i ≠ j.
//
// Replaces src/repro/kernels/level0.py::level0_kernel (_level0_kernel),
// whose (256, 256) VMEM tiles masked the diagonal with a 2-D iota against
// the global tile offsets.
//
// What bounds it on an H100: 5·n² bytes (C read once, adj written once:
// 7.1 MB at n = 1190, about 2 µs at 3.35 TB/s); its eleven or so fp32
// operations per cell (atanhf counted as five) need a tenth of that. At
// NCI-60's n it is one short launch. One thread per (i, j), consecutive
// threads on consecutive j, a 64-bit flat index; the clip, atanhf and
// compare are those of the plain PyTorch version (core/levels.level0), so
// the two agree exactly.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
level0_kernel(const float* __restrict__ c, uint8_t* __restrict__ adj, int n, float tau) {
  const long long idx = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long cells = static_cast<long long>(n) * n;
  if (idx >= cells) return;
  const int i = static_cast<int>(idx / n);
  const int j = static_cast<int>(idx - static_cast<long long>(i) * n);
  const float rho = fminf(fmaxf(c[idx], -0.9999999f), 0.9999999f);
  adj[idx] = (fabsf(atanhf(rho)) > tau && i != j) ? 1 : 0;
}

}  // namespace

// c: (n, n) float32, adj: (n, n) uint8, device pointers. Returns the
// launch's cudaError_t.
extern "C" int repro_level0(const float* c, uint8_t* adj, int n, float tau, cudaStream_t stream) {
  const long long cells = static_cast<long long>(n) * n;
  if (cells == 0) return 0;
  const long long blocks = (cells + kThreads - 1) / kThreads;
  level0_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(c, adj, n, tau);
  return static_cast<int>(cudaGetLastError());
}
