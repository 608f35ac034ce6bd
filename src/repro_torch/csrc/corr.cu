// C = Xnᵀ Xn / m for standardised samples Xn (m, n), fp32 in and out: a
// symmetric rank-m update (SYRK) on the CUDA cores.
//
// Replaces src/repro/kernels/corr.py::corr_matmul (_corr_kernel), the
// tiled MXU product whose sample axis was the TPU's sequential grid
// dimension. Here the sample axis is split over blocks instead and summed
// in a second pass.
//
// What bounds it on an H100: at the paper's §5.6 shape (m = 10000,
// n = 1000) the symmetric half is m·n·(n+1) = 1.0e10 FLOPs against 44 MB of
// input, so fp32 arithmetic (67 TFLOP/s), not bytes. The port's tolerance
// (atol 2e-6 against the float64 product) rules out TF32 tensor cores, so
// the design is a SIMT SYRK:
//   * only output tiles with bi ≤ bj are computed (128×128, 256 threads,
//     8×8 outputs a thread, four 16-byte shared loads per 64 FMAs);
//   * both operands of a tile are 32-sample slabs of row-major X, i.e.
//     contiguous 2-D boxes: cp.async copies them (16 bytes a copy where
//     n % 4 == 0, 4 bytes otherwise; zero-filled past m and n) through a
//     3-stage ring (96 KB), so the next slabs arrive while this one is
//     multiplied. Both the copies and the reads walk shared rows
//     contiguously, so no padding is needed against bank conflicts; a
//     diagonal tile loads its one operand once;
//   * split-K: the wrapper splits the slabs into `splits` contiguous ranges
//     (kernels/corr.py::plan picks the count that fills the card), block
//     (tile, split) writes its partial tile to a scratch buffer, and a second
//     kernel sums the partials in split order in float64, scales by 1/m,
//     rounds once to fp32 and writes C[i, j] and its mirror C[j, i] from that
//     one value. No atomics: C is bitwise symmetric and bitwise the same from
//     run to run;
//   * a small m (m ≤ 512, chosen by kernels/corr.py::plan: NCI-60's m = 47)
//     takes 64-wide tiles with 16-sample slabs (n = 1190: 190 tiles, where
//     128-wide ones would leave SMs idle; m = 47 pads to 48) and one split,
//     so it needs no second pass: the block scales its tile in float64 and
//     writes it and its mirror itself, staged through shared memory so both
//     writes are row-contiguous. One launch, no scratch.
// Accuracy: each slab is an FMA chain of 32 samples, slabs add into a group
// sum of 16 slabs (512 samples), groups add into the block's scratch tile
// (a load-add-store by the owning thread; one group a split at the paper's
// shapes), and splits add in float64; a direct block adds its (at most 32)
// 16-sample slabs into one sum. One fp32 running sum over 10 000 samples
// drifted 2.4e-6; this order keeps C within 2e-7 of float64 there.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;    // output rows and columns per split-K block
constexpr int kSmallTile = 64;  // ... per block that writes C directly (m ≤ 512)
constexpr int kSide = 16;     // threads per block side
constexpr int kThreads = kSide * kSide;
constexpr int kSlab = 32;     // samples per pipeline stage (16 for 64-wide tiles)
constexpr int kStages = 3;
constexpr int kGroup = 16;    // slabs summed before joining the scratch tile
constexpr int kSub = 32;      // the reduction's sub-tile side
constexpr int kMaxDevices = 64;

__host__ __device__ constexpr int slab(int t) { return t == kTile ? kSlab : kSlab / 2; }

template <int T>
__host__ __device__ constexpr int smem_bytes() {
  return kStages * 2 * slab(T) * T * 4;  // both operands of every stage
}

__device__ __forceinline__ void cp_async(float* dst, const float* src, bool ok, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = ok ? bytes : 0;  // 0 source bytes: zero-fill
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(n));
  }
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Linear index t of an upper tile (row-major over bi ≤ bj) → (bi, bj).
__device__ __forceinline__ void upper_tile(int t, int nt, int& bi, int& bj) {
  bi = 0;
  while (t >= nt - bi) {
    t -= nt - bi;
    ++bi;
  }
  bj = bi + t;
}

// Stage samples [k0, k0 + slab(T)) of columns [c0, c0 + T) into dst[kk][c].
template <int T, int kVec>
__device__ __forceinline__ void load_slab(float* dst, const float* __restrict__ x, int m, int n,
                                          int k0, int c0, int tid) {
  constexpr int kPerRow = T / kVec;
  static_assert(slab(T) * kPerRow % kThreads == 0, "whole copies per thread");
#pragma unroll
  for (int it = 0; it < slab(T) * kPerRow / kThreads; ++it) {
    const int e = tid + it * kThreads;
    const int kk = e / kPerRow;
    const int c = (e % kPerRow) * kVec;
    const int k = k0 + kk;
    const bool ok = k < m && c0 + c < n;  // kVec = 4 only where n % 4 == 0
    const float* src = ok ? x + static_cast<size_t>(k) * n + c0 + c : x;
    cp_async(dst + kk * T + c, src, ok, 4 * kVec);
  }
}

// Block (tile, split): XᵀX of upper T×T tile `tile` over slabs [split·sps,
// min(ns, (split + 1)·sps)), each thread T/16 × T/16 outputs at rows
// ty·4 + {0..3} (+64) and columns tx·4 + {0..3} (+64). T = 64 (one split):
// C itself, scaled and mirrored, into dst = out. T = 128: the partial tile
// into dst = ws[split][tile][128][128].
template <int T, int kVec>
__global__ void __launch_bounds__(kThreads, T == kTile ? 1 : 2)
syrk_kernel(const float* __restrict__ x, float* __restrict__ dst, int m, int n, int nt,
            int tiles, int sps) {
  constexpr bool kDirect = T == kSmallTile;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int ty = tid / kSide;
  const int tx = tid % kSide;
  const int tile = blockIdx.x;
  const int split = blockIdx.y;
  int bi, bj;
  upper_tile(tile, nt, bi, bj);
  const bool diag = bi == bj;
  constexpr int kReg = T / kSide;  // 8 (T = 128) or 4 outputs per thread per side
  constexpr int S = slab(T);
  constexpr int kStageFloats = 2 * S * T;
  const int i0 = bi * T;
  const int j0 = bj * T;
  const int ns = (m + S - 1) / S;
  const int s_begin = split * sps;
  const int nsl = min(ns, s_begin + sps) - s_begin;

  auto stage = [&](int st) { return smem + st * kStageFloats; };
  auto fetch = [&](int t) {
    float* a = stage(t % kStages);
    const int k0 = (s_begin + t) * S;
    load_slab<T, kVec>(a, x, m, n, k0, i0, tid);
    if (!diag) load_slab<T, kVec>(a + S * T, x, m, n, k0, j0, tid);
  };

  float acc[kReg][kReg], part[kReg][kReg];
#pragma unroll
  for (int a = 0; a < kReg; ++a)
#pragma unroll
    for (int b = 0; b < kReg; ++b) acc[a][b] = 0.f;

  float* out = dst + (static_cast<size_t>(split) * tiles + tile) * T * T;
  bool first_group = true;
#pragma unroll
  for (int p = 0; p < kStages - 1; ++p) {
    if (p < nsl) fetch(p);
    cp_commit();
  }
  for (int t = 0; t < nsl; ++t) {
    cp_wait<kStages - 2>();
    __syncthreads();  // slab t has landed; every thread is done with slab t − 1
    if (t + kStages - 1 < nsl) fetch(t + kStages - 1);
    cp_commit();

    const float* a_s = stage(t % kStages);
    const float* b_s = diag ? a_s : a_s + S * T;
#pragma unroll
    for (int a = 0; a < kReg; ++a)
#pragma unroll
      for (int b = 0; b < kReg; ++b) part[a][b] = 0.f;
#pragma unroll
    for (int kk = 0; kk < S; ++kk) {
      float av[kReg], bv[kReg];
#pragma unroll
      for (int h = 0; h < kReg / 4; ++h) {
        const float4 a4 = *reinterpret_cast<const float4*>(a_s + kk * T + 64 * h + ty * 4);
        const float4 b4 = *reinterpret_cast<const float4*>(b_s + kk * T + 64 * h + tx * 4);
        av[4 * h] = a4.x, av[4 * h + 1] = a4.y, av[4 * h + 2] = a4.z, av[4 * h + 3] = a4.w;
        bv[4 * h] = b4.x, bv[4 * h + 1] = b4.y, bv[4 * h + 2] = b4.z, bv[4 * h + 3] = b4.w;
      }
#pragma unroll
      for (int a = 0; a < kReg; ++a)
#pragma unroll
        for (int b = 0; b < kReg; ++b) part[a][b] = fmaf(av[a], bv[b], part[a][b]);
    }
#pragma unroll
    for (int a = 0; a < kReg; ++a)
#pragma unroll
      for (int b = 0; b < kReg; ++b) acc[a][b] += part[a][b];

    if (!kDirect && ((t + 1) % kGroup == 0 || t + 1 == nsl)) {
      // thread-owned elements of the scratch tile: rows ty·4 + {0..3} (+64),
      // columns tx·4 + {0..3} (+64), as float4
#pragma unroll
      for (int a = 0; a < kReg; ++a) {
        const int r = ty * 4 + (a & 3) + 64 * (a >> 2);
#pragma unroll
        for (int h = 0; h < kReg / 4; ++h) {
          float4* d = reinterpret_cast<float4*>(out + r * T + 64 * h + tx * 4);
          float4 v = make_float4(acc[a][4 * h], acc[a][4 * h + 1], acc[a][4 * h + 2],
                                 acc[a][4 * h + 3]);
          if (!first_group) {
            const float4 o = *d;
            v.x += o.x;
            v.y += o.y;
            v.z += o.z;
            v.w += o.w;
          }
          *d = v;
#pragma unroll
          for (int b = 0; b < 4; ++b) acc[a][4 * h + b] = 0.f;
        }
      }
      first_group = false;
    }
  }
  if (!kDirect) return;

  // C = acc/m in float64, rounded once; in a diagonal tile r ≤ c written
  // directly and r < c mirrored. Columns [64h, 64h + 64) of the tile go
  // through sh[c − 64h][r], then out as rows of the tile and of its mirror.
  constexpr int kPitch = T + 1;
  static_assert(64 * kPitch * 4 <= smem_bytes<T>(), "64 columns fit the stage buffers");
  __syncthreads();  // every thread is done with the stage buffers
  float* sh = smem;
  const double inv_m = 1.0 / m;
#pragma unroll
  for (int h = 0; h < kReg / 4; ++h) {
#pragma unroll
    for (int a = 0; a < kReg; ++a) {
      const int r = ty * 4 + (a & 3) + 64 * (a >> 2);
#pragma unroll
      for (int b = 0; b < 4; ++b)
        sh[(tx * 4 + b) * kPitch + r] =
            static_cast<float>(static_cast<double>(acc[a][4 * h + b]) * inv_m);
    }
    __syncthreads();
    for (int e = tid; e < T * 64; e += kThreads) {
      const int r = e / 64;
      const int cl = e % 64;
      const int gi = i0 + r;
      const int gj = j0 + 64 * h + cl;
      if (gi < n && gj < n && (!diag || r <= 64 * h + cl))
        dst[static_cast<size_t>(gi) * n + gj] = sh[cl * kPitch + r];
    }
    for (int e = tid; e < T * 64; e += kThreads) {
      const int cl = e / T;
      const int r = e % T;
      const int gi = i0 + r;
      const int gj = j0 + 64 * h + cl;
      if (gi < n && gj < n && (!diag || r < 64 * h + cl))
        dst[static_cast<size_t>(gj) * n + gi] = sh[cl * kPitch + r];
    }
    __syncthreads();
  }
}

// Sum the splits' partial tiles in split order in float64, scale by 1/m,
// round once, and write C[i, j] and C[j, i]. One 32×8 block per 32×32
// sub-tile; the mirror goes through shared memory so both writes coalesce.
// In a diagonal tile only r ≤ c is written directly and r < c mirrored.
__global__ void __launch_bounds__(kSub * 8)
reduce_kernel(const float* __restrict__ ws, float* __restrict__ out, int m, int n, int nt,
              int tiles, int splits) {
  __shared__ float sh[kSub][kSub + 1];
  constexpr int kSubs = kTile / kSub;
  const int tile = blockIdx.x / (kSubs * kSubs);
  const int sub = blockIdx.x % (kSubs * kSubs);
  const int sr = sub / kSubs;
  const int sc = sub % kSubs;
  int bi, bj;
  upper_tile(tile, nt, bi, bj);
  const bool diag = bi == bj;
  if (diag && sr > sc) return;  // the whole block: its mirror sub-tile writes it
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const double inv_m = 1.0 / m;
  const size_t tile_stride = static_cast<size_t>(tiles) * kTile * kTile;
  const float* base = ws + static_cast<size_t>(tile) * kTile * kTile;
#pragma unroll
  for (int q = 0; q < kSub / 8; ++q) {
    const int r = sr * kSub + ty + 8 * q;
    const int c = sc * kSub + tx;
    double s = 0.0;
    for (int sp = 0; sp < splits; ++sp) s += base[sp * tile_stride + r * kTile + c];
    const float v = static_cast<float>(s * inv_m);
    sh[ty + 8 * q][tx] = v;
    const int gi = bi * kTile + r;
    const int gj = bj * kTile + c;
    if (gi < n && gj < n && (!diag || r <= c)) out[static_cast<size_t>(gi) * n + gj] = v;
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < kSub / 8; ++q) {
    const int r = sr * kSub + tx;  // the element (r, c) of the tile, written at (c, r)
    const int c = sc * kSub + ty + 8 * q;
    const int gi = bi * kTile + r;
    const int gj = bj * kTile + c;
    if (gi < n && gj < n && (!diag || r < c))
      out[static_cast<size_t>(gj) * n + gi] = sh[tx][ty + 8 * q];
  }
}

template <int T, int kVec>
cudaError_t launch_syrk(const float* x, float* dst, int m, int n, int splits, int sps,
                        cudaStream_t stream) {
  // above 48 KB of dynamic shared memory needs the opt-in, once per device
  static bool opted[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices || !opted[dev]) {
    err = cudaFuncSetAttribute(syrk_kernel<T, kVec>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<T>());
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) opted[dev] = true;
  }
  const int nt = (n + T - 1) / T;
  const int tiles = nt * (nt + 1) / 2;
  syrk_kernel<T, kVec><<<dim3(tiles, splits), kThreads, smem_bytes<T>(), stream>>>(
      x, dst, m, n, nt, tiles, sps);
  return cudaGetLastError();
}

}  // namespace

// x: (m, n) fp32 row-major; out: (n, n) fp32. The slabs (32 samples; 16
// for 64-wide tiles) are split into `splits` ranges of `sps` slabs (the
// last may be shorter, none empty). `tile` = 64 (one split, m ≤ 512) writes
// C directly and takes no scratch (ws may be null); `tile` = 128 writes
// partial tiles to ws, which holds splits·tiles·128·128 fp32 with tiles =
// nt(nt + 1)/2 and nt = ⌈n/128⌉, and a second launch reduces them into C.
// Returns the launches' cudaError_t.
extern "C" int repro_corr_xtx(const float* x, float* out, float* ws, int m, int n, int tile,
                              int splits, int sps, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (tile == kSmallTile && splits == 1)
    return static_cast<int>(vec ? launch_syrk<kSmallTile, 4>(x, out, m, n, 1, sps, s)
                                : launch_syrk<kSmallTile, 1>(x, out, m, n, 1, sps, s));
  if (tile != kTile || ws == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = vec ? launch_syrk<kTile, 4>(x, ws, m, n, splits, sps, s)
                        : launch_syrk<kTile, 1>(x, ws, m, n, splits, sps, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nt = (n + kTile - 1) / kTile;
  const int tiles = nt * (nt + 1) / 2;
  constexpr int kSubs = kTile / kSub;
  reduce_kernel<<<tiles * kSubs * kSubs, dim3(kSub, 8), 0, s>>>(ws, out, m, n, nt, tiles, splits);
  return static_cast<int>(cudaGetLastError());
}
