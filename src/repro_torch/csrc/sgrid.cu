// Grid-resident cuPC-S: for every row i of a launch and every neighbour
// slot p, the least launch-local rank t whose conditioning set S_t
// separates i from the slot's neighbour j, and that set:
//     g     = M2⁻¹ of M2 = C[S,S] (1/x at ℓ = 1, the adjugate at ℓ = 2,
//             Cholesky → L⁻¹ → Gram at ℓ ≥ 3; jitter scaled by the mean
//             diagonal), u = g·C(i,S), var_i = 1 − C(i,S)·u
//     num   = C_ij − C(j,S)·u,  var_j = 1 − Σ w_i² g_ii − Σ 2 w_i w_j g_ij
//     ρ     = num · rsqrt(max(var_i·var_j, 1e-20)), clipped to ±0.9999999
//     t_loc = least t with |atanh ρ| ≤ τ ∧ mask, else 2^30; s_win = S_t.
//
// Replaces src/repro/kernels/sgrid.py::sgrid_kernel (_sgrid_kernel,
// _inverse_tiles), where rows sat on the TPU's 128 lanes, ranks streamed
// 8 at a time through a sequential grid axis, and the winners accumulated
// across grid steps in revisited output blocks through a one-hot select.
//
// What bounds it on an H100: per tested cell about ℓ² + 3ℓ + 15
// operations against 4ℓ + 1 bytes (C(j,S) and the mask), so bytes bound
// it, and the loop ends early: a slot stops at its first separating rank.
// The design: one block per row; the block walks the launch's ranks in
// ascending tiles of 32. Per tile, 32 threads compute one rank's g, u and
// var_i each (ℓ a template parameter, the factor in registers) into
// shared memory; then each thread takes neighbour slots p (consecutive
// threads on consecutive slots, so the mask and C(j,S) loads coalesce)
// and walks the tile's ranks in ascending order until the first
// independent one, which is the least local rank: no atomics, no one-hot
// select, and no (n_l, T, n′) decision tensor. A slot with a winner skips
// later tiles, and the block leaves once every slot has one. The winners
// live in t_loc itself: each slot belongs to one thread for the whole
// launch. cij is read through a row stride and a rank stride, so the
// expanded (stride 0 over T) view the gather makes needs no copy.
//
// Every step rounds once, in _inverse_tiles' and the sweep's order
// (__fadd_rn, __fmul_rn, __fdiv_rn, __fsqrt_rn keep nvcc from
// contracting into FMAs), the rsqrt is correctly rounded (__frsqrt_rn),
// and NaN passes through the max and clip as in the plain PyTorch
// version, so kernel and plain version take the same decisions on the
// card. Launch-local ranks are int32 (levels._check_rank_capacity bounds
// a launch); offsets into the inputs are 64-bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;
constexpr int kSentinel = 1 << 30;

__device__ __forceinline__ float max_keep_nan(float x, float lo) { return x < lo ? lo : x; }

__device__ __forceinline__ float clip_keep_nan(float x, float c) {
  return x < -c ? -c : (x > c ? c : x);
}

// g = M2⁻¹ for one set, branch for branch as _inverse_tiles
template <int L>
__device__ __forceinline__ void set_inverse(const float* __restrict__ m, float jitter,
                                            float inv_l, float g[L][L]) {
  if constexpr (L == 1) {
    g[0][0] = __fdiv_rn(1.f, max_keep_nan(m[0], 1e-8f));
  } else {
    float scale = m[0];
#pragma unroll
    for (int i = 1; i < L; ++i) scale = __fadd_rn(scale, m[i * L + i]);
    const float jit = __fmul_rn(jitter, __fmul_rn(scale, inv_l));
    if constexpr (L == 2) {
      const float a = __fadd_rn(m[0], jit), b = m[1], c = m[2], d = __fadd_rn(m[3], jit);
      const float det = __fsub_rn(__fmul_rn(a, d), __fmul_rn(b, c));
      g[0][0] = __fdiv_rn(d, det);
      g[0][1] = __fdiv_rn(-b, det);
      g[1][0] = __fdiv_rn(-c, det);
      g[1][1] = __fdiv_rn(a, det);
    } else {
      float a[L][L];
#pragma unroll
      for (int i = 0; i < L; ++i)
#pragma unroll
        for (int j = 0; j < L; ++j) a[i][j] = i == j ? __fadd_rn(m[i * L + j], jit) : m[i * L + j];
      float l[L][L];
#pragma unroll
      for (int j = 0; j < L; ++j) {
        float s = a[j][j];
#pragma unroll
        for (int k = 0; k < j; ++k) s = __fsub_rn(s, __fmul_rn(l[j][k], l[j][k]));
        l[j][j] = __fsqrt_rn(max_keep_nan(s, 1e-20f));
        const float inv_ljj = __fdiv_rn(1.f, l[j][j]);
#pragma unroll
        for (int i = j + 1; i < L; ++i) {
          s = a[i][j];
#pragma unroll
          for (int k = 0; k < j; ++k) s = __fsub_rn(s, __fmul_rn(l[i][k], l[j][k]));
          l[i][j] = __fmul_rn(s, inv_ljj);
        }
      }
      float mi[L][L];
#pragma unroll
      for (int j = 0; j < L; ++j) {
        mi[j][j] = __fdiv_rn(1.f, l[j][j]);
#pragma unroll
        for (int i = j + 1; i < L; ++i) {
          float s = __fmul_rn(l[i][j], mi[j][j]);
#pragma unroll
          for (int k = j + 1; k < i; ++k) s = __fadd_rn(s, __fmul_rn(l[i][k], mi[k][j]));
          mi[i][j] = __fdiv_rn(-s, l[i][i]);
        }
      }
#pragma unroll
      for (int i = 0; i < L; ++i) {
#pragma unroll
        for (int j = i; j < L; ++j) {
          float s = __fmul_rn(mi[j][i], mi[j][j]);
#pragma unroll
          for (int k = j + 1; k < L; ++k) s = __fadd_rn(s, __fmul_rn(mi[k][i], mi[k][j]));
          g[i][j] = s;
          g[j][i] = s;
        }
      }
    }
  }
}

template <int L>
__global__ void __launch_bounds__(256)
sgrid_kernel(const float* __restrict__ m2, const float* __restrict__ ci,
             const float* __restrict__ cjs, const float* __restrict__ cij,
             long long cij_row_stride, long long cij_t_stride,
             const uint8_t* __restrict__ mask, const int* __restrict__ s_ids,
             int* __restrict__ t_loc, int* __restrict__ s_win, int t_len, int npr, float tau,
             float jitter, float inv_l) {
  __shared__ float g_s[kTile][L][L];
  __shared__ float u_s[kTile][L];
  __shared__ float v_s[kTile];

  const long long row = blockIdx.x;
  const int tid = threadIdx.x;
  int* win = t_loc + row * npr;
  for (int p = tid; p < npr; p += blockDim.x) win[p] = kSentinel;

  for (int tile0 = 0; tile0 < t_len; tile0 += kTile) {
    const int tile_n = t_len - tile0 < kTile ? t_len - tile0 : kTile;
    if (tid < tile_n) {
      const long long rt = row * t_len + tile0 + tid;
      float g[L][L];
      set_inverse<L>(m2 + rt * L * L, jitter, inv_l, g);
      float c[L];
#pragma unroll
      for (int i = 0; i < L; ++i) c[i] = ci[rt * L + i];
      float v = 1.f;
#pragma unroll
      for (int i = 0; i < L; ++i) {
        float acc = __fmul_rn(g[i][0], c[0]);
#pragma unroll
        for (int j = 1; j < L; ++j) acc = __fadd_rn(acc, __fmul_rn(g[i][j], c[j]));
        u_s[tid][i] = acc;
#pragma unroll
        for (int j = 0; j < L; ++j) g_s[tid][i][j] = g[i][j];
      }
#pragma unroll
      for (int i = 0; i < L; ++i) v = __fsub_rn(v, __fmul_rn(c[i], u_s[tid][i]));
      v_s[tid] = v;
    }
    __syncthreads();

    int open = 0;
    for (int p = tid; p < npr; p += blockDim.x) {
      if (win[p] != kSentinel) continue;
      const float cij_v = cij[row * cij_row_stride + static_cast<long long>(tile0) * cij_t_stride + p];
      int found = kSentinel;
      for (int r = 0; r < tile_n; ++r) {
        const long long cell = (row * t_len + tile0 + r) * npr + p;
        if (mask[cell] == 0) continue;
        const float num0 = cij_t_stride == 0
            ? cij_v
            : cij[row * cij_row_stride + static_cast<long long>(tile0 + r) * cij_t_stride + p];
        float w[L];
#pragma unroll
        for (int i = 0; i < L; ++i) w[i] = cjs[cell * L + i];
        float num = num0;
        float var_j = 1.f;
#pragma unroll
        for (int i = 0; i < L; ++i) {
          num = __fsub_rn(num, __fmul_rn(w[i], u_s[r][i]));
          var_j = __fsub_rn(var_j, __fmul_rn(__fmul_rn(w[i], w[i]), g_s[r][i][i]));
#pragma unroll
          for (int j = i + 1; j < L; ++j)
            var_j = __fsub_rn(var_j,
                              __fmul_rn(__fmul_rn(__fmul_rn(2.f, w[i]), w[j]), g_s[r][i][j]));
        }
        const float prod = max_keep_nan(__fmul_rn(v_s[r], var_j), 1e-20f);
        const float rho = clip_keep_nan(__fmul_rn(num, __frsqrt_rn(prod)), 0.9999999f);
        if (fabsf(atanhf(rho)) <= tau) {
          found = tile0 + r;
          break;
        }
      }
      if (found != kSentinel) {
        win[p] = found;
      } else {
        open = 1;
      }
    }
    // also the barrier before the next tile overwrites g_s, u_s and v_s
    if (!__syncthreads_or(open)) break;
  }

  for (int p = tid; p < npr; p += blockDim.x) {
    const int t = win[p];
    int* out = s_win + (row * npr + p) * L;
#pragma unroll
    for (int e = 0; e < L; ++e) out[e] = t == kSentinel ? 0 : s_ids[(row * t_len + t) * L + e];
  }
}

template <int L>
int launch(const float* m2, const float* ci, const float* cjs, const float* cij,
           long long cij_row_stride, long long cij_t_stride, const uint8_t* mask,
           const int* s_ids, int* t_loc, int* s_win, int n_l, int t_len, int npr, float tau,
           float jitter, cudaStream_t stream) {
  int threads = ((npr + 31) / 32) * 32;
  if (threads < kTile) threads = kTile;
  if (threads > 256) threads = 256;
  sgrid_kernel<L><<<static_cast<unsigned>(n_l), threads, 0, stream>>>(
      m2, ci, cjs, cij, cij_row_stride, cij_t_stride, mask, s_ids, t_loc, s_win, t_len, npr,
      tau, jitter, static_cast<float>(1.0 / L));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int repro_sgrid(const float* m2, const float* ci, const float* cjs, const float* cij,
                           long long cij_row_stride, long long cij_t_stride,
                           const uint8_t* mask, const int* s_ids, int* t_loc, int* s_win,
                           int n_l, int t_len, int npr, int ell, float tau, float jitter,
                           void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_SGRID_CASE(L)                                                                  \
  case L:                                                                                    \
    return launch<L>(m2, ci, cjs, cij, cij_row_stride, cij_t_stride, mask, s_ids, t_loc,     \
                     s_win, n_l, t_len, npr, tau, jitter, st);
  switch (ell) {
    REPRO_SGRID_CASE(1)
    REPRO_SGRID_CASE(2)
    REPRO_SGRID_CASE(3)
    REPRO_SGRID_CASE(4)
    REPRO_SGRID_CASE(5)
    REPRO_SGRID_CASE(6)
    REPRO_SGRID_CASE(7)
    REPRO_SGRID_CASE(8)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_SGRID_CASE
}
