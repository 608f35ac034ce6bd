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
// across grid steps in revisited output blocks. That kernel needed every
// operand pre-gathered into (rows, T, n′, ℓ) arrays, because BlockSpecs
// cut dense arrays.
//
// Two entries launch the sweep core of sweep.cuh (shared with
// skernel.cu) with this file's arithmetic, each through its reader:
//  * repro_sgrid_fused (the "S-grid" engine): sweep.cuh's Fused reader,
//    on C, Cᵀ, adj, the rows' compacted neighbour lists and counts, the
//    binomial table and the launch's first rank, and nothing gathered.
//    Each block unranks its row's sets itself (the combinadic walk of
//    levels._unrank_dyn, closed form at ℓ = 1; unrank.cuh), so neither
//    the (rows, T, n′, ·) gather nor the host's unrank loop runs. Each
//    value the sweep needs is one read of C (5.7 MB at n = 1190,
//    resident in the 50 MB L2): M2 = C[S,S], C(i,S) and C_ij from rows
//    of C, C(j,S) = Cᵀ[S, j] along rows of Cᵀ (C is only symmetric to
//    validation's tolerance, so C[j,S] is read as the reference reads
//    it, from a transposed copy), and the mask — rank valid, j ∉ S, edge
//    alive — from the row's count of sets, the set ids in shared memory
//    and the slot's adjacency bit.
//  * repro_sgrid (ops.ci_shared_grid, the reference's contract): the
//    Gathered reader below, on the gathered m2, ci_s, cj_s, cij, mask
//    and s_ids.
// The design and what bounds it are sweep.cuh's. The atanh is skipped
// away from the threshold (window.cuh).
//
// Every step rounds once, in _inverse_tiles' and the sweep's order
// (__fadd_rn, __fmul_rn, __fdiv_rn, __fsqrt_rn keep nvcc from
// contracting into FMAs), the rsqrt is correctly rounded (__frsqrt_rn),
// and NaN passes through the max and clip as in the plain PyTorch
// version, so kernel and plain version take the same decisions on the
// card.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sweep.cuh"
#include "window.cuh"

namespace {

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

// one cell's CI test against a staged set: num, var_j, ρ and |atanh ρ| ≤ τ
template <int L>
__device__ __forceinline__ bool separates(const float w[L], float num, const float* g,
                                          const float* u, float var_i, float tau, float lo,
                                          float hi) {
  float var_j = 1.f;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    num = __fsub_rn(num, __fmul_rn(w[i], u[i]));
    var_j = __fsub_rn(var_j, __fmul_rn(__fmul_rn(w[i], w[i]), g[i * L + i]));
#pragma unroll
    for (int j = i + 1; j < L; ++j)
      var_j = __fsub_rn(var_j, __fmul_rn(__fmul_rn(__fmul_rn(2.f, w[i]), w[j]), g[i * L + j]));
  }
  const float prod = max_keep_nan(__fmul_rn(var_i, var_j), 1e-20f);
  const float rho = clip_keep_nan(__fmul_rn(num, __frsqrt_rn(prod)), 0.9999999f);
  return independent(rho, tau, lo, hi);
}

// The gathered launch of ops.ci_shared_grid: m2 (n_l,T,ℓ,ℓ), ci_s (n_l,T,ℓ),
// cj_s (n_l,T,n′,ℓ), cij through a row and a rank stride, mask (n_l,T,n′),
// s_ids (n_l,T,ℓ).
template <int L>
struct Gathered {
  const float* m2;
  const float* ci;
  const float* cjs;
  const float* cij;
  long long cij_row_stride, cij_t_stride;
  const uint8_t* mask;
  const int* s_ids;
  int t_len, npr;

  struct Slot {};
  __device__ int ranks(long long) const { return t_len; }
  __device__ void stage(long long loc, int t, float m[L][L], float c[L], int* ids) const {
    const long long rt = loc * t_len + t;
#pragma unroll
    for (int e = 0; e < L * L; ++e) m[e / L][e % L] = m2[rt * L * L + e];
#pragma unroll
    for (int e = 0; e < L; ++e) {
      c[e] = ci[rt * L + e];
      ids[e] = s_ids[rt * L + e];
    }
  }
  __device__ bool slot(long long, int, Slot&) const { return true; }
  // loads issued whatever the mask says, so they never wait on it
  __device__ bool cell(const Slot&, long long loc, int t, int p, const int*, float w[L],
                       float& num0) const {
    const long long cell = (loc * t_len + t) * npr + p;
#pragma unroll
    for (int e = 0; e < L; ++e) w[e] = cjs[cell * L + e];
    num0 = cij[loc * cij_row_stride + static_cast<long long>(t) * cij_t_stride + p];
    return mask[cell] != 0;
  }
};

// this file's arithmetic, as sweep.cuh's policy A
template <int L>
struct SgridMath {
  __device__ static void stage(float m[L][L], const float c[L], float jitter, float inv_l,
                               float g[L][L], float u[L], float& v) {
    set_inverse<L>(&m[0][0], jitter, inv_l, g);
    v = 1.f;
#pragma unroll
    for (int i = 0; i < L; ++i) {
      float acc = __fmul_rn(g[i][0], c[0]);
#pragma unroll
      for (int j = 1; j < L; ++j) acc = __fadd_rn(acc, __fmul_rn(g[i][j], c[j]));
      u[i] = acc;
      v = __fsub_rn(v, __fmul_rn(c[i], acc));
    }
  }
  __device__ static bool test(const float w[L], float num, const float* g, const float* u,
                              float var_i, float tau, float lo, float hi) {
    return separates<L>(w, num, g, u, var_i, tau, lo, hi);
  }
};

}  // namespace

extern "C" int repro_sgrid(const float* m2, const float* ci, const float* cjs, const float* cij,
                           long long cij_row_stride, long long cij_t_stride,
                           const uint8_t* mask, const int* s_ids, int* t_loc, int* s_win,
                           int n_l, int t_len, int npr, int ell, float tau, float jitter,
                           float lo, float hi, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_SGRID_CASE(L)                                                                  \
  case L:                                                                                    \
    return launch_sweep<L, SgridMath<L>>(                                                    \
        Gathered<L>{m2, ci, cjs, cij, cij_row_stride, cij_t_stride, mask, s_ids, t_len, npr}, \
        t_loc, s_win, n_l, npr, tau, jitter, lo, hi, st);
  REPRO_SWEEP_SWITCH(ell, REPRO_SGRID_CASE)
#undef REPRO_SGRID_CASE
}

// C(j,S) from Cᵀ: strides n over S and 1 over j
extern "C" int repro_sgrid_fused(const float* c, const float* ct, const uint8_t* adj,
                                 const int* rows, const int* compact, const int* counts,
                                 const long long* table, int table_width, const void* t0,
                                 int t0_wide, int* t_loc, int* s_win, int n, int n_l,
                                 int t_len, int npr, int n_max, int ell, float tau,
                                 float jitter, float lo, float hi, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_SGRID_CASE(L)                                                                \
  case L:                                                                                  \
    return launch_sweep<L, SgridMath<L>>(                                                  \
        Fused<L>{c, ct, n, 1, adj, rows, compact, counts, table, t0, table_width, t0_wide, \
                 n, t_len, npr, n_max},                                                    \
        t_loc, s_win, n_l, npr, tau, jitter, lo, hi, st);
  REPRO_SWEEP_SWITCH(ell, REPRO_SGRID_CASE)
#undef REPRO_SGRID_CASE
}
