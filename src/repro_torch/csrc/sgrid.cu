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
// Two entries share one sweep core, templated on an input reader:
//  * repro_sgrid_fused (the "S-grid" engine): reads C, Cᵀ, adj, the
//    rows' compacted neighbour lists and counts, the binomial table and
//    the launch's first rank, and nothing gathered. Each block unranks
//    its row's sets itself (the combinadic walk of levels._unrank_dyn,
//    closed form at ℓ = 1), so neither the (rows, T, n′, ·) gather nor
//    the host's unrank loop runs. Each value the sweep needs is one read
//    of C (5.7 MB at n = 1190, resident in the 50 MB L2): M2 = C[S,S],
//    C(i,S) and C_ij from rows of C, C(j,S) = Cᵀ[S, j] along rows of Cᵀ
//    (C is only symmetric to validation's tolerance, so C[j,S] is read as
//    the reference reads it, from a transposed copy), and the mask —
//    rank valid, j ∉ S, edge alive — from the row's count of sets, the
//    set ids in shared memory and the slot's adjacency bit.
//  * repro_sgrid (ops.ci_shared_grid, the reference's contract): reads
//    the gathered m2, ci_s, cj_s, cij, mask and s_ids.
//
// What bounds it on an H100: fused, the compulsory bytes are C, adj and
// the neighbour lists once (≈ 12 MB at NCI-60) and the operations a few
// hundred million, so both bounds are µs; what the sweep waits on is the
// latency of each cell's chain (ℓ reads of Cᵀ from L2, a correctly
// rounded rsqrt, an atanh). The design: one 128-thread block per row.
// The block stages a tile of 128 ranks, one rank per thread (unrank, set
// inverse, u and var_i into shared memory), so every thread works during
// the inversions. Then groups of q lanes (q = 1 for n′ ≥ 128, up to 32
// for small n′) take slots; each lane issues the loads of kAhead cells
// (ranks r0 + a·q + lane) and decides them all, so both the loads and the
// decision chains of a round overlap instead of each waiting on the one
// before; the least separating rank of the lane, then (a shuffle minimum)
// of the group, is the round's. A slot that separates leaves and writes
// its winner and set; rounds are warp-uniform. The first hit is the least
// rank with no atomics, because every rank below it in the slot's
// earlier rounds and tiles was tested and failed. A slot that can never
// separate (no edge, padded slot) leaves before its first round, the
// fused entry stops at the row's last valid rank, and the block leaves
// once every slot is closed. The atanh is skipped away from the
// threshold (window.cuh).
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

#include "window.cuh"

namespace {

constexpr int kThreads = 128;  // threads a block, and ranks a tile
constexpr int kSentinel = 1 << 30;
constexpr unsigned kFull = 0xffffffffu;

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
  __device__ void stage(long long loc, int t, float m[L * L], float c[L], int* ids) const {
    const long long rt = loc * t_len + t;
#pragma unroll
    for (int e = 0; e < L * L; ++e) m[e] = m2[rt * L * L + e];
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

// The fused launch of ops.chunk_s_grid: C and Cᵀ (n, n), adj (n, n), the
// block's global row ids, compact and counts (n_l, n′) and (n_l,), the
// binomial table (n_max + 1, width) in int64 and the launch's first rank
// t0 (a device scalar, int32 or int64). Rank t0 + t of a row is valid iff
// it is below C(counts_i, ℓ), so a row's valid ranks are a prefix.
template <int L>
struct Fused {
  const float* c;
  const float* ct;
  const uint8_t* adj;
  const int* rows;
  const int* compact;
  const int* counts;
  const long long* table;
  const void* t0;
  int table_width, t0_wide, n, t_len, npr, n_max;

  struct Slot {
    int j;
    float cij;
  };
  __device__ long long first_rank() const {
    return t0_wide ? *static_cast<const long long*>(t0) : *static_cast<const int*>(t0);
  }
  __device__ int row_sets(long long loc) const {
    const int k = counts[loc];
    return k < 0 ? 0 : (k > n_max ? n_max : k);
  }
  __device__ int ranks(long long loc) const {
    const long long left = table[row_sets(loc) * table_width + L] - first_rank();
    return left <= 0 ? 0 : (left >= t_len ? t_len : static_cast<int>(left));
  }
  // the set of a valid rank: levels._unrank_dyn's walk (k ascending, take
  // k while the rank lies below C(tail, slots left)), ids clipped to
  // [0, n − 1] as plan_sets clips them
  __device__ void stage(long long loc, int t, float m[L * L], float ci[L], int* ids) const {
    const long long i = rows[loc];
    const int* row = compact + loc * npr;
    const long long rank = first_rank() + t;
    if constexpr (L == 1) {
      ids[0] = row[rank];
    } else {
      const int n_dyn = row_sets(loc);
      long long rem = rank;
      int taken = 0;
      for (int k = 0; k < n_dyn && taken < L; ++k) {
        const long long cnt = table[(n_dyn - k - 1) * table_width + (L - taken - 1)];
        if (rem < cnt) {
          ids[taken++] = row[k];
        } else {
          rem -= cnt;
        }
      }
    }
#pragma unroll
    for (int a = 0; a < L; ++a) ids[a] = ids[a] < 0 ? 0 : (ids[a] < n ? ids[a] : n - 1);
#pragma unroll
    for (int a = 0; a < L; ++a) {
#pragma unroll
      for (int b = 0; b < L; ++b) m[a * L + b] = c[static_cast<long long>(ids[a]) * n + ids[b]];
      ci[a] = c[i * n + ids[a]];
    }
  }
  // j clipped to [0, n-1] as the gather clips it; false for a padded
  // slot or a removed edge, which no rank can separate
  __device__ bool slot(long long loc, int p, Slot& sl) const {
    const long long i = rows[loc];
    const int jc = compact[loc * npr + p];
    sl.j = jc < 0 ? 0 : (jc < n ? jc : n - 1);
    sl.cij = c[i * n + sl.j];
    return jc >= 0 && adj[i * n + sl.j] != 0;
  }
  __device__ bool cell(const Slot& sl, long long, int, int, const int* s, float w[L],
                       float& num0) const {
#pragma unroll
    for (int a = 0; a < L; ++a)
      if (s[a] == sl.j) return false;
#pragma unroll
    for (int a = 0; a < L; ++a) w[a] = ct[static_cast<long long>(s[a]) * n + sl.j];
    num0 = sl.cij;
    return true;
  }
};

template <int L, class R>
__global__ void __launch_bounds__(kThreads)
sgrid_kernel(R rd, int* __restrict__ t_loc, int* __restrict__ s_win, int npr, int q_log2,
             float tau, float jitter, float inv_l, float lo, float hi) {
  constexpr int kAhead = L >= 8 ? 1 : 8 / L;  // cells a lane loads and decides a round
  __shared__ float g_s[kThreads][L * L];
  __shared__ float u_s[kThreads][L];
  __shared__ float v_s[kThreads];
  __shared__ int ids_s[kThreads][L];

  const long long loc = blockIdx.x;
  const int tid = threadIdx.x;
  const int q = 1 << q_log2;
  const int sub = tid & (q - 1);
  const int gid = tid >> q_log2;
  const int n_groups = kThreads >> q_log2;
  int* win = t_loc + loc * npr;
  for (int p = tid; p < npr; p += kThreads) win[p] = kSentinel;
  const int t_row = rd.ranks(loc);
  __syncthreads();

  for (int tile0 = 0; tile0 < t_row; tile0 += kThreads) {
    const int tile_n = t_row - tile0 < kThreads ? t_row - tile0 : kThreads;
    if (tid < tile_n) {
      float m[L * L], c[L], g[L][L];
      rd.stage(loc, tile0 + tid, m, c, ids_s[tid]);
      set_inverse<L>(m, jitter, inv_l, g);
      float v = 1.f;
#pragma unroll
      for (int i = 0; i < L; ++i) {
        float acc = __fmul_rn(g[i][0], c[0]);
#pragma unroll
        for (int j = 1; j < L; ++j) acc = __fadd_rn(acc, __fmul_rn(g[i][j], c[j]));
        u_s[tid][i] = acc;
        v = __fsub_rn(v, __fmul_rn(c[i], acc));
#pragma unroll
        for (int j = 0; j < L; ++j) g_s[tid][i * L + j] = g[i][j];
      }
      v_s[tid] = v;
    }
    __syncthreads();

    int open_any = 0;
    for (int p0 = 0; p0 < npr; p0 += n_groups) {  // block-uniform
      const int p = p0 + gid;
      typename R::Slot sl;
      bool open = p < npr && win[p] == kSentinel && rd.slot(loc, p, sl);
      for (int r0 = 0; r0 < tile_n && __any_sync(kFull, open); r0 += q * kAhead) {
        float w[kAhead][L], num0[kAhead];
        bool in[kAhead];
#pragma unroll
        for (int a = 0; a < kAhead; ++a) {
          const int r = r0 + a * q + sub;
          in[a] = open && r < tile_n && rd.cell(sl, loc, tile0 + r, p, ids_s[r], w[a], num0[a]);
        }
        bool sep[kAhead];
#pragma unroll
        for (int a = 0; a < kAhead; ++a) {
          const int r = r0 + a * q + sub;
          sep[a] = in[a] && separates<L>(w[a], num0[a], g_s[r], u_s[r], v_s[r], tau, lo, hi);
        }
        int best = kSentinel;
#pragma unroll
        for (int a = kAhead - 1; a >= 0; --a)
          if (sep[a]) best = r0 + a * q + sub;
        for (int off = q >> 1; off > 0; off >>= 1) {
          const int other = __shfl_xor_sync(kFull, best, off);
          best = other < best ? other : best;
        }
        if (open && best != kSentinel) {
          open = false;
          if (sub == 0) {
            win[p] = tile0 + best;
            int* out = s_win + (loc * npr + p) * L;
#pragma unroll
            for (int e = 0; e < L; ++e) out[e] = ids_s[best][e];
          }
        }
      }
      open_any |= open;
    }
    // also the barrier before the next tile overwrites the staged sets
    if (!__syncthreads_or(open_any)) break;
  }

  for (int p = tid; p < npr; p += kThreads) {
    if (win[p] == kSentinel) {
      int* out = s_win + (loc * npr + p) * L;
#pragma unroll
      for (int e = 0; e < L; ++e) out[e] = 0;
    }
  }
}

// lanes a slot: the largest power of two ≤ 32 with q·n′ ≤ the block
int group_log2(int npr) {
  int lg = 0;
  while (lg < 5 && (npr << (lg + 1)) <= kThreads) ++lg;
  return lg;
}

template <int L, class R>
int launch(const R& rd, int* t_loc, int* s_win, int n_l, int npr, float tau, float jitter,
           float lo, float hi, cudaStream_t stream) {
  sgrid_kernel<L, R><<<static_cast<unsigned>(n_l), kThreads, 0, stream>>>(
      rd, t_loc, s_win, npr, group_log2(npr), tau, jitter, static_cast<float>(1.0 / L), lo, hi);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define REPRO_SGRID_SWITCH(CASE) \
  switch (ell) {                 \
    CASE(1)                      \
    CASE(2)                      \
    CASE(3)                      \
    CASE(4)                      \
    CASE(5)                      \
    CASE(6)                      \
    CASE(7)                      \
    CASE(8)                      \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }

extern "C" int repro_sgrid(const float* m2, const float* ci, const float* cjs, const float* cij,
                           long long cij_row_stride, long long cij_t_stride,
                           const uint8_t* mask, const int* s_ids, int* t_loc, int* s_win,
                           int n_l, int t_len, int npr, int ell, float tau, float jitter,
                           float lo, float hi, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_SGRID_CASE(L)                                                                   \
  case L:                                                                                     \
    return launch<L>(Gathered<L>{m2, ci, cjs, cij, cij_row_stride, cij_t_stride, mask, s_ids, \
                                 t_len, npr},                                                 \
                     t_loc, s_win, n_l, npr, tau, jitter, lo, hi, st);
  REPRO_SGRID_SWITCH(REPRO_SGRID_CASE)
#undef REPRO_SGRID_CASE
}

extern "C" int repro_sgrid_fused(const float* c, const float* ct, const uint8_t* adj,
                                 const int* rows, const int* compact, const int* counts,
                                 const long long* table, int table_width, const void* t0,
                                 int t0_wide, int* t_loc, int* s_win, int n, int n_l,
                                 int t_len, int npr, int n_max, int ell, float tau,
                                 float jitter, float lo, float hi, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_SGRID_CASE(L)                                                               \
  case L:                                                                                 \
    return launch<L>(Fused<L>{c, ct, adj, rows, compact, counts, table, t0, table_width,  \
                              t0_wide, n, t_len, npr, n_max},                             \
                     t_loc, s_win, n_l, npr, tau, jitter, lo, hi, st);
  REPRO_SGRID_SWITCH(REPRO_SGRID_CASE)
#undef REPRO_SGRID_CASE
}
#undef REPRO_SGRID_SWITCH
