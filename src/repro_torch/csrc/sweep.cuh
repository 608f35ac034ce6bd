// The grid-resident cuPC-S sweep that sgrid.cu and skernel.cu both
// launch: for every row i of a launch and every neighbour slot p, the
// least launch-local rank t whose conditioning set S_t separates i from
// the slot's neighbour j, and that set. One core, templated on
//  * a reader R: where a rank's set, C[S,S], C(i,S) and a cell's C(j,S),
//    C_ij and mask come from (sgrid.cu's Gathered, or Fused below);
//  * an arithmetic policy A: A::stage turns C[S,S] and C(i,S) into the
//    set's G, u and var_i, A::test decides one cell (sgrid.cu's own
//    arithmetic, or cholinv's and cisweep's device functions in
//    skernel.cu).
//
// What bounds it on an H100: fused, the compulsory bytes are the parts
// of C, adj and the neighbour lists the tests read, and the operations a
// few hundred per set and tens per cell, so both bounds are µs; what the
// sweep waits on is the latency of each cell's chain (ℓ reads of C from
// L2, a reciprocal square root, an atanh). The design: one 128-thread
// block per row. The block stages a tile of 128 ranks, one rank per
// thread (its set, A::stage, the upper G, u and var_i into shared
// memory), so every thread works during the inversions. Then groups of q
// lanes (q = 1 for n′ ≥ 128, up to 32 for small n′) take slots; each
// lane issues the loads of kAhead cells (ranks r0 + a·q + lane) and
// decides them all, so both the loads and the decision chains of a round
// overlap instead of each waiting on the one before; the least separating
// rank of the lane, then (a shuffle minimum) of the group, is the
// round's. A slot that separates leaves and writes its winner and set;
// rounds are warp-uniform. The first hit is the least rank with no
// atomics, because every rank below it in the slot's earlier rounds and
// tiles was tested and failed. A slot that can never separate (no edge,
// padded slot) leaves before its first round, a row none of whose slots
// is open stages nothing, the fused reader stops at the row's last valid
// rank, and the block leaves once every slot is closed. Launch-local
// ranks are int32 (levels._check_rank_capacity bounds a launch); offsets
// into the inputs are 64-bit.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "unrank.cuh"

namespace {

constexpr int kThreads = 128;  // threads a block, and ranks a tile
constexpr int kSentinel = 1 << 30;
constexpr unsigned kFull = 0xffffffffu;

// The fused reader: C (n, n), adj (n, n), the block's global row ids,
// compact and counts (n_l, n′) and (n_l,), the binomial table
// (n_max + 1, width) in int64 and the launch's first rank t0 (a device
// scalar, int32 or int64); the unrank is unrank.cuh's. C(j,S) is read as
// cj[s·s_stride + j·j_stride]: C[j,S] from row j of C (cj = C, strides
// 1 and n), or the same values along rows of a transposed copy (cj = Cᵀ,
// strides n and 1), which lanes on neighbouring slots read coalesced.
template <int L>
struct Fused {
  const float* c;
  const float* cj;
  long long cj_s_stride, cj_j_stride;
  const uint8_t* adj;
  const int* rows;
  const int* compact;
  const int* counts;
  const long long* table;
  const void* t0;
  int table_width, t0_wide, n, t_len, npr, n_max;

  struct Slot {
    const float* cj;
    int j;
    float cij;
  };
  // a row id ≥ n (a pad row of a sharded block: count 0, list all −1)
  // reads row n − 1, as the gather clamps it; none of its slots is open
  __device__ long long row(long long loc) const {
    const int r = rows[loc];
    return r < n ? r : n - 1;
  }
  __device__ int row_sets(long long loc) const {
    const int k = counts[loc];
    return k < 0 ? 0 : (k > n_max ? n_max : k);
  }
  // none when the row has fewer than ℓ + 1 neighbours: every slot's j
  // then lies in the one set there is, or there is none
  __device__ int ranks(long long loc) const {
    const int sets = row_sets(loc);
    return sets - 1 < L ? 0
                        : launch_row_ranks<L>(sets, launch_first_rank(t0, t0_wide), t_len,
                                              table, table_width);
  }
  // the set of a valid rank (unrank.cuh) and what its inverse reads of C
  __device__ void stage(long long loc, int t, float m[L][L], float ci[L], int* ids) const {
    const long long i = row(loc);
    unrank_set<L>(compact + loc * npr, row_sets(loc), launch_first_rank(t0, t0_wide) + t, table,
                  table_width, n, ids);
#pragma unroll
    for (int a = 0; a < L; ++a) {
      const float* ca = c + static_cast<long long>(ids[a]) * n;
#pragma unroll
      for (int b = 0; b < L; ++b) m[a][b] = ca[ids[b]];
      ci[a] = c[i * n + ids[a]];
    }
  }
  // j clipped to [0, n-1] as the gather clips it; false for a padded
  // slot or a removed edge, which no rank can separate
  __device__ bool slot(long long loc, int p, Slot& sl) const {
    const long long i = row(loc);
    const int jc = compact[loc * npr + p];
    sl.j = jc < 0 ? 0 : (jc < n ? jc : n - 1);
    sl.cij = c[i * n + sl.j];
    sl.cj = cj + sl.j * cj_j_stride;
    return jc >= 0 && adj[i * n + sl.j] != 0;
  }
  // j ∈ S is found from the set ids before any load
  __device__ bool cell(const Slot& sl, long long, int, int, const int* s, float w[L],
                       float& num0) const {
#pragma unroll
    for (int a = 0; a < L; ++a)
      if (s[a] == sl.j) return false;
#pragma unroll
    for (int a = 0; a < L; ++a) w[a] = sl.cj[s[a] * cj_s_stride];
    num0 = sl.cij;
    return true;
  }
};

template <int L, class R, class A>
__global__ void __launch_bounds__(kThreads)
sweep_kernel(R rd, int* __restrict__ t_loc, int* __restrict__ s_win, int npr, int q_log2,
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
  int open_any = 0;
  for (int p = tid; p < npr; p += kThreads) {
    win[p] = kSentinel;
    typename R::Slot sl;
    open_any |= rd.slot(loc, p, sl);
  }
  // also the barrier after the winners' initialisation
  const int t_row = __syncthreads_or(open_any) ? rd.ranks(loc) : 0;

  for (int tile0 = 0; tile0 < t_row; tile0 += kThreads) {
    const int tile_n = t_row - tile0 < kThreads ? t_row - tile0 : kThreads;
    if (tid < tile_n) {
      float m[L][L], c[L], g[L][L], u[L], v;
      rd.stage(loc, tile0 + tid, m, c, ids_s[tid]);
      A::stage(m, c, jitter, inv_l, g, u, v);
#pragma unroll
      for (int i = 0; i < L; ++i) {
#pragma unroll
        for (int j = i; j < L; ++j) g_s[tid][i * L + j] = g[i][j];
        u_s[tid][i] = u[i];
      }
      v_s[tid] = v;
    }
    __syncthreads();

    open_any = 0;
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
          sep[a] = in[a] && A::test(w[a], num0[a], g_s[r], u_s[r], v_s[r], tau, lo, hi);
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

template <int L, class A, class R>
int launch_sweep(const R& rd, int* t_loc, int* s_win, int n_l, int npr, float tau, float jitter,
                 float lo, float hi, cudaStream_t stream) {
  sweep_kernel<L, R, A><<<static_cast<unsigned>(n_l), kThreads, 0, stream>>>(
      rd, t_loc, s_win, npr, group_log2(npr), tau, jitter, static_cast<float>(1.0 / L), lo, hi);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// the launcher's switch over ℓ = 1..8; CASE(L) returns from each case
#define REPRO_SWEEP_SWITCH(ell, CASE)                        \
  switch (ell) {                                             \
    CASE(1)                                                  \
    CASE(2)                                                  \
    CASE(3)                                                  \
    CASE(4)                                                  \
    CASE(5)                                                  \
    CASE(6)                                                  \
    CASE(7)                                                  \
    CASE(8)                                                  \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }
