// Fused cuPC-S chunk (the "S-kernel" engine on the card, so the ℓ ≥ 2
// levels of "auto"): for every row i of a chunk and every neighbour slot
// p, the least launch-local rank t whose conditioning set S_t separates i
// from the slot's neighbour j, and that set, in one launch:
//     g, u, var_i = cholinv_set(C[S,S], C(i,S))        (cholinv.cuh)
//     independent = cisweep_cell(C(j,S), C_ij, g, ...)  (cisweep.cuh)
//     t_loc = least t with independent ∧ mask, else 2^30; s_win = S_t.
//
// Replaces src/repro/kernels/cholinv.py::cholinv_kernel and
// src/repro/kernels/cisweep.py::cisweep_kernel as the engine runs them:
// two pallas_calls a chunk on operands that levels.gather_s unranked and
// gathered first, because BlockSpecs cut dense arrays. On the card that
// prologue cost ms a chunk on the host (a loop of small launches a
// candidate position for the unrank) and its layout is dense over
// (row, rank, slot): it inverted the sets of ranks past a row's
// C(count, ℓ) and visited every slot of every rank to decide the few
// masked in.
//
// Inputs: C and adj (n, n), the block's global row ids, the rows'
// compacted neighbour lists and counts, the binomial table and the
// launch's first rank t0 (a device scalar). Nothing is gathered: each
// block unranks its row's sets itself (unrank.cuh, shared with sgrid.cu)
// and reads every value from C (5.7 MB at n = 1190, resident in the
// 50 MB L2): C[S,S] and C(i,S) from rows of C, and C(j,S) from row j, as
// levels.gather_sets reads it (C is only symmetric to validation's
// tolerance). The arithmetic is the gathered kernels' own device
// functions, so on one card the winners are bitwise those of cholinv +
// cisweep on gather_s's copies of the same values, and those of
// levels._winners over their decisions.
//
// The sweep is sweep.cuh's core, the one sgrid.cu launches, with its
// Fused reader on C itself (C(j,S) from row j: strides 1 over S and n
// over j, no transposed copy) and cholinv's and cisweep's arithmetic as
// its policy: one 128-thread block per row; a tile of 128 ranks is
// staged one rank a thread (unrank, C[S,S] and C(i,S) from L2,
// cholinv_set); groups of lanes take the row's slots and keep the least
// separating rank with no atomics. Work follows the valid tests only: a
// row whose count is below ℓ + 1 (every slot's j lies in the one set) or
// that has no alive edge stages nothing; ranks past C(count, ℓ) are never
// staged; a padded slot or a dead edge never opens, and j ∈ S is found
// from the set ids in shared memory before any load; a slot leaves at
// its first separator and the block at the tile where every slot has
// left.
#include <cuda_runtime.h>
#include <stdint.h>

#include "cholinv.cuh"
#include "cisweep.cuh"
#include "sweep.cuh"

namespace {

// cholinv's and cisweep's arithmetic, as sweep.cuh's policy A
template <int L>
struct CholinvMath {
  __device__ static void stage(float m[L][L], const float c[L], float jitter, float inv_l,
                               float g[L][L], float u[L], float& v) {
    cholinv_set<L>(m, c, jitter, inv_l, g, u, v);
  }
  __device__ static bool test(const float w[L], float num, const float* g, const float* u,
                              float var_i, float tau, float, float) {
    return cisweep_cell<L>(w, num, g, u, var_i, tau);
  }
};

}  // namespace

extern "C" int repro_skernel_fused(const float* c, const uint8_t* adj, const int* rows,
                                   const int* compact, const int* counts,
                                   const long long* table, int table_width, const void* t0,
                                   int t0_wide, int* t_loc, int* s_win, int n, int n_l,
                                   int t_len, int npr, int n_max, int ell, float tau,
                                   float jitter, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_SKERNEL_CASE(L)                                                             \
  case L:                                                                                 \
    return launch_sweep<L, CholinvMath<L>>(                                               \
        Fused<L>{c, c, 1, n, adj, rows, compact, counts, table, t0, table_width, t0_wide, \
                 n, t_len, npr, n_max},                                                   \
        t_loc, s_win, n_l, npr, tau, jitter, 0.f, 0.f, st);
  REPRO_SWEEP_SWITCH(ell, REPRO_SKERNEL_CASE)
#undef REPRO_SKERNEL_CASE
}
