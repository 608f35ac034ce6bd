// A launch's conditioning sets, unranked on the card: the fused sgrid
// (sgrid.cu) and the fused S-kernel (skernel.cu) read a row's compacted
// neighbour list, its count, the binomial table (levels._jtable, int64,
// (n_max + 1, width)) and the launch's first rank t0, and each thread
// walks to its own rank's set, so no host unrank runs. Rank t0 + t of a
// row is valid iff it is below C(count, ℓ), so a row's valid ranks are a
// prefix of the launch.
#pragma once

// the launch's first rank, a device scalar of int32 or int64
__device__ __forceinline__ long long launch_first_rank(const void* t0, int wide) {
  return wide ? *static_cast<const long long*>(t0) : *static_cast<const int*>(t0);
}

// ranks of a row of `sets` neighbours (clipped to [0, n_max]) in a launch
// of t_len ranks from `first`: C(sets, ℓ) − first, clipped to [0, t_len]
template <int L>
__device__ __forceinline__ int launch_row_ranks(int sets, long long first, int t_len,
                                                const long long* __restrict__ table,
                                                int width) {
  const long long left = table[static_cast<long long>(sets) * width + L] - first;
  return left <= 0 ? 0 : (left >= t_len ? t_len : static_cast<int>(left));
}

// the set of a valid rank: levels._unrank_dyn's walk (k ascending, take
// k while the rank lies below C(tail, slots left); at ℓ = 1 rank t is
// position t), ids clipped to [0, n − 1] as levels.plan_sets clips them
template <int L>
__device__ __forceinline__ void unrank_set(const int* __restrict__ row, int sets, long long rank,
                                           const long long* __restrict__ table, int width, int n,
                                           int* ids) {
  if constexpr (L == 1) {
    ids[0] = row[rank];
  } else {
    long long rem = rank;
    int taken = 0;
    for (int k = 0; k < sets && taken < L; ++k) {
      const long long cnt = table[static_cast<long long>(sets - k - 1) * width + (L - taken - 1)];
      if (rem < cnt) {
        ids[taken++] = row[k];
      } else {
        rem -= cnt;
      }
    }
  }
#pragma unroll
  for (int a = 0; a < L; ++a) ids[a] = ids[a] < 0 ? 0 : (ids[a] < n ? ids[a] : n - 1);
}
