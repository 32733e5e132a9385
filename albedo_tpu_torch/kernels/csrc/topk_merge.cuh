// The streaming top-k that K5-K7 (topk_body.cuh) and K11's masked_topk
// (masked_topk.cu) keep for one query row per CTA.
//
// The order is that of the JAX programs: score descending, then item index
// ascending (lax.top_k keeps the lower position on ties), and the slots past
// the admissible items are (-inf, -1). NaN follows lax.top_k's total order:
// a NaN with the sign bit clear ranks above +inf (NaNs among themselves by
// index), one with it set below -inf; -inf and such a -NaN are never
// admitted; -0.0 and +0.0 tie. The order compares K5's 32-bit order key
// (topk_scores.cu score_key), then the index. The running list lives in
// shared memory: each tile of items appends only the items that beat the
// current k-th entry, and a merge places each survivor at its rank in the
// total order.
//
// A row's excluded items arrive as a -1-padded, unsorted list that may hold
// duplicates; it is copied into shared memory and sorted (bitonic), so a
// membership test is a binary search and no U x I mask exists.
//
// The list holds at most KM entries, a template argument: KMAX_SMALL (128)
// for the k <= 128 launches, so they keep their shared-memory footprint,
// and KMAX (512) for the serving path's k, which rounds the service's
// max_k = 500 up to a power of two.

#pragma once

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace topk {

constexpr int THREADS = 256;
constexpr int KMAX_SMALL = 128;
constexpr int KMAX = 512;
// The largest static shared memory of a kernel holding a running list
// (topk_body.cuh narrow_kernel<KMAX>: 22.8 KB). A launch whose dynamic
// shared memory and this exceed the 48 KB a block gets by default opts in
// to more (cudaFuncAttributeMaxDynamicSharedMemorySize) first.
constexpr size_t STATIC_SMEM_MAX = 24 * 1024;

// Order key of a score: larger = better; 0 = not admissible (-inf, -NaN).
// +NaN is the largest; -0.0 and +0.0 tie.
__device__ __forceinline__ unsigned int order_key(float s) {
  if (s != s) return (__float_as_uint(s) & 0x80000000u) ? 0u : 0xFFFFFFFFu;
  if (!(s > -INFINITY)) return 0u;
  const unsigned int u = __float_as_uint(__fadd_rn(s, 0.0f));  // -0.0 -> +0.0: they tie
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// (key a, item a) comes before (key b, item b).
__device__ __forceinline__ bool beats(unsigned int ka, int ia, unsigned int kb, int ib) {
  return ka > kb || (ka == kb && ia < ib);
}

// Copy ``list[0..E)`` into ``s_list[0..Epad)`` (negative entries and the
// padding past E become INT_MAX) and sort it ascending. Epad is a power of
// two, or 0 for no list; ``list`` may be null when E == 0. With ``map``,
// each non-negative entry x is replaced by map[x] first (a negative map[x]
// drops it). Ends synchronized.
__device__ void load_sorted(const int* __restrict__ list, int E, int Epad, int* s_list,
                            const int* __restrict__ map = nullptr) {
  const int tid = threadIdx.x;
  for (int e = tid; e < Epad; e += THREADS) {
    int v = INT_MAX;
    if (e < E) {
      int x = list[e];
      if (x >= 0 && map != nullptr) x = map[x];
      if (x >= 0) v = x;
    }
    s_list[e] = v;
  }
  __syncthreads();
  for (int size = 2; size <= Epad; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = tid; t < Epad; t += THREADS) {
        const int partner = t ^ stride;
        if (partner > t) {
          const bool up = (t & size) == 0;
          const int a = s_list[t];
          const int b = s_list[partner];
          if ((a > b) == up) {
            s_list[t] = b;
            s_list[partner] = a;
          }
        }
      }
      __syncthreads();
    }
  }
}

// True when ``item`` is in the sorted ``s_list[0..Epad)``.
__device__ __forceinline__ bool contains(const int* s_list, int Epad, int item) {
  int lo = 0, hi = Epad;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s_list[mid] < item) lo = mid + 1; else hi = mid;
  }
  return lo < Epad && s_list[lo] == item;
}

// What a thread needs to test a candidate against the current k-th entry.
struct Threshold {
  int nr;
  unsigned int key;
  int i;
};

// One row's running top-k (k <= KM), in shared memory; TILE bounds the
// candidates a tile can add.
template <int TILE, int KM>
struct Running {
  float top_s[KM];
  int top_i[KM];
  float new_s[KM];
  int new_i[KM];
  float cand_s[TILE];
  int cand_i[TILE];
  unsigned int keys[KM + TILE];  // order keys of the list and the candidates, for the merge
  int n_cand;
  int n_real;

  // Empty list. The caller synchronizes before the first tile.
  __device__ void init() {
    if (threadIdx.x == 0) n_real = 0;
  }

  // Open a tile: no candidates yet, and the k-th entry so far.
  __device__ Threshold begin_tile(int k) {
    if (threadIdx.x == 0) n_cand = 0;
    __syncthreads();
    const int nr = n_real;
    return {nr, nr == k ? order_key(top_s[k - 1]) : 0u, nr == k ? top_i[k - 1] : -1};
  }

  // Add (s, item) to the tile's candidates if it is admissible and beats the
  // k-th entry.
  __device__ __forceinline__ void offer(const Threshold& th, float s, int item, int k) {
    const unsigned int key = order_key(s);
    if (key == 0u) return;  // -inf and -NaN are never admitted
    if (th.nr == k && !beats(key, item, th.key, th.i)) return;
    const int slot = atomicAdd(&n_cand, 1);
    cand_s[slot] = s;
    cand_i[slot] = item;
  }

  // Close a tile: merge its candidates into the running list.
  __device__ void end_tile(int k) {
    const int tid = threadIdx.x;
    __syncthreads();
    const int nc = n_cand;
    if (nc == 0) return;
    const int nr = n_real;
    const int M = nr + nc;
    for (int e = tid; e < M; e += THREADS) keys[e] = order_key(e < nr ? top_s[e] : cand_s[e - nr]);
    __syncthreads();
    for (int e = tid; e < M; e += THREADS) {
      const float se = e < nr ? top_s[e] : cand_s[e - nr];
      const int ie = e < nr ? top_i[e] : cand_i[e - nr];
      const unsigned int ke = keys[e];
      int rank = 0;
      for (int f = 0; f < M; ++f) {
        const int jf = f < nr ? top_i[f] : cand_i[f - nr];
        rank += beats(keys[f], jf, ke, ie);
      }
      if (rank < k) {
        new_s[rank] = se;
        new_i[rank] = ie;
      }
    }
    __syncthreads();
    const int nn = min(k, M);
    for (int e = tid; e < nn; e += THREADS) {
      top_s[e] = new_s[e];
      top_i[e] = new_i[e];
    }
    if (tid == 0) n_real = nn;
    __syncthreads();
  }

  // The k slots of the row, (-inf, -1) past the admissible items.
  __device__ void write(float* out_s, int* out_i, int k) const {
    for (int e = threadIdx.x; e < k; e += THREADS) {
      const bool real = e < n_real;
      out_s[e] = real ? top_s[e] : -INFINITY;
      out_i[e] = real ? top_i[e] : -1;
    }
  }
};

}  // namespace topk
