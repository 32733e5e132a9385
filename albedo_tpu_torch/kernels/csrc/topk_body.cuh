// The body of K5-K7: score one query row per CTA against an item table and
// keep a streaming top-k (topk_merge.cuh), at any rank. K5 (topk_scores.cu),
// K6 (gather_topk.cu) and K7 (bank_query.cu) differ only in the prologue
// that finds CTA b's query row and exclusion row (QuerySpec below); the
// scoring, the exclusion test and the merge are this one code.
//
// Scores are accumulated as separately rounded multiplies and adds in index
// order, the arithmetic of the plain PyTorch versions (ops/topk.py), so
// kernel and plain version agree bit for bit, ties included, and a query
// row's answer does not depend on the other rows of its launch. The order
// is score descending, then item index ascending, with (-inf, -1) past the
// admissible items: the JAX scan's order.
//
// Two paths, chosen by the rank:
//   - r <= RMAX (ALS, the ranker, ranking_mf): the query row sits in shared
//     memory and each thread walks whole item rows from global memory.
//   - r > RMAX (tf-idf rows, r ~ 3000; Word2Vec document vectors, r = 200):
//     the query and a tile of WTILE item rows are streamed through shared
//     memory CHUNK columns at a time, each warp loading 128 contiguous bytes
//     of one item row (all of a thread's loads of a chunk in flight at
//     once), and each thread keeps its item's running sum in a register
//     across chunks. Any r fits: only CHUNK columns are staged.
// Each is instantiated for a running list of KMAX_SMALL (128) and of KMAX
// (512) entries, picked by k at launch.

#pragma once

#include <cuda_runtime.h>

#include "topk_merge.cuh"

namespace topk {

constexpr int TILE = 1024;   // items per tile, narrow path
constexpr int RMAX = 64;     // widest rank of the narrow path
constexpr int WTILE = 256;   // items per tile, wide path (one per thread)
constexpr int CHUNK = 32;    // rank columns staged per step, wide path
constexpr int VSTRIDE = CHUNK + 1;  // padded row: no bank conflicts
constexpr int LOADS = WTILE * CHUNK / THREADS;  // chunk floats per thread

// Where CTA b finds its query row and its exclusion row.
struct QuerySpec {
  const float* users;   // rows the queries are taken from (unused with mean_rows)
  const int* user_idx;  // CTA b queries row user_idx[b] of users; null: row b
  const int* excl;      // exclusion rows, E wide, -1-padded; null when E == 0
  int excl_by_user;     // 1: CTA b excludes row user_idx[b] of excl; 0: row b
  const int* excl_map;  // exclusion entries are remapped through it; null: not
  int mean_rows;        // 1: the query is the L2-normalized mean of the item
                        // rows listed in excl row b (K7's item_mean sources)
  int E, Epad;          // exclusion width, and it rounded up to a power of 2
  int dpad;             // mean_rows: r rounded up to a power of two
};

// Loads CTA b's exclusion row into s_excl (sorted) and returns its query
// row: a row of q.users (global memory), or, with mean_rows, the mean query
// computed into s_mean (shared memory, 2 * dpad floats). Returns null for a
// mean query with no valid item (the row then gets no items). Ends
// synchronized, with every thread holding the same result.
__device__ const float* query_row(const QuerySpec& q, const float* __restrict__ items, int r,
                                  long long b, int* s_excl, float* s_mean) {
  const int tid = threadIdx.x;
  const long long urow = q.user_idx != nullptr ? (long long)q.user_idx[b] : b;
  const int* ex = q.excl == nullptr ? nullptr : q.excl + (q.excl_by_user ? urow : b) * q.E;
  load_sorted(ex, q.E, q.Epad, s_excl, q.excl_map);
  if (!q.mean_rows) return q.users + urow * r;

  // The masked mean of the listed rows, summed in list order, divided by
  // their count, then by max(||mean||_2, 1e-9); the squares are summed by a
  // fixed pairwise tree over dpad (zero-padded) slots. The plain version
  // repeats these steps in this order.
  int count = 0;
  for (int j = 0; j < q.E; ++j) count += ex[j] >= 0;
  if (count == 0) return nullptr;
  float* s_red = s_mean + q.dpad;
  const float denom = (float)count;
  for (int c = tid; c < q.dpad; c += THREADS) {
    float acc = 0.f;
    if (c < r) {
      for (int j = 0; j < q.E; ++j) {
        const int it = ex[j];
        if (it >= 0) acc = __fadd_rn(acc, items[(long long)it * r + c]);
      }
      acc = __fdiv_rn(acc, denom);
    }
    s_mean[c] = acc;
    s_red[c] = __fmul_rn(acc, acc);
  }
  __syncthreads();
  for (int half = q.dpad >> 1; half > 0; half >>= 1) {
    for (int c = tid; c < half; c += THREADS) s_red[c] = __fadd_rn(s_red[c], s_red[c + half]);
    __syncthreads();
  }
  const float norm = fmaxf(__fsqrt_rn(s_red[0]), 1e-9f);
  for (int c = tid; c < r; c += THREADS) s_mean[c] = __fdiv_rn(s_mean[c], norm);
  __syncthreads();
  return s_mean;
}

// Dynamic shared memory: Epad ints of exclusion list, then (mean_rows)
// 2 * dpad floats of mean query and reduction scratch.
template <int KM>
__global__ void __launch_bounds__(THREADS) narrow_kernel(
    QuerySpec q, const float* __restrict__ items, float* __restrict__ out_s,
    int* __restrict__ out_i, int n_items, int r, int k) {
  extern __shared__ int smem[];
  int* s_excl = smem;
  float* s_mean = reinterpret_cast<float*>(smem + q.Epad);
  __shared__ float s_u[RMAX];
  __shared__ Running<TILE, KM> st;

  const int tid = threadIdx.x;
  const long long row = blockIdx.x;

  st.init();
  const float* u = query_row(q, items, r, row, s_excl, s_mean);
  if (u != nullptr) {
    for (int c = tid; c < r; c += THREADS) s_u[c] = u[c];
    for (int tile0 = 0; tile0 < n_items; tile0 += TILE) {
      const Threshold th = st.begin_tile(k);  // its barrier publishes s_u
      for (int t = tid; t < TILE; t += THREADS) {
        const int item = tile0 + t;
        if (item >= n_items) break;
        const float* v = items + (long long)item * r;
        float s = 0.f;
        for (int c = 0; c < r; ++c) s = __fadd_rn(s, __fmul_rn(s_u[c], v[c]));
        if (q.Epad > 0 && contains(s_excl, q.Epad, item)) continue;
        st.offer(th, s, item, k);
      }
      st.end_tile(k);
    }
  }
  st.write(out_s + row * k, out_i + row * k, k);
}

// Dynamic shared memory: Epad ints of exclusion list, WTILE x VSTRIDE floats
// of item tile, CHUNK floats of query chunk, then (mean_rows) 2 * dpad
// floats of mean query and reduction scratch.
template <int KM>
__global__ void __launch_bounds__(THREADS) wide_kernel(
    QuerySpec q, const float* __restrict__ items, float* __restrict__ out_s,
    int* __restrict__ out_i, int n_items, int r, int k) {
  extern __shared__ int smem[];
  int* s_excl = smem;
  float* s_v = reinterpret_cast<float*>(smem + q.Epad);
  float* s_u = s_v + WTILE * VSTRIDE;
  float* s_mean = s_u + CHUNK;
  __shared__ Running<WTILE, KM> st;

  const int tid = threadIdx.x;
  const long long row = blockIdx.x;

  st.init();
  const float* u = query_row(q, items, r, row, s_excl, s_mean);
  if (u != nullptr) {
    for (int tile0 = 0; tile0 < n_items; tile0 += WTILE) {
      const int n_tile = min(WTILE, n_items - tile0);
      float s = 0.f;
      for (int c0 = 0; c0 < r; c0 += CHUNK) {
        const int w = min(CHUNK, r - c0);
        // All of this thread's loads of the chunk are issued before any is
        // stored, so their latencies overlap (a CTA is often alone on its SM).
        float staged[LOADS];
#pragma unroll
        for (int j = 0; j < LOADS; ++j) {
          const int e = tid + j * THREADS;
          const int t = e / CHUNK;
          const int c = e % CHUNK;
          staged[j] = (t < n_tile && c < w) ? items[(long long)(tile0 + t) * r + c0 + c] : 0.f;
        }
        const float uc = tid < w ? u[c0 + tid] : 0.f;
        __syncthreads();  // the previous chunk's reads are done
        if (tid < w) s_u[tid] = uc;
#pragma unroll
        for (int j = 0; j < LOADS; ++j) {
          const int e = tid + j * THREADS;
          s_v[(e / CHUNK) * VSTRIDE + e % CHUNK] = staged[j];
        }
        __syncthreads();
        if (tid < n_tile) {
          const float* v = s_v + tid * VSTRIDE;
          for (int c = 0; c < w; ++c) s = __fadd_rn(s, __fmul_rn(s_u[c], v[c]));
        }
      }
      const Threshold th = st.begin_tile(k);
      const int item = tile0 + tid;
      if (tid < n_tile && !(q.Epad > 0 && contains(s_excl, q.Epad, item))) st.offer(th, s, item, k);
      st.end_tile(k);
    }
  }
  st.write(out_s + row * k, out_i + row * k, k);
}

// Launch B CTAs (one per query row) on ``stream``: 1 <= k <= KMAX, r >= 1.
// Returns cudaGetLastError() after the launch (0 = launched).
inline int launch(const QuerySpec& q, int B, const float* items, float* out_s, int* out_i,
                  int n_items, int r, int k, cudaStream_t stream) {
  if (k < 1 || k > KMAX || r < 1) return (int)cudaErrorInvalidValue;
  const bool wide = r > RMAX;
  const bool small_list = k <= KMAX_SMALL;
  const size_t smem = (size_t)q.Epad * sizeof(int) +
                      (wide ? (size_t)(WTILE * VSTRIDE + CHUNK) * sizeof(float) : 0) +
                      (q.mean_rows ? (size_t)2 * q.dpad * sizeof(float) : 0);
  const void* kernel =
      wide ? (small_list ? (const void*)wide_kernel<KMAX_SMALL> : (const void*)wide_kernel<KMAX>)
           : (small_list ? (const void*)narrow_kernel<KMAX_SMALL> : (const void*)narrow_kernel<KMAX>);
  if (smem + STATIC_SMEM_MAX > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (B > 0) {
    if (wide && small_list)
      wide_kernel<KMAX_SMALL><<<B, THREADS, smem, stream>>>(q, items, out_s, out_i, n_items, r, k);
    else if (wide)
      wide_kernel<KMAX><<<B, THREADS, smem, stream>>>(q, items, out_s, out_i, n_items, r, k);
    else if (small_list)
      narrow_kernel<KMAX_SMALL><<<B, THREADS, smem, stream>>>(q, items, out_s, out_i, n_items, r, k);
    else
      narrow_kernel<KMAX><<<B, THREADS, smem, stream>>>(q, items, out_s, out_i, n_items, r, k);
  }
  return (int)cudaGetLastError();
}

}  // namespace topk
