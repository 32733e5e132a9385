// K5 topk_scores: blocked user x item scoring with a streaming top-k, one
// query row per CTA, at any rank.
//
// Replaces: albedo_tpu/ops/topk.py topk_scores (:28), and the cosine
// scoring + top-k of albedo_tpu/recommenders/tfidf.py similar (:121-122),
// similar_to_repos (:157) and recommenders/content.py more_like_this (:81)
// (K14: the same function over L2-normalized rows). For each query row u:
// score every item i as u . v_i, drop the row's excluded items (a -1-padded,
// unsorted list that may hold duplicates), and return the k best as
// (score, item) ordered by score descending, then item index ascending,
// with the slots past the admissible items filled with (-inf, -1). That is
// exactly the order the JAX scan produces: lax.top_k keeps the lower
// position on ties and the running list precedes each block in the merge.
// The running top-k and the exclusion list are topk_merge.cuh.
//
// What bounds it on an H100: 2 U I r FLOP over (U + I) r floats. The U x I
// score matrix is never written; the work is FP32 dot products on CUDA
// cores, and the item table is re-read from L2 by every row's CTA, so at
// this first version L2 traffic (U I r 4 bytes) bounds it rather than
// device memory. Scores are accumulated as separately rounded multiplies
// and adds in index order, the same arithmetic as the plain PyTorch
// version, so the two agree bit for bit, ties included, at every rank.
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

#include <cuda_runtime.h>

#include "topk_merge.cuh"

namespace {

using topk::THREADS;
constexpr int TILE = 1024;   // items per tile, narrow path
constexpr int RMAX = 64;     // widest rank of the narrow path
constexpr int WTILE = 256;   // items per tile, wide path (one per thread)
constexpr int CHUNK = 32;    // rank columns staged per step, wide path
constexpr int VSTRIDE = CHUNK + 1;  // padded row: no bank conflicts
constexpr int LOADS = WTILE * CHUNK / THREADS;  // chunk floats per thread

__global__ void __launch_bounds__(THREADS) topk_scores_kernel(
    const float* __restrict__ users, const float* __restrict__ items,
    const int* __restrict__ excl, float* __restrict__ out_s,
    int* __restrict__ out_i, int n_items, int r, int k, int E, int Epad) {
  extern __shared__ int s_excl[];
  __shared__ float s_u[RMAX];
  __shared__ topk::Running<TILE> st;

  const int tid = threadIdx.x;
  const long long row = blockIdx.x;

  for (int c = tid; c < r; c += THREADS) s_u[c] = users[row * r + c];
  st.init();
  topk::load_sorted(excl == nullptr ? nullptr : excl + row * E, E, Epad, s_excl);

  for (int tile0 = 0; tile0 < n_items; tile0 += TILE) {
    const topk::Threshold th = st.begin_tile(k);
    for (int t = tid; t < TILE; t += THREADS) {
      const int item = tile0 + t;
      if (item >= n_items) break;
      const float* v = items + (long long)item * r;
      float s = 0.f;
      for (int c = 0; c < r; ++c) s = __fadd_rn(s, __fmul_rn(s_u[c], v[c]));
      if (Epad > 0 && topk::contains(s_excl, Epad, item)) continue;
      st.offer(th, s, item, k);
    }
    st.end_tile(k);
  }
  st.write(out_s + row * k, out_i + row * k, k);
}

__global__ void __launch_bounds__(THREADS) topk_scores_wide_kernel(
    const float* __restrict__ users, const float* __restrict__ items,
    const int* __restrict__ excl, float* __restrict__ out_s,
    int* __restrict__ out_i, int n_items, int r, int k, int E, int Epad) {
  extern __shared__ int smem[];
  int* s_excl = smem;                                       // Epad
  float* s_v = reinterpret_cast<float*>(smem + Epad);       // WTILE x VSTRIDE
  float* s_u = s_v + WTILE * VSTRIDE;                       // CHUNK
  __shared__ topk::Running<WTILE> st;

  const int tid = threadIdx.x;
  const long long row = blockIdx.x;
  const float* u = users + row * r;

  st.init();
  topk::load_sorted(excl == nullptr ? nullptr : excl + row * E, E, Epad, s_excl);

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
    const topk::Threshold th = st.begin_tile(k);
    const int item = tile0 + tid;
    if (tid < n_tile && !(Epad > 0 && topk::contains(s_excl, Epad, item))) st.offer(th, s, item, k);
    st.end_tile(k);
  }
  st.write(out_s + row * k, out_i + row * k, k);
}

}  // namespace

// users (U, r); items (I, r) f32; excl (U, E) i32 or null when E == 0;
// out_s (U, k) f32, out_i (U, k) i32; 1 <= k <= 128, any r >= 1. Epad is E
// rounded up to a power of two (0 when E == 0); the wrapper bounds it by the
// shared memory the card has. Returns cudaGetLastError() after the launch
// (0 = launched).
extern "C" int topk_scores_launch(const float* users, const float* items,
                                  const int* excl, float* out_s, int* out_i,
                                  int U, int n_items, int r, int k, int E,
                                  int Epad, void* stream) {
  if (k < 1 || k > topk::KMAX || r < 1) return (int)cudaErrorInvalidValue;
  const bool wide = r > RMAX;
  const size_t smem = (size_t)Epad * sizeof(int) +
                      (wide ? (size_t)(WTILE * VSTRIDE + CHUNK) * sizeof(float) : 0);
  const void* kernel = wide ? (const void*)topk_scores_wide_kernel : (const void*)topk_scores_kernel;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (U > 0) {
    if (wide)
      topk_scores_wide_kernel<<<U, THREADS, smem, (cudaStream_t)stream>>>(
          users, items, excl, out_s, out_i, n_items, r, k, E, Epad);
    else
      topk_scores_kernel<<<U, THREADS, smem, (cudaStream_t)stream>>>(
          users, items, excl, out_s, out_i, n_items, r, k, E, Epad);
  }
  return (int)cudaGetLastError();
}
