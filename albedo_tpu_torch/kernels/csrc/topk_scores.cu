// K5 topk_scores: blocked user x item scoring with a streaming top-k, one
// query row per CTA, at any rank and 1 <= k <= 512.
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
// The body (both rank paths) is topk_body.cuh, shared with K6 and K7; the
// running top-k and the exclusion list are topk_merge.cuh.
//
// What bounds it on an H100: 2 U I r FLOP over (U + I) r floats. The U x I
// score matrix is never written; the work is FP32 dot products on CUDA
// cores, and the item table is re-read from L2 by every row's CTA, so at
// this first version L2 traffic (U I r 4 bytes) bounds it rather than
// device memory. At k > 128 the first tile merges up to 512 + TILE
// candidates by an O(M^2) rank count, which grows with k.

#include <cuda_runtime.h>

#include "topk_body.cuh"

// users (U, r); items (I, r) f32; excl (U, E) i32 or null when E == 0;
// out_s (U, k) f32, out_i (U, k) i32; 1 <= k <= 512, any r >= 1. Epad is E
// rounded up to a power of two (0 when E == 0); the wrapper bounds it by the
// shared memory the card has. Returns cudaGetLastError() after the launch
// (0 = launched).
extern "C" int topk_scores_launch(const float* users, const float* items,
                                  const int* excl, float* out_s, int* out_i,
                                  int U, int n_items, int r, int k, int E,
                                  int Epad, void* stream) {
  topk::QuerySpec q{users, nullptr, excl, 0, nullptr, 0, E, Epad, 0};
  return topk::launch(q, U, items, out_s, out_i, n_items, r, k, (cudaStream_t)stream);
}
