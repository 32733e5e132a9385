// K7 bank_query: one source of the retrieval bank's fused query program,
// one launch per (source, batch).
//
// Replaces: albedo_tpu/retrieval/bank.py _make_query_program (:187), inner
// run (:212), per source:
//   - user_rows (ALS, user_sim): the query is row user_idx[b] of the
//     source's user table, and, where the source excludes seen items, the
//     exclusion row is row user_idx[b] of the serving exclusion table,
//     remapped through the source's excl_map (matrix item -> source row,
//     -1 where the source lacks it) when its rows are not the matrix items;
//   - item_mean (content, tfidf; query_similar on any source): the query is
//     the L2-normalized masked mean of the source rows listed in q_idx row
//     b (<= 32 of them), divided by max(count, 1) and then by
//     max(||q||_2, 1e-9), and those rows are the exclusion list; a row with
//     no valid entry gets (-inf, -1) in every slot.
// Then the top-k of topk_scores (topk_body.cuh). The mean query is built
// in shared memory inside the kernel (tf-idf's r ~ 3010 floats is 12 KB),
// its squares summed by a fixed pairwise tree that the plain version
// repeats, so the two agree bit for bit.
//
// What bounds it on an H100: the source table read by each of the B CTAs
// (d = 50 for ALS, 200 for content, ~3010 for tf-idf), as K5.

#include <cuda_runtime.h>

#include "topk_body.cuh"

// items (I, d) f32. user_rows: users (N, d) f32, user_idx (B,) i32, excl
// (M, E) i32 gathered by user_idx or null when E == 0, excl_map (M,) i32 or
// null; mean_rows = 0. item_mean: users, user_idx and excl_map null, excl
// = q_idx (B, E) i32 rows of items (-1 padded), mean_rows = 1, dpad = d
// rounded up to a power of two. out_s (B, k) f32, out_i (B, k) i32;
// 1 <= k <= 512. Returns cudaGetLastError() after the launch (0 =
// launched).
extern "C" int bank_query_launch(const float* users, const float* items,
                                 const int* user_idx, const int* excl,
                                 const int* excl_map, int mean_rows,
                                 float* out_s, int* out_i, int B, int n_items,
                                 int d, int k, int E, int Epad, int dpad,
                                 void* stream) {
  topk::QuerySpec q{users, user_idx, excl, mean_rows ? 0 : 1, excl_map, mean_rows, E, Epad, dpad};
  return topk::launch(q, B, items, out_s, out_i, n_items, d, k, (cudaStream_t)stream);
}
