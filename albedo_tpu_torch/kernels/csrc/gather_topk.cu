// K6 gather_topk: the serving micro-batcher's batch program, K5 with the
// query rows gathered inside the kernel.
//
// Replaces: albedo_tpu/serving/batcher.py _gather_topk (:118) and
// _gather_topk_device_excl (:129): gather the batch's user rows
// uf_all[user_idx] (B <= 64, r = 50) and, in device mode, their -1-padded
// exclusion rows excl_all[user_idx] from the table of every user's history
// (width = the longest history), then the top-k of topk_scores at a power
// of two k <= 512.
//
// CTA b reads user_idx[b] and takes its query row straight from the user
// table, and its exclusion row from the device table at row user_idx[b]
// (or, in host mode, row b of the batch's own (B, E) table); no gathered
// (B, r) or (B, E) tensor is written. The scoring, the exclusion test and
// the merge are K5's (topk_body.cuh), so a user's answer is bit-identical
// to the direct path's (ALSModel.recommend) whatever batch it rides in.
//
// What bounds it on an H100: as K5, the (I, r) item table read by each of
// the B CTAs (from L2 after the first); at B <= 64 only B of the 132 SMs
// work, so at small buckets it is latency-bound, not bandwidth-bound.

#include <cuda_runtime.h>

#include "topk_body.cuh"

// uf_all (N, r), items (I, r) f32; user_idx (B,) i32 rows of uf_all; excl
// i32 or null when E == 0: (N, E) gathered by user_idx when excl_by_user,
// else (B, E); out_s (B, k) f32, out_i (B, k) i32; 1 <= k <= 512. Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int gather_topk_launch(const float* uf_all, const float* items,
                                  const int* user_idx, const int* excl,
                                  int excl_by_user, float* out_s, int* out_i,
                                  int B, int n_items, int r, int k, int E,
                                  int Epad, void* stream) {
  topk::QuerySpec q{uf_all, user_idx, excl, excl_by_user, nullptr, 0, E, Epad, 0};
  return topk::launch(q, B, items, out_s, out_i, n_items, r, k, (cudaStream_t)stream);
}
