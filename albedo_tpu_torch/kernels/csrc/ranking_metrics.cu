// K13 ranking_metrics: MLlib's NDCG@k, precision@k and mean average
// precision of each query row, from its -1-padded predicted and actual item
// lists (both already cut to k).
//
// Replaces: albedo_tpu/evaluators/ranking.py _ranking_metrics (:117), a
// jitted program that compares every predicted slot with every actual slot
// ((Q, kp, ka) booleans), then sums gains, hits and precisions per row.
//
// One warp a row. The lanes take 32 predicted slots at a time; the row's
// actual items pass through the warp by shuffles, 32 at a time, so each
// lane tests its slot against every actual item with no (Q, kp, ka) array.
// A ballot of the hits gives each lane its running hit count (MAP's
// precision at a hit) by a popcount of the lanes below it. The row's sums
// (DCG, ideal DCG, MAP's) are float32 and reduced by a fixed shuffle tree:
// the same lists give the same bits on every run. The float32 rules are the
// plain version's: gains 1 / log(i + 2), each precision at a hit cum / (i +
// 1), hits over k, sums over max(ideal DCG, 1e-12) and max(|actual|, 1); only
// the order of the float32 sums differs.
//
// What bounds it on an H100: bytes, one read of the two lists (4 bytes a
// slot) and three floats written a row.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int WARPS = 8;  // rows a block
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float gain(int i) { return 1.0f / logf((float)i + 2.0f); }

template <typename T>
__device__ __forceinline__ T warp_sum(T x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(FULL, x, off);
  return x;
}

__global__ void __launch_bounds__(WARPS * 32)
    ranking_metrics_kernel(const int* __restrict__ pred, const int* __restrict__ actual, int Q, int kp, int ka,
                           int k, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (q >= Q) return;  // the whole warp: q is the warp's
  const int* p = pred + (long long)q * kp;
  const int* a = actual + (long long)q * ka;

  int pred_len = 0, lab_size = 0;
  for (int j = lane; j < kp; j += 32) pred_len += p[j] >= 0;
  for (int j = lane; j < ka; j += 32) lab_size += a[j] >= 0;
  pred_len = warp_sum(pred_len);
  lab_size = warp_sum(lab_size);

  float dcg = 0.0f, prec_at_hit = 0.0f;
  int hits_k = 0, before = 0;  // before: hits in the slots of earlier rounds
  for (int base = 0; base < kp; base += 32) {
    const int i = base + lane;
    const int v = i < kp ? p[i] : -1;
    bool hit = false;
    for (int abase = 0; abase < ka; abase += 32) {
      const int w = abase + lane < ka ? a[abase + lane] : -1;
      const int n = min(32, ka - abase);
      for (int s = 0; s < n; ++s) hit |= __shfl_sync(FULL, w, s) == v;
    }
    hit = hit && v >= 0;  // a padded slot never hits
    const unsigned ball = __ballot_sync(FULL, hit);
    if (hit) {
      const int cum = before + __popc(ball & (FULL >> (31 - lane)));  // hits in slots 0..i
      dcg += gain(i);
      hits_k += i < k;
      prec_at_hit += (float)cum / ((float)i + 1.0f);
    }
    before += __popc(ball);
  }
  // Ideal DCG: the first min(|actual|, n) gains, n = min(max(|pred|, |actual|), k).
  const int ideal = min(lab_size, min(max(pred_len, lab_size), k));
  float max_dcg = 0.0f;
  for (int i = lane; i < ideal; i += 32) max_dcg += gain(i);

  dcg = warp_sum(dcg);
  max_dcg = warp_sum(max_dcg);
  prec_at_hit = warp_sum(prec_at_hit);
  hits_k = warp_sum(hits_k);
  if (lane == 0) {
    out[q] = lab_size > 0 ? dcg / fmaxf(max_dcg, 1e-12f) : 0.0f;
    out[(long long)Q + q] = (float)hits_k / (float)k;
    out[2LL * Q + q] = lab_size > 0 ? prec_at_hit / (float)max(lab_size, 1) : 0.0f;
  }
}

}  // namespace

// pred (Q, kp), actual (Q, ka) int32, -1 padded, row-major; k >= 1 the
// metric's cut; out (3, Q) float32: NDCG, precision, MAP of each row.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int ranking_metrics_launch(const int* pred, const int* actual, int Q, int kp, int ka, int k, float* out,
                                      void* stream) {
  if (Q < 1 || kp < 0 || ka < 0 || k < 1) return (int)cudaErrorInvalidValue;
  const int blocks = (Q + WARPS - 1) / WARPS;
  ranking_metrics_kernel<<<blocks, WARPS * 32, 0, (cudaStream_t)stream>>>(pred, actual, Q, kp, ka, k, out);
  return (int)cudaGetLastError();
}
