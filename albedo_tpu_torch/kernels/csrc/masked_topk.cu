// K11 masked_topk: per-column normalization, masking of a row's starred
// items and the top-k of a dense score block, one query row per CTA.
//
// Replaces: the tail of albedo_tpu/recommenders/cf.py ItemCFRecommender
// score (:216-218) and UserCFRecommender score (:248-249):
//     scores = p / max(col_norm, 1e-12)      (item-CF; user-CF has no norm)
//     scores = where(starred, -inf, scores)
//     lax.top_k(scores, k)
// For each row b of the (B, n) block (read through strides, so the
// transposed output of spmm_rows is taken without a copy), it returns the k
// best (score, column) ordered by score descending, then column ascending
// (lax.top_k's order), with (-inf, -1) past the admissible columns: JAX
// returns -inf scores there and its callers drop every non-finite slot, so
// the candidates are the same. The division is IEEE (nvcc's default
// -prec-div=true), as in the plain version, so the two agree bit for bit.
//
// What bounds it on an H100: bytes. One read of the (B, n) block and of the
// norm, k slots written per row; a compare or two per element. The starred
// list is sorted in shared memory (topk_merge.cuh) and the running top-k
// keeps only the items that beat its k-th entry, so only (B, k) is written.

#include <cuda_runtime.h>

#include "topk_merge.cuh"

namespace {

using topk::THREADS;
constexpr int TILE = 1024;

__global__ void __launch_bounds__(THREADS) masked_topk_kernel(
    const float* __restrict__ scores, long long sb, long long si,
    const int* __restrict__ starred, const float* __restrict__ norm,
    float* __restrict__ out_s, int* __restrict__ out_i, int n, int k, int L,
    int Lpad) {
  extern __shared__ int s_star[];
  __shared__ topk::Running<TILE, topk::KMAX_SMALL> st;

  const long long row = blockIdx.x;
  const float* p = scores + row * sb;

  st.init();
  topk::load_sorted(starred == nullptr ? nullptr : starred + row * L, L, Lpad, s_star);

  for (int tile0 = 0; tile0 < n; tile0 += TILE) {
    const topk::Threshold th = st.begin_tile(k);
    for (int t = threadIdx.x; t < TILE; t += THREADS) {
      const int i = tile0 + t;
      if (i >= n) break;
      float s = p[i * si];
      if (norm != nullptr) s = s / fmaxf(norm[i], 1e-12f);
      if (Lpad > 0 && topk::contains(s_star, Lpad, i)) continue;
      st.offer(th, s, i, k);
    }
    st.end_tile(k);
  }
  st.write(out_s + row * k, out_i + row * k, k);
}

}  // namespace

// scores: element (b, i) at scores[b * sb + i * si], f32, B x n; starred
// (B, L) i32 or null when L == 0; norm (n,) f32 or null; out_s (B, k) f32,
// out_i (B, k) i32; 1 <= k <= 128. Lpad is L rounded up to a power of two
// (0 when L == 0). Returns cudaGetLastError() after the launch (0 =
// launched).
extern "C" int masked_topk_launch(const float* scores, long long sb, long long si,
                                  const int* starred, const float* norm, float* out_s,
                                  int* out_i, int B, int n, int k, int L, int Lpad,
                                  void* stream) {
  if (k < 1 || k > topk::KMAX_SMALL) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)Lpad * sizeof(int);
  if (smem + topk::STATIC_SMEM_MAX > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        masked_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (B > 0)
    masked_topk_kernel<<<B, THREADS, smem, (cudaStream_t)stream>>>(
        scores, sb, si, starred, norm, out_s, out_i, n, k, L, Lpad);
  return (int)cudaGetLastError();
}
