// K5 topk_scores: blocked user x item scoring with a streaming top-k, one
// query row per CTA.
//
// Replaces: albedo_tpu/ops/topk.py topk_scores (:28). For each query row u:
// score every item i as u . v_i, drop the row's excluded items (a -1-padded,
// unsorted list that may hold duplicates), and return the k best as
// (score, item) ordered by score descending, then item index ascending,
// with the slots past the admissible items filled with (-inf, -1). That is
// exactly the order the JAX scan produces: lax.top_k keeps the lower
// position on ties and the running list precedes each block in the merge.
//
// What bounds it on an H100: 2 U I r FLOP over (U + I) r floats. The U x I
// score matrix is never written; the work is FP32 dot products on CUDA
// cores, and the item table (4 MB at the bench scale) is re-read from L2 by
// every row's CTA, so at this first version L2 traffic (U I r 4 bytes)
// bounds it rather than device memory. Scores are accumulated as separately
// rounded multiplies and adds in index order, the same arithmetic as the
// plain PyTorch version, so the two agree bit for bit, ties included.
// The exclusion list is copied into shared memory and sorted (bitonic), so
// membership is a binary search and no U x I mask exists. The running top-k
// lives in shared memory: each tile of TILE items appends only the items
// that beat the current k-th entry, and a merge places each survivor at its
// rank in the total order (score desc, index asc).

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 1024;
constexpr int KMAX = 128;
constexpr int RMAX = 64;

__device__ __forceinline__ bool beats(float sa, int ia, float sb, int ib) {
  return sa > sb || (sa == sb && ia < ib);
}

__global__ void __launch_bounds__(THREADS) topk_scores_kernel(
    const float* __restrict__ users, const float* __restrict__ items,
    const int* __restrict__ excl, float* __restrict__ out_s,
    int* __restrict__ out_i, int n_items, int r, int k, int E, int Epad) {
  extern __shared__ int s_excl[];
  __shared__ float s_u[RMAX];
  __shared__ float top_s[KMAX];
  __shared__ int top_i[KMAX];
  __shared__ float new_s[KMAX];
  __shared__ int new_i[KMAX];
  __shared__ float cand_s[TILE];
  __shared__ int cand_i[TILE];
  __shared__ int n_cand;
  __shared__ int n_real;

  const int tid = threadIdx.x;
  const long long row = blockIdx.x;

  for (int c = tid; c < r; c += THREADS) s_u[c] = users[row * r + c];
  for (int e = tid; e < Epad; e += THREADS) {
    int v = INT_MAX;
    if (e < E) {
      const int x = excl[row * E + e];
      if (x >= 0) v = x;
    }
    s_excl[e] = v;
  }
  if (tid == 0) n_real = 0;
  __syncthreads();
  // Bitonic sort of the exclusion list (Epad is a power of two).
  for (int size = 2; size <= Epad; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = tid; t < Epad; t += THREADS) {
        const int partner = t ^ stride;
        if (partner > t) {
          const bool up = (t & size) == 0;
          const int a = s_excl[t];
          const int b = s_excl[partner];
          if ((a > b) == up) {
            s_excl[t] = b;
            s_excl[partner] = a;
          }
        }
      }
      __syncthreads();
    }
  }

  for (int tile0 = 0; tile0 < n_items; tile0 += TILE) {
    if (tid == 0) n_cand = 0;
    __syncthreads();
    const int nr = n_real;
    const float th_s = nr == k ? top_s[k - 1] : -INFINITY;
    const int th_i = nr == k ? top_i[k - 1] : -1;
    for (int t = tid; t < TILE; t += THREADS) {
      const int item = tile0 + t;
      if (item >= n_items) break;
      const float* v = items + (long long)item * r;
      float s = 0.f;
      for (int c = 0; c < r; ++c) s = __fadd_rn(s, __fmul_rn(s_u[c], v[c]));
      if (Epad > 0) {
        int lo = 0, hi = Epad;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (s_excl[mid] < item) lo = mid + 1; else hi = mid;
        }
        if (lo < Epad && s_excl[lo] == item) continue;
      }
      if (!(s > -INFINITY)) continue;  // -inf and NaN are never admitted
      if (nr == k && !beats(s, item, th_s, th_i)) continue;
      const int slot = atomicAdd(&n_cand, 1);
      cand_s[slot] = s;
      cand_i[slot] = item;
    }
    __syncthreads();
    const int nc = n_cand;
    if (nc > 0) {
      const int M = nr + nc;
      for (int e = tid; e < M; e += THREADS) {
        const float se = e < nr ? top_s[e] : cand_s[e - nr];
        const int ie = e < nr ? top_i[e] : cand_i[e - nr];
        int rank = 0;
        for (int f = 0; f < M; ++f) {
          const float sf = f < nr ? top_s[f] : cand_s[f - nr];
          const int jf = f < nr ? top_i[f] : cand_i[f - nr];
          rank += beats(sf, jf, se, ie);
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
  }

  for (int e = tid; e < k; e += THREADS) {
    const bool real = e < n_real;
    out_s[row * k + e] = real ? top_s[e] : -INFINITY;
    out_i[row * k + e] = real ? top_i[e] : -1;
  }
}

}  // namespace

// users (U, r); items (I, r) f32; excl (U, E) i32 or null when E == 0;
// out_s (U, k) f32, out_i (U, k) i32. Epad is E rounded up to a power of two
// (0 when E == 0); the wrapper bounds it by the shared memory the card has.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int topk_scores_launch(const float* users, const float* items,
                                  const int* excl, float* out_s, int* out_i,
                                  int U, int n_items, int r, int k, int E,
                                  int Epad, void* stream) {
  const size_t smem = (size_t)Epad * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        topk_scores_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (U > 0)
    topk_scores_kernel<<<U, THREADS, smem, (cudaStream_t)stream>>>(
        users, items, excl, out_s, out_i, n_items, r, k, E, Epad);
  return (int)cudaGetLastError();
}
