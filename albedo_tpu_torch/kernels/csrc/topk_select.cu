// The select path of K5-K7 (and K14): the top-k of each query row for any k
// and any exclusion width, behind the same wrappers as topk_scores.cu,
// gather_topk.cu and bank_query.cu.
//
// Replaces: albedo_tpu/ops/topk.py topk_scores (:27), which takes any k and
// any exclusion width, and with it the K6 and K7 programs
// (serving/batcher.py:118, :129; retrieval/bank.py:187) above the limits of
// the streaming body (topk_body.cuh): its running list holds at most 512
// entries, and it sorts a row's exclusion list in shared memory, so k > 512,
// an exclusion row longer than 32768 entries, or a launch whose sorted
// exclusion row and tile overflow shared memory come here.
//
// One launch function runs four kernels over a chunk of query rows (the
// wrapper cuts the rows so that the scratch stays under its budget):
//   1. query: CTA b finds its query row through the same prologue as K5-K7
//      (topk::query_row: a row of the user table, through user_idx or not,
//      or K7's L2-normalized item mean, built here in global memory) and
//      writes it to a scratch row, with a flag for "no query" (an item-mean
//      row with no valid entry);
//   2. score: every (row, item) score, accumulated as K5 does (separately
//      rounded multiplies and adds in rank order), so a score is bit for bit
//      the one K5 computes; -inf for a row with no query;
//   3. exclude: each row's exclusion entries (remapped through excl_map where
//      given) overwrite their scores with -inf, so no sorted list is needed;
//   4. select: one CTA per row finds the k-th best admissible score by a
//      radix select over a 32-bit order key (four 8-bit passes over the row),
//      gathers the k survivors (every key above the threshold, and the lowest
//      item indices among the keys equal to it, in index order), sorts them by
//      (score desc, index asc) with a bitonic sort (in shared memory, or in a
//      global-memory buffer for large k), and writes them, then (-inf, -1) in
//      the slots past the admissible items.
// The order and tie rule are topk_merge.cuh's: score descending, then item
// index ascending; -inf and NaN are never admitted; -0.0 and +0.0 tie.
//
// What bounds it on an H100: the (rows, I) score scratch it writes and reads
// back about six times (the score pass, the exclusions, the count, four radix
// passes and the gather), so bytes; the scoring itself is K5's 2 I r FLOP per
// row on CUDA cores. It is the general path, not the fast one: the k <= 512
// launches keep the streaming body and its times.

#include <cuda_runtime.h>

#include "topk_body.cuh"

namespace {

constexpr int QTHREADS = topk::THREADS;  // query_row's block size
constexpr int STHREADS = 256;            // score and exclude kernels
constexpr int KTHREADS = 1024;           // select kernel
constexpr int KWARPS = KTHREADS / 32;

// Order key of a score: larger key = better; 0 = not admissible (-inf, NaN).
__device__ __forceinline__ unsigned int order_key(float s) {
  if (!(s > -INFINITY)) return 0u;
  const unsigned int u = __float_as_uint(s + 0.0f);  // -0.0 -> +0.0: they tie
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__global__ void __launch_bounds__(QTHREADS) query_kernel(topk::QuerySpec q, const float* __restrict__ items,
                                                         int r, float* qbuf, int qstride, int* has) {
  const long long b = blockIdx.x;
  float* row = qbuf + b * qstride;
  const float* u = topk::query_row(q, items, r, b, nullptr, row);
  if (u != nullptr && u != row)
    for (int c = threadIdx.x; c < r; c += QTHREADS) row[c] = u[c];
  if (threadIdx.x == 0) has[b] = u != nullptr;
}

__global__ void __launch_bounds__(STHREADS) score_kernel(const float* __restrict__ qbuf, int qstride,
                                                         const int* __restrict__ has,
                                                         const float* __restrict__ items, int n_items,
                                                         int r, float* __restrict__ scratch) {
  const long long b = blockIdx.y;
  const int item = blockIdx.x * STHREADS + threadIdx.x;
  if (item >= n_items) return;
  float s = -INFINITY;
  if (has[b]) {
    const float* u = qbuf + b * qstride;
    const float* v = items + (long long)item * r;
    s = 0.f;
    for (int c = 0; c < r; ++c) s = __fadd_rn(s, __fmul_rn(u[c], v[c]));
  }
  scratch[b * n_items + item] = s;
}

__global__ void __launch_bounds__(STHREADS) exclude_kernel(topk::QuerySpec q, int n_items,
                                                           float* __restrict__ scratch) {
  const long long b = blockIdx.x;
  const long long urow = q.user_idx != nullptr ? (long long)q.user_idx[b] : b;
  const int* ex = q.excl + (q.excl_by_user ? urow : b) * q.E;
  for (int e = threadIdx.x; e < q.E; e += STHREADS) {
    int x = ex[e];
    if (x >= 0 && q.excl_map != nullptr) x = q.excl_map[x];
    if (x >= 0 && x < n_items) scratch[b * n_items + x] = -INFINITY;
  }
}

// Sum of v over the block (every thread gets it).
__device__ int block_sum(int v, int* s_warp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  if (lane == 0) s_warp[warp] = v;
  __syncthreads();
  int t = 0;
  for (int w = 0; w < KWARPS; ++w) t += s_warp[w];
  return t;
}

// buf: sort_pad slots of (key << 32 | ~index); null to use dynamic shared memory.
__global__ void __launch_bounds__(KTHREADS) select_kernel(const float* __restrict__ scratch, int n_items,
                                                          int k, float* __restrict__ out_s,
                                                          int* __restrict__ out_i,
                                                          unsigned long long* gbuf, int sort_pad) {
  extern __shared__ unsigned long long s_buf[];
  __shared__ unsigned int hist[256];
  __shared__ int s_warp[KWARPS];
  __shared__ int s_off[KWARPS];
  __shared__ unsigned int s_prefix;
  __shared__ int s_remaining, s_gt, s_run;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const long long row = blockIdx.x;
  const float* sc = scratch + row * n_items;
  unsigned long long* buf = gbuf == nullptr ? s_buf : gbuf + row * sort_pad;

  int mine = 0;
  for (int i = tid; i < n_items; i += KTHREADS) mine += order_key(sc[i]) != 0u;
  const int n_adm = block_sum(mine, s_warp);
  const int kk = min(k, n_adm);

  if (kk > 0) {
    // Radix select: the kk-th largest key, 8 bits at a time from the top.
    unsigned int prefix = 0u, pmask = 0u;
    if (tid == 0) s_remaining = kk;
    for (int shift = 24; shift >= 0; shift -= 8) {
      for (int d = tid; d < 256; d += KTHREADS) hist[d] = 0u;
      __syncthreads();
      for (int i = tid; i < n_items; i += KTHREADS) {
        const unsigned int key = order_key(sc[i]);
        if (key != 0u && (key & pmask) == prefix) atomicAdd(&hist[(key >> shift) & 0xFFu], 1u);
      }
      __syncthreads();
      if (tid == 0) {
        int need = s_remaining, d = 255;
        for (; d > 0; --d) {
          if ((int)hist[d] >= need) break;
          need -= (int)hist[d];
        }
        s_remaining = need;
        s_prefix = prefix | ((unsigned int)d << shift);
      }
      __syncthreads();
      prefix = s_prefix;
      pmask |= 0xFFu << shift;
    }
    const unsigned int thresh = prefix;
    const int need_eq = s_remaining;  // keys equal to thresh to take, lowest indices first
    const int n_gt = kk - need_eq;

    for (int i = tid; i < sort_pad; i += KTHREADS) buf[i] = 0ull;
    if (tid == 0) {
      s_gt = 0;
      s_run = 0;
    }
    __syncthreads();
    for (int base = 0; base < n_items; base += KTHREADS) {
      const int i = base + tid;
      const unsigned int key = i < n_items ? order_key(sc[i]) : 0u;
      const unsigned long long packed = ((unsigned long long)key << 32) | (0xFFFFFFFFu - (unsigned int)i);
      if (key > thresh) buf[atomicAdd(&s_gt, 1)] = packed;
      const bool eq = key == thresh && key != 0u;
      const unsigned int ballot = __ballot_sync(0xffffffffu, eq);
      if (lane == 0) s_warp[warp] = __popc(ballot);
      __syncthreads();
      if (tid == 0) {
        int acc = 0;
        for (int w = 0; w < KWARPS; ++w) {
          s_off[w] = acc;
          acc += s_warp[w];
        }
        s_warp[0] = acc;  // the chunk's total, read below after the barrier
      }
      __syncthreads();
      const int pos = s_run + s_off[warp] + __popc(ballot & ((1u << lane) - 1u));
      if (eq && pos < need_eq) buf[n_gt + pos] = packed;
      __syncthreads();
      if (tid == 0) s_run += s_warp[0];
      __syncthreads();
    }

    // Bitonic sort, descending, of the sort_pad slots (zeros sink to the end).
    for (int size = 2; size <= sort_pad; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        for (int t = tid; t < sort_pad; t += KTHREADS) {
          const int partner = t ^ stride;
          if (partner > t) {
            const bool down = (t & size) == 0;
            const unsigned long long a = buf[t], b = buf[partner];
            if ((a < b) == down) {
              buf[t] = b;
              buf[partner] = a;
            }
          }
        }
        __syncthreads();
      }
    }
  }

  for (int j = tid; j < k; j += KTHREADS) {
    float s = -INFINITY;
    int item = -1;
    if (j < kk) {
      item = (int)(0xFFFFFFFFu - (unsigned int)(buf[j] & 0xFFFFFFFFull));
      s = sc[item];
    }
    out_s[row * k + j] = s;
    out_i[row * k + j] = item;
  }
}

}  // namespace

// The query, as K5-K7 take it (topk_body.cuh QuerySpec, without the sorted
// list): users (N, r) f32 with user_idx (B,) i32 or null (row b), or, with
// mean_rows, the mean of the rows of items listed in excl row b; excl (rows,
// E) i32 or null when E == 0, read at row user_idx[b] when excl_by_user,
// else row b; excl_map (M,) i32 or null. This call serves rows [row0, row0 +
// B) of the launch: out_s, out_i (., k) at those rows. Scratch, one row per
// CTA of this call: qbuf (B, qstride) f32 with qstride = 2 dpad (mean_rows)
// or r, has (B,) i32, scratch (B, I) f32, and sortbuf (B, sort_pad) u64 or
// null to sort in shared memory (sort_pad = a power of two >= min(k, I)).
// Any k >= 1, any E. Returns cudaGetLastError() after the launches (0 =
// launched).
extern "C" int topk_select_launch(const float* users, const float* items, const int* user_idx,
                                  const int* excl, int excl_by_user, const int* excl_map,
                                  int mean_rows, float* out_s, int* out_i, int row0, int B,
                                  int n_items, int r, int k, int E, int dpad, float* qbuf,
                                  int* has, float* scratch, unsigned long long* sortbuf,
                                  int sort_pad, void* stream) {
  if (k < 1 || r < 1 || sort_pad < 1) return (int)cudaErrorInvalidValue;
  if (B <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  topk::QuerySpec q{users, user_idx, excl, excl_by_user, excl_map, mean_rows, E, 0, dpad};
  if (user_idx != nullptr) q.user_idx += row0;
  else if (!mean_rows) q.users += (long long)row0 * r;
  if (excl != nullptr && !excl_by_user) q.excl += (long long)row0 * E;
  const int qstride = mean_rows ? 2 * dpad : r;

  query_kernel<<<B, QTHREADS, 0, st>>>(q, items, r, qbuf, qstride, has);
  if (n_items > 0) {
    score_kernel<<<dim3((n_items + STHREADS - 1) / STHREADS, B), STHREADS, 0, st>>>(
        qbuf, qstride, has, items, n_items, r, scratch);
    if (excl != nullptr && E > 0) exclude_kernel<<<B, STHREADS, 0, st>>>(q, n_items, scratch);
  }
  const size_t smem = sortbuf == nullptr ? (size_t)sort_pad * sizeof(unsigned long long) : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  select_kernel<<<B, KTHREADS, smem, st>>>(scratch, n_items, k, out_s + (long long)row0 * k,
                                           out_i + (long long)row0 * k, sortbuf, sort_pad);
  return (int)cudaGetLastError();
}
