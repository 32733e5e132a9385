// K9s sgns_shared: one skip-gram minibatch with a shared negative pool, loss
// and gradients, into dense gradient tables, in an order fixed by the inputs.
//
// Replaces: albedo_tpu/models/word2vec.py loss_fn (:241), its shared branch
// (:243-257), and the value_and_grad of step (:303), shared_negatives = K > 0.
// With vc_b = in[c_b], vo_b = out[o_b] and the pool's rows vn_k = out[pool_k]:
//     pos_b  = <vc_b, vo_b>,   L_bk = <vc_b, vn_k>          (L = Vc Vn^T, B x K)
//     loss   = mean_b (BCE(pos_b, 1) + s sum_k BCE(L_bk, 0)),   s = negatives / K
//     g_b    = (sigmoid(pos_b) - 1) / B,   G_bk = sigmoid(L_bk) s / B
//     grad_in[c_b]     += H_b = g_b vo_b + (G Vn)_b
//     grad_out[o_b]    += g_b vc_b
//     grad_out[pool_k] += (G^T Vc)_k
// and loss_acc[0] += loss. BCE is K9's form, max(x, 0) - x label +
// log1p(exp(-|x|)). The Adam update is adam_dense.cu.
//
// What bounds it on an H100: operations. At the reference scale (B 65536,
// d 200, K 512) the three products are 3 x 2 B d K = 40 GFLOP a step, about
// 0.6 ms at the FP32 peak of the CUDA cores; TF32 or bf16 tensor cores would
// not keep the JAX program's float32 products. The products are one SIMT GEMM
// core (Gemm below) in three layouts, each with its row gathers in the load
// stage: 8 x 8 outputs a thread, k-slices 8 deep in a three-stage ring of
// shared memory filled by cp.async (16-byte copies where every row is a
// multiple of 4 floats, 4-byte ones otherwise), fragments read as float4,
// one barrier a slice; G Vn and G^T Vc held to 128 registers, 2 CTAs an SM
// (kernels/spmm_sgns_bench.py variants: slices of 16, five stages or one
// CTA an SM were 2-9% slower). Tiles: L (B x K) 128 x 128; G Vn (B x d) and G^T Vc
// (K x d) take the whole of d = 200 in one tile (80 x 200 and 64 x 200), so
// no column is padding (64-wide tiles for d <= 64, 128 rows).
//   pos_kernel:      g_b and the positive loss, one warp a pair;
//   logits_kernel:   L, epilogue G = sigmoid(L) s / B, the negative loss;
//   grad_in_kernel:  H = G Vn + g vo, each pair's row written once (B x d);
//   grad_out_kernel: G^T Vc, a sum over all B pairs for only K x d outputs,
//                    so the pairs are split over the grid's z and each split
//                    writes its partial to a (splits, K, d) workspace.
// Then the sums into the tables, with no atomics, so two calls on the same
// inputs give the same bits. The caller sorts the 2B keys (c_b, V + o_b)
// stably, so each word's pairs are one run of the sorted list in pair order:
//   word_sum_kernel:    the sorted list cut into ranges of RANGE positions, a
//                       CTA each walking its range in order, one column a
//                       thread: a run wholly inside the range is added into
//                       its table row (H_b for a center, g_b vc_b for a
//                       context); a piece of a run that crosses a range edge
//                       is written to the workspace;
//   word_finish_kernel: the range holding a crossing run's last position adds
//                       its pieces in range order into the table row;
//   pool_split_kernel:  each slot's split partials added in split order;
//   pool_kernel:        the first slot of each pool word adds those sums of
//                       every slot of that word, in slot order, after the
//                       contexts' sums; its last CTA adds the per-CTA loss
//                       slots in a fixed order.
// Summation depth of a gradient element (for the round-off bound that
// ops/sgns.py sgns_shared_depths derives): into grad_in, K (the FMA chain of a
// product output) + 1 (g_b vo_b) + RANGE (a range's walk) + the pieces of
// the longest run + 1; into grad_out, the pairs of a split + the splits +
// the pool slots of a word + 2, or a context's walk and pieces.
// G is materialized (B x K floats, 128 MiB at the reference scale): written
// once and read twice, where recomputing it would cost a product twice.

#include <cuda_runtime.h>

namespace {

constexpr int BK = 8;          // depth of a k-slice
constexpr int STAGES = 3;      // slices in the shared-memory ring
constexpr int MIN_BLOCKS = 2;  // CTAs an SM that G Vn and G^T Vc are compiled for (at most 128 registers)
constexpr int PAIR_WARPS = 8;  // pairs (warps) a CTA of pos_kernel
constexpr int RANGE = 64;      // sorted positions a CTA of word_sum_kernel
constexpr int SUM_THREADS = 256;
constexpr int LOSS_THREADS = 256;

__device__ __forceinline__ float bce_with_logits(float x, float label) {
  return fmaxf(x, 0.0f) - x * label + log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// sigmoid(x) and BCE(x, 0) from one exp(-|x|).
__device__ __forceinline__ void sigmoid_bce0(float x, float& sig, float& bce) {
  const float e = expf(-fabsf(x));
  sig = x >= 0.0f ? 1.0f / (1.0f + e) : e / (1.0f + e);
  bce = fmaxf(x, 0.0f) + log1pf(e);
}

template <int VEC>
__device__ __forceinline__ void cp_async(float* dst, const float* src, bool ok) {
  const unsigned int s = static_cast<unsigned int>(__cvta_generic_to_shared(dst));
  if constexpr (VEC == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(ok ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

// The sum of v over the CTA, in a fixed order (butterfly in each warp, then
// the warps in order), returned to thread 0.
__device__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  float s = 0.0f;
  if (threadIdx.x == 0)
    for (int i = 0; i < (int)(blockDim.x >> 5); ++i) s += red[i];
  __syncthreads();
  return s;
}

// A CTA of TR x TC threads computes a (TR TM) x (TC TN) tile, TM x TN
// outputs a thread. AK: A is stored k-contiguous (a row of A is a row of
// the source), else m-contiguous; likewise BKN for B (n x k or k x n).
// Shared rows are padded by 4 floats: 16-byte aligned, and k-contiguous
// rows read by neighbouring threads fall in distinct banks.
template <bool AK, bool BKN, int TR, int TC, int TM, int TN>
struct Gemm {
  static constexpr int BM = TR * TM, BN = TC * TN, THREADS = TR * TC;
  static constexpr int A_LD = AK ? BK + 4 : BM + 4;
  static constexpr int B_LD = BKN ? BK + 4 : BN + 4;
  static constexpr int A_SIZE = (AK ? BM : BK) * A_LD;
  static constexpr int B_SIZE = (BKN ? BN : BK) * B_LD;
  static constexpr int STAGE = A_SIZE + B_SIZE;
  static constexpr int SMEM = STAGES * STAGE;

  // The tile row of a thread's output i and column of its output j: strided
  // for a k-contiguous operand (neighbouring threads read neighbouring
  // rows), groups of 4 for an m- or n-contiguous one (float4 fragments).
  __device__ static int row(int tr, int i) { return AK ? tr + TR * i : 4 * tr + 4 * TR * (i >> 2) + (i & 3); }
  __device__ static int col(int tc, int j) { return BKN ? tc + TC * j : 4 * tc + 4 * TC * (j >> 2) + (j & 3); }

  // acc += the slice held at As, Bs, in k order.
  __device__ static void slice(const float* As, const float* Bs, float (&acc)[TM][TN], int tr, int tc) {
#pragma unroll
    for (int q = 0; q < BK; q += 4) {
      float a[TM][4], b[TN][4];
      if constexpr (AK) {
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float4 v = *reinterpret_cast<const float4*>(As + row(tr, i) * A_LD + q);
          a[i][0] = v.x, a[i][1] = v.y, a[i][2] = v.z, a[i][3] = v.w;
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int g = 0; g < TM / 4; ++g) {
            const float4 v = *reinterpret_cast<const float4*>(As + (q + kk) * A_LD + 4 * tr + 4 * TR * g);
            a[4 * g][kk] = v.x, a[4 * g + 1][kk] = v.y, a[4 * g + 2][kk] = v.z, a[4 * g + 3][kk] = v.w;
          }
      }
      if constexpr (BKN) {
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const float4 v = *reinterpret_cast<const float4*>(Bs + col(tc, j) * B_LD + q);
          b[j][0] = v.x, b[j][1] = v.y, b[j][2] = v.z, b[j][3] = v.w;
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int g = 0; g < TN / 4; ++g) {
            const float4 v = *reinterpret_cast<const float4*>(Bs + (q + kk) * B_LD + 4 * tc + 4 * TC * g);
            b[4 * g][kk] = v.x, b[4 * g + 1][kk] = v.y, b[4 * g + 2][kk] = v.z, b[4 * g + 3][kk] = v.w;
          }
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i][kk], b[j][kk], acc[i][j]);
    }
  }

  // The k loop over nk slices: load(stage, k0) issues the cp.async copies
  // of slice k0 into a stage; one barrier a slice.
  template <class Load>
  __device__ static void run(float* smem, int nk, Load load, float (&acc)[TM][TN], int tr, int tc) {
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < nk) load(smem + s * STAGE, s * BK);
      cp_async_commit();
    }
    for (int kt = 0; kt < nk; ++kt) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();  // slice kt landed for all; slice kt - 1's stage is free
      const int nx = kt + STAGES - 1;
      if (nx < nk) load(smem + (nx % STAGES) * STAGE, nx * BK);
      cp_async_commit();
      const float* st = smem + (kt % STAGES) * STAGE;
      slice(st, st + A_SIZE, acc, tr, tc);
    }
    cp_async_wait<0>();
  }
};

// Copies `lines` lines of `len` floats (multiples of VEC) into shared rows
// of stride ld: line l from src(l) + c (c < len), zero where ok(l, c) fails.
template <int VEC, int THREADS, class Src, class Ok>
__device__ __forceinline__ void copy_lines(float* dst, int ld, int lines, int len, Src src, Ok ok) {
  const int per = len / VEC;
  for (int e = threadIdx.x; e < lines * per; e += THREADS) {
    const int l = e / per, c = (e % per) * VEC;
    const bool in = ok(l, c);
    cp_async<VEC>(dst + l * ld + c, in ? src(l) + c : src(-1), in);
  }
}

// The positive term: g_b and the BCE of pos_b, one warp a pair; each CTA's
// loss into its slot.
__global__ void __launch_bounds__(PAIR_WARPS * 32) pos_kernel(
    const float* __restrict__ in_t, const float* __restrict__ out_t, const int* __restrict__ centers,
    const int* __restrict__ contexts, float* __restrict__ g, float* __restrict__ slots, int B, int d, float inv_b) {
  __shared__ float red[PAIR_WARPS];
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * PAIR_WARPS + (threadIdx.x >> 5);
  float loss = 0.0f;
  if (b < B) {  // uniform over the warp
    const float* vc = in_t + (long long)centers[b] * d;
    const float* vo = out_t + (long long)contexts[b] * d;
    float dot = 0.0f;
    for (int i = lane; i < d; i += 32) dot = fmaf(vc[i], vo[i], dot);
    for (int off = 16; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
    if (lane == 0) {  // every lane holds the dot: count it once
      g[b] = -sigmoid(-dot) * inv_b;  // sigmoid(pos) - 1 without cancelling
      loss = bce_with_logits(dot, 1.0f);
    }
  }
  const float s = block_sum(loss, red);
  if (threadIdx.x == 0) slots[blockIdx.x] = s;
}

using LogitsGemm = Gemm<true, true, 16, 16, 8, 8>;

// L = Vc Vn^T over (B-tile, K-tile); G = sigmoid(L) gs; the tile's BCE(L, 0)
// into its loss slot.
template <int VEC>
__global__ void __launch_bounds__(LogitsGemm::THREADS) logits_kernel(
    const float* __restrict__ in_t, const float* __restrict__ out_t, const int* __restrict__ centers,
    const int* __restrict__ pool, float* __restrict__ G, float* __restrict__ slots, int B, int d, int K, float gs) {
  using T = LogitsGemm;
  __shared__ __align__(16) float smem[T::SMEM];
  __shared__ long long arow[T::BM], brow[T::BN];
  __shared__ float red[T::THREADS / 32];
  const int tid = threadIdx.x, tc = tid % 16, tr = tid / 16;
  const int m0 = blockIdx.x * T::BM, n0 = blockIdx.y * T::BN;
  for (int i = tid; i < T::BM; i += T::THREADS) arow[i] = m0 + i < B ? (long long)centers[m0 + i] * d : -1;
  for (int i = tid; i < T::BN; i += T::THREADS) brow[i] = n0 + i < K ? (long long)pool[n0 + i] * d : -1;
  __syncthreads();
  float acc[8][8] = {};
  T::run(smem, (d + BK - 1) / BK, [&](float* st, int k0) {
    copy_lines<VEC, T::THREADS>(st, T::A_LD, T::BM, BK,
        [&](int l) { return l < 0 ? in_t : in_t + arow[l] + k0; },
        [&](int l, int c) { return arow[l] >= 0 && k0 + c < d; });
    copy_lines<VEC, T::THREADS>(st + T::A_SIZE, T::B_LD, T::BN, BK,
        [&](int l) { return l < 0 ? out_t : out_t + brow[l] + k0; },
        [&](int l, int c) { return brow[l] >= 0 && k0 + c < d; });
  }, acc, tr, tc);
  float loss = 0.0f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + T::row(tr, i);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + T::col(tc, j);
      if (m < B && n < K) {
        float sig, bce;
        sigmoid_bce0(acc[i][j], sig, bce);
        G[(long long)m * K + n] = sig * gs;
        loss += bce;
      }
    }
  }
  const float s = block_sum(loss, red);
  if (tid == 0) slots[blockIdx.y * gridDim.x + blockIdx.x] = s;
}

// H = G Vn + g vo over (B-tile, d-tile), the sum over the K pool slots.
template <int VEC, class T>
__global__ void __launch_bounds__(T::THREADS, MIN_BLOCKS) grad_in_kernel(
    const float* __restrict__ out_t, const int* __restrict__ contexts, const int* __restrict__ pool,
    const float* __restrict__ G, const float* __restrict__ g, float* __restrict__ H, int B, int d, int K) {
  __shared__ __align__(16) float smem[T::SMEM];
  constexpr int TC = T::BN / 8;
  const int tid = threadIdx.x, tc = tid % TC, tr = tid / TC;
  const int m0 = blockIdx.x * T::BM, n0 = blockIdx.y * T::BN;
  float acc[8][8] = {};
  T::run(smem, (K + BK - 1) / BK, [&](float* st, int k0) {
    copy_lines<VEC, T::THREADS>(st, T::A_LD, T::BM, BK,  // row m0 + l of G, slots k0 + c
        [&](int l) { return l < 0 ? G : G + (long long)(m0 + l) * K + k0; },
        [&](int l, int c) { return m0 + l < B && k0 + c < K; });
    copy_lines<VEC, T::THREADS>(st + T::A_SIZE, T::B_LD, BK, T::BN,  // slot k0 + l, columns n0 + c
        [&](int l) { return l < 0 ? out_t : out_t + (long long)__ldg(pool + k0 + l) * d + n0; },
        [&](int l, int c) { return k0 + l < K && n0 + c < d; });
  }, acc, tr, tc);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + T::row(tr, i);
    if (m >= B) continue;
    const float gm = g[m];
    const float* vo = out_t + (long long)contexts[m] * d;
    float* h = H + (long long)m * d;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + T::col(tc, j);
      if (n < d) h[n] = fmaf(gm, vo[n], acc[i][j]);
    }
  }
}

// The (splits, K, d) partials of G^T Vc over (K-tile, d-tile, split z), the
// sum over pairs [z chunk, (z + 1) chunk) in pair order.
template <int VEC, class T>
__global__ void __launch_bounds__(T::THREADS, MIN_BLOCKS) grad_out_kernel(
    const float* __restrict__ in_t, const int* __restrict__ centers, const float* __restrict__ G,
    float* __restrict__ part, int B, int d, int K, int chunk) {
  __shared__ __align__(16) float smem[T::SMEM];
  constexpr int TC = T::BN / 8;
  const int tid = threadIdx.x, tc = tid % TC, tr = tid / TC;
  const int m0 = blockIdx.x * T::BM, n0 = blockIdx.y * T::BN;
  const int b0 = blockIdx.z * chunk, b1 = min(B, b0 + chunk);
  float acc[8][8] = {};
  T::run(smem, (b1 - b0 + BK - 1) / BK, [&](float* st, int k0) {
    const int b = b0 + k0;
    copy_lines<VEC, T::THREADS>(st, T::A_LD, BK, T::BM,  // pair b + l: G's slots m0 + c
        [&](int l) { return l < 0 ? G : G + (long long)(b + l) * K + m0; },
        [&](int l, int c) { return b + l < b1 && m0 + c < K; });
    copy_lines<VEC, T::THREADS>(st + T::A_SIZE, T::B_LD, BK, T::BN,  // pair b + l: Vc's columns n0 + c
        [&](int l) { return l < 0 ? in_t : in_t + (long long)__ldg(centers + b + l) * d + n0; },
        [&](int l, int c) { return b + l < b1 && n0 + c < d; });
  }, acc, tr, tc);
  float* out = part + (long long)blockIdx.z * K * d;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + T::row(tr, i);
    if (m >= K) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + T::col(tc, j);
      if (n < d) out[(long long)m * d + n] = acc[i][j];
    }
  }
}

// One range [p0, p1) of the sorted list: keys[p] is c_b for a center
// (position value H_b) or V + o_b for a context (value g_b vc_b), perm[p]
// the pair (b for a center, B + b for a context). Each thread walks the
// range in order for its columns; a run that lies wholly in the range is
// added into its table row, a piece of a run that crosses the range's
// start (slot 0: it began earlier; also a range inside one run) or end
// (slot 1: it goes on) is written to part[range][slot].
__global__ void __launch_bounds__(SUM_THREADS) word_sum_kernel(
    const int* __restrict__ keys, const int* __restrict__ perm, const float* __restrict__ H,
    const float* __restrict__ g, const float* __restrict__ in_t, const int* __restrict__ centers,
    float* __restrict__ grad_in, float* __restrict__ grad_out, float* __restrict__ part, int n, int B, int V,
    int d) {
  __shared__ int skey[RANGE + 2];  // keys of positions p0 - 1 .. p1 (-1 outside the list)
  __shared__ const float* rowp[RANGE];
  __shared__ float scale[RANGE];
  const int r = blockIdx.x, p0 = r * RANGE, p1 = min(n, p0 + RANGE), len = p1 - p0;
  for (int t = threadIdx.x; t < len + 2; t += blockDim.x) {
    const int p = p0 - 1 + t;
    skey[t] = p >= 0 && p < n ? keys[p] : -1;
  }
  for (int t = threadIdx.x; t < len; t += blockDim.x) {
    const int q = perm[p0 + t];
    if (q < B) {
      rowp[t] = H + (long long)q * d;
      scale[t] = 1.0f;
    } else {
      rowp[t] = in_t + (long long)centers[q - B] * d;
      scale[t] = g[q - B];
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < d; j += blockDim.x) {
    float acc = 0.0f;
    int start = 0;
    for (int t0 = 0; t0 < len; t0 += 8) {
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = t0 + u < len ? rowp[t0 + u][j] : 0.0f;
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int t = t0 + u;
        if (t >= len) break;
        acc = fmaf(scale[t], v[u], acc);
        const int key = skey[t + 1];
        if (skey[t + 2] == key && t < len - 1) continue;
        const bool head = start == 0 && skey[0] == key;
        const bool tail = t == len - 1 && skey[len + 1] == key;
        if (!head && !tail) {
          float* dst = key < V ? grad_in + (long long)key * d : grad_out + (long long)(key - V) * d;
          dst[j] += acc;
        } else {
          part[((long long)r * 2 + (head ? 0 : 1)) * d + j] = acc;
        }
        acc = 0.0f;
        start = t + 1;
      }
    }
  }
}

// The range that holds the last position of a run crossing into it from
// earlier ranges adds the run's pieces in range order into its table row.
__global__ void __launch_bounds__(SUM_THREADS) word_finish_kernel(
    const int* __restrict__ keys, const float* __restrict__ part, float* __restrict__ grad_in,
    float* __restrict__ grad_out, int n, int V, int d) {
  const int r = blockIdx.x, p0 = r * RANGE, p1 = min(n, p0 + RANGE);
  if (p0 == 0) return;
  const int key = keys[p0];
  if (keys[p0 - 1] != key) return;                                // no piece began earlier
  if (p1 < n && keys[p1 - 1] == key && keys[p1] == key) return;  // the run goes on past this range
  int lo = 0, hi = p0;                                            // the run's first position
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (keys[mid] < key) lo = mid + 1;
    else hi = mid;
  }
  const int first = lo / RANGE;
  float* dst = key < V ? grad_in + (long long)key * d : grad_out + (long long)(key - V) * d;
  for (int j = threadIdx.x; j < d; j += blockDim.x) {
    float total = part[((long long)first * 2 + 1) * d + j];
    for (int i = first + 1; i <= r; ++i) total += part[(long long)i * 2 * d + j];
    dst[j] += total;
  }
}

// P_k = the split partials of slot k added in split order, written over
// split 0's partial, one (slot, column) a thread.
__global__ void __launch_bounds__(LOSS_THREADS) pool_split_kernel(float* __restrict__ part, int K, int d,
                                                                  int splits) {
  const long long e = (long long)blockIdx.x * LOSS_THREADS + threadIdx.x, kd = (long long)K * d;
  if (e >= kd) return;
  float total = part[e];
  for (int s = 1; s < splits; ++s) total += part[s * kd + e];
  part[e] = total;
}

// CTA k < K: if slot k is its word's first, add P of every slot of that
// word, in slot order, into grad_out (after the contexts' sums). CTA K: the
// loss slots, positive then negative, each in a fixed order.
__global__ void __launch_bounds__(LOSS_THREADS) pool_kernel(
    const int* __restrict__ pool, const float* __restrict__ P, float* __restrict__ grad_out,
    const float* __restrict__ slots, float* __restrict__ loss_acc, int K, int d, int n_pos, int n_neg, float inv_b,
    float ls) {
  __shared__ float red[LOSS_THREADS / 32];
  const int k = blockIdx.x;
  if (k == K) {
    float a = 0.0f, b = 0.0f;
    for (int t = threadIdx.x; t < n_pos; t += blockDim.x) a += slots[t];
    for (int t = threadIdx.x; t < n_neg; t += blockDim.x) b += slots[n_pos + t];
    a = block_sum(a, red);
    b = block_sum(b, red);
    if (threadIdx.x == 0) loss_acc[0] += a * inv_b + b * ls;
    return;
  }
  const int w = pool[k];
  int dup = 0;
  for (int t = threadIdx.x; t < k; t += blockDim.x) dup |= pool[t] == w;
  if (__syncthreads_or(dup)) return;
  float* dst = grad_out + (long long)w * d;
  for (int j = threadIdx.x; j < d; j += blockDim.x) {
    float total = P[(long long)k * d + j];
    for (int k0 = k + 1; k0 < K; k0 += 8) {  // 8 predicated loads in flight; a miss adds +0
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = k0 + u < K && pool[k0 + u] == w ? P[(long long)(k0 + u) * d + j] : 0.0f;
#pragma unroll
      for (int u = 0; u < 8; ++u) total += v[u];
    }
    dst[j] += total;
  }
}

using InWide = Gemm<true, false, 10, 25, 8, 8>;    // 80 x 200
using InNarrow = Gemm<true, false, 16, 8, 8, 8>;   // 128 x 64
using OutWide = Gemm<false, false, 8, 25, 8, 8>;   // 64 x 200
using OutNarrow = Gemm<false, false, 16, 8, 8, 8>; // 128 x 64

constexpr int TARGET_CTAS = 528;  // the grid G^T Vc's pair splits aim at (4 waves of 132 SMs)

// K9s's plan for (B, d, K): G^T Vc's pairs cut into `splits` chunks of
// `chunk` pairs (whole k-slices) so its grid has about TARGET_CTAS CTAs, and
// the float32 workspace, `numel` floats: G (B K) | g (B) | H (B d) | word
// pieces (2 ranges d) | split partials (splits K d) | loss slots (n_pos +
// n_neg). The launch and sgns_shared_plan below both take it from here.
struct Plan {
  long long numel;
  int chunk, splits, ranges, n_pos, n_neg;
};

Plan plan_of(int B, int d, int K) {
  Plan p{};
  const bool wide = d > 64;
  const int bm = wide ? OutWide::BM : OutNarrow::BM, bn = wide ? OutWide::BN : OutNarrow::BN;
  const int tiles = ((K + bm - 1) / bm) * ((d + bn - 1) / bn);
  const int slices = (B + BK - 1) / BK;
  int splits = (TARGET_CTAS + (tiles > 1 ? tiles : 1) - 1) / (tiles > 1 ? tiles : 1);
  splits = splits < slices ? splits : slices;
  p.chunk = splits > 0 ? ((slices + splits - 1) / splits) * BK : BK;
  p.splits = (B + p.chunk - 1) / p.chunk;
  p.ranges = (2 * B + RANGE - 1) / RANGE;
  p.n_pos = (B + PAIR_WARPS - 1) / PAIR_WARPS;
  p.n_neg = K > 0 ? ((B + LogitsGemm::BM - 1) / LogitsGemm::BM) * ((K + LogitsGemm::BN - 1) / LogitsGemm::BN) : 0;
  p.numel = (long long)B * K + B + (long long)B * d + (long long)p.ranges * 2 * d + (long long)p.splits * K * d +
            p.n_pos + p.n_neg;
  return p;
}

template <int VEC, class In, class Out>
cudaError_t products(const float* in_t, const float* out_t, const int* centers, const int* contexts,
                     const int* pool, float* G, float* g, float* H, float* part_out, float* neg_slots, int B,
                     int d, int K, float gs, int chunk, int splits, cudaStream_t stream) {
  cudaError_t err;
  if (K > 0) {
    logits_kernel<VEC><<<dim3((B + LogitsGemm::BM - 1) / LogitsGemm::BM, (K + LogitsGemm::BN - 1) / LogitsGemm::BN),
                         LogitsGemm::THREADS, 0, stream>>>(in_t, out_t, centers, pool, G, neg_slots, B, d, K, gs);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  grad_in_kernel<VEC, In><<<dim3((B + In::BM - 1) / In::BM, (d + In::BN - 1) / In::BN), In::THREADS, 0, stream>>>(
      out_t, contexts, pool, G, g, H, B, d, K);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (K > 0) {
    grad_out_kernel<VEC, Out><<<dim3((K + Out::BM - 1) / Out::BM, (d + Out::BN - 1) / Out::BN, splits), Out::THREADS,
                                0, stream>>>(in_t, centers, G, part_out, B, d, K, chunk);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// K9s's plan for a batch (plan_of): out[0..5] = workspace floats, chunk,
// splits, ranges, loss slots of the positive and of the negative terms.
// ops/sgns.py k9s_plan reads it to size the workspace and to derive the
// check's summation depths. Returns 0, or cudaErrorInvalidValue for a shape
// the kernel does not take.
extern "C" int sgns_shared_plan(int B, int d, int K, long long* out) {
  if (B < 0 || d < 1 || K < 0) return (int)cudaErrorInvalidValue;
  const Plan p = plan_of(B, d, K);
  out[0] = p.numel;
  out[1] = p.chunk;
  out[2] = p.splits;
  out[3] = p.ranges;
  out[4] = p.n_pos;
  out[5] = p.n_neg;
  return 0;
}

// in_t, out_t (V, d) f32; centers, contexts (B,) int32; pool (K,) int32, may
// repeat; grad_in, grad_out (V, d) f32, added into; loss_acc (1,) f32, added
// into; keys, perm (2B,) int32: the keys (c_b, V + o_b) sorted stably and
// the position each came from; ws the float32 workspace of ws_numel floats,
// laid out by plan_of. neg_scale = negatives / K. Any d >= 1. Returns the
// first launch error (0 = all launched), cudaErrorInvalidValue for a
// workspace shorter than the plan's.
extern "C" int sgns_shared_launch(const float* in_t, const float* out_t, const int* centers,
                                  const int* contexts, const int* pool, float* grad_in, float* grad_out,
                                  float* loss_acc, const int* keys, const int* perm, float* ws, long long ws_numel,
                                  int B, int V, int d, int K, float neg_scale, void* stream_) {
  if (B <= 0) return (int)cudaGetLastError();
  if (d < 1 || K < 0) return (int)cudaErrorInvalidValue;
  const Plan plan = plan_of(B, d, K);
  if (ws_numel < plan.numel) return (int)cudaErrorInvalidValue;
  const int chunk = plan.chunk, splits = plan.splits;
  cudaStream_t stream = (cudaStream_t)stream_;
  const float inv_b = 1.0f / (float)B;
  const float gs = neg_scale * inv_b;
  const int n = 2 * B, ranges = plan.ranges, n_pos = plan.n_pos, n_neg = plan.n_neg;
  float* G = ws;
  float* g = G + (long long)B * K;
  float* H = g + B;
  float* part_w = H + (long long)B * d;
  float* part_out = part_w + (long long)ranges * 2 * d;
  float* slots = part_out + (long long)splits * K * d;
  cudaError_t err;
  pos_kernel<<<n_pos, PAIR_WARPS * 32, 0, stream>>>(in_t, out_t, centers, contexts, g, slots, B, d, inv_b);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const bool vec4 = d % 4 == 0 && K % 4 == 0;
  if (d > 64)
    err = vec4 ? products<4, InWide, OutWide>(in_t, out_t, centers, contexts, pool, G, g, H, part_out, slots + n_pos,
                                              B, d, K, gs, chunk, splits, stream)
               : products<1, InWide, OutWide>(in_t, out_t, centers, contexts, pool, G, g, H, part_out, slots + n_pos,
                                              B, d, K, gs, chunk, splits, stream);
  else
    err = vec4 ? products<4, InNarrow, OutNarrow>(in_t, out_t, centers, contexts, pool, G, g, H, part_out,
                                                  slots + n_pos, B, d, K, gs, chunk, splits, stream)
               : products<1, InNarrow, OutNarrow>(in_t, out_t, centers, contexts, pool, G, g, H, part_out,
                                                  slots + n_pos, B, d, K, gs, chunk, splits, stream);
  if (err != cudaSuccess) return (int)err;
  word_sum_kernel<<<ranges, SUM_THREADS, 0, stream>>>(keys, perm, H, g, in_t, centers, grad_in, grad_out, part_w, n,
                                                      B, V, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  word_finish_kernel<<<ranges, SUM_THREADS, 0, stream>>>(keys, part_w, grad_in, grad_out, n, V, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (K > 0) {
    pool_split_kernel<<<(int)(((long long)K * d + LOSS_THREADS - 1) / LOSS_THREADS), LOSS_THREADS, 0, stream>>>(
        part_out, K, d, splits);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  pool_kernel<<<K + 1, LOSS_THREADS, 0, stream>>>(pool, part_out, grad_out, slots, loss_acc, K, d, n_pos, n_neg,
                                                  inv_b, gs);
  return (int)cudaGetLastError();
}
