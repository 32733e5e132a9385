// K5 topk_scores: user x item scoring with a split top-k, at any rank and
// 1 <= k <= 512 (larger k takes the select path, topk_select.cu).
//
// Replaces: albedo_tpu/ops/topk.py topk_scores (:28), and the cosine
// scoring + top-k of albedo_tpu/recommenders/tfidf.py similar (:121-122),
// similar_to_repos (:157) and recommenders/content.py more_like_this (:81)
// (K14: the same function over L2-normalized rows, r = 200 or ~3000). For
// each query row u: score every item i as u . v_i, drop the row's excluded
// items (a -1-padded, unsorted list that may hold duplicates and entries out
// of range), and return the k best as (score, item) ordered by score
// descending, then item index ascending, with the slots past the admissible
// items filled with (-inf, -1). -inf is never admitted. NaN follows
// lax.top_k's total order, as the plain version does: a NaN with the sign
// bit clear ranks above +inf (NaNs among themselves by index), one with it
// set below -inf, never admitted. (The card's arithmetic makes +NaN.)
//
// Scores are accumulated one rank term at a time, each multiply and add
// rounded separately (__fmul_rn, __fadd_rn), in column order: the plain
// version's arithmetic (ops/topk.py _scores), so the two agree bit for bit,
// ties included, and a row's answer does not depend on the other rows of
// the call or on how the items are split. That rules out tensor cores and
// FMA, and splitting the rank across threads (it would reorder the adds).
//
// What bounds it on an H100: 2 U I r FLOP on CUDA cores over (U + I) r
// floats; without FMA a term is two instructions, so the reachable bound is
// half the FP32 peak's: U I r / 33.5e12 s (~0.030 ms at 500 x 20000 x 50).
// A single query row (tf-idf similar, r = 3010) reads the item table once
// and is bound by its bytes (~11 us for 35.5 MB) and, below that, by each
// item's chain of r dependent adds (~6.5 us at r = 3010).
//
// The design, per pass of rows (the wrapper cuts rows so that a pass's
// workspace stays under its budget), all from one launch call:
//   1. mask (when the call has exclusions): each row's exclusion list
//      becomes a bitmask of ceil(I / 32) words (atomicOr: duplicates and
//      order do not matter), so scoring tests a bit, not a sorted list.
//   2. score: a grid of (32-row tile) x (item split). A CTA stages its query
//      rows and a tile of 32 or 128 item rows in shared memory 64 columns a
//      step (128 for a few rows of a wide rank), cp.async, coalesced, 8-byte
//      copies where the tables allow; the item table is read from L2 once
//      per row tile instead of once per row. Each thread keeps a 4 x TI
//      block of accumulators across the steps (any rank; a lone row is
//      scored alone). Warp w owns rows 4w..4w+3 of the tile and every item
//      of it, so it selects for its rows from its own registers. Each
//      candidate is one 64-bit key (order key << 32 | ~item), so one
//      unsigned compare is the whole order.
//      k <= 32: a row's list lives in the warp's registers, one entry a
//      lane; a few candidates above the row's k-th go in one at a time (a
//      ballot ranks each), more through a shuffle network (a bitonic sort
//      of the 32, then the top 32 of both lists by a bitonic merge).
//      k > 32: a first pass at k1 = ceil(k / n1) <= 32 over n1 splits
//      writes each split's k1-th key; the smallest of a row's n1 keys is a
//      floor its k-th key reaches (n1 k1 >= k keys lie at or above it), so
//      the second pass keeps only the few keys at or above the floor,
//      appended to the (row, split)'s workspace slot (a slot that would
//      overflow is sorted and kept as a list of k, merged by merge path).
//      Without a first pass (too few items for one), sorted lists of k in
//      shared memory take each tile's candidates by a bitonic sort and a
//      merge path that rewrites only the positions below the best
//      candidate's rank. No pass ranks every entry against every other.
//   3. merge: one CTA per row. Sorted per-split lists (k <= 32) are folded
//      in registers, warp by warp; larger ones pairwise in shared memory
//      (the max of one list against the other reversed is the top of both,
//      a bitonic sequence that a bitonic merge sorts); after a floor pass
//      the slots' keys are gathered and sorted. The first k keys are written
//      as (score, item).
// The order is a strict total order on (score, item) and a split's scores
// are the same bits whichever CTA computes them, so the top k of the splits'
// top-k lists (or of every key at or above a floor that k keys reach) is the
// row's top k. Ties across splits and tiles fall to the lower index by the
// key. No float atomics: two calls give the same bits. The wrapper
// (ops/topk.py topk_scores, _k5_plan) picks the tile, the splits of both
// passes and the rows of a pass so that each grid fills the card once.

#include <cuda_runtime.h>

#include <cmath>

namespace {

typedef unsigned long long u64;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TR = 4;           // rows a warp owns (and a thread scores)
constexpr int RT = WARPS * TR;  // rows a CTA scores
constexpr int KMAX = 512;
constexpr int MTHREADS = 256;   // merge kernel
constexpr int MAX_SPLITS = 1024;  // splits of a row (the merge kernel's offsets)

// Order key of a score: larger = better; 0 = not admissible (-inf, -NaN).
// +NaN is the largest; -0.0 and +0.0 tie.
__device__ __forceinline__ unsigned int score_key(float s) {
  if (s != s) return (__float_as_uint(s) & 0x80000000u) ? 0u : 0xFFFFFFFFu;
  if (!(s > -INFINITY)) return 0u;
  const unsigned int u = __float_as_uint(__fadd_rn(s, 0.0f));
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The score of a key (NaN as the card's canonical NaN).
__device__ __forceinline__ float key_score(unsigned int key) {
  if (key == 0xFFFFFFFFu) return __uint_as_float(0x7FFFFFFFu);
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7FFFFFFFu) : ~key);
}

// (key, item) as one unsigned: larger = earlier in the order; 0 = nothing.
__device__ __forceinline__ u64 pack(unsigned int key, int item) {
  return key == 0u ? 0ull : ((u64)key << 32) | (u64)(0xFFFFFFFFu - (unsigned int)item);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const unsigned int s = static_cast<unsigned int>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async8(float* dst, const float* src, bool ok) {
  const unsigned int s = static_cast<unsigned int>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(src), "r"(ok ? 8 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Sort buf[0..n) descending, by one warp, in place (bitonic over the next
// power of two, zero-padded; n <= the buffer's capacity, a power of two).
__device__ void warp_sort_desc(u64* buf, int n, int lane) {
  int p2 = 1;
  while (p2 < n) p2 <<= 1;
  for (int e = n + lane; e < p2; e += 32) buf[e] = 0ull;
  __syncwarp();
  for (int size = 2; size <= p2; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = lane; t < (p2 >> 1); t += 32) {
        const int a = 2 * t - (t & (stride - 1));
        const bool desc = (a & size) == 0;
        const u64 x = buf[a], y = buf[a + stride];
        if ((x < y) == desc) {
          buf[a] = y;
          buf[a + stride] = x;
        }
      }
      __syncwarp();
    }
  }
}

// Merge the sorted candidates cand[0..nc) (nc >= 1) into the sorted list
// list[0..n), keeping the first min(k, n + nc), by one warp. The entries
// above the best candidate stay where they are; each later position j takes
// its element by a co-rank search (merge path). Keys are distinct.
template <int KP>
__device__ void warp_merge(u64* list, int n, const u64* cand, int nc, int k, int lane) {
  const int nout = min(k, n + nc);
  int lo = 0, hi = n;
  const u64 best = cand[0];
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (list[mid] > best) lo = mid + 1; else hi = mid;
  }
  const int a0 = lo;
  u64 out[KP / 32];
#pragma unroll
  for (int m = 0; m < KP / 32; ++m) {
    const int j = a0 + lane + 32 * m;
    if (j < nout) {
      int l = max(a0, j - nc), h = min(j, n);
      while (l < h) {
        const int mid = (l + h) >> 1;
        if (list[mid] > cand[j - 1 - mid]) l = mid + 1; else h = mid;
      }
      out[m] = (l < n && (j - l >= nc || list[l] > cand[j - l])) ? list[l] : cand[j - l];
    }
  }
  __syncwarp();
#pragma unroll
  for (int m = 0; m < KP / 32; ++m) {
    const int j = a0 + lane + 32 * m;
    if (j < nout) list[j] = out[m];
  }
  __syncwarp();
}

// One CTA per row of the pass: zero the row's mask words, then set the bit
// of every entry in [0, n_items).
__global__ void __launch_bounds__(THREADS) mask_kernel(const int* __restrict__ excl, int E, int n_items,
                                                       int W, unsigned int* __restrict__ mask) {
  const long long row = blockIdx.x;
  unsigned int* m = mask + row * W;
  for (int w = threadIdx.x; w < W; w += THREADS) m[w] = 0u;
  __syncthreads();
  const int* ex = excl + row * E;
  for (int e = threadIdx.x; e < E; e += THREADS) {
    const int x = ex[e];
    if (x >= 0 && x < n_items) atomicOr(m + (x >> 5), 1u << (x & 31));
  }
}

__device__ __forceinline__ u64 umax(u64 a, u64 b) { return a > b ? a : b; }
__device__ __forceinline__ u64 umin(u64 a, u64 b) { return a < b ? a : b; }

// A row's list in registers, k <= 32: lane l holds the row's l-th best key
// so far (0 = none), sorted across the warp; its k-th is the row's cut.

// Insert the keys p of the lanes in bal, one at a time where still above
// the cut (a ballot gives the rank, a shuffle moves the tail down); returns
// the new cut.
__device__ __forceinline__ u64 warp_insert(u64& top, u64 p, unsigned int bal, int k, int lane) {
  u64 thr = __shfl_sync(0xFFFFFFFFu, top, k - 1);
  while (bal) {
    const int src = __ffs(bal) - 1;
    bal &= bal - 1;
    const u64 x = __shfl_sync(0xFFFFFFFFu, p, src);
    if (x <= thr) continue;
    const int pos = __popc(__ballot_sync(0xFFFFFFFFu, top > x));
    const u64 up = __shfl_up_sync(0xFFFFFFFFu, top, 1);
    top = lane < pos ? top : (lane == pos ? x : up);
    thr = __shfl_sync(0xFFFFFFFFu, top, k - 1);
  }
  return thr;
}

// Merge the keys p of the lanes in bal into top: a bitonic sort of the
// candidates across the lanes, then the top 32 of both lists (each entry
// against the other list's reversed) sorted by a bitonic merge; returns
// the new cut.
__device__ __forceinline__ u64 warp_network(u64& top, u64 p, unsigned int bal, int k, int lane) {
  u64 c = (bal >> lane) & 1u ? p : 0ull;
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1)
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const u64 o = __shfl_xor_sync(0xFFFFFFFFu, c, stride);
      c = (((lane & stride) == 0) == ((lane & size) == 0)) ? umax(c, o) : umin(c, o);
    }
  u64 m = umax(top, __shfl_sync(0xFFFFFFFFu, c, 31 - lane));
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1) {
    const u64 o = __shfl_xor_sync(0xFFFFFFFFu, m, stride);
    m = (lane & stride) == 0 ? umax(m, o) : umin(m, o);
  }
  top = m;
  return __shfl_sync(0xFFFFFFFFu, top, k - 1);
}

// Add columns [0, w4) of the staged chunk to the first NR rows' sums, one
// rank term at a time in column order: acc[i][j] += u_i[c] * v_j[c],
// multiply and add rounded separately. The next 4 columns are loaded while
// these are added (past w4 they are the rows' padding or stale columns,
// loaded and never used).
template <int NR, int TI, int LD>
__device__ __forceinline__ void accumulate(float (&acc)[TR][TI], const float* su, const float* sv, int w4) {
  float4 u4[NR], v4[TI];
#pragma unroll
  for (int i = 0; i < NR; ++i) u4[i] = *reinterpret_cast<const float4*>(su + i * LD);
#pragma unroll
  for (int j = 0; j < TI; ++j) v4[j] = *reinterpret_cast<const float4*>(sv + j * 32 * LD);
  for (int c = 0; c < w4; c += 4) {
    float4 un[NR], vn[TI];
#pragma unroll
    for (int i = 0; i < NR; ++i) un[i] = *reinterpret_cast<const float4*>(su + i * LD + c + 4);
#pragma unroll
    for (int j = 0; j < TI; ++j) vn[j] = *reinterpret_cast<const float4*>(sv + j * 32 * LD + c + 4);
#pragma unroll
    for (int i = 0; i < NR; ++i)
#pragma unroll
      for (int j = 0; j < TI; ++j) {
        float s = acc[i][j];
        s = __fadd_rn(s, __fmul_rn(u4[i].x, v4[j].x));
        s = __fadd_rn(s, __fmul_rn(u4[i].y, v4[j].y));
        s = __fadd_rn(s, __fmul_rn(u4[i].z, v4[j].z));
        s = __fadd_rn(s, __fmul_rn(u4[i].w, v4[j].w));
        acc[i][j] = s;
      }
#pragma unroll
    for (int i = 0; i < NR; ++i) u4[i] = un[i];
#pragma unroll
    for (int j = 0; j < TI; ++j) v4[j] = vn[j];
  }
}

// What a launch of score_kernel reads and writes (one pass of rows).
struct Pass {
  const float* users;        // the pass's rows (n_users, r)
  const float* items;        // (n_items, r)
  const unsigned int* mask;  // (n_users, W) exclusion bits, or null
  int W;
  u64* ws;                   // (n_users, n_splits, LP) keys, or null with bound_out
  int* cnt;                  // with bound_in: (n_users, n_splits) keys in each ws slot
  u64* bound_out;            // (n_users, n_splits): each split's k-th key (0: fewer), or null
  const u64* bound_in;       // (n_users, n_bound): the first pass's bound_out, or null
  int n_bound;
  int n_users, n_items, r, k, split, n_splits, LP;
  int vec2;                  // r even and both tables 8-byte aligned: stage two floats a copy
};

// Dynamic shared memory of score_kernel<TI, STAGES, KP, CH>: the staging
// buffers (CH columns a row, padded by 4: no bank conflicts) and, with
// KP > 32, the warps' candidate buffers.
__host__ __device__ constexpr size_t score_smem(int TI, int STAGES, int KP, int CH) {
  return (size_t)STAGES * (RT + 32 * TI) * (CH + 4) * sizeof(float) +
         (KP > 32 ? (size_t)WARPS * 32 * TI * sizeof(u64) : 0);
}

// CTA (x, y): rows [32x, 32x + 32) of the pass against the items of split y,
// [y split, (y + 1) split), in tiles of IT = 32 TI items, CH columns a step.
// KP = 32 (k <= 32): each row's list is in registers (warp_insert,
// warp_network); the CTA writes it to ws, or with bound_out only its k-th
// key. KP > 32 (a second pass, with bound_in): each row has a floor, the
// smallest nonzero first-pass key of its row: the first pass, at k1 =
// ceil(k / n_bound) over n_bound splits, gave each of the nz splits with
// k1 keys its k1-th; when nz k1 >= k, at least k keys lie at or above that
// floor, so the row's k-th key does too (else the floor is 0). Only the few
// items at or above it are kept: appended in item order to the (row,
// split)'s ws slot, their number in cnt (the merge kernel sorts them). A
// slot about to hold more than LP keys is sorted in place and from then on
// kept as a sorted list of k (warp_sort_desc, warp_merge).
template <int TI, int STAGES, int KP, int CH>
__global__ void __launch_bounds__(THREADS) score_kernel(const Pass a) {
  constexpr int IT = 32 * TI;
  constexpr int LD = CH + 4;
  constexpr bool REG = KP == 32;
  extern __shared__ __align__(16) float smem[];
  u64* s_cand = reinterpret_cast<u64*>(smem + STAGES * (RT + IT) * LD);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r = a.r, k = a.k;
  const int row0 = blockIdx.x * RT;
  const int n_rows = min(RT, a.n_users - row0);
  const int item_begin = blockIdx.y * a.split;
  const int item_end = min(a.n_items, item_begin + a.split);
  const int n_chunks = (r + CH - 1) / CH;
  const int steps = max(0, (item_end - item_begin + IT - 1) / IT) * n_chunks;
  const bool active = warp * TR < n_rows;  // warp-uniform
  u64* cand = s_cand + warp * IT;
  const float* ubase = a.users + (long long)row0 * r;
  const float* items = a.items;

  // Stage step s (tile s / n_chunks, chunk s % n_chunks) into its buffer:
  // the CTA's query rows and the tile's item rows, columns [c0, c0 + w4),
  // zero past r (an added +0 * +0 leaves a sum unchanged: it is never -0).
  auto issue = [&](int s) {
    if (s < steps) {
      const int tile = s / n_chunks, c0 = (s - tile * n_chunks) * CH;
      const int i0 = item_begin + tile * IT;
      const int w4 = min(CH, (r - c0 + 3) & ~3);
      float* su = smem + (s % STAGES) * (RT + IT) * LD;
      float* sv = su + RT * LD;
      if (a.vec2) {
        for (int e = tid; e < RT * (CH / 2); e += THREADS) {
          const int rr = e / (CH / 2), c = 2 * (e % (CH / 2));
          if (rr < n_rows && c < w4)
            cp_async8(su + rr * LD + c, ubase + (long long)rr * r + min(c0 + c, r - 2), c0 + c < r);
        }
        for (int e = tid; e < IT * (CH / 2); e += THREADS) {
          const int t = e / (CH / 2), c = 2 * (e % (CH / 2));
          const int item = i0 + t;
          if (c < w4)
            cp_async8(sv + t * LD + c, items + (long long)min(item, a.n_items - 1) * r + min(c0 + c, r - 2),
                      item < item_end && c0 + c < r);
        }
      } else {
        for (int e = tid; e < RT * CH; e += THREADS) {
          const int rr = e / CH, c = e % CH;
          if (rr < n_rows && c < w4)
            cp_async4(su + rr * LD + c, ubase + (long long)rr * r + min(c0 + c, r - 1), c0 + c < r);
        }
        for (int e = tid; e < IT * CH; e += THREADS) {
          const int t = e / CH, c = e % CH;
          const int item = i0 + t;
          if (c < w4)
            cp_async4(sv + t * LD + c, items + (long long)min(item, a.n_items - 1) * r + min(c0 + c, r - 1),
                      item < item_end && c0 + c < r);
        }
      }
    }
    cp_async_commit();  // an empty group past the end keeps the wait count uniform
  };

  // Per row of this warp: REG, its list and k-th key; else its floor (less
  // one: keys above it are offered), its slot's length, and whether the
  // slot has become a sorted list.
  u64 top[TR], thr[TR];
  int count[TR];
  bool sorted[TR];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    top[i] = 0ull;
    thr[i] = 0ull;
    count[i] = 0;
    sorted[i] = false;
    if (!REG && warp * TR + i < n_rows) {
      const u64* b = a.bound_in + (long long)(row0 + warp * TR + i) * a.n_bound;
      u64 m = ~0ull;
      int nz = 0;
      for (int q = lane; q < a.n_bound; q += 32)
        if (b[q] != 0ull) {
          m = umin(m, b[q]);
          ++nz;
        }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        m = umin(m, __shfl_xor_sync(0xFFFFFFFFu, m, o));
        nz += __shfl_xor_sync(0xFFFFFFFFu, nz, o);
      }
      const int k1 = (k + a.n_bound - 1) / a.n_bound;
      thr[i] = nz * k1 >= k ? m - 1ull : 0ull;
    }
  }
  float acc[TR][TI];
  unsigned int excl_bits[TR][TI];

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) issue(s);
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // step's buffer landed for every thread; step - 1's is free
    issue(step + STAGES - 1);
    const int tile = step / n_chunks, chunk = step - tile * n_chunks;
    const int i0 = item_begin + tile * IT;
    if (chunk == 0) {
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < TI; ++j) {
          acc[i][j] = 0.f;
          // The tile's exclusion words, loaded now and read after the last chunk.
          const int item = i0 + j * 32;
          excl_bits[i][j] = (a.mask != nullptr && warp * TR + i < n_rows && item < item_end)
                                ? a.mask[(long long)(row0 + warp * TR + i) * a.W + (item >> 5)] : 0u;
        }
    }
    if (!active) continue;
    const float* su = smem + (step % STAGES) * (RT + IT) * LD + warp * TR * LD;
    const float* sv = smem + (step % STAGES) * (RT + IT) * LD + RT * LD + lane * LD;
    const int w4 = min(CH, (r - chunk * CH + 3) & ~3);
    if (warp * TR + 1 == n_rows)  // one row left (a single query): score it alone
      accumulate<1, TI, LD>(acc, su, sv, w4);
    else
      accumulate<TR, TI, LD>(acc, su, sv, w4);
    if (chunk != n_chunks - 1) continue;

    // The tile's scores are final: offer them to this warp's rows.
    if (REG) {
#pragma unroll
      for (int j = 0; j < TI; ++j) {
        const int item = i0 + j * 32 + lane;
        u64 p[TR];
        unsigned int bal[TR], any = 0u;
#pragma unroll
        for (int i = 0; i < TR; ++i) {
          p[i] = (warp * TR + i < n_rows && item < item_end && !((excl_bits[i][j] >> lane) & 1u))
                     ? pack(score_key(acc[i][j]), item) : 0ull;
          bal[i] = __ballot_sync(0xFFFFFFFFu, p[i] > thr[i]);
          any |= bal[i];
        }
        if (any == 0u) continue;
        // A few candidates go in one at a time; more through the network.
#pragma unroll
        for (int i = 0; i < TR; ++i)
          if (bal[i] != 0u)
            thr[i] = __popc(bal[i]) > 4 ? warp_network(top[i], p[i], bal[i], k, lane)
                                        : warp_insert(top[i], p[i], bal[i], k, lane);
      }
      continue;
    }
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int rr = warp * TR + i;
      if (rr >= n_rows) break;
      u64* list = a.ws + ((long long)(row0 + rr) * a.n_splits + blockIdx.y) * a.LP;
      const u64 cut = umax(thr[i], sorted[i] && count[i] == k ? list[k - 1] : 0ull);
      int nc = 0;
#pragma unroll
      for (int j = 0; j < TI; ++j) {
        const int item = i0 + j * 32 + lane;
        const u64 p = (item < item_end && !((excl_bits[i][j] >> lane) & 1u)) ? pack(score_key(acc[i][j]), item)
                                                                               : 0ull;
        const bool take = p > cut;
        const unsigned int ballot = __ballot_sync(0xFFFFFFFFu, take);
        if (take) cand[nc + __popc(ballot & ((1u << lane) - 1u))] = p;
        nc += __popc(ballot);
      }
      __syncwarp();
      if (nc == 0) continue;
      if (!sorted[i]) {
        if (count[i] + nc <= a.LP) {  // append
          for (int e = lane; e < nc; e += 32) list[count[i] + e] = cand[e];
          count[i] += nc;
          __syncwarp();
          continue;
        }
        warp_sort_desc(list, count[i], lane);  // overflow: from now on a sorted list of k
        count[i] = min(k, count[i]);
        sorted[i] = true;
      }
      warp_sort_desc(cand, nc, lane);
      warp_merge<KP>(list, count[i], cand, nc, k, lane);
      count[i] = min(k, count[i] + nc);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int rr = warp * TR + i;
    if (rr >= n_rows) break;
    const long long slot = (long long)(row0 + rr) * a.n_splits + blockIdx.y;
    if (!REG) {
      if (lane == 0) a.cnt[slot] = count[i];
    } else if (a.bound_out != nullptr) {
      if (lane == 0) a.bound_out[slot] = thr[i];
    } else if (lane < a.LP) {
      a.ws[slot * a.LP + lane] = lane < k ? top[i] : 0ull;
    }
  }
}

// The top 32 of two lists sorted across the warp (lane l: l-th key): each
// key against the other list's reversed, then a bitonic merge.
__device__ __forceinline__ u64 warp_top32(u64 a, u64 b, int lane) {
  u64 m = umax(a, __shfl_sync(0xFFFFFFFFu, b, 31 - lane));
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1) {
    const u64 o = __shfl_xor_sync(0xFFFFFFFFu, m, stride);
    m = (lane & stride) == 0 ? umax(m, o) : umin(m, o);
  }
  return m;
}

// One CTA per row of the pass: the top k of its n_splits ws slots (LP keys
// each), written as (score, item), (-inf, -1) past the admissible items.
// k <= 32 (no cnt): each slot is a sorted, zero-padded list; warp w folds
// slots w, w + 8, ... in registers, warp 0 the warps' results. k > 32: slot
// q holds cnt[q] keys in any order; they are gathered into dynamic shared
// memory (pow2(n_splits) LP keys) and sorted (bitonic).
__global__ void __launch_bounds__(MTHREADS) merge_kernel(const u64* __restrict__ ws, const int* __restrict__ cnt,
                                                         int n_splits, int LP, int k, float* __restrict__ out_s,
                                                         int* __restrict__ out_i) {
  extern __shared__ u64 s_m[];
  __shared__ u64 s_warp[MTHREADS / 32][32];
  __shared__ int s_off[MAX_SPLITS + 1];
  const long long row = blockIdx.x;
  const u64* src = ws + row * n_splits * LP;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const u64* top;
  if (cnt == nullptr) {
    u64 m = 0ull;
    for (int q = warp; q < n_splits; q += MTHREADS / 32)
      m = warp_top32(m, lane < LP ? src[(long long)q * LP + lane] : 0ull, lane);
    s_warp[warp][lane] = m;
    __syncthreads();
    if (warp == 0) {
      for (int w = 1; w < MTHREADS / 32; ++w) m = warp_top32(m, s_warp[w][lane], lane);
      s_warp[0][lane] = m;
    }
    __syncthreads();
    top = s_warp[0];
  } else {
    if (warp == 0) {  // offsets of the slots' keys: a running warp scan
      int run = 0;
      if (lane == 0) s_off[0] = 0;
      for (int q0 = 0; q0 < n_splits; q0 += 32) {
        int v = q0 + lane < n_splits ? cnt[row * n_splits + q0 + lane] : 0;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int u = __shfl_up_sync(0xFFFFFFFFu, v, o);
          if (lane >= o) v += u;
        }
        if (q0 + lane < n_splits) s_off[q0 + lane + 1] = run + v;
        run += __shfl_sync(0xFFFFFFFFu, v, 31);
      }
    }
    __syncthreads();
    const int total = s_off[n_splits];
    int p2 = 1;
    while (p2 < total || p2 < k) p2 <<= 1;
    for (int t = threadIdx.x; t < p2; t += MTHREADS) {
      u64 key = 0ull;
      if (t < total) {
        int lo = 0, hi = n_splits;  // the slot q with s_off[q] <= t < s_off[q + 1]
        while (hi - lo > 1) {
          const int mid = (lo + hi) >> 1;
          if (s_off[mid] <= t) lo = mid; else hi = mid;
        }
        key = src[(long long)lo * LP + (t - s_off[lo])];
      }
      s_m[t] = key;
    }
    __syncthreads();
    for (int size = 2; size <= p2; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        for (int t = threadIdx.x; t < (p2 >> 1); t += MTHREADS) {
          const int i = 2 * t - (t & (stride - 1));
          const bool desc = (i & size) == 0;
          const u64 x = s_m[i], y = s_m[i + stride];
          if ((x < y) == desc) {
            s_m[i] = y;
            s_m[i + stride] = x;
          }
        }
        __syncthreads();
      }
    }
    top = s_m;
  }
  for (int j = threadIdx.x; j < k; j += MTHREADS) {
    const u64 p = top[j];
    out_s[row * k + j] = p ? key_score((unsigned int)(p >> 32)) : -INFINITY;
    out_i[row * k + j] = p ? (int)(0xFFFFFFFFu - (unsigned int)(p & 0xFFFFFFFFull)) : -1;
  }
}

cudaError_t allow_smem(const void* kernel, size_t smem) {
  return smem > 48 * 1024 ? cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)
                          : cudaSuccess;
}

template <int TI, int STAGES, int KP, int CH>
cudaError_t run_score(dim3 grid, cudaStream_t st, const Pass& a) {
  const size_t smem = score_smem(TI, STAGES, KP, CH);
  const cudaError_t err = allow_smem((const void*)score_kernel<TI, STAGES, KP, CH>, smem);
  if (err != cudaSuccess) return err;
  score_kernel<TI, STAGES, KP, CH><<<grid, THREADS, smem, st>>>(a);
  return cudaSuccess;
}

// The score kernel for this pass's k and tile: 128-item tiles, or 32-item
// ones with 64 columns a step, or (few rows of a wide rank: each CTA streams
// its items' rows through one SM) 128 columns a step.
cudaError_t run_pass(dim3 grid, cudaStream_t st, const Pass& a, int tile, bool wide) {
  if (tile == 128) {
    if (a.k <= 32) return run_score<4, 2, 32, 64>(grid, st, a);
    if (a.k <= 128) return run_score<4, 2, 128, 64>(grid, st, a);
    return run_score<4, 2, KMAX, 64>(grid, st, a);
  }
  if (wide) {
    if (a.k <= 32) return run_score<1, 4, 32, 128>(grid, st, a);
    if (a.k <= 128) return run_score<1, 4, 128, 128>(grid, st, a);
    return run_score<1, 4, KMAX, 128>(grid, st, a);
  }
  if (a.k <= 32) return run_score<1, 4, 32, 64>(grid, st, a);
  if (a.k <= 128) return run_score<1, 4, 128, 64>(grid, st, a);
  return run_score<1, 4, KMAX, 64>(grid, st, a);
}

}  // namespace

// users (U, r), items (I, r) f32; excl (U, E) i32 or null when E == 0;
// out_s (U, k) f32, out_i (U, k) i32; 1 <= k <= 512, r >= 1. The plan (from
// the wrapper): tile, the items a CTA scores at once (32 or 128); split, the
// items of a split (a multiple of tile); split1, the items of the first
// pass's split, given exactly when k > 32 (k1 = ceil(k / ceil(I / split1))
// must be <= 32); rows, the rows of a pass (a multiple of 32). Workspace
// for one pass of rows: ws, rows x ceil(I / split) x pow2(k) u64, then
// (k > 32) rows x ceil(I / split) i32 of counts; bws, rows x ceil(I /
// split1) u64 (null when k <= 32); mask, rows x ceil(I / 32) u32 (null when
// E == 0). All passes run from this one call. Returns cudaGetLastError()
// after the launches (0 = launched).
extern "C" int topk_scores_launch(const float* users, const float* items, const int* excl, float* out_s,
                                  int* out_i, int U, int n_items, int r, int k, int E, int tile, int split,
                                  int split1, int rows, void* ws, void* bws, void* mask, void* stream) {
  const int n_splits = n_items > 0 ? (n_items + split - 1) / split : 1;
  const int n_bound = split1 > 0 && n_items > 0 ? (n_items + split1 - 1) / split1 : 0;
  if (k < 1 || k > KMAX || r < 1 || n_items < 0 || (tile != 32 && tile != 128) || split < tile ||
      split % tile != 0 || rows < RT || rows % RT != 0 || ws == nullptr ||
      (E > 0 && excl != nullptr && mask == nullptr) || n_splits > MAX_SPLITS ||
      (k > 32) != (n_bound > 0) ||
      (k > 32 && (split1 % tile != 0 || (k + n_bound - 1) / n_bound > 32 || bws == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int LP = 1;
  while (LP < k) LP <<= 1;
  int n_pow2 = 1;
  while (n_pow2 < n_splits) n_pow2 <<= 1;
  const int W = (n_items + 31) / 32;
  unsigned int* bits = (E > 0 && excl != nullptr) ? static_cast<unsigned int*>(mask) : nullptr;
  u64* keys = static_cast<u64*>(ws);
  int* counts = k > 32 ? reinterpret_cast<int*>(keys + (size_t)rows * n_splits * LP) : nullptr;
  const int vec2 = r % 2 == 0 && ((reinterpret_cast<size_t>(users) | reinterpret_cast<size_t>(items)) & 7) == 0;
  const size_t merge_smem = k > 32 ? (size_t)n_pow2 * LP * sizeof(u64) : 0;
  cudaError_t err = allow_smem((const void*)merge_kernel, merge_smem);
  if (err != cudaSuccess) return (int)err;
  for (int row0 = 0; row0 < U; row0 += rows) {
    const int n = U - row0 < rows ? U - row0 : rows;
    const bool wide = r > 64 && n <= RT;
    if (bits != nullptr) mask_kernel<<<n, THREADS, 0, st>>>(excl + (long long)row0 * E, E, n_items, W, bits);
    Pass a{users + (long long)row0 * r, items, bits, W, keys, counts, nullptr, nullptr, 0,
           n, n_items, r, k, split, n_splits, LP, vec2};
    if (k > 32) {  // the first pass: each split's k1-th key
      Pass b = a;
      b.ws = nullptr;
      b.cnt = nullptr;
      b.bound_out = static_cast<u64*>(bws);
      b.k = (k + n_bound - 1) / n_bound;
      b.split = split1;
      b.n_splits = n_bound;
      err = run_pass(dim3((n + RT - 1) / RT, n_bound), st, b, tile, wide);
      if (err != cudaSuccess) return (int)err;
      a.bound_in = b.bound_out;
      a.n_bound = n_bound;
    }
    err = run_pass(dim3((n + RT - 1) / RT, n_splits), st, a, tile, wide);
    if (err != cudaSuccess) return (int)err;
    merge_kernel<<<n, MTHREADS, merge_smem, st>>>(keys, counts, n_splits, LP, k, out_s + (long long)row0 * k,
                                                  out_i + (long long)row0 * k);
  }
  return (int)cudaGetLastError();
}
