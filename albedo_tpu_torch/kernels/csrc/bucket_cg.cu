// K3 bucket_cg: warm-started Jacobi-preconditioned conjugate gradient on the
// implicit-ALS normal equations, matrix-free.
//
// Replaces: albedo_tpu/ops/als.py bucket_cg_body (:154). For a row with
// entries (y_l = source[idx_l], c1_l = alpha val_l, w_l = 1 + c1_l):
//     b      = sum_l w_l y_l
//     diag   = max(diag(YtY) + sum_l c1_l y_l^2 + reg n, 1e-12)
//     A p    = YtY p + sum_l y_l (c1_l (y_l . p)) + reg n p
// then cg_steps iterations from x0 with the tiny = 1e-30 guards, in the same
// order as the JAX loop (:205-221).
//
// What bounds it on an H100: a row's cg_steps + 1 matvecs and its b/diag
// pass each contract the row's gathered entries twice (4 k FLOP an entry a
// matvec), about 0.09 ms of FP32 work a bench iteration; the bytes (the
// entry lists and the 4-6 MB tables, which stay in the 50 MB L2) are less.
// A bucket group is (B, L) with rows of every length: the ALS fit's groups
// run from 3072 rows x 16 slots to one row x 7624 slots, and each CG step
// needs the whole row's matvec before the next one. The first design (one
// CTA a row, every matvec re-streaming the row from L2 in 32-entry tiles,
// thread 0 taking each dot product alone) left the narrow tall groups on a
// handful of SMs: 83% of K3's time in the 30 groups of fewer rows than SMs.
//
// Rank k <= SPLIT_KMAX = 512: one plan a group (ops/als.py _k3_plan,
// mirrored entry for entry in k3_units), in one of two modes. Lane l of a
// warp owns the columns l + 32 j, j < NC, of every k-vector: NC = 2 up to
// rank 64, then 4, 8 and 16 (k 128, 256, 512), a kernel of each mode per
// column class.
//   - Warp mode (rows short enough that PW staged rows fit beside YtY; the
//     length is the plan's, per rank): one warp a row, PW rows a CTA. The
//     warp stages its row's gathered rows into its own slice of shared
//     memory once and runs the whole solve alone: the dots are warp
//     shuffles and no CTA barrier follows the one that publishes YtY.
//   - Cluster mode: a row's slots are cut into c slices of `slice` slots
//     (c in {1, 2, 4, 8, 16}), one CTA of CW warps each, the row's c CTAs
//     one thread-block cluster. Each CTA stages its slice's gathered rows,
//     with c1 and w, into shared memory once (cp.async) and reads them from
//     there for the b/diag pass and every matvec. A slice too long for
//     shared memory even at the widest cluster is streamed instead: every
//     pass walks it in windows of WIN slots (64; 32 above rank 256) through
//     a two-slot cp.async ring (a path of the kernel, not a fallback). Each
//     pass: every warp accumulates the partial k-vector of its contiguous
//     block of entries, warp 0 adds the warps' partials in warp order, the
//     cluster syncs, and warp 0 of every CTA adds the c CTAs' partials read
//     through distributed shared memory in rank order 0 .. c - 1 and runs
//     the k-length CG update (YtY p, the dots, x, r, z, beta, p) itself.
//     Every CTA computes the same bits from the same partials, so nothing
//     is broadcast; partials are double-buffered, so one cluster barrier a
//     pass suffices, and a last one keeps every CTA alive until its peers
//     have read it. No float atomics: the same bits on every call.
// Inside a pass, entry e's dot y_e . p is a warp sum (fixed xor tree) of
// the lanes' NC products (column order), t_e = c1_e (y_e . p) goes back on
// the same row values, and YtY p (warp 0, i ascending) is formed while the
// other warps work: from a copy of YtY in shared memory (rows of 32 NC
// floats) up to rank 128 (k = 100: 51 KB beside the slice), from L2 above,
// a row of YtY a warp load at a time. The CG vectors of a row live in its
// warp's registers up to rank 256 and in shared memory above (96 floats a
// lane would crowd out the rest). These are the first design's orders
// where one warp holds the row (warp mode: every sum in entry order), and
// blocks of it otherwise. Under bf16 gathers a float32 round-off in any
// other order can flip a bf16 rounding of p or t, which moves a row by up
// to ~1e-3 of the group's largest value (PERF.md, K3-bf16 at the bench);
// hence K3-bf16 is held row by row to F9's limits (ops.als.
// bucket_cg_bf16_limits), not to K3's 1e-4.
//
// Ranks above 512 take the tiled path (bucket_cg_wide_kernel, counted
// bucket_cg_tiled): the same steps in the same order, one 128-thread CTA a
// row, with YtY read from global memory (one k x k table for the whole
// launch, resident in L2) and the entry tile and the seven CG vectors in
// dynamic shared memory while they fit the 227 KB a block may opt into
// ((TILE + 7) k + 3 TILE floats: k up to 1487), else in a global-memory
// workspace of the same layout, one slice per CTA, which the wrapper
// allocates. Each thread owns the columns c = tid, tid + THREADS, ... of
// every vector, so any k fits.
//
// K3-bf16 (entry bucket_cg_bf16): the same kernels reading a bf16 copy of
// the table, as bucket_cg_body does under gather_dtype="bfloat16" (:180,
// :193-203). The staged rows are the bf16 rows as they are, widened on use;
// the kernel rounds where the JAX program rounds and nowhere else (round =
// __float2bfloat16_rn, nearest even, as XLA's convert):
//     diag   = max(diag(YtY) + sum_l round(y_l^2) round(c1_l) + reg n, 1e-12)
//     A p    = YtY p + sum_l y_l round(c1_l (y_l . round(p))) + reg n p
// with b = sum_l w_l y_l (w unrounded). The iterate p stays float32; only
// the two gathered contractions see its rounded copy, formed on the fly.
// Splitting a row across CTAs moves none of these rounding sites.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <mutex>

namespace cg = cooperative_groups;

namespace {

// How the gathered rows are read (see als_partials.cu): float32 as they
// are, or bf16 widened to float32; ``round`` is the identity for float32.
template <typename T>
struct Rows;

template <>
struct Rows<float> {
  static __device__ __forceinline__ float widen(float v) { return v; }
  static __device__ __forceinline__ float round(float x) { return x; }
  static __device__ __forceinline__ float zero() { return 0.f; }
};

template <>
struct Rows<__nv_bfloat16> {
  static __device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  static __device__ __forceinline__ __nv_bfloat16 zero() { return __float2bfloat16_rn(0.f); }
};

constexpr int SPLIT_KMAX = 512;  // the split design's widest rank; the tiled kernel above
constexpr int YTY_NC = 4;        // YtY staged in shared memory up to 32 YTY_NC columns a lane's 32; from L2 above
constexpr int REG_NC = 8;        // the CG vectors in registers up to NC = 8 (k 256); in shared memory above
constexpr int THREADS = 128;     // tiled path
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 32;         // tiled path: entries per shared-memory tile
constexpr unsigned FULL = 0xffffffffu;

// ------------------------------------------------ split design (k <= 512)

constexpr int PW = 4;             // rows (warps) of a warp-mode CTA
constexpr int CW = 8;             // warps of a cluster-mode CTA
constexpr int PACK_MAX = 128;     // the longest row warp mode takes
constexpr int SMEM_MAX = 232448;  // dynamic shared memory a block may opt into

// Columns a lane owns at rank k (columns lane + 32 j, j < NC): 2 up to 64,
// then 4, 8, 16; the kernels are instantiated per class.
__host__ __device__ constexpr int cols_of(int k) { return k <= 64 ? 2 : k <= 128 ? 4 : k <= 256 ? 8 : 16; }
// Slots of a streamed window, and floats of one exchanged partial (b | diag | count).
__host__ __device__ constexpr int win_slots(int nc) { return nc <= 8 ? 64 : 32; }
__host__ __device__ constexpr int cpart_floats(int nc) { return 64 * nc + 16; }

__host__ __device__ __forceinline__ int r16(long long bytes) { return (int)((bytes + 15) / 16 * 16); }

// Staged row stride in elements: k rounded up so that a row is whole 16-byte words.
template <typename T>
__host__ __device__ __forceinline__ int row_elems(int k) {
  const int q = 16 / (int)sizeof(T);
  return (k + q - 1) / q * q;
}

// A region of n slots in shared memory: the gathered rows (n x kp), c1 and
// w (n each), and per 32-slot chunk one past its last masked-in slot (nl)
// and its masked-in count (cnt).
template <typename T>
__host__ __device__ __forceinline__ int region_bytes(int n, int k) {
  const int chunks = (n + 31) / 32;
  return r16((long long)n * row_elems<T>(k) * (int)sizeof(T)) + 2 * r16(4LL * n) + 2 * r16(4LL * chunks);
}

template <typename T>
struct Region {
  T* ys;
  float *c1, *w;
  int *nl, *cnt;
  __device__ Region(unsigned char* base, int n, int k) {
    const int chunks = (n + 31) / 32;
    ys = reinterpret_cast<T*>(base);
    base += r16((long long)n * row_elems<T>(k) * (int)sizeof(T));
    c1 = reinterpret_cast<float*>(base);
    base += r16(4LL * n);
    w = reinterpret_cast<float*>(base);
    base += r16(4LL * n);
    nl = reinterpret_cast<int*>(base);
    base += r16(4LL * chunks);
    cnt = reinterpret_cast<int*>(base);
  }
};

// Shared bytes of YtY staged with rows of 32 NC floats (lane l reads columns
// l + 32 j), none where it is read from L2; of a k-vector (32 NC floats);
// of a row's six CG vectors where they live in shared memory.
__host__ __device__ __forceinline__ int yty_bytes(int k, int nc) { return nc <= YTY_NC ? r16(4LL * k * 32 * nc) : 0; }
__host__ __device__ constexpr int vec_bytes(int nc) { return 4 * 32 * nc; }
__host__ __device__ constexpr int state_bytes(int nc) { return nc <= REG_NC ? 0 : 6 * vec_bytes(nc); }

// Shared bytes of a launch: warp mode (mode 0) YtY and PW regions of
// `slice` slots, each with its p vector (and CG vectors); cluster mode
// (mode 1) one resident region of `slice` slots or two streamed windows,
// YtY, p (and the CG vectors), the warps' partials and the two exchanged
// partials.
template <typename T>
__host__ __device__ __forceinline__ int split_smem(int mode, int slice, int resident, int k) {
  const int nc = cols_of(k);
  const int vec = vec_bytes(nc) + state_bytes(nc);
  if (mode == 0) return yty_bytes(k, nc) + PW * (region_bytes<T>(slice, k) + vec);
  return (resident ? region_bytes<T>(slice, k) : 2 * region_bytes<T>(win_slots(nc), k)) + yty_bytes(k, nc) + vec +
         4 * CW * 64 * nc + 4 * 2 * cpart_floats(nc);
}

struct Args {
  const float* yty;
  const int* idx;
  const float* val;
  const unsigned char* mask;
  const float* x0;
  float* x;
  int B, L, k;
  float reg, alpha;
  int steps;
  int c, slice, resident;  // the plan (cluster mode; warp mode: slice = a warp's slots)
  int kp;                  // staged row stride (elements)
  int wb, words;           // bytes of a cp.async word of a gathered row (8, 4; 0: plain loads), words a row
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  const unsigned int s = static_cast<unsigned int>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool ok) {
  const unsigned int s = static_cast<unsigned int>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(src), "r"(ok ? 8 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait0() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

__device__ __forceinline__ void cp_async_wait1() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// Stage slots [s0, s0 + n) of the row at `rowoff` into region rg, chunk q
// of 32 slots by warp q % G of the group (gw its warp index). A masked-out
// slot gets c1 = w = 0 and, below its chunk's last masked-in slot, a zero
// row (cp.async zero-fill); slots past that are not copied. One commit
// group per thread.
template <typename T>
__device__ void stage(const Region<T>& rg, const T* __restrict__ source, const Args& a, long long rowoff,
                      int s0, int n, int gw, int G, int lane) {
  const int k = a.k, kp = a.kp, wb = a.wb;
  const int width = wb == 0 ? k : a.words;  // items a slot: columns (plain loads) or words
  for (int q = gw; q * 32 < n; q += G) {
    const int l = q * 32 + lane;
    const bool in = l < n;
    const long long o = rowoff + s0 + l;
    const bool m = in && a.mask[o] != 0;
    const int id = m ? a.idx[o] : 0;
    const float c1 = m ? a.alpha * a.val[o] : 0.f;
    if (in) {
      rg.c1[l] = c1;
      rg.w[l] = m ? 1.f + c1 : 0.f;
    }
    const unsigned bal = __ballot_sync(FULL, m);
    const int nq = 32 - __clz(bal);
    if (lane == 0) {
      rg.nl[q] = nq;
      rg.cnt[q] = __popc(bal);
    }
    T* dst = rg.ys + (long long)q * 32 * kp;
    // (slot, item) pairs of the chunk's first nq slots over the lanes.
    int sl = lane / width, c = lane - sl * width;
    const int dsl = 32 / width, dc = 32 - dsl * width;
    for (int e0 = 0; e0 < nq * width; e0 += 32) {
      const int from = sl < 32 ? sl : 31;
      const int ids = __shfl_sync(FULL, id, from);
      const bool ms = __shfl_sync(FULL, (int)m, from) != 0;
      if (e0 + lane < nq * width) {
        if (wb == 0) {
          dst[sl * kp + c] = ms ? source[(long long)ids * k + c] : Rows<T>::zero();
        } else {
          char* d = reinterpret_cast<char*>(dst + sl * kp) + c * wb;
          const char* s = reinterpret_cast<const char*>(source + (long long)ids * k) + c * wb;
          if (wb == 8) cp_async8(d, s, ms);
          else cp_async4(d, s, ms);
        }
      }
      sl += dsl;
      c += dc;
      if (c >= width) {
        c -= width;
        ++sl;
      }
    }
  }
  cp_async_commit();
}

// A lane's NC columns (lane + 32 j) of a k-vector: in registers (Vec<NC,
// true>, also every temporary), or in shared memory at s[32 j] (Vec<NC,
// false>, the CG vectors above REG_NC).
template <int NC, bool REG>
struct Vec {
  float v[NC];
  __device__ __forceinline__ float& operator[](int j) { return v[j]; }
  __device__ __forceinline__ float operator[](int j) const { return v[j]; }
  __device__ __forceinline__ void at(float*) {}
};

template <int NC>
struct Vec<NC, false> {
  float* s;
  __device__ __forceinline__ float& operator[](int j) { return s[32 * j]; }
  __device__ __forceinline__ float operator[](int j) const { return s[32 * j]; }
  __device__ __forceinline__ void at(float* lane_base) { s = lane_base; }
};

template <int NC>
using Reg = Vec<NC, true>;

template <int NC>
__device__ __forceinline__ Reg<NC> zeros() {
  Reg<NC> v;
#pragma unroll
  for (int j = 0; j < NC; ++j) v[j] = 0.f;
  return v;
}

// Columns lane + 32 j of staged entry e, 0 beyond k.
template <typename T, int NC>
__device__ __forceinline__ Reg<NC> entry_cols(const Region<T>& rg, int e, int kp, int k, int lane) {
  const T* y = rg.ys + (long long)e * kp;
  Reg<NC> v;
#pragma unroll
  for (int j = 0; j < NC; ++j) v[j] = lane + 32 * j < k ? Rows<T>::widen(y[lane + 32 * j]) : 0.f;
  return v;
}

// Calls fn(e) for the entries of warp gw's contiguous block of the region's
// n slots (G blocks of ceil(n / G)), in slot order, skipping each chunk's
// slots past its last masked-in one.
template <typename F>
__device__ __forceinline__ void for_block(const int* nl, int n, int gw, int G, F&& fn) {
  const int per = (n + G - 1) / G;
  const int lo = gw * per, hi = min(n, lo + per);
  for (int q = lo >> 5; q * 32 < hi; ++q) {
    const int end = min(hi, q * 32 + nl[q]);
#pragma unroll 4
    for (int e = max(lo, q * 32); e < end; ++e) fn(e);
  }
}

// a . b over the k columns: each lane's products in column order
// (a_0 b_0, then fused), then a warp sum in a fixed xor tree.
template <int NC, typename A, typename B>
__device__ __forceinline__ float dotv(const A& a, const B& b) {
  float d = a[0] * b[0];
#pragma unroll
  for (int j = 1; j < NC; ++j) d = fmaf(a[j], b[j], d);
  return warp_sum(d);
}

// This warp's share of the matvec's gathered term sum_e y_e round(c1_e
// (y_e . pr)), added to acc.
template <typename T, int NC>
__device__ __forceinline__ void matvec_entries(const Region<T>& rg, int n, const Reg<NC>& pr, int kp, int k, int gw,
                                               int G, int lane, Reg<NC>& acc) {
  for_block(rg.nl, n, gw, G, [&](int e) {
    const Reg<NC> y = entry_cols<T, NC>(rg, e, kp, k, lane);
    const float t = Rows<T>::round(rg.c1[e] * dotv<NC>(y, pr));
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[j] = fmaf(y[j], t, acc[j]);
  });
}

// This warp's share of b = sum_e w_e y_e and of diag's sum_e round(y_e^2) round(c1_e).
template <typename T, int NC>
__device__ __forceinline__ void bdiag_entries(const Region<T>& rg, int n, int kp, int k, int gw, int G, int lane,
                                              Reg<NC>& b, Reg<NC>& dg) {
  for_block(rg.nl, n, gw, G, [&](int e) {
    const Reg<NC> y = entry_cols<T, NC>(rg, e, kp, k, lane);
    const float w = rg.w[e], c = Rows<T>::round(rg.c1[e]);
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      b[j] = fmaf(w, y[j], b[j]);
      dg[j] = fmaf(Rows<T>::round(y[j] * y[j]), c, dg[j]);
    }
  });
}

__device__ __forceinline__ int chunk_count(const int* cnt, int chunks) {
  int s = 0;
  for (int q = 0; q < chunks; ++q) s += cnt[q];
  return s;
}

// Load YtY (k x k) into shared memory with rows of 32 NC floats, zero-padded.
template <int NC>
__device__ void load_yty(float* ys, const float* __restrict__ yty, int k) {
  for (int i = threadIdx.x / 32; i < k; i += blockDim.x / 32)
    for (int c = threadIdx.x & 31; c < 32 * NC; c += 32) ys[i * 32 * NC + c] = c < k ? yty[i * k + c] : 0.f;
}

// (YtY p) over the lane's columns, p read whole from pv (i ascending, as
// the JAX program's p @ YtY is formed): from the staged copy (NC <=
// YTY_NC), else from L2, each row of YtY read by the warp at once.
template <int NC>
__device__ __forceinline__ Reg<NC> yty_p(const float* ys, const float* __restrict__ yty, const float* pv, int k,
                                         int lane) {
  Reg<NC> s = zeros<NC>();
  if (NC <= YTY_NC) {
    for (int i = 0; i < k; ++i) {
      const float pi = pv[i];
#pragma unroll
      for (int j = 0; j < NC; ++j) s[j] = fmaf(pi, ys[i * 32 * NC + lane + 32 * j], s[j]);
    }
  } else {
#pragma unroll 2
    for (int i = 0; i < k; ++i) {
      const float pi = pv[i];
      const float* row = yty + (long long)i * k;
#pragma unroll
      for (int j = 0; j < NC; ++j)
        if (lane + 32 * j < k) s[j] = fmaf(pi, __ldg(row + lane + 32 * j), s[j]);
    }
  }
  return s;
}

// The k-length CG state of one row, lane l holding columns l + 32 j
// (zeros beyond k, diag 1 there), in registers up to REG_NC columns a
// lane, else in shared memory (bind: six vectors of 32 NC floats).
template <int NC, bool REG = (NC <= REG_NC)>
struct CgState {
  Vec<NC, REG> x, r, z, p, diag, b;
  float rz, rn;
  __device__ __forceinline__ void bind(float* base, int lane) {
    x.at(base + lane);
    r.at(base + 32 * NC + lane);
    z.at(base + 64 * NC + lane);
    p.at(base + 96 * NC + lane);
    diag.at(base + 128 * NC + lane);
    b.at(base + 160 * NC + lane);
  }
};

// After the first matvec (A x0): r = b - A x0, z = r / diag, p = z.
template <int NC, typename S>
__device__ __forceinline__ void cg_start(S& st, const Reg<NC>& ap) {
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    st.r[j] = st.b[j] - ap[j];
    st.z[j] = st.r[j] / st.diag[j];
    st.p[j] = st.z[j];
  }
  st.rz = dotv<NC>(st.r, st.z);
}

// One CG step given A p.
template <int NC, typename S>
__device__ __forceinline__ void cg_step(S& st, const Reg<NC>& ap) {
  const float tiny = 1e-30f;
  const float step = st.rz / (dotv<NC>(st.p, ap) + tiny);
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    st.x[j] = fmaf(step, st.p[j], st.x[j]);
    st.r[j] = fmaf(-step, ap[j], st.r[j]);
    st.z[j] = st.r[j] / st.diag[j];
  }
  const float rz_new = dotv<NC>(st.r, st.z);
  const float beta = rz_new / (st.rz + tiny);
#pragma unroll
  for (int j = 0; j < NC; ++j) st.p[j] = fmaf(beta, st.p[j], st.z[j]);
  st.rz = rz_new;
}

// A p = (YtY p + the gathered term) + reg n p.
template <int NC, typename V>
__device__ __forceinline__ Reg<NC> apply(const Reg<NC>& yp, const Reg<NC>& s, const V& p, float rn) {
  Reg<NC> out;
#pragma unroll
  for (int j = 0; j < NC; ++j) out[j] = yp[j] + s[j] + rn * p[j];
  return out;
}

// b, diag and rn from the row's sums; x from x0.
template <int NC, typename S>
__device__ __forceinline__ void cg_init(S& st, const float* __restrict__ x0, const float* sb, const float* sd,
                                        int count, const Args& a, int lane) {
  const int k = a.k;
  st.rn = a.reg * (float)count;
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int c = lane + 32 * j;
    st.b[j] = c < k ? sb[j] : 0.f;
    st.diag[j] = c < k ? fmaxf(a.yty[c * k + c] + sd[j] + st.rn, 1e-12f) : 1.f;
    st.x[j] = c < k ? x0[c] : 0.f;
  }
}

template <int NC, typename V>
__device__ __forceinline__ void put_p(float* pv, const V& p, int lane) {
#pragma unroll
  for (int j = 0; j < NC; ++j) pv[lane + 32 * j] = p[j];
}

template <typename T, int NC>
__device__ __forceinline__ Reg<NC> rounded(const float* pv, int lane) {
  Reg<NC> v;
#pragma unroll
  for (int j = 0; j < NC; ++j) v[j] = Rows<T>::round(pv[lane + 32 * j]);
  return v;
}

template <typename T, int NC>
__device__ __forceinline__ void store_x(const Args& a, int row, const CgState<NC>& st, int lane) {
  float* xs = a.x + (long long)row * a.k;
#pragma unroll
  for (int j = 0; j < NC; ++j)
    if (lane + 32 * j < a.k) xs[lane + 32 * j] = st.x[j];
}

// Warp mode: warp w of CTA g solves row g * PW + w, its slots staged in its
// own region of a.slice slots, followed by its p vector (and CG vectors).
template <typename T, int NC>
__global__ void __launch_bounds__(PW * 32) cg_warp_kernel(const T* __restrict__ source, Args a) {
  extern __shared__ __align__(16) unsigned char shm[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int k = a.k;
  float* ys = reinterpret_cast<float*>(shm);
  if (NC <= YTY_NC) load_yty<NC>(ys, a.yty, k);
  __syncthreads();  // YtY is in place: the only CTA barrier, before any row
  const int row = blockIdx.x * PW + warp;
  if (row >= a.B) return;
  const int rb = region_bytes<T>(a.slice, k);
  unsigned char* base = shm + yty_bytes(k, NC) + warp * (rb + vec_bytes(NC) + state_bytes(NC));
  const Region<T> rg(base, a.slice, k);
  float* pv = reinterpret_cast<float*>(base + rb);
  const int chunks = (a.L + 31) / 32;

  stage(rg, source, a, (long long)row * a.L, 0, a.L, 0, 1, lane);
  cp_async_wait0();
  __syncwarp();
  Reg<NC> b = zeros<NC>(), dg = zeros<NC>();
  bdiag_entries<T, NC>(rg, a.L, a.kp, k, 0, 1, lane, b, dg);
  CgState<NC> st;
  st.bind(pv + 32 * NC, lane);
  cg_init<NC>(st, a.x0 + (long long)row * k, b.v, dg.v, chunk_count(rg.cnt, chunks), a, lane);

  put_p<NC>(pv, st.x, lane);
  for (int it = -1; it < a.steps; ++it) {  // it = -1: the matvec of x0
    __syncwarp();                         // pv holds the vector to multiply
    const Reg<NC> yp = yty_p<NC>(ys, a.yty, pv, k, lane);
    Reg<NC> s = zeros<NC>();
    matvec_entries<T, NC>(rg, a.L, rounded<T, NC>(pv, lane), a.kp, k, 0, 1, lane, s);
    if (it < 0) {
      cg_start<NC>(st, apply<NC>(yp, s, st.x, st.rn));
    } else {
      cg_step<NC>(st, apply<NC>(yp, s, st.p, st.rn));
    }
    __syncwarp();  // every lane is done reading pv
    put_p<NC>(pv, st.p, lane);
  }
  store_x<T, NC>(a, row, st, lane);
}

// One exchange of a cluster-mode pass, called by every thread of every CTA
// of the cluster: warp 0 adds the warps' partials (wpart, 64 NC floats a
// warp: column lane + 32 j at 32 j + lane, and with `both` the diag sums at
// 32 NC + 32 j + lane) in warp order into this CTA's cpart (with `both`,
// its count at 64 NC), then adds the c CTAs' cpart in rank order into out
// (warp 0 only): out[j] the lane's columns, with `both` out[NC + j] the
// diag columns and out[2 NC] the count. No warp leaves before warp 0 has
// read wpart: the next pass's partials overwrite it, with no barrier in
// between when the slice is resident.
template <int NC>
__device__ __forceinline__ void exchange(const float* wpart, float* cpart, bool both, int count, int c, int warp,
                                         int lane, float* out) {
  __syncthreads();  // every warp's partial is in wpart
  if (warp == 0) {
    for (int h = 0; h < (both ? 2 : 1); ++h)
      for (int j = 32 * NC * h + lane; j < 32 * NC * (h + 1); j += 32) {
        float s = 0.f;
        for (int w = 0; w < CW; ++w) s += wpart[w * 64 * NC + j];
        cpart[j] = s;
      }
    if (both && lane == 0) cpart[64 * NC] = (float)count;
  }
  if (c > 1) cg::this_cluster().sync();  // also a barrier of this CTA's threads
  else __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int j = 0; j < 2 * NC + 1; ++j) out[j] = 0.f;
    for (int r = 0; r < c; ++r) {
      const float* peer = c > 1 ? cg::this_cluster().map_shared_rank(cpart, r) : cpart;
#pragma unroll
      for (int j = 0; j < NC; ++j) out[j] += peer[lane + 32 * j];
      if (both) {
#pragma unroll
        for (int j = 0; j < NC; ++j) out[NC + j] += peer[32 * NC + lane + 32 * j];
        out[2 * NC] += peer[64 * NC];
      }
    }
  }
}

// Cluster mode: CTA g is rank g % c of row g / c's cluster and holds slots
// [rank slice, (rank + 1) slice) of the row.
template <typename T, int NC>
__global__ void __launch_bounds__(CW * 32) cg_cluster_kernel(const T* __restrict__ source, Args a) {
  extern __shared__ __align__(16) unsigned char shm[];
  constexpr int WIN = win_slots(NC);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int k = a.k, kp = a.kp, c = a.c;
  const int row = blockIdx.x / c;
  const int rank = blockIdx.x - row * c;  // a 1-D cluster's rank
  const int s0 = rank * a.slice;
  const int n = max(0, min(a.L, s0 + a.slice) - s0);
  const long long rowoff = (long long)row * a.L;

  unsigned char* p = shm;
  const int rb = region_bytes<T>(a.resident ? a.slice : WIN, k);
  const Region<T> r0(p, a.resident ? a.slice : WIN, k);
  const Region<T> r1(p + (a.resident ? 0 : rb), WIN, k);  // the ring's second slot (streamed)
  p += a.resident ? rb : 2 * rb;
  float* ys = reinterpret_cast<float*>(p);
  p += yty_bytes(k, NC);
  float* pv = reinterpret_cast<float*>(p);
  p += vec_bytes(NC);
  float* sv = reinterpret_cast<float*>(p);  // the CG vectors (shared-memory state)
  p += state_bytes(NC);
  float* wpart = reinterpret_cast<float*>(p);
  p += 4 * CW * 64 * NC;
  float* cpart = reinterpret_cast<float*>(p);  // two buffers of cpart_floats(NC)

  if (NC <= YTY_NC) load_yty<NC>(ys, a.yty, k);
  const float* x0 = a.x0 + (long long)row * k;
  if (warp == 0) {
#pragma unroll
    for (int j = 0; j < NC; ++j) pv[lane + 32 * j] = lane + 32 * j < k ? x0[lane + 32 * j] : 0.f;
  }
  const int nw = (n + WIN - 1) / WIN;  // streamed windows
  if (a.resident) {
    stage(r0, source, a, rowoff, s0, n, warp, CW, lane);
    cp_async_wait0();
  }
  __syncthreads();

  // One pass over the slice: fn(region, slots) on every warp, over the
  // resident slice, or window by window through the two-slot ring (the next
  // window's copies in flight while this one is processed).
  auto pass = [&](auto&& fn) {
    if (a.resident) {
      fn(r0, n);
      return;
    }
    if (nw > 0) stage(r0, source, a, rowoff, s0, min(WIN, n), warp, CW, lane);
    for (int j = 0; j < nw; ++j) {
      const Region<T>& cur = (j & 1) ? r1 : r0;
      if (j + 1 < nw) {
        stage((j & 1) ? r0 : r1, source, a, rowoff, s0 + (j + 1) * WIN, min(WIN, n - (j + 1) * WIN), warp, CW,
              lane);
        cp_async_wait1();
      } else {
        cp_async_wait0();
      }
      __syncthreads();  // window j has landed for every thread
      fn(cur, min(WIN, n - j * WIN));
      __syncthreads();  // every warp is done with window j's slot
    }
  };

  // b, diag and the count.
  Reg<NC> b = zeros<NC>(), dg = zeros<NC>();
  int count = 0;
  pass([&](const Region<T>& rg, int slots) {
    bdiag_entries<T, NC>(rg, slots, kp, k, warp, CW, lane, b, dg);
    if (warp == 0) count += chunk_count(rg.cnt, (slots + 31) / 32);
  });
  float* wp = wpart + warp * 64 * NC;
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    wp[lane + 32 * j] = b[j];
    wp[32 * NC + lane + 32 * j] = dg[j];
  }
  float sums[2 * NC + 1];
  exchange<NC>(wpart, cpart, true, count, c, warp, lane, sums);
  CgState<NC> st;
  st.bind(sv, lane);
  if (warp == 0) cg_init<NC>(st, x0, sums, sums + NC, (int)sums[2 * NC], a, lane);

  int buf = 1;
  for (int it = -1; it < a.steps; ++it) {  // it = -1: the matvec of x0; pv holds the vector
    const Reg<NC> pr = rounded<T, NC>(pv, lane);
    Reg<NC> yp = zeros<NC>();
    if (warp == 0) yp = yty_p<NC>(ys, a.yty, pv, k, lane);
    Reg<NC> acc = zeros<NC>();
    pass([&](const Region<T>& rg, int slots) { matvec_entries<T, NC>(rg, slots, pr, kp, k, warp, CW, lane, acc); });
#pragma unroll
    for (int j = 0; j < NC; ++j) wp[lane + 32 * j] = acc[j];
    exchange<NC>(wpart, cpart + buf * cpart_floats(NC), false, 0, c, warp, lane, sums);
    buf ^= 1;
    if (warp == 0) {
      Reg<NC> s;
#pragma unroll
      for (int j = 0; j < NC; ++j) s[j] = sums[j];
      if (it < 0) {
        cg_start<NC>(st, apply<NC>(yp, s, st.x, st.rn));
      } else {
        cg_step<NC>(st, apply<NC>(yp, s, st.p, st.rn));
      }
      put_p<NC>(pv, st.p, lane);
    }
    __syncthreads();  // the new p is in pv; warp 0 is done with wpart
  }
  if (rank == 0 && warp == 0) store_x<T, NC>(a, row, st, lane);
  if (c > 1) cg::this_cluster().sync();  // no CTA leaves while a peer may still read its partials
}

// The tiled path's per-CTA region (shared or global): the entry tile (TILE x
// k), the CG vectors (k each) and the entry weights (TILE each).
// A bf16 tile uses the first half of the tile's room, so the layout (and
// the workspace the wrapper sizes) is one for both element types.
template <typename T>
struct Wide {
  T* ys;
  float *x, *r, *z, *p, *ap, *diag, *b;
  float *c1s, *ws, *ts;
};

template <typename T>
__device__ Wide<T> wide_region(float* base, int k) {
  Wide<T> w;
  w.ys = reinterpret_cast<T*>(base);
  float* v = base + TILE * k;
  w.x = v; w.r = v + k; w.z = v + 2 * k; w.p = v + 3 * k;
  w.ap = v + 4 * k; w.diag = v + 5 * k; w.b = v + 6 * k;
  w.c1s = v + 7 * k; w.ws = w.c1s + TILE; w.ts = w.ws + TILE;
  return w;
}

template <typename T>
__device__ void wide_load_tile(const Wide<T>& w, int end, const T* __restrict__ source,
                               const int* __restrict__ idx, const float* __restrict__ val,
                               const unsigned char* __restrict__ mask, long long base,
                               int l0, int k, float alpha) {
  const int tid = threadIdx.x;
  for (int e = tid; e < TILE * k; e += THREADS) {
    const int l = e / k;
    const int c = e - l * k;
    const int gl = l0 + l;
    T y = Rows<T>::zero();
    if (gl < end && mask[base + gl]) y = source[(long long)idx[base + gl] * k + c];
    w.ys[e] = y;
  }
  if (tid < TILE) {
    const int gl = l0 + tid;
    float c1 = 0.f, wt = 0.f;
    if (gl < end && mask[base + gl]) {
      c1 = alpha * val[base + gl];
      wt = 1.f + c1;
    }
    w.c1s[tid] = c1;
    w.ws[tid] = wt;
  }
}

// a . b over k: each thread's columns c = tid, tid + THREADS, ... in
// order, a warp sum (fixed xor tree), then the WARPS sums in warp order,
// added by every thread. (Thread 0 summing all k products in a row was a
// fault under bf16 gathers: the serial order's round-off flipped a bf16
// rounding of p past F9's row limits at rank 513.) The next call's first
// barrier keeps red until every thread has read it.
__device__ float wide_dot(float* red, const float* a, const float* b, int k) {
  __syncthreads();
  float d = 0.f;
  for (int c = threadIdx.x; c < k; c += THREADS) d = fmaf(a[c], b[c], d);
  d = warp_sum(d);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = d;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < WARPS; ++w) s += red[w];
  return s;
}

template <typename T>
__device__ void wide_matvec(const Wide<T>& w, int end, const float* v, float* out,
                            const float* __restrict__ yty, const T* __restrict__ source,
                            const int* __restrict__ idx, const float* __restrict__ val,
                            const unsigned char* __restrict__ mask, long long base, int k,
                            float alpha, float rn) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  __syncthreads();
  for (int c = tid; c < k; c += THREADS) out[c] = 0.f;
  for (int l0 = 0; l0 < end; l0 += TILE) {
    __syncthreads();
    wide_load_tile(w, end, source, idx, val, mask, base, l0, k, alpha);
    __syncthreads();
    const int nl = min(TILE, end - l0);
    for (int l = warp; l < nl; l += WARPS) {
      float d = 0.f;
      for (int c = lane; c < k; c += 32) d += Rows<T>::widen(w.ys[l * k + c]) * Rows<T>::round(v[c]);
      for (int o = 16; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
      if (lane == 0) w.ts[l] = Rows<T>::round(w.c1s[l] * d);
    }
    __syncthreads();
    for (int c = tid; c < k; c += THREADS) {
      float a = out[c];
      for (int l = 0; l < nl; ++l) a += Rows<T>::widen(w.ys[l * k + c]) * w.ts[l];
      out[c] = a;
    }
  }
  __syncthreads();
  for (int c = tid; c < k; c += THREADS) {
    float yp = 0.f;
    for (int i = 0; i < k; ++i) yp += v[i] * yty[(long long)i * k + c];
    out[c] = yp + out[c] + rn * v[c];
  }
  __syncthreads();
}

// ws: null to keep the region in dynamic shared memory, else a workspace of
// B x ((TILE + 7) k + 3 TILE) floats, one slice per CTA.
template <typename T>
__global__ void __launch_bounds__(THREADS) bucket_cg_wide_kernel(
    const T* __restrict__ source, const float* __restrict__ yty,
    const int* __restrict__ idx, const float* __restrict__ val,
    const unsigned char* __restrict__ mask, const float* __restrict__ x0,
    float* __restrict__ xout, int L, int k, float reg, float alpha,
    int cg_steps, float* ws) {
  extern __shared__ float smem[];
  __shared__ float red[WARPS];
  __shared__ int s_end, s_count;
  const int tid = threadIdx.x;
  const long long row = blockIdx.x;
  const long long base = row * L;
  const long long per_cta = (long long)(TILE + 7) * k + 3 * TILE;
  const Wide<T> w = wide_region<T>(ws == nullptr ? smem : ws + row * per_cta, k);

  if (tid == 0) {
    s_end = 0;
    s_count = 0;
  }
  __syncthreads();
  int my_end = 0, my_count = 0;
  for (int l = tid; l < L; l += THREADS)
    if (mask[base + l]) {
      my_end = l + 1;
      ++my_count;
    }
  if (my_end) {
    atomicMax(&s_end, my_end);
    atomicAdd(&s_count, my_count);
  }
  __syncthreads();
  const int end = s_end;
  const float rn = reg * (float)s_count;

  // b-vector and the Jacobi diagonal, accumulated in place over the tiles.
  for (int c = tid; c < k; c += THREADS) {
    w.b[c] = 0.f;
    w.diag[c] = 0.f;
  }
  for (int l0 = 0; l0 < end; l0 += TILE) {
    __syncthreads();
    wide_load_tile(w, end, source, idx, val, mask, base, l0, k, alpha);
    __syncthreads();
    const int nl = min(TILE, end - l0);
    for (int c = tid; c < k; c += THREADS) {
      float bacc = w.b[c], dacc = w.diag[c];
      for (int l = 0; l < nl; ++l) {
        const float y = Rows<T>::widen(w.ys[l * k + c]);
        bacc += w.ws[l] * y;
        dacc += Rows<T>::round(y * y) * Rows<T>::round(w.c1s[l]);
      }
      w.b[c] = bacc;
      w.diag[c] = dacc;
    }
  }
  __syncthreads();
  for (int c = tid; c < k; c += THREADS) {
    w.diag[c] = fmaxf(yty[(long long)c * k + c] + w.diag[c] + rn, 1e-12f);
    w.x[c] = x0[row * k + c];
  }
  __syncthreads();

  const float tiny = 1e-30f;
  wide_matvec(w, end, w.x, w.ap, yty, source, idx, val, mask, base, k, alpha, rn);
  for (int c = tid; c < k; c += THREADS) {
    w.r[c] = w.b[c] - w.ap[c];
    w.z[c] = w.r[c] / w.diag[c];
    w.p[c] = w.z[c];
  }
  float rz = wide_dot(red, w.r, w.z, k);
  for (int it = 0; it < cg_steps; ++it) {
    wide_matvec(w, end, w.p, w.ap, yty, source, idx, val, mask, base, k, alpha, rn);
    const float pap = wide_dot(red, w.p, w.ap, k);
    const float step = rz / (pap + tiny);
    for (int c = tid; c < k; c += THREADS) {
      w.x[c] += step * w.p[c];
      w.r[c] -= step * w.ap[c];
      w.z[c] = w.r[c] / w.diag[c];
    }
    const float rz_new = wide_dot(red, w.r, w.z, k);
    const float beta = rz_new / (rz + tiny);
    for (int c = tid; c < k; c += THREADS) w.p[c] = w.z[c] + beta * w.p[c];
    rz = rz_new;
    __syncthreads();
  }
  for (int c = tid; c < k; c += THREADS) xout[row * k + c] = w.x[c];
}


// The launch path's per-device caches hold up to MAX_DEVICES devices, each
// filled under its lock on the device's first launch.
constexpr int MAX_DEVICES = 64;

cudaError_t current_device(int* dev) {
  const cudaError_t err = cudaGetDevice(dev);
  if (err == cudaSuccess && (*dev < 0 || *dev >= MAX_DEVICES)) return cudaErrorInvalidDevice;
  return err;
}

// Both split kernels of a column class may opt into all of a block's
// shared memory, and cluster mode into clusters of 16 (non-portable); set
// once a device.
template <typename T, int NC>
cudaError_t split_attrs(int dev) {
  static std::mutex lock;
  static bool done[MAX_DEVICES];
  const std::lock_guard<std::mutex> hold(lock);
  if (done[dev]) return cudaSuccess;
  cudaError_t err =
      cudaFuncSetAttribute(cg_warp_kernel<T, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(cg_cluster_kernel<T, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(cg_cluster_kernel<T, NC>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  done[dev] = err == cudaSuccess;
  return err;
}

// A cluster-mode launch of c CTAs a cluster, each with smem bytes.
cudaLaunchConfig_t cluster_config(cudaLaunchAttribute* attr, int clusters, int c, int smem, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * c);
  cfg.blockDim = dim3(CW * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Clusters of c CTAs (smem bytes each) the current device holds at once,
// cached per device and cluster size for the last shared-memory size asked.
template <typename T, int NC>
cudaError_t max_clusters(int c, int smem, int* out) {
  static std::mutex lock;
  static int occ_smem[MAX_DEVICES][7], occ_n[MAX_DEVICES][7];
  int lg = 0;
  while ((1 << lg) < c) ++lg;
  if (lg > 6) return cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = current_device(&dev);
  if (err != cudaSuccess) return err;
  const std::lock_guard<std::mutex> hold(lock);
  if (occ_smem[dev][lg] != smem) {
    err = split_attrs<T, NC>(dev);
    if (err != cudaSuccess) return err;
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = cluster_config(attr, 1, c, smem, 0);
    int n = 0;
    err = cudaOccupancyMaxActiveClusters(&n, cg_cluster_kernel<T, NC>, &cfg);
    if (err != cudaSuccess) return err;
    occ_n[dev][lg] = n;
    occ_smem[dev][lg] = smem;
  }
  *out = occ_n[dev][lg];
  return cudaSuccess;
}

template <typename T>
cudaError_t cluster_query(int k, int c, int smem, int* out) {
  switch (cols_of(k)) {
    case 2: return max_clusters<T, 2>(c, smem, out);
    case 4: return max_clusters<T, 4>(c, smem, out);
    case 8: return max_clusters<T, 8>(c, smem, out);
    default: return max_clusters<T, 16>(c, smem, out);
  }
}

// One column class's launch of a checked plan: warp mode, one CTA a row
// (c = 1), or a cluster launch of c CTAs a row. A cluster the card cannot
// hold (cudaOccupancyMaxActiveClusters gives 0) is refused, never shrunk.
template <typename T, int NC>
int launch_class(const T* source, const Args& a, int mode, int smem, cudaStream_t stream) {
  int dev = 0;
  cudaError_t err = current_device(&dev);
  if (err == cudaSuccess) err = split_attrs<T, NC>(dev);
  if (err != cudaSuccess) return (int)err;
  if (mode == 0) {
    cg_warp_kernel<T, NC><<<(a.B + PW - 1) / PW, PW * 32, smem, stream>>>(source, a);
    return (int)cudaGetLastError();
  }
  if (a.c == 1) {
    cg_cluster_kernel<T, NC><<<a.B, CW * 32, smem, stream>>>(source, a);
    return (int)cudaGetLastError();
  }
  int clusters = 0;
  err = max_clusters<T, NC>(a.c, smem, &clusters);
  if (err != cudaSuccess) return (int)err;
  if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(attr, a.B, a.c, smem, stream);
  err = cudaLaunchKernelEx(&cfg, cg_cluster_kernel<T, NC>, source, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The split design's launch: the plan checked (it must cover every row's
// slots once and fit shared memory), then the column class's kernels.
template <typename T>
int launch_split(const T* source, Args a, int mode, cudaStream_t stream) {
  const int k = a.k;
  a.kp = row_elems<T>(k);
  // Words of 8 bytes where every row starts 8-byte aligned, else 4 (bf16:
  // 4-byte aligned rows, else plain loads), as in als_partials.cu.
  const unsigned long long base = reinterpret_cast<unsigned long long>(source);
  const bool even = (k & 1) == 0;
  a.wb = sizeof(T) == 4 ? (even && base % 8 == 0 ? 8 : 4) : (even && base % 4 == 0 ? 4 : 0);
  a.words = a.wb ? k * (int)sizeof(T) / a.wb : k;
  if (mode == 0) {
    if (a.L > PACK_MAX || a.slice < a.L || a.slice % 4 != 0 || a.slice < 4) return (int)cudaErrorInvalidValue;
  } else if (mode == 1) {
    if (a.c < 1 || a.c > 64 || (a.c & (a.c - 1)) || a.slice < 32 || a.slice % 32 != 0 ||
        (long long)a.slice * a.c < a.L || (long long)a.B * a.c > 0x7fffffffLL)
      return (int)cudaErrorInvalidValue;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  const int smem = split_smem<T>(mode, a.slice, a.resident, k);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  if (a.B == 0) return (int)cudaGetLastError();
  switch (cols_of(k)) {
    case 2: return launch_class<T, 2>(source, a, mode, smem, stream);
    case 4: return launch_class<T, 4>(source, a, mode, smem, stream);
    case 8: return launch_class<T, 8>(source, a, mode, smem, stream);
    default: return launch_class<T, 16>(source, a, mode, smem, stream);
  }
}

template <typename T>
int launch(const T* source, const float* yty, const int* idx, const float* val, const unsigned char* mask,
           const float* x0, float* x, int B, int L, int k, float reg, float alpha, int cg_steps, int mode, int c,
           int slice, int resident, float* ws, cudaStream_t stream) {
  if (k < 1 || B < 0 || L < 0 || cg_steps < 0) return (int)cudaErrorInvalidValue;
  if (k <= SPLIT_KMAX) {
    Args a{yty, idx, val, mask, x0, x, B, L, k, reg, alpha, cg_steps, c, slice, resident, 0, 0, 0};
    return launch_split<T>(source, a, mode, stream);
  }
  if (B == 0) return (int)cudaGetLastError();
  const size_t smem = ws == nullptr ? ((size_t)(TILE + 7) * k + 3 * TILE) * sizeof(float) : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        bucket_cg_wide_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  bucket_cg_wide_kernel<T><<<B, THREADS, smem, stream>>>(
      source, yty, idx, val, mask, x0, x, L, k, reg, alpha, cg_steps, ws);
  return (int)cudaGetLastError();
}

}  // namespace

// source (n, k) f32; yty (k, k); idx, val, mask (B, L); x0, x (B, k); any k >= 1.
// The plan of k <= 512 (ops/als.py _k3_plan; ignored above 512): mode 0,
// warp mode (L <= 128, slice = a warp's slots, a multiple of 4 not below
// L), or mode 1, cluster mode (c CTAs a row, c a power of two; slice slots
// a CTA, a multiple of 32, c slice >= L; resident 1 to hold the slice in
// shared memory, 0 to stream it). ws is null (k <= 512, or the tiled
// region fits shared memory) or a workspace of B x ((TILE + 7) k + 3 TILE)
// floats. Returns cudaGetLastError() after the launch (0 = launched;
// cudaErrorInvalidValue for a plan that does not cover the rows or does not
// fit shared memory; cudaErrorInvalidConfiguration, or the runtime's own
// error, for a cluster the card refuses).
extern "C" int bucket_cg_launch(const float* source, const float* yty, const int* idx, const float* val,
                                const unsigned char* mask, const float* x0, float* x, int B, int L, int k,
                                float reg, float alpha, int cg_steps, int mode, int c, int slice, int resident,
                                float* ws, void* stream) {
  return launch<float>(source, yty, idx, val, mask, x0, x, B, L, k, reg, alpha, cg_steps, mode, c, slice,
                       resident, ws, (cudaStream_t)stream);
}

// Clusters of c CTAs of cluster mode at rank k (its column class's kernel),
// each with smem bytes of dynamic shared memory, that the card holds at
// once (cudaOccupancyMaxActiveClusters; bf16 1 for K3-bf16's kernel), or
// minus the runtime's error. The wrapper plans clusters of 16 only where
// this is at least 1.
extern "C" int bucket_cg_clusters(int bf16, int k, int c, int smem) {
  int n = 0;
  const cudaError_t err = bf16 ? cluster_query<__nv_bfloat16>(k, c, smem, &n) : cluster_query<float>(k, c, smem, &n);
  return err == cudaSuccess ? n : -(int)err;
}

// Dynamic shared bytes a launch of the split design takes at rank k under
// the plan (mode, slice, resident), as bucket_cg_launch checks them (bf16 1
// for K3-bf16; INT_MAX for a slice too long to count in an int), or -1 for
// a rank or plan outside the split design. The wrapper plans with this.
extern "C" int bucket_cg_smem(int bf16, int k, int mode, int slice, int resident) {
  if (k < 1 || k > SPLIT_KMAX || slice < 0 || (mode != 0 && mode != 1)) return -1;
  if ((long long)slice * row_elems<float>(k) * 4 > (1LL << 30)) return INT_MAX;
  return bf16 ? split_smem<__nv_bfloat16>(mode, slice, resident, k) : split_smem<float>(mode, slice, resident, k);
}

// K3-bf16: as bucket_cg_launch, with source (n, k) bf16.
extern "C" int bucket_cg_bf16_launch(const void* source, const float* yty, const int* idx, const float* val,
                                     const unsigned char* mask, const float* x0, float* x, int B, int L, int k,
                                     float reg, float alpha, int cg_steps, int mode, int c, int slice,
                                     int resident, float* ws, void* stream) {
  return launch<__nv_bfloat16>((const __nv_bfloat16*)source, yty, idx, val, mask, x0, x, B, L, k, reg, alpha,
                               cg_steps, mode, c, slice, resident, ws, (cudaStream_t)stream);
}
