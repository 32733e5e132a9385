// K2 solve_corrected: the batched Cholesky solve of the implicit-ALS normal
// equations, one k x k system per bucket row.
//
// Replaces: albedo_tpu/ops/als.py solve_corrected (:138), which forms
//     A_b = YtY + corr_b + reg * n_b * I
// and solves A_b x_b = b_b with jnp.linalg.cholesky + cho_solve.
//
// What bounds it on an H100: bytes. Each system is k^3/3 + 2 k^2 FLOP on one
// triangle of its (k, k) correction (the factorization reads nothing else of
// it), about 330 MB per bench iteration (65 667 padded systems at rank 50),
// 0.1 ms at 3.35 TB/s; its ~2.7 GFLOP take 0.04 ms at the FP32 peak. What
// stands in the way is the chain: a right-looking Cholesky is k dependent
// column steps, and a CTA per system with barriers between them (the first
// design: ~350 __syncthreads a system at k = 50, thread 0 alone taking each
// square root) left the card waiting on that chain at 50x the bound.
//
// Rank k <= 64 (one warp per system). Every warp of a CTA solves its own
// systems: warp w of CTA g takes systems g * SW + w, then + grid * SW, ...
// (the grid is sized from the SM count, a few CTAs an SM). No CTA barrier
// sits inside a solve: lanes trade values by warp shuffles only.
//   - The factor lives in registers: lane i owns rows i and i + 32 of the
//     lower triangle (a0[p] = L[i][p], p < 32; a1[p] = L[i + 32][p], p < 64),
//     indexed by compile-time columns only (every loop over columns is
//     unrolled to the rank class KC = 16, 32 or 64 the kernel is built for),
//     so nothing spills to local memory.
//   - Left-looking column steps: column j is A[i][j] - sum_{p<j} L[i][p]
//     L[j][p], each L[j][p] broadcast from lane j by one shuffle and used by
//     both rows of every lane (the same subtraction order as a right-looking
//     update). Only 1 / L[j][j] is ever used, so lane j takes the pivot's
//     reciprocal square root once (rsqrtf and one Newton step, within an
//     ulp or two of 1 / sqrtf) and broadcasts it; the rows below scale by it.
//   - The two triangular solves: L y = b in registers, one broadcast a
//     column; for L^T x = y each lane copies its rows of L into the warp's
//     slice of shared memory (odd row stride: conflict-free), and x_j,
//     broadcast from lane j, is taken off the rows above it, each reading
//     L[j][i] there (one shuffle and one FMA a column, where a warp sum a
//     column took five dependent shuffles).
//   - Staging: YtY is loaded into shared memory once per CTA. A warp's next
//     system's correction is copied by cp.async into the warp's slab of
//     shared memory while it factors the current one, so the read of the
//     corrections stays off the chain. Only the upper triangle
//     (p, i), i >= p, is copied and read: lane i reads row i of the lower
//     triangle as column i of the upper one, a conflict-free shared read at
//     any k. A is symmetric by contract: K1 writes the correction mirrored,
//     and the JAX program symmetrizes its input ((A + A^T) / 2) before
//     factoring it, so either triangle is the system.
// Measured (als_partials_bench.py variants k2 and ranks): the kernel is
// latency-bound, a warp's chain of column steps and triangular solves with
// 8 warps an SM at rank 33-64 (the rank-64 class takes ~250 registers;
// capping them at 168 or 128 for more CTAs spills and is slower), 20 at
// rank <= 32.
// Padding slots (n_b = 0) solve A = YtY: if that is not positive definite
// a pivot's reciprocal square root is NaN, which reaches every value of that
// system without a trap or a branch (and no other system: each is its own
// warp's), as the JAX program's does; the landing drops those rows.
//
// Ranks above KMAX = 64 take the wide path (solve_corrected_wide_kernel): a
// blocked Cholesky, one CTA of 8 warps a system (4 warps in a group of more
// systems than the card holds 8-warp CTAs at once), looping over systems as
// the narrow path's persistent grid does. The first design (a right-looking
// factorization, three CTA barriers a column with thread 0 alone taking each
// square root, two a column in each triangular solve, an integer / and % at
// each of the n^2 positions of the trailing update, both triangles read:
// ~500 barriers a system at k = 100) ran at 0.85% of its bound. Now:
//   - The system is the bordered matrix [[A, b], [b^T, .]] (b in row k), so
//     factoring it leaves L^-1 b in row k: the forward solve costs one more
//     row of each panel, no pass of its own.
//   - Panels of NB = 32 columns. Warp 0 factors the diagonal block in
//     registers by the narrow path's rank-32 chain (one reciprocal square
//     root a pivot, broadcast); the rows below it (b's included) are solved
//     against L11^T a row a thread in registers and written to A and,
//     transposed, to Lt; the trailing update A22 -= L21 L21^T runs over the
//     lower triangle only, a 4 x 4 register block a thread, two 16-byte
//     loads of Lt for 16 FMAs. Three barriers a panel.
//   - L^T x = y by the same panels from the last: warp 0 solves the block
//     (x_j broadcast from lane j), every thread takes a row above it off the
//     block's x. Two barriers a panel: ~20 a system at k = 100.
//   - Only the upper triangle of each correction is read (A is symmetric by
//     contract, as above), and YtY from L2 as each system is assembled. Where
//     two 8-warp CTAs an SM fit with the next system beside the current one
//     (k up to 110), that system is staged by cp.async while the current
//     one is factored; 4-warp CTAs and wider systems load a system when its
//     turn comes, and a system too wide for shared memory (k above 223)
//     lives in a global workspace the wrapper allocates, a slice a CTA (the
//     barriers order its global writes as they do shared ones): the grid is
//     then no larger than the workspace's slices, one launch whatever B.
//   - Padding slots: a pivot that is not positive gives a NaN reciprocal
//     square root, which reaches every value of that system and no other.
// Measured (als_partials_bench.py variants k2w): latency-bound, ~47 us a
// system at k = 100 on 8 warps; the diagonal blocks' chain takes a quarter
// of it, the panel rows and the back substitution a sixth each.

#include <cuda_runtime.h>

#include <mutex>

namespace {

constexpr int KMAX = 64;
constexpr int SW = 4;  // warps (systems in flight) a CTA
// CTAs an SM the register allocation must leave room for (measured by
// als_partials_bench.py variants k2: capping registers for more is slower).
constexpr int MIN_CTAS = 1;
constexpr unsigned FULL = 0xffffffffu;

// v from lane src, as volatile PTX: the compiler keeps these shuffles in
// program order among a column's sums instead of hoisting them all ahead
// (12% faster than __shfl_sync, als_partials_bench.py variants k2).
__device__ __forceinline__ float shfl_in_order(float v, int src) {
  float r;
  asm volatile("shfl.sync.idx.b32 %0, %1, %2, 0x1f, 0xffffffff;" : "=f"(r) : "f"(v), "r"(src));
  return r;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned int s = static_cast<unsigned int>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// Copy the upper triangle (p, i), i >= p, of one system's (k, k) correction
// into the warp's slab (same row-major layout), one commit group.
__device__ __forceinline__ void stage_upper(float* slab, const float* __restrict__ c, int k, int lane) {
  for (int p = 0; p < k; ++p)
    for (int i = p + lane; i < k; i += 32) cp_async4(slab + p * k + i, c + p * k + i);
  cp_async_commit();
}

// slab: floats a warp's staged correction takes (k * k rounded up to 4);
// ls: the row stride of its copy of L (k rounded up to odd).
template <int KC>
__global__ void __launch_bounds__(SW * 32, MIN_CTAS) solve_warp_kernel(
    const float* __restrict__ yty, const float* __restrict__ corr,
    const float* __restrict__ bvec, const float* __restrict__ n_b, float reg,
    float* __restrict__ x, int B, int k, int slab, int ls) {
  constexpr int N0 = KC < 32 ? KC : 32;  // columns of row `lane` (p <= lane < 32)
  constexpr int N1 = KC > 32 ? KC : 1;   // columns of row `lane + 32`
  extern __shared__ __align__(16) float sm[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* ys = sm;                                  // YtY, k x k
  float* cs = sm + slab + warp * (slab + k * ls);  // this warp's staged correction
  float* lw = cs + slab;                           // and its copy of L
  const int i0 = lane, i1 = lane + 32;

  int s = blockIdx.x * SW + warp;
  const int step = gridDim.x * SW;
  if (s < B) stage_upper(cs, corr + (long long)s * k * k, k, lane);
  for (int e = threadIdx.x; e < k * k; e += blockDim.x) ys[e] = yty[e];
  __syncthreads();  // YtY is in place: the kernel's only CTA barrier, before any solve

  for (; s < B; s += step) {
    const float rn = reg * n_b[s];
    const float* bs = bvec + (long long)s * k;
    float y0 = i0 < k ? bs[i0] : 0.f;
    float y1 = (KC > 32 && i1 < k) ? bs[i1] : 0.f;
    float a0[N0], a1[N1];
// Register columns by compile-time index, clamped so that a branch dead for
// this rank class still indexes in bounds.
#define A0(p) a0[(p) < N0 ? (p) : 0]
#define A1(p) a1[(p) < N1 ? (p) : 0]
    cp_async_wait_all();
    __syncwarp();  // the slab of system s has landed for every lane
    // A = (YtY + corr) + rn I, row i read as column i of the upper triangle.
#pragma unroll
    for (int p = 0; p < N0; ++p) {
      float v = 0.f;
      if (p < k && p <= i0 && i0 < k) {
        v = ys[p * k + i0] + cs[p * k + i0];
        if (p == i0) v += rn;
      }
      A0(p) = v;
    }
#pragma unroll
    for (int p = 0; p < N1; ++p) {
      float v = 0.f;
      if (KC > 32 && p < k && i1 < k) {
        v = ys[p * k + i1] + cs[p * k + i1];
        if (p == i1) v += rn;
      }
      A1(p) = v;
    }
    __syncwarp();  // every lane has read the slab: stage the next system into it
    if (s + step < B) stage_upper(cs, corr + (long long)(s + step) * k * k, k, lane);

    // Left-looking Cholesky, column by column. Lanes whose row lies above
    // column j compute values they never read (the upper triangle).
    float dinv0 = 0.f, dinv1 = 0.f;  // 1 / L[i][i] of the lane's rows
#pragma unroll
    for (int j = 0; j < KC; ++j) {
      if (j >= k) break;
#pragma unroll
      for (int p = 0; p < j; ++p) {
        const float v = shfl_in_order(j < 32 ? A0(p) : A1(p), j & 31);  // L[j][p]
        if (j < 32) A0(j) = fmaf(-A0(p), v, A0(j));
        if (KC > 32) A1(j) = fmaf(-A1(p), v, A1(j));
      }
      // 1 / L[j][j] = 1 / sqrt(pivot), taken once on lane j (rsqrt and one
      // Newton step) and broadcast; L[j][j] itself is never read again.
      const float piv = j < 32 ? A0(j) : A1(j);
      float r = rsqrtf(piv);
      r = r * fmaf(-0.5f * piv * r, r, 1.5f);
      const float inv = __shfl_sync(FULL, r, j & 31);
      if (j < 32) {
        if (i0 > j) A0(j) *= inv;
        if (i0 == j) dinv0 = inv;
      }
      if (KC > 32) {
        if (i1 > j) A1(j) *= inv;
        if (i1 == j) dinv1 = inv;
      }
    }
    // The strictly lower triangle into the warp's copy of L (rows of ls
    // floats, ls odd: conflict-free), for the back substitution.
#pragma unroll
    for (int p = 0; p < N0; ++p)
      if (p < i0 && i0 < k) lw[i0 * ls + p] = A0(p);
#pragma unroll
    for (int p = 0; p < N1; ++p)
      if (KC > 32 && p < i1 && i1 < k) lw[i1 * ls + p] = A1(p);
    __syncwarp();

    // L y = b: y_j broadcast from lane j, subtracted below it.
#pragma unroll
    for (int j = 0; j < KC; ++j) {
      if (j >= k) break;
      const float yj = __shfl_sync(FULL, j < 32 ? y0 * dinv0 : y1 * dinv1, j & 31);
      if (j < 32) y0 = i0 == j ? yj : (i0 > j ? fmaf(-A0(j), yj, y0) : y0);
      if (KC > 32) y1 = i1 == j ? yj : (i1 > j ? fmaf(-A1(j), yj, y1) : y1);
    }
    // L^T x = y by rows of L (columns of L^T): x_j = y_j / L[j][j] on lane
    // j, broadcast, then y_i -= L[j][i] x_j for the rows above it.
    float x0 = 0.f, x1 = 0.f;
#pragma unroll
    for (int j = KC - 1; j >= 0; --j) {
      if (j >= k) continue;
      const float xj = __shfl_sync(FULL, j < 32 ? y0 * dinv0 : y1 * dinv1, j & 31);
      if (i0 == j) x0 = xj;
      else if (i0 < j) y0 = fmaf(-lw[j * ls + i0], xj, y0);
      if (KC > 32) {
        if (i1 == j) x1 = xj;
        else if (i1 < j) y1 = fmaf(-lw[j * ls + i1], xj, y1);
      }
    }
    __syncwarp();  // every lane has read the copy of L before the next system's is written
#undef A0
#undef A1
    float* xs = x + (long long)s * k;
    if (i0 < k) xs[i0] = x0;
    if (KC > 32 && i1 < k) xs[i1] = x1;
  }
}

// ---------------------------------------------------------------- wide path

constexpr int NB = 32;         // panel width of the wide path: one warp's diagonal block
constexpr int WTHREADS = 256;  // threads of a wide CTA; WTHREADS / 2 for groups of many systems (launch_wide)
// Dynamic shared memory a wide CTA may take with the next system staged
// beside the current one: two CTAs an SM (228 KB, less 1 KB a block).
constexpr int WIDE_STAGE_MAX = 113 * 1024;

// The wide path's layout of one system, in floats: A's lower triangle in
// rows 0..k-1 of stride lda (odd: a column read across rows is free of bank
// conflicts), b in row k (the bordered matrix [[A, b], [b^T, .]]: factoring
// it leaves L^-1 b in row k); the panel below the diagonal block transposed
// (Lt, NB rows of ldt floats: 16-byte loads of 4 consecutive rows); the
// reciprocals of the pivots.
struct WideLayout {
  int k, lda, ldt, a, lt, dv;
  __host__ __device__ explicit WideLayout(int k_)
      : k(k_), lda((k_ + 1) | 1), ldt((k_ + 4) & ~3), a((((k_ + 1) * ((k_ + 1) | 1)) + 3) & ~3),
        lt(NB * ((k_ + 4) & ~3)), dv((k_ + 3) & ~3) {}
  __host__ __device__ int floats(bool staged) const { return (staged ? 2 * a : a) + lt + dv; }
};

// Walks a thread's share of the upper triangle (j, i), i >= j, of a k x k
// correction row by row, elements tid, tid + blockDim.x, ..., as (j, i)
// pairs without a division per step; then b's k elements as (k, i).
struct TriWalk {
  int j, i, k;
  __device__ __forceinline__ explicit TriWalk(int k_) : j(0), i(threadIdx.x), k(k_) { settle(); }
  __device__ __forceinline__ void settle() {
    while (j < k && i >= k) {
      i -= j + 1 < k ? k - j - 1 : k;  // row j + 1 starts at column j + 1, b's row at 0
      ++j;
    }
  }
  __device__ __forceinline__ bool more() const { return j < k || i < k; }
  __device__ __forceinline__ void next() {
    i += blockDim.x;
    settle();
  }
};

// Stage system s into A: element (i, j) of its lower triangle from the upper
// triangle's (j, i) of the correction (A is symmetric by contract, as in the
// narrow path), b into row k. Staged: cp.async, completed by
// assemble_system; else plain loads, summed with YtY and reg n_b at once.
template <bool ASYNC>
__device__ __forceinline__ void stage_system(float* A, const float* __restrict__ yty, const float* __restrict__ c,
                                             const float* __restrict__ bs, float rn, const WideLayout& w) {
  for (TriWalk t(w.k); t.more(); t.next()) {
    const bool b_row = t.j == w.k;
    const float* src = b_row ? bs + t.i : c + t.j * w.k + t.i;
    float* dst = b_row ? A + w.k * w.lda + t.i : A + t.i * w.lda + t.j;
    if (ASYNC) {
      cp_async4(dst, src);
    } else {
      float v = *src;
      if (!b_row) {
        v += yty[t.j * w.k + t.i];
        if (t.i == t.j) v += rn;
      }
      *dst = v;
    }
  }
  if (ASYNC) cp_async_commit();
}

// The staged elements a thread copied: add YtY and reg n_b (its own copies
// are visible to it once its cp.async groups completed).
__device__ __forceinline__ void assemble_system(float* A, const float* __restrict__ yty, float rn,
                                                const WideLayout& w) {
  for (TriWalk t(w.k); t.j < w.k; t.next()) {
    float& v = A[t.i * w.lda + t.j];
    v += yty[t.j * w.k + t.i];
    if (t.i == t.j) v += rn;
  }
}

// The diagonal block at (p0, p0), nb <= NB rows, factored by one warp in
// registers as the narrow path's rank-32 class does: lane i holds row p0 + i,
// column j is A[i][j] - sum_{p<j} L[i][p] L[j][p] with L[j][p] broadcast from
// lane j (the sum in two partial sums over even and odd p), and lane j
// takes the pivot's reciprocal square root once. The
// strictly lower part of L11 goes back to A, 1 / L[j][j] to dinv.
__device__ __forceinline__ void factor_diagonal(float* A, float* dinv, int p0, int nb, const WideLayout& w,
                                                int lane) {
  float a[NB];
  float* row = A + (p0 + lane) * w.lda + p0;
#pragma unroll
  for (int c = 0; c < NB; ++c) a[c] = (c <= lane && lane < nb) ? row[c] : 0.f;
  float dv = 0.f;
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    if (j >= nb) break;
    float s0 = a[j], s1 = 0.f;  // two partial sums: half the dependent chain of FMAs
#pragma unroll
    for (int p = 0; p < j; ++p) {
      const float v = shfl_in_order(a[p], j);
      if (p & 1) s1 = fmaf(-a[p], v, s1);
      else s0 = fmaf(-a[p], v, s0);
    }
    a[j] = s0 + s1;
    const float piv = a[j];
    float r = rsqrtf(piv);
    r = r * fmaf(-0.5f * piv * r, r, 1.5f);
    const float inv = __shfl_sync(FULL, r, j);
    if (lane > j) a[j] *= inv;
    if (lane == j) dv = inv;
  }
#pragma unroll
  for (int c = 0; c < NB; ++c)
    if (c < lane && lane < nb) row[c] = a[c];
  if (lane < nb) dinv[p0 + lane] = dv;
}

// Row i below the diagonal block: L21[i] = A21[i] L11^-T, a row a thread in
// registers (L11 read as broadcasts), into A and, transposed, into Lt.
__device__ __forceinline__ void panel_row(float* A, float* Lt, const float* dinv, int i, int p0, int nb,
                                          int r0, const WideLayout& w) {
  float r[NB];
  float* row = A + i * w.lda + p0;
#pragma unroll
  for (int c = 0; c < NB; ++c) r[c] = c < nb ? row[c] : 0.f;
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    if (j >= nb) break;
    const float* lj = A + (p0 + j) * w.lda + p0;
    float s0 = r[j], s1 = 0.f;  // two partial sums, as in factor_diagonal
#pragma unroll
    for (int p = 0; p < j; ++p) {
      if (p & 1) s1 = fmaf(-r[p], lj[p], s1);
      else s0 = fmaf(-r[p], lj[p], s0);
    }
    r[j] = (s0 + s1) * dinv[p0 + j];
  }
#pragma unroll
  for (int c = 0; c < NB; ++c) {
    if (c >= nb) break;
    row[c] = r[c];
    Lt[c * w.ldt + i - r0] = r[c];
  }
}

// The trailing update A22 -= L21 L21^T over the lower triangle of rows
// r0..k (b's row included), a 4 x 4 block (I, M), M <= I, a thread: two
// 16-byte loads of Lt for 16 FMAs a panel column.
__device__ __forceinline__ void trailing_update(float* A, const float* Lt, int nb, int r0, const WideLayout& w) {
  const int n2 = w.k + 1 - r0;
  const int nbk = (n2 + 3) >> 2;
  const int blocks = nbk * (nbk + 1) / 2;
  for (int t = threadIdx.x; t < blocks; t += blockDim.x) {
    int I = (int)((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
    while (I * (I + 1) / 2 > t) --I;
    while ((I + 1) * (I + 2) / 2 <= t) ++I;
    const int M = t - I * (I + 1) / 2;
    float acc[4][4];
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int y = 0; y < 4; ++y) acc[x][y] = 0.f;
#pragma unroll 4
    for (int j = 0; j < nb; ++j) {
      const float4 a = *reinterpret_cast<const float4*>(Lt + j * w.ldt + 4 * I);
      const float4 m = *reinterpret_cast<const float4*>(Lt + j * w.ldt + 4 * M);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float mv[4] = {m.x, m.y, m.z, m.w};
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int y = 0; y < 4; ++y) acc[x][y] = fmaf(av[x], mv[y], acc[x][y]);
    }
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int i = r0 + 4 * I + x;
#pragma unroll
      for (int y = 0; y < 4; ++y) {
        const int m = r0 + 4 * M + y;
        if (i <= w.k && m <= i && m < w.k) A[i * w.lda + m] -= acc[x][y];
      }
    }
  }
}

// ws: null to hold each CTA's systems in dynamic shared memory (the next
// one staged beside the current one when `staged`), else a workspace of
// gridDim.x slices of WideLayout(k).floats(false) floats.
template <int THREADS>
__global__ void __launch_bounds__(THREADS, THREADS == WTHREADS ? 2 : 4) solve_corrected_wide_kernel(
    const float* __restrict__ yty, const float* __restrict__ corr, const float* __restrict__ bvec,
    const float* __restrict__ n_b, float reg, float* __restrict__ x, int B, int k, float* ws, int staged) {
  extern __shared__ __align__(16) float smem[];
  const WideLayout w(k);
  float* base = ws == nullptr ? smem : ws + (long long)blockIdx.x * w.floats(false);
  float* Lt = base + (staged ? 2 * w.a : w.a);
  float* dinv = Lt + w.lt;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int step = gridDim.x;
  int s = blockIdx.x;
  if (staged && s < B) stage_system<true>(base, yty, corr + (long long)s * k * k, bvec + (long long)s * k, 0.f, w);

  for (int n = 0; s < B; s += step, ++n) {
    float* A = base + (staged ? (n & 1) * w.a : 0);
    const float rn = reg * n_b[s];
    if (staged) {
      cp_async_wait_all();
      assemble_system(A, yty, rn, w);
      __syncthreads();  // system s in place; every thread is done with the other buffer
      if (s + step < B)
        stage_system<true>(base + ((n + 1) & 1) * w.a, yty, corr + (long long)(s + step) * k * k,
                           bvec + (long long)(s + step) * k, 0.f, w);
    } else {
      __syncthreads();  // every thread is done with the last system
      stage_system<false>(A, yty, corr + (long long)s * k * k, bvec + (long long)s * k, rn, w);
      __syncthreads();
    }
    float* y = A + k * w.lda;  // b, then L^-1 b, then x

    // Blocked right-looking Cholesky of the bordered matrix, panels of NB
    // columns: three barriers a panel.
    for (int p0 = 0; p0 < k; p0 += NB) {
      const int nb = min(NB, k - p0);
      const int r0 = p0 + nb;
      if (warp == 0) factor_diagonal(A, dinv, p0, nb, w, lane);
      __syncthreads();
      for (int i = r0 + threadIdx.x; i <= k; i += THREADS) panel_row(A, Lt, dinv, i, p0, nb, r0, w);
      __syncthreads();
      if (r0 < k) {
        trailing_update(A, Lt, nb, r0, w);
        __syncthreads();
      }
    }
    // L^T x = y by panels from the last: one warp solves the diagonal
    // block (x_j broadcast from lane j), then every thread takes a row above
    // it off the block's x: two barriers a panel.
    for (int p0 = (k - 1) / NB * NB; p0 >= 0; p0 -= NB) {
      const int nb = min(NB, k - p0);
      if (warp == 0) {
        float v = lane < nb ? y[p0 + lane] : 0.f;
        const float dv = lane < nb ? dinv[p0 + lane] : 0.f;
        float xv = 0.f;
#pragma unroll
        for (int j = NB - 1; j >= 0; --j) {
          if (j >= nb) continue;
          const float xj = __shfl_sync(FULL, v * dv, j);
          if (lane == j) xv = xj;
          else if (lane < j) v = fmaf(-A[(p0 + j) * w.lda + p0 + lane], xj, v);
        }
        if (lane < nb) y[p0 + lane] = xv;
      }
      __syncthreads();
      for (int i = threadIdx.x; i < p0; i += THREADS) {
        float v = y[i];
        for (int j = 0; j < nb; ++j) v = fmaf(-A[(p0 + j) * w.lda + i], y[p0 + j], v);
        y[i] = v;
      }
      __syncthreads();
    }
    float* xs = x + (long long)s * k;
    for (int i = threadIdx.x; i < k; i += THREADS) xs[i] = y[i];
  }
}

// The launch path's per-device cache holds up to MAX_DEVICES devices.
constexpr int MAX_DEVICES = 64;

template <int KC>
int launch_warps(const float* yty, const float* corr, const float* bvec, const float* n_b, float reg,
                 float* x, int B, int k, cudaStream_t stream) {
  // Shared memory: YtY and a slab a warp, each k * k floats rounded up to
  // 4, and a warp's copy of L, k rows of ls floats.
  const int slab = (k * k + 3) & ~3;
  const int ls = k | 1;
  const int smem = (int)(((1 + SW) * (size_t)slab + (size_t)SW * k * ls) * sizeof(float));
  // Per device, filled under the lock on its first launch: the attribute
  // set, the SM count and the resident CTAs an SM at each rank (occupancy,
  // registers and shared memory).
  static std::mutex lock;
  static int sms[MAX_DEVICES], per_sm[MAX_DEVICES][KC + 1];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  int cap = 0;
  {
    const std::lock_guard<std::mutex> hold(lock);
    if (!sms[dev]) {
      const int most = ((1 + SW) * KC * KC + SW * KC * (KC + 1)) * (int)sizeof(float);
      err = cudaFuncSetAttribute(solve_warp_kernel<KC>, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
      int n = 0;
      if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
      if (err != cudaSuccess) return (int)err;
      sms[dev] = n;
    }
    if (!per_sm[dev][k]) {
      int n = 0;
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, solve_warp_kernel<KC>, SW * 32, smem);
      if (err != cudaSuccess) return (int)err;
      if (n < 1) return (int)cudaErrorInvalidConfiguration;
      per_sm[dev][k] = n;
    }
    cap = per_sm[dev][k] * sms[dev];
  }
  const int want = (B + SW - 1) / SW;
  const int grid = want < cap ? want : cap;
  solve_warp_kernel<KC><<<grid, SW * 32, smem, stream>>>(yty, corr, bvec, n_b, reg, x, B, k, slab, ls);
  return (int)cudaGetLastError();
}


// The wide path: 8-warp CTAs, the next system staged beside the current one
// where two such CTAs fit an SM, else one system in shared memory at a time,
// else (ws) in a global workspace of a slice a CTA. A group with more systems
// than the card holds such CTAs at once takes 4-warp CTAs, one system each
// in shared memory, where twice as many of them fit an SM: the systems'
// dependent chains overlap across more CTAs, where a few systems finish
// sooner on 8 warps (als_partials_bench.py variants k2w). A persistent grid
// of the CTAs the card holds at once, and no more than the workspace's
// ws_slices slices when there is one.
int launch_wide(const float* yty, const float* corr, const float* bvec, const float* n_b, float reg, float* x,
                int B, int k, float* ws, int ws_slices, cudaStream_t stream) {
  const WideLayout w(k);
  const bool staged = ws == nullptr && w.floats(true) * (int)sizeof(float) <= WIDE_STAGE_MAX;
  const int smem = ws != nullptr ? 0 : w.floats(staged) * (int)sizeof(float);
  const int smem_half = ws != nullptr ? 0 : w.floats(false) * (int)sizeof(float);
  static std::mutex lock;
  static int sms[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  int per_sm = 0, per_sm_half = 0, n_sm = 0;
  {
    const std::lock_guard<std::mutex> hold(lock);
    if (!sms[dev]) {
      int most = 0, n = 0;
      err = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
      if (err == cudaSuccess)
        err = cudaFuncSetAttribute(solve_corrected_wide_kernel<WTHREADS>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, most);
      if (err == cudaSuccess)
        err = cudaFuncSetAttribute(solve_corrected_wide_kernel<WTHREADS / 2>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, most);
      if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
      if (err != cudaSuccess) return (int)err;
      sms[dev] = n;
    }
    n_sm = sms[dev];
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, solve_corrected_wide_kernel<WTHREADS>, WTHREADS,
                                                      smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm_half, solve_corrected_wide_kernel<WTHREADS / 2>,
                                                        WTHREADS / 2, smem_half);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidValue;  // a system too wide for shared memory needs ws
  if (ws != nullptr && ws_slices < 1) return (int)cudaErrorInvalidValue;
  const int busy = ws != nullptr && ws_slices < B ? ws_slices : B;  // systems in flight at most
  if (busy > per_sm * n_sm && per_sm_half >= 2 * per_sm) {
    const int cap = per_sm_half * n_sm;
    solve_corrected_wide_kernel<WTHREADS / 2><<<busy < cap ? busy : cap, WTHREADS / 2, smem_half, stream>>>(
        yty, corr, bvec, n_b, reg, x, B, k, ws, 0);
  } else {
    const int cap = per_sm * n_sm;
    solve_corrected_wide_kernel<WTHREADS><<<busy < cap ? busy : cap, WTHREADS, smem, stream>>>(
        yty, corr, bvec, n_b, reg, x, B, k, ws, (int)staged);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// yty (k, k); corr (B, k, k); bvec (B, k); n_b (B,); x (B, k); all f32; any
// k >= 1. ws is null (k <= 64, or the system fits shared memory) or a
// workspace of ws_slices >= 1 slices of WideLayout(k).floats(false) floats
// (ops/als.py k2_wide_floats), whatever B. Returns cudaGetLastError() after
// the launch (0 = launched), cudaErrorInvalidValue for a system too wide
// for shared memory without a workspace.
extern "C" int solve_corrected_launch(const float* yty, const float* corr,
                                      const float* bvec, const float* n_b,
                                      float reg, float* x, int B, int k,
                                      float* ws, int ws_slices, void* stream) {
  if (k < 1 || B < 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaGetLastError();
  const cudaStream_t st = (cudaStream_t)stream;
  if (k <= 16) return launch_warps<16>(yty, corr, bvec, n_b, reg, x, B, k, st);
  if (k <= 32) return launch_warps<32>(yty, corr, bvec, n_b, reg, x, B, k, st);
  if (k <= KMAX) return launch_warps<64>(yty, corr, bvec, n_b, reg, x, B, k, st);
  return launch_wide(yty, corr, bvec, n_b, reg, x, B, k, ws, ws_slices, st);
}
