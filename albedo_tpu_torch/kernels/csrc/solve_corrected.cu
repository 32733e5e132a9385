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
// Ranks above KMAX = 64 take the wide path (solve_corrected_wide_kernel),
// a right-looking factorization by one CTA a system, held in dynamic shared
// memory while it fits the 227 KB a block may opt into (k(k + 1) + k floats:
// k up to 240), and beyond that in a global-memory workspace of the same
// layout, one slice per CTA, which the wrapper allocates (the block's
// barriers order its global writes as they do its shared ones).

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

constexpr int WTHREADS = 256;

// ws: null to hold each system in dynamic shared memory, else a workspace of
// B x (k (k + 1) + k) floats, one slice per CTA.
__global__ void __launch_bounds__(WTHREADS) solve_corrected_wide_kernel(
    const float* __restrict__ yty, const float* __restrict__ corr,
    const float* __restrict__ bvec, const float* __restrict__ n_b, float reg,
    float* __restrict__ x, int k, float* ws) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const long long row = blockIdx.x;
  const int lda = k + 1;
  float* A = ws == nullptr ? smem : ws + row * ((long long)k * lda + k);
  float* v = A + (long long)k * lda;
  const float* C = corr + row * k * k;
  const float rn = reg * n_b[row];

  for (int p = tid; p < k * k; p += WTHREADS) {
    const int i = p / k;
    const int j = p - i * k;
    const float a = yty[p] + C[p];
    A[i * lda + j] = (i == j) ? a + rn : a;
  }
  for (int i = tid; i < k; i += WTHREADS) v[i] = bvec[row * k + i];
  __syncthreads();

  for (int j = 0; j < k; ++j) {
    if (tid == 0) A[j * lda + j] = sqrtf(A[j * lda + j]);
    __syncthreads();
    const float d = A[j * lda + j];
    for (int i = j + 1 + tid; i < k; i += WTHREADS) A[i * lda + j] /= d;
    __syncthreads();
    const int n = k - j - 1;
    for (int p = tid; p < n * n; p += WTHREADS) {
      const int ii = j + 1 + p / n;
      const int mm = j + 1 + p % n;
      if (mm <= ii) A[ii * lda + mm] -= A[ii * lda + j] * A[mm * lda + j];
    }
    __syncthreads();
  }
  for (int j = 0; j < k; ++j) {
    if (tid == 0) v[j] /= A[j * lda + j];
    __syncthreads();
    const float vj = v[j];
    for (int i = j + 1 + tid; i < k; i += WTHREADS) v[i] -= A[i * lda + j] * vj;
    __syncthreads();
  }
  for (int j = k - 1; j >= 0; --j) {
    if (tid == 0) v[j] /= A[j * lda + j];
    __syncthreads();
    const float vj = v[j];
    for (int i = tid; i < j; i += WTHREADS) v[i] -= A[j * lda + i] * vj;
    __syncthreads();
  }
  for (int i = tid; i < k; i += WTHREADS) x[row * k + i] = v[i];
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

}  // namespace

// yty (k, k); corr (B, k, k); bvec (B, k); n_b (B,); x (B, k); all f32; any
// k >= 1. ws is null (k <= 64, or the system fits shared memory) or a
// workspace of B x (k (k + 1) + k) floats. Returns cudaGetLastError() after
// the launch (0 = launched).
extern "C" int solve_corrected_launch(const float* yty, const float* corr,
                                      const float* bvec, const float* n_b,
                                      float reg, float* x, int B, int k,
                                      float* ws, void* stream) {
  if (k < 1 || B < 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaGetLastError();
  const cudaStream_t st = (cudaStream_t)stream;
  if (k <= 16) return launch_warps<16>(yty, corr, bvec, n_b, reg, x, B, k, st);
  if (k <= 32) return launch_warps<32>(yty, corr, bvec, n_b, reg, x, B, k, st);
  if (k <= KMAX) return launch_warps<64>(yty, corr, bvec, n_b, reg, x, B, k, st);
  const size_t smem = ws == nullptr ? ((size_t)k * (k + 1) + k) * sizeof(float) : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        solve_corrected_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  solve_corrected_wide_kernel<<<B, WTHREADS, smem, st>>>(yty, corr, bvec, n_b, reg, x, k, ws);
  return (int)cudaGetLastError();
}
