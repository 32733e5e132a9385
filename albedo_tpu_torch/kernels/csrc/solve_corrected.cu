// K2 solve_corrected: the batched Cholesky solve of the implicit-ALS normal
// equations, one k x k system per bucket row.
//
// Replaces: albedo_tpu/ops/als.py solve_corrected (:138), which forms
//     A_b = YtY + corr_b + reg * n_b * I
// and solves A_b x_b = b_b with jnp.linalg.cholesky + cho_solve.
//
// What bounds it on an H100: each system is k^3/3 + 2 k^2 FLOP on 4 (k^2 + k)
// bytes of input, far too little work per system for the tensor cores, and a
// right-looking Cholesky is k dependent steps. Its least time is set by the
// bytes of the (B, k, k) corrections it reads (about 680 MB per bench
// iteration), but in practice it is bound by the latency of those steps,
// far above either bound: one CTA per system holds A in shared memory
// (64 x 64 f32 = 16 KB at most), and the many systems of a bucket (up to
// thousands) are what fill the 132 SMs. Each column step is a scale of the
// column below the pivot and a rank-1 update of the trailing lower triangle,
// spread over the CTA's threads; the two triangular solves follow in place.
// Padding slots (n_b = 0) solve A = YtY: if that is not positive definite the
// square root yields NaN, which propagates without a trap or a branch, as
// the JAX program's does; the landing drops those rows.
//
// Ranks above KMAX = 64 take the wide path (solve_corrected_wide_kernel),
// the same steps on a system of any size held in dynamic shared memory
// while it fits the 227 KB a block may opt into (k(k + 1) + k floats: k up
// to 240), and beyond that in a global-memory workspace of the same layout,
// one slice per CTA, which the wrapper allocates (the block's barriers
// order its global writes as they do its shared ones).

#include <cuda_runtime.h>

namespace {

constexpr int KMAX = 64;
constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS) solve_corrected_kernel(
    const float* __restrict__ yty, const float* __restrict__ corr,
    const float* __restrict__ bvec, const float* __restrict__ n_b, float reg,
    float* __restrict__ x, int k) {
  __shared__ float A[KMAX][KMAX + 1];
  __shared__ float v[KMAX];

  const int tid = threadIdx.x;
  const long long row = blockIdx.x;
  const float* C = corr + row * k * k;
  const float rn = reg * n_b[row];

  for (int p = tid; p < k * k; p += THREADS) {
    const int i = p / k;
    const int j = p - i * k;
    const float a = yty[p] + C[p];
    A[i][j] = (i == j) ? a + rn : a;
  }
  for (int i = tid; i < k; i += THREADS) v[i] = bvec[row * k + i];
  __syncthreads();

  // Right-looking Cholesky, lower triangle, in place.
  for (int j = 0; j < k; ++j) {
    if (tid == 0) A[j][j] = sqrtf(A[j][j]);
    __syncthreads();
    const float d = A[j][j];
    for (int i = j + 1 + tid; i < k; i += THREADS) A[i][j] /= d;
    __syncthreads();
    const int n = k - j - 1;
    for (int p = tid; p < n * n; p += THREADS) {
      const int ii = j + 1 + p / n;
      const int mm = j + 1 + p % n;
      if (mm <= ii) A[ii][mm] -= A[ii][j] * A[mm][j];
    }
    __syncthreads();
  }

  // Forward substitution L y = b.
  for (int j = 0; j < k; ++j) {
    if (tid == 0) v[j] /= A[j][j];
    __syncthreads();
    const float vj = v[j];
    for (int i = j + 1 + tid; i < k; i += THREADS) v[i] -= A[i][j] * vj;
    __syncthreads();
  }
  // Back substitution L^T x = y.
  for (int j = k - 1; j >= 0; --j) {
    if (tid == 0) v[j] /= A[j][j];
    __syncthreads();
    const float vj = v[j];
    for (int i = tid; i < j; i += THREADS) v[i] -= A[j][i] * vj;
    __syncthreads();
  }
  for (int i = tid; i < k; i += THREADS) x[row * k + i] = v[i];
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

}  // namespace

// yty (k, k); corr (B, k, k); bvec (B, k); n_b (B,); x (B, k); all f32; any
// k >= 1. ws is null (k <= 64, or the system fits shared memory) or a
// workspace of B x (k (k + 1) + k) floats. Returns cudaGetLastError() after
// the launch (0 = launched).
extern "C" int solve_corrected_launch(const float* yty, const float* corr,
                                      const float* bvec, const float* n_b,
                                      float reg, float* x, int B, int k,
                                      float* ws, void* stream) {
  if (B > 0 && k <= KMAX) {
    solve_corrected_kernel<<<B, THREADS, 0, (cudaStream_t)stream>>>(
        yty, corr, bvec, n_b, reg, x, k);
  } else if (B > 0) {
    const size_t smem = ws == nullptr ? ((size_t)k * (k + 1) + k) * sizeof(float) : 0;
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          solve_corrected_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    solve_corrected_wide_kernel<<<B, WTHREADS, smem, (cudaStream_t)stream>>>(
        yty, corr, bvec, n_b, reg, x, k, ws);
  }
  return (int)cudaGetLastError();
}
