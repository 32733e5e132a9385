// K11 spmm_rows: CSR sparse times dense, for a batch of B dense columns,
//     out[s, b] = sum_{e in [indptr[s], indptr[s+1])} val[e] * x[idx[e], b]
// (val == nullptr reads as val[e] = 1), in float32. Empty rows give 0.
//
// Replaces the four sparse passes of albedo_tpu/recommenders/cf.py, which
// run over padded row groups as a scanned gather-einsum or scatter-add:
//   - gather_matmul_t (:74), x_blk @ W^T: the CSR of W, x = x_blk^T (n_cols, B);
//   - scatter_matmul (:90), m @ W: the same kernel on the CSR of W^T (the
//     CSC of W), x = m^T (n_rows, B), so no scatter and no atomics;
//   - row_sums (:106), W @ 1: the CSR of W, B = 1, x = 1;
//   - col_weighted_sums (:120), W^T t: the CSC of W, B = 1, x = t.
// The dense operands are (n, B) row-major: the B values of one x row are
// contiguous, so a warp reads 128 contiguous bytes per entry.
//
// What bounds it on an H100: bytes. Each entry reads an index, a value and
// one B-float row of x (x is a few MB and stays in L2), for 2 B flops. One
// CTA per sparse row: its 8 warps split the row's entries (entry lo + w,
// lo + w + 8, ...), each lane keeps 8 column sums in registers (256 columns
// per pass over the row), and the warps' partial sums are added in a fixed
// order through shared memory. Rows are power-law long (the CSC of the star
// matrix has a column of 1089 entries at the job, 6690 at the bench scale),
// so a long row is split over 8 warps instead of one. The sums are kept in
// float64 (each float32 product is exact in it) and rounded to float32 once,
// as the plain version does, so the two agree to a rounding whatever their
// order: summed in float32, this kernel and the plain version's atomics
// drifted apart by up to 4.4e-5 of the terms' mass on 6690-entry rows, too
// close to what one dropped term moves. The float64 sums cost time: about
// 1.5x the float32 kernel's (see PERF.md).

#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;
constexpr int PER_LANE = 8;
constexpr int COLS = 32 * PER_LANE;  // columns per pass over a row

__global__ void __launch_bounds__(WARPS * 32) spmm_rows_kernel(
    const float* __restrict__ x, const int* __restrict__ indptr,
    const int* __restrict__ idx, const float* __restrict__ val,
    float* __restrict__ out, int B) {
  __shared__ double part[WARPS][COLS];
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long s = blockIdx.x;
  const int lo = indptr[s];
  const int hi = indptr[s + 1];
  for (int b0 = 0; b0 < B; b0 += COLS) {
    double acc[PER_LANE];
#pragma unroll
    for (int t = 0; t < PER_LANE; ++t) acc[t] = 0.0;
    for (int e = lo + w; e < hi; e += WARPS) {
      const double v = val == nullptr ? 1.0 : (double)val[e];
      const float* xr = x + (long long)idx[e] * B + b0;
#pragma unroll
      for (int t = 0; t < PER_LANE; ++t) {
        const int b = lane + 32 * t;
        if (b0 + b < B) acc[t] += v * (double)__ldg(xr + b);
      }
    }
#pragma unroll
    for (int t = 0; t < PER_LANE; ++t) part[w][lane + 32 * t] = acc[t];
    __syncthreads();
    for (int b = threadIdx.x; b < COLS && b0 + b < B; b += WARPS * 32) {
      double sum = 0.0;
#pragma unroll
      for (int i = 0; i < WARPS; ++i) sum += part[i][b];
      out[s * B + b0 + b] = (float)sum;
    }
    __syncthreads();
  }
}

}  // namespace

// x (n_x, B) f32; indptr (S + 1,) i32, nondecreasing, indptr[S] = nnz;
// idx (nnz,) i32 in [0, n_x); val (nnz,) f32 or null; out (S, B) f32.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int spmm_rows_launch(const float* x, const int* indptr, const int* idx,
                                const float* val, float* out, int S, int B, void* stream) {
  if (S > 0 && B > 0)
    spmm_rows_kernel<<<S, WARPS * 32, 0, (cudaStream_t)stream>>>(x, indptr, idx, val, out, B);
  return (int)cudaGetLastError();
}
