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
// contiguous.
//
// What bounds it on an H100: the gathered rows. Each entry reads one B-float
// row of x (x is a few MB to 30 MB and stays in the 50 MB L2), for 2 B flops;
// the rows come from L2 at random, nnz B 4 bytes a pass (2.46 GB at the
// bench's item block), far above the bytes counted once. The design keeps
// as many gathered rows in flight as it can and nothing else in the way:
//   - a warp walks one unit of entries, each lane holding 8 consecutive
//     columns of B (two 16-byte loads a row where B is a multiple of 4),
//     256 columns a pass (grid y); the warp loads the indices and values of
//     32 entries at once and broadcasts them by shuffle, 4 rows in flight
//     (~74 registers; kernels/spmm_sgns_bench.py variants: 8 rows in flight
//     or 8 warps a CTA were 6-13% slower); no shared memory and no barrier;
//   - a unit is a whole row up to SPMM_CHUNK entries, or a chunk of that many
//     entries of a longer row (the CSC's power-law columns: 1089 entries at
//     the job, 6690 at the bench). A chunk writes its partial to a
//     workspace and spmm_finish_kernel adds a row's chunks in chunk order.
//     The units are a plan built on the host once per matrix (ops/spmm.py
//     spmm_plan);
//   - B = 1 (row sums, the weighted column sums): a warp a row, a lane an
//     entry, then a fixed butterfly of shuffles.
// The sums are kept in float64 (each float32 product is exact in it) and
// rounded to float32 once, as the plain version does, so the two agree to a
// rounding whatever their order: summed in float32, the first kernel and the
// plain version's atomics drifted apart by up to 4.4e-5 of the terms' mass
// on 6690-entry rows. Every sum runs in an order fixed by the inputs and the
// plan, so the same inputs give the same bits.

#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 4;           // warps (units) a CTA (8 ran 6% slower)
constexpr int PER_LANE = 8;        // columns a lane
constexpr int COLS = 32 * PER_LANE;
constexpr int UNROLL = 4;          // gathered rows in flight a warp
constexpr int FINISH_THREADS = 256;

// units: (row, lo, hi, slot): entries [lo, hi) of row; slot < 0 writes
// out[row], else the float64 partial ws[slot].
template <int VEC>
__global__ void __launch_bounds__(WARPS * 32) spmm_units_kernel(
    const float* __restrict__ x, const int4* __restrict__ units, int n_units, const int* __restrict__ idx,
    const float* __restrict__ val, float* __restrict__ out, double* __restrict__ ws, int B) {
  const int unit = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (unit >= n_units) return;  // uniform over the warp
  const int4 u = units[unit];
  const int c0 = blockIdx.y * COLS + lane * PER_LANE;
  double acc[PER_LANE];
#pragma unroll
  for (int t = 0; t < PER_LANE; ++t) acc[t] = 0.0;
  for (int base = u.y; base < u.z; base += 32) {
    const int e = base + lane;
    const int my_idx = e < u.z ? __ldg(idx + e) : 0;
    const float my_val = e < u.z ? (val == nullptr ? 1.0f : __ldg(val + e)) : 0.0f;
    const int cnt = min(32, u.z - base);
    for (int t0 = 0; t0 < cnt; t0 += UNROLL) {
      float xv[UNROLL][PER_LANE];
      double v[UNROLL];
#pragma unroll
      for (int r = 0; r < UNROLL; ++r) {
        const int src = t0 + r < cnt ? t0 + r : 0;
        const int row = __shfl_sync(0xffffffffu, my_idx, src);
        v[r] = t0 + r < cnt ? (double)__shfl_sync(0xffffffffu, my_val, src) : 0.0;
        const float* xr = x + (long long)row * B + c0;
        if constexpr (VEC == 4) {
#pragma unroll
          for (int h = 0; h < PER_LANE; h += 4) {
            float4 q = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            if (t0 + r < cnt && c0 + h < B) q = __ldg(reinterpret_cast<const float4*>(xr + h));
            xv[r][h] = q.x, xv[r][h + 1] = q.y, xv[r][h + 2] = q.z, xv[r][h + 3] = q.w;
          }
        } else {
#pragma unroll
          for (int h = 0; h < PER_LANE; ++h) xv[r][h] = t0 + r < cnt && c0 + h < B ? __ldg(xr + h) : 0.0f;
        }
      }
#pragma unroll
      for (int r = 0; r < UNROLL; ++r)
#pragma unroll
        for (int h = 0; h < PER_LANE; ++h) acc[h] = fma(v[r], (double)xv[r][h], acc[h]);
    }
  }
  if (u.w < 0) {
    float* o = out + (long long)u.x * B + c0;
#pragma unroll
    for (int h = 0; h < PER_LANE; ++h)
      if (c0 + h < B) o[h] = (float)acc[h];
  } else {
    double* o = ws + (long long)u.w * B + c0;
#pragma unroll
    for (int h = 0; h < PER_LANE; ++h)
      if (c0 + h < B) o[h] = acc[h];
  }
}

// long_rows: (row, first slot, slots): out[row] = the row's chunk partials
// added in chunk order, rounded once.
__global__ void __launch_bounds__(FINISH_THREADS) spmm_finish_kernel(
    const int* __restrict__ long_rows, const double* __restrict__ ws, float* __restrict__ out, int B) {
  const int* lr = long_rows + 3 * blockIdx.x;
  const int row = lr[0], first = lr[1], n = lr[2];
  for (int b = blockIdx.y * FINISH_THREADS + threadIdx.x; b < B; b += gridDim.y * FINISH_THREADS) {
    double sum = 0.0;
    for (int i = 0; i < n; ++i) sum += ws[(long long)(first + i) * B + b];
    out[(long long)row * B + b] = (float)sum;
  }
}

// B = 1: a warp a row, a lane an entry, a fixed butterfly.
__global__ void __launch_bounds__(WARPS * 32) spmm_vec_kernel(
    const float* __restrict__ x, const int* __restrict__ indptr, const int* __restrict__ idx,
    const float* __restrict__ val, float* __restrict__ out, int S) {
  const int s = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (s >= S) return;  // uniform over the warp
  const int lo = indptr[s], hi = indptr[s + 1];
  double acc = 0.0;
  for (int e = lo + lane; e < hi; e += 32)
    acc = fma(val == nullptr ? 1.0 : (double)__ldg(val + e), (double)__ldg(x + __ldg(idx + e)), acc);
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0) out[s] = (float)acc;
}

}  // namespace

// x (n_x, B) f32; indptr (S + 1,) i32, nondecreasing, indptr[S] = nnz;
// idx (nnz,) i32 in [0, n_x); val (nnz,) f32 or null; out (S, B) f32.
// units (n_units, 4) i32 and long_rows (n_long, 3) i32: the plan of
// ops/spmm.py spmm_plan, covering every row once; ws (n_slots, B) f64 for
// the chunks' partials. B = 1 reads indptr and no plan. Returns
// cudaGetLastError() after the launches (0 = launched).
extern "C" int spmm_rows_launch(const float* x, const int* indptr, const int* idx, const float* val, float* out,
                                const int* units, int n_units, const int* long_rows, int n_long, double* ws, int S,
                                int B, void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  if (S <= 0 || B <= 0) return (int)cudaGetLastError();
  if (B == 1) {
    spmm_vec_kernel<<<(S + WARPS - 1) / WARPS, WARPS * 32, 0, stream>>>(x, indptr, idx, val, out, S);
    return (int)cudaGetLastError();
  }
  const dim3 grid((n_units + WARPS - 1) / WARPS, (B + COLS - 1) / COLS);
  if (B % 4 == 0 && reinterpret_cast<unsigned long long>(x) % 16 == 0)
    spmm_units_kernel<4><<<grid, WARPS * 32, 0, stream>>>(x, reinterpret_cast<const int4*>(units), n_units, idx, val,
                                                          out, ws, B);
  else
    spmm_units_kernel<1><<<grid, WARPS * 32, 0, stream>>>(x, reinterpret_cast<const int4*>(units), n_units, idx, val,
                                                          out, ws, B);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_long == 0) return (int)err;
  spmm_finish_kernel<<<dim3(n_long, (B + FINISH_THREADS - 1) / FINISH_THREADS), FINISH_THREADS, 0, stream>>>(
      long_rows, ws, out, B);
  return (int)cudaGetLastError();
}
