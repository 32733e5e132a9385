// K8 segment_dot: CSR segmented gather-multiply-sum
//     out[s] = sum_{j in [indptr[s], indptr[s+1])} x[idx[j]] * val[j]
// (val == nullptr reads as val[j] = 1), in float32. Empty segments give 0.
//
// Replaces: albedo_tpu/ops/sparse_linear.py _segment_sums (:217) and its
// three uses, _bag_term (:235) forward and backward and _rep_term (:263)
// backward. The JAX program reduces by an exclusive cumsum gathered at the
// segment boundaries, because scatters were slow on the TPU; that costs
// eps * |running prefix| of round-off per segment. Here each segment is
// summed directly, so the error is eps * |segment|.
//
//   - bag forward:  x = w (V,) weights,   idx/val = row-sorted flats,   S = N rows;
//   - bag backward: x = g (N,) cotangent, idx/val = vocab-sorted flats, S = V
//     (the vocab indptr spans the whole table, so the gradient has V rows);
//   - rep backward: x = g (N,) cotangent, idx = rep-sorted row order, val
//     null, S = U distinct vectors.
//
// What bounds it on an H100: bytes. Each entry moves an index, a value and
// one 4-byte gather of x (x is small and stays in L2), two flops each: far
// below the FP32 rate. One warp per segment reads its entries coalesced, 32
// at a time, and reduces with shuffles. Segment lengths are heavily skewed
// (a frequent token spans most rows of the vocab-sorted backward), so the
// longest segment is one warp's serial loop and the critical path; an
// nnz-balanced split of long segments over several warps is left for later.
//
// K8g (segment_dot_grid_launch): the same sums for G rows of x at once,
//     out[g, s] = sum_{j in segment s} x[g, idx[j]] * val[j],
// x (G, n_x) and out (G, S) row-major. Replaces _segment_sums under the
// jax.vmap of albedo_tpu/models/logistic_regression.py _lbfgs_fit_many_impl
// (:381), which batches every call over the CV weight grid. A warp reads each
// index and value once for up to GC = 8 rows and keeps one accumulator per
// row (G > 8 runs in chunks of 8 rows, each chunk re-reading the indices).
// Row g sums its terms in K8's order with K8's arithmetic, so each row
// equals K8 on that row bit for bit. Bound: bytes, nnz (8 + 4 G) plus the
// (G, S) output. The longest segment's serial loop does G gathers an entry,
// so a lane issues the loads of U = 4 entries at once to keep more of them
// in flight (a first version, one entry a trip, took 2.5x the time of G
// launches of K8 at the ranker fit's batch on an H100; this one 1.8x).

#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;

__global__ void __launch_bounds__(WARPS * 32) segment_dot_kernel(
    const float* __restrict__ x, const int* __restrict__ idx,
    const float* __restrict__ val, const int* __restrict__ indptr,
    float* __restrict__ out, int S) {
  const int seg = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (seg >= S) return;  // uniform over the warp
  const int lo = indptr[seg];
  const int hi = indptr[seg + 1];
  float acc = 0.0f;
  if (val != nullptr) {
    for (int j = lo + lane; j < hi; j += 32) acc += __ldg(x + idx[j]) * val[j];
  } else {
    for (int j = lo + lane; j < hi; j += 32) acc += __ldg(x + idx[j]);
  }
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) out[seg] = acc;
}

constexpr int GC = 8;  // grid rows per pass over a segment
constexpr int U = 4;   // entries per lane per trip, their loads issued together

__global__ void __launch_bounds__(WARPS * 32) segment_dot_grid_kernel(
    const float* __restrict__ x, long long n_x, const int* __restrict__ idx,
    const float* __restrict__ val, const int* __restrict__ indptr,
    float* __restrict__ out, int S, int G) {
  const int seg = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (seg >= S) return;  // uniform over the warp
  const int lo = indptr[seg];
  const int hi = indptr[seg + 1];
  for (int g0 = 0; g0 < G; g0 += GC) {
    const int gn = min(GC, G - g0);
    const float* xg = x + (long long)g0 * n_x;
    float acc[GC];
#pragma unroll
    for (int g = 0; g < GC; ++g) acc[g] = 0.0f;
    int j = lo + lane;
    // U entries a trip (j, j + 32, ...): every index, value and gather is
    // issued before the first add, and the adds go in entry order, K8's.
    for (; j + 32 * (U - 1) < hi; j += 32 * U) {
      long long i[U];
      float v[U], xv[U][GC];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        i[u] = idx[j + 32 * u];
        v[u] = val != nullptr ? val[j + 32 * u] : 1.0f;
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int g = 0; g < GC; ++g) xv[u][g] = g < gn ? __ldg(xg + g * n_x + i[u]) : 0.0f;
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int g = 0; g < GC; ++g) {
          if (val != nullptr) acc[g] += xv[u][g] * v[u];
          else acc[g] += xv[u][g];
        }
    }
    for (; j < hi; j += 32) {
      const long long i = idx[j];
      const float v = val != nullptr ? val[j] : 1.0f;
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        if (g >= gn) continue;
        const float xv = __ldg(xg + g * n_x + i);
        if (val != nullptr) acc[g] += xv * v;
        else acc[g] += xv;
      }
    }
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      float a = acc[g];
      for (int off = 16; off > 0; off >>= 1) a += __shfl_xor_sync(0xffffffffu, a, off);
      if (lane == 0 && g < gn) out[(long long)(g0 + g) * S + seg] = a;
    }
  }
}

}  // namespace

// x (n_x,) f32; idx (nnz,) int32 in [0, n_x); val (nnz,) f32 or null;
// indptr (S + 1,) int32, nondecreasing, indptr[S] = nnz; out (S,) f32.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int segment_dot_launch(const float* x, const int* idx, const float* val,
                                  const int* indptr, float* out, int S, void* stream) {
  if (S > 0)
    segment_dot_kernel<<<(S + WARPS - 1) / WARPS, WARPS * 32, 0, (cudaStream_t)stream>>>(
        x, idx, val, indptr, out, S);
  return (int)cudaGetLastError();
}

// K8g. x (G, n_x) f32 row-major; idx, val, indptr as above; out (G, S) f32;
// G >= 1. Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int segment_dot_grid_launch(const float* x, long long n_x, const int* idx, const float* val,
                                       const int* indptr, float* out, int S, int G, void* stream) {
  if (G < 1) return (int)cudaErrorInvalidValue;
  if (S > 0)
    segment_dot_grid_kernel<<<(S + WARPS - 1) / WARPS, WARPS * 32, 0, (cudaStream_t)stream>>>(
        x, n_x, idx, val, indptr, out, S, G);
  return (int)cudaGetLastError();
}
