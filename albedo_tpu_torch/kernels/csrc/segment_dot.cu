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
