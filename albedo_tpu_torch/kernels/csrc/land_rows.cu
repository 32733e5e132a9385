// K4 land_rows: land an ALS half-sweep's solved rows in the new factor table,
//     out[r] = landing[r] < n_slots ? pool[landing[r]] : target[landing[r] - n_slots],
// i.e. cat(pool, target)[landing], without concatenating them first. The
// pool holds every group's solved block in group order (K2 and K3 write
// their blocks into it); landing[r] = n_slots + r keeps the old row (a row
// in no bucket).
//
// scatter_rows: K4's scatter_solved, out = target with out[row_ids[i]] =
// solved[i] for every slot i whose id lies in [0, n_target); slots with id -1
// (padding) drop. The old table is copied first (cudaMemcpyAsync on the same
// stream), then one warp per slot writes its row. Row ids are unique.
//
// Replaces: albedo_tpu/ops/als.py scan_half_sweep's landing gather
// (:368-373, pool[landing] from jnp.concatenate(all_solved + [target])) and
// scatter_solved (:50). The JAX program lands by a gather because TPU
// scatters serialize; the gather also suits the card: one warp per output row
// reads its landing slot and copies the k floats coalesced. gramian (:45)
// stays a matmul (torch's, as the JAX package leaves it to XLA).
//
// What bounds it on an H100: bytes, n_target (8 + 8 k) read and written (the
// landing, the solved or kept row, the new row); no arithmetic.

#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;

__global__ void __launch_bounds__(WARPS * 32) land_rows_kernel(
    const float* __restrict__ pool, long long n_slots, const float* __restrict__ target,
    const long long* __restrict__ landing, float* __restrict__ out, int n_target, int k) {
  const long long r = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= n_target) return;  // uniform over the warp
  const long long s = landing[r];
  const float* src = s < n_slots ? pool + s * k : target + (s - n_slots) * k;
  float* dst = out + r * k;
  for (int c = lane; c < k; c += 32) dst[c] = src[c];
}

__global__ void __launch_bounds__(WARPS * 32) scatter_rows_kernel(
    const int* __restrict__ row_ids, const float* __restrict__ solved, float* __restrict__ out,
    int n_slots, int n_target, int k) {
  const long long i = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (i >= n_slots) return;
  const int r = row_ids[i];
  if (r < 0 || r >= n_target) return;  // padding slots (and out-of-range ids) drop
  const float* src = solved + i * k;
  float* dst = out + (long long)r * k;
  for (int c = lane; c < k; c += 32) dst[c] = src[c];
}

}  // namespace

// pool (n_slots, k) f32; target (n_target, k) f32; landing (n_target,) int64
// in [0, n_slots + n_target); out (n_target, k) f32, aliasing neither pool
// nor target. Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int land_rows_launch(const float* pool, long long n_slots, const float* target,
                                const long long* landing, float* out, int n_target, int k, void* stream) {
  if (n_target > 0 && k > 0)
    land_rows_kernel<<<(n_target + WARPS - 1) / WARPS, WARPS * 32, 0, (cudaStream_t)stream>>>(
        pool, n_slots, target, landing, out, n_target, k);
  return (int)cudaGetLastError();
}

// target (n_target, k) f32; row_ids (n_slots,) int32; solved (n_slots, k) f32;
// out (n_target, k) f32 (out == target lands in place). Returns
// cudaGetLastError() after the copy and the launch.
extern "C" int scatter_rows_launch(const float* target, const int* row_ids, const float* solved, float* out,
                                   int n_slots, int n_target, int k, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (out != target && n_target > 0 && k > 0) {
    cudaError_t e = cudaMemcpyAsync(out, target, sizeof(float) * (size_t)n_target * k,
                                    cudaMemcpyDeviceToDevice, s);
    if (e != cudaSuccess) return (int)e;
  }
  if (n_slots > 0 && k > 0)
    scatter_rows_kernel<<<(n_slots + WARPS - 1) / WARPS, WARPS * 32, 0, s>>>(row_ids, solved, out, n_slots,
                                                                             n_target, k);
  return (int)cudaGetLastError();
}
