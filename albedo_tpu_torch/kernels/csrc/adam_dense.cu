// adam_dense: one dense Adam step over a parameter table, fused with
// zeroing its gradient for the next step.
//
// Replaces: the optax.adam(0.025) update of albedo_tpu/models/word2vec.py
// step (:303) on the "in" and "out" tables (K9's optimizer half). Every
// element moves every step, as optax's dense Adam does (a lazy sparse Adam
// would compute another function):
//     m = (1 - b1) g + b1 m,  v = (1 - b2) g^2 + b2 v
//     p = p - lr * (m / bc1) / (sqrt(v / bc2) + eps),  g = 0
// with bc1 = 1 - b1^t and bc2 = 1 - b2^t for step t (count after the
// increment), computed by the caller in float32 as optax does. The caller
// passes them by value, or as a pointer to the pair (bc1, bc2) in device
// memory: a fit captured as a CUDA graph reads each step's pair from a table
// it refills before each replay, where values passed by value would be
// those of the captured step in every replay.
//
// What bounds it on an H100: bytes. Each element reads p, g, m, v and writes
// p, g, m, v (32 bytes) for about 15 flops. A grid-stride loop of
// coalesced float loads; nothing is staged in shared memory.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS) adam_dense_kernel(
    float* __restrict__ p, float* __restrict__ g, float* __restrict__ m,
    float* __restrict__ v, long long n, float lr, float b1, float b2,
    float one_minus_b1, float one_minus_b2, float eps, float bc1, float bc2,
    const float* __restrict__ bias) {
  if (bias != nullptr) {
    bc1 = bias[0];
    bc2 = bias[1];
  }
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const float gi = g[i];
    const float mi = one_minus_b1 * gi + b1 * m[i];
    const float vi = one_minus_b2 * (gi * gi) + b2 * v[i];
    m[i] = mi;
    v[i] = vi;
    const float upd = (mi / bc1) / (sqrtf(vi / bc2) + eps);
    p[i] = p[i] + (-lr) * upd;
    g[i] = 0.0f;
  }
}

}  // namespace

// p, g, m, v (n,) f32, updated in place; bias, if not null, the (2,) f32
// pair (bc1, bc2) on the device, read in place of bc1 and bc2. Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int adam_dense_launch(float* p, float* g, float* m, float* v, long long n,
                                 float lr, float b1, float b2, float one_minus_b1,
                                 float one_minus_b2, float eps, float bc1, float bc2,
                                 const float* bias, void* stream) {
  if (n > 0) {
    long long blocks = (n + THREADS - 1) / THREADS;
    if (blocks > 132 * 16) blocks = 132 * 16;
    adam_dense_kernel<<<(int)blocks, THREADS, 0, (cudaStream_t)stream>>>(
        p, g, m, v, n, lr, b1, b2, one_minus_b1, one_minus_b2, eps, bc1, bc2, bias);
  }
  return (int)cudaGetLastError();
}
