// lbfgs_direction: the L-BFGS descent direction of one iteration in one
// launch, a CTA a grid row (G rows, 1 for a single fit): optax's
// scale_by_lbfgs(memory_size=m, scale_init_precond=True) followed by
// scale(-1), with the memory's update.
//
// Replaces: the two-loop recursion inside opt.update of
// albedo_tpu/models/logistic_regression.py _lbfgs_loop (:327, the
// optax.lbfgs of :318), vmapped over the weight grid in _lbfgs_fit_many_impl
// (:381). Plain version: albedo_tpu_torch/ops/lbfgs.py
// lbfgs_direction_reference (the port's _LBFGS.direction, torch ops).
//
// For row g, with the iteration count c read from the loop's state on the
// device (the largest of n_iters counts: the rows still running share it):
// - c > 0: the secant pair dw = x - x_prev, du = g - g_prev goes into slot
//   (c - 1) mod m, rho = 1 / <du, dw> (0 where the dot is 0), and the
//   initial scale is <du, dw> / <du, du> (1 where that is not positive);
//   c = 0: the scale is min(1 / ||g||, 1) and the memory is left alone;
// - the two loops over the slots, oldest to newest from c mod m (unwritten
//   slots have rho 0 and change nothing);
// - the direction -vec and its slope <-vec, g>;
// - x and g become the memory's previous point and gradient.
//
// Each of the 2 m + 3 dots is a block sum in a fixed order (a thread's
// strided terms, a shuffle tree, the warps' sums), so a call repeats its
// bits, and a graph replays the host loop's. Every add and multiply is an
// explicit round-to-nearest intrinsic: no FMA, as torch's separate ops.
// A slot reads its two rows in two passes (the dot, then the update), each
// a round trip to L2.
//
// What bounds it on an H100: bytes and latency. It reads each written slot's
// dw and du rows (2 min(c, m) G P floats, 670 KB a row at P 8 382 and m 10)
// and a few more rows; the dots depend on each other, so one CTA a row walks
// them in order. vec (the recursion's vector) stays in shared memory up to
// VEC_SMEM floats (P 8 382: 33 KB); above it, the same kernel keeps vec in a
// global scratch row, each thread reading back only what it wrote.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_M = 64;          // memory slots
constexpr int VEC_SMEM = 49152;    // floats of vec kept in shared memory (192 KB)

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }

// A block's sum in a fixed order, returned to every thread.
__device__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v = add(v, __shfl_down_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // red is free again
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < WARPS ? red[lane] : 0.0f;
    for (int o = 16; o > 0; o >>= 1) v = add(v, __shfl_down_sync(0xffffffffu, v, o));
    if (lane == 0) red[WARPS] = v;
  }
  __syncthreads();
  return red[WARPS];
}

// One slot of the two-loop recursion: vec += coef(<x, vec>) y, the dot a
// block sum. A thread takes its entries k = t, t + THREADS, ... in order.
template <typename Coef>
__device__ __forceinline__ void slot_loop(const float* __restrict__ x, const float* __restrict__ y, float* vec, int P,
                                          float* red, Coef coef) {
  float s = 0.0f;
  for (int k = threadIdx.x; k < P; k += THREADS) s = add(s, mul(x[k], vec[k]));
  const float c = coef(block_sum(s, red));
  for (int k = threadIdx.x; k < P; k += THREADS) vec[k] = add(vec[k], mul(c, y[k]));
}

__global__ void __launch_bounds__(THREADS) lbfgs_direction_kernel(
    const float* __restrict__ grad, const float* __restrict__ params, float* __restrict__ dw,
    float* __restrict__ du, float* __restrict__ rho, float* __restrict__ prev_params,
    float* __restrict__ prev_grad, const int* __restrict__ iters, int n_iters, int G, int P, int m,
    float* __restrict__ updates, float* __restrict__ slope, float* __restrict__ scratch) {
  extern __shared__ float smem[];
  __shared__ float red[WARPS + 1];
  __shared__ float r[MAX_M], alpha[MAX_M];
  const int g = blockIdx.x, t = threadIdx.x;
  float* vec = scratch != nullptr ? scratch + (size_t)g * P : smem;
  int c = 0;
  for (int k = 0; k < n_iters; ++k) c = max(c, iters[k]);
  const int mem = c % m;
  const size_t row = (size_t)g * P;
  const float* gr = grad + row;
  const float* x = params + row;
  float* xp = prev_params + row;
  float* gp = prev_grad + row;
  if (t < m) r[t] = rho[(size_t)t * G + g];
  float scale;
  if (c > 0) {
    const int prev = (c - 1) % m;
    float* dwp = dw + ((size_t)prev * G + g) * P;
    float* dup = du + ((size_t)prev * G + g) * P;
    float s_vd = 0.0f, s_dd = 0.0f;
    for (int k = t; k < P; k += THREADS) {
      const float xk = x[k], gk = gr[k];
      const float a = sub(xk, xp[k]), b = sub(gk, gp[k]);
      dwp[k] = a;
      dup[k] = b;
      xp[k] = xk;
      gp[k] = gk;
      vec[k] = gk;
      s_vd = add(s_vd, mul(b, a));
      s_dd = add(s_dd, mul(b, b));
    }
    const float vdot = block_sum(s_vd, red), denom = block_sum(s_dd, red);
    if (t == 0) {
      const float rp = vdot == 0.0f ? 0.0f : div(1.0f, vdot);
      r[prev] = rp;
      rho[(size_t)prev * G + g] = rp;
    }
    scale = denom > 0.0f ? div(vdot, denom) : 1.0f;
  } else {
    float s_gg = 0.0f;
    for (int k = t; k < P; k += THREADS) {
      const float gk = gr[k];
      xp[k] = x[k];
      gp[k] = gk;
      vec[k] = gk;
      s_gg = add(s_gg, mul(gk, gk));
    }
    const float inv = div(1.0f, __fsqrt_rn(block_sum(s_gg, red)));
    scale = inv > 1.0f ? 1.0f : inv;  // torch.clamp_max(inv, 1): NaN stays NaN
  }
  __syncthreads();  // r[prev] is written
  for (int j = m - 1; j >= 0; --j) {  // newest to oldest: vec -= alpha du, alpha = rho <dw, vec>
    const int i = (mem + j) % m;
    const float* dwi = dw + ((size_t)i * G + g) * P;
    const float* dui = du + ((size_t)i * G + g) * P;
    auto coef = [&](float sum) {
      const float a = mul(r[i], sum);
      if (t == 0) alpha[i] = a;
      return -a;  // v + (-a) d rounds as v - a d
    };
    slot_loop(dwi, dui, vec, P, red, coef);
  }
  for (int k = t; k < P; k += THREADS) vec[k] = mul(scale, vec[k]);
  __syncthreads();  // alpha is written
  for (int j = 0; j < m; ++j) {  // oldest to newest: vec += (alpha - rho <du, vec>) dw
    const int i = (mem + j) % m;
    const float* dwi = dw + ((size_t)i * G + g) * P;
    const float* dui = du + ((size_t)i * G + g) * P;
    auto coef = [&](float sum) { return sub(alpha[i], mul(r[i], sum)); };
    slot_loop(dui, dwi, vec, P, red, coef);
  }
  float s = 0.0f;
  float* u = updates + row;
  for (int k = t; k < P; k += THREADS) {
    const float uk = -vec[k];
    u[k] = uk;
    s = add(s, mul(uk, gr[k]));
  }
  s = block_sum(s, red);
  if (t == 0) slope[g] = s;
}

}  // namespace

// Floats of vec a row keeps in shared memory; above, the caller passes a
// (G, P) f32 scratch.
extern "C" int lbfgs_direction_smem_floats() { return VEC_SMEM; }

// grad, params (G, P) f32; dw, du (m, G, P) f32 and rho (m, G) f32 the
// memory, prev_params and prev_grad (G, P) f32 its previous point and
// gradient, all updated in place; iters (n_iters,) int32 on the device, the
// count the largest of them; updates (G, P) and slope (G,) f32 outputs;
// scratch null for P <= VEC_SMEM, else (G, P) f32. Returns a cudaError_t
// (0 = launched).
extern "C" int lbfgs_direction_launch(const float* grad, const float* params, float* dw, float* du, float* rho,
                                      float* prev_params, float* prev_grad, const int* iters, int n_iters, int G,
                                      int P, int m, float* updates, float* slope, float* scratch, void* stream) {
  if (G < 1 || P < 1 || m < 1 || m > MAX_M || n_iters < 1 || ((P > VEC_SMEM) != (scratch != nullptr)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = scratch != nullptr ? 0 : (size_t)P * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(lbfgs_direction_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  lbfgs_direction_kernel<<<G, THREADS, smem, (cudaStream_t)stream>>>(grad, params, dw, du, rho, prev_params,
                                                                     prev_grad, iters, n_iters, G, P, m, updates,
                                                                     slope, scratch);
  return (int)cudaGetLastError();
}
