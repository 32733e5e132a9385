// logloss: the LR objective's value and its gradient with respect to the
// logits in one launch, for one model or a grid of G models:
//     loss[g]   = sum_i w[g,i] ce(z[g,i], y[i]) / W[g] + half_reg sum_{k>0} theta[g,k]^2
//     dz[g,i]   = (1 / W[g]) w[g,i] ce'(z[g,i], y[i])
//     bias[g]   = sum_i dz[g,i]          (the gradient of the unpenalized bias)
//     pen[g,k]  = reg theta[g,k], pen[g,0] = 0
// with W[g] = sum_i w[g,i] (the caller's, once a fit) and the logits z from
// K8c (gather_sum.cu).
//
// Replaces: the elementwise work and the reductions of
// albedo_tpu/ops/sparse_linear.py weighted_logloss (:371-397) under
// jax.value_and_grad in albedo_tpu/models/logistic_regression.py
// _lbfgs_fit_impl (:363), vmapped over the weight grid in
// _lbfgs_fit_many_impl (:381): XLA fuses them into the fit's while_loop.
// The port's plain version, ops/sparse_linear.py logloss_reference, spells
// the same per-row arithmetic in torch (the autograd objective
// weighted_logloss stays as the plain version of the whole objective).
//
// The gradient rule is the plain version's: the pre-clip at +-1e6 has slope
// 1 inside and at the edges (torch's clamp), 0 outside; the straight-through
// clip at +-35 passes the gradient; at a logit of exactly 0, max(z, 0) has
// slope 0.5 and |z| slope +1 (JAX's maximum and abs). So at the zero init
// dz = -w y / W. A zero weight row gives 0 / 0: NaN, as the plain version.
//
// The same bits on every call: each CTA sums its rows in a fixed order (a
// thread's ITEMS rows, then a shuffle tree, then the warps' sums), writes its
// partials, and the last CTA of a grid row by ticket adds the row's partials
// in index order and resets the ticket, so a CUDA graph replays the launch.
// No float atomics; every add and multiply is an explicit round-to-nearest
// intrinsic (nvcc never contracts them into an FMA), exp and log1p are the
// precise expf / log1pf (no fast math).
//
// What bounds it on an H100: bytes. It reads z, w (G N each), y (N) and theta
// (G P) and writes dz (G N) and pen (G P): 4 (3 G N + N + 2 G P) bytes, ~4 MB
// for one model of the ranker job, against ~20 operations a row. One pass,
// coalesced, a thread ITEMS rows.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 8;
constexpr int CHUNK = THREADS * ITEMS;  // rows (and parameters) a CTA
constexpr int WARPS = THREADS / 32;
constexpr float PRE_CLIP = 1e6f;
constexpr float CE_CLIP = 35.0f;

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
// torch.clamp: NaN stays NaN.
__device__ __forceinline__ float clamp(float x, float lo, float hi) { return x < lo ? lo : (x > hi ? hi : x); }

// A block's sum, in a fixed order: each warp by a shuffle tree, then warp 0
// over the warps' sums. Thread 0 holds it; every thread must call.
__device__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v = add(v, __shfl_down_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // red is free again
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = 0.0f;
  if (warp == 0) {
    v = lane < WARPS ? red[lane] : 0.0f;
    for (int o = 16; o > 0; o >>= 1) v = add(v, __shfl_down_sync(0xffffffffu, v, o));
  }
  return v;
}

__global__ void __launch_bounds__(THREADS) logloss_kernel(
    const float* __restrict__ z, const float* __restrict__ y, const float* __restrict__ w,
    const float* __restrict__ wsum, const float* __restrict__ theta, int N, int P, int nb, float reg,
    float half_reg, float* __restrict__ loss, float* __restrict__ dz, float* __restrict__ bias,
    float* __restrict__ pen, float* __restrict__ partials, unsigned* __restrict__ tickets) {
  __shared__ float red[WARPS];
  __shared__ bool last;
  const int g = blockIdx.y;
  const float W = wsum[g];
  const float inv = div(1.0f, W);
  const float* zg = z + (size_t)g * N;
  const float* wg = w + (size_t)g * N;
  float* dzg = dz + (size_t)g * N;
  const float* tg = theta + (size_t)g * P;
  float* pg = pen + (size_t)g * P;
  float s_ce = 0.0f, s_dz = 0.0f, s_pen = 0.0f;
  const long long first = (long long)blockIdx.x * CHUNK + threadIdx.x;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const long long i = first + (long long)j * THREADS;
    if (i < N) {
      const float zi = zg[i], yi = y[i], wi = wg[i];
      const bool inside = zi >= -PRE_CLIP && zi <= PRE_CLIP;
      const float z1 = clamp(zi, -PRE_CLIP, PRE_CLIP);
      const float z2 = add(z1, sub(clamp(z1, -CE_CLIP, CE_CLIP), z1));  // straight-through: its value
      const float e = expf(-(z2 >= 0.0f ? z2 : -z2));
      const float m = (z2 >= 0.0f || isnan(z2)) ? z2 : 0.0f;  // torch.maximum(z2, 0)
      const float ce = add(sub(m, mul(z2, yi)), log1pf(e));
      const float dm = z2 > 0.0f ? 1.0f : (z2 == 0.0f ? 0.5f : 0.0f);
      const float sign = z2 >= 0.0f ? 1.0f : -1.0f;
      const float dce = sub(sub(dm, yi), mul(sign, div(e, add(1.0f, e))));
      const float d = inside ? mul(mul(inv, wi), dce) : 0.0f;
      dzg[i] = d;
      s_ce = add(s_ce, mul(wi, ce));
      s_dz = add(s_dz, d);
    }
    if (i < P) {
      const float t = tg[i];
      pg[i] = i == 0 ? 0.0f : mul(reg, t);
      if (i > 0) s_pen = add(s_pen, mul(t, t));
    }
  }
  s_ce = block_sum(s_ce, red);
  s_dz = block_sum(s_dz, red);
  s_pen = block_sum(s_pen, red);
  if (threadIdx.x == 0) {
    float* part = partials + ((size_t)g * nb + blockIdx.x) * 3;
    part[0] = s_ce;
    part[1] = s_dz;
    part[2] = s_pen;
    __threadfence();
    last = atomicAdd(tickets + g, 1u) == (unsigned)(nb - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // The row's last CTA: its partials in index order (L1 bypassed: other SMs wrote them).
  float a_ce = 0.0f, a_dz = 0.0f, a_pen = 0.0f;
  for (int p = threadIdx.x; p < nb; p += THREADS) {
    const float* part = partials + ((size_t)g * nb + p) * 3;
    a_ce = add(a_ce, __ldcg(part));
    a_dz = add(a_dz, __ldcg(part + 1));
    a_pen = add(a_pen, __ldcg(part + 2));
  }
  a_ce = block_sum(a_ce, red);
  a_dz = block_sum(a_dz, red);
  a_pen = block_sum(a_pen, red);
  if (threadIdx.x == 0) {
    loss[g] = add(div(a_ce, W), mul(half_reg, a_pen));
    bias[g] = a_dz;
    tickets[g] = 0u;  // zero for the next launch
  }
}

// CTAs a grid row (mirrored by albedo_tpu_torch/ops/sparse_linear.py
// logloss_ctas): one CHUNK of rows and of parameters each.
int logloss_ctas(int N, int P) {
  const int rows = (N + CHUNK - 1) / CHUNK, params = (P + CHUNK - 1) / CHUNK;
  const int n = rows > params ? rows : params;
  return n > 0 ? n : 1;
}

}  // namespace

// z, w (G, N) f32; y (N,) f32; wsum (G,) f32; theta (G, P) f32; loss (G,),
// dz (G, N), bias (G,) (may be a slice of a larger buffer), pen (G, P) f32
// outputs; partials (G * nb * 3,) f32 and tickets (G,) u32 a workspace whose
// tickets are 0 before the launch (and are again after it); nb =
// logloss_ctas(N, P). Returns cudaGetLastError() after the launch.
extern "C" int logloss_launch(const float* z, const float* y, const float* w, const float* wsum,
                              const float* theta, int G, int N, int P, float reg, float half_reg, float* loss,
                              float* dz, float* bias, float* pen, float* partials, unsigned* tickets, int nb,
                              void* stream) {
  if (G < 1 || G > 65535 || N < 0 || P < 1 || nb != logloss_ctas(N, P)) return (int)cudaErrorInvalidValue;
  logloss_kernel<<<dim3(nb, G), THREADS, 0, (cudaStream_t)stream>>>(z, y, w, wsum, theta, N, P, nb, reg, half_reg,
                                                                     loss, dz, bias, pen, partials, tickets);
  return (int)cudaGetLastError();
}
