// K10 bpr_step: one BPR minibatch of the ranking factorization, loss and
// gradients, into dense gradient tables.
//
// Replaces: the value_and_grad of loss_fn (:152, with item_score :145) in
// step (:180) of albedo_tpu/models/ranking_factorization.py run (:167):
//     s(b, i)  = <x[u_b], y[i]> + bias[i] + <g[i], w>
//     d_bn     = s(b, pos_b) - s(b, neg_bn)                    (N negatives)
//     loss     = mean_{b,n} softplus(-d_bn)
//              + reg * mean_b (|x[u_b]|^2 + |y[pos_b]|^2 + sum_n |y[neg_bn]|^2)
// With c_bn = -sigmoid(-d_bn) / (B N), the terms added are
//     gx[u_b]     += sum_n c_bn (y[pos_b] - y[neg_bn]) + 2 reg / B x[u_b]
//     gy[pos_b]   += sum_n c_bn x[u_b] + 2 reg / B y[pos_b]
//     gy[neg_bn]  += -c_bn x[u_b] + 2 reg / B y[neg_bn]
//     gbias[pos_b] += sum_n c_bn,  gbias[neg_bn] += -c_bn
//     gw          += sum_{b,n} c_bn (g[pos_b] - g[neg_bn])
// and loss_acc[0] += loss. The Adam update is adam_dense.cu, over the flat
// buffer that holds x, y, bias and w (optax.adam treats every element
// alike).
//
// What bounds it on an H100: atomics and bytes. A pair reads 2 + N factor
// rows (r floats each) and adds as many rows into the gradients, a few
// flops per element read. One warp per pair keeps x[u] and y[pos] and their
// gradient sums in registers (r <= RMAX, each lane a strided slice; lane j
// also holds side feature j, d <= 32), reduces each score with shuffles, and
// adds into the tables with atomicAdd: hot users and items repeat within a
// batch and negatives are drawn with replacement, so two warps may add into
// one row at once and the sum order (and the last bits) changes from run to
// run. The loss and gw are reduced over the CTA's pairs in shared memory
// and added with one atomic each per CTA.
//
// Ranks above RMAX and side widths above DMAX take the wide path
// (bpr_step_wide_kernel): the same warp per pair, holding no row in
// registers. Each score is one strided pass over r and d (the rows read from
// L2); each negative's terms go into gx[u], gy[neg] and gw with atomics as
// soon as its c_bn is known, and the positive's after the last negative:
// any width, more atomics than the narrow path, for widths no job of the
// repo runs.

#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;
constexpr int RMAX = 128;
constexpr int PER_LANE = RMAX / 32;
constexpr int DMAX = 32;

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float softplus(float z) {
  return fmaxf(z, 0.0f) + log1pf(expf(-fabsf(z)));
}

__global__ void __launch_bounds__(WARPS * 32) bpr_step_kernel(
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ bias, const float* __restrict__ w,
    const float* __restrict__ g, const int* __restrict__ users,
    const int* __restrict__ pos, const int* __restrict__ neg,
    float* __restrict__ gx, float* __restrict__ gy, float* __restrict__ gbias,
    float* __restrict__ gw, float* __restrict__ loss_acc, int B, int N, int r,
    int d, float reg) {
  __shared__ float s_loss[WARPS];
  __shared__ float s_gw[WARPS][DMAX];
  const int wi = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS + wi;
  const float inv_bn = 1.0f / ((float)B * (float)N);
  const float two_reg_b = 2.0f * reg / (float)B;
  float loss = 0.0f;  // the same on every lane
  float gw_l = 0.0f;  // lane j < d: this pair's gw[j]
  if (b < B) {  // uniform over the warp
    const long long u = users[b];
    const long long ip = pos[b];
    const float wl = lane < d ? w[lane] : 0.0f;
    const float gp = lane < d ? g[ip * d + lane] : 0.0f;
    float xu[PER_LANE], yp[PER_LANE], gxu[PER_LANE];
    float dot = gp * wl;
    float sq = 0.0f;  // this lane's share of |x_u|^2 + |y_pos|^2 + sum_n |y_neg|^2
#pragma unroll
    for (int t = 0; t < PER_LANE; ++t) {
      const int c = lane + 32 * t;
      xu[t] = c < r ? x[u * r + c] : 0.0f;
      yp[t] = c < r ? y[ip * r + c] : 0.0f;
      gxu[t] = 0.0f;
      dot += xu[t] * yp[t];
      sq += xu[t] * xu[t] + yp[t] * yp[t];
    }
    const float s_pos = warp_sum(dot) + bias[ip];
    float csum = 0.0f;
    for (int n = 0; n < N; ++n) {
      const long long in = neg[(long long)b * N + n];
      const float gn = lane < d ? g[in * d + lane] : 0.0f;
      float yn[PER_LANE];
      dot = gn * wl;
#pragma unroll
      for (int t = 0; t < PER_LANE; ++t) {
        const int c = lane + 32 * t;
        yn[t] = c < r ? y[in * r + c] : 0.0f;
        dot += xu[t] * yn[t];
        sq += yn[t] * yn[t];
      }
      const float diff = s_pos - (warp_sum(dot) + bias[in]);
      loss += softplus(-diff) * inv_bn;
      const float cb = -inv_bn / (1.0f + expf(diff));  // -sigmoid(-diff) / (B N)
      csum += cb;
      gw_l -= cb * gn;
      float* gyn = gy + in * r;
#pragma unroll
      for (int t = 0; t < PER_LANE; ++t) {
        const int c = lane + 32 * t;
        if (c < r) {
          gxu[t] += cb * (yp[t] - yn[t]);
          atomicAdd(gyn + c, -cb * xu[t] + two_reg_b * yn[t]);
        }
      }
      if (lane == 0) atomicAdd(gbias + in, -cb);
    }
    loss += reg / (float)B * warp_sum(sq);
    gw_l += csum * gp;
    float* gxr = gx + u * r;
    float* gyp = gy + ip * r;
#pragma unroll
    for (int t = 0; t < PER_LANE; ++t) {
      const int c = lane + 32 * t;
      if (c < r) {
        atomicAdd(gxr + c, gxu[t] + two_reg_b * xu[t]);
        atomicAdd(gyp + c, csum * xu[t] + two_reg_b * yp[t]);
      }
    }
    if (lane == 0) atomicAdd(gbias + ip, csum);
  }
  if (lane == 0) s_loss[wi] = loss;
  s_gw[wi][lane] = gw_l;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.0f;
    for (int i = 0; i < WARPS; ++i) s += s_loss[i];
    atomicAdd(loss_acc, s);
  }
  if (threadIdx.x < d) {
    float s = 0.0f;
    for (int i = 0; i < WARPS; ++i) s += s_gw[i][threadIdx.x];
    atomicAdd(gw + threadIdx.x, s);
  }
}

__global__ void __launch_bounds__(WARPS * 32) bpr_step_wide_kernel(
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ bias, const float* __restrict__ w,
    const float* __restrict__ g, const int* __restrict__ users,
    const int* __restrict__ pos, const int* __restrict__ neg,
    float* __restrict__ gx, float* __restrict__ gy, float* __restrict__ gbias,
    float* __restrict__ gw, float* __restrict__ loss_acc, int B, int N, int r,
    int d, float reg) {
  __shared__ float s_loss[WARPS];
  const int wi = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS + wi;
  const float inv_bn = 1.0f / ((float)B * (float)N);
  const float two_reg_b = 2.0f * reg / (float)B;
  float loss = 0.0f;  // the same on every lane
  if (b < B) {  // uniform over the warp
    const float* xu = x + (long long)users[b] * r;
    const long long ip = pos[b];
    const float* yp = y + ip * r;
    const float* gp = g + ip * d;
    float dot = 0.0f;
    float sq = 0.0f;  // this lane's share of |x_u|^2 + |y_pos|^2 + sum_n |y_neg|^2
    for (int c = lane; c < r; c += 32) {
      dot += xu[c] * yp[c];
      sq += xu[c] * xu[c] + yp[c] * yp[c];
    }
    for (int j = lane; j < d; j += 32) dot += gp[j] * w[j];
    const float s_pos = warp_sum(dot) + bias[ip];
    float csum = 0.0f;
    float* gxr = gx + (long long)users[b] * r;
    for (int n = 0; n < N; ++n) {
      const long long in = neg[(long long)b * N + n];
      const float* yn = y + in * r;
      const float* gn = g + in * d;
      dot = 0.0f;
      for (int c = lane; c < r; c += 32) {
        dot += xu[c] * yn[c];
        sq += yn[c] * yn[c];
      }
      for (int j = lane; j < d; j += 32) dot += gn[j] * w[j];
      const float diff = s_pos - (warp_sum(dot) + bias[in]);
      loss += softplus(-diff) * inv_bn;
      const float cb = -inv_bn / (1.0f + expf(diff));  // -sigmoid(-diff) / (B N)
      csum += cb;
      float* gyn = gy + in * r;
      for (int c = lane; c < r; c += 32) {
        atomicAdd(gxr + c, cb * (yp[c] - yn[c]));
        atomicAdd(gyn + c, -cb * xu[c] + two_reg_b * yn[c]);
      }
      for (int j = lane; j < d; j += 32) atomicAdd(gw + j, -cb * gn[j]);
      if (lane == 0) atomicAdd(gbias + in, -cb);
    }
    loss += reg / (float)B * warp_sum(sq);
    float* gyp = gy + ip * r;
    for (int c = lane; c < r; c += 32) {
      atomicAdd(gxr + c, two_reg_b * xu[c]);
      atomicAdd(gyp + c, csum * xu[c] + two_reg_b * yp[c]);
    }
    for (int j = lane; j < d; j += 32) atomicAdd(gw + j, csum * gp[j]);
    if (lane == 0) atomicAdd(gbias + ip, csum);
  }
  if (lane == 0) s_loss[wi] = loss;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.0f;
    for (int i = 0; i < WARPS; ++i) s += s_loss[i];
    atomicAdd(loss_acc, s);
  }
}

}  // namespace

// x (U, r), y (I, r), bias (I,), w (d,), g (I, d) f32; users, pos (B,) and
// neg (B, N) i32 row ids; gx, gy, gbias, gw the gradients of x, y, bias, w,
// added into; loss_acc (1,) f32, added into. Any r >= 1 and d >= 1 (r >
// 128 or d > 32 takes the wide path). Returns cudaGetLastError() after the
// launch (0 = launched).
extern "C" int bpr_step_launch(const float* x, const float* y, const float* bias,
                               const float* w, const float* g, const int* users,
                               const int* pos, const int* neg, float* gx, float* gy,
                               float* gbias, float* gw, float* loss_acc, int B, int N,
                               int r, int d, float reg, void* stream) {
  if (r < 1 || d < 1 || N < 1) return (int)cudaErrorInvalidValue;
  const int grid = (B + WARPS - 1) / WARPS;
  if (B > 0 && r <= RMAX && d <= DMAX)
    bpr_step_kernel<<<grid, WARPS * 32, 0, (cudaStream_t)stream>>>(
        x, y, bias, w, g, users, pos, neg, gx, gy, gbias, gw, loss_acc, B, N, r, d, reg);
  else if (B > 0)
    bpr_step_wide_kernel<<<grid, WARPS * 32, 0, (cudaStream_t)stream>>>(
        x, y, bias, w, g, users, pos, neg, gx, gy, gbias, gw, loss_acc, B, N, r, d, reg);
  return (int)cudaGetLastError();
}
