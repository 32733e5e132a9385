// K9 sgns_step: one skip-gram negative-sampling minibatch, loss and
// gradients, into dense gradient tables.
//
// Replaces: albedo_tpu/models/word2vec.py loss_fn (:241) and the
// value_and_grad of step (:303) inside epoch (:291), shared_negatives = 0:
//     rows_b   = [o_b, neg_b1 .. neg_bK]                      (1 + K rows)
//     logit_bk = <in[c_b], out[rows_bk]>,  label_bk = (k == 0)
//     loss     = mean_b sum_k BCE(logit_bk, label_bk)
// For each pair b and row k, with g_bk = (sigmoid(logit_bk) - label_bk) / B:
//     grad_in[c_b]        += g_bk * out[rows_bk]
//     grad_out[rows_bk]   += g_bk * in[c_b]
// and loss_acc[0] += loss (summed over calls: the caller divides by the
// number of steps for the epoch mean). The Adam update is adam_dense.cu.
//
// What bounds it on an H100: bytes and atomics. A pair reads (2 + K) rows of
// d floats and adds (2 + K) rows into the gradients, about 4 flops per
// element read. One warp per pair keeps in[c] and its grad_in sum in
// registers (d <= DMAX, each lane a strided slice), reduces each logit with
// shuffles, and adds into the tables with atomicAdd: frequent words repeat
// as centers and as negatives within a batch, so two warps may add into one
// row at once, and the sum order (and the last bits) changes from run to
// run. The loss is reduced over the CTA's pairs in shared memory and added
// with one atomic per CTA.
//
// Embeddings wider than DMAX take the wide path (sgns_step_wide_kernel): the
// same warp per pair, but no row is held in registers. For each of its 1 + K
// rows the warp forms the logit in one strided pass over d (in[c] and the
// row read from L2), then adds g * row into grad_in[c] and g * in[c] into
// grad_out[row] in a second pass, with atomics: any d, (1 + K) times the
// narrow path's grad_in atomics, for a width no job of the repo runs.

#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;
constexpr int DMAX = 512;
constexpr int PER_LANE = DMAX / 32;

__device__ __forceinline__ float bce_with_logits(float x, float label) {
  return fmaxf(x, 0.0f) - x * label + log1pf(expf(-fabsf(x)));
}

__global__ void __launch_bounds__(WARPS * 32) sgns_step_kernel(
    const float* __restrict__ in_t, const float* __restrict__ out_t,
    const int* __restrict__ centers, const int* __restrict__ contexts,
    const int* __restrict__ negs, float* __restrict__ grad_in,
    float* __restrict__ grad_out, float* __restrict__ loss_acc, int B, int d,
    int K, float inv_b) {
  __shared__ float pair_loss[WARPS];
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS + w;
  float loss = 0.0f;
  if (b < B) {  // uniform over the warp
    const long long c = centers[b];
    float vc[PER_LANE];
    float gin[PER_LANE];
#pragma unroll
    for (int t = 0; t < PER_LANE; ++t) {
      const int i = lane + 32 * t;
      vc[t] = i < d ? in_t[c * d + i] : 0.0f;
      gin[t] = 0.0f;
    }
    for (int k = 0; k <= K; ++k) {
      const long long row = k == 0 ? contexts[b] : negs[(long long)b * K + (k - 1)];
      const float* vo = out_t + row * d;
      float vr[PER_LANE];
      float dot = 0.0f;
#pragma unroll
      for (int t = 0; t < PER_LANE; ++t) {
        const int i = lane + 32 * t;
        vr[t] = i < d ? vo[i] : 0.0f;
        dot += vc[t] * vr[t];
      }
      for (int off = 16; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
      const float label = k == 0 ? 1.0f : 0.0f;
      const float g = (1.0f / (1.0f + expf(-dot)) - label) * inv_b;
      loss += bce_with_logits(dot, label);
      float* go = grad_out + row * d;
#pragma unroll
      for (int t = 0; t < PER_LANE; ++t) {
        const int i = lane + 32 * t;
        if (i < d) {
          gin[t] += g * vr[t];
          atomicAdd(go + i, g * vc[t]);
        }
      }
    }
    float* gi = grad_in + c * d;
#pragma unroll
    for (int t = 0; t < PER_LANE; ++t) {
      const int i = lane + 32 * t;
      if (i < d) atomicAdd(gi + i, gin[t]);
    }
  }
  if (lane == 0) pair_loss[w] = loss;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.0f;
    for (int i = 0; i < WARPS; ++i) s += pair_loss[i];
    atomicAdd(loss_acc, s * inv_b);
  }
}

__global__ void __launch_bounds__(WARPS * 32) sgns_step_wide_kernel(
    const float* __restrict__ in_t, const float* __restrict__ out_t,
    const int* __restrict__ centers, const int* __restrict__ contexts,
    const int* __restrict__ negs, float* __restrict__ grad_in,
    float* __restrict__ grad_out, float* __restrict__ loss_acc, int B, int d,
    int K, float inv_b) {
  __shared__ float pair_loss[WARPS];
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS + w;
  float loss = 0.0f;
  if (b < B) {  // uniform over the warp
    const float* vc = in_t + (long long)centers[b] * d;
    float* gi = grad_in + (long long)centers[b] * d;
    for (int k = 0; k <= K; ++k) {
      const long long row = k == 0 ? contexts[b] : negs[(long long)b * K + (k - 1)];
      const float* vo = out_t + row * d;
      float dot = 0.0f;
      for (int i = lane; i < d; i += 32) dot += vc[i] * vo[i];
      for (int off = 16; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
      const float label = k == 0 ? 1.0f : 0.0f;
      const float g = (1.0f / (1.0f + expf(-dot)) - label) * inv_b;
      loss += bce_with_logits(dot, label);
      float* go = grad_out + row * d;
      for (int i = lane; i < d; i += 32) {
        atomicAdd(gi + i, g * vo[i]);
        atomicAdd(go + i, g * vc[i]);
      }
    }
  }
  if (lane == 0) pair_loss[w] = loss;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.0f;
    for (int i = 0; i < WARPS; ++i) s += pair_loss[i];
    atomicAdd(loss_acc, s * inv_b);
  }
}

}  // namespace

// in_t, out_t (V, d) f32; centers, contexts (B,) int32; negs (B, K) int32;
// grad_in, grad_out (V, d) f32, added into; loss_acc (1,) f32, added into.
// any d >= 1 (d > 512 takes the wide path). Returns cudaGetLastError()
// after the launch (0 = launched).
extern "C" int sgns_step_launch(const float* in_t, const float* out_t, const int* centers,
                                const int* contexts, const int* negs, float* grad_in,
                                float* grad_out, float* loss_acc, int B, int d, int K,
                                void* stream) {
  if (d < 1) return (int)cudaErrorInvalidValue;
  const int grid = (B + WARPS - 1) / WARPS;
  if (B > 0 && d <= DMAX)
    sgns_step_kernel<<<grid, WARPS * 32, 0, (cudaStream_t)stream>>>(
        in_t, out_t, centers, contexts, negs, grad_in, grad_out, loss_acc, B, d, K, 1.0f / (float)B);
  else if (B > 0)
    sgns_step_wide_kernel<<<grid, WARPS * 32, 0, (cudaStream_t)stream>>>(
        in_t, out_t, centers, contexts, negs, grad_in, grad_out, loss_acc, B, d, K, 1.0f / (float)B);
  return (int)cudaGetLastError();
}
