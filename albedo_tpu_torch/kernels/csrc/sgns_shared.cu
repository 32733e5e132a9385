// K9s sgns_shared: one skip-gram minibatch with a shared negative pool, loss
// and gradients, into dense gradient tables.
//
// Replaces: albedo_tpu/models/word2vec.py loss_fn (:241), its shared branch
// (:243-257), and the value_and_grad of step (:303), shared_negatives = K > 0.
// With vc_b = in[c_b], vo_b = out[o_b] and the pool's rows vn_k = out[pool_k]:
//     pos_b  = <vc_b, vo_b>,   L_bk = <vc_b, vn_k>          (L = Vc Vn^T, B x K)
//     loss   = mean_b (BCE(pos_b, 1) + s sum_k BCE(L_bk, 0)),   s = negatives / K
//     g_b    = (sigmoid(pos_b) - 1) / B,   G_bk = sigmoid(L_bk) s / B
//     grad_in[c_b]     += g_b vo_b + (G Vn)_b
//     grad_out[o_b]    += g_b vc_b
//     grad_out[pool_k] += (G^T Vc)_k
// and loss_acc[0] += loss. BCE is K9's form, max(x, 0) - x label +
// log1p(exp(-|x|)). The Adam update is adam_dense.cu.
//
// What bounds it on an H100: operations. At the reference scale (B 65536,
// d 200, K 512) the three products are 3 x 2 B d K = 40 GFLOP a step, about
// 0.6 ms at the FP32 peak, against 128 MiB of G and a few MB of rows. The
// positive term is K9's per-pair warp with K = 0 (pos_kernel). The negative
// term is three tiled FP32 GEMMs on the CUDA cores (64 x 64 output tiles,
// 16-deep slices in shared memory, a 4 x 4 block of outputs a thread), each
// with its row gathers in the load stage:
//   logits_kernel:   L = Vc Vn^T, epilogue sigmoid and BCE: writes G and adds
//                    the tile's loss with one atomic;
//   grad_in_kernel:  G Vn, each output row added into grad_in[c_b] with
//                    atomics (centers repeat within a batch);
//   grad_out_kernel: G^T Vc, a sum over all B pairs for only K x d outputs,
//                    so the B axis is split over the grid's z (about 8 CTAs
//                    an SM) and each split adds its partial into
//                    grad_out[pool_k] with atomics (pool slots repeat).
// G is materialized (B x K floats, 128 MiB at the reference scale, from a
// workspace the caller allocates once): written once and read twice, about
// 0.12 ms of device memory traffic, where recomputing it in each backward
// product would cost a third GEMM's 13 GFLOP (0.2 ms) twice. Atomic sums run
// in an order that changes from run to run, so the kernel matches its plain
// version to float32 round-off, not bit for bit. Tensor cores (TF32 or bf16
// wgmma) would not keep the float32 products of the JAX program and are later
// work.

#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int PAD = 4;        // keeps each shared row 16-byte aligned, breaks bank strides
constexpr int PAIR_WARPS = 8;
constexpr int TARGET_CTAS = 1056;  // grad_out_kernel's grid: about 8 CTAs per SM of 132

__device__ __forceinline__ float bce_with_logits(float x, float label) {
  return fmaxf(x, 0.0f) - x * label + log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// The sum of v over the CTA, returned to thread 0.
__device__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  float s = 0.0f;
  if (threadIdx.x == 0)
    for (int i = 0; i < (int)(blockDim.x >> 5); ++i) s += red[i];
  return s;
}

// acc[i][j] += sum_kk As[kk][ty 4 + i] Bs[kk][tx 4 + j] over one slice.
__device__ __forceinline__ void mma_slice(const float (*As)[BM + PAD], const float (*Bs)[BN + PAD],
                                          float (&acc)[4][4], int ty, int tx) {
#pragma unroll
  for (int kk = 0; kk < BK; ++kk) {
    const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
    const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
  }
}

// The positive term: one warp per pair (K9's structure with K = 0).
__global__ void __launch_bounds__(PAIR_WARPS * 32) pos_kernel(
    const float* __restrict__ in_t, const float* __restrict__ out_t,
    const int* __restrict__ centers, const int* __restrict__ contexts,
    float* __restrict__ grad_in, float* __restrict__ grad_out, float* __restrict__ loss_acc,
    int B, int d, float inv_b) {
  __shared__ float red[PAIR_WARPS];
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * PAIR_WARPS + (threadIdx.x >> 5);
  float loss = 0.0f;
  if (b < B) {  // uniform over the warp
    const long long c = centers[b], o = contexts[b];
    const float* vc = in_t + c * d;
    const float* vo = out_t + o * d;
    float dot = 0.0f;
    for (int i = lane; i < d; i += 32) dot += vc[i] * vo[i];
    for (int off = 16; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
    const float g = (sigmoid(dot) - 1.0f) * inv_b;
    if (lane == 0) loss = bce_with_logits(dot, 1.0f);  // every lane holds the dot: count it once
    for (int i = lane; i < d; i += 32) {
      atomicAdd(grad_in + c * d + i, g * vo[i]);
      atomicAdd(grad_out + o * d + i, g * vc[i]);
    }
  }
  const float s = block_sum(loss, red);
  if (threadIdx.x == 0) atomicAdd(loss_acc, s * inv_b);
}

// L = Vc Vn^T over (B-tile, K-tile); G = sigmoid(L) gs; loss += ls sum BCE(L, 0).
__global__ void __launch_bounds__(THREADS) logits_kernel(
    const float* __restrict__ in_t, const float* __restrict__ out_t,
    const int* __restrict__ centers, const int* __restrict__ pool, float* __restrict__ G,
    float* __restrict__ loss_acc, int B, int d, int K, float gs, float ls) {
  __shared__ __align__(16) float As[BK][BM + PAD];
  __shared__ __align__(16) float Bs[BK][BN + PAD];
  __shared__ long long arow[BM], brow[BN];
  __shared__ float red[THREADS / 32];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  if (tid < BM) arow[tid] = m0 + tid < B ? (long long)centers[m0 + tid] * d : -1;
  else if (tid < BM + BN) brow[tid - BM] = n0 + tid - BM < K ? (long long)pool[n0 + tid - BM] * d : -1;
  __syncthreads();
  float acc[4][4] = {};
  for (int k0 = 0; k0 < d; k0 += BK) {
#pragma unroll
    for (int q = 0; q < BM * BK / THREADS; ++q) {
      const int e = tid + q * THREADS, r = e / BK, c = e % BK;
      const bool in_k = k0 + c < d;
      As[c][r] = arow[r] >= 0 && in_k ? in_t[arow[r] + k0 + c] : 0.0f;
      Bs[c][r] = brow[r] >= 0 && in_k ? out_t[brow[r] + k0 + c] : 0.0f;
    }
    __syncthreads();
    mma_slice(As, Bs, acc, ty, tx);
    __syncthreads();
  }
  float loss = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (m < B && n < K) {
        const float x = acc[i][j];
        G[(long long)m * K + n] = sigmoid(x) * gs;
        loss += bce_with_logits(x, 0.0f);
      }
    }
  }
  const float s = block_sum(loss, red);
  if (tid == 0) atomicAdd(loss_acc, s * ls);
}

// grad_in[c_b] += (G Vn)_b over (B-tile, d-tile), the sum over the K pool slots.
__global__ void __launch_bounds__(THREADS) grad_in_kernel(
    const float* __restrict__ out_t, const int* __restrict__ centers, const int* __restrict__ pool,
    const float* __restrict__ G, float* __restrict__ grad_in, int B, int d, int K) {
  __shared__ __align__(16) float As[BK][BM + PAD];
  __shared__ __align__(16) float Bs[BK][BN + PAD];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int q = 0; q < BM * BK / THREADS; ++q) {
      const int e = tid + q * THREADS;
      const int r = e / BK, c = e % BK;  // A: row m0 + r of G, slot k0 + c
      As[c][r] = m0 + r < B && k0 + c < K ? G[(long long)(m0 + r) * K + k0 + c] : 0.0f;
      const int kr = e / BN, nc = e % BN;  // B: slot k0 + kr, column n0 + nc
      Bs[kr][nc] = k0 + kr < K && n0 + nc < d ? out_t[(long long)pool[k0 + kr] * d + n0 + nc] : 0.0f;
    }
    __syncthreads();
    mma_slice(As, Bs, acc, ty, tx);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= B) continue;
    float* row = grad_in + (long long)centers[m] * d;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < d) atomicAdd(row + n, acc[i][j]);
    }
  }
}

// grad_out[pool_k] += (G^T Vc)_k over (K-tile, d-tile), the sum over pairs
// [z chunk, (z + 1) chunk).
__global__ void __launch_bounds__(THREADS) grad_out_kernel(
    const float* __restrict__ in_t, const int* __restrict__ centers, const int* __restrict__ pool,
    const float* __restrict__ G, float* __restrict__ grad_out, int B, int d, int K, int chunk) {
  __shared__ __align__(16) float As[BK][BM + PAD];
  __shared__ __align__(16) float Bs[BK][BN + PAD];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int b0 = blockIdx.z * chunk, b1 = min(B, b0 + chunk);
  float acc[4][4] = {};
  for (int k0 = b0; k0 < b1; k0 += BK) {
#pragma unroll
    for (int q = 0; q < BM * BK / THREADS; ++q) {
      const int e = tid + q * THREADS;
      const int r = e / BM, c = e % BM;  // pair k0 + r: A is G's slot m0 + c, B is Vc's column n0 + c
      const bool in_b = k0 + r < b1;
      As[r][c] = in_b && m0 + c < K ? G[(long long)(k0 + r) * K + m0 + c] : 0.0f;
      Bs[r][c] = in_b && n0 + c < d ? in_t[(long long)centers[k0 + r] * d + n0 + c] : 0.0f;
    }
    __syncthreads();
    mma_slice(As, Bs, acc, ty, tx);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= K) continue;
    float* row = grad_out + (long long)pool[m] * d;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < d) atomicAdd(row + n, acc[i][j]);
    }
  }
}

}  // namespace

// in_t, out_t (V, d) f32; centers, contexts (B,) int32; pool (K,) int32, may
// repeat; grad_in, grad_out (V, d) f32, added into; loss_acc (1,) f32, added
// into; G (B, K) f32 workspace, overwritten; neg_scale = negatives / K. Any
// d >= 1. Four launches on the stream; returns the first launch error (0 =
// all launched).
extern "C" int sgns_shared_launch(const float* in_t, const float* out_t, const int* centers,
                                  const int* contexts, const int* pool, float* grad_in,
                                  float* grad_out, float* loss_acc, float* G, int B, int d, int K,
                                  float neg_scale, void* stream_) {
  if (B <= 0) return (int)cudaGetLastError();
  cudaStream_t stream = (cudaStream_t)stream_;
  const float inv_b = 1.0f / (float)B;
  cudaError_t err;
  pos_kernel<<<(B + PAIR_WARPS - 1) / PAIR_WARPS, PAIR_WARPS * 32, 0, stream>>>(
      in_t, out_t, centers, contexts, grad_in, grad_out, loss_acc, B, d, inv_b);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (K <= 0) return 0;
  const int mt = (B + BM - 1) / BM, kt = (K + BN - 1) / BN, dt = (d + BN - 1) / BN;
  const float gs = neg_scale * inv_b;
  logits_kernel<<<dim3(mt, kt), THREADS, 0, stream>>>(in_t, out_t, centers, pool, G, loss_acc, B, d, K,
                                                       gs, gs);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  grad_in_kernel<<<dim3(mt, dt), THREADS, 0, stream>>>(out_t, centers, pool, G, grad_in, B, d, K);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int tiles = ((K + BM - 1) / BM) * dt;
  const int slices = (B + BK - 1) / BK;
  int splits = (TARGET_CTAS + tiles - 1) / tiles;
  splits = splits < 1 ? 1 : (splits > slices ? slices : splits);
  const int chunk = ((slices + splits - 1) / splits) * BK;
  splits = (B + chunk - 1) / chunk;
  grad_out_kernel<<<dim3((K + BM - 1) / BM, dt, splits), THREADS, 0, stream>>>(
      in_t, centers, pool, G, grad_out, B, d, K, chunk);
  return (int)cudaGetLastError();
}
