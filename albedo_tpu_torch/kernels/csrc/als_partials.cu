// K1 als_partials: the gathered Gramian correction and b-vector of one ALS
// bucket, fused with the row gather.
//
// Replaces: albedo_tpu/ops/als.py bucket_partial_terms (:108) together with
// the gather _gather (:62) that feeds it. For each bucket row b over its L
// padded entries (idx, val, mask):
//     c1_l   = alpha * val_l,   w_l = 1 + c1_l   (both 0 where mask is false)
//     corr_b = sum_l c1_l * y_l y_l^T            (k x k)
//     b_b    = sum_l w_l * y_l                   (k)
// with y_l = source[idx_l].
//
// What bounds it on an H100: the JAX program writes the gathered (B, L, k)
// block to device memory and reads it back for two einsums; at the bench
// shape one such block is 400 MB. Here the block never leaves the chip: one
// CTA per bucket row copies tiles of TILE gathered rows into shared memory
// and accumulates the k*k correction in registers (16 entries per thread at
// k = 64). The entry lists and the source rows (which stay in the 50 MB L2:
// a 30000 x 50 f32 table is 6 MB) are then a small part of the bytes: the
// (B, k, k) correction it writes, and K2 reads back, is most of them (about
// 670 of 744 MB per bench iteration), so its bound is set by bytes, not by
// its 2 k^2 FP32 FLOP per entry. Fusing K1 with K2 removes that round trip.
// It computes the full square rather than the upper triangle (twice the
// FMAs of a symmetric accumulation): each product c1 * (y_i * y_j) is formed
// from the commuted pair, so the result is exactly symmetric. Masked entries
// contribute nothing; entries past the row's last masked-in entry are not
// visited at all, so padding slots (all-false masks) cost one mask scan.
// k is a runtime argument; up to KMAX = 64 (rank 50 pads to 64 inside the
// kernel) one CTA holds the whole k x k correction in registers.
//
// Ranks above 64 take the wide path (als_partials_wide_kernel): a per-thread
// (k, k) accumulator no longer fits in registers, so the correction is cut
// into 64 x 64 output tiles and CTA (b, t) computes tile t of row b,
// streaming the row's entries through shared memory twice as wide (the
// tile's 64 row columns and 64 column columns of each gathered row). Every
// tile re-reads the row's entries (T^2 times for T = ceil(k / 64) tiles a
// side), from L2; the bytes bound is unchanged (the correction it writes is
// still most of them). Tile (i, j) and tile (j, i) form each product from
// the commuted pair in the same entry order, so the result stays exactly
// symmetric. The b-vector is written by the CTAs of tile column 0.
//
// K1-bf16 (entry als_partials_bf16): the same kernels reading a bf16 copy of
// the table, as albedo_tpu/ops/als.py bucket_partial_terms does under
// gather_dtype="bfloat16" (_gather :62, the einsums :127-135). The tiles hold
// the bf16 rows as they are (half the shared memory and half the gathered
// bytes) and widen each value to float32 on use; the correction's c1 is
// rounded to bf16 (__float2bfloat16_rn, as JAX casts it to the rows' dtype),
// the b-vector's w = 1 + c1 is not. Each product c1 * (y_i * y_j) then holds
// at most 8 + 8 + 8 significant bits and is exact in float32, so only the
// order of the float32 sums differs from JAX. The bound moves little: the
// (B, k, k) correction the kernel writes is most of its bytes either way.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// How the gathered rows are read: float32 as they are, or bf16 widened to
// float32, with ``round`` the value a float32 operand takes when JAX casts
// it to the rows' dtype (the identity for float32 rows).
template <typename T>
struct Rows;

template <>
struct Rows<float> {
  static __device__ __forceinline__ float widen(float v) { return v; }
  static __device__ __forceinline__ float round(float x) { return x; }
  static __device__ __forceinline__ float zero() { return 0.f; }
};

template <>
struct Rows<__nv_bfloat16> {
  static __device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  static __device__ __forceinline__ __nv_bfloat16 zero() { return __float2bfloat16_rn(0.f); }
};

constexpr int KMAX = 64;
constexpr int THREADS = 256;
constexpr int TILE = 32;
constexpr int PER_THREAD = KMAX * KMAX / THREADS;

template <typename T>
__global__ void __launch_bounds__(THREADS) als_partials_kernel(
    const T* __restrict__ source, const int* __restrict__ idx,
    const float* __restrict__ val, const unsigned char* __restrict__ mask,
    float* __restrict__ corr, float* __restrict__ bvec, int L, int k,
    float alpha) {
  __shared__ T ys[TILE][KMAX];
  __shared__ float c1s[TILE];
  __shared__ float ws[TILE];
  __shared__ int s_end;

  const int tid = threadIdx.x;
  const long long base = (long long)blockIdx.x * L;

  // One past the row's last masked-in entry.
  if (tid == 0) s_end = 0;
  __syncthreads();
  int my_end = 0;
  for (int l = tid; l < L; l += THREADS)
    if (mask[base + l]) my_end = l + 1;
  if (my_end) atomicMax(&s_end, my_end);
  __syncthreads();
  const int end = s_end;
  const int kk = k * k;

  float acc[PER_THREAD];
#pragma unroll
  for (int q = 0; q < PER_THREAD; ++q) acc[q] = 0.f;
  float bacc = 0.f;

  for (int l0 = 0; l0 < end; l0 += TILE) {
    for (int e = tid; e < TILE * k; e += THREADS) {
      const int l = e / k;
      const int c = e - l * k;
      const int gl = l0 + l;
      T y = Rows<T>::zero();
      if (gl < end && mask[base + gl])
        y = source[(long long)idx[base + gl] * k + c];
      ys[l][c] = y;
    }
    if (tid < TILE) {
      const int gl = l0 + tid;
      float c1 = 0.f, w = 0.f;
      if (gl < end && mask[base + gl]) {
        c1 = alpha * val[base + gl];
        w = 1.f + c1;
      }
      c1s[tid] = Rows<T>::round(c1);
      ws[tid] = w;
    }
    __syncthreads();
    const int nl = min(TILE, end - l0);
    if (tid < k)
      for (int l = 0; l < nl; ++l) bacc += ws[l] * Rows<T>::widen(ys[l][tid]);
#pragma unroll
    for (int q = 0; q < PER_THREAD; ++q) {
      const int p = tid + q * THREADS;
      if (p < kk) {
        const int i = p / k;
        const int j = p - i * k;
        float a = acc[q];
        for (int l = 0; l < nl; ++l)
          a += c1s[l] * (Rows<T>::widen(ys[l][i]) * Rows<T>::widen(ys[l][j]));
        acc[q] = a;
      }
    }
    __syncthreads();
  }

  float* out = corr + (long long)blockIdx.x * kk;
#pragma unroll
  for (int q = 0; q < PER_THREAD; ++q) {
    const int p = tid + q * THREADS;
    if (p < kk) out[p] = acc[q];
  }
  if (tid < k) bvec[(long long)blockIdx.x * k + tid] = bacc;
}

constexpr int WT = 64;  // output tile side, wide path
constexpr int W_PER_THREAD = WT * WT / THREADS;

template <typename T>
__global__ void __launch_bounds__(THREADS) als_partials_wide_kernel(
    const T* __restrict__ source, const int* __restrict__ idx,
    const float* __restrict__ val, const unsigned char* __restrict__ mask,
    float* __restrict__ corr, float* __restrict__ bvec, int L, int k,
    float alpha) {
  __shared__ T yi[TILE][WT];
  __shared__ T yj[TILE][WT];
  __shared__ float c1s[TILE];
  __shared__ float ws[TILE];
  __shared__ int s_end;

  const int tid = threadIdx.x;
  const long long row = blockIdx.x;
  const long long base = row * L;
  const int tiles = (k + WT - 1) / WT;

  if (tid == 0) s_end = 0;
  __syncthreads();
  int my_end = 0;
  for (int l = tid; l < L; l += THREADS)
    if (mask[base + l]) my_end = l + 1;
  if (my_end) atomicMax(&s_end, my_end);
  __syncthreads();
  const int end = s_end;

  // The grid's y extent is capped at 65535: a CTA walks tiles t, t + gridDim.y, ...
  for (int t = blockIdx.y; t < tiles * tiles; t += gridDim.y) {
    const int i0 = (t / tiles) * WT;
    const int j0 = (t % tiles) * WT;
    const int ni = min(WT, k - i0);
    const int nj = min(WT, k - j0);

    float acc[W_PER_THREAD];
#pragma unroll
    for (int q = 0; q < W_PER_THREAD; ++q) acc[q] = 0.f;
    float bacc = 0.f;

    for (int l0 = 0; l0 < end; l0 += TILE) {
      for (int e = tid; e < TILE * WT; e += THREADS) {
        const int l = e / WT;
        const int c = e - l * WT;
        const int gl = l0 + l;
        T a = Rows<T>::zero(), b = Rows<T>::zero();
        if (gl < end && mask[base + gl]) {
          const T* y = source + (long long)idx[base + gl] * k;
          if (c < ni) a = y[i0 + c];
          if (c < nj) b = y[j0 + c];
        }
        yi[l][c] = a;
        yj[l][c] = b;
      }
      if (tid < TILE) {
        const int gl = l0 + tid;
        float c1 = 0.f, w = 0.f;
        if (gl < end && mask[base + gl]) {
          c1 = alpha * val[base + gl];
          w = 1.f + c1;
        }
        c1s[tid] = Rows<T>::round(c1);
        ws[tid] = w;
      }
      __syncthreads();
      const int nl = min(TILE, end - l0);
      if (j0 == 0 && tid < ni)
        for (int l = 0; l < nl; ++l) bacc += ws[l] * Rows<T>::widen(yi[l][tid]);
#pragma unroll
      for (int q = 0; q < W_PER_THREAD; ++q) {
        const int p = tid + q * THREADS;
        const int i = p / WT;
        const int j = p - i * WT;
        float a = acc[q];
        for (int l = 0; l < nl; ++l)
          a += c1s[l] * (Rows<T>::widen(yi[l][i]) * Rows<T>::widen(yj[l][j]));
        acc[q] = a;
      }
      __syncthreads();
    }

    float* out = corr + row * k * k;
#pragma unroll
    for (int q = 0; q < W_PER_THREAD; ++q) {
      const int p = tid + q * THREADS;
      const int i = p / WT;
      const int j = p - i * WT;
      if (i < ni && j < nj) out[(long long)(i0 + i) * k + j0 + j] = acc[q];
    }
    if (j0 == 0 && tid < ni) bvec[row * k + i0 + tid] = bacc;
  }
}

template <typename T>
int launch(const T* source, const int* idx, const float* val, const unsigned char* mask,
           float* corr, float* bvec, int B, int L, int k, float alpha, cudaStream_t stream) {
  if (B > 0 && k <= KMAX) {
    als_partials_kernel<T><<<B, THREADS, 0, stream>>>(source, idx, val, mask, corr, bvec, L, k, alpha);
  } else if (B > 0) {
    const int tiles = (k + WT - 1) / WT;
    als_partials_wide_kernel<T><<<dim3(B, tiles * tiles < 65535 ? tiles * tiles : 65535), THREADS, 0, stream>>>(
        source, idx, val, mask, corr, bvec, L, k, alpha);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// source (n, k) f32; idx, val, mask (B, L); corr (B, k, k), bvec (B, k) f32;
// any k >= 1 (k > 64 takes the wide path).
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int als_partials_launch(const float* source, const int* idx,
                                   const float* val, const unsigned char* mask,
                                   float* corr, float* bvec, int B, int L,
                                   int k, float alpha, void* stream) {
  return launch<float>(source, idx, val, mask, corr, bvec, B, L, k, alpha, (cudaStream_t)stream);
}

// K1-bf16: as als_partials_launch, with source (n, k) bf16.
extern "C" int als_partials_bf16_launch(const void* source, const int* idx,
                                        const float* val, const unsigned char* mask,
                                        float* corr, float* bvec, int B, int L,
                                        int k, float alpha, void* stream) {
  return launch<__nv_bfloat16>((const __nv_bfloat16*)source, idx, val, mask, corr, bvec, B, L, k, alpha,
                               (cudaStream_t)stream);
}
