// K3 bucket_cg: warm-started Jacobi-preconditioned conjugate gradient on the
// implicit-ALS normal equations, matrix-free, one bucket row per CTA.
//
// Replaces: albedo_tpu/ops/als.py bucket_cg_body (:154). For a row with
// entries (y_l = source[idx_l], c1_l = alpha val_l, w_l = 1 + c1_l):
//     b      = sum_l w_l y_l
//     diag   = max(diag(YtY) + sum_l c1_l y_l^2 + reg n, 1e-12)
//     A p    = YtY p + sum_l y_l (c1_l (y_l . p)) + reg n p
// then cg_steps iterations from x0 with the tiny = 1e-30 guards, in the same
// order as the JAX loop (:205-221).
//
// What bounds it on an H100: each matvec streams the row's gathered entries
// once (L k FMAs twice over). A row reaches L = 7624 entries at the bench
// scale (7624 x 50 x 4 B = 1.5 MB), so the gathered rows cannot all stay in
// shared memory: every matvec re-reads them from the source table through
// TILE-row shared-memory tiles. The table itself (4-6 MB at the bench scale)
// stays in the 50 MB L2, so the kernel is bound by L2 traffic and by the
// dependent chain of cg_steps + 1 matvecs per row, not by device memory.
// YtY (k x k) and the CG vectors live in shared memory for the whole solve;
// nothing of the (B, L, k) block or the (B, k, k) systems is ever written.
//
// Ranks above KMAX = 64 take the wide path (bucket_cg_wide_kernel): the same
// steps in the same order, with YtY read from global memory (one k x k table
// for the whole launch, resident in L2) and the entry tile and the seven CG
// vectors in dynamic shared memory while they fit the 227 KB a block may opt
// into ((TILE + 7) k + 3 TILE floats: k up to 1487), else in a global-memory
// workspace of the same layout, one slice per CTA, which the wrapper
// allocates. Each thread owns the columns c = tid, tid + THREADS, ... of
// every vector, so any k fits.
//
// K3-bf16 (entry bucket_cg_bf16): the same kernels reading a bf16 copy of
// the table, as bucket_cg_body does under gather_dtype="bfloat16" (:180,
// :193-203). The entry tile holds the bf16 rows as they are and widens each
// value on use; the kernel rounds where the JAX program rounds and nowhere
// else (round = __float2bfloat16_rn, nearest even, as XLA's convert):
//     diag   = max(diag(YtY) + sum_l round(y_l^2) round(c1_l) + reg n, 1e-12)
//     A p    = YtY p + sum_l y_l round(c1_l (y_l . round(p))) + reg n p
// with b = sum_l w_l y_l (w unrounded). The iterate p stays float32; only
// the two gathered contractions see its rounded copy, formed on the fly.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// How the gathered rows are read (see als_partials.cu): float32 as they
// are, or bf16 widened to float32; ``round`` is the identity for float32.
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
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 32;

template <typename T>
struct Shared {
  float yty[KMAX][KMAX];
  T ys[TILE][KMAX];
  float c1s[TILE];
  float ws[TILE];
  float ts[TILE];
  float x[KMAX], r[KMAX], z[KMAX], p[KMAX], ap[KMAX], diag[KMAX], b[KMAX];
  float red;
  int end;
  int count;
};

// Load entries [l0, l0 + TILE) of the row into the shared tile; entries that
// are masked out (or past `end`) load as zero rows with zero weights.
template <typename T>
__device__ void load_tile(Shared<T>& s, const T* __restrict__ source,
                          const int* __restrict__ idx,
                          const float* __restrict__ val,
                          const unsigned char* __restrict__ mask,
                          long long base, int l0, int k, float alpha) {
  const int tid = threadIdx.x;
  for (int e = tid; e < TILE * k; e += THREADS) {
    const int l = e / k;
    const int c = e - l * k;
    const int gl = l0 + l;
    T y = Rows<T>::zero();
    if (gl < s.end && mask[base + gl])
      y = source[(long long)idx[base + gl] * k + c];
    s.ys[l][c] = y;
  }
  if (tid < TILE) {
    const int gl = l0 + tid;
    float c1 = 0.f, w = 0.f;
    if (gl < s.end && mask[base + gl]) {
      c1 = alpha * val[base + gl];
      w = 1.f + c1;
    }
    s.c1s[tid] = c1;
    s.ws[tid] = w;
  }
}

// sum_i a[i] * b[i] over k entries, returned to every thread.
template <typename T>
__device__ float block_dot(Shared<T>& s, const float* a, const float* b, int k) {
  __syncthreads();
  if (threadIdx.x == 0) {
    float acc = 0.f;
    for (int i = 0; i < k; ++i) acc += a[i] * b[i];
    s.red = acc;
  }
  __syncthreads();
  return s.red;
}

// out = A v (see the header), for the whole CTA.
template <typename T>
__device__ void matvec(Shared<T>& s, const float* v, float* out,
                       const T* __restrict__ source,
                       const int* __restrict__ idx,
                       const float* __restrict__ val,
                       const unsigned char* __restrict__ mask, long long base,
                       int k, float alpha, float rn) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float acc = 0.f;
  for (int l0 = 0; l0 < s.end; l0 += TILE) {
    __syncthreads();
    load_tile(s, source, idx, val, mask, base, l0, k, alpha);
    __syncthreads();
    const int nl = min(TILE, s.end - l0);
    for (int l = warp; l < nl; l += WARPS) {
      float d = 0.f;
      for (int c = lane; c < k; c += 32) d += Rows<T>::widen(s.ys[l][c]) * Rows<T>::round(v[c]);
      for (int o = 16; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
      if (lane == 0) s.ts[l] = Rows<T>::round(s.c1s[l] * d);
    }
    __syncthreads();
    if (tid < k)
      for (int l = 0; l < nl; ++l) acc += Rows<T>::widen(s.ys[l][tid]) * s.ts[l];
  }
  __syncthreads();
  if (tid < k) {
    float yp = 0.f;
    for (int i = 0; i < k; ++i) yp += v[i] * s.yty[i][tid];
    out[tid] = yp + acc + rn * v[tid];
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(THREADS) bucket_cg_kernel(
    const T* __restrict__ source, const float* __restrict__ yty,
    const int* __restrict__ idx, const float* __restrict__ val,
    const unsigned char* __restrict__ mask, const float* __restrict__ x0,
    float* __restrict__ xout, int L, int k, float reg, float alpha,
    int cg_steps) {
  __shared__ Shared<T> s;
  const int tid = threadIdx.x;
  const long long row = blockIdx.x;
  const long long base = row * L;

  if (tid == 0) {
    s.end = 0;
    s.count = 0;
  }
  for (int p = tid; p < k * k; p += THREADS) s.yty[p / k][p % k] = yty[p];
  __syncthreads();
  int my_end = 0, my_count = 0;
  for (int l = tid; l < L; l += THREADS)
    if (mask[base + l]) {
      my_end = l + 1;
      ++my_count;
    }
  if (my_end) {
    atomicMax(&s.end, my_end);
    atomicAdd(&s.count, my_count);
  }
  __syncthreads();
  const float rn = reg * (float)s.count;

  // b-vector and the Jacobi diagonal in one pass over the entries.
  float bacc = 0.f, dacc = 0.f;
  for (int l0 = 0; l0 < s.end; l0 += TILE) {
    __syncthreads();
    load_tile(s, source, idx, val, mask, base, l0, k, alpha);
    __syncthreads();
    const int nl = min(TILE, s.end - l0);
    if (tid < k)
      for (int l = 0; l < nl; ++l) {
        const float y = Rows<T>::widen(s.ys[l][tid]);
        bacc += s.ws[l] * y;
        dacc += Rows<T>::round(y * y) * Rows<T>::round(s.c1s[l]);
      }
  }
  if (tid < k) {
    s.b[tid] = bacc;
    s.diag[tid] = fmaxf(s.yty[tid][tid] + dacc + rn, 1e-12f);
    s.x[tid] = x0[row * k + tid];
  }
  __syncthreads();

  const float tiny = 1e-30f;
  matvec(s, s.x, s.ap, source, idx, val, mask, base, k, alpha, rn);
  if (tid < k) {
    s.r[tid] = s.b[tid] - s.ap[tid];
    s.z[tid] = s.r[tid] / s.diag[tid];
    s.p[tid] = s.z[tid];
  }
  float rz = block_dot(s, s.r, s.z, k);
  for (int it = 0; it < cg_steps; ++it) {
    matvec(s, s.p, s.ap, source, idx, val, mask, base, k, alpha, rn);
    const float pap = block_dot(s, s.p, s.ap, k);
    const float step = rz / (pap + tiny);
    if (tid < k) {
      s.x[tid] += step * s.p[tid];
      s.r[tid] -= step * s.ap[tid];
      s.z[tid] = s.r[tid] / s.diag[tid];
    }
    const float rz_new = block_dot(s, s.r, s.z, k);
    const float beta = rz_new / (rz + tiny);
    if (tid < k) s.p[tid] = s.z[tid] + beta * s.p[tid];
    rz = rz_new;
    __syncthreads();
  }
  if (tid < k) xout[row * k + tid] = s.x[tid];
}

// The wide path's per-CTA region (shared or global): the entry tile (TILE x
// k), the CG vectors (k each) and the entry weights (TILE each).
// A bf16 tile uses the first half of the tile's room, so the layout (and
// the workspace the wrapper sizes) is one for both element types.
template <typename T>
struct Wide {
  T* ys;
  float *x, *r, *z, *p, *ap, *diag, *b;
  float *c1s, *ws, *ts;
};

template <typename T>
__device__ Wide<T> wide_region(float* base, int k) {
  Wide<T> w;
  w.ys = reinterpret_cast<T*>(base);
  float* v = base + TILE * k;
  w.x = v; w.r = v + k; w.z = v + 2 * k; w.p = v + 3 * k;
  w.ap = v + 4 * k; w.diag = v + 5 * k; w.b = v + 6 * k;
  w.c1s = v + 7 * k; w.ws = w.c1s + TILE; w.ts = w.ws + TILE;
  return w;
}

template <typename T>
__device__ void wide_load_tile(const Wide<T>& w, int end, const T* __restrict__ source,
                               const int* __restrict__ idx, const float* __restrict__ val,
                               const unsigned char* __restrict__ mask, long long base,
                               int l0, int k, float alpha) {
  const int tid = threadIdx.x;
  for (int e = tid; e < TILE * k; e += THREADS) {
    const int l = e / k;
    const int c = e - l * k;
    const int gl = l0 + l;
    T y = Rows<T>::zero();
    if (gl < end && mask[base + gl]) y = source[(long long)idx[base + gl] * k + c];
    w.ys[e] = y;
  }
  if (tid < TILE) {
    const int gl = l0 + tid;
    float c1 = 0.f, wt = 0.f;
    if (gl < end && mask[base + gl]) {
      c1 = alpha * val[base + gl];
      wt = 1.f + c1;
    }
    w.c1s[tid] = c1;
    w.ws[tid] = wt;
  }
}

__device__ float wide_dot(float* red, const float* a, const float* b, int k) {
  __syncthreads();
  if (threadIdx.x == 0) {
    float acc = 0.f;
    for (int i = 0; i < k; ++i) acc += a[i] * b[i];
    *red = acc;
  }
  __syncthreads();
  return *red;
}

template <typename T>
__device__ void wide_matvec(const Wide<T>& w, int end, const float* v, float* out,
                            const float* __restrict__ yty, const T* __restrict__ source,
                            const int* __restrict__ idx, const float* __restrict__ val,
                            const unsigned char* __restrict__ mask, long long base, int k,
                            float alpha, float rn) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  __syncthreads();
  for (int c = tid; c < k; c += THREADS) out[c] = 0.f;
  for (int l0 = 0; l0 < end; l0 += TILE) {
    __syncthreads();
    wide_load_tile(w, end, source, idx, val, mask, base, l0, k, alpha);
    __syncthreads();
    const int nl = min(TILE, end - l0);
    for (int l = warp; l < nl; l += WARPS) {
      float d = 0.f;
      for (int c = lane; c < k; c += 32) d += Rows<T>::widen(w.ys[l * k + c]) * Rows<T>::round(v[c]);
      for (int o = 16; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
      if (lane == 0) w.ts[l] = Rows<T>::round(w.c1s[l] * d);
    }
    __syncthreads();
    for (int c = tid; c < k; c += THREADS) {
      float a = out[c];
      for (int l = 0; l < nl; ++l) a += Rows<T>::widen(w.ys[l * k + c]) * w.ts[l];
      out[c] = a;
    }
  }
  __syncthreads();
  for (int c = tid; c < k; c += THREADS) {
    float yp = 0.f;
    for (int i = 0; i < k; ++i) yp += v[i] * yty[(long long)i * k + c];
    out[c] = yp + out[c] + rn * v[c];
  }
  __syncthreads();
}

// ws: null to keep the region in dynamic shared memory, else a workspace of
// B x ((TILE + 7) k + 3 TILE) floats, one slice per CTA.
template <typename T>
__global__ void __launch_bounds__(THREADS) bucket_cg_wide_kernel(
    const T* __restrict__ source, const float* __restrict__ yty,
    const int* __restrict__ idx, const float* __restrict__ val,
    const unsigned char* __restrict__ mask, const float* __restrict__ x0,
    float* __restrict__ xout, int L, int k, float reg, float alpha,
    int cg_steps, float* ws) {
  extern __shared__ float smem[];
  __shared__ float red;
  __shared__ int s_end, s_count;
  const int tid = threadIdx.x;
  const long long row = blockIdx.x;
  const long long base = row * L;
  const long long per_cta = (long long)(TILE + 7) * k + 3 * TILE;
  const Wide<T> w = wide_region<T>(ws == nullptr ? smem : ws + row * per_cta, k);

  if (tid == 0) {
    s_end = 0;
    s_count = 0;
  }
  __syncthreads();
  int my_end = 0, my_count = 0;
  for (int l = tid; l < L; l += THREADS)
    if (mask[base + l]) {
      my_end = l + 1;
      ++my_count;
    }
  if (my_end) {
    atomicMax(&s_end, my_end);
    atomicAdd(&s_count, my_count);
  }
  __syncthreads();
  const int end = s_end;
  const float rn = reg * (float)s_count;

  // b-vector and the Jacobi diagonal, accumulated in place over the tiles.
  for (int c = tid; c < k; c += THREADS) {
    w.b[c] = 0.f;
    w.diag[c] = 0.f;
  }
  for (int l0 = 0; l0 < end; l0 += TILE) {
    __syncthreads();
    wide_load_tile(w, end, source, idx, val, mask, base, l0, k, alpha);
    __syncthreads();
    const int nl = min(TILE, end - l0);
    for (int c = tid; c < k; c += THREADS) {
      float bacc = w.b[c], dacc = w.diag[c];
      for (int l = 0; l < nl; ++l) {
        const float y = Rows<T>::widen(w.ys[l * k + c]);
        bacc += w.ws[l] * y;
        dacc += Rows<T>::round(y * y) * Rows<T>::round(w.c1s[l]);
      }
      w.b[c] = bacc;
      w.diag[c] = dacc;
    }
  }
  __syncthreads();
  for (int c = tid; c < k; c += THREADS) {
    w.diag[c] = fmaxf(yty[(long long)c * k + c] + w.diag[c] + rn, 1e-12f);
    w.x[c] = x0[row * k + c];
  }
  __syncthreads();

  const float tiny = 1e-30f;
  wide_matvec(w, end, w.x, w.ap, yty, source, idx, val, mask, base, k, alpha, rn);
  for (int c = tid; c < k; c += THREADS) {
    w.r[c] = w.b[c] - w.ap[c];
    w.z[c] = w.r[c] / w.diag[c];
    w.p[c] = w.z[c];
  }
  float rz = wide_dot(&red, w.r, w.z, k);
  for (int it = 0; it < cg_steps; ++it) {
    wide_matvec(w, end, w.p, w.ap, yty, source, idx, val, mask, base, k, alpha, rn);
    const float pap = wide_dot(&red, w.p, w.ap, k);
    const float step = rz / (pap + tiny);
    for (int c = tid; c < k; c += THREADS) {
      w.x[c] += step * w.p[c];
      w.r[c] -= step * w.ap[c];
      w.z[c] = w.r[c] / w.diag[c];
    }
    const float rz_new = wide_dot(&red, w.r, w.z, k);
    const float beta = rz_new / (rz + tiny);
    for (int c = tid; c < k; c += THREADS) w.p[c] = w.z[c] + beta * w.p[c];
    rz = rz_new;
    __syncthreads();
  }
  for (int c = tid; c < k; c += THREADS) xout[row * k + c] = w.x[c];
}

template <typename T>
int launch(const T* source, const float* yty, const int* idx, const float* val,
           const unsigned char* mask, const float* x0, float* x, int B, int L, int k,
           float reg, float alpha, int cg_steps, float* ws, cudaStream_t stream) {
  if (B > 0 && k <= KMAX) {
    bucket_cg_kernel<T><<<B, THREADS, 0, stream>>>(
        source, yty, idx, val, mask, x0, x, L, k, reg, alpha, cg_steps);
  } else if (B > 0) {
    const size_t smem =
        ws == nullptr ? ((size_t)(TILE + 7) * k + 3 * TILE) * sizeof(float) : 0;
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          bucket_cg_wide_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    bucket_cg_wide_kernel<T><<<B, THREADS, smem, stream>>>(
        source, yty, idx, val, mask, x0, x, L, k, reg, alpha, cg_steps, ws);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// source (n, k) f32; yty (k, k); idx, val, mask (B, L); x0, x (B, k); any k >= 1.
// ws is null (k <= 64, or the wide region fits shared memory) or a workspace
// of B x ((TILE + 7) k + 3 TILE) floats. Returns cudaGetLastError() after the
// launch (0 = launched).
extern "C" int bucket_cg_launch(const float* source, const float* yty,
                                const int* idx, const float* val,
                                const unsigned char* mask, const float* x0,
                                float* x, int B, int L, int k, float reg,
                                float alpha, int cg_steps, float* ws, void* stream) {
  return launch<float>(source, yty, idx, val, mask, x0, x, B, L, k, reg, alpha, cg_steps, ws,
                       (cudaStream_t)stream);
}

// K3-bf16: as bucket_cg_launch, with source (n, k) bf16.
extern "C" int bucket_cg_bf16_launch(const void* source, const float* yty,
                                     const int* idx, const float* val,
                                     const unsigned char* mask, const float* x0,
                                     float* x, int B, int L, int k, float reg,
                                     float alpha, int cg_steps, float* ws, void* stream) {
  return launch<__nv_bfloat16>((const __nv_bfloat16*)source, yty, idx, val, mask, x0, x, B, L, k,
                               reg, alpha, cg_steps, ws, (cudaStream_t)stream);
}
