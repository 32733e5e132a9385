// K12 factor_health: the divergence watchdog's health vector of an ALS fit,
// [nonfinite count, max |x| over finite entries, max of the two tables' rms
// over finite entries (non-finite entries read as 0)], in one pass over both
// factor tables.
//
// Replaces: albedo_tpu/utils/watchdog.py factor_health (:55), a jitted
// program of per-table isfinite / where / abs-max / mean-of-squares
// reductions (and the same tail of parallel/foldin.py :99-108). In plain
// PyTorch that is about a dozen launches, each a pass over the tables.
//
// What bounds it on an H100: bytes, one read of the two tables (2.5 M floats
// at the bench scale, 10 MB: 0.003 ms at 3.35 TB/s). Pass 1: a fixed grid of
// blocks strides over both tables; each thread keeps, per table, its count,
// its max |x| and its sum of squares in float64, and each block reduces them
// by a fixed tree in shared memory and writes its six partials. Pass 2: one
// block reduces the partials in a fixed order and forms the vector. No
// atomics: the same tables give the same bits on every run. The sums are
// float64 (the plain version's too), so the rms is the correctly rounded
// float32 of the exact value up to float64 round-off.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int THREADS = 256;

struct Part {
  double cnt_u, max_u, ss_u, cnt_v, max_v, ss_v;
};

__device__ void accumulate(const float* __restrict__ x, long long n, long long start, long long step,
                           double& cnt, double& mx, double& ss) {
  for (long long i = start; i < n; i += step) {
    const float v = x[i];
    if (isfinite(v)) {
      mx = fmax(mx, (double)fabsf(v));
      ss += (double)v * (double)v;
    } else {
      cnt += 1.0;
    }
  }
}

// Reduce each thread's Part over the block by a fixed tree (sums add, maxes
// take the max); thread 0 returns the block's.
__device__ Part block_reduce(Part p, Part* s) {
  const int tid = threadIdx.x;
  s[tid] = p;
  __syncthreads();
  for (int half = THREADS / 2; half > 0; half >>= 1) {
    if (tid < half) {
      Part a = s[tid];
      const Part b = s[tid + half];
      a.cnt_u += b.cnt_u; a.max_u = fmax(a.max_u, b.max_u); a.ss_u += b.ss_u;
      a.cnt_v += b.cnt_v; a.max_v = fmax(a.max_v, b.max_v); a.ss_v += b.ss_v;
      s[tid] = a;
    }
    __syncthreads();
  }
  return s[0];
}

__global__ void __launch_bounds__(THREADS) partials_kernel(const float* __restrict__ u, long long nu,
                                                           const float* __restrict__ v, long long nv,
                                                           Part* __restrict__ parts) {
  __shared__ Part s[THREADS];
  Part p{0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  const long long start = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long step = (long long)gridDim.x * THREADS;
  accumulate(u, nu, start, step, p.cnt_u, p.max_u, p.ss_u);
  accumulate(v, nv, start, step, p.cnt_v, p.max_v, p.ss_v);
  const Part total = block_reduce(p, s);
  if (threadIdx.x == 0) parts[blockIdx.x] = total;
}

__global__ void __launch_bounds__(THREADS) final_kernel(const Part* __restrict__ parts, int G,
                                                        long long nu, long long nv, float* __restrict__ out) {
  __shared__ Part s[THREADS];
  Part p{0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  for (int g = threadIdx.x; g < G; g += THREADS) {
    const Part b = parts[g];
    p.cnt_u += b.cnt_u; p.max_u = fmax(p.max_u, b.max_u); p.ss_u += b.ss_u;
    p.cnt_v += b.cnt_v; p.max_v = fmax(p.max_v, b.max_v); p.ss_v += b.ss_v;
  }
  const Part t = block_reduce(p, s);
  if (threadIdx.x == 0) {
    out[0] = (float)(t.cnt_u + t.cnt_v);
    out[1] = (float)fmax(t.max_u, t.max_v);
    out[2] = fmaxf((float)sqrt(t.ss_u / (double)nu), (float)sqrt(t.ss_v / (double)nv));
  }
}

}  // namespace

// u (nu,) and v (nv,) f32 (the two factor tables, flattened); parts: a
// workspace of G x 6 doubles; out (3,) f32. Returns cudaGetLastError() after
// the launches (0 = launched).
extern "C" int factor_health_launch(const float* u, long long nu, const float* v, long long nv,
                                    double* parts, int G, float* out, void* stream) {
  if (G < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  Part* p = reinterpret_cast<Part*>(parts);
  partials_kernel<<<G, THREADS, 0, st>>>(u, nu, v, nv, p);
  final_kernel<<<1, THREADS, 0, st>>>(p, G, nu, nv, out);
  return (int)cudaGetLastError();
}
