// K8 segment_dot: CSR segmented gather-multiply-sum
//     out[s] = sum_{j in [indptr[s], indptr[s+1])} x[idx[j]] * val[j]
// (val == nullptr reads as val[j] = 1), in float32. Empty segments give 0.
//
// Replaces: albedo_tpu/ops/sparse_linear.py _segment_sums (:217) and its
// three uses, _bag_term (:235) forward and backward and _rep_term (:263)
// backward. The JAX program reduces by an exclusive cumsum gathered at the
// segment boundaries, because scatters were slow on the TPU; that costs
// eps * |running prefix| of round-off per segment. Here each segment is
// summed directly, so the error is eps * |segment|.
//
//   - bag forward:  x = w (V,) weights,   idx/val = row-sorted flats,   S = N rows;
//   - bag backward: x = g (N,) cotangent, idx/val = vocab-sorted flats, S = V
//     (the vocab indptr spans the whole table, so the gradient has V rows);
//   - rep and category backward: x = g (N,) cotangent, idx = the rows sorted
//     by value, val null, S = the table's size.
//
// K8g (segment_dot_grid_launch): the same sums for G rows of x at once,
//     out[g, s] = sum_{j in segment s} x[g, idx[j]] * val[j],
// x (G, n_x) and out (G, S) row-major. Replaces _segment_sums under the
// jax.vmap of albedo_tpu/models/logistic_regression.py _lbfgs_fit_many_impl
// (:381), which batches every call over the CV weight grid. Each index and
// value is read once for up to R = 8 rows (G > 8 runs in passes of 8).
//
// What bounds it on an H100: bytes. Each entry moves an index, a value and
// G 4-byte gathers of x (x is small and stays in L2), two flops a row: far
// below the FP32 rate. The ranker's calls are skewed: a category gradient
// puts 207 000 of 257 000 entries in one of 3 segments. So the work is cut
// by a merge path, not by segments (as merge-based CSR SpMV does): the S
// segment ends and the nnz entries form one sequence of S + nnz steps, a
// step adds one entry or closes one segment, and each CTA takes STEPS = 256
// consecutive steps, 2 a thread. No thread does more than 2 steps whatever
// the lengths, so a long segment spreads over many CTAs and a run of empty
// segments over many threads. A CTA finds its first and last step by a
// 32-way warp search of indptr, stages its entries' products and its
// segment ends in shared memory, then each thread walks its 2 steps:
//   - a segment that starts and ends inside one thread is written by it;
//   - the rest of each thread's sums (the segment open at its end, and the
//     segment open at its start, which earlier threads began) join in a
//     segmented scan over the CTA's threads (warp shuffles with head flags,
//     then the warps' totals in shared memory, in warp order);
//   - a segment that began in earlier CTAs and ends in this one takes their
//     partials: each CTA publishes the partial of the segment open at its
//     end (a value, then a flag in the workspace), and the CTA that closes
//     the segment waits for the flags of the CTAs from the one holding the
//     segment's first step, adds their partials in CTA order (lane l those
//     of the l-th, l+32-th, ...; then a fixed shuffle tree) to its own, and
//     sets the flags back to 0 (decoupled look-back, as single-pass scans
//     do: a CTA waits only on CTAs of lower index, which the card starts
//     first).
// One launch a call (a pass of 8 rows for K8g), no host synchronisation.
// No floating-point atomics and no order that depends on timing: two calls
// give the same bits. A row of K8g takes the very steps, partition and
// hand-over order of K8 on that row, so it equals K8 bit for bit. Every
// product and sum is an explicit __fmul_rn/__fadd_rn, so no FMA contraction
// can make the two differ.
//
// Round-off of this order, against a segment's L1 mass m = sum |x[idx] val|
// (u = 2^-24): a term passes through at most 1 rounding of its product,
// min(L, 2) - 1 in its thread's sum, 5 in the warp scan, 2 in the
// warp-order prefix, 1 joining the two, 1 adding the segment's start from
// earlier threads, and for a segment whose steps span C > 1 CTAs
// ceil((C - 1) / 32) in the look-back warp's lanes, 5 in its shuffle tree
// and 1 adding that to the closing CTA's value:
//     |got - exact| <= (min(L, 2) + 9 + [C > 1] (ceil((C - 1) / 32) + 6)) u m,
// with C = (s + indptr[s+1]) / 256 - (s + indptr[s]) / 256 + 1. The
// one-warp-per-segment order it replaced had (ceil(L / 32) + 6) u m: the
// new bound is far smaller on long segments (43 u m against 6 484 u m on a
// 207 000-entry one) and can be larger below 100 entries.
//
// The workspace (cap >= n_cta = ceil((S + nnz) / 256) CTAs): cap int32
// flags, 0 at launch and left 0, then R * cap floats of partials, R = 1 (K8)
// or 8 (K8g). Launches that share a workspace must run in order (one
// stream).

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int IPT = 2;                       // merge steps a thread (1, 4 and 8 took longer on an H100)
constexpr int STEPS = THREADS * IPT;         // merge steps a CTA
constexpr int PADDED = STEPS + STEPS / 32;   // one pad word every 32: the threads' steps hit distinct banks
constexpr int GC = 8;                        // K8g rows a pass
constexpr int LB = 8;                        // look-back partials a lane takes a round
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int pad(int e) { return e + (e >> 5); }

// Segments closed before merge step p: #{k in [0, S) : k + indptr[k+1] < p}
// (k + indptr[k+1] is the step that closes segment k, increasing in k). One
// warp, 32 probes a round, so ceil(log32 S) rounds of dependent loads.
__device__ int closed_before(const int* __restrict__ indptr, int S, long long p, int lane) {
  int lo = 0, hi = S;
  while (lo < hi) {
    const int base = lo;
    const long long span = hi - lo;
    const int k = base + (int)(span * lane / 32);
    const bool before = (long long)k + indptr[k + 1] < p;
    const int n = __popc(__ballot_sync(FULL, before));  // the true lanes are a prefix
    if (n > 0) lo = base + (int)(span * (n - 1) / 32) + 1;
    if (n < 32) hi = base + (int)(span * n / 32);
  }
  return lo;
}

// One CTA's STEPS merge steps for R rows of x (R = 1: K8; GC: K8g, gn <= R
// rows live). out is the (gn, S) block of this pass.
template <int R>
__global__ void __launch_bounds__(THREADS) segment_dot_merge(
    const float* __restrict__ x, long long n_x, const int* __restrict__ idx,
    const float* __restrict__ val, const int* __restrict__ indptr, float* __restrict__ out,
    int S, int gn, long long total, int* __restrict__ flags, float* __restrict__ carry_val, int cap) {
  __shared__ float s_term[R][PADDED];
  __shared__ int s_end[STEPS];
  __shared__ int s_bounds[2];
  __shared__ int s_start0;  // indptr[i0]
  __shared__ float s_head[R];
  __shared__ int s_wflag[WARPS];
  __shared__ float s_wsum[WARPS][R];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long p0 = (long long)blockIdx.x * STEPS;
  const long long p1 = min(p0 + STEPS, total);
  if (warp < 2) {
    const int c = closed_before(indptr, S, warp == 0 ? p0 : p1, lane);
    if (lane == 0) s_bounds[warp] = c;
  }
  __syncthreads();
  const int i0 = s_bounds[0];           // first segment of the CTA (open at its start)
  const int n_close = s_bounds[1] - i0; // segments closed in the CTA
  const int j0 = (int)(p0 - i0);        // entries consumed before the CTA
  const int n_steps = (int)(p1 - p0);
  const int n_ent = n_steps - n_close;

  // Stage the segment ends (relative to j0) and the entries' products.
  if (tid == 0) s_start0 = indptr[i0];
  for (int k = tid; k < n_close; k += THREADS) s_end[k] = indptr[i0 + k + 1] - j0;
#pragma unroll
  for (int u = 0; u < IPT; ++u) {
    const int e = tid + u * THREADS;
    if (e < n_ent) {
      const long long i = idx[j0 + e];
      const float v = val != nullptr ? val[j0 + e] : 1.0f;
#pragma unroll
      for (int g = 0; g < R; ++g) {
        if (g < gn) {
          const float xv = __ldg(x + g * n_x + i);
          s_term[g][pad(e)] = val != nullptr ? __fmul_rn(xv, v) : xv;
        }
      }
    }
  }
  __syncthreads();

  // This thread's steps [q0, q0 + IPT): find its state, then walk.
  const int q0 = tid * IPT;
  int lo = 0, hi = n_close;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (mid + s_end[mid] < q0) lo = mid + 1;
    else hi = mid;
  }
  int i = lo, j = q0 - lo;
  float acc[R], first[R];
#pragma unroll
  for (int g = 0; g < R; ++g) acc[g] = first[g] = 0.0f;
  bool closed = false;
  int first_seg = 0;
#pragma unroll
  for (int t = 0; t < IPT; ++t) {
    if (q0 + t < n_steps) {
      if (i < n_close && j == s_end[i]) {  // close segment i0 + i
        if (!closed) {
          closed = true;
          first_seg = i;
#pragma unroll
          for (int g = 0; g < R; ++g) first[g] = acc[g];
        } else {
#pragma unroll
          for (int g = 0; g < R; ++g)
            if (g < gn) out[(long long)g * S + i0 + i] = acc[g];
        }
#pragma unroll
        for (int g = 0; g < R; ++g) acc[g] = 0.0f;
        ++i;
      } else {
#pragma unroll
        for (int g = 0; g < R; ++g)
          if (g < gn) acc[g] = __fadd_rn(acc[g], s_term[g][pad(j)]);
        ++j;
      }
    }
  }

  // Segmented inclusive scan of (closed, acc) over the warp: a thread that
  // closed a segment starts a new run; op(a, b) = (a.f | b.f, b.f ? b.v : a.v + b.v).
  bool f = closed;
  float v[R];
#pragma unroll
  for (int g = 0; g < R; ++g) v[g] = acc[g];
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const bool lf = __shfl_up_sync(FULL, (int)f, d) != 0;
    float lv[R];
#pragma unroll
    for (int g = 0; g < R; ++g) lv[g] = __shfl_up_sync(FULL, v[g], d);
    if (lane >= d) {
      if (!f) {
#pragma unroll
        for (int g = 0; g < R; ++g) v[g] = __fadd_rn(lv[g], v[g]);
      }
      f = f || lf;
    }
  }
  bool ef = __shfl_up_sync(FULL, (int)f, 1) != 0;
  float ev[R];
#pragma unroll
  for (int g = 0; g < R; ++g) ev[g] = __shfl_up_sync(FULL, v[g], 1);
  if (lane == 0) {
    ef = false;
#pragma unroll
    for (int g = 0; g < R; ++g) ev[g] = 0.0f;
  }
  if (lane == 31) {
    s_wflag[warp] = f;
#pragma unroll
    for (int g = 0; g < R; ++g) s_wsum[warp][g] = v[g];
  }
  __syncthreads();
  // The earlier warps' totals, in warp order.
  bool pf = false;
  float pv[R];
#pragma unroll
  for (int g = 0; g < R; ++g) pv[g] = 0.0f;
  for (int w = 0; w < warp; ++w) {
    const bool wf = s_wflag[w] != 0;
#pragma unroll
    for (int g = 0; g < R; ++g) pv[g] = wf ? s_wsum[w][g] : __fadd_rn(pv[g], s_wsum[w][g]);
    pf = pf || wf;
  }
  // The CTA's first segment began in earlier CTAs when its first step lies
  // before this CTA: if the CTA also closes it, the CTAs from the one
  // holding that step to the one before this hand over their partials.
  const long long start0 = (long long)i0 + s_start0;
  const bool has_run = n_close > 0 && start0 < p0;
  if (closed) {  // the first segment this thread closed: add what earlier threads summed of it
#pragma unroll
    for (int g = 0; g < R; ++g) {
      const float carry_in = ef ? ev[g] : __fadd_rn(pv[g], ev[g]);
      const float sum = __fadd_rn(carry_in, first[g]);
      if (has_run && first_seg == 0) s_head[g] = sum;
      else if (g < gn) out[(long long)g * S + i0 + first_seg] = sum;
    }
  }
  // Hand over the partial of the segment open at the CTA's end, if it has
  // begun (a segment that starts at the next CTA's first step has not).
  const int open = i0 + n_close;
  if (tid == THREADS - 1 && open < S &&
      (long long)open + (n_close > 0 ? s_end[n_close - 1] + j0 : s_start0) < p1) {
#pragma unroll
    for (int g = 0; g < R; ++g)
      if (g < gn) carry_val[(long long)g * cap + blockIdx.x] = f ? v[g] : __fadd_rn(pv[g], v[g]);
    __threadfence();
    atomicExch(flags + blockIdx.x, 1);
  }
  if (!has_run) return;
  __syncthreads();  // s_head
  if (warp != 0) return;
  // Warp 0 takes the partials of CTAs c0 .. blockIdx.x - 1 in CTA order,
  // lane l those of c0 + l, c0 + l + 32, ..., LB of them a round with their
  // flag and value loads all in flight, then a fixed shuffle tree; each flag
  // goes back to 0 once read, so the workspace is clean again.
  const int c0 = (int)(start0 / STEPS);
  float run[R];
#pragma unroll
  for (int g = 0; g < R; ++g) run[g] = 0.0f;
  for (int b = c0; b < (int)blockIdx.x; b += 32 * LB) {
    unsigned pending = 0;
#pragma unroll
    for (int u = 0; u < LB; ++u)
      if (b + u * 32 + lane < (int)blockIdx.x) pending |= 1u << u;
    const unsigned mine = pending;
    while (pending) {
      int ready[LB];
#pragma unroll
      for (int u = 0; u < LB; ++u)
        ready[u] = (pending >> u & 1) ? *(volatile const int*)(flags + b + u * 32 + lane) : 0;
#pragma unroll
      for (int u = 0; u < LB; ++u)
        if (ready[u]) pending &= ~(1u << u);
    }
    __threadfence();
    float part[LB][R];
#pragma unroll
    for (int u = 0; u < LB; ++u)
#pragma unroll
      for (int g = 0; g < R; ++g)
        part[u][g] = (mine >> u & 1) && g < gn ? __ldcg(carry_val + (long long)g * cap + b + u * 32 + lane) : 0.0f;
#pragma unroll
    for (int u = 0; u < LB; ++u) {
      if (mine >> u & 1) {
#pragma unroll
        for (int g = 0; g < R; ++g) run[g] = __fadd_rn(run[g], part[u][g]);
        flags[b + u * 32 + lane] = 0;
      }
    }
  }
#pragma unroll
  for (int g = 0; g < R; ++g)
    for (int off = 16; off > 0; off >>= 1) run[g] = __fadd_rn(run[g], __shfl_xor_sync(FULL, run[g], off));
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < R; ++g)
      if (g < gn) out[(long long)g * S + i0] = __fadd_rn(s_head[g], run[g]);
  }
}

template <int R>
int launch(const float* x, long long n_x, const int* idx, const float* val, const int* indptr,
           float* out, int S, int G, int nnz, int* ws, int cap, cudaStream_t stream) {
  if (G < 1 || S < 0 || nnz < 0) return (int)cudaErrorInvalidValue;
  if (S == 0) return (int)cudaGetLastError();
  const long long total = (long long)S + nnz;
  const long long n_cta = (total + STEPS - 1) / STEPS;
  if (n_cta > cap) return (int)cudaErrorInvalidValue;
  float* carry_val = reinterpret_cast<float*>(ws + cap);
  for (int g0 = 0; g0 < G; g0 += R)
    segment_dot_merge<R><<<(int)n_cta, THREADS, 0, stream>>>(
        x + g0 * n_x, n_x, idx, val, indptr, out + (long long)g0 * S, S, min(R, G - g0), total, ws,
        carry_val, cap);
  return (int)cudaGetLastError();
}

}  // namespace

// x (n_x,) f32; idx (nnz,) int32 in [0, n_x); val (nnz,) f32 or null;
// indptr (S + 1,) int32, nondecreasing, indptr[0] = 0, indptr[S] = nnz;
// out (S,) f32; ws (cap * 9,) int32 with its first cap words 0 and
// cap >= ceil((S + nnz) / 256). Returns cudaGetLastError() after the
// launch (0 = launched).
extern "C" int segment_dot_launch(const float* x, const int* idx, const float* val, const int* indptr,
                                  float* out, int S, int nnz, int* ws, int cap, void* stream) {
  return launch<1>(x, 0, idx, val, indptr, out, S, 1, nnz, ws, cap, (cudaStream_t)stream);
}

// K8g. x (G, n_x) f32 row-major; idx, val, indptr as above; out (G, S) f32;
// G >= 1; ws as above. Returns cudaGetLastError() after the launches
// (0 = launched).
extern "C" int segment_dot_grid_launch(const float* x, long long n_x, const int* idx, const float* val,
                                       const int* indptr, float* out, int S, int G, int nnz, int* ws,
                                       int cap, void* stream) {
  return launch<GC>(x, n_x, idx, val, indptr, out, S, G, nnz, ws, cap, (cudaStream_t)stream);
}
