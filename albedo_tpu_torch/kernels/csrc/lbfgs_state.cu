// lbfgs_state: the scalar state machine of the L-BFGS fits on the card, a
// thread a grid row, so that a block of iterations runs as one CUDA graph
// with no host read between its line-search trials.
//
// Replaces: the control flow of albedo_tpu/models/logistic_regression.py
// _lbfgs_loop (:314-360), the jax.lax.while_loop of _lbfgs_fit_jit (:378)
// and, under jax.vmap, _lbfgs_fit_many_jit (:394), with optax's zoom line
// search (scale_by_zoom_linesearch, :299). The port's plain loops
// (albedo_tpu_torch/models/logistic_regression.py _lbfgs_loop_reference,
// _lbfgs_loop_many_reference) run that logic in numpy float32 on the host;
// here it runs on the device, with the same float32 rules:
//
// - lbfgs_state (the line search's trial): from a trial's value and slope,
//   each running row takes optax's search step (Algorithm 3.5, Nocedal and
//   Wright) or zoom step (3.6), then the safe-step rule of a failed search,
//   and writes its next trial step (2x the last, or the cubic, quadratic or
//   bisection point of the interval), its `running` flag and the row masks
//   the torch glue selects gradients by; one device bool says whether some
//   row still runs.
// - lbfgs_stop (the loop's bookkeeping): ok (finite value and iterate),
//   plateau, flat, prev, i, bad, the stored line-search value, then the
//   stop test (at least 2 steps, then 3 consecutive plateaus or a gradient
//   norm at tol) on the gradient norms torch computed; it writes each row's
//   `active` and one device bool: some row is still active. The next
//   iteration's direction (lbfgs_direction.cu) reads its count from the
//   rows' i: the loop's count is the largest i, the rows still active share
//   it.
//
// Same bits as numpy float32: every add, subtract, multiply, divide and
// square root is an explicit round-to-nearest intrinsic (__fadd_rn and
// friends), which nvcc never contracts into an FMA, so `a - b * c` rounds
// twice as numpy does; max and min propagate NaN as np.maximum and
// np.minimum do (fmaxf/fminf would drop it, and the sufficient-decrease
// error's NaN -> inf rule rests on that); the cubic interpolant's square
// root of a negative radical and its divisions by zero keep IEEE results
// (no fast math). Powers are products, x * x and x * (x * x), as JAX's
// integer_pow lowers them (the plain loops spell them so too). Constants
// are the float32 values of the plain loops' np.float32 constants.
//
// What bounds it on an H100: launch latency. A row's state is 20 floats,
// 6 ints and 7 flags; a call reads and writes a few hundred bytes.

#include <cuda_runtime.h>
#include <math.h>

namespace {

// State layout, mirrored by albedo_tpu_torch/ops/lbfgs.py: fs (NF, G)
// float32, is (NI, G) int32, ms (NM, G) bool, flags (NFLAGS,) bool.
enum {
  F_VALUE_INIT, F_SLOPE_INIT, F_STEP, F_VALUE, F_SLOPE, F_DEC, F_CURV,
  F_LOW, F_VALUE_LOW, F_SLOPE_LOW, F_HIGH, F_VALUE_HIGH, F_SLOPE_HIGH,
  F_CUBIC_REF, F_VALUE_CUBIC_REF, F_SAFE_STEP, F_SAFE_VALUE, F_TRIAL,
  F_LS_VALUE, F_PREV, NF
};
enum { I_INTERVAL, I_DONE, I_FAILED, I_ITER, I_BAD, I_FLAT, NI };
enum { M_RUNNING, M_TOOK, M_SAFE_NEW, M_SAFE_TAKE, M_ACTIVE, M_OK, M_STALE, NM };
// flags (NFLAGS,) bool: some row active, running, stale.
enum { FLAG_ACTIVE, FLAG_RUNNING, FLAG_STALE, NFLAGS };

// np.float32 of optax's defaults, exactly.
constexpr float SLOPE_RTOL = 0x1.a36e2ep-14f;          // 1e-4
constexpr float CURV_RTOL = 0x1.cccccc0p-1f;           // 0.9
constexpr float APPROX_DEC_RTOL = 0x1.0c6f7ap-20f;     // 1e-6
constexpr float INTERVAL_THRESHOLD = 0x1.4f8b58p-17f;  // 1e-5
constexpr float TWO_SLOPE_RTOL_M1 = -0x1.ffe5cap-1f;   // 2e-4 - 1
constexpr float TINY = 0x1.197998p-40f;                // 1e-12
constexpr float CUBIC_CHECK = 0x1.99999ap-3f;          // 0.2
constexpr float QUAD_CHECK = 0x1.99999ap-4f;           // 0.1

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
// np.maximum / np.minimum: NaN in either operand gives NaN.
__device__ __forceinline__ float np_max(float a, float b) { return (a >= b || isnan(a)) ? a : b; }
__device__ __forceinline__ float np_min(float a, float b) { return (a <= b || isnan(a)) ? a : b; }

__device__ float decrease_error(float step, float vs, float ss, float vi, float si) {
  float dec = sub(sub(vs, vi), mul(mul(SLOPE_RTOL, step), si));
  float approx = sub(ss, mul(TWO_SLOPE_RTOL_M1, si));
  const float delta_values = sub(sub(vs, vi), mul(APPROX_DEC_RTOL, fabsf(vi)));
  approx = np_max(approx, delta_values);
  dec = np_min(approx, dec);
  return isnan(dec) ? INFINITY : np_max(dec, 0.0f);
}

__device__ float curvature_error(float ss, float si) {
  const float curv = sub(fabsf(ss), mul(CURV_RTOL, fabsf(si)));
  return isnan(curv) ? INFINITY : np_max(curv, 0.0f);
}

__device__ float cubicmin(float a, float fa, float fpa, float b, float fb, float c, float fc) {
  const float C = fpa;
  const float db = sub(b, a), dc = sub(c, a);
  const float dbdc = mul(db, dc);
  const float denom = mul(mul(dbdc, dbdc), sub(db, dc));
  const float r0 = sub(sub(fb, fa), mul(C, db));
  const float r1 = sub(sub(fc, fa), mul(C, dc));
  const float A = div(add(mul(mul(dc, dc), r0), mul(-mul(db, db), r1)), denom);
  const float B = div(add(mul(-mul(dc, mul(dc, dc)), r0), mul(mul(db, mul(db, db)), r1)), denom);
  const float radical = sub(mul(B, B), mul(mul(3.0f, A), C));
  return add(a, div(add(-B, __fsqrt_rn(radical)), mul(3.0f, A)));
}

__device__ float quadmin(float a, float fa, float fpa, float b, float fb) {
  const float db = sub(b, a);
  const float B = div(sub(sub(fb, fa), mul(fpa, db)), mul(db, db));
  return sub(a, div(fpa, mul(2.0f, B)));
}

// Row g's field k.
#define FS(k) fs[(size_t)(k) * G + g]
#define IS(k) is[(size_t)(k) * G + g]
#define MS(k) ms[(size_t)(k) * G + g]

__global__ void lbfgs_state_kernel(float* __restrict__ fs, int* __restrict__ is, bool* __restrict__ ms,
                                   bool* __restrict__ flags, int G, const float* __restrict__ value,
                                   const float* __restrict__ slope, const float* __restrict__ slope_init,
                                   int count, int max_steps) {
  int any = 0;
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    if (count == 0) {  // a new search from the iteration's value and slope
      const float vi = FS(F_LS_VALUE), si = slope_init[g];
      FS(F_VALUE_INIT) = vi;
      FS(F_SLOPE_INIT) = si;
      FS(F_STEP) = 0.0f;
      FS(F_VALUE) = vi;
      FS(F_SLOPE) = si;
      FS(F_DEC) = INFINITY;
      FS(F_CURV) = INFINITY;
      FS(F_LOW) = 0.0f;
      FS(F_VALUE_LOW) = vi;
      FS(F_SLOPE_LOW) = si;
      FS(F_HIGH) = 0.0f;
      FS(F_VALUE_HIGH) = vi;
      FS(F_SLOPE_HIGH) = si;
      FS(F_CUBIC_REF) = 0.0f;
      FS(F_VALUE_CUBIC_REF) = vi;
      FS(F_SAFE_STEP) = 0.0f;
      FS(F_SAFE_VALUE) = vi;
      IS(I_INTERVAL) = 0;
      IS(I_DONE) = 0;
      IS(I_FAILED) = 0;
    }
    bool running = MS(M_RUNNING);
    const bool took = running;
    bool safe_new = false, safe_take = false;
    if (running) {
      const float t = FS(F_TRIAL), nv = value[g], ns = slope[g];
      const float vi = FS(F_VALUE_INIT), si = FS(F_SLOPE_INIT);
      const float dec = decrease_error(t, nv, ns, vi, si);
      const float curv = curvature_error(ns, si);
      const bool done = np_max(dec, curv) <= 0.0f;
      bool failed;
      if (!IS(I_INTERVAL)) {  // search the initial interval
        const float prev_step = FS(F_STEP), prev_value = FS(F_VALUE), prev_slope = FS(F_SLOPE);
        safe_new = dec <= 0.0f;
        const bool set_high = dec > 0.0f || (nv >= prev_value && count > 0);
        const bool set_low = ns >= 0.0f && !set_high;
        const float low = set_low ? t : prev_step, value_low = set_low ? nv : prev_value;
        FS(F_LOW) = low;
        FS(F_VALUE_LOW) = value_low;
        FS(F_SLOPE_LOW) = set_low ? ns : prev_slope;
        FS(F_HIGH) = set_low ? prev_step : t;
        FS(F_VALUE_HIGH) = set_low ? prev_value : nv;
        FS(F_SLOPE_HIGH) = set_low ? prev_slope : ns;
        FS(F_CUBIC_REF) = low;
        FS(F_VALUE_CUBIC_REF) = value_low;
        if (safe_new) {
          FS(F_SAFE_STEP) = t;
          FS(F_SAFE_VALUE) = nv;
        }
        IS(I_INTERVAL) = set_high || set_low || done;
        failed = count + 1 >= max_steps && !done;
      } else {  // zoom into the interval at its interpolated point t
        const float low = FS(F_LOW), value_low = FS(F_VALUE_LOW), slope_low = FS(F_SLOPE_LOW);
        const float high = FS(F_HIGH), value_high = FS(F_VALUE_HIGH), slope_high = FS(F_SLOPE_HIGH);
        const bool too_small = fabsf(sub(high, low)) <= INTERVAL_THRESHOLD;
        safe_new = dec <= 0.0f && nv < FS(F_SAFE_VALUE);
        if (safe_new) {
          FS(F_SAFE_STEP) = t;
          FS(F_SAFE_VALUE) = nv;
        }
        const bool to_middle = dec > 0.0f || nv >= value_low;
        const bool to_low = mul(ns, sub(high, low)) >= 0.0f && !to_middle;
        const bool moved = to_middle || to_low;
        failed = (count + 1 >= max_steps || (too_small && FS(F_SAFE_STEP) > 0.0f)) && !done;
        if (!to_middle) {
          FS(F_LOW) = t;
          FS(F_VALUE_LOW) = nv;
          FS(F_SLOPE_LOW) = ns;
        }
        FS(F_HIGH) = to_middle ? t : (to_low ? low : high);
        FS(F_VALUE_HIGH) = to_middle ? nv : (to_low ? value_low : value_high);
        FS(F_SLOPE_HIGH) = to_middle ? ns : (to_low ? slope_low : slope_high);
        FS(F_CUBIC_REF) = moved ? high : low;
        FS(F_VALUE_CUBIC_REF) = moved ? value_high : value_low;
      }
      IS(I_DONE) = done;
      IS(I_FAILED) = failed;
      FS(F_STEP) = t;
      FS(F_VALUE) = nv;
      FS(F_SLOPE) = ns;
      FS(F_DEC) = dec;
      FS(F_CURV) = curv;
      // A failed search takes the safe step: the best point with sufficient decrease.
      if (failed && (FS(F_SAFE_STEP) > 0.0f || isinf(dec))) {
        FS(F_STEP) = FS(F_SAFE_STEP);
        FS(F_VALUE) = FS(F_SAFE_VALUE);
        safe_take = true;
      }
      running = !(done || failed);
    }
    float next = 0.0f;
    if (running) {
      if (IS(I_INTERVAL)) {
        const float low = FS(F_LOW), high = FS(F_HIGH);
        const float delta = fabsf(sub(high, low));
        const float left = np_min(high, low), right = np_max(high, low);
        const float mc = cubicmin(low, FS(F_VALUE_LOW), FS(F_SLOPE_LOW), high, FS(F_VALUE_HIGH), FS(F_CUBIC_REF),
                                  FS(F_VALUE_CUBIC_REF));
        const bool use_cubic = mc > add(left, mul(CUBIC_CHECK, delta)) && mc < sub(right, mul(CUBIC_CHECK, delta));
        const float mq = quadmin(low, FS(F_VALUE_LOW), FS(F_SLOPE_LOW), high, FS(F_VALUE_HIGH));
        const bool use_quad = !use_cubic && mq > add(left, mul(QUAD_CHECK, delta))
                              && mq < sub(right, mul(QUAD_CHECK, delta));
        next = use_cubic ? mc : (use_quad ? mq : div(add(low, high), 2.0f));
      } else {
        next = mul(2.0f, FS(F_STEP));
      }
    }
    FS(F_TRIAL) = next;
    MS(M_RUNNING) = running;
    MS(M_TOOK) = took;
    MS(M_SAFE_NEW) = took && safe_new;
    MS(M_SAFE_TAKE) = safe_take;
    any |= running;
  }
  any = __syncthreads_or(any);
  if (threadIdx.x == 0) flags[FLAG_RUNNING] = any;
}

__global__ void lbfgs_stop_kernel(float* __restrict__ fs, int* __restrict__ is, bool* __restrict__ ms,
                                  bool* __restrict__ flags, int G, const bool* __restrict__ finite,
                                  const float* __restrict__ gnorm, int max_iter, float tol) {
  int any_active = 0, any_stale = 0;
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    bool ok_active = false;
    if (MS(M_ACTIVE)) {
      const float value = FS(F_VALUE_INIT);
      const bool ok = isfinite(value) && finite[g];
      ok_active = ok;
      FS(F_LS_VALUE) = FS(F_VALUE);
      // Count CONSECUTIVE no-progress steps.
      const bool plateau = fabsf(sub(FS(F_PREV), value)) <= mul(tol, np_max(fabsf(value), TINY));
      IS(I_FLAT) = plateau ? IS(I_FLAT) + 1 : 0;
      FS(F_PREV) = value;
      IS(I_ITER) += 1;
      IS(I_BAD) = !ok;
    }
    MS(M_OK) = ok_active;
    const int i = IS(I_ITER);
    const bool active = !IS(I_BAD) && i < max_iter && (i < 2 || (IS(I_FLAT) < 3 && gnorm[g] > tol));
    const bool stale = active && !isfinite(FS(F_LS_VALUE));
    MS(M_ACTIVE) = active;
    MS(M_RUNNING) = active;
    MS(M_STALE) = stale;
    FS(F_TRIAL) = active ? 1.0f : 0.0f;
    any_active |= active;
    any_stale |= stale;
  }
  any_active = __syncthreads_or(any_active);
  any_stale = __syncthreads_or(any_stale);
  if (threadIdx.x == 0) {
    flags[FLAG_ACTIVE] = any_active;
    flags[FLAG_RUNNING] = any_active;
    flags[FLAG_STALE] = any_stale;
  }
}

#undef FS
#undef IS
#undef MS

int threads_for(int G) { return G >= 1024 ? 1024 : ((G + 31) / 32) * 32; }

}  // namespace

// value, slope (G,) f32: the trial's objective and slope along the search
// direction; slope_init (G,) f32, read at count 0 (the iteration's first
// trial), where every row's search starts from its stored value (fs row
// F_LS_VALUE). Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int lbfgs_state_launch(float* fs, int* is, bool* ms, bool* flags, int G, const float* value,
                                  const float* slope, const float* slope_init, int count, int max_steps,
                                  void* stream) {
  if (G < 1) return (int)cudaErrorInvalidValue;
  lbfgs_state_kernel<<<1, threads_for(G), 0, (cudaStream_t)stream>>>(fs, is, ms, flags, G, value, slope,
                                                                     slope_init, count, max_steps);
  return (int)cudaGetLastError();
}

// finite (G,) bool: each row's iterate after the step is finite; gnorm (G,)
// f32: each row's stored line-search gradient norm.
extern "C" int lbfgs_stop_launch(float* fs, int* is, bool* ms, bool* flags, int G, const bool* finite,
                                 const float* gnorm, int max_iter, float tol, void* stream) {
  if (G < 1) return (int)cudaErrorInvalidValue;
  lbfgs_stop_kernel<<<1, threads_for(G), 0, (cudaStream_t)stream>>>(fs, is, ms, flags, G, finite, gnorm,
                                                                    max_iter, tol);
  return (int)cudaGetLastError();
}

// Loads the state kernels (CUDA loads a kernel lazily, at its first launch
// or attribute query), so that a capture that launches them first finds
// them loaded. Returns a cudaError_t.
extern "C" int lbfgs_state_load() {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, lbfgs_state_kernel);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, lbfgs_stop_kernel);
  return (int)e;
}
