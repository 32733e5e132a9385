// K8c gather_sum: the gather terms of the ranker's block logits in one pass,
//     out[n] = base[n] + T_0[idx_0[n]] + T_1[idx_1[n]] + ... + T_{J-1}[idx_{J-1}[n]]
// added left to right, each add rounded (the plain version's order).
//
// Replaces: the gathers inside albedo_tpu/ops/sparse_linear.py block_logits
// (:289): each cat: field's w[arr] (:338-342, T = the field's weights times
// its 1/std scales) and each rep expansion's lu[rep] (_rep_term's forward,
// :278; T = a vec field's per-distinct-vector term, or a factored bag field's
// per-document term). XLA writes each gathered (N,) term and adds it to the
// running logits, one pass over device memory per term; here one thread per
// row reads its J indices and table entries and writes the sum once. The
// gradient wrt each table is K8 (segment_dot.cu) over a row order sorted by
// that table's index, with its indptr (ops/sparse_linear.py _GatherSum), so
// the backward has no atomics and repeats bit for bit.
//
// What bounds it on an H100: bytes (N (J + 2) 4-byte reads and writes plus
// the tables, which stay in L2), at one add per term. The pointers of up to
// MAXJ terms travel in the launch's parameters; the wrapper chains launches
// for more (base = the previous launch's out, so the order is unchanged).

#include <cuda_runtime.h>

namespace {

constexpr int MAXJ = 32;
constexpr int THREADS = 256;

struct Terms {
  const float* table[MAXJ];
  const int* idx[MAXJ];
};

__global__ void __launch_bounds__(THREADS) gather_sum_kernel(const float* __restrict__ base, Terms t,
                                                             int J, int N, float* __restrict__ out) {
  const long long n = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (n >= N) return;
  float s = base[n];
  for (int j = 0; j < J; ++j) s = __fadd_rn(s, t.table[j][t.idx[j][n]]);
  out[n] = s;
}

}  // namespace

// base (N,) f32; tables and idxs: host arrays of J device pointers ((size_j,)
// f32 tables, (N,) i32 indices in range); out (N,) f32 (may be base);
// 0 <= J <= 32. Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int gather_sum_launch(const float* base, const void* const* tables, const void* const* idxs,
                                 int J, int N, float* out, void* stream) {
  if (J < 0 || J > MAXJ) return (int)cudaErrorInvalidValue;
  Terms t{};
  for (int j = 0; j < J; ++j) {
    t.table[j] = static_cast<const float*>(tables[j]);
    t.idx[j] = static_cast<const int*>(idxs[j]);
  }
  if (N > 0)
    gather_sum_kernel<<<(N + THREADS - 1) / THREADS, THREADS, 0, (cudaStream_t)stream>>>(base, t, J, N, out);
  return (int)cudaGetLastError();
}
