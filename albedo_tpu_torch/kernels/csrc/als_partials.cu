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
// What bounds it on an H100: bytes. The gathered (B, L, k) block never
// leaves the chip; the entry lists and the source rows (which stay in the
// 50 MB L2: a 30000 x 50 f32 table is 6 MB) are a small part of the bytes.
// The (B, k, k) correction it writes, and K2 reads back, is most of them
// (about 670 of 744 MB per bench iteration, 0.222 ms at 3.35 TB/s); its
// k (k + 1) + 2k FLOP per masked-in entry take 0.19 ms at the FP32 peak.
// Rows split across CTAs add a workspace of partial sums (below), a few MB
// per iteration that stay in L2.
//
// Rank k <= 64 (the split design). A bucket group is (B, L) with rows of
// every length: the ALS fit's groups run from 3072 rows x 16 slots to one
// row x 7624 slots, and a design of one CTA per row left 131 of 132 SMs idle
// on the narrow tall groups (74% of K1's time at the bench shape). So the
// work is cut by entries, not by rows, in a plan the wrapper computes
// (ops/als.py _k1_plan, mirrored there entry for entry):
//   - each row's L slots are cut into n_chunks chunks of `chunk` slots (a
//     multiple of the 32-entry tile); a unit is one (row, chunk). A group
//     with few rows gets chunks short enough for ~8 units per SM, down to
//     64 slots; a group with many rows keeps one chunk per row;
//   - CTA g takes units [g per_cta, (g + 1) per_cta): several short rows to
//     a CTA when the rows are many (the CTA start, the pipeline's fill and
//     the metadata loads are paid once for all of them), one unit when rows
//     are split;
//   - a unit whose row has one chunk writes its row of the output; a split
//     row's units write partial sums to a workspace (one per unit), and a
//     second kernel of the same launch closes each row by adding its
//     chunks' partials in chunk order. No float atomics: two calls give
//     the same bits.
// Inside a CTA the units' tiles of 32 entries stream through a ring of two
// shared-memory slots: the entries' metadata (idx, val, mask) is loaded two
// tiles ahead into registers, the gathered rows one tile ahead by cp.async
// (zero-filled for a masked-out entry, none for the tile's padding past its
// last masked-in entry, so an all-padding tile costs its metadata loads
// only). Each staged entry gets c1 * y once in shared memory, with column k
// holding w, so every product of the correction and of the b-vector is one
// FMA: thread t owns a 4 x 4 block (I, J), I <= J, of the upper triangle of
// the (k, k + 1) matrix [corr | b] and reads 4 + 4 operands per entry
// (two 16-byte shared loads for 16 FMAs). At rank 50 that is 91 blocks,
// 1456 products an entry against the 4096 of a full padded square. The
// result is mirrored on write (element (i, j), i <= j, is written to (i, j)
// and (j, i)), so it is exactly symmetric; a row's output goes through
// shared memory so its k * k floats are written coalesced.
//
// Round-off: an element is the sum of one term per masked-in entry, t_l =
// y_il * fl(c1_l y_jl). A unit sums its terms in entry order (one rounding
// per FMA), the closing kernel adds the units' sums in chunk order, so the
// error is at most (chunk + n_chunks - 1) 2^-24 sum_l |t_l| (the - 1 less
// under bf16 gathers, where c1 y is exact), against (L - 1) 2^-24 for one
// sequential sum.
//
// Ranks 65 to 512 take the same design in a wide kernel (als_split_wide_
// kernel, counted als_partials_wide). The first wide design gave
// CTA (row, tile) one 64 x 64 tile of the correction, re-gathered the row's
// entries for every tile with scalar loads of each entry's mask and idx, no
// copy in flight beside the products, three shared loads an FMA, both
// triangles and the 128^2 padding at k = 100 (16 384 products an entry
// against the 5 150 needed), and never split a row. Now the staged row is
// k + 1 floats rounded up to 4 (dynamic shared memory, 3 E (k + 4) floats:
// 40 KB at k = 100), thread t owns block t of the upper triangle (350
// threads at k = 100, two CTAs an SM), two blocks a thread above 384
// blocks (k above 107), and CTA (x, y)
// holds the y-th run of up to 1024 blocks where a rank has more (k >= 176:
// the run's CTAs each stream the units' entries). Rows are split under the
// same plan and closed by the same kernel. An unsplit row's (k, k) output
// does not fit the consumed slabs, so each block is written from
// registers, mirrored: 16-byte stores of (i, 4J..4J + 3) and of its mirror
// (4J + b, 4I..4I + 3) where k % 4 == 0 and the block is off the diagonal,
// else element by element.
//
// Ranks above SPLIT_KMAX = 512 take the tiled kernel (counted
// als_partials_tiled), where a staged tile of k + 1 floats an entry would
// not fit shared memory: CTA (b, t) computes 64 x 64 tile t of row b,
// streaming the row's entries through shared memory twice as wide (the
// tile's 64 row columns and 64 column columns of each gathered row); every
// tile re-reads the row's entries (T^2 times for T = ceil(k / 64) tiles a
// side), from L2. Tile (i, j) and tile (j, i) form each product from the
// commuted pair c1 * (y_i * y_j) in the same entry order, so the result
// stays exactly symmetric. The b-vector is written by the CTAs of tile
// column 0.
//
// K1-bf16 (entry als_partials_bf16): the same kernels reading a bf16 copy of
// the table, as albedo_tpu/ops/als.py bucket_partial_terms does under
// gather_dtype="bfloat16" (_gather :62, the einsums :127-135). The rows are
// staged as bf16 (half the gathered bytes) and widened once per entry; the
// correction's c1 is rounded to bf16 (__float2bfloat16_rn, as JAX casts it
// to the rows' dtype), the b-vector's w = 1 + c1 is not. Each staged
// c1 * y then holds at most 16 significant bits and each product y_i c1 y_j
// at most 24, exact in float32, so only the order of the float32 sums
// differs from JAX.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <mutex>

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
constexpr int THREADS = 256;  // tiled path
constexpr int TILE = 32;      // tiled path: entries per shared-memory tile

// ------------------------------------------------------------ split design

constexpr int E = 32;           // entries per staged tile (one warp's ballot)
constexpr int KP = 68;          // staged row stride: k columns and the w column, in 4-blocks
constexpr int SLAB = E * KP;    // floats of one staged tile
constexpr int NT_MAX = 160;     // threads of a CTA at k = 64 (152 blocks)
constexpr int CLOSE_THREADS = 256;
// Ranks up to SPLIT_KMAX take the split design, the wide kernel above
// KMAX: a staged tile of E rows of k + 1 floats (3 E (k + 4) floats of
// shared memory, WIDE_SMEM_MAX at 512), BPT = 1 block a thread up to
// WIDE_THREADS1 blocks (two CTAs an SM, at most 85 registers a thread),
// else 2 blocks a thread on up to WIDE_THREADS threads. Wider ranks take
// the tiled kernel.
constexpr int SPLIT_KMAX = 512;
constexpr int WIDE_SMEM_MAX = 3 * E * ((SPLIT_KMAX + 4) & ~3) * (int)sizeof(float);
constexpr int WIDE_THREADS1 = 384;
constexpr int WIDE_THREADS = 512;

struct Plan {
  int B, L, k;
  int chunk, n_chunks, per_cta;  // slots a unit, units a row, units a CTA
  int kbi, kbj, n_blocks;        // 4-blocks of the rows, of the columns (k + 1), blocks a unit
  int wb;                        // bytes a cp.async word of a gathered row (8, 4), 0: plain loads
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  const unsigned int s = static_cast<unsigned int>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool ok) {
  const unsigned int s = static_cast<unsigned int>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(src), "r"(ok ? 8 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait1() { asm volatile("cp.async.wait_group 1;\n" ::); }

// Walks a thread's share of an (n, width) grid of a tile, elements tid,
// tid + blockDim.x, ..., as (row, column) pairs without a division per step.
struct Stride {
  int l, c, dl, dc, width;
  __device__ __forceinline__ Stride(int width_) : width(width_) {
    l = threadIdx.x / width;
    c = threadIdx.x - l * width;
    dl = blockDim.x / width;
    dc = blockDim.x - dl * width;
  }
  __device__ __forceinline__ void next() {
    l += dl;
    c += dc;
    if (c >= width) {
      c -= width;
      ++l;
    }
  }
};

// A unit's tile: unit u (row u / n_chunks, chunk u % n_chunks), tile j.
struct Pos {
  int u, j;
};

__device__ __forceinline__ int unit_start(const Plan& p, int u) { return (u % p.n_chunks) * p.chunk; }

// Tiles of unit u: its slots in tiles of E, at least one (an empty unit
// still writes its zeros).
__device__ __forceinline__ int unit_tiles(const Plan& p, int u) {
  const int len = min(p.L - unit_start(p, u), p.chunk);
  return len > 0 ? (len + E - 1) / E : 1;
}

__device__ __forceinline__ Pos advance(const Plan& p, Pos q) {
  return q.j + 1 < unit_tiles(p, q.u) ? Pos{q.u, q.j + 1} : Pos{q.u + 1, 0};
}

// One entry's metadata, held by thread e < E of the CTA for tile position q.
struct Meta {
  int idx;
  float val;
  bool m;
};

__device__ __forceinline__ Meta load_meta(const Plan& p, Pos q, const int* __restrict__ idx,
                                          const float* __restrict__ val,
                                          const unsigned char* __restrict__ mask) {
  Meta r{0, 0.f, false};
  const int start = unit_start(p, q.u);
  const int l = start + q.j * E + threadIdx.x;
  if (l < min(p.L, start + p.chunk)) {
    const long long o = (long long)(q.u / p.n_chunks) * p.L + l;
    r.idx = idx[o];
    r.val = val[o];
    r.m = mask[o] != 0;
  }
  return r;
}

// Per-slot metadata in shared memory.
struct SlotMeta {
  int idx[2][E];
  float c1[2][E];  // rounded to the rows' dtype
  float w[2][E];
  unsigned char m[2][E];
  int nl[2];       // one past the tile's last masked-in entry
};

// T = float: [raw slot 0 | cys | raw slot 1], each `slab` floats (a tile of
// E rows of `kp` floats); the rows are read from their raw slot. T = bf16:
// [raw slots 0, 1 (bf16) | ysf | cys]; the rows are widened into ysf. The
// narrow kernel stages a row's output (k * k <= 4096 floats) in two
// consumed slabs: raw slot s and cys (float), ysf and cys (bf16).
template <typename T>
struct Smem;

template <>
struct Smem<float> {
  static __device__ __forceinline__ float* raw(float* sm, int s, int slab) { return sm + (s ? 2 * slab : 0); }
  static __device__ __forceinline__ float* rows(float* sm, int s, int slab) { return raw(sm, s, slab); }
  static __device__ __forceinline__ float* cys(float* sm, int slab) { return sm + slab; }
  static __device__ __forceinline__ float* out(float* sm, int s) { return sm + (s ? SLAB : 0); }
};

template <>
struct Smem<__nv_bfloat16> {
  static __device__ __forceinline__ __nv_bfloat16* raw(float* sm, int s, int slab) {
    return reinterpret_cast<__nv_bfloat16*>(sm) + s * slab;
  }
  static __device__ __forceinline__ float* rows(float* sm, int, int slab) { return sm + slab; }
  static __device__ __forceinline__ float* cys(float* sm, int slab) { return sm + 2 * slab; }
  static __device__ __forceinline__ float* out(float* sm, int) { return sm + SLAB; }
};

// Issue the copies of slot s's gathered rows (stride kp in the slot):
// entries below the tile's last masked-in one, a masked-out entry
// zero-filled. Rows are copied in p.wb-byte words: 8 (float rows of even k),
// 4 (float rows of odd k, bf16 rows of even k), or 0: bf16 rows of odd k
// (not 4-byte aligned) by plain loads.
template <typename T>
__device__ __forceinline__ void issue_rows(const Plan& p, const T* __restrict__ source, T* raw, int kp,
                                           const SlotMeta& sd, int s) {
  const int nl = sd.nl[s];
  const int k = p.k;
  if (p.wb == 0) {
    for (Stride it(k); it.l < nl; it.next()) {
      const int l = it.l, c = it.c;
      raw[l * kp + c] = sd.m[s][l] ? source[(long long)sd.idx[s][l] * k + c] : Rows<T>::zero();
    }
    return;
  }
  const int wb = p.wb;
  const int words = k * (int)sizeof(T) / wb;
  for (Stride it(words); it.l < nl; it.next()) {
    const int l = it.l, c = it.c;
    const bool m = sd.m[s][l];
    const char* src = reinterpret_cast<const char*>(source + (long long)(m ? sd.idx[s][l] : 0) * k) + c * wb;
    char* dst = reinterpret_cast<char*>(raw + l * kp) + c * wb;
    if (wb == 8) cp_async8(dst, src, m);
    else cp_async4(dst, src, m);
  }
}

// Thread t's 4 x 4 block (I, J), I <= J, of [corr | b], row-major over the
// upper triangle (kbj 4-blocks of columns, b's column included).
__device__ __forceinline__ void block_of(const Plan& p, int t, int& I, int& J) {
  I = 0;
  while (t >= p.kbj - I) {
    t -= p.kbj - I;
    ++I;
  }
  J = I + t;
}

// The split design's walk, shared by the narrow kernel (WIDE false: static
// shared memory, rows of KP floats, one block a thread, an unsplit row's
// output staged through the consumed slabs and written coalesced) and the
// wide one (WIDE true: dynamic shared memory, rows of kp floats, BPT blocks a
// thread, CTA (x, y) holding blocks [y G, (y + 1) G) of the triangle for G =
// BPT blockDim.x, each output block written from registers, mirrored).
template <typename T, int BPT, bool WIDE>
__device__ __forceinline__ void split_body(const Plan& p, float* sm, SlotMeta& sd, int kp,
                                           const T* __restrict__ source, const int* __restrict__ idx,
                                           const float* __restrict__ val, const unsigned char* __restrict__ mask,
                                           float* __restrict__ corr, float* __restrict__ bvec,
                                           float* __restrict__ ws, float alpha) {
  const int tid = threadIdx.x;
  const int u_end = min(p.B * p.n_chunks, ((int)blockIdx.x + 1) * p.per_cta);
  const int k = p.k;
  const int slab = E * kp;

  // This thread's 4 x 4 blocks (I, J) of [corr | b], row-major over I <= J.
  int bt[BPT], I[BPT], J[BPT];
  bool active[BPT];
  float acc[BPT][4][4];
#pragma unroll
  for (int q = 0; q < BPT; ++q) {
    bt[q] = (int)blockIdx.y * BPT * (int)blockDim.x + q * (int)blockDim.x + tid;
    active[q] = bt[q] < p.n_blocks;
    I[q] = J[q] = 0;
    if (active[q]) block_of(p, bt[q], I[q], J[q]);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[q][a][b] = 0.f;
  }

  auto stage_meta = [&](int s, const Meta& r) {
    if (tid < E) {
      const float c1 = r.m ? alpha * r.val : 0.f;
      sd.idx[s][tid] = r.idx;
      sd.c1[s][tid] = Rows<T>::round(c1);
      sd.w[s][tid] = r.m ? 1.f + c1 : 0.f;
      sd.m[s][tid] = r.m;
    }
    if (tid < 32) {
      const unsigned int bal = __ballot_sync(0xffffffffu, tid < E && r.m);
      if (tid == 0) sd.nl[s] = 32 - __clz(bal);
    }
  };

  Pos pc{(int)blockIdx.x * p.per_cta, 0};  // the tile computed this iteration
  Pos pn = advance(p, pc);                 // its rows in flight
  Pos pm = advance(p, pn);                 // its metadata in registers
  Meta reg = tid < E ? load_meta(p, pc, idx, val, mask) : Meta{0, 0.f, false};
  stage_meta(0, reg);
  __syncthreads();
  issue_rows<T>(p, source, Smem<T>::raw(sm, 0, slab), kp, sd, 0);
  cp_async_commit();
  if (tid < E && pn.u < u_end) reg = load_meta(p, pn, idx, val, mask);

  for (int s = 0;; s ^= 1) {
    const bool has_next = pn.u < u_end;
    if (has_next) stage_meta(s ^ 1, reg);
    __syncthreads();  // slot s ^ 1's metadata is staged; the last tile's reads are done
    if (has_next) issue_rows<T>(p, source, Smem<T>::raw(sm, s ^ 1, slab), kp, sd, s ^ 1);
    cp_async_commit();
    if (tid < E && pm.u < u_end) reg = load_meta(p, pm, idx, val, mask);
    cp_async_wait1();
    __syncthreads();  // slot s's rows have landed

    // c1 * y once per staged entry, w in column k (bf16: the rows widened).
    const int nl = sd.nl[s];
    float* rows = Smem<T>::rows(sm, s, slab);
    float* cys = Smem<T>::cys(sm, slab);
    {
      const T* raw = Smem<T>::raw(sm, s, slab);
      for (Stride it(k + 1); it.l < nl; it.next()) {
        const int l = it.l, c = it.c;
        if (c < k) {
          const float y = Rows<T>::widen(raw[l * kp + c]);
          if (sizeof(T) == 2) rows[l * kp + c] = y;
          cys[l * kp + c] = sd.c1[s][l] * y;
        } else {
          cys[l * kp + k] = sd.w[s][l];
        }
      }
    }
    __syncthreads();

#pragma unroll
    for (int q = 0; q < BPT; ++q) {
      if (!active[q]) continue;
      const float* yb = rows + 4 * I[q];
      const float* cb = cys + 4 * J[q];
#pragma unroll 4
      for (int l = 0; l < nl; ++l) {
        const float4 y = *reinterpret_cast<const float4*>(yb + l * kp);
        const float4 c = *reinterpret_cast<const float4*>(cb + l * kp);
        const float ya[4] = {y.x, y.y, y.z, y.w};
        const float ca[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) acc[q][a][b] = fmaf(ya[a], ca[b], acc[q][a][b]);
      }
    }

    if (pc.j == unit_tiles(p, pc.u) - 1) {  // the unit's last tile: write it out
      const int row = pc.u / p.n_chunks;
      if (p.n_chunks == 1 && WIDE) {
        float* out = corr + (long long)row * k * k;
#pragma unroll
        for (int q = 0; q < BPT; ++q) {
          if (!active[q]) continue;
          if ((k & 3) == 0 && I[q] != J[q] && 4 * J[q] + 3 < k) {  // rows 16-byte aligned: (i, 4J..) and (4J + b, 4I..)
#pragma unroll
            for (int a = 0; a < 4; ++a)
              *reinterpret_cast<float4*>(out + (4 * I[q] + a) * k + 4 * J[q]) =
                  make_float4(acc[q][a][0], acc[q][a][1], acc[q][a][2], acc[q][a][3]);
#pragma unroll
            for (int b = 0; b < 4; ++b)
              *reinterpret_cast<float4*>(out + (4 * J[q] + b) * k + 4 * I[q]) =
                  make_float4(acc[q][0][b], acc[q][1][b], acc[q][2][b], acc[q][3][b]);
            continue;
          }
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const int i = 4 * I[q] + a;
#pragma unroll
            for (int b = 0; b < 4; ++b) {
              const int j = 4 * J[q] + b;
              if (i >= k || (I[q] == J[q] && a > b)) continue;
              if (j == k) bvec[(long long)row * k + i] = acc[q][a][b];
              else if (j < k) out[i * k + j] = out[j * k + i] = acc[q][a][b];
            }
          }
        }
      } else if (p.n_chunks == 1) {
        float* so = Smem<T>::out(sm, s);
        __syncthreads();  // every thread is done with the consumed slabs
        if (active[0]) {
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const int i = 4 * I[0] + a;
#pragma unroll
            for (int b = 0; b < 4; ++b) {
              const int j = 4 * J[0] + b;
              if (i >= k || (I[0] == J[0] && a > b)) continue;
              if (j == k) bvec[(long long)row * k + i] = acc[0][a][b];
              else if (j < k) so[i * k + j] = so[j * k + i] = acc[0][a][b];
            }
          }
        }
        __syncthreads();
        float* out = corr + (long long)row * k * k;
        if ((k & 1) == 0) {  // k * k % 4 == 0: the row is 16-byte aligned
          for (int e = tid; e < k * k / 4; e += blockDim.x)
            reinterpret_cast<float4*>(out)[e] = reinterpret_cast<const float4*>(so)[e];
        } else {
          for (int e = tid; e < k * k; e += blockDim.x) out[e] = so[e];
        }
      } else {
#pragma unroll
        for (int q = 0; q < BPT; ++q) {
          if (!active[q]) continue;
          float4* out = reinterpret_cast<float4*>(ws + ((long long)pc.u * p.n_blocks + bt[q]) * 16);
#pragma unroll
          for (int a = 0; a < 4; ++a) out[a] = make_float4(acc[q][a][0], acc[q][a][1], acc[q][a][2], acc[q][a][3]);
        }
      }
#pragma unroll
      for (int q = 0; q < BPT; ++q)
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) acc[q][a][b] = 0.f;
    }
    if (!has_next) break;
    pc = pn;
    pn = pm;
    pm = advance(p, pm);
  }
}

template <typename T>
__global__ void __launch_bounds__(NT_MAX) als_split_kernel(
    Plan p, const T* __restrict__ source, const int* __restrict__ idx,
    const float* __restrict__ val, const unsigned char* __restrict__ mask,
    float* __restrict__ corr, float* __restrict__ bvec, float* __restrict__ ws, float alpha) {
  __shared__ __align__(16) float sm[3 * SLAB];
  __shared__ SlotMeta sd;
  split_body<T, 1, false>(p, sm, sd, KP, source, idx, val, mask, corr, bvec, ws, alpha);
}

// Ranks above 64: rows of kp = k + 1 rounded up to 4 floats in dynamic
// shared memory (3 E kp floats), threads of BPT blocks.
template <typename T, int BPT>
__global__ void __launch_bounds__(BPT == 1 ? WIDE_THREADS1 : WIDE_THREADS, BPT == 1 ? 2 : 1) als_split_wide_kernel(
    Plan p, int kp, const T* __restrict__ source, const int* __restrict__ idx,
    const float* __restrict__ val, const unsigned char* __restrict__ mask,
    float* __restrict__ corr, float* __restrict__ bvec, float* __restrict__ ws, float alpha) {
  extern __shared__ __align__(16) float dsm[];
  __shared__ SlotMeta sd;
  split_body<T, BPT, true>(p, dsm, sd, kp, source, idx, val, mask, corr, bvec, ws, alpha);
}

// Close the split rows: element e of row b's [corr | b] is the sum of its
// n_chunks units' partials in chunk order ((i, j) read at (min, max): the
// upper triangle the units computed).
__global__ void __launch_bounds__(CLOSE_THREADS) als_close_kernel(Plan p, const float* __restrict__ ws,
                                                                  float* __restrict__ corr,
                                                                  float* __restrict__ bvec) {
  const int k = p.k;
  const long long row = blockIdx.x;
  const int e = blockIdx.y * CLOSE_THREADS + threadIdx.x;
  if (e >= k * k + k) return;
  int i, j;
  if (e < k * k) {
    i = e / k;
    j = e - i * k;
    if (i > j) {
      const int t = i;
      i = j;
      j = t;
    }
  } else {
    i = e - k * k;
    j = k;
  }
  const int bi = i >> 2, bj = j >> 2;
  const int blk = bi * p.kbj - bi * (bi - 1) / 2 + (bj - bi);
  const float* part = ws + (row * p.n_chunks * p.n_blocks + blk) * 16 + (i & 3) * 4 + (j & 3);
  const long long stride = (long long)p.n_blocks * 16;
  float s = 0.f;
#pragma unroll 8
  for (int c = 0; c < p.n_chunks; ++c) s += part[c * stride];  // loads run ahead, adds in chunk order
  if (e < k * k) corr[row * k * k + e] = s;
  else bvec[row * k + i] = s;
}

// ------------------------------------------------- tiled path (k > 512)

constexpr int WT = 64;  // output tile side, tiled path
constexpr int W_PER_THREAD = WT * WT / THREADS;

template <typename T>
__global__ void __launch_bounds__(THREADS) als_partials_tiled_kernel(
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

// The wide kernels' opt-in to the shared memory the widest rank takes, once
// per device (up to MAX_DEVICES).
constexpr int MAX_DEVICES = 64;

template <typename T>
cudaError_t wide_attributes() {
  static std::mutex lock;
  static bool done[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  const std::lock_guard<std::mutex> hold(lock);
  if (done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(als_split_wide_kernel<T, 1>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             WIDE_SMEM_MAX);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(als_split_wide_kernel<T, 2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               WIDE_SMEM_MAX);
  done[dev] = err == cudaSuccess;
  return err;
}

template <typename T>
int launch(const T* source, const int* idx, const float* val, const unsigned char* mask,
           float* corr, float* bvec, int B, int L, int k, float alpha, int chunk, int n_chunks,
           int per_cta, float* ws, cudaStream_t stream) {
  if (k < 1 || B < 0 || L < 0) return (int)cudaErrorInvalidValue;
  if (k > SPLIT_KMAX) {
    if (B > 0) {
      const int tiles = (k + WT - 1) / WT;
      als_partials_tiled_kernel<T><<<dim3(B, tiles * tiles < 65535 ? tiles * tiles : 65535), THREADS, 0,
                                      stream>>>(source, idx, val, mask, corr, bvec, L, k, alpha);
    }
    return (int)cudaGetLastError();
  }
  // The plan (ops/als.py _k1_plan): chunks of whole tiles covering the row
  // once, several units a CTA only for unsplit rows, a workspace for split ones.
  const long long need = L > 0 ? ((long long)L + chunk - 1) / chunk : 1;
  if (chunk < E || chunk % E != 0 || n_chunks != need || per_cta < 1 || (n_chunks > 1 && per_cta != 1) ||
      (n_chunks > 1 && ws == nullptr) || (long long)B * n_chunks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaGetLastError();
  // Words of 8 bytes where every row starts 8-byte aligned, else 4 (bf16:
  // 4-byte aligned rows, else plain loads).
  const unsigned long long base = reinterpret_cast<unsigned long long>(source);
  const bool even = (k & 1) == 0;
  const int wb = sizeof(T) == 4 ? (even && base % 8 == 0 ? 8 : 4) : (even && base % 4 == 0 ? 4 : 0);
  Plan p{B, L, k, chunk, n_chunks, per_cta, (k + 3) / 4, (k + 4) / 4, 0, wb};
  p.n_blocks = p.kbi * p.kbj - p.kbi * (p.kbi - 1) / 2;
  const int units = B * n_chunks;
  const int grid = (units + per_cta - 1) / per_cta;
  if (k <= KMAX) {
    als_split_kernel<T><<<grid, (p.n_blocks + 31) / 32 * 32, 0, stream>>>(p, source, idx, val, mask, corr, bvec,
                                                                          ws, alpha);
  } else {
    // BPT blocks a thread, groups of BPT x threads blocks along the grid's y.
    const int kp = (k + 4) & ~3;
    const int smem = 3 * E * kp * (int)sizeof(float);
    const int bpt = p.n_blocks <= WIDE_THREADS1 ? 1 : 2;
    const int per = (p.n_blocks + bpt - 1) / bpt;
    const int threads = per < WIDE_THREADS ? (per + 31) / 32 * 32 : WIDE_THREADS;
    const dim3 grid2(grid, (p.n_blocks + bpt * threads - 1) / (bpt * threads));
    const cudaError_t err = wide_attributes<T>();
    if (err != cudaSuccess) return (int)err;
    if (bpt == 1)
      als_split_wide_kernel<T, 1><<<grid2, threads, smem, stream>>>(p, kp, source, idx, val, mask, corr, bvec, ws,
                                                                    alpha);
    else
      als_split_wide_kernel<T, 2><<<grid2, threads, smem, stream>>>(p, kp, source, idx, val, mask, corr, bvec, ws,
                                                                    alpha);
  }
  if (n_chunks > 1)
    als_close_kernel<<<dim3(B, (k * k + k + CLOSE_THREADS - 1) / CLOSE_THREADS), CLOSE_THREADS, 0, stream>>>(
        p, ws, corr, bvec);
  return (int)cudaGetLastError();
}

}  // namespace

// source (n, k) f32; idx, val, mask (B, L); corr (B, k, k), bvec (B, k) f32;
// any k >= 1 (k > 512 takes the tiled path, which ignores the plan). The
// plan of k <= 512: chunk slots a unit (a multiple of 32), n_chunks = ceil(L /
// chunk) units a row (1 when L == 0), per_cta units a CTA (1 when n_chunks >
// 1), and ws, B * n_chunks * 16 * blocks floats (blocks = the 4 x 4 blocks
// of [corr | b]: ops/als.py k1_blocks), when n_chunks > 1.
// Returns cudaGetLastError() after the launches (0 = launched;
// cudaErrorInvalidValue for a plan that does not cover the rows).
extern "C" int als_partials_launch(const float* source, const int* idx, const float* val,
                                   const unsigned char* mask, float* corr, float* bvec, int B, int L,
                                   int k, float alpha, int chunk, int n_chunks, int per_cta, float* ws,
                                   void* stream) {
  return launch<float>(source, idx, val, mask, corr, bvec, B, L, k, alpha, chunk, n_chunks, per_cta, ws,
                       (cudaStream_t)stream);
}

// K1-bf16: as als_partials_launch, with source (n, k) bf16.
extern "C" int als_partials_bf16_launch(const void* source, const int* idx, const float* val,
                                        const unsigned char* mask, float* corr, float* bvec, int B,
                                        int L, int k, float alpha, int chunk, int n_chunks, int per_cta,
                                        float* ws, void* stream) {
  return launch<__nv_bfloat16>((const __nv_bfloat16*)source, idx, val, mask, corr, bvec, B, L, k, alpha,
                               chunk, n_chunks, per_cta, ws, (cudaStream_t)stream);
}
