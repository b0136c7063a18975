// The gated RMSNorm over split rows for Hopper (sm_90a): the statistic and
// apply launches of its forward and of its backward.
//
// Replaces: under a model axis, src/repro/kernels/rmsnorm/kernel.py,
// fused_rmsnorm_fwd, over a row split across ranks (the gated form,
// rmsnorm(y * silu(z), w) of src/repro/models/layers.py:518), and the
// gradient the reference takes of it (src/repro/models/layers.py:47). Each
// rank holds a block of d columns of the row (its SSM heads' columns of
// d_inner); the mean is over the whole row of dn. So each way is two
// launches with an all-reduce of a few floats a row between them:
//   statistic  (split_stat_kernel)      out[row] = sum over the block of g^2
//   apply      (split_apply_kernel)     y = g * rsqrt(stats[row] / dn + eps) * w
//   statistic  (split_bwd_stat_kernel)  out[row] = (sum g^2, sum w dh g)
//   apply      (split_bwd_apply_kernel) dy, dz and the block's dw, given both sums
// with g = bf16(bf16(y) * bf16(silu(z))), silu = z / (1 + expf(-z)) in f32
// as PyTorch's CUDA kernel computes it (float32: no rounding), and the
// backward's roundings those of the one-launch norm's (rmsnorm.cu,
// rmsnorm_bwd_kernel): the blocks put together give its bits but for the
// order of the row sums.
//
// Bound on this card: bytes, every launch. An element moves 6 B in the
// statistic (the f32 y and the bf16 gate read), 8 B in the apply (and the
// output written), 8 B in the backward statistic (y, z, dh), 14 B in the
// backward apply (y, z, dh read, the f32 dy and dz written); a few floats a
// row and w, dw once. ~15-30 flops an element (an expf, one or two IEEE
// divides) are nothing beside the 295 flops a byte the H100 affords. At
// rank 0's block of the serving shapes (kernels/cost.py, 3.35 TB/s):
//   mamba2 prefill (16384, 768 of 1536)   0.02256  0.03007  0.03009  0.05263 ms
//   jamba prefill  (8192, 4096 of 8192)   0.06011  0.08014  0.08015  0.14026 ms
// (statistic, apply, backward statistic, backward apply).
//
// What held the previous version back (the one-launch kernels of rmsnorm.cu
// run with a statistic output or the summed statistics, PR 26), and what
// this design does about it:
//  1. One vector width a launch. Mamba2's gate is a column slice of the
//     rank's in_proj output, whose row of 2 d + 2 N + H / ranks = 1804 bf16
//     (3608 B) starts on 8 bytes but not on 16, so every tensor of the
//     launch, y, w, dh, the outputs, went one element at a time (and the
//     scalar path had no prefetch). Here each tensor takes its own width:
//     y, w, dh, the outputs and dw's shares, contiguous, 16-byte vectors
//     (VE = 8 elements a chunk); the gate the widest its base and row stride
//     allow, ZB = 16, 8, 4 or 2 bytes a load (TMA cannot serve it: a tensor
//     map's strides are multiples of 16 bytes). The wrapper computes both
//     (ops.split_widths); a gate width not instantiated is refused. Rows
//     whose width is not a multiple of 8, or contiguous tensors off 16
//     bytes, take the scalar path (VE = 1, every tensor an element a load).
//  2. The statistic launches ran the whole norm: w loaded, the row held in
//     registers across a barrier, one row a block at a time. Here they are
//     streaming reductions of their own: no w forward, nothing written but
//     the row sums, a team of tpr threads a row and several rows a block
//     of BLOCK threads; a team's warps add their shuffled sums in shared
//     memory in a fixed order. Their rows, read once, are loads the L2
//     evicts first (STAT_LOADS), so they do not evict the lines others
//     hold (the dirty ones a predecessor left among them).
//  3. The backward issued a row's loads only after the previous row's
//     stores and read w twice a row (512 threads of one vector each, one
//     block an SM, at Jamba's 4096). Here both apply launches hold w in
//     registers for every row a thread takes, and issue the next row's
//     loads (and its row sums) once this row's outputs are computed, before
//     they are stored (PREFETCH; not in float32, whose raw loads would take
//     its outputs' registers). They reduce nothing over a row, so their
//     warps never wait on a barrier; the backward apply's dw share is summed
//     over a block's teams once, at its end, and split_dw_kernel adds the
//     blocks' shares, each in a fixed order: two calls give the same bits.
// Prefill (more than FEW_ROWS rows): the narrowest team (PER chunks a
// thread), a one-wave grid from occupancy (at most BWD_MAX_BLOCKS blocks in
// the backward apply), teams walking rows grid-stride. Decode: one row a
// block, its team as wide as the launch bound allows, and a row of fewer
// than DECODE_SCALAR_BELOW chunks (Mamba2's 768 columns) an element a
// thread on the scalar instantiation: the shortest chain of math a thread.
// A chunk past a row's end is never computed on (on stale registers the
// apply launches lost up to 15 % at Mamba2's prefill). Launches go through
// cudaLaunchKernel, allocate nothing and do not synchronise: the decode
// step's CUDA graph captures them. Rows up to 8192 wide on the vector path,
// 4096 on the scalar one.
//
// Measured on an H100 80GB HBM3 at 700 W with tools/split_norm_compare.py
// (PR 30's last run; PR 26's kernels, "pr26", built from the parent's
// rmsnorm.cu in the same call, in turns, each reading the mean of two).
// Prefill, one launch a graph replay, the L2 flushed by a write, us,
// mamba2 (16384, 768 of 1536) / jamba (8192, 4096 of 8192), in the order
// statistic, apply, backward statistic, backward apply:
//   this source  38.35/82.96  48.08/103.59  47.01/108.22   83.25/179.41
//   pr26         56.65/85.52  65.96/101.57  76.39/151.01  123.65/309.50
//   no-stream    42.10/85.36                52.46/107.47
//   narrow-gate  38.38/84.25  52.80/127.40  49.17/109.89   84.93/180.18
//     (the gate an element a load, the other tensors in vectors)
//   no-prefetch               48.08/104.24                 86.00/177.18
//   stat-per-1   37.27/84.76   (one chunk a thread: 1024-thread teams at
//     Jamba; with a clean L2 34.60/83.88 against 35.87/76.86)
//   apply-per-4               47.61/105.59                 98.10/209.41
//   block-256    38.94/83.09  47.41/104.41  48.79/106.07   84.10/179.06
// A flush by a write leaves ~50 MB of dirty L2 lines that a launch's reads
// evict to memory; with a clean L2 this source reads 35.87, 40.61, 42.90,
// 77.34 us at mamba2 (63-74 % of the bound) and 76.86, 95.00, 96.50,
// 171.45 at jamba (78-84 %).
// Decode, one launch of 64 captured in a graph, us, mamba2 (8, 768) /
// jamba (4, 4096):
//   this source  1.99/2.57  2.19/2.58  2.15/2.87  3.62/5.54
//   pr26         2.04/2.72  2.32/2.99  2.54/2.87  5.04/6.89
//   no-few-rows  2.73/2.89  2.65/2.92  3.08/3.29  6.74/6.31 (prefill's plan)
//   decode-per   2.06/2.89  2.08/2.92  2.33/3.31  3.98/6.33 (PER a thread)
//   mamba2 on the vector path 2.15, 2.05, 2.45, 4.06; jamba on the scalar
//   one 2.90, 3.12, 3.20, 5.38
// The statistic's last sum of warp partials is serial in one thread (a
// five-step shuffle tree read 2.09 us at mamba2's decode in an earlier
// run); the backward statistic's two by shuffles (two serial sums of 16
// partials read 2.96 at jamba's).
// ptxas (-O3, sm_90a): 44-56 registers (statistic), 48-88 (apply), 47-91
// (backward statistic), 59-123 and 249 in float32 (backward apply, 4096 B
// of shared memory); no spill in the 37 instantiations.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int FEW_ROWS = 128;        // rows <= FEW_ROWS: one row a block (decode)
constexpr int DECODE_SCALAR_BELOW = 256;  // decode rows of fewer chunks: an element a thread
constexpr int BLOCK = 128;           // a block's threads where it holds several rows
constexpr int PER_STAT = 2;          // chunks a thread and row: forward statistic,
constexpr int PER_BWD_STAT = 2;      //   backward statistic (w in registers),
constexpr int PER_APPLY = 2;         //   the apply launches,
constexpr int PER_APPLY_F32 = 4;     //   the float32 backward apply,
constexpr int PER_SCALAR = 4;        //   every launch on the scalar path
constexpr bool PREFETCH = true;      // apply: the next row's loads before this row's stores
constexpr int BWD_MAX_BLOCKS = 1024;  // scratch rows of dw shares at most
constexpr int DW_COLS = 32, DW_GROUPS = 16;  // split_dw_kernel's block

enum Kind { STAT = 0, APPLY = 1, BWD_STAT = 2, BWD_APPLY = 3 };

// Chunks a thread of an instantiation (esize: its element's bytes). The
// float32 backward apply takes four: at two, a launch bound of 512 threads
// left it 128 registers, and it spilled.
__host__ __device__ constexpr int per_of(int kind, int ve, int esize) {
  return ve == 1 ? PER_SCALAR
         : kind == STAT ? PER_STAT
         : kind == BWD_STAT ? PER_BWD_STAT
         : kind == BWD_APPLY && esize == 4 ? PER_APPLY_F32 : PER_APPLY;
}
// A launch's most threads: one team over the widest row, 8192 columns in
// chunks of 8 or 4096 of one.
__host__ __device__ constexpr int max_threads(int kind, int ve, int esize) {
  return (ve == 8 ? 8192 / 8 : 4096) / per_of(kind, ve, esize);
}

__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }
template <typename T>
__device__ __forceinline__ T from_f32(float v) {
  if constexpr (sizeof(T) == 2) {
    return __float2bfloat16(v);
  } else {
    return v;
  }
}
// A value rounded to the element type T where the unfused chain rounds it:
// to bf16, or not at all in float32.
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// How a load is cached: through the L2 (ld.global.cg: data another kernel
// may have just written), through the L2 evicted first (ld.global.cs: the
// statistic launches' rows, read once, so they do not push out the lines
// others hold), or through the read-only path (w, which nothing writes).
enum Cache { LD_CG, LD_CS, LD_RO };
constexpr Cache STAT_LOADS = LD_CS;     // the statistic launches' row loads

template <int B> struct Word;
template <> struct Word<16> { using T = uint4; };
template <> struct Word<8> { using T = uint2; };
template <> struct Word<4> { using T = unsigned int; };
template <> struct Word<2> { using T = unsigned short; };

// N values of T at src in loads of B bytes, cached as C says.
template <int B, Cache C = LD_CG, int N, typename T>
__device__ __forceinline__ void load(const T* src, T (&dst)[N]) {
  using W = typename Word<B>::T;
  static_assert(N * sizeof(T) % B == 0, "a chunk is whole loads");
#pragma unroll
  for (int i = 0; i < int(N * sizeof(T) / B); ++i) {
    const W* q = reinterpret_cast<const W*>(src) + i;
    if constexpr (C == LD_RO) {
      reinterpret_cast<W*>(dst)[i] = __ldg(q);
    } else if constexpr (C == LD_CS) {
      reinterpret_cast<W*>(dst)[i] = __ldcs(q);
    } else {
      reinterpret_cast<W*>(dst)[i] = __ldcg(q);
    }
  }
}

template <int B, int N, typename T>
__device__ __forceinline__ void store(T* dst, const T (&src)[N]) {
  using W = typename Word<B>::T;
#pragma unroll
  for (int i = 0; i < int(N * sizeof(T) / B); ++i)
    reinterpret_cast<W*>(dst)[i] = reinterpret_cast<const W*>(src)[i];
}

// Tensors in the element type Elt (bf16 or float32) but y, w, dy, the
// scratch and the row sums, which are float32.
struct SplitParams {
  const float* y;      // (rows, d), contiguous
  const void* z;       // gate (rows, d) at row stride zs
  const float* w;      // (d,)
  const void* dh;      // backward: (rows, d), contiguous
  void* out;           // forward apply: (rows, d); backward apply: the f32 dy
  void* dz;            // backward apply: (rows, d), contiguous
  float* part;         // backward apply: (grid, d), each block's share of dw
  float* stat_out;     // statistic launches: (rows,) or (rows, 2)
  const float* stats;  // apply launches: (rows,) or (rows, 2), summed over the ranks
  int rows, d, dn;
  int tpr;             // threads a row: a team; a block holds blockDim / tpr teams
  int64_t zs;
  float eps;
};

// A thread's team (its row of the block's rows) and place in it. With one
// row a block (decode) no integer divide precedes the first loads.
struct Place {
  int team, t, rpb;
};
__device__ __forceinline__ Place place(int tpr) {
  if (tpr == int(blockDim.x)) return {0, int(threadIdx.x), 1};
  const int team = threadIdx.x / tpr;
  return {team, int(threadIdx.x) - team * tpr, int(blockDim.x) / tpr};
}

// One row's raw loads of a thread: y, the gate and dh of its chunks (chunk
// k is columns (t + k tpr) VE .. + VE), and the row's summed statistics
// (the apply launches').
template <typename Elt, int VE, int PER>
struct Row {
  alignas(16) float y[PER][VE];
  alignas(16) Elt z[PER][VE];
  alignas(16) Elt h[PER][VE];
  float s[2];
};

// Issues the loads of one row, every one before any is used: y (and dh,
// DH) in 16-byte vectors (VE 8) or elements, the gate in ZB-byte loads, and
// NS summed statistics; the rows cached as C says.
template <bool DH, int NS, int ZB, Cache C = LD_CG, typename Elt, int VE, int PER>
__device__ __forceinline__ void load_row(const SplitParams& p, int row, int t,
                                         Row<Elt, VE, PER>& r) {
  constexpr int YB = VE == 8 ? 16 : 4, HB = VE == 8 ? 16 : sizeof(Elt);
  if (row >= p.rows) return;
  const int nvec = p.d / VE;
  const float* y = p.y + (int64_t)row * p.d;
  const Elt* z = static_cast<const Elt*>(p.z) + (int64_t)row * p.zs;
  const Elt* h = static_cast<const Elt*>(p.dh) + (int64_t)row * p.d;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int v = t + k * p.tpr;
    if (v < nvec) {
      load<YB, C>(y + v * VE, r.y[k]);
      load<ZB, C>(z + v * VE, r.z[k]);
      if constexpr (DH) load<HB, C>(h + v * VE, r.h[k]);
    }
  }
#pragma unroll
  for (int i = 0; i < NS; ++i) r.s[i] = __ldcg(p.stats + NS * row + i);
}

// Whether an apply instantiation issues the next row's loads before this
// row's stores: the bf16 vector path (float32's raw loads of the next row
// would take the registers of its outputs).
template <typename Elt, int VE>
__host__ __device__ constexpr bool prefetches() {
  return PREFETCH && VE == 8 && sizeof(Elt) == 2;
}

// w of a thread's chunks, once: the same columns for every row it takes.
template <int VE, int PER>
__device__ __forceinline__ void load_w(const SplitParams& p, int t, float (&wv)[PER][VE]) {
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int v = t + k * p.tpr;
    if (v < p.d / VE) {
      load<VE == 8 ? 16 : 4, LD_RO>(p.w + v * VE, wv[k]);
    } else {
#pragma unroll
      for (int j = 0; j < VE; ++j) wv[k][j] = 0.f;
    }
  }
}

// silu(z) rounded to Elt, e = expf(-z)
template <typename Elt>
__device__ __forceinline__ float silu_to(float z, float e) {
  return round_to<Elt>(z / (1.f + e));
}
// g = bf16(bf16(y) * bf16(silu(z))) (float32: unrounded)
template <typename Elt>
__device__ __forceinline__ float gated(float y, Elt zr) {
  const float z = to_f32(zr);
  return round_to<Elt>(round_to<Elt>(y) * silu_to<Elt>(z, expf(-z)));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
// The sum of a team's n warp partials (n <= 32) in order, by one thread:
// every load issued at once, then the adds (the forward statistic's; a
// shuffle tree's five dependent steps took longer at Mamba2's decode, where
// this sum is on the launch's path).
__device__ __forceinline__ float partials_sum(const float* part, int n) {
  float v[32];
#pragma unroll
  for (int u = 0; u < 32; ++u) v[u] = u < n ? part[u] : 0.f;
  float tot = 0.f;
#pragma unroll
  for (int u = 0; u < 32; ++u) tot += v[u];
  return tot;
}

// Statistic: stat_out[row] = the f32 sum of g^2 over the block's columns.
// (Chunks past the row's end are never computed on: their registers hold
// whatever was there, and an IEEE divide of such a value may take its slow
// path.)
template <typename Elt, int VE, int ZB>
__global__ void __launch_bounds__(max_threads(STAT, VE, sizeof(Elt)))
    split_stat_kernel(const SplitParams p) {
  constexpr int PER = per_of(STAT, VE, sizeof(Elt));
  __shared__ float red[2][32];  // the warps' partials, two row groups' worth
  const Place q = place(p.tpr);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, wpt = p.tpr >> 5;
  const int nvec = p.d / VE;
  int buf = 0;
  for (int grp = blockIdx.x; grp * q.rpb < p.rows; grp += gridDim.x, buf ^= 1) {
    const int row = grp * q.rpb + q.team;
    Row<Elt, VE, PER> cur;
    load_row<false, 0, ZB, STAT_LOADS>(p, row, q.t, cur);
    float sq = 0.f;
    if (row < p.rows) {
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        if (q.t + k * p.tpr < nvec) {
#pragma unroll
          for (int j = 0; j < VE; ++j) {
            const float g = gated<Elt>(cur.y[k][j], cur.z[k][j]);
            sq += g * g;
          }
        }
      }
    }
    sq = warp_sum(sq);
    if (wpt == 1) {  // a team of one warp: no shared memory, no barrier
      if (lane == 0 && row < p.rows) p.stat_out[row] = sq;
    } else {
      if (lane == 0) red[buf][warp] = sq;
      __syncthreads();  // every warp's partial of this group is in
      if (q.t == 0 && row < p.rows) p.stat_out[row] = partials_sum(red[buf] + q.team * wpt, wpt);
    }
  }
}

// Backward statistic: stat_out[2 row], [2 row + 1] = the sums over the
// block of g^2 and of w dh g.
template <typename Elt, int VE, int ZB>
__global__ void __launch_bounds__(max_threads(BWD_STAT, VE, sizeof(Elt)))
    split_bwd_stat_kernel(const SplitParams p) {
  constexpr int PER = per_of(BWD_STAT, VE, sizeof(Elt));
  __shared__ float red[2][2][32];  // the warps' two partials, two row groups' worth
  const Place q = place(p.tpr);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, wpt = p.tpr >> 5;
  const int nvec = p.d / VE;
  alignas(16) float wv[PER][VE];
  load_w<VE, PER>(p, q.t, wv);
  int buf = 0;
  for (int grp = blockIdx.x; grp * q.rpb < p.rows; grp += gridDim.x, buf ^= 1) {
    const int row = grp * q.rpb + q.team;
    Row<Elt, VE, PER> cur;
    load_row<true, 0, ZB, STAT_LOADS>(p, row, q.t, cur);
    float sq = 0.f, dot = 0.f;
    if (row < p.rows) {
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        if (q.t + k * p.tpr < nvec) {
#pragma unroll
          for (int j = 0; j < VE; ++j) {
            const float g = gated<Elt>(cur.y[k][j], cur.z[k][j]);
            sq += g * g;
            dot += wv[k][j] * to_f32(cur.h[k][j]) * g;
          }
        }
      }
    }
    sq = warp_sum(sq);
    dot = warp_sum(dot);
    if (wpt == 1) {
      if (lane == 0 && row < p.rows) p.stat_out[2 * row] = sq, p.stat_out[2 * row + 1] = dot;
    } else {
      if (lane == 0) red[buf][0][warp] = sq, red[buf][1][warp] = dot;
      __syncthreads();  // every warp's two partials of this group are in
      if (q.t < 32) {  // the team's first warp adds its warps' two partials
        // (by shuffles: two sums of 16 partials by one thread were slower
        // at Jamba's decode)
        const int u = q.team * wpt + lane;
        const float s0 = warp_sum(lane < wpt ? red[buf][0][u] : 0.f);
        const float s1 = warp_sum(lane < wpt ? red[buf][1][u] : 0.f);
        if (lane == 0 && row < p.rows) p.stat_out[2 * row] = s0, p.stat_out[2 * row + 1] = s1;
      }
    }
  }
}

// Apply: y = g * rsqrt(stats[row] / dn + eps) * w, in Elt.
template <typename Elt, int VE, int ZB>
__global__ void __launch_bounds__(max_threads(APPLY, VE, sizeof(Elt)))
    split_apply_kernel(const SplitParams p) {
  constexpr int PER = per_of(APPLY, VE, sizeof(Elt));
  constexpr int OB = VE == 8 ? 16 : sizeof(Elt);
  constexpr bool prefetch = prefetches<Elt, VE>();
  const Place q = place(p.tpr);
  const int nvec = p.d / VE, step = gridDim.x * q.rpb;
  alignas(16) float wv[PER][VE];
  load_w<VE, PER>(p, q.t, wv);
  Row<Elt, VE, PER> cur;
  int row = blockIdx.x * q.rpb + q.team;
  if (prefetch) load_row<false, 1, ZB>(p, row, q.t, cur);
  for (; row < p.rows; row += step) {
    if (!prefetch) load_row<false, 1, ZB>(p, row, q.t, cur);
    const float inv = rsqrtf(cur.s[0] / (float)p.dn + p.eps);
    alignas(16) Elt o[PER][VE];
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      if (q.t + k * p.tpr < nvec) {
#pragma unroll
        for (int j = 0; j < VE; ++j)
          o[k][j] = from_f32<Elt>(gated<Elt>(cur.y[k][j], cur.z[k][j]) * inv * wv[k][j]);
      }
    }
    // the next row's loads fly while this one is written
    if (prefetch) load_row<false, 1, ZB>(p, row + step, q.t, cur);
    Elt* out = static_cast<Elt*>(p.out) + (int64_t)row * p.d;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int v = q.t + k * p.tpr;
      if (v < nvec) store<OB>(out + v * VE, o[k]);
    }
  }
}

// Backward apply, given both row sums over every block: dy (f32), dz (Elt)
// and this block's share of dw (part[blockIdx.x]).
template <typename Elt, int VE, int ZB>
__global__ void __launch_bounds__(max_threads(BWD_APPLY, VE, sizeof(Elt)))
    split_bwd_apply_kernel(const SplitParams p) {
  constexpr int PER = per_of(BWD_APPLY, VE, sizeof(Elt));
  constexpr int YB = VE == 8 ? 16 : 4, OB = VE == 8 ? 16 : sizeof(Elt);
  constexpr bool prefetch = prefetches<Elt, VE>();
  __shared__ float red[VE][BLOCK];  // the teams' dw shares, one chunk at a time
  const Place q = place(p.tpr);
  const int nvec = p.d / VE, step = gridDim.x * q.rpb;
  alignas(16) float wv[PER][VE], acc[PER][VE];
  load_w<VE, PER>(p, q.t, wv);
#pragma unroll
  for (int k = 0; k < PER; ++k)
#pragma unroll
    for (int j = 0; j < VE; ++j) acc[k][j] = 0.f;
  Row<Elt, VE, PER> cur;
  int row = blockIdx.x * q.rpb + q.team;
  if (prefetch) load_row<true, 2, ZB>(p, row, q.t, cur);
  for (; row < p.rows; row += step) {
    if (!prefetch) load_row<true, 2, ZB>(p, row, q.t, cur);
    const float rstd = rsqrtf(cur.s[0] / (float)p.dn + p.eps);
    const float mean = cur.s[1] * rstd / (float)p.dn;  // mean(w dh s^)
    alignas(16) float dy[PER][VE];
    alignas(16) Elt dzo[PER][VE];
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      if (q.t + k * p.tpr < nvec) {
#pragma unroll
        for (int j = 0; j < VE; ++j) {
          const float u = round_to<Elt>(cur.y[k][j]), zz = to_f32(cur.z[k][j]);
          const float dh = to_f32(cur.h[k][j]), e = expf(-zz);
          const float sz = silu_to<Elt>(zz, e), sig = 1.f / (1.f + e);
          const float sh = round_to<Elt>(u * sz) * rstd;
          acc[k][j] += dh * sh;
          const float dg = round_to<Elt>(rstd * (wv[k][j] * dh - sh * mean));
          dy[k][j] = round_to<Elt>(dg * sz);
          dzo[k][j] = from_f32<Elt>(round_to<Elt>(dg * u) * sig * (1.f + zz * (1.f - sig)));
        }
      }
    }
    // the next row's loads fly while this one is written
    if (prefetch) load_row<true, 2, ZB>(p, row + step, q.t, cur);
    float* dyr = static_cast<float*>(p.out) + (int64_t)row * p.d;
    Elt* dzr = static_cast<Elt*>(p.dz) + (int64_t)row * p.d;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int v = q.t + k * p.tpr;
      if (v < nvec) {
        store<YB>(dyr + v * VE, dy[k]);
        store<OB>(dzr + v * VE, dzo[k]);
      }
    }
  }
  // the block's share of dw: its teams' shares added in team order
  float* share = p.part + (int64_t)blockIdx.x * p.d;
  if (q.rpb == 1) {
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int v = q.t + k * p.tpr;
      if (v < nvec) store<YB>(share + v * VE, acc[k]);
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < PER; ++k) {
#pragma unroll
    for (int j = 0; j < VE; ++j) red[j][threadIdx.x] = acc[k][j];
    __syncthreads();  // every team's share of chunk k is in
    const int v = q.t + k * p.tpr;
    if (q.team == 0 && v < nvec) {
      alignas(16) float s[VE];
#pragma unroll
      for (int j = 0; j < VE; ++j) {
        float a = 0.f;
        for (int r = 0; r < q.rpb; ++r) a += red[j][r * p.tpr + q.t];
        s[j] = a;
      }
      store<YB>(share + v * VE, s);
    }
    __syncthreads();  // read before the next chunk overwrites
  }
}

// dw[c] = the blocks' shares of column c added in a fixed order: group gy of
// a (DW_COLS, DW_GROUPS) block adds shares gy, gy + DW_GROUPS, ..., then
// group 0 adds the groups' sums in order.
__global__ void __launch_bounds__(DW_COLS * DW_GROUPS) split_dw_kernel(
    const float* part, float* dw, int blocks, int d) {
  __shared__ float grp[DW_GROUPS][DW_COLS + 1];
  const int cx = threadIdx.x, gy = threadIdx.y;
  const int c = blockIdx.x * DW_COLS + cx;
  float s = 0.f;
  if (c < d)
    for (int b = gy; b < blocks; b += DW_GROUPS) s += part[(int64_t)b * d + c];
  grp[gy][cx] = s;
  __syncthreads();  // the groups' sums are in
  if (gy == 0 && c < d) {
    float t = 0.f;
    for (int i = 0; i < DW_GROUPS; ++i) t += grp[i][cx];
    dw[c] = t;
  }
}

// The launch geometry of one call.
struct Plan {
  int grid, threads, tpr, per, ve, zb;
};

int ceil_div(int a, int b) { return (a + b - 1) / b; }
int round_warp(int n) { return ceil_div(n, 32) * 32; }

template <typename Elt, int VE, int ZB>
const void* instance(int kind) {
  switch (kind) {
    case STAT: return (const void*)split_stat_kernel<Elt, VE, ZB>;
    case APPLY: return (const void*)split_apply_kernel<Elt, VE, ZB>;
    case BWD_STAT: return (const void*)split_bwd_stat_kernel<Elt, VE, ZB>;
    default: return (const void*)split_bwd_apply_kernel<Elt, VE, ZB>;
  }
}

// The instantiation of a launch: the vector path (ve 8) with the gate in
// 16-, 8-, 4- or (bf16) 2-byte loads, or the scalar path (ve 1, the gate an
// element a load); null for any other width.
template <typename Elt>
const void* find_kernel(int kind, int ve, int zb) {
  if (ve == 1) return zb == int(sizeof(Elt)) ? instance<Elt, 1, sizeof(Elt)>(kind) : nullptr;
  if (ve != 8) return nullptr;
  switch (zb) {
    case 16: return instance<Elt, 8, 16>(kind);
    case 8: return instance<Elt, 8, 8>(kind);
    case 4: return instance<Elt, 8, 4>(kind);
    case 2:
      if constexpr (sizeof(Elt) == 2) {
        return instance<Elt, 8, 2>(kind);
      } else {
        return nullptr;
      }
    default: return nullptr;
  }
}

// A team of tpr threads a row, each at most PER chunks. Up to FEW_ROWS rows
// (decode) one row a block, its team as wide as the launch bound allows (the
// fewest chunks a thread: one round trip, over as many SMs as rows); more
// rows (prefill) the narrowest team, BLOCK / tpr teams a block where a team
// is narrower than BLOCK. A one-wave grid from occupancy.
template <typename Elt>
cudaError_t plan(Plan* pl, const void** kernel, int kind, int rows, int d, int vec, int zb) {
  pl->ve = vec ? 8 : 1;
  if (rows <= 0 || d <= 0 || d % pl->ve) return cudaErrorInvalidValue;
  if (!find_kernel<Elt>(kind, pl->ve, zb)) return cudaErrorInvalidValue;  // no such width
  int nvec = d / pl->ve, most = max_threads(kind, pl->ve, sizeof(Elt));
  if (round_warp(ceil_div(nvec, per_of(kind, pl->ve, sizeof(Elt)))) > most)
    return cudaErrorInvalidValue;  // wider than the kernels take
  if (rows <= FEW_ROWS && pl->ve == 8 && round_warp(nvec) < DECODE_SCALAR_BELOW) {
    // a narrow decode row: an element a thread spreads it over the most
    // threads, the shortest chain of math each (the row's bytes are few)
    pl->ve = 1, zb = sizeof(Elt), nvec = d, most = max_threads(kind, 1, sizeof(Elt));
  }
  *kernel = find_kernel<Elt>(kind, pl->ve, zb);
  pl->zb = zb;
  pl->per = per_of(kind, pl->ve, sizeof(Elt));
  pl->tpr = round_warp(ceil_div(nvec, pl->per));
  int rpb = pl->tpr < BLOCK ? BLOCK / pl->tpr : 1;
  if (rows <= FEW_ROWS) {
    pl->tpr = round_warp(nvec) < most ? round_warp(nvec) : most;
    rpb = 1;
  }
  pl->threads = pl->tpr * rpb;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, *kernel, pl->threads, 0);
  if (e != cudaSuccess) return e;
  int g = sms * (per_sm > 0 ? per_sm : 1);
  if (kind == BWD_APPLY && g > BWD_MAX_BLOCKS) g = BWD_MAX_BLOCKS;
  const int groups = ceil_div(rows, rpb);
  pl->grid = groups < g ? groups : g;
  return cudaSuccess;
}

template <typename Elt>
cudaError_t launch(int kind, SplitParams p, float* dw, int vec, int zb, cudaStream_t stream,
                   Plan* plan_only) {
  Plan pl{};
  const void* kernel = nullptr;
  cudaError_t e = plan<Elt>(&pl, &kernel, kind, p.rows, p.d, vec, zb);
  if (e != cudaSuccess || plan_only) {
    if (plan_only) *plan_only = pl;
    return e;
  }
  p.tpr = pl.tpr;
  void* args[] = {&p};
  e = cudaLaunchKernel(kernel, dim3(pl.grid), dim3(pl.threads), args, 0, stream);
  if (e != cudaSuccess) return e;
  if (kind == BWD_APPLY) {
    int blocks = pl.grid, d = p.d;
    const float* part = p.part;
    void* dw_args[] = {&part, &dw, &blocks, &d};
    e = cudaLaunchKernel((const void*)split_dw_kernel, dim3(ceil_div(d, DW_COLS)),
                         dim3(DW_COLS, DW_GROUPS), dw_args, 0, stream);
    if (e != cudaSuccess) return e;
  }
  return cudaGetLastError();
}

cudaError_t run(int kind, const SplitParams& p, float* dw, int vec, int zb, bool f32,
                cudaStream_t stream, Plan* plan_only) {
  return f32 ? launch<float>(kind, p, dw, vec, zb, stream, plan_only)
             : launch<bf16>(kind, p, dw, vec, zb, stream, plan_only);
}

int fwd_entry(const void* x, const void* z, const void* w, void* y, void* stat_out,
              const void* stats, int rows, int d, int dn, long long zs, float eps, int vec,
              int zvec, bool f32, void* stream) {
  const SplitParams p{static_cast<const float*>(x), z, static_cast<const float*>(w), nullptr,
                      y, nullptr, nullptr, static_cast<float*>(stat_out),
                      static_cast<const float*>(stats), rows, d, dn, 0, (int64_t)zs, eps};
  return (int)run(stat_out ? STAT : APPLY, p, nullptr, vec, zvec, f32,
                  static_cast<cudaStream_t>(stream), nullptr);
}

int bwd_entry(const void* dh, const void* x, const void* z, const void* w, void* dx, void* dz,
              void* part, void* dw, void* stat_out, const void* stats, int rows, int d, int dn,
              long long zs, float eps, int vec, int zvec, bool f32, void* stream) {
  const SplitParams p{static_cast<const float*>(x), z, static_cast<const float*>(w), dh, dx, dz,
                      static_cast<float*>(part), static_cast<float*>(stat_out),
                      static_cast<const float*>(stats), rows, d, dn, 0, (int64_t)zs, eps};
  return (int)run(stat_out ? BWD_STAT : BWD_APPLY, p, static_cast<float*>(dw), vec, zvec, f32,
                  static_cast<cudaStream_t>(stream), nullptr);
}

}  // namespace

extern "C" {

// The gated norm over split rows: x the f32 y and z the gate (row stride zs
// elements) of this rank's block of d columns, w its block of the weight, dn
// the full row's width. Statistic launch (stat_out not null): writes
// stat_out[row], the f32 sum of g^2 over the block, and nothing else. Apply
// launch (stat_out null): stats[row] the sum over every block; writes y.
// vec: 1 when d % 8 == 0 and x, w and y start their rows on 16 bytes (they
// take 16-byte vectors), else 0 (every tensor an element a load); zvec: the
// gate's load in bytes, 16, 8, 4 or 2 (bf16) that its base and row stride
// allow with vec 1, its element's size with vec 0; another width returns
// cudaErrorInvalidValue. Returns cudaGetLastError() after the launch.
int rmsnorm_fwd_split(const void* x, const void* z, const void* w, void* y, void* stat_out,
                      const void* stats, int rows, int d, int dn, long long zs, float eps,
                      int vec, int zvec, void* stream) {
  return fwd_entry(x, z, w, y, stat_out, stats, rows, d, dn, zs, eps, vec, zvec, false, stream);
}

// As rmsnorm_fwd_split with a float32 gate and y.
int rmsnorm_fwd_split_f32(const void* x, const void* z, const void* w, void* y, void* stat_out,
                          const void* stats, int rows, int d, int dn, long long zs, float eps,
                          int vec, int zvec, void* stream) {
  return fwd_entry(x, z, w, y, stat_out, stats, rows, d, dn, zs, eps, vec, zvec, true, stream);
}

// The gated backward over split rows: dh, x (the f32 y), z, w this rank's
// block of d columns, dn the full width, vec and zvec as rmsnorm_fwd_split's
// (dh, dx and dz as x). Statistic launch (stat_out not null): writes
// stat_out[2 row], stat_out[2 row + 1], the block's f32 sums of g^2 and of
// w dh g, and nothing else (one launch). Apply launch: stats the sums over
// every block; writes dx (the f32 dy), dz (contiguous) and this block's dw
// (two launches: the rows, then dw's shares added in a fixed order; part is
// scratch of min(rows, 1024) x d floats).
int rmsnorm_bwd_split(const void* dh, const void* x, const void* z, const void* w, void* dx,
                      void* dz, void* part, void* dw, void* stat_out, const void* stats,
                      int rows, int d, int dn, long long zs, float eps, int vec, int zvec,
                      void* stream) {
  return bwd_entry(dh, x, z, w, dx, dz, part, dw, stat_out, stats, rows, d, dn, zs, eps, vec,
                   zvec, false, stream);
}

// As rmsnorm_bwd_split with float32 dh, gate and dz.
int rmsnorm_bwd_split_f32(const void* dh, const void* x, const void* z, const void* w, void* dx,
                          void* dz, void* part, void* dw, void* stat_out, const void* stats,
                          int rows, int d, int dn, long long zs, float eps, int vec, int zvec,
                          void* stream) {
  return bwd_entry(dh, x, z, w, dx, dz, part, dw, stat_out, stats, rows, d, dn, zs, eps, vec,
                   zvec, true, stream);
}

// The launch of one of the four kernels (kind 0 statistic, 1 apply, 2
// backward statistic, 3 backward apply) at these shapes and widths,
// launching nothing: out[0..5] = blocks, threads a block, threads a row,
// chunks a thread and row, elements a chunk, the gate's load in bytes.
// Returns a CUDA error code (cudaErrorInvalidValue for a width the kernels
// do not take).
int rmsnorm_split_plan(int kind, int rows, int d, int vec, int zvec, int f32, int* out) {
  Plan pl{};
  const SplitParams p{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                      nullptr, nullptr, rows, d, d, 0, 0, 0.f};
  const cudaError_t err = run(kind, p, nullptr, vec, zvec, f32 != 0, nullptr, &pl);
  out[0] = pl.grid, out[1] = pl.threads, out[2] = pl.tpr, out[3] = pl.per, out[4] = pl.ve,
  out[5] = pl.zb;
  return (int)err;
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
