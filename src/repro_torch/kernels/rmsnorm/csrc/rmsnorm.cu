// Fused residual add + RMSNorm for Hopper (sm_90a), with the Mamba2 gate;
// its backward follows the forward (rmsnorm_bwd_kernel, below).
//
// Replaces: src/repro/kernels/rmsnorm/kernel.py, fused_rmsnorm_fwd
// (Pallas body _rms_kernel): s = x (+ residual) in f32, y = s * rsqrt(mean(s^2)
// + eps) * w; writes y and the new residual s, each once, in x's dtype. The
// gated form computes the reference's rmsnorm(y * silu(z), w)
// (src/repro/models/layers.py:518, :558) in the same launch: x is the f32 y,
// z the bf16 gate read through its row stride, g = bf16(bf16(y) *
// bf16(silu(z))) with silu = z / (1 + expf(-z)) in f32 as PyTorch's CUDA
// kernel computes it, then g is normalised with no residual and only the
// output is written.
//
// Bound on this card: bytes. Each input is read once and each output
// written once; ~5 flops an element (gated: ~15, an expf and a divide) are
// nothing beside the 295 flops a byte the H100 affords. At the path's six
// shapes (3.35 TB/s):
//   mistral decode   (4, 5120) + residual       184,320 B   0.055 us
//   mistral prefill  (8192, 5120) + residual    335.6 MB    0.1002 ms
//   mamba2 decode    (8, 768) + residual         52,224 B   0.016 us
//   mamba2 decode    (8, 1536) gated            104,448 B   0.031 us
//   mamba2 prefill   (16384, 768) + residual    100.7 MB    0.0300 ms
//   mamba2 prefill   (16384, 1536) gated        201.3 MB    0.0601 ms
// (gated: 4 B of y, 2 of z and 2 of output an element, plus w).
//
// Design, measured on an H100 80GB HBM3 at 700 W with
// tools/rmsnorm_variants.py, each variant an edit of this source (a decode
// shape: 81 launches on their own buffers in one CUDA graph, L2 flushed by
// a read, per launch; an empty kernel launched alike reads ~1.17 us, the
// previous kernel, one block a row with the row in shared memory, 3.3 us
// at (4, 5120); this one 2.65 us). At decode shapes the bytes take
// nanoseconds and the time is latency: the launch, then memory round
// trips. So:
//  * w is loaded into registers first, with 16-byte vectors, then the
//    kernel executes griddepcontrol.wait, and only then issues its x and r
//    (or y and z) loads, all together: one round trip after the wait. The
//    previous kernel waited for x and r, reduced, then read w: two.
//    Reading w after the reduction (w-late) costs 2.65 -> 3.42 us at (4,
//    5120) and 114.4 -> 118.0 us at (8192, 5120).
//  * The wait is what a programmatic dependent launch needs (pdl:
//    cudaLaunchAttributeProgrammaticStreamSerialization), whose blocks
//    start while the predecessor drains: nothing but w is read, and
//    nothing written, before it (the predecessor may still be writing x,
//    and a captured graph's pool may hand this launch's outputs memory the
//    predecessor still reads). PDL survives stream capture and saves
//    ~0.15 us a launch in the graph of 81 (2.50 against 2.65 us), but no
//    decode step showed it: decode_steady TPOT mistral_nemo_12b 11.79 ms
//    with it, 11.70-11.81 without; mamba2_130m 2.07-2.15 and 2.02 (one
//    call, in turns). So the kernel is launched plainly and the wait is a
//    no-op.
//  * The f32 row stays in registers, not shared memory; a block's sum of
//    squares takes one barrier, then every thread adds the warps' partials
//    in the same order. Shared memory holds only those partials,
//    double-buffered so consecutive rows need no second barrier.
//  * One block a row. Spreading a row over a thread-block cluster, the
//    partials read through distributed shared memory (cluster-N), lost:
//    4.13 us with 2 blocks a row, 4.51 with 4, 5.35 with 8, at (4, 5120).
// At prefill shapes the bytes dominate: two copy_ calls that move the
// norm's bytes take 112.5 us at (8192, 5120), 89 % of the bound.
//  * A one-wave grid (from occupancy), each block walking rows grid-stride
//    with w held in registers for all of them (the previous kernel re-read w
//    from the L2 for every row, 168 MB at (8192, 5120)), and the next
//    row's loads issued before this row is summed and written (PREFETCH:
//    116.4 -> 114.4 us at (8192, 5120), 74.9 -> 72.2 gated).
//  * Blocks of at most 256 threads (MANY_THREADS): at (8192, 5120) 160
//    threads of 4 vectors, 114.4 us, against 320 of 2 at a 512 limit,
//    114.0; at (16384, 1536) gated a 128 limit (96 threads of 2) costs
//    72.2 -> 74.2 us.
//  * rows <= FEW_ROWS (128) take the decode design, more the prefill one:
//    at d 5120 one block a row wins up to 64 rows (3.30 against 3.41 us),
//    ties at 128 (7.62 against 7.54) and loses at 256 (8.98 against 8.73);
//    gated at d 1536 the two are within 2 % up to 1024 rows.
// Rows whose width or addresses do not allow 16-byte vectors take the same
// kernel with one element a vector (VW = 1), without the prefetch. Rows up
// to 16384 wide (8192 gated, 4096 on the scalar path): every configuration
// of the repo is at most 12288 wide, 8192 gated.
//
// The gated norm over rows split across ranks (a statistic and an apply
// launch each way) has kernels of its own, in rmsnorm_split.cu.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

// Launch configuration, picked from the shapes alone.
constexpr int FEW_ROWS = 128;      // rows <= FEW_ROWS: one row a block
constexpr int MANY_THREADS = 256;  // threads a block at most (prefill design)
constexpr bool PREFETCH = true;    // the next row's loads before this one's sum

// The most threads a block of an instantiation may have: its launch bound,
// which leaves each thread 64 registers at 1024 and 128 at 512.
__host__ __device__ constexpr int max_threads(int vw, int per) {
  return vw == 1 || per == 1 ? 1024 : 512;
}
// float32 rows of 4 vectors a thread take twice bf16's registers: their
// blocks stop at 384 threads (170 registers a thread; 512 spilled at 128),
// rows up to 384 x 4 x 8 = 12288 wide, the widest configuration's
constexpr int F32_PER4_THREADS = 384;
template <typename Elt, int VW, int PER>
__host__ __device__ constexpr int kernel_threads() {
  return sizeof(Elt) == 4 && VW == 8 && PER == 4 ? F32_PER4_THREADS : max_threads(VW, PER);
}

__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}
// A value rounded to the element type T, where the unfused chain of torch
// ops rounds it: to bf16, or not at all in float32.
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  if constexpr (sizeof(T) == 2) {
    return round_bf16(v);
  } else {
    return v;
  }
}

// Loads of data another kernel may have just written go through the L2
// (ld.global.cg), never the non-coherent path; w, which nothing writes,
// through the read-only path.
template <int VW>
__device__ __forceinline__ void load_bf16(const bf16* src, bf16 (&dst)[VW]) {
  if constexpr (VW == 8) {
    *reinterpret_cast<uint4*>(dst) = __ldcg(reinterpret_cast<const uint4*>(src));
  } else {
#pragma unroll
    for (int j = 0; j < VW; ++j) dst[j] = __ldcg(src + j);
  }
}

template <int VW, bool READ_ONLY = false>
__device__ __forceinline__ void load_f32(const float* src, float (&dst)[VW]) {
  auto ld = [](const auto* q) { return READ_ONLY ? __ldg(q) : __ldcg(q); };
  if constexpr (VW == 8) {
    const float4 a = ld(reinterpret_cast<const float4*>(src));
    const float4 b = ld(reinterpret_cast<const float4*>(src) + 1);
    dst[0] = a.x, dst[1] = a.y, dst[2] = a.z, dst[3] = a.w;
    dst[4] = b.x, dst[5] = b.y, dst[6] = b.z, dst[7] = b.w;
  } else {
#pragma unroll
    for (int j = 0; j < VW; ++j) dst[j] = ld(src + j);
  }
}

template <int VW>
__device__ __forceinline__ void store_bf16(bf16* dst, const float (&v)[VW]) {
  alignas(VW == 8 ? 16 : 2) bf16 o[VW];
#pragma unroll
  for (int j = 0; j < VW; ++j) o[j] = __float2bfloat16(v[j]);
  if constexpr (VW == 8) {
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(o);
  } else {
#pragma unroll
    for (int j = 0; j < VW; ++j) dst[j] = o[j];
  }
}

template <int VW>
__device__ __forceinline__ void store_f32(float* dst, const float (&v)[VW]) {
  if constexpr (VW == 8) {
    reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int j = 0; j < VW; ++j) dst[j] = v[j];
  }
}

// Loads and stores of the element type: bf16 (a vector of 8 is 16 bytes)
// or float32 (a vector of 8 is two 16-byte loads).
template <int VW>
__device__ __forceinline__ void load_elt(const bf16* src, bf16 (&dst)[VW]) {
  load_bf16<VW>(src, dst);
}
template <int VW>
__device__ __forceinline__ void load_elt(const float* src, float (&dst)[VW]) {
  load_f32<VW>(src, dst);
}
template <int VW>
__device__ __forceinline__ void store_elt(bf16* dst, const float (&v)[VW]) {
  store_bf16<VW>(dst, v);
}
template <int VW>
__device__ __forceinline__ void store_elt(float* dst, const float (&v)[VW]) {
  store_f32<VW>(dst, v);
}

// Tensors in the element type (bf16 or float32) but w, and the gated
// form's y, which are float32.
struct Params {
  const void* x;   // (rows, d): T, or the f32 y when gated
  const void* r;   // residual (rows, d) or null
  const void* z;   // gate (rows, d) at row stride zs, or null
  const float* w;  // (d,)
  void* y;         // (rows, d)
  void* rout;      // new residual (rows, d); null when gated
  int rows, d;
  int64_t zs;
  float eps;
};

// The loads of one row, every one issued before any of them is used: x and
// r, or the f32 y and the gate z (Elt deduced from the buffers).
template <int VW, int PER, bool GATE, typename Elt>
__device__ __forceinline__ void load_row(const Params& p, int row, int first,
                                         Elt (&xb)[PER][VW], Elt (&rb)[PER][VW],
                                         float (&yf)[PER][VW]) {
  const int nvec = p.d / VW, T = blockDim.x;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int v = first + k * T;
    if (row < p.rows && v < nvec) {
      const int64_t off = (int64_t)row * p.d + (int64_t)v * VW;
      if constexpr (GATE) {
        load_f32<VW>(static_cast<const float*>(p.x) + off, yf[k]);
        load_elt<VW>(static_cast<const Elt*>(p.z) + (int64_t)row * p.zs + (int64_t)v * VW, rb[k]);
      } else {
        load_elt<VW>(static_cast<const Elt*>(p.x) + off, xb[k]);
        if (p.r) load_elt<VW>(static_cast<const Elt*>(p.r) + off, rb[k]);
      }
    }
  }
}

// Elt the element type (bf16 or float), VW elements a vector (8: 16 bytes of
// bf16, 32 of float; 1: the scalar path), PER vectors a thread and row:
// thread t holds vectors first + k * T, k < PER, of each row its block
// takes.
template <typename Elt, int VW, int PER, bool GATE>
__global__ void __launch_bounds__(kernel_threads<Elt, VW, PER>()) rmsnorm_kernel(const Params p) {
  __shared__ float red[2][32];  // the warps' partial sums, two rows' worth
  const int T = blockDim.x, tid = threadIdx.x;
  const int nvec = p.d / VW;
  const int first = tid;

  float wv[PER][VW];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int v = first + k * T;
    if (v < nvec) {
      load_f32<VW, true>(p.w + (int64_t)v * VW, wv[k]);
    } else {
#pragma unroll
      for (int j = 0; j < VW; ++j) wv[k][j] = 0.f;
    }
  }
  // The predecessor's writes are visible from here on; nothing above reads
  // them or writes anything. (A no-op as launched; it holds the kernel to
  // the contract of a programmatic dependent launch.)
  asm volatile("griddepcontrol.wait;" ::: "memory");

  const int warp = tid >> 5, lane = tid & 31, nw = (T + 31) >> 5;
  const int step = gridDim.x;
  // the raw loads of one row: x and r, or y and z
  alignas(VW == 8 ? 16 : sizeof(Elt)) Elt xb[PER][VW];
  alignas(VW == 8 ? 16 : sizeof(Elt)) Elt rb[PER][VW];
  float yf[PER][VW];
  // (the scalar path, for odd widths and unaligned rows, does not prefetch:
  // its loads take too many registers; nor does float32 at PER 4, whose
  // raw loads take twice bf16's registers)
  constexpr bool prefetch = PREFETCH && VW == 8 && (sizeof(Elt) == 2 || PER < 4);
  int buf = 0, row = blockIdx.x;
  if (prefetch) load_row<VW, PER, GATE>(p, row, first, xb, rb, yf);
  for (; row < p.rows; row += step, buf ^= 1) {
    if (!prefetch) load_row<VW, PER, GATE>(p, row, first, xb, rb, yf);
    float s[PER][VW], sq = 0.f;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int v = first + k * T;
      const bool ok = v < nvec;
#pragma unroll
      for (int j = 0; j < VW; ++j) {
        float e;
        if constexpr (GATE) {
          const float zf = to_f32(rb[k][j]);
          const float sz = round_to<Elt>(zf / (1.f + expf(-zf)));
          e = round_to<Elt>(round_to<Elt>(yf[k][j]) * sz);
        } else {
          e = to_f32(xb[k][j]) + (p.r ? to_f32(rb[k][j]) : 0.f);
        }
        s[k][j] = e;
        if (ok) sq += e * e;
      }
      if constexpr (!GATE) {
        if (ok) store_elt<VW>(static_cast<Elt*>(p.rout) + (int64_t)row * p.d + (int64_t)v * VW, s[k]);
      }
    }
    // the next row's loads fly while this one is summed and written
    if (prefetch) load_row<VW, PER, GATE>(p, row + step, first, xb, rb, yf);
    // one cross-warp step: each warp's partial to shared memory, one
    // barrier, then every thread adds them in the same order
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
    if (lane == 0) red[buf][warp] = sq;
    __syncthreads();
    float tot = 0.f;
    for (int u = 0; u < nw; ++u) tot += red[buf][u];
    const float inv = rsqrtf(tot / (float)p.d + p.eps);
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int v = first + k * T;
      if (v < nvec) {
        float o[VW];
#pragma unroll
        for (int j = 0; j < VW; ++j) o[j] = s[k][j] * inv * wv[k][j];
        store_elt<VW>(static_cast<Elt*>(p.y) + (int64_t)row * p.d + (int64_t)v * VW, o);
      }
    }
  }
}

// The launch geometry of one call.
struct Plan {
  int grid, threads, per, vw;
};

int ceil_div(int a, int b) { return (a + b - 1) / b; }
int round_warp(int n) { return ceil_div(n, 32) * 32; }

// The vectors a thread and row of each instantiation, in order: the first
// that holds a block's nb vectors within limit threads is taken, else the
// one with the fewest threads within its launch bound (sets pl.per and
// pl.threads). Gated rows stop at 8192 wide (no PER 4 with 16-byte vectors).
bool pick(Plan* pl, int nb, int limit, bool many, bool gated) {
  static const int vec_few[] = {1, 4}, vec_many[] = {1, 2, 4}, scalar[] = {4};
  const int* c = pl->vw == 1 ? scalar : many ? vec_many : vec_few;
  int n = pl->vw == 1 ? 1 : many ? 3 : 2;
  if (gated && pl->vw == 8) --n;
  for (int pass = 0; pass < 2; ++pass) {
    for (int j = 0; j < n; ++j) {
      const int i = pass == 0 ? j : n - 1 - j;
      const int bound = max_threads(pl->vw, c[i]);
      const int t = round_warp(ceil_div(nb, c[i]));
      if (t <= (pass == 0 && limit < bound ? limit : bound)) {
        pl->per = c[i], pl->threads = t;
        return true;
      }
    }
  }
  return false;
}

template <typename Elt, int VW, int PER, bool GATE>
cudaError_t run(Plan pl, const Params* p, cudaStream_t stream, Plan* plan_only) {
  auto kernel = rmsnorm_kernel<Elt, VW, PER, GATE>;
  if (pl.grid == 0) {  // the prefill design: one wave of blocks, from occupancy
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, pl.threads, 0);
    if (e != cudaSuccess) return e;
    const int wave = sms * (per_sm > 0 ? per_sm : 1);
    pl.grid = p->rows < wave ? p->rows : wave;
  }
  if (plan_only) {
    *plan_only = pl;
    return cudaSuccess;
  }
  kernel<<<pl.grid, pl.threads, 0, stream>>>(*p);
  return cudaGetLastError();
}

template <typename Elt, bool GATE>
cudaError_t dispatch(const Plan& pl, const Params* p, cudaStream_t s, Plan* plan_only) {
  if (pl.vw == 1) return run<Elt, 1, 4, GATE>(pl, p, s, plan_only);
  if constexpr (!GATE) {
    if (pl.per == 4) return run<Elt, 8, 4, GATE>(pl, p, s, plan_only);
  }
  if (pl.per == 1) return run<Elt, 8, 1, GATE>(pl, p, s, plan_only);
  return run<Elt, 8, 2, GATE>(pl, p, s, plan_only);
}

template <typename Elt>
cudaError_t launch(const Params& p, bool vec, cudaStream_t stream, Plan* plan_only) {
  if (p.rows <= 0 || p.d <= 0 || (vec && p.d % 8)) return cudaErrorInvalidValue;
  Plan pl{};
  pl.vw = vec ? 8 : 1;
  const int nvec = p.d / pl.vw;
  const bool gated = p.z != nullptr;
  bool ok;
  if (p.rows <= FEW_ROWS) {  // decode design: one row a block
    ok = pick(&pl, nvec, 1024, false, gated);
    pl.grid = p.rows;
  } else {  // prefill design: one wave from occupancy, rows grid-stride
    ok = pick(&pl, nvec, MANY_THREADS, true, gated);
    pl.grid = 0;
  }
  if (!ok) return cudaErrorInvalidValue;  // wider than the kernel takes
  if (sizeof(Elt) == 4 && pl.vw == 8 && pl.per == 4 && pl.threads > F32_PER4_THREADS)
    return cudaErrorInvalidValue;  // wider than the float32 kernel takes
  return gated ? dispatch<Elt, true>(pl, &p, stream, plan_only)
               : dispatch<Elt, false>(pl, &p, stream, plan_only);
}


// ---------------------------------------------------------------------------
// Backward: rmsnorm_bwd_kernel<VW, PER, GATE> and rmsnorm_dw_kernel.
//
// Replaces no Pallas kernel: the reference's Pallas norm has no backward
// (its model trains through plain jnp norms under jax.value_and_grad,
// src/repro/models/layers.py:47). The port's model runs every RMSNorm
// through the fused forward above, so its gradient is a kernel too.
//
// Residual form, (h, r) = norm(a, w, residual=x): s = f32(a) + f32(x)
// recomputed from the bf16 inputs as the forward sums it, rstd =
// rsqrtf(sum(s^2) / d + eps) as the forward computes it, s^ = s * rstd;
//   ds = dr + rstd * (w dh - s^ * mean(w dh s^)),  da = dx = bf16(ds),
//   dw = sum over rows of dh s^ (f32).
// Without a residual (the first norm of a pass, whose r is a) the same.
// Gated form: the norm's ds of g = bf16(bf16(y) * bf16(silu(z))), then the
// chain's own backward, each rounding where torch's autograd of the
// unfused chain rounds: dg = bf16(ds); dy = bf16(dg * bf16(silu(z))) (the
// cast of y passes it through, in f32); dsilu = bf16(dg * bf16(y)); dz =
// bf16(dsilu * sig * (1 + z (1 - sig))), sig = 1 / (1 + expf(-z)). dz is
// written contiguous, whatever z's row stride.
//
// Bound on this card: bytes, as the forward. Read a, x, dh, dr (bf16) and
// write da, 10 B an element; gated read y (f32), z, dh and write dy (f32),
// dz, 14 B; w and dw once. ~12 flops an element (gated ~30, an expf and
// two divides) are nothing beside 295 flops a byte.
//
// Design, a simple one: a one-wave grid (from occupancy, at most
// BWD_MAX_BLOCKS blocks), each block walking rows grid-stride with its
// columns of the row in registers; the two row sums (sum s^2 and sum w dh
// s) take one warp-shuffle and one shared-memory step together, double-
// buffered across rows, as the forward's one sum does. dw is the one sum
// across rows: each thread keeps its columns' share in registers over the
// block's rows, each block writes its share to a scratch row (no atomics),
// and rmsnorm_dw_kernel adds the scratch rows in a fixed order, so two
// calls give the same bits. Both are launched with cudaLaunchKernel (the
// forward's one chevron launch is the line tools/rmsnorm_variants.py edits).
// Rows up to 8192 wide with 16-byte vectors (every RMSNorm config of the
// repo is at most 5120 wide, 8192 gated), 4096 on the scalar path.
constexpr int BWD_MAX_BLOCKS = 1024;  // scratch rows of dw shares at most
constexpr int DW_COLS = 32, DW_GROUPS = 16;  // rmsnorm_dw_kernel's block

__host__ __device__ constexpr int bwd_max_threads(int vw) { return vw == 1 ? 1024 : 512; }

template <typename Elt>
__device__ __forceinline__ float silu_to(float z, float e) {  // e = expf(-z)
  return round_to<Elt>(z / (1.f + e));
}

// Tensors in the element type but w, dw, the scratch and the gated
// form's y and dy, which are float32.
struct BwdParams {
  const void* dh;   // (rows, d) gradient of the normed output
  const void* dr;   // (rows, d) gradient of the new residual, or null
  const void* x;    // (rows, d): Elt a; gated: the f32 y
  const void* r;    // residual (rows, d) or null
  const void* z;    // gate (rows, d) at row stride zs, or null
  const float* w;   // (d,)
  void* dx;         // (rows, d): Elt da (= dresidual); gated: the f32 dy
  void* dz;         // gated: (rows, d), contiguous; else null
  float* part;      // (grid, d): each block's share of dw
  int rows, d;
  int64_t zs;
  float eps;
};

template <typename Elt, int VW, int PER, bool GATE>
__global__ void __launch_bounds__(bwd_max_threads(VW)) rmsnorm_bwd_kernel(const BwdParams p) {
  __shared__ float sums[2][2][32];  // each warp's two row sums, two rows' worth
  const int T = blockDim.x, tid = threadIdx.x;
  const int nvec = p.d / VW, warp = tid >> 5, lane = tid & 31, nw = (T + 31) >> 5;
  float acc[PER][VW];  // this thread's columns of the block's dw share
#pragma unroll
  for (int k = 0; k < PER; ++k)
#pragma unroll
    for (int j = 0; j < VW; ++j) acc[k][j] = 0.f;
  int half = 0;
  for (int row = blockIdx.x; row < p.rows; row += gridDim.x, half ^= 1) {
    // residual form: u = s; gated: u = bf16(y), zz = z (g recomputed from them)
    float u[PER][VW], zz[PER][VW], dh[PER][VW];
    float sq = 0.f, dot = 0.f;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int v = tid + k * T;
      if (v < nvec) {
        const int64_t off = (int64_t)row * p.d + (int64_t)v * VW;
        alignas(VW == 8 ? 16 : sizeof(Elt)) Elt hb[VW];
        alignas(VW == 8 ? 16 : sizeof(Elt)) Elt ab[VW];
        float wv[VW];
        load_elt<VW>(static_cast<const Elt*>(p.dh) + off, hb);
        load_f32<VW, true>(p.w + (int64_t)v * VW, wv);
        if constexpr (GATE) {
          float yv[VW];
          load_f32<VW>(static_cast<const float*>(p.x) + off, yv);
          load_elt<VW>(static_cast<const Elt*>(p.z) + (int64_t)row * p.zs + (int64_t)v * VW, ab);
#pragma unroll
          for (int j = 0; j < VW; ++j) {
            u[k][j] = round_to<Elt>(yv[j]);
            zz[k][j] = to_f32(ab[j]);
          }
        } else {
          alignas(VW == 8 ? 16 : sizeof(Elt)) Elt rb[VW];
          load_elt<VW>(static_cast<const Elt*>(p.x) + off, ab);
          if (p.r) load_elt<VW>(static_cast<const Elt*>(p.r) + off, rb);
#pragma unroll
          for (int j = 0; j < VW; ++j) u[k][j] = to_f32(ab[j]) + (p.r ? to_f32(rb[j]) : 0.f);
        }
#pragma unroll
        for (int j = 0; j < VW; ++j) {
          dh[k][j] = to_f32(hb[j]);
          float g = u[k][j];
          if constexpr (GATE) g = round_to<Elt>(g * silu_to<Elt>(zz[k][j], expf(-zz[k][j])));
          sq += g * g;
          dot += wv[j] * dh[k][j] * g;
        }
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      sq += __shfl_xor_sync(0xffffffffu, sq, o);
      dot += __shfl_xor_sync(0xffffffffu, dot, o);
    }
    if (lane == 0) sums[half][0][warp] = sq, sums[half][1][warp] = dot;
    __syncthreads();  // every warp's two sums of this row are in
    float ssq = 0.f, sdot = 0.f;
    for (int i = 0; i < nw; ++i) ssq += sums[half][0][i], sdot += sums[half][1][i];
    const float rstd = rsqrtf(ssq / (float)p.d + p.eps);
    const float mean = sdot * rstd / (float)p.d;  // mean(w dh s^)
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int v = tid + k * T;
      if (v < nvec) {
        const int64_t off = (int64_t)row * p.d + (int64_t)v * VW;
        float wv[VW], o[VW];
        load_f32<VW, true>(p.w + (int64_t)v * VW, wv);
        alignas(VW == 8 ? 16 : sizeof(Elt)) Elt drb[VW];
        if (!GATE && p.dr) load_elt<VW>(static_cast<const Elt*>(p.dr) + off, drb);
        if constexpr (GATE) {
          float oz[VW];
#pragma unroll
          for (int j = 0; j < VW; ++j) {
            const float e = expf(-zz[k][j]);
            const float sz = silu_to<Elt>(zz[k][j], e), sig = 1.f / (1.f + e);
            const float sh = round_to<Elt>(u[k][j] * sz) * rstd;
            acc[k][j] += dh[k][j] * sh;
            const float dg = round_to<Elt>(rstd * (wv[j] * dh[k][j] - sh * mean));
            o[j] = round_to<Elt>(dg * sz);
            oz[j] = round_to<Elt>(dg * u[k][j]) * sig * (1.f + zz[k][j] * (1.f - sig));
          }
          store_f32<VW>(static_cast<float*>(p.dx) + off, o);
          store_elt<VW>(static_cast<Elt*>(p.dz) + off, oz);
        } else {
#pragma unroll
          for (int j = 0; j < VW; ++j) {
            const float sh = u[k][j] * rstd;
            acc[k][j] += dh[k][j] * sh;
            o[j] = rstd * (wv[j] * dh[k][j] - sh * mean) + (p.dr ? to_f32(drb[j]) : 0.f);
          }
          store_elt<VW>(static_cast<Elt*>(p.dx) + off, o);
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int v = tid + k * T;
    if (v < nvec) store_f32<VW>(p.part + (int64_t)blockIdx.x * p.d + (int64_t)v * VW, acc[k]);
  }
}

// dw[c] = the blocks' shares of column c added in a fixed order: group gy of
// a (DW_COLS, DW_GROUPS) block adds shares gy, gy + DW_GROUPS, ..., then
// group 0 adds the groups' sums in order.
__global__ void __launch_bounds__(DW_COLS * DW_GROUPS) rmsnorm_dw_kernel(
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

// The backward's launch: PER from {1, 2} (16-byte vectors) or 4 (scalar),
// the first whose threads fit the launch bound; the grid one wave.
template <typename Elt>
cudaError_t bwd_plan(Plan* pl, int rows, int d, bool vec, const void** kernel, bool gated) {
  if (rows <= 0 || d <= 0 || (vec && d % 8)) return cudaErrorInvalidValue;
  pl->vw = vec ? 8 : 1;
  const int nvec = d / pl->vw, bound = bwd_max_threads(pl->vw);
  static const int pers[] = {1, 2, 4};
  pl->per = 0;
  for (int per : pers) {
    if ((pl->vw == 1) != (per == 4)) continue;
    const int t = round_warp(ceil_div(nvec, per));
    if (t <= bound) {
      pl->per = per, pl->threads = t;
      break;
    }
  }
  if (!pl->per) return cudaErrorInvalidValue;  // wider than the kernel takes
  const void* table[2][3] = {
      {(const void*)rmsnorm_bwd_kernel<Elt, 8, 1, false>,
       (const void*)rmsnorm_bwd_kernel<Elt, 8, 2, false>,
       (const void*)rmsnorm_bwd_kernel<Elt, 1, 4, false>},
      {(const void*)rmsnorm_bwd_kernel<Elt, 8, 1, true>,
       (const void*)rmsnorm_bwd_kernel<Elt, 8, 2, true>,
       (const void*)rmsnorm_bwd_kernel<Elt, 1, 4, true>}};
  *kernel = table[gated][pl->per == 4 ? 2 : pl->per - 1];
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, *kernel, pl->threads, 0);
  if (e != cudaSuccess) return e;
  int g = sms * (per_sm > 0 ? per_sm : 1);
  if (g > BWD_MAX_BLOCKS) g = BWD_MAX_BLOCKS;
  pl->grid = rows < g ? rows : g;
  return cudaSuccess;
}

template <typename Elt>
cudaError_t launch_bwd(BwdParams p, float* dw, bool vec, cudaStream_t stream, Plan* plan_only) {
  Plan pl{};
  const void* kernel = nullptr;
  cudaError_t e = bwd_plan<Elt>(&pl, p.rows, p.d, vec, &kernel, p.z != nullptr);
  if (e != cudaSuccess || plan_only) {
    if (plan_only) *plan_only = pl;
    return e;
  }
  void* args[] = {&p};
  e = cudaLaunchKernel(kernel, dim3(pl.grid), dim3(pl.threads), args, 0, stream);
  if (e != cudaSuccess) return e;
  int blocks = pl.grid, d = p.d;
  const float* part = p.part;
  void* dw_args[] = {&part, &dw, &blocks, &d};
  e = cudaLaunchKernel((const void*)rmsnorm_dw_kernel, dim3(ceil_div(d, DW_COLS)),
                       dim3(DW_COLS, DW_GROUPS), dw_args, 0, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// The entry points for both element types: f32 picks float32 x, residual,
// gate, outputs and gradients, else bfloat16.
cudaError_t fwd(const Params& p, bool vec, bool f32, cudaStream_t stream, Plan* plan_only) {
  return f32 ? launch<float>(p, vec, stream, plan_only) : launch<bf16>(p, vec, stream, plan_only);
}

cudaError_t bwd(const BwdParams& p, float* dw, bool vec, bool f32, cudaStream_t stream,
                Plan* plan_only) {
  return f32 ? launch_bwd<float>(p, dw, vec, stream, plan_only)
             : launch_bwd<bf16>(p, dw, vec, stream, plan_only);
}

int fwd_entry(const void* x, const void* r, const void* z, const void* w, void* y, void* rout,
              int rows, int d, long long zs, float eps, int vec, bool f32, void* stream) {
  const Params p{x, r, z, static_cast<const float*>(w), y, rout, rows, d, (int64_t)zs, eps};
  return (int)fwd(p, vec != 0, f32, static_cast<cudaStream_t>(stream), nullptr);
}

int plan_entry(int rows, int d, int gated, int vec, bool f32, int* out) {
  Params p{};
  p.rows = rows, p.d = d;
  p.z = gated ? reinterpret_cast<const void*>(16) : nullptr;
  Plan pl{};
  const cudaError_t err = fwd(p, vec != 0, f32, nullptr, &pl);
  out[0] = pl.grid, out[1] = pl.threads, out[2] = pl.per, out[3] = pl.vw;
  return (int)err;
}

int bwd_entry(const void* dh, const void* dr, const void* x, const void* r, const void* z,
              const void* w, void* dx, void* dz, void* part, void* dw, int rows, int d,
              long long zs, float eps, int vec, bool f32, void* stream) {
  const BwdParams p{dh, dr, x, r, z, static_cast<const float*>(w), dx, dz,
                    static_cast<float*>(part), rows, d, (int64_t)zs, eps};
  return (int)bwd(p, static_cast<float*>(dw), vec != 0, f32, static_cast<cudaStream_t>(stream),
                  nullptr);
}

int bwd_plan_entry(int rows, int d, int gated, int vec, bool f32, int* out) {
  BwdParams p{};
  p.rows = rows, p.d = d;
  p.z = gated ? reinterpret_cast<const void*>(16) : nullptr;
  Plan pl{};
  const cudaError_t err = bwd(p, nullptr, vec != 0, f32, nullptr, &pl);
  out[0] = pl.grid, out[1] = pl.threads, out[2] = pl.per, out[3] = pl.vw;
  return (int)err;
}

}  // namespace

extern "C" {

// x, the residual, y and the new residual are bfloat16; w is float32. r may
// be null (no residual). Gated (z not null): x is the float32 y, z the
// bfloat16 gate at row stride zs (elements), r and rout null, only y is
// written. vec: 1 when d % 8 == 0 and every row and w start on 16 bytes.
// Returns cudaGetLastError() after the launch.
int rmsnorm_fwd(const void* x, const void* r, const void* z, const void* w, void* y,
                void* rout, int rows, int d, long long zs, float eps, int vec, void* stream) {
  return fwd_entry(x, r, z, w, y, rout, rows, d, zs, eps, vec, false, stream);
}

// As rmsnorm_fwd with float32 x, residual, gate, y and new residual.
int rmsnorm_fwd_f32(const void* x, const void* r, const void* z, const void* w, void* y,
                    void* rout, int rows, int d, long long zs, float eps, int vec,
                    void* stream) {
  return fwd_entry(x, r, z, w, y, rout, rows, d, zs, eps, vec, true, stream);
}

// The launch a call of these shapes makes, launching nothing: out[0..3] =
// blocks, threads a block, vectors a thread and row, elements a vector.
// Returns a CUDA error code (cudaErrorInvalidValue for a width the kernel
// does not take).
int rmsnorm_plan(int rows, int d, int gated, int vec, int* out) {
  return plan_entry(rows, d, gated, vec, false, out);
}

// As rmsnorm_plan for float32 rows.
int rmsnorm_plan_f32(int rows, int d, int gated, int vec, int* out) {
  return plan_entry(rows, d, gated, vec, true, out);
}

// The backward of rmsnorm_fwd. dh, dr, x (or the f32 y), r, z and w as the
// forward took them (dr and r may be null; gated: z not null, dr and r
// null). Writes dx (bf16 da = dresidual; gated: the f32 dy), dz (gated,
// contiguous) and dw (f32, d); part is scratch of min(rows,
// BWD_MAX_BLOCKS) x d floats. vec: 1 when d % 8 == 0 and every row and w
// start on 16 bytes. Two launches (the rows, then dw); returns
// cudaGetLastError() after them.
int rmsnorm_bwd(const void* dh, const void* dr, const void* x, const void* r, const void* z,
                const void* w, void* dx, void* dz, void* part, void* dw, int rows, int d,
                long long zs, float eps, int vec, void* stream) {
  return bwd_entry(dh, dr, x, r, z, w, dx, dz, part, dw, rows, d, zs, eps, vec, false, stream);
}

// As rmsnorm_bwd with float32 dh, dr, x, residual, gate, dx and dz.
int rmsnorm_bwd_f32(const void* dh, const void* dr, const void* x, const void* r, const void* z,
                    const void* w, void* dx, void* dz, void* part, void* dw, int rows, int d,
                    long long zs, float eps, int vec, void* stream) {
  return bwd_entry(dh, dr, x, r, z, w, dx, dz, part, dw, rows, d, zs, eps, vec, true, stream);
}

// The backward's launch for these shapes, launching nothing: out[0..3] as
// rmsnorm_plan's.
int rmsnorm_bwd_plan(int rows, int d, int gated, int vec, int* out) {
  return bwd_plan_entry(rows, d, gated, vec, false, out);
}

// As rmsnorm_bwd_plan for float32 rows.
int rmsnorm_bwd_plan_f32(int rows, int d, int gated, int vec, int* out) {
  return bwd_plan_entry(rows, d, gated, vec, true, out);
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
