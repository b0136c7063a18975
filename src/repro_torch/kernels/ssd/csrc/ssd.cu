// Mamba2 SSD chunk scan for Hopper (sm_90a), on bf16 tensor cores at f32
// accuracy.
//
// Replaces: src/repro/kernels/ssd/kernel.py, ssd_chunk_fwd (Pallas body
// _ssd_kernel). Per chunk of Q positions, csum the running sum of dA inside
// the chunk and L[i,j] = exp(csum_i - csum_j) for i >= j, else 0:
//   y = (C B^T . L)(x dt) + (C h) exp(csum)
//   h <- h exp(csum_Q) + B^T (x dt exp(csum_Q - csum))
// with the state h carried across the chunks of a sequence inside one
// launch, as the TPU kernel carries it across its sequential grid axis.
// The reference casts every input to float32; x, B and C may be bfloat16.
//
// Bound on this card. At the serving shape (8 sequences of 2048, 24 heads
// of P = 64, N = 128) the scan is ~15 GFLOP (the causal half of each
// product; C B^T once per sequence and chunk) against ~168 MB of traffic
// (y alone, f32, is 100 MB): ~0.22 ms at the CUDA cores' 67 TFLOP/s, ~0.05
// ms at 3.35 TB/s. On the tensor cores the same f32-accurate work is
// bound by its bytes.
//
// Products on tensor cores at f32 accuracy. Every product runs as
// mma.sync m16n8k16 bf16 with f32 accumulation. An f32 operand v is split
// into three bf16 terms, hi = bf16(v), mid = bf16(v - hi), lo = bf16(v - hi
// - mid) (round to nearest): each subtraction is exact, v - hi has at most
// 16 significant bits and v - hi - mid at most 8, so v == hi + mid + lo
// exactly (for |v| >= 2^-103; below that lo may be subnormal). A bf16
// operand is one exact term. A product of a split operand and a bf16 one
// runs its three term products, each exact in f32: nothing is dropped.
// Where both operands are f32 (x, B and C given in float32), the term
// pairs whose orders sum to more than KEEP = 2 are dropped: mid*lo,
// lo*mid and lo*lo. With |mid| <= 2^-8 (1 + 2^-8)|a| and |lo| <= 2^-16|a|
// they are at most 2^-23 (1 + 2^-8) |a||b| + 2^-32 |a||b| < 1.01 * 2^-23
// |a||b| per product, one f32 ulp of it. So a K-long product differs from
// the exact sum by at most (1.01 * 2^-23 [both f32] + m * 2^-23) * sum_k
// |a_k||b_k|, m the number of term products added (the tensor cores add in
// f32, rounding toward zero: 2^-23 per addition). The rest is f32 on the
// CUDA cores: csum, the exponentials, L, dt, the decay of h and the scale
// of C h. On the model path (x, B, C in bf16) C B^T is one exact bf16
// product, and the other three each split one f32 operand: the masked
// scores M = (C B^T . L) dt_j, the state h, and x dt exp(csum_Q - csum).
//
// Design. One block per (sequence, head), ceil(P / 16) warps; warp w owns
// rows 16w..16w+15 of the state's P side. The state lives transposed in
// registers (h^T, 16 x N per warp, f32) for the whole launch: the chunk's
// update h^T += (x dt w)^T B leaves it in the accumulator layout, which is
// the A-fragment layout of the next chunk's y^T += h^T C^T, so h is split
// into its three terms in registers and never goes through shared memory.
// Per chunk: each warp computes csum, exp(csum), the decay weights in its
// own copy (one warp shuffle scan, no barrier); the warps share the masked
// score tiles (C B^T once per chunk and block, split into three bf16
// planes in shared memory, only the 10 causal 16 x 16 blocks); y^T = h^T
// C^T scaled by exp(csum), plus x^T M^T; then h^T. x, B and C of chunk
// c + 1 load by cp.async into the other half of a two-stage ring while
// chunk c computes (f32 inputs: one stage, split into planes as they
// load). Two barriers a chunk. Tiles in shared memory are XOR-swizzled by
// 16-byte column and row so that ldmatrix reads and fragment stores hit
// distinct banks. At P = 64 a block takes 128 threads and ~109 KB, so two
// blocks share an SM. No atomics: two calls are bit-identical.
//
// The TPU kernel's 128-row chunk becomes a 64-row tile (the result does
// not depend on the chunk length up to f32 rounding). A ragged tail reads
// as zeros, which is exact (x dt = 0 adds nothing and dA = 0 keeps the
// decay at 1), so any length is taken. exp(csum_i - csum_j) is evaluated
// only where i >= j: above the diagonal the difference is positive and may
// overflow, and inf * 0 is NaN.
//
// Inputs are read through strides (sequence b, head h, position s), so the
// model's x (B, S, H, P) slice of the convolution output and its B/C shared
// by all heads (head stride 0) are read in place. h_final is written in the
// model's orientation (B, H, P, N); the TPU kernel's is (BH, N, P).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int Q = 64;            // rows per chunk
constexpr int KEEP = 2;          // largest order sum of a kept term pair
constexpr int MAX_SMEM = 232448; // 227 KB, the most a block may use

struct Strides {
  long long b, h, s;
  __device__ __forceinline__ long long at(int b_, int h_, int s_) const {
    return b_ * b + h_ * h + s_ * s;
  }
};

struct Args {
  const void* x;
  const float* dt;
  const float* da;
  const void* B;
  const void* C;
  float* y;
  float* hout;
  int nh, S, P, N;
  int vec;                       // x, B, C rows 16-byte aligned: vector loads
  Strides sx, sdt, sda, sB, sC, sy;
};

// Shared memory plan, in bytes; tiles are bf16 planes of Q rows.
struct Plan {
  int warps, xw, np, terms, stages;
  int xplane, bcplane, stage, mplane, total;
  __host__ __device__ Plan(int P, int NP, bool f32) {
    warps = (P + 15) / 16;
    xw = P <= 64 ? 64 : 128;     // x row width: 128 or 256 bytes
    np = NP;
    terms = f32 ? 3 : 1;         // planes per input: f32 inputs load split
    stages = f32 ? 1 : 2;
    xplane = Q * xw * 2;
    bcplane = Q * np * 2;
    stage = terms * (xplane + 2 * bcplane) + 2 * Q * 4;
    mplane = Q * Q * 2;
    total = stages * stage + 3 * mplane + warps * 4 * Q * 4;
  }
};

// ------------------------------- PTX helpers --------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of (row, col) in a plane whose rows are `width` bf16 wide
// (64 or 128), 16-byte columns XOR-swizzled by the row.
__device__ __forceinline__ uint32_t swz(int row, int col, int width) {
  return row * width * 2 + ((((col >> 3) ^ (row & 7))) << 4) + (col & 7) * 2;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// d += a b, m16n8k16, bf16 in, f32 accumulate.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Every kept term pair of a split product, the smallest orders first.
template <int TA, int TB>
__device__ __forceinline__ void mma_terms(float (&d)[4], const uint32_t (&a)[TA][4],
                                          const uint32_t (&b)[TB][2]) {
#pragma unroll
  for (int s = KEEP; s >= 0; --s)
#pragma unroll
    for (int i = 0; i < TA; ++i)
      if (s - i >= 0 && s - i < TB) mma(d, a[i], b[s - i][0], b[s - i][1]);
}

__device__ __forceinline__ uint32_t pack(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ float2 unpack(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

// Two f32 values into three bf16x2 terms, v == t0 + t1 + t2 (see header).
__device__ __forceinline__ void split3(float v0, float v1, uint32_t (&t)[3]) {
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v0, v1);
  const float2 h = __bfloat1622float2(hi);
  const float r0 = v0 - h.x, r1 = v1 - h.y;
  const __nv_bfloat162 mid = __floats2bfloat162_rn(r0, r1);
  const float2 m = __bfloat1622float2(mid);
  t[0] = pack(hi);
  t[1] = pack(mid);
  t[2] = pack(__floats2bfloat162_rn(r0 - m.x, r1 - m.y));
}

// Fragments of a 16 x 16 block at (r0, c0) of a swizzled plane of `width`.
// A operand, row-major rows r (ldmatrix, no transpose).
__device__ __forceinline__ uint32_t a_addr(uint32_t base, int r0, int c0, int width, int lane) {
  return base + swz(r0 + (lane & 7) + ((lane >> 3) & 1) * 8, c0 + (lane >> 4) * 8, width);
}
// A operand from a plane stored (k rows, m columns), transposed on load.
__device__ __forceinline__ uint32_t at_addr(uint32_t base, int k0, int m0, int width, int lane) {
  return base + swz(k0 + (lane & 7) + (lane >> 4) * 8, m0 + ((lane >> 3) & 1) * 8, width);
}
// B operands of two n8 tiles (n0, n0 + 8) from a plane stored (n rows, k
// columns): registers {b0, b1} of tile n0, then of tile n0 + 8.
__device__ __forceinline__ uint32_t b_addr(uint32_t base, int n0, int k0, int width, int lane) {
  return base + swz(n0 + (lane & 7) + (lane >> 4) * 8, k0 + ((lane >> 3) & 1) * 8, width);
}
// The same from a plane stored (k rows, n columns), transposed on load.
__device__ __forceinline__ uint32_t bt_addr(uint32_t base, int k0, int n0, int width, int lane) {
  return base + swz(k0 + (lane & 7) + ((lane >> 3) & 1) * 8, n0 + (lane >> 4) * 8, width);
}

// ------------------------------- loading -------------------------------------
// One 16-byte slot (8 columns) of a row of x, B or C into its plane(s).
// bf16: a cp.async (zero-filled past the end), or element by element where
// the rows are not 16-byte aligned. f32: 8 values split into three planes.
template <typename T>
__device__ __forceinline__ void load_slot(uint32_t dst, uint32_t plane_bytes,
                                          const T* src, int valid, bool vec) {
  if constexpr (sizeof(T) == 2) {
    if (vec && (valid == 8 || valid == 0)) {
      cp_async16(dst, src, valid == 8);
    } else {
      uint32_t w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const __nv_bfloat16 z = __float2bfloat16(0.f);
        const __nv_bfloat16 lo = 2 * e < valid ? src[2 * e] : z;
        const __nv_bfloat16 hi = 2 * e + 1 < valid ? src[2 * e + 1] : z;
        w[e] = pack(__halves2bfloat162(lo, hi));
      }
      asm volatile("st.shared.v4.b32 [%0], {%1,%2,%3,%4};\n"
                   :: "r"(dst), "r"(w[0]), "r"(w[1]), "r"(w[2]), "r"(w[3]));
    }
  } else {
    float v[8];
    if (vec && valid == 8) {
      const float4 a = *reinterpret_cast<const float4*>(src);
      const float4 b = *reinterpret_cast<const float4*>(src + 4);
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
      v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = e < valid ? src[e] : 0.f;
    }
    uint32_t t[4][3];
#pragma unroll
    for (int e = 0; e < 4; ++e) split3(v[2 * e], v[2 * e + 1], t[e]);
#pragma unroll
    for (int k = 0; k < 3; ++k)
      asm volatile("st.shared.v4.b32 [%0], {%1,%2,%3,%4};\n"
                   :: "r"(dst + k * plane_bytes), "r"(t[0][k]), "r"(t[1][k]),
                      "r"(t[2][k]), "r"(t[3][k]));
  }
}

// What one thread loads of every chunk, fixed for the launch: one 16-byte
// slot (column 8k) of every `step`-th row of x, and of B and C, from the
// rows of (seq, head); the columns of the slot that lie inside P or N.
template <typename T>
struct Loader {
  const T *x, *B, *C;
  const float *dt, *da;
  long long sx, sB, sC, sdt, sda;  // position strides
  int xk, xr, xstep, xvalid, bk, br, bstep, bvalid;

  __device__ Loader(const Args& a, const Plan& pl, int seq, int head) {
    const int tid = threadIdx.x, nt = blockDim.x;
    const int xs = 2 * pl.warps, bs = pl.np / 8;   // slots a row; nt is a multiple
    xk = tid % xs; xr = tid / xs; xstep = nt / xs;
    bk = tid % bs; br = tid / bs; bstep = nt / bs;
    xvalid = max(0, min(8, a.P - 8 * xk));
    bvalid = max(0, min(8, a.N - 8 * bk));
    x = static_cast<const T*>(a.x) + a.sx.at(seq, head, 0) + 8 * xk;
    B = static_cast<const T*>(a.B) + a.sB.at(seq, head, 0) + 8 * bk;
    C = static_cast<const T*>(a.C) + a.sC.at(seq, head, 0) + 8 * bk;
    dt = a.dt + a.sdt.at(seq, head, 0);
    da = a.da + a.sda.at(seq, head, 0);
    sx = a.sx.s; sB = a.sB.s; sC = a.sC.s; sdt = a.sdt.s; sda = a.sda.s;
  }

  // Chunk c0..c0+Q-1 into the stage at `sbase`: dt and dA by 4-byte
  // cp.async, then x, B and C. Rows past S and columns past P or N read as
  // zeros.
  __device__ __forceinline__ void chunk(const Args& a, const Plan& pl, uint8_t* sbase,
                                        int c0) const {
    const int rows = min(Q, a.S - c0);
    const uint32_t xb = smem_u32(sbase), bb = xb + pl.terms * pl.xplane;
    const uint32_t cb = bb + pl.terms * pl.bcplane, sb = cb + pl.terms * pl.bcplane;
    for (int e = threadIdx.x; e < 2 * Q; e += blockDim.x) {
      const int r = e & (Q - 1);
      const bool ok = r < rows;
      const long long s = c0 + (ok ? r : 0);
      cp_async4(sb + e * 4, e < Q ? dt + s * sdt : da + s * sda, ok);
    }
    for (int r = xr; r < Q; r += xstep) {
      const bool ok = r < rows;
      load_slot<T>(xb + swz(r, 8 * xk, pl.xw), pl.xplane,
                   x + (ok ? (long long)(c0 + r) * sx : 0), ok ? xvalid : 0, a.vec);
    }
    for (int r = br; r < Q; r += bstep) {
      const bool ok = r < rows;
      const long long s = ok ? c0 + r : 0;
      const uint32_t off = swz(r, 8 * bk, pl.np);
      load_slot<T>(bb + off, pl.bcplane, B + s * sB, ok ? bvalid : 0, a.vec);
      load_slot<T>(cb + off, pl.bcplane, C + s * sC, ok ? bvalid : 0, a.vec);
    }
  }
};

// ------------------------------- the kernel ---------------------------------
template <typename T, int NP>
__global__ void __launch_bounds__(256)
ssd_chunk_kernel(const Args a) {
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int TI = F32 ? 3 : 1;          // terms of an input operand
  constexpr int NT = NP / 8;               // n8 tiles of the state's N side
  extern __shared__ __align__(128) uint8_t smem[];
  const Plan pl(a.P, NP, F32);
  const int head = blockIdx.x, seq = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int p0 = 16 * warp;                // this warp's rows of P
  const uint32_t mbase = smem_u32(smem + pl.stages * pl.stage);
  float* scal = reinterpret_cast<float*>(smem + pl.stages * pl.stage + 3 * pl.mplane) + warp * 4 * Q;
  float* cs = scal;                        // csum, this warp's copy
  float* ecs = cs + Q;                     // exp(csum)
  float* wv = ecs + Q;                     // dt exp(csum_Q - csum)
  float* dts = wv + Q;                     // dt

  float hacc[NT][4];                       // h^T rows p0.., all of N
#pragma unroll
  for (int i = 0; i < NT; ++i) hacc[i][0] = hacc[i][1] = hacc[i][2] = hacc[i][3] = 0.f;

  const Loader<T> ld(a, pl, seq, head);
  const int nc = (a.S + Q - 1) / Q;
  if (pl.stages == 2) {
    ld.chunk(a, pl, smem, 0);
    cp_async_commit();
  }
  for (int c = 0; c < nc; ++c) {
    const int c0 = c * Q;
    const int st = pl.stages == 2 ? (c & 1) : 0;
    uint8_t* sp = smem + st * pl.stage;
    if (pl.stages == 1) {
      __syncthreads();                     // every warp is done with c - 1
      ld.chunk(a, pl, sp, c0);
      cp_async_commit();
    }
    cp_async_wait_all();
    __syncthreads();                       // chunk c landed; c - 1 done
    if (pl.stages == 2) {
      if (c + 1 < nc) ld.chunk(a, pl, smem + (st ^ 1) * pl.stage, c0 + Q);
      cp_async_commit();
    }
    const uint32_t xb = smem_u32(sp), bb = xb + TI * pl.xplane;
    const uint32_t cb = bb + TI * pl.bcplane;
    const float* sdt = reinterpret_cast<const float*>(sp + TI * (pl.xplane + 2 * pl.bcplane));
    const float* sda = sdt + Q;

    // 1. csum (inclusive scan of dA), exp(csum), the decay weights: each
    // warp its own copy.
    float cs_last;
    {
      const float d0 = sda[2 * lane], d1 = sda[2 * lane + 1];
      float incl = d0 + d1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += u;
      }
      float prev = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) prev = 0.f;
      const float c0v = prev + d0, c1v = c0v + d1;
      cs_last = __shfl_sync(0xffffffffu, c1v, 31);
      const float t0 = sdt[2 * lane], t1 = sdt[2 * lane + 1];
      cs[2 * lane] = c0v;
      cs[2 * lane + 1] = c1v;
      ecs[2 * lane] = expf(c0v);
      ecs[2 * lane + 1] = expf(c1v);
      wv[2 * lane] = t0 * expf(cs_last - c0v);
      wv[2 * lane + 1] = t1 * expf(cs_last - c1v);
      dts[2 * lane] = t0;
      dts[2 * lane + 1] = t1;
      __syncwarp();
    }

    // 2. Masked scores M[i][j] = (C B^T)[i][j] L[i][j] dt_j, i >= j, split
    // into three planes: the 10 causal 16 x 16 blocks (m, k), k <= m,
    // shared out among the warps.
    for (int blk = warp; blk < 10; blk += pl.warps) {
      const int m = blk < 1 ? 0 : blk < 3 ? 1 : blk < 6 ? 2 : 3;
      const int k = blk - m * (m + 1) / 2;
      float acc[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < NP / 16; ++kk) {
        uint32_t af[TI][4], bf[TI][4];
#pragma unroll
        for (int u = 0; u < TI; ++u) {
          ldsm_x4(af[u], a_addr(cb + u * pl.bcplane, 16 * m, 16 * kk, NP, lane));
          ldsm_x4(bf[u], b_addr(bb + u * pl.bcplane, 16 * k, 16 * kk, NP, lane));
        }
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          uint32_t b2[TI][2];
#pragma unroll
          for (int u = 0; u < TI; ++u) { b2[u][0] = bf[u][2 * h2]; b2[u][1] = bf[u][2 * h2 + 1]; }
          mma_terms<TI, TI>(acc[h2], af, b2);
        }
      }
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int i = 16 * m + g + 8 * rr, j = 16 * k + 8 * h2 + 2 * t;
          const float ci = cs[i];
          const float v0 = i >= j ? acc[h2][2 * rr] * expf(ci - cs[j]) * dts[j] : 0.f;
          const float v1 = i >= j + 1 ? acc[h2][2 * rr + 1] * expf(ci - cs[j + 1]) * dts[j + 1] : 0.f;
          uint32_t tm[3];
          split3(v0, v1, tm);
#pragma unroll
          for (int u = 0; u < 3; ++u)
            asm volatile("st.shared.b32 [%0], %1;\n"
                         :: "r"(mbase + u * pl.mplane + swz(i, j, Q)), "r"(tm[u]));
        }
    }

    // 3. y^T = exp(csum) (h^T C^T): h^T split in registers.
    float yacc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) yacc[i][0] = yacc[i][1] = yacc[i][2] = yacc[i][3] = 0.f;
    if (c > 0) {
#pragma unroll
      for (int kk = 0; kk < NP / 16; ++kk) {
        uint32_t ah[3][4];
        {
          uint32_t s0[3], s1[3], s2[3], s3[3];
          split3(hacc[2 * kk][0], hacc[2 * kk][1], s0);
          split3(hacc[2 * kk][2], hacc[2 * kk][3], s1);
          split3(hacc[2 * kk + 1][0], hacc[2 * kk + 1][1], s2);
          split3(hacc[2 * kk + 1][2], hacc[2 * kk + 1][3], s3);
#pragma unroll
          for (int u = 0; u < 3; ++u) { ah[u][0] = s0[u]; ah[u][1] = s1[u]; ah[u][2] = s2[u]; ah[u][3] = s3[u]; }
        }
#pragma unroll
        for (int n2 = 0; n2 < 4; ++n2) {
          uint32_t bf[TI][4];
#pragma unroll
          for (int u = 0; u < TI; ++u)
            ldsm_x4(bf[u], b_addr(cb + u * pl.bcplane, 16 * n2, 16 * kk, NP, lane));
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            uint32_t b2[TI][2];
#pragma unroll
            for (int u = 0; u < TI; ++u) { b2[u][0] = bf[u][2 * h2]; b2[u][1] = bf[u][2 * h2 + 1]; }
            mma_terms<3, TI>(yacc[2 * n2 + h2], ah, b2);
          }
        }
      }
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const float e0 = ecs[8 * ni + 2 * t], e1 = ecs[8 * ni + 2 * t + 1];
        yacc[ni][0] *= e0; yacc[ni][1] *= e1; yacc[ni][2] *= e0; yacc[ni][3] *= e1;
      }
    }
    __syncthreads();                       // the masked score planes are complete

    // 4. y^T += x^T M^T over the causal blocks (k <= m); store y.
#pragma unroll
    for (int m = 0; m < 4; ++m) {
#pragma unroll
      for (int k = 0; k <= m; ++k) {
        uint32_t ax[TI][4], bm[3][4];
#pragma unroll
        for (int u = 0; u < TI; ++u) ldsm_x4_t(ax[u], at_addr(xb + u * pl.xplane, 16 * k, p0, pl.xw, lane));
#pragma unroll
        for (int u = 0; u < 3; ++u) ldsm_x4(bm[u], b_addr(mbase + u * pl.mplane, 16 * m, 16 * k, Q, lane));
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          uint32_t b2[3][2];
#pragma unroll
          for (int u = 0; u < 3; ++u) { b2[u][0] = bm[u][2 * h2]; b2[u][1] = bm[u][2 * h2 + 1]; }
          mma_terms<TI, 3>(yacc[2 * m + h2], ax, b2);
        }
      }
    }
    {
      const int rows = min(Q, a.S - c0);
      float* yc = a.y + a.sy.at(seq, head, c0);
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int p = p0 + g + 8 * (e >> 1), i = 8 * ni + 2 * t + (e & 1);
          if (p < a.P && i < rows) yc[i * a.sy.s + p] = yacc[ni][e];
        }
    }

    // 5. h^T <- h^T exp(csum_Q) + (x dt exp(csum_Q - csum))^T B.
    const float decay = expf(cs_last);
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) hacc[i][e] *= decay;
#pragma unroll
    for (int kk = 0; kk < Q / 16; ++kk) {
      uint32_t ax[3][4];
      {
        uint32_t raw[TI][4];
#pragma unroll
        for (int u = 0; u < TI; ++u) ldsm_x4_t(raw[u], at_addr(xb + u * pl.xplane, 16 * kk, p0, pl.xw, lane));
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int j = 16 * kk + 2 * t + 8 * (r >> 1);
          float2 v = unpack(raw[0][r]);
#pragma unroll
          for (int u = 1; u < TI; ++u) {
            const float2 w = unpack(raw[u][r]);
            v.x += w.x; v.y += w.y;
          }
          uint32_t s[3];
          split3(v.x * wv[j], v.y * wv[j + 1], s);
#pragma unroll
          for (int u = 0; u < 3; ++u) ax[u][r] = s[u];
        }
      }
#pragma unroll
      for (int n2 = 0; n2 < NT / 2; ++n2) {
        uint32_t bf[TI][4];
#pragma unroll
        for (int u = 0; u < TI; ++u)
          ldsm_x4_t(bf[u], bt_addr(bb + u * pl.bcplane, 16 * kk, 16 * n2, NP, lane));
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          uint32_t b2[TI][2];
#pragma unroll
          for (int u = 0; u < TI; ++u) { b2[u][0] = bf[u][2 * h2]; b2[u][1] = bf[u][2 * h2 + 1]; }
          mma_terms<3, TI>(hacc[2 * n2 + h2], ax, b2);
        }
      }
    }
  }
  // h_final in the model's orientation (P, N).
  float* ho = a.hout + ((long long)seq * a.nh + head) * a.P * a.N;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = p0 + g + 8 * (e >> 1), n = 8 * nt + 2 * t + (e & 1);
      if (p < a.P && n < a.N) ho[(long long)p * a.N + n] = hacc[nt][e];
    }
}

template <typename T, int NP>
cudaError_t launch(const Args& a, int nb, cudaStream_t stream) {
  const Plan pl(a.P, NP, sizeof(T) == 4);
  if (pl.total > MAX_SMEM || nb > 65535) return cudaErrorInvalidValue;
  static bool opted_in = false;    // once, so no attribute call during graph capture
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_chunk_kernel<T, NP>, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  ssd_chunk_kernel<T, NP><<<dim3(a.nh, nb), 32 * pl.warps, pl.total, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_n(const Args& a, int nb, cudaStream_t stream) {
  return a.N <= 64 ? launch<T, 64>(a, nb, stream) : launch<T, 128>(a, nb, stream);
}

bool aligned(const void* p, const long long* s, int esize) {
  if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  for (int k = 0; k < 3; ++k)
    if ((s[k] * esize) % 16) return false;
  return true;
}

}  // namespace

extern "C" {

// x, B, C: float32 (bf16 = 0) or bfloat16 (bf16 = 1); dt, dA: float32.
// strides: 18 element strides, (sequence, head, position) for x, dt, dA, B,
// C and y in that order; the last dimension of x, B, C and y is contiguous.
// y: float32; h_final: float32 (nb, nh, P, N), contiguous. P <= 128,
// N <= 128. Grid: heads on x, sequences on y (at most 65535). Returns
// cudaGetLastError(), or cudaErrorInvalidValue if the shapes need more
// shared memory than a block has or nb exceeds the grid.
int ssd_chunk_fwd(const void* x, const void* dt, const void* da, const void* B,
                  const void* C, void* y, void* hout, int nb, int nh, int S, int P,
                  int N, int bf16, const long long* strides, void* stream) {
  if (P < 1 || P > 128 || N < 1 || N > 128) return (int)cudaErrorInvalidValue;
  Args a{x, static_cast<const float*>(dt), static_cast<const float*>(da), B, C,
         static_cast<float*>(y), static_cast<float*>(hout), nh, S, P, N, 0};
  Strides* dst[6] = {&a.sx, &a.sdt, &a.sda, &a.sB, &a.sC, &a.sy};
  for (int k = 0; k < 6; ++k) *dst[k] = {strides[3 * k], strides[3 * k + 1], strides[3 * k + 2]};
  const int es = bf16 ? 2 : 4;
  a.vec = (P * es) % 16 == 0 && (N * es) % 16 == 0 && aligned(x, strides, es) &&
          aligned(B, strides + 9, es) && aligned(C, strides + 12, es);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? launch_n<__nv_bfloat16>(a, nb, st) : launch_n<float>(a, nb, st));
}

// Dynamic shared memory (bytes) of a launch at state width P and size N.
int ssd_smem_bytes(int P, int N, int bf16) {
  return Plan(P, N <= 64 ? 64 : 128, !bf16).total;
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
