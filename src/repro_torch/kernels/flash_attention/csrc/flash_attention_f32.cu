// FlashAttention in float32 for Hopper (sm_90a): the forward, the forward
// with a per-row LSE, and the two backward kernels.
//
// Replaces, for float32 q, k, v (and dO), the Pallas kernels that
// flash_attention.cu replaces for bfloat16:
// * src/repro/kernels/flash_attention/kernel.py, flash_attention_fwd
//   (_fa_kernel, the pallas_call at kernel.py:112);
// * backward.py, flash_attention_fwd_lse (_fa_fwd_lse_kernel, :109);
// * backward.py, flash_attention_bwd: _fa_bwd_dkv_kernel (:252) and
//   _fa_bwd_dq_kernel (:283).
// The functions are those of flash_attention.cu: GQA (query head h reads kv
// head h // n_rep), causal masking top-left aligned (key <= query) or none,
// Sq != Sk, a row with no visible key gives o = 0 and lse = -inf, dK and dV
// summed over the query heads of a kv head, D = rowsum(dO * O) from
// outside, P recomputed from the LSE; every tensor read and written through
// its strides (rows on 16 bytes).
//
// Float32 accuracy on the tensor cores: split TF32. The reference holds its
// float32 kernels to 2e-5 (forward) and 2e-4 (backward). The tensor cores
// take float32 operands only as TF32 (10 mantissa bits), whose rounding
// (2^-11 of each operand) misses 2e-5 by 13 to 53 times (the CPU
// emulation of tests/test_torch_f32_split.py). So each
// float32 operand a is split as a = hi + lo: hi = a rounded to TF32 to
// nearest, ties away from zero (cvt.rna.tf32.f32, done here on the bits:
// (bits + 0x1000) & ~0x1fff), lo = a - hi (exact in f32) rounded alike.
// Each product is hi hi + hi lo + lo hi, three TF32 products of
// mma.sync.m16n8k8 accumulated in f32; a TF32 x TF32 product is exact in
// f32 (11 x 11 significant bits). The error bound: |a - hi - lo| <= 2^-22
// |a| (lo's own rounding), and the dropped lo lo is at most 2^-22 |a||b|,
// so each split product is within about 3 x 2^-22 |a||b| (7e-7) of a b,
// near the f32 FMA's 2^-24 and below plain TF32's 2^-10 by a factor of
// about 1,400; the sums then round as f32 sums do. The test emulates this
// arithmetic and holds it to the reference's tolerances.
//
// Bound on this card: operations, at the split rate of the TF32 tensor
// cores (495 / 3 = 165 TFLOP/s of f32 products): a causal (4, 16, 2048,
// 128) forward with LSE is 68.7 GFLOP, 0.42 ms (kernels/cost.py), against
// 1.03 ms at the 67 TFLOP/s of the CUDA cores.
// Besides the three mma a product, every operand fragment is split in
// registers (five integer or f32 instructions an element), so the issue
// slots, not the tensor cores alone, set the pace.
//
// Design of the three kernels:
// * mma.sync m16n8k8, not wgmma: wgmma's TF32 form takes both operands
//   K-major from shared memory (A may come from registers), so P V and the
//   backward's products would want V, dO and Q transposed, and pre-split
//   hi / lo tiles double shared memory (a 64 x 128 f32 tile is 32 KB; dK/dV
//   at hd 128 would not fit). mma.sync reads its fragments from f32 tiles
//   in any layout and splits them in registers, and its accumulator is the
//   next product's A fragment with no round trip through shared memory: a
//   16 x 8 accumulator holds columns 2c and 2c + 1 at lane c, so P V (and
//   P^T dO, dS^T Q) take the keys (queries) in the order 2c, 2c + 1 as the
//   A fragment's columns c, c + 4, and read V's (dO's, Q's) rows in that
//   order (load_b).
// * Every tile is row-major in shared memory with rows of hd + 4 floats,
//   so the three fragment patterns (load_a, load_bt, load_b) meet 32
//   distinct banks; tiles arrive by cp.async (16 bytes a copy, rows past
//   the end zero-filled) into a ring of two stages, the next tile's copy
//   in flight while this tile's products run.
// * Forward: one block of 8 warps per 128 query rows of one (batch, head),
//   16 rows a warp; Q resident; 64-key K and V tiles through the ring; S
//   (16 x 64 a warp) and P stay in registers; the online softmax in the
//   log2 domain (exp2f), each row's max and sum over the 4 lanes that hold
//   it; a warp skips a tile wholly right of its rows. Grid (B H, query
//   tiles), the longest rows first over all heads.
// * dQ: the forward's layout, 16 query rows a warp; Q and dO resident, each
//   row's LSE and D in registers; K and V tiles through the ring (32 keys a
//   tile at hd 128, 64 below: two stages of 64 would not fit beside Q and dO);
//   S, P, dP and dS stay in registers; dQ += dS K reads K's rows in load_b's
//   order from the tile S = Q K^T read by load_bt, so K is loaded once; dQ
//   summed in a fixed order, no atomics, and written once, times scale. Grid
//   (B H, query tiles), the queries with the most keys first over all heads.
// * dK/dV: one block of 8 warps per 128 keys of one (batch, kv head), 16
//   keys a warp; K and V resident; Q, dO and the tile's LSE and D through
//   the ring, tile after tile over every query head of the group (32
//   queries a tile at hd 128, 64 below); S^T, P^T, dP^T and dS^T stay in
//   registers; dK and dV summed in registers in a fixed order, no atomics,
//   so two calls give the same bits. Grid (B Hkv, key tiles), the first
//   keys (the most query tiles) first over all heads.
// * The tensor cores' f32 accumulation truncates, so one chain of
//   thousands of mma into one accumulator drifts: dV summed over every
//   query of a GQA-4 group at 2048 nears the 2e-4 tolerance
//   (tools/flash_f32_compare.py, variant one-chain). Each tile's products
//   are summed in fresh accumulators and added by f32 FMAs (tile_product)
//   to O, with the softmax's rescale, or to dQ, all column blocks at once,
//   or to dK and dV, 4 column blocks of 8 at a time (2 or 8 spill: variants
//   dkv-cw2 and dkv-cw8).
// * The rounding is the integer form: cvt.rna.tf32.f32 gives the same bits
//   and takes longer (variant cvt).
// * ptxas (sm_90a; registers, no spill; dynamic shared memory): forward
//   250 / 186 / 155 / 151 registers with the LSE at hd 128 / 64 / 32 / 16
//   (250 / 184 / 153 / 128 without), 202,752 / 104,448 / 55,296 / 30,720
//   bytes; dK/dV 255 / 255 / 208 / 168, 203,264 / 140,288 / 74,752 /
//   41,984 bytes; dQ 223 / 213 / 192 / 186, 202,752 / 139,264 / 73,728 /
//   40,960 bytes: one block of 8 warps an SM at hd 128. dQ's fresh
//   accumulators over all column blocks at once read 1 % faster than 4 or 8
//   at a time (variants dq-cw4, dq-cw8; H100 80GB HBM3, 700 W).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr int THREADS = 256;  // every kernel: 8 warps

struct Str3 {  // element strides of a (B, heads, S, hd) tensor
  int64_t b, h, s;
};

// ----------------------------- split TF32 -------------------------------------
// a rounded to TF32, to nearest with ties away from zero: cvt.rna.tf32.f32's
// value for a finite a, as an f32 bit pattern with the low 13 bits zero.
__device__ __forceinline__ uint32_t tf32_rna(float a) {
  return (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
}

struct FragA {  // a 16 x 8 A fragment, split: a = hi + lo
  uint32_t hi[4], lo[4];
};
struct FragB {  // an 8 x 8 B fragment, split
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ void split(float a, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(a);
  lo = tf32_rna(a - __uint_as_float(hi));
}

__device__ __forceinline__ FragA split_a(float a0, float a1, float a2, float a3) {
  FragA f;
  split(a0, f.hi[0], f.lo[0]);
  split(a1, f.hi[1], f.lo[1]);
  split(a2, f.hi[2], f.lo[2]);
  split(a3, f.hi[3], f.lo[3]);
  return f;
}

__device__ __forceinline__ FragB split_b(float b0, float b1) {
  FragB f;
  split(b0, f.hi[0], f.lo[0]);
  split(b1, f.hi[1], f.lo[1]);
  return f;
}

// d += a b, one m16n8k8 TF32 product accumulated in f32.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b at float32 accuracy: lo hi + hi lo + hi hi, the small terms
// first; lo lo is dropped.
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a, const FragB& b) {
  mma_tf32(d, a.lo, b.hi);
  mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

// Fragments from a row-major tile t (ld floats a row) in shared memory, g =
// lane / 4 and c = lane % 4 (PTX's groupID and threadID_in_group). The A
// fragment of rows r0 .. r0 + 15, columns k0 .. k0 + 7.
__device__ __forceinline__ FragA load_a(const float* t, int ld, int r0, int k0, int g, int c) {
  const float* p = t + (r0 + g) * ld + k0 + c;
  return split_a(p[0], p[8 * ld], p[4], p[8 * ld + 4]);
}

// The B fragment that is the transpose of rows n0 .. n0 + 7, columns k0 ..
// k0 + 7 of t (K in S = Q K^T).
__device__ __forceinline__ FragB load_bt(const float* t, int ld, int n0, int k0, int g, int c) {
  const float* p = t + (n0 + g) * ld + k0 + c;
  return split_b(p[0], p[4]);
}

// The B fragment of rows k0 .. k0 + 7, columns n0 .. n0 + 7 of t, its rows
// c and c + 4 being t's rows k0 + 2c and k0 + 2c + 1: the order in which
// acc_as_a hands over an accumulator's columns (V in P V).
__device__ __forceinline__ FragB load_b(const float* t, int ld, int k0, int n0, int g, int c) {
  const float* p = t + (k0 + 2 * c) * ld + n0 + g;
  return split_b(p[0], p[ld]);
}

// A 16 x 8 accumulator (rows g, g + 8; columns 2c, 2c + 1) as the A
// fragment of a product over its columns, in load_b's order.
__device__ __forceinline__ FragA acc_as_a(const float (&d)[4]) {
  return split_a(d[0], d[2], d[1], d[3]);
}

// ------------------------------ cp.async --------------------------------------
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [r0, r0 + ROWS) of one head (base: its row 0, ss its row stride) of
// a view with n >= 1 rows into a row-major tile of HD + 4 floats a row,
// rows past n as zeros (a copy of 0 bytes from row 0).
template <int HD, int ROWS>
__device__ __forceinline__ void copy_rows(float* dst, const float* __restrict__ base, int64_t ss,
                                          int r0, int n) {
  constexpr int C4 = HD / 4;  // 16-byte copies a row
#pragma unroll 4
  for (int i = threadIdx.x; i < ROWS * C4; i += THREADS) {
    const int r = i / C4, c = i % C4 * 4;
    const bool ok = r0 + r < n;
    cp_async16(dst + r * (HD + 4) + c, ok ? base + (int64_t)(r0 + r) * ss + c : base, ok);
  }
}

// Max and sum over the 4 lanes that hold one accumulator row.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// acc = acc alpha + a t over the tile's NJ k-steps (alpha per accumulator
// row, g or g + 8): a the split A fragments of an accumulator 16 x 8 NJ
// wide, t a row-major tile (LD floats a row) read by load_b. The products
// of each CW columns of 8 are summed in fresh accumulators, then added to
// acc by f32 FMAs: the tensor cores' f32 sums truncate, so one chain of
// them over every key or query tile drifts.
template <int NI, int NJ, int CW, int LD>
__device__ __forceinline__ void tile_product(float (&acc)[NI][4], const FragA (&a)[NJ],
                                             const float* t, int g, int c,
                                             const float (&alpha)[2]) {
#pragma unroll
  for (int i0 = 0; i0 < NI; i0 += CW) {
    float part[CW][4];
#pragma unroll
    for (int i = 0; i < CW; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[i][e] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int i = 0; i < CW; ++i) mma3(part[i], a[j], load_b(t, LD, 8 * j, 8 * (i0 + i), g, c));
#pragma unroll
    for (int i = 0; i < CW; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[i0 + i][e] = fmaf(acc[i0 + i][e], alpha[e / 2], part[i][e]);
  }
}

// ------------------------------- forward -------------------------------------
template <int HD>
struct Fwd {
  static_assert(HD == 16 || HD == 32 || HD == 64 || HD == 128, "hd in {16, 32, 64, 128}");
  static constexpr int BM = 128;                         // query rows a block, 16 a warp
  static constexpr int BN = 64;                          // keys a tile
  static constexpr int LD = HD + 4;                      // floats a tile row
  static constexpr int KV = BN * LD;                     // floats of a K or V tile
  static constexpr int SMEM = 4 * (BM * LD + 2 * 2 * KV);  // Q, two stages of K and V
};

template <int HD, bool LSE>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         float* __restrict__ lse, int H, int Hkv, int Sq, int Sk, int causal,
                         float scale_log2, Str3 qs, Str3 ks, Str3 vs, Str3 os) {
  using G = Fwd<HD>;
  constexpr int LD = G::LD, NI = HD / 8, NJ = G::BN / 8;
  extern __shared__ float4 fwd_smem[];
  float* Qs = reinterpret_cast<float*>(fwd_smem);
  float* ring = Qs + G::BM * LD;  // stage s: K at ring + 2 s KV, V after it
  const int bh = blockIdx.x, b = bh / H, h = bh % H, kvh = h / (H / Hkv);
  const int m0 = (gridDim.y - 1 - blockIdx.y) * G::BM;  // the longest rows first
  const int warp = threadIdx.x / 32, g = threadIdx.x % 32 / 4, c = threadIdx.x % 4;
  const int wr = 16 * warp;                       // the warp's first row in the tile
  const int rows[2] = {m0 + wr + g, m0 + wr + g + 8};  // the thread's two rows
  const float* kb = k + b * ks.b + kvh * ks.h;
  const float* vb = v + b * vs.b + kvh * vs.h;
  const int n_end = causal ? min(Sk, m0 + G::BM) : Sk;
  const int tiles = (n_end + G::BN - 1) / G::BN;
  copy_rows<HD, G::BM>(Qs, q + b * qs.b + h * qs.h, qs.s, m0, Sq);
  if (tiles > 0) {
    copy_rows<HD, G::BN>(ring, kb, ks.s, 0, Sk);
    copy_rows<HD, G::BN>(ring + G::KV, vb, vs.s, 0, Sk);
  }
  cp_async_commit();

  float acc[NI][4], mrow[2] = {-INFINITY, -INFINITY}, lrow[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  for (int it = 0; it < tiles; ++it) {
    const int n0 = it * G::BN;
    if (it + 1 < tiles) {
      float* next = ring + ((it + 1) & 1) * 2 * G::KV;
      copy_rows<HD, G::BN>(next, kb, ks.s, n0 + G::BN, Sk);
      copy_rows<HD, G::BN>(next + G::KV, vb, vs.s, n0 + G::BN, Sk);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and Q) arrived; the next one may be in flight
    __syncthreads();
    const float* Ks = ring + (it & 1) * 2 * G::KV;
    const float* Vs = Ks + G::KV;
    if (!causal || n0 <= m0 + wr + 15) {  // else every key of the tile is right of the warp's rows
      float s[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD; kk += 8) {
        const FragA a = load_a(Qs, LD, wr, kk, g, c);
#pragma unroll
        for (int j = 0; j < NJ; ++j) mma3(s[j], a, load_bt(Ks, LD, 8 * j, kk, g, c));
      }
      // the online softmax; element e of a tile is row e / 2, key 2c + e % 2
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = n0 + 8 * j + 2 * c + (e & 1);
          const bool vis = key < Sk && (!causal || key <= rows[e / 2]);
          s[j][e] = vis ? s[j][e] * scale_log2 : -INFINITY;
          mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
        }
      float base[2], alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(mrow[r], quad_max(mx[r]));
        base[r] = m_new == -INFINITY ? 0.f : m_new;  // a row with no key yet
        alpha[r] = exp2f(mrow[r] - base[r]);
        mrow[r] = m_new;
        lrow[r] *= alpha[r];  // this thread's columns; summed at the end
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = exp2f(s[j][e] - base[e / 2]);
          lrow[e / 2] += s[j][e];
        }
      // O = O alpha + P V, P split once straight from the accumulators
      FragA pa[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) pa[j] = acc_as_a(s[j]);
      tile_product<NI, NJ, NI, LD>(acc, pa, Vs, g, c, alpha);
    }
    __syncthreads();  // this stage is free for the copy two tiles on
  }
  cp_async_wait<0>();
  float* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l = quad_sum(lrow[r]);
    const float inv = l == 0.f ? 1.f : 1.f / l;  // fully masked rows -> 0
    if (rows[r] >= Sq) continue;
    if (LSE && c == 0)
      lse[(int64_t)bh * Sq + rows[r]] = (l == 0.f ? mrow[r] : mrow[r] + log2f(l)) * LN2;
    float* out = ob + (int64_t)rows[r] * os.s + 2 * c;
#pragma unroll
    for (int i = 0; i < NI; ++i)
      *reinterpret_cast<float2*>(out + 8 * i) =
          make_float2(acc[i][2 * r] * inv, acc[i][2 * r + 1] * inv);
  }
}

// ------------------------------ dK / dV --------------------------------------
template <int HD>
struct Dkv {
  static_assert(HD == 16 || HD == 32 || HD == 64 || HD == 128, "hd in {16, 32, 64, 128}");
  static constexpr int BN = 128;                   // keys a block, 16 a warp
  static constexpr int BM = HD == 128 ? 32 : 64;   // queries a tile (registers at hd 128)
  static constexpr int LD = HD + 4;                // floats a tile row
  static constexpr int CW = HD / 8 < 4 ? HD / 8 : 4;  // 8-column blocks of dK, dV a chunk
  static constexpr int QT = BM * LD;               // floats of a Q or dO tile
  static constexpr int STAGE = 2 * QT + 2 * BM;    // Q, dO, the tile's LSE and D
  static constexpr int SMEM = 4 * (2 * BN * LD + 2 * STAGE);  // K, V, two stages
};

// dK/dV: 128 keys of one (batch, kv head), K and V resident; for each query
// head of the group and each query tile at or below the diagonal S^T = K
// Q^T, dP^T = V dO^T, P^T = exp2(S^T scale log2 e - LSE log2 e) masked,
// dS^T = P^T (dP^T - D), dV += P^T dO, dK += dS^T Q.
template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, const float* __restrict__ dout,
                             const float* __restrict__ lse, const float* __restrict__ dd,
                             float* __restrict__ dk, float* __restrict__ dv, int H, int Hkv,
                             int Sq, int Sk, int causal, float scale, Str3 qs, Str3 ks,
                             Str3 vs, Str3 dos, Str3 dks, Str3 dvs) {
  using G = Dkv<HD>;
  constexpr int LD = G::LD, NI = HD / 8, NJ = G::BM / 8;
  extern __shared__ float4 dkv_smem[];
  float* Ks = reinterpret_cast<float*>(dkv_smem);
  float* Vs = Ks + G::BN * LD;
  float* ring = Vs + G::BN * LD;  // stage s: Q, dO, LSE, D at ring + s STAGE
  const int bkv = blockIdx.x, b = bkv / Hkv, kvh = bkv % Hkv, n_rep = H / Hkv;
  const int n0 = blockIdx.y * G::BN;  // the first keys, the most query tiles, first
  const int warp = threadIdx.x / 32, g = threadIdx.x % 32 / 4, c = threadIdx.x % 4;
  const int wk = 16 * warp;  // the warp's first key in the block
  const int keys[2] = {n0 + wk + g, n0 + wk + g + 8};  // the thread's two keys
  const float scale_log2 = scale * LOG2E;
  // query tiles wholly above the diagonal see no key of this block
  const int m_begin = causal ? n0 : 0;
  const int per_head = m_begin < Sq ? (Sq - m_begin + G::BM - 1) / G::BM : 0;
  const int tiles = n_rep * per_head;
  // tile i: query head kvh n_rep + i / per_head, rows m_begin + (i % per_head) BM
  auto copy_tile = [&](int i, float* st) {
    const int h = kvh * n_rep + i / per_head, m0 = m_begin + i % per_head * G::BM;
    copy_rows<HD, G::BM>(st, q + b * qs.b + h * qs.h, qs.s, m0, Sq);
    copy_rows<HD, G::BM>(st + G::QT, dout + b * dos.b + h * dos.h, dos.s, m0, Sq);
    const int64_t rb = (int64_t)(b * H + h) * Sq;
    for (int r = threadIdx.x; r < 2 * G::BM; r += THREADS) {  // rows past Sq: 0, masked
      const int m = m0 + r % G::BM;
      cp_async4(st + 2 * G::QT + r, (r < G::BM ? lse : dd) + rb + (m < Sq ? m : 0), m < Sq);
    }
  };
  if (tiles > 0) {
    copy_rows<HD, G::BN>(Ks, k + b * ks.b + kvh * ks.h, ks.s, n0, Sk);
    copy_rows<HD, G::BN>(Vs, v + b * vs.b + kvh * vs.h, vs.s, n0, Sk);
    copy_tile(0, ring);
  }
  cp_async_commit();

  float dka[NI][4], dva[NI][4];
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[i][e] = dva[i][e] = 0.f;
  for (int it = 0; it < tiles; ++it) {
    if (it + 1 < tiles) copy_tile(it + 1, ring + ((it + 1) & 1) * G::STAGE);
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and K, V) arrived; the next one may be in flight
    __syncthreads();
    const int m0 = m_begin + it % per_head * G::BM;
    const float* Qs = ring + (it & 1) * G::STAGE;
    const float* dOs = Qs + G::QT;
    const float* rowv = dOs + G::QT;  // the tile's LSE, then its D
    // else the warp's keys are past Sk, or every one right of the tile's queries
    if (n0 + wk < Sk && (!causal || n0 + wk <= m0 + G::BM - 1)) {
      float s[NJ][4], dp[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD; kk += 8) {
        const FragA ak = load_a(Ks, LD, wk, kk, g, c);
        const FragA av = load_a(Vs, LD, wk, kk, g, c);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          mma3(s[j], ak, load_bt(Qs, LD, 8 * j, kk, g, c));
          mma3(dp[j], av, load_bt(dOs, LD, 8 * j, kk, g, c));
        }
      }
      // element e of a tile is key e / 2, query 2c + e % 2
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * c + (e & 1), qi = m0 + col, key = keys[e / 2];
          const bool vis = key < Sk && qi < Sq && (!causal || key <= qi);
          const float p =
              vis ? exp2f(fmaf(s[j][e], scale_log2, -(rowv[col] * LOG2E))) : 0.f;
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - rowv[G::BM + col]);
        }
      // dV += P^T dO, then dK += dS^T Q, P^T and dS^T split once straight
      // from the accumulators, CW columns of 8 at a time (for registers)
      const float one[2] = {1.f, 1.f};
      FragA fa[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) fa[j] = acc_as_a(s[j]);
      tile_product<NI, NJ, G::CW, LD>(dva, fa, dOs, g, c, one);
#pragma unroll
      for (int j = 0; j < NJ; ++j) fa[j] = acc_as_a(dp[j]);
      tile_product<NI, NJ, G::CW, LD>(dka, fa, Qs, g, c, one);
    }
    __syncthreads();  // this stage is free for the copy two tiles on
  }
  cp_async_wait<0>();
  float* dkb = dk + b * dks.b + kvh * dks.h;
  float* dvb = dv + b * dvs.b + kvh * dvs.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (keys[r] >= Sk) continue;
    float* ok = dkb + (int64_t)keys[r] * dks.s + 2 * c;
    float* ov = dvb + (int64_t)keys[r] * dvs.s + 2 * c;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      *reinterpret_cast<float2*>(ok + 8 * i) =
          make_float2(dka[i][2 * r] * scale, dka[i][2 * r + 1] * scale);
      *reinterpret_cast<float2*>(ov + 8 * i) = make_float2(dva[i][2 * r], dva[i][2 * r + 1]);
    }
  }
}

// --------------------------------- dQ ----------------------------------------
template <int HD>
struct Dq {
  static_assert(HD == 16 || HD == 32 || HD == 64 || HD == 128, "hd in {16, 32, 64, 128}");
  static constexpr int BM = 128;                   // query rows a block, 16 a warp
  static constexpr int BN = HD == 128 ? 32 : 64;   // keys a tile (shared memory at hd 128)
  static constexpr int LD = HD + 4;                // floats a tile row
  static constexpr int CW = HD / 8;                // 8-column blocks of dQ a chunk: all
  static constexpr int KV = BN * LD;               // floats of a K or V tile
  static constexpr int SMEM = 4 * (2 * BM * LD + 2 * 2 * KV);  // Q, dO, two stages of K and V
};

// dQ: 128 query rows of one (batch, head), Q and dO resident, each row's LSE
// and D in registers; for each key tile at or left of the diagonal S = Q
// K^T, dP = dO V^T, P = exp2(S scale log2 e - LSE log2 e) masked, dS = P (dP
// - D), dQ += dS K.
template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const float* __restrict__ dout,
                            const float* __restrict__ lse, const float* __restrict__ dd,
                            float* __restrict__ dq, int H, int Hkv, int Sq, int Sk, int causal,
                            float scale, Str3 qs, Str3 ks, Str3 vs, Str3 dos, Str3 dqs) {
  using G = Dq<HD>;
  constexpr int LD = G::LD, NI = HD / 8, NJ = G::BN / 8;
  extern __shared__ float4 dq_smem[];
  float* Qs = reinterpret_cast<float*>(dq_smem);
  float* dOs = Qs + G::BM * LD;
  float* ring = dOs + G::BM * LD;  // stage s: K at ring + 2 s KV, V after it
  const int bh = blockIdx.x, b = bh / H, h = bh % H, kvh = h / (H / Hkv);
  const int m0 = (gridDim.y - 1 - blockIdx.y) * G::BM;  // the most keys first
  const int warp = threadIdx.x / 32, g = threadIdx.x % 32 / 4, c = threadIdx.x % 4;
  const int wr = 16 * warp;                       // the warp's first row in the tile
  const int rows[2] = {m0 + wr + g, m0 + wr + g + 8};  // the thread's two rows
  const float scale_log2 = scale * LOG2E;
  const float* kb = k + b * ks.b + kvh * ks.h;
  const float* vb = v + b * vs.b + kvh * vs.h;
  const int n_end = causal ? min(Sk, m0 + G::BM) : Sk;
  const int tiles = (n_end + G::BN - 1) / G::BN;
  copy_rows<HD, G::BM>(Qs, q + b * qs.b + h * qs.h, qs.s, m0, Sq);
  copy_rows<HD, G::BM>(dOs, dout + b * dos.b + h * dos.h, dos.s, m0, Sq);
  if (tiles > 0) {
    copy_rows<HD, G::BN>(ring, kb, ks.s, 0, Sk);
    copy_rows<HD, G::BN>(ring + G::KV, vb, vs.s, 0, Sk);
  }
  cp_async_commit();
  // rows past Sq: zero Q and dO give dS = 0
  float lse2[2], drow[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool ok = rows[r] < Sq;
    lse2[r] = ok ? lse[(int64_t)bh * Sq + rows[r]] * LOG2E : 0.f;
    drow[r] = ok ? dd[(int64_t)bh * Sq + rows[r]] : 0.f;
  }

  float dqa[NI][4];
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[i][e] = 0.f;
  for (int it = 0; it < tiles; ++it) {
    const int n0 = it * G::BN;
    if (it + 1 < tiles) {
      float* next = ring + ((it + 1) & 1) * 2 * G::KV;
      copy_rows<HD, G::BN>(next, kb, ks.s, n0 + G::BN, Sk);
      copy_rows<HD, G::BN>(next + G::KV, vb, vs.s, n0 + G::BN, Sk);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and Q, dO) arrived; the next one may be in flight
    __syncthreads();
    const float* Ks = ring + (it & 1) * 2 * G::KV;
    const float* Vs = Ks + G::KV;
    if (!causal || n0 <= m0 + wr + 15) {  // else every key of the tile is right of the warp's rows
      float s[NJ][4], dp[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD; kk += 8) {
        const FragA aq = load_a(Qs, LD, wr, kk, g, c);
        const FragA ad = load_a(dOs, LD, wr, kk, g, c);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          mma3(s[j], aq, load_bt(Ks, LD, 8 * j, kk, g, c));
          mma3(dp[j], ad, load_bt(Vs, LD, 8 * j, kk, g, c));
        }
      }
      // element e of a tile is row e / 2, key 2c + e % 2
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = n0 + 8 * j + 2 * c + (e & 1);
          const bool vis = key < Sk && (!causal || key <= rows[e / 2]);
          const float p = vis ? exp2f(fmaf(s[j][e], scale_log2, -lse2[e / 2])) : 0.f;
          dp[j][e] = p * (dp[j][e] - drow[e / 2]);
        }
      // dQ += dS K, dS split once straight from the accumulators
      const float one[2] = {1.f, 1.f};
      FragA fa[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) fa[j] = acc_as_a(dp[j]);
      tile_product<NI, NJ, G::CW, LD>(dqa, fa, Ks, g, c, one);
    }
    __syncthreads();  // this stage is free for the copy two tiles on
  }
  cp_async_wait<0>();
  float* dqb = dq + b * dqs.b + h * dqs.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= Sq) continue;
    float* out = dqb + (int64_t)rows[r] * dqs.s + 2 * c;
#pragma unroll
    for (int i = 0; i < NI; ++i)
      *reinterpret_cast<float2*>(out + 8 * i) =
          make_float2(dqa[i][2 * r] * scale, dqa[i][2 * r + 1] * scale);
  }
}

// Raise a kernel's dynamic shared memory limit, once per process (so never
// inside a CUDA graph capture after the first call).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, bool& configured) {
  if (configured) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) configured = true;
  return err;
}

Str3 str3(const int64_t* st) { return Str3{st[0], st[1], st[2]}; }

template <int HD, bool LSE>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                       int H, int Hkv, int Sq, int Sk, int causal, float scale_log2,
                       const int64_t* st, cudaStream_t stream) {
  static bool configured = false;
  auto kernel = flash_fwd_f32_kernel<HD, LSE>;
  cudaError_t err = allow_smem(kernel, Fwd<HD>::SMEM, configured);
  if (err != cudaSuccess) return err;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(o);
  Str3 qs = str3(st), ks = str3(st + 3), vs = str3(st + 6), os = str3(st + 9);
  void* args[] = {&qf, &kf, &vf, &of, &lse, &H, &Hkv, &Sq, &Sk, &causal, &scale_log2,
                  &qs, &ks, &vs, &os};
  const dim3 grid(B * H, (Sq + Fwd<HD>::BM - 1) / Fwd<HD>::BM);
  err = cudaLaunchKernel((const void*)kernel, grid, dim3(THREADS), args, Fwd<HD>::SMEM, stream);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int HD>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* dd, void* dq, int B, int H, int Hkv,
                      int Sq, int Sk, int causal, float scale, const int64_t* st,
                      cudaStream_t stream) {
  static bool configured = false;
  auto kernel = flash_bwd_dq_f32_kernel<HD>;
  cudaError_t err = allow_smem(kernel, Dq<HD>::SMEM, configured);
  if (err != cudaSuccess) return err;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* df = static_cast<const float*>(dout);
  float* dqf = static_cast<float*>(dq);
  Str3 qs = str3(st), ks = str3(st + 3), vs = str3(st + 6), dos = str3(st + 9),
       dqs = str3(st + 12);
  void* args[] = {&qf, &kf, &vf, &df, &lse, &dd, &dqf, &H, &Hkv, &Sq, &Sk, &causal, &scale,
                  &qs, &ks, &vs, &dos, &dqs};
  const dim3 grid(B * H, (Sq + Dq<HD>::BM - 1) / Dq<HD>::BM);
  err = cudaLaunchKernel((const void*)kernel, grid, dim3(THREADS), args, Dq<HD>::SMEM, stream);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int HD>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* dd, void* dk, void* dv, int B, int H,
                       int Hkv, int Sq, int Sk, int causal, float scale, const int64_t* st,
                       cudaStream_t stream) {
  static bool configured = false;
  auto kernel = flash_bwd_dkv_f32_kernel<HD>;
  cudaError_t err = allow_smem(kernel, Dkv<HD>::SMEM, configured);
  if (err != cudaSuccess) return err;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* df = static_cast<const float*>(dout);
  float* dkf = static_cast<float*>(dk);
  float* dvf = static_cast<float*>(dv);
  Str3 qs = str3(st), ks = str3(st + 3), vs = str3(st + 6), dos = str3(st + 9),
       dks = str3(st + 12), dvs = str3(st + 15);
  void* args[] = {&qf, &kf, &vf, &df, &lse, &dd, &dkf, &dvf, &H, &Hkv, &Sq, &Sk, &causal,
                  &scale, &qs, &ks, &vs, &dos, &dks, &dvs};
  const dim3 grid(B * Hkv, (Sk + Dkv<HD>::BN - 1) / Dkv<HD>::BN);
  err = cudaLaunchKernel((const void*)kernel, grid, dim3(THREADS), args, Dkv<HD>::SMEM, stream);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

#define F32_DISPATCH(HDV, CALL) \
  switch (HDV) {                \
    case 16: return CALL(16);   \
    case 32: return CALL(32);   \
    case 64: return CALL(64);   \
    case 128: return CALL(128); \
    default: return (int)cudaErrorInvalidValue; \
  }

extern "C" {

// As flash_attention_fwd of flash_attention.cu, for float32 q, k, v and o:
// q (B, H, Sq, hd), k and v (B, Hkv, Sk, hd), o (B, H, Sq, hd), any strides
// with a unit last stride, rows on 16 bytes; strides (sb, sh, ss) of q, k,
// v and o in elements. hd in {16, 32, 64, 128}. Returns cudaGetLastError().
int flash_attention_f32_fwd(const void* q, const void* k, const void* v, void* o, int B,
                            int H, int Hkv, int Sq, int Sk, int hd, int causal,
                            float scale_log2, const int64_t* strides, void* stream) {
  if (Hkv < 1 || H % Hkv != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CALL(HD) (int)launch_fwd<HD, false>(q, k, v, o, nullptr, B, H, Hkv, Sq, Sk, causal, \
                                            scale_log2, strides, s)
  F32_DISPATCH(hd, CALL)
#undef CALL
}

// As flash_attention_f32_fwd, and lse: (B, H, Sq) f32, contiguous.
int flash_attention_f32_fwd_lse(const void* q, const void* k, const void* v, void* o,
                                float* lse, int B, int H, int Hkv, int Sq, int Sk, int hd,
                                int causal, float scale_log2, const int64_t* strides,
                                void* stream) {
  if (Hkv < 1 || H % Hkv != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CALL(HD) (int)launch_fwd<HD, true>(q, k, v, o, lse, B, H, Hkv, Sq, Sk, causal, \
                                           scale_log2, strides, s)
  F32_DISPATCH(hd, CALL)
#undef CALL
}

// dK and dV in float32, arguments as flash_attention_bwd_dkv's.
int flash_attention_f32_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                const float* lse, const float* dd, void* dk, void* dv, int B,
                                int H, int Hkv, int Sq, int Sk, int hd, int causal,
                                float scale, const int64_t* strides, void* stream) {
  if (Hkv < 1 || H % Hkv != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CALL(HD) (int)launch_dkv<HD>(q, k, v, dout, lse, dd, dk, dv, B, H, Hkv, Sq, Sk, causal, \
                                     scale, strides, s)
  F32_DISPATCH(hd, CALL)
#undef CALL
}

// dQ in float32, arguments as flash_attention_bwd_dq's.
int flash_attention_f32_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                               const float* lse, const float* dd, void* dq, int B, int H,
                               int Hkv, int Sq, int Sk, int hd, int causal, float scale,
                               const int64_t* strides, void* stream) {
  if (Hkv < 1 || H % Hkv != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CALL(HD) (int)launch_dq<HD>(q, k, v, dout, lse, dd, dq, B, H, Hkv, Sq, Sk, causal, \
                                    scale, strides, s)
  F32_DISPATCH(hd, CALL)
#undef CALL
}

// Dynamic shared memory a launch takes, in bytes: kernel 0 the forward
// (with or without LSE), 1 dK/dV, 2 dQ; 0 for another hd.
int flash_attention_f32_smem_bytes(int kernel, int hd) {
#define CALL(HD) kernel == 0 ? Fwd<HD>::SMEM : kernel == 1 ? Dkv<HD>::SMEM : Dq<HD>::SMEM
  switch (hd) {
    case 16: return CALL(16);
    case 32: return CALL(32);
    case 64: return CALL(64);
    case 128: return CALL(128);
    default: return 0;
  }
#undef CALL
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
