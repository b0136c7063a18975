// FlashAttention for Hopper (sm_90a), bf16 in, f32 softmax: the forward, the
// forward with a per-row LSE, and the two backward kernels.
//
// Replaces:
// * src/repro/kernels/flash_attention/kernel.py, flash_attention_fwd
//   (Pallas body _fa_kernel): causal or full GQA attention with an online
//   softmax; the kv head of query head h is h // n_rep (no repeated K/V);
//   tiles above the causal diagonal are skipped; fully masked rows give 0.
// * src/repro/kernels/flash_attention/backward.py, flash_attention_fwd_lse
//   (_fa_fwd_lse_kernel): the same, plus LSE = m + log l per query row in
//   f32 (l == 0 divides by 1).
// * backward.py, flash_attention_bwd: the dK/dV kernel (_fa_bwd_dkv_kernel)
//   and the dQ kernel (_fa_bwd_dq_kernel), below the forward.
//
// Bound on this card: operations. Causal prefill of 4 x 2048 tokens x 32
// heads x 128 does ~137 GFLOP per layer against ~67 MB of Q/K/V/O, about
// 2000 flops per byte, far above the ~295 where the H100's bf16 tensor
// cores (989 TFLOP/s dense) and not its memory become the limit. The full
// rate is reached only through warpgroup products (wgmma), with loads
// that overlap the math.
//
// Forward design (one template for hd 32, 64, 128, with and without LSE):
// * Persistent: one block per SM (at most one per work item) walks work
//   items of 128 query rows of one (batch, head). Heads go in groups whose
//   K/V fit in ~40 MB of L2 together; inside a group the longest (last)
//   query blocks of every head come first, and blocks take items in
//   zigzag rounds (k, 2P - 1 - k, 2P + k, ...), pairing long and short
//   ones. So the next item's loads overlap this one's epilogue, and there
//   is no block launch per item.
// * 384 threads: two consumer warpgroups of 64 query rows each and one
//   producer warpgroup. The roles split once into one if/else; setmaxnreg
//   gives each consumer thread 232 registers and each producer thread 40.
// * One producer thread loads with TMA (cp.async.bulk.tensor) through 4-D
//   tiled tensor maps over the strided (B, heads, S, hd) views, dims
//   (hd, heads, S, B): Q into one of two buffers, then K and V tiles of
//   128 keys into two rings of shared-memory stages, K_{j+1} ahead of V_j.
//   Each load completes on a "full" mbarrier with expect_tx bytes; before
//   reusing a buffer the producer waits on its "empty" mbarrier, which the
//   8 consumer warps arrive on once the product reading it has finished.
//   The ragged S edge is zero-filled by TMA and masked in the scores.
// * Shared memory is swizzled as the products read it: 128-byte swizzle
//   (64-byte at hd 32, whose rows are 64 bytes), boxes at most one swizzle
//   span wide, so an hd 128 row is two 64-column chunks, each its own TMA
//   box. hd 128: 2 x 32 KB of Q and two stages of 32 KB per ring, 192 KB;
//   hd 64 and 32: four stages per ring, 160 KB and 80 KB.
// * Each consumer warpgroup computes S = Q K^T as wgmma.m64n128k16 with
//   both operands in shared memory (K-major) and O += P V as
//   wgmma.m64n{hd}k16 with P in registers (the f32 accumulator of S packs
//   into bf16 A fragments with no shuffle) and V read MN-major
//   (transposed B). S of tile j and P V of tile j - 1 are in flight
//   together, and the softmax of tile j runs while P V does.
// * Ping-pong: the two warpgroups take turns (named barriers) to issue
//   their products, so one's run on the tensor cores while the other does
//   its softmax. The softmax is online in registers in the log2 domain: a
//   thread holds rows g and g + 8 of its warp's 16, the row max over 4
//   lanes by two shuffles, the scale folded into one FFMA before a single
//   ex2.approx.ftz; masking only on diagonal or ragged tiles.
// * The epilogue divides by l and writes o from registers through its
//   strides (rows past Sq are not written), and LSE = (m2 + log2 l) ln 2
//   with m2 kept in the log2 domain.
// * A pipeline fault (a load never issued, a wrong phase parity) would
//   leave a thread spinning on its mbarrier; after ~2^32 cycles the wait
//   gives up and the block writes NaN, so a fault fails every check
//   instead of hanging the card.
#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;    // query rows per block (backward)
constexpr int BN = 64;    // keys per tile (backward)
constexpr int NWARP = 4;  // 16 rows per warp (backward)
constexpr int PAD = 8;    // elements of padding per shared-memory row (backward)
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8. TRANS delivers each matrix transposed.
template <bool TRANS>
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const uint16_t* row) {
  if (TRANS)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(row)));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(row)));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [row0, row0 + ROWS) of a (rows, HD) matrix with row stride
// `stride` into shared memory, by asynchronous 16-byte copies; rows at or
// past `n_valid` are zero-filled (a copy of 0 source bytes).
template <int HD, int ROWS>
__device__ __forceinline__ void load_tile(uint16_t* sm, const __nv_bfloat16* __restrict__ g,
                                          int64_t stride, int row0, int n_valid) {
  constexpr int VPR = HD / 8;  // 16-byte vectors per row
  for (int i = threadIdx.x; i < ROWS * VPR; i += NWARP * 32) {
    const int r = i / VPR, c = (i % VPR) * 8;
    const bool ok = r < n_valid;
    const __nv_bfloat16* src = ok ? g + (int64_t)(row0 + r) * stride + c : g;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 ::"r"(smem_addr(sm + r * (HD + PAD) + c)), "l"(src), "r"(ok ? 16 : 0));
  }
}

// ------------------------------- forward -------------------------------------

constexpr int FBM = 128;          // query rows per work item: two warpgroups of 64
constexpr int FBN = 128;          // keys per K/V tile
constexpr int FWD_THREADS = 384;  // warpgroups 0 and 1 consume, 2 produces
constexpr int CONSUMER_WARPS = 8;

template <int HD>
struct Fwd {
  static constexpr int SW = HD * 2 < 128 ? HD * 2 : 128;  // swizzle span: bytes per chunk row
  static constexpr int CW = SW / 2;                       // columns per chunk (TMA box width)
  static constexpr int NC = HD / CW;                      // chunks per row
  static constexpr int KPC = SW / 32;                     // 16-column k-steps per chunk
  static constexpr int Q_CHUNK = FBM * SW;                // bytes of one chunk of Q
  static constexpr int KV_CHUNK = FBN * SW;               // bytes of one chunk of a K or V tile
  static constexpr int Q_BYTES = NC * Q_CHUNK;  // one of two Q buffers
  static constexpr int KV_BYTES = NC * KV_CHUNK;
  static constexpr int STAGES = HD == 128 ? 2 : 4;  // per ring (K, V)
  // wgmma descriptor layout: 1 = 128-byte swizzle, 2 = 64-byte
  static constexpr uint64_t LAYOUT = SW == 128 ? 1 : 2;
  // tiles (1024-byte aligned): two Q buffers, the K ring, the V ring; then
  // 4 + 4 * STAGES mbarriers; plus alignment slack
  static constexpr int SMEM = 1024 + 2 * Q_BYTES + STAGES * 2 * KV_BYTES + 8 * (4 + 4 * STAGES);
};

// ---- mbarriers
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the phase of `bar` with parity `parity` has completed. A wait
// that never ends is a pipeline fault (a load never issued, a wrong
// parity): after ~2^32 cycles (~2.4 s; a whole launch takes under a
// millisecond) the thread gives up and marks itself `stuck`, later waits
// return at once, and the epilogue writes NaN, so a fault fails every
// check instead of hanging the card. (No __trap: a trap block shared by
// both roles makes ptxas cap the consumers at the launch's 168 registers.)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity, bool& stuck) {
  const uint32_t a = smem_addr(bar);
  if (stuck || mbar_try_wait(a, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(a, parity))
    if (clock64() - t0 > (1ll << 32)) {
      stuck = true;
      return;
    }
}

// 2^x as one MUFU.EX2, subnormal results flushed to zero (exp2f without
// fast math adds range fixes around it; a probability below 2^-126 of the
// row's largest is dropped either way by its bf16 rounding in P V).
__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ---- TMA: one box (CW columns x 128 rows) of a 4-D map at (col, head, row, batch)
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int col, int head, int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(col), "r"(head), "r"(row),
      "r"(batch)
      : "memory");
}

// Rows [row, row + 128) of one head into a tile: one box per chunk, all
// completing on `bar`.
template <int HD>
__device__ __forceinline__ void load_rows(const CUtensorMap* map, uint8_t* dst, uint64_t* bar,
                                          int row, int head, int batch) {
  using C = Fwd<HD>;
  mbar_expect_tx(bar, C::NC * 128 * C::SW);
#pragma unroll
  for (int c = 0; c < C::NC; ++c)
    tma_load_4d(dst + c * 128 * C::SW, map, bar, c * C::CW, head, row, batch);
}

// ---- wgmma
// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (each >> 4) and the swizzle layout.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving register reads or writes across an
// asynchronous product that owns the registers.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

#define WG_F8(i)                                                                       \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define WG_R16(a, b, c, e, f, g, h, i, j, k, l, m, n, o, p, q)                             \
  "%" #a ", %" #b ", %" #c ", %" #e ", %" #f ", %" #g ", %" #h ", %" #i ", %" #j ", %" #k \
  ", %" #l ", %" #m ", %" #n ", %" #o ", %" #p ", %" #q

// d (64 x 128, f32) (+)= A (64 x 16, shared, K-major) B^T (B: 128 x 16,
// shared, K-major); scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      WG_R16(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15) ", "
      WG_R16(16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31) ", "
      WG_R16(32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47) ", "
      WG_R16(48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63)
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : WG_F8(0), WG_F8(8), WG_F8(16), WG_F8(24), WG_F8(32), WG_F8(40), WG_F8(48), WG_F8(56)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x N, f32) += A (64 x 16, bf16 fragments in registers, as
// mma.m16n8k16's A per warp) B (16 x N, shared, MN-major: transposed).
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (N == 32) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %21, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        WG_R16(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : WG_F8(0), WG_F8(8)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else if constexpr (N == 64) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        WG_R16(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15) ", "
        WG_R16(16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31)
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : WG_F8(0), WG_F8(8), WG_F8(16), WG_F8(24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else {
    static_assert(N == 128, "wgmma_rs: N in {32, 64, 128}");
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        WG_R16(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15) ", "
        WG_R16(16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31) ", "
        WG_R16(32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47) ", "
        WG_R16(48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63)
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : WG_F8(0), WG_F8(8), WG_F8(16), WG_F8(24), WG_F8(32), WG_F8(40), WG_F8(48), WG_F8(56)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
}

// S = Q K^T for one warpgroup: wgmma k-steps of 16 columns, C::KPC per
// swizzled chunk; Q and K both K-major in shared memory.
template <int HD>
__device__ __forceinline__ void qk_product(float (&s)[FBN / 2], uint32_t q_base, uint32_t k_base) {
  using C = Fwd<HD>;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int c = kk / C::KPC;
    const uint32_t off = (kk % C::KPC) * 32;  // bytes into the chunk's swizzled rows
    wgmma_ss_n128(s, smem_desc(q_base + c * C::Q_CHUNK + off, 16, 8 * C::SW, C::LAYOUT),
                  smem_desc(k_base + c * C::KV_CHUNK + off, 16, 8 * C::SW, C::LAYOUT), kk > 0);
  }
}

// O += P V: V is (keys, hd) with hd contiguous, the B operand MN-major;
// 8-key groups are 8 rows apart, hd chunks a whole chunk apart.
template <int HD>
__device__ __forceinline__ void pv_product(float (&o)[HD / 2], const uint32_t (&pa)[FBN / 16][4],
                                           uint32_t v_base) {
  using C = Fwd<HD>;
#pragma unroll
  for (int kk = 0; kk < FBN / 16; ++kk)
    wgmma_rs<HD>(o, pa[kk], smem_desc(v_base + kk * 16 * C::SW, C::KV_CHUNK, 8 * C::SW, C::LAYOUT));
}

// Named barriers 1 and 2 pass the turn to issue products between the two
// consumer warpgroups (256 threads: one group syncs, the other arrives).
__device__ __forceinline__ void turn_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void turn_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// Work item L of the persistent grid -> (batch * H + head, first query
// row). Heads go in groups of `group` whose K/V fit in L2 together; inside
// a group the longest (last) query blocks of every head come first.
__device__ __forceinline__ void work_item(int L, int nm, int bh_all, int group, int& bh,
                                          int& m0) {
  const int span = group * nm, g0 = L / span * group;
  const int in_group = min(group, bh_all - g0), idx = L % span;
  bh = g0 + idx % in_group;
  m0 = (nm - 1 - idx / in_group) * FBM;
}

template <int HD, bool LSE>
__global__ void __launch_bounds__(FWD_THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ o,
                 float* __restrict__ lse, int B, int H, int Hkv, int Sq, int Sk, int causal,
                 float scale_log2, int group, int64_t o_sb, int64_t o_sh, int64_t o_ss) {
  using C = Fwd<HD>;
  constexpr int ST = C::STAGES;
  constexpr int NT = FBN / 8;  // 8-key column tiles of S
  constexpr int DT = HD / 8;   // 8-wide column tiles of O
  extern __shared__ uint8_t fwd_smem[];
  uint8_t* Qs = fwd_smem + ((1024 - (smem_addr(fwd_smem) & 1023)) & 1023);
  uint8_t* Ks = Qs + 2 * C::Q_BYTES;    // Q buffer i at Qs + i Q_BYTES; K stage s at Ks + s KV_BYTES
  uint8_t* Vs = Ks + ST * C::KV_BYTES;  // V stage s at Vs + s KV_BYTES
  uint64_t* full_q = reinterpret_cast<uint64_t*>(Vs + ST * C::KV_BYTES);
  uint64_t* empty_q = full_q + 2;
  uint64_t* full_k = empty_q + 2;
  uint64_t* empty_k = full_k + ST;
  uint64_t* full_v = empty_k + ST;
  uint64_t* empty_v = full_v + ST;

  const int nm = (Sq + FBM - 1) / FBM, bh_all = B * H, items = bh_all * nm;
  const int n_rep = H / Hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // Items in zigzag rounds of gridDim.x: block k takes k, 2P - 1 - k,
  // 2P + k, ... (P = gridDim.x), pairing long items with short ones.
  const int P = gridDim.x;
  auto next_item = [&](int L) {
    const int k = (L / P) % 2 == 0 ? (int)blockIdx.x : P - 1 - (int)blockIdx.x;
    return L - k + P + (P - 1 - k);
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(full_q + i, 1);
      mbar_init(empty_q + i, CONSUMER_WARPS);
    }
    for (int s = 0; s < ST; ++s) {
      mbar_init(full_k + s, 1);
      mbar_init(full_v + s, 1);
      mbar_init(empty_k + s, CONSUMER_WARPS);
      mbar_init(empty_v + s, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= CONSUMER_WARPS) {  // ---- producer warpgroup: one thread loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    bool stuck = false;
    if (warp == CONSUMER_WARPS && lane == 0) {
      // Per item: Q, K_0, then K_{it+1} ahead of V_it (the consumers need
      // tile it + 1's K before tile it's V). kt and vt count the tiles
      // loaded into each ring over the whole launch; each ring's first lap
      // finds it free.
      int kt = 0, vt = 0, qi = 0;
      for (int L = blockIdx.x; L < items; L = next_item(L), ++qi) {
        int bh, m0;
        work_item(L, nm, bh_all, group, bh, m0);
        const int b = bh / H, h = bh % H, kvh = h / n_rep;
        const int n_end = causal ? min(Sk, m0 + FBM) : Sk;
        const int n_tiles = (n_end + FBN - 1) / FBN;
        const int qb = qi & 1;  // Q buffer of this item
        mbar_wait(empty_q + qb, ((qi >> 1) & 1) ^ 1, stuck);
        load_rows<HD>(&qmap, Qs + qb * C::Q_BYTES, full_q + qb, m0, h, b);
        for (int it = -1; it < n_tiles; ++it) {
          if (it + 1 < n_tiles) {
            const int sk = kt % ST;
            mbar_wait(empty_k + sk, ((kt / ST) & 1) ^ 1, stuck);
            load_rows<HD>(&kmap, Ks + sk * C::KV_BYTES, full_k + sk, (it + 1) * FBN, kvh, b);
            ++kt;
          }
          if (it >= 0) {
            const int sv = vt % ST;
            mbar_wait(empty_v + sv, ((vt / ST) & 1) ^ 1, stuck);
            load_rows<HD>(&vmap, Vs + sv * C::KV_BYTES, full_v + sv, it * FBN, kvh, b);
            ++vt;
          }
        }
      }
    }
  } else {  // ---- consumer warpgroups: 64 query rows of each item
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    bool stuck = false;
    const int wg = warp >> 2;
    const int g = lane >> 2, t = lane & 3;  // accumulator row group, column pair
    const int r0 = (warp & 3) * 16 + g;     // this thread's rows r0 and r0 + 8 of the group's 64
    const uint32_t q_base0 = smem_addr(Qs) + wg * 64 * C::SW;
    const uint32_t k_base = smem_addr(Ks), v_base = smem_addr(Vs);
    // Ping-pong: the groups take turns to issue their products, so one's
    // run on the tensor cores while the other does its softmax. Group 0
    // goes first; group 0's last sync takes group 1's last turn.
    const int my_turn = 1 + wg, their_turn = 2 - wg;
    if (wg == 1) turn_arrive(1);

    float oacc[HD / 2];
    float mrow[2], lrow[2];
    float s[FBN / 2];          // scores, then probabilities, of one tile
    uint32_t pa[FBN / 16][4];  // the previous tile's P as bf16 A fragments
    float alpha[2];
    int qrow[2], m0w = 0, n0 = 0;

    // Scores of the tile at keys n0 -> probabilities in s, with the online
    // max and sum updated and alpha the factor that rescales O.
    auto softmax = [&]() {
      // partial maxima and sums over 4 interleaved column groups, so no
      // chain of dependent operations is longer than 16
      float mx[2][4], ls[2][4];
#pragma unroll
      for (int rh = 0; rh < 2; ++rh)
#pragma unroll
        for (int c = 0; c < 4; ++c) mx[rh][c] = -INFINITY, ls[rh][c] = 0.f;
      if ((n0 + FBN > Sk) || (causal && n0 + FBN - 1 > m0w)) {
        // columns at or past lim[rh] of this thread's row rh are masked
        int lim[2];
#pragma unroll
        for (int rh = 0; rh < 2; ++rh)
          lim[rh] = (causal ? min(Sk, qrow[rh] + 1) : Sk) - n0 - 2 * t;
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (j * 8 + (e & 1) >= lim[e >> 1]) s[4 * j + e] = -INFINITY;
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          mx[e >> 1][j & 3] = fmaxf(mx[e >> 1][j & 3], s[4 * j + e]);
      float base[2];
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        float m = fmaxf(fmaxf(mx[rh][0], mx[rh][1]), fmaxf(mx[rh][2], mx[rh][3]));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
        const float m_new = fmaxf(mrow[rh], m * scale_log2);  // log2 domain
        base[rh] = (m_new == -INFINITY) ? 0.f : m_new;       // a row with no key yet
        alpha[rh] = exp2f(mrow[rh] - base[rh]);
        mrow[rh] = m_new;
      }
#pragma unroll
      for (int i = 0; i < FBN / 2; ++i) {
        s[i] = ex2_ftz(fmaf(s[i], scale_log2, -base[(i >> 1) & 1]));
        ls[(i >> 1) & 1][(i >> 2) & 3] += s[i];
      }
#pragma unroll
      for (int rh = 0; rh < 2; ++rh)
        lrow[rh] = lrow[rh] * alpha[rh] + ((ls[rh][0] + ls[rh][1]) + (ls[rh][2] + ls[rh][3]));
    };
    // O *= alpha, and P (keys 16 kk .. 16 kk + 15 are S tiles 2 kk, 2 kk + 1)
    // packed into A fragments; only once the last product reading O and P
    // has finished.
    auto rescale_and_pack = [&]() {
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        oacc[4 * d + 0] *= alpha[0];
        oacc[4 * d + 1] *= alpha[0];
        oacc[4 * d + 2] *= alpha[1];
        oacc[4 * d + 3] *= alpha[1];
      }
#pragma unroll
      for (int kk = 0; kk < FBN / 16; ++kk) {
        pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
        pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
    };

    int kt = 0, vt = 0, qi = 0;
    for (int L = blockIdx.x; L < items; L = next_item(L), ++qi) {
      int bh, m0;
      work_item(L, nm, bh_all, group, bh, m0);
      const int b = bh / H, h = bh % H;
      const int n_end = causal ? min(Sk, m0 + FBM) : Sk;
      const int n_tiles = (n_end + FBN - 1) / FBN;
      m0w = m0 + wg * 64;
      qrow[0] = m0w + r0;
      qrow[1] = m0w + r0 + 8;
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) oacc[i] = 0.f;
      mrow[0] = mrow[1] = -INFINITY;
      lrow[0] = lrow[1] = 0.f;

      const int qb = qi & 1;  // Q buffer of this item
      const uint32_t q_base = q_base0 + qb * C::Q_BYTES;
      mbar_wait(full_q + qb, (qi >> 1) & 1, stuck);
      if (n_tiles == 0 && lane == 0) mbar_arrive(empty_q + qb);
      if (n_tiles > 0) {  // tile 0: S alone
        const int sk = kt % ST;
        mbar_wait(full_k + sk, (kt / ST) & 1, stuck);
        __syncwarp();
        turn_sync(my_turn);
        wgmma_fence();
        qk_product<HD>(s, q_base, k_base + sk * C::KV_BYTES);
        wgmma_commit();
        turn_arrive(their_turn);
        wgmma_wait<0>();
        fence_regs(s);
        if (lane == 0) {
          mbar_arrive(empty_k + sk);
          if (n_tiles == 1) mbar_arrive(empty_q + qb);  // the item's last read of Q
        }
        ++kt;
        n0 = 0;
        softmax();
        rescale_and_pack();
      }
      // Tile it: S_it = Q K_it^T and O += P_{it-1} V_{it-1} in flight
      // together; the softmax of S_it runs while the PV product does.
      for (int it = 1; it < n_tiles; ++it) {
        const int sk = kt % ST, sv = vt % ST;
        mbar_wait(full_k + sk, (kt / ST) & 1, stuck);
        mbar_wait(full_v + sv, (vt / ST) & 1, stuck);
        __syncwarp();
        turn_sync(my_turn);
        wgmma_fence();
        qk_product<HD>(s, q_base, k_base + sk * C::KV_BYTES);
        wgmma_commit();
        pv_product<HD>(oacc, pa, v_base + sv * C::KV_BYTES);
        wgmma_commit();
        turn_arrive(their_turn);
        wgmma_wait<1>();  // S_it is done
        fence_regs(s);
        if (lane == 0) {
          mbar_arrive(empty_k + sk);
          if (it == n_tiles - 1) mbar_arrive(empty_q + qb);
        }
        ++kt;
        n0 = it * FBN;
        softmax();
        wgmma_wait<0>();  // P_{it-1} V_{it-1} is done
        fence_regs(oacc);
        fence_regs(pa);
        if (lane == 0) mbar_arrive(empty_v + sv);
        ++vt;
        rescale_and_pack();
      }
      if (n_tiles > 0) {  // the last tile's PV alone
        const int sv = vt % ST;
        mbar_wait(full_v + sv, (vt / ST) & 1, stuck);
        __syncwarp();
        turn_sync(my_turn);
        wgmma_fence();
        pv_product<HD>(oacc, pa, v_base + sv * C::KV_BYTES);
        wgmma_commit();
        turn_arrive(their_turn);
        wgmma_wait<0>();
        fence_regs(oacc);
        if (lane == 0) mbar_arrive(empty_v + sv);
        ++vt;
      }

      float inv[2];
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        float l = lrow[rh];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        inv[rh] = (l == 0.f) ? 1.f : 1.f / l;  // fully masked rows -> 0
        if (stuck) inv[rh] = NAN;               // a wait gave up: poison the rows
        if (LSE && t == 0 && qrow[rh] < Sq)     // m is per row, log2 domain
          lse[(int64_t)bh * Sq + qrow[rh]] =
              (l == 0.f ? mrow[rh] : mrow[rh] + log2f(l)) * LN2 * (stuck ? NAN : 1.f);
      }
      __nv_bfloat16* ob = o + b * o_sb + h * o_sh + 2 * t;
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        if (qrow[rh] < Sq) {
          __nv_bfloat16* orow = ob + (int64_t)qrow[rh] * o_ss;
#pragma unroll
          for (int d = 0; d < DT; ++d)
            *reinterpret_cast<__nv_bfloat162*>(orow + d * 8) = __floats2bfloat162_rn(
                oacc[4 * d + 2 * rh] * inv[rh], oacc[4 * d + 2 * rh + 1] * inv[rh]);
        }
      }
    }
    if (wg == 0) turn_sync(1);
  }
}

// Raise a kernel's dynamic shared memory limit to `bytes`: once per
// process, and so never inside a CUDA graph capture after the first call.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, bool& configured) {
  if (configured) return cudaSuccess;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) configured = true;
  return err;
}

// cuTensorMapEncodeTiled is a driver-API function; it is fetched through the
// runtime, so the library links no libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled tensor_map_encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// The TMA map of a (B, heads, S, hd) bf16 view with element strides
// st = (sb, sh, ss) and a unit last stride: dims (hd, heads, S, B), boxes
// of (CW, 1, 128, 1), swizzled as the products read them; rows past S
// read as zeros.
template <int HD>
cudaError_t make_map(CUtensorMap* map, const void* base, int B, int heads, int S,
                     const int64_t* st) {
  using C = Fwd<HD>;
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)heads, (cuuint64_t)(S > 0 ? S : 1),
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st[1] * 2, (cuuint64_t)st[2] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {(cuuint32_t)C::CW, 1, 128, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
      unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      C::SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Heads per block group: as many as keep their K/V (2 Sk hd bf16 per kv
// head, shared by its n_rep query heads) within ~40 MB of the 50 MB L2
// (measured best at the mistral prefill and olmo_1b training shapes).
int head_group(int BH, int n_rep, int Sk, int hd) {
  const double per_head = 4.0 * (Sk > 0 ? Sk : 1) * hd / n_rep;
  const int g = (int)(40.0 * (1 << 20) / per_head);
  return g < 1 ? 1 : (g > BH ? BH : g);
}

template <int HD, bool LSE>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                   int H, int Hkv, int Sq, int Sk, int causal, float scale_log2,
                   const int64_t* st, cudaStream_t stream) {
  using C = Fwd<HD>;
  static bool configured = false;
  cudaError_t err = allow_smem(flash_fwd_kernel<HD, LSE>, C::SMEM, configured);
  if (err != cudaSuccess) return err;
  CUtensorMap qm, km, vm;
  if ((err = make_map<HD>(&qm, q, B, H, Sq, st)) != cudaSuccess) return err;
  if ((err = make_map<HD>(&km, k, B, Hkv, Sk, st + 3)) != cudaSuccess) return err;
  if ((err = make_map<HD>(&vm, v, B, Hkv, Sk, st + 6)) != cudaSuccess) return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  const int items = B * H * ((Sq + FBM - 1) / FBM);  // persistent: one block per SM at most
  flash_fwd_kernel<HD, LSE><<<items < sms ? items : sms, FWD_THREADS, C::SMEM, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), lse, B, H, Hkv, Sq, Sk, causal, scale_log2,
      head_group(B * H, H / Hkv, Sk, HD), st[9], st[10], st[11]);
  return cudaGetLastError();
}

// ------------------------------ backward -------------------------------------
//
// FlashAttention-2 backward (FA-2 section 3.2), the reference's deterministic
// two-kernel partition, without atomics. P = exp(s * scale - LSE) is
// recomputed tile by tile from the forward's LSE, so no (Sq, Sk) tensor
// exists; D = rowsum(dO * O) comes from outside (one elementwise pass).
//
// Bound on this card: operations. At the training shape (8 x 16 heads x
// 2048 x 128, causal) the dK/dV kernel does four products (S, dP, dV, dK;
// 275 GFLOP) and the dQ kernel three (S, dP, dQ; 206 GFLOP) over ~0.1 GB.
//
// * dK/dV: a block owns 64 keys of one (batch, kv head) and keeps its K and
//   V tiles in shared memory; each of its 4 warps owns 16 keys. It walks
//   the query heads of the GQA group and, for each, the 32-row query tiles
//   at or below the diagonal, Q and dO double-buffered by cp.async. It
//   computes the transposed scores S^T = K Q^T and dP^T = V dO^T, so that
//   P^T and dS^T = P^T * (dP^T - D) sit in the accumulators with the keys
//   as rows and go straight into A fragments for dV += P^T dO and
//   dK += dS^T Q. The group is summed inside the block: no (B, H, Sk, hd)
//   per-query-head buffer as in the reference.
// * dQ: a block owns 64 query rows of one (batch, head), 16 per warp, and
//   walks the 64-key K/V tiles up to the diagonal, double-buffered; S and
//   dP are row-major, dS goes straight into A fragments for dQ += dS K.
// * Accumulators are f32; P and dS are rounded to bf16 for their products,
//   as the forward rounds P. Masked entries are set to 0 by a select, never
//   through exp of an infinity. Causal masking is top-left aligned
//   (key <= query), as in the reference; ragged Sq and Sk are masked in
//   the kernels; all tensors are read and written through strides.

struct Str3 {  // element strides of a (B, heads, S, hd) tensor
  int64_t b, h, s;
};

constexpr int BQ2 = 32;  // query rows per tile of the dK/dV kernel

// A fragments (m16n8k16) of rows row0..row0+15 and k-steps kk and kk + 1 of
// a row-major tile in shared memory.
__device__ __forceinline__ void load_a2(uint32_t (&a0)[4], uint32_t (&a1)[4], const uint16_t* sm,
                                        int lds, int row0, int kk, int lane) {
  const int r = row0 + ((lane >> 3) & 1) * 8 + (lane & 7), c = kk * 16 + (lane >> 4) * 8;
  ldmatrix_x4<false>(a0, sm + r * lds + c);
  ldmatrix_x4<false>(a1, sm + r * lds + c + 16);
}

template <int HD>
__global__ void __launch_bounds__(NWARP * 32)
flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ dd,
                     __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int H,
                     int Hkv, int Sq, int Sk, int causal, float scale, Str3 qs, Str3 ks,
                     Str3 vs, Str3 dos, Str3 dks, Str3 dvs) {
  constexpr int LDS = HD + PAD;
  constexpr int KSTEPS = HD / 16;
  constexpr int NTQ = BQ2 / 8;  // 8-query column tiles of S^T
  constexpr int DT = HD / 8;
  constexpr int QSTAGE = 2 * BQ2 * LDS;
  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* Ks = smem;
  uint16_t* Vs = Ks + BN * LDS;
  uint16_t* qd = Vs + BN * LDS;  // stage s: Q tile at qd + s * QSTAGE, dO after it
  float* rowv = reinterpret_cast<float*>(qd + 2 * QSTAGE);  // stage s: LSE*log2 e, D

  const int n0 = blockIdx.x * BN;
  const int b = blockIdx.y / Hkv, kvh = blockIdx.y % Hkv;
  const int n_rep = H / Hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ld_row = lane & 7, ld_mat = lane >> 3;
  const float scale_log2 = scale * LOG2E;

  load_tile<HD, BN>(Ks, k + b * ks.b + kvh * ks.h, ks.s, n0, Sk - n0);
  load_tile<HD, BN>(Vs, v + b * vs.b + kvh * vs.h, vs.s, n0, Sk - n0);
  // query tiles wholly above the diagonal see no key of this block
  const int m_begin = causal ? (n0 / BQ2) * BQ2 : 0;
  const int nqt = m_begin < Sq ? (Sq - m_begin + BQ2 - 1) / BQ2 : 0;
  const int items = n_rep * nqt;  // (query head, query tile) pairs

  auto load_item = [&](int i, int st) {
    const int h = kvh * n_rep + i / nqt, m0 = m_begin + (i % nqt) * BQ2;
    uint16_t* Qs = qd + st * QSTAGE;
    load_tile<HD, BQ2>(Qs, q + b * qs.b + h * qs.h, qs.s, m0, Sq - m0);
    load_tile<HD, BQ2>(Qs + BQ2 * LDS, dout + b * dos.b + h * dos.h, dos.s, m0, Sq - m0);
    float* rv = rowv + st * 2 * BQ2;
    for (int r = threadIdx.x; r < BQ2; r += NWARP * 32) {
      const bool ok = m0 + r < Sq;
      const int64_t idx = (int64_t)(b * H + h) * Sq + m0 + r;
      rv[r] = ok ? lse[idx] * LOG2E : 0.f;
      rv[BQ2 + r] = ok ? dd[idx] : 0.f;
    }
  };
  if (items > 0) load_item(0, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  float dka[DT][4], dva[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[d][e] = dva[d][e] = 0.f;
  const int key0 = n0 + warp * 16 + g;  // this thread's keys key0 and key0 + 8

  for (int it = 0; it < items; ++it) {
    const int st = it & 1;
    if (it + 1 < items) load_item(it + 1, st ^ 1);
    cp_async_commit();
    const uint16_t* Qs = qd + st * QSTAGE;
    const uint16_t* dOs = Qs + BQ2 * LDS;
    const float* lse2 = rowv + st * 2 * BQ2;
    const float* Dr = lse2 + BQ2;
    const int m0 = m_begin + (it % nqt) * BQ2;

    // S^T = K Q^T and dP^T = V dO^T: rows this warp's 16 keys, columns BQ2 queries
    float s[NTQ][4], dp[NTQ][4];
#pragma unroll
    for (int j = 0; j < NTQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; kk += 2) {
      uint32_t a0[4], a1[4], c0[4], c1[4];
      load_a2(a0, a1, Ks, LDS, warp * 16, kk, lane);
      load_a2(c0, c1, Vs, LDS, warp * 16, kk, lane);
#pragma unroll
      for (int j = 0; j < NTQ; ++j) {
        uint32_t bq[4], bo[4];
        ldmatrix_x4<false>(bq, Qs + (j * 8 + ld_row) * LDS + kk * 16 + ld_mat * 8);
        ldmatrix_x4<false>(bo, dOs + (j * 8 + ld_row) * LDS + kk * 16 + ld_mat * 8);
        mma_bf16(s[j], a0, bq[0], bq[1]);
        mma_bf16(s[j], a1, bq[2], bq[3]);
        mma_bf16(dp[j], c0, bo[0], bo[1]);
        mma_bf16(dp[j], c1, bo[2], bo[3]);
      }
    }
    // P^T and dS^T = P^T * (dP^T - D)
#pragma unroll
    for (int j = 0; j < NTQ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = j * 8 + 2 * t + (e & 1), key = key0 + (e >> 1) * 8;
        const bool ok = m0 + qc < Sq && !(causal && key > m0 + qc);
        const float p = ok ? exp2f(s[j][e] * scale_log2 - lse2[qc]) : 0.f;
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - Dr[qc]);
      }
    }
    // dV += P^T dO, dK += dS^T Q (the k dimension is the query)
#pragma unroll
    for (int kk = 0; kk < BQ2 / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const uint32_t da[4] = {pack_bf16(dp[2 * kk][0], dp[2 * kk][1]),
                              pack_bf16(dp[2 * kk][2], dp[2 * kk][3]),
                              pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
                              pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
      const int r = kk * 16 + (ld_mat & 1) * 8 + ld_row;
#pragma unroll
      for (int d = 0; d < DT; d += 2) {
        uint32_t ob[4], qb[4];
        ldmatrix_x4<true>(ob, dOs + r * LDS + (d + (ld_mat >> 1)) * 8);
        ldmatrix_x4<true>(qb, Qs + r * LDS + (d + (ld_mat >> 1)) * 8);
        mma_bf16(dva[d], pa, ob[0], ob[1]);
        mma_bf16(dva[d + 1], pa, ob[2], ob[3]);
        mma_bf16(dka[d], da, qb[0], qb[1]);
        mma_bf16(dka[d + 1], da, qb[2], qb[3]);
      }
    }
    cp_async_wait<0>();  // the next item has landed
    __syncthreads();     // and every warp is done with this one
  }

#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    const int key = key0 + rh * 8;
    if (key < Sk) {
      __nv_bfloat16* krow = dk + b * dks.b + kvh * dks.h + (int64_t)key * dks.s + 2 * t;
      __nv_bfloat16* vrow = dv + b * dvs.b + kvh * dvs.h + (int64_t)key * dvs.s + 2 * t;
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        *reinterpret_cast<__nv_bfloat162*>(krow + d * 8) =
            __floats2bfloat162_rn(dka[d][2 * rh] * scale, dka[d][2 * rh + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(vrow + d * 8) =
            __floats2bfloat162_rn(dva[d][2 * rh], dva[d][2 * rh + 1]);
      }
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(NWARP * 32)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ dd,
                    __nv_bfloat16* __restrict__ dq, int H, int Hkv, int Sq, int Sk, int causal,
                    float scale, Str3 qs, Str3 ks, Str3 vs, Str3 dos, Str3 dqs) {
  constexpr int LDS = HD + PAD;
  constexpr int KSTEPS = HD / 16;
  constexpr int NT = BN / 8;
  constexpr int DT = HD / 8;
  constexpr int STAGE = 2 * BN * LDS;
  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* Qs = smem;
  uint16_t* dOs = Qs + BM * LDS;
  uint16_t* kv = dOs + BM * LDS;  // stage s: K tile at kv + s * STAGE, V tile after it

  const int m0 = (gridDim.x - 1 - blockIdx.x) * BM;  // heaviest blocks first
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int kvh = h / (H / Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ld_row = lane & 7, ld_mat = lane >> 3;
  const float scale_log2 = scale * LOG2E;

  const __nv_bfloat16* kg = k + b * ks.b + kvh * ks.h;
  const __nv_bfloat16* vg = v + b * vs.b + kvh * vs.h;
  const int n_end = causal ? min(Sk, m0 + BM) : Sk;
  load_tile<HD, BM>(Qs, q + b * qs.b + h * qs.h, qs.s, m0, Sq - m0);
  load_tile<HD, BM>(dOs, dout + b * dos.b + h * dos.h, dos.s, m0, Sq - m0);
  if (n_end > 0) {
    load_tile<HD, BN>(kv, kg, ks.s, 0, Sk);
    load_tile<HD, BN>(kv + BN * LDS, vg, vs.s, 0, Sk);
  }
  cp_async_commit();

  const int r0 = warp * 16 + g;
  const int qrow[2] = {m0 + r0, m0 + r0 + 8};
  float lse2[2], Dr[2];
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    const bool ok = qrow[rh] < Sq;
    const int64_t idx = (int64_t)blockIdx.y * Sq + qrow[rh];
    lse2[rh] = ok ? lse[idx] * LOG2E : 0.f;
    Dr[rh] = ok ? dd[idx] : 0.f;
  }
  float dqa[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d) dqa[d][0] = dqa[d][1] = dqa[d][2] = dqa[d][3] = 0.f;
  cp_async_wait<0>();
  __syncthreads();

  for (int n0 = 0, it = 0; n0 < n_end; n0 += BN, ++it) {
    const uint16_t* Ks = kv + (it & 1) * STAGE;
    const uint16_t* Vs = Ks + BN * LDS;
    if (n0 + BN < n_end) {
      uint16_t* nxt = kv + ((it + 1) & 1) * STAGE;
      load_tile<HD, BN>(nxt, kg, ks.s, n0 + BN, Sk - n0 - BN);
      load_tile<HD, BN>(nxt + BN * LDS, vg, vs.s, n0 + BN, Sk - n0 - BN);
    }
    cp_async_commit();

    // S = Q K^T and dP = dO V^T: rows this warp's 16 queries, columns BN keys
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; kk += 2) {
      uint32_t a0[4], a1[4], c0[4], c1[4];
      load_a2(a0, a1, Qs, LDS, warp * 16, kk, lane);
      load_a2(c0, c1, dOs, LDS, warp * 16, kk, lane);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t kb[4], vb[4];
        ldmatrix_x4<false>(kb, Ks + (j * 8 + ld_row) * LDS + kk * 16 + ld_mat * 8);
        ldmatrix_x4<false>(vb, Vs + (j * 8 + ld_row) * LDS + kk * 16 + ld_mat * 8);
        mma_bf16(s[j], a0, kb[0], kb[1]);
        mma_bf16(s[j], a1, kb[2], kb[3]);
        mma_bf16(dp[j], c0, vb[0], vb[1]);
        mma_bf16(dp[j], c1, vb[2], vb[3]);
      }
    }
    const bool mask = (n0 + BN > Sk) || (causal && n0 + BN - 1 > m0);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = n0 + j * 8 + 2 * t + (e & 1), rh = e >> 1;
        const bool ok = !mask || (key < Sk && !(causal && key > qrow[rh]));
        const float p = ok ? exp2f(s[j][e] * scale_log2 - lse2[rh]) : 0.f;
        dp[j][e] = p * (dp[j][e] - Dr[rh]);
      }
    }
    // dQ += dS K (the k dimension is the key)
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint32_t da[4] = {pack_bf16(dp[2 * kk][0], dp[2 * kk][1]),
                              pack_bf16(dp[2 * kk][2], dp[2 * kk][3]),
                              pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
                              pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
#pragma unroll
      for (int d = 0; d < DT; d += 2) {
        uint32_t kb[4];
        ldmatrix_x4<true>(kb, Ks + (kk * 16 + (ld_mat & 1) * 8 + ld_row) * LDS +
                                  (d + (ld_mat >> 1)) * 8);
        mma_bf16(dqa[d], da, kb[0], kb[1]);
        mma_bf16(dqa[d + 1], da, kb[2], kb[3]);
      }
    }
    cp_async_wait<0>();
    __syncthreads();
  }

  __nv_bfloat16* qb = dq + b * dqs.b + h * dqs.h + 2 * t;
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    if (qrow[rh] < Sq) {
      __nv_bfloat16* row = qb + (int64_t)qrow[rh] * dqs.s;
#pragma unroll
      for (int d = 0; d < DT; ++d)
        *reinterpret_cast<__nv_bfloat162*>(row + d * 8) = __floats2bfloat162_rn(
            dqa[d][2 * rh] * scale, dqa[d][2 * rh + 1] * scale);
    }
  }
}

template <int HD>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* dd, void* dk, void* dv, int B, int H,
                       int Hkv, int Sq, int Sk, int causal, float scale, const int64_t* st,
                       cudaStream_t stream) {
  const size_t smem = (size_t)(2 * BN + 4 * BQ2) * (HD + PAD) * sizeof(uint16_t) +
                      4 * BQ2 * sizeof(float);
  static bool configured = false;
  cudaError_t err = allow_smem(flash_bwd_dkv_kernel<HD>, smem, configured);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sk + BN - 1) / BN, B * Hkv);  // the first keys, the most work, first
  flash_bwd_dkv_kernel<HD><<<grid, NWARP * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout), lse, dd,
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), H, Hkv, Sq, Sk, causal,
      scale, Str3{st[0], st[1], st[2]}, Str3{st[3], st[4], st[5]}, Str3{st[6], st[7], st[8]},
      Str3{st[9], st[10], st[11]}, Str3{st[12], st[13], st[14]}, Str3{st[15], st[16], st[17]});
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* dd, void* dq, int B, int H, int Hkv, int Sq,
                      int Sk, int causal, float scale, const int64_t* st, cudaStream_t stream) {
  const size_t smem = (size_t)(2 * BM + 4 * BN) * (HD + PAD) * sizeof(uint16_t);
  static bool configured = false;
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<HD>, smem, configured);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BM - 1) / BM, B * H);
  flash_bwd_dq_kernel<HD><<<grid, NWARP * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout), lse, dd,
      static_cast<__nv_bfloat16*>(dq), H, Hkv, Sq, Sk, causal, scale,
      Str3{st[0], st[1], st[2]}, Str3{st[3], st[4], st[5]}, Str3{st[6], st[7], st[8]},
      Str3{st[9], st[10], st[11]}, Str3{st[12], st[13], st[14]});
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q: (B, H, Sq, hd), k and v: (B, Hkv, Sk, hd), o: (B, H, Sq, hd), all bf16,
// any strides with a unit last stride. strides: (sb, sh, ss) of q, k, v
// and o in elements. Every row must start on 16 bytes. hd in {32, 64, 128}.
// Returns cudaGetLastError().
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int B, int H,
                        int Hkv, int Sq, int Sk, int hd, int causal, float scale_log2,
                        const int64_t* strides, void* stream) {
  if (H % Hkv != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32: return launch<32, false>(q, k, v, o, nullptr, B, H, Hkv, Sq, Sk, causal, scale_log2, strides, s);
    case 64: return launch<64, false>(q, k, v, o, nullptr, B, H, Hkv, Sq, Sk, causal, scale_log2, strides, s);
    case 128: return launch<128, false>(q, k, v, o, nullptr, B, H, Hkv, Sq, Sk, causal, scale_log2, strides, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// As flash_attention_fwd, and lse: (B, H, Sq) f32, contiguous, the natural
// log-sum-exp of each query row's scaled scores.
int flash_attention_fwd_lse(const void* q, const void* k, const void* v, void* o, float* lse,
                            int B, int H, int Hkv, int Sq, int Sk, int hd, int causal,
                            float scale_log2, const int64_t* strides, void* stream) {
  if (H % Hkv != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32: return launch<32, true>(q, k, v, o, lse, B, H, Hkv, Sq, Sk, causal, scale_log2, strides, s);
    case 64: return launch<64, true>(q, k, v, o, lse, B, H, Hkv, Sq, Sk, causal, scale_log2, strides, s);
    case 128: return launch<128, true>(q, k, v, o, lse, B, H, Hkv, Sq, Sk, causal, scale_log2, strides, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dK and dV. q, dout: (B, H, Sq, hd); k, v, dk, dv: (B, Hkv, Sk, hd), bf16,
// rows on 16 bytes; lse and dd (D = rowsum(dO * O)): (B, H, Sq) f32,
// contiguous. strides: (sb, sh, ss) of q, k, v, dout, dk and dv. dk and dv
// are summed over the query heads of each kv head.
int flash_attention_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                            const float* lse, const float* dd, void* dk, void* dv, int B,
                            int H, int Hkv, int Sq, int Sk, int hd, int causal, float scale,
                            const int64_t* strides, void* stream) {
  if (H % Hkv != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32: return launch_dkv<32>(q, k, v, dout, lse, dd, dk, dv, B, H, Hkv, Sq, Sk, causal, scale, strides, s);
    case 64: return launch_dkv<64>(q, k, v, dout, lse, dd, dk, dv, B, H, Hkv, Sq, Sk, causal, scale, strides, s);
    case 128: return launch_dkv<128>(q, k, v, dout, lse, dd, dk, dv, B, H, Hkv, Sq, Sk, causal, scale, strides, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dQ: (B, H, Sq, hd) bf16; the other arguments as for
// flash_attention_bwd_dkv. strides: (sb, sh, ss) of q, k, v, dout and dq.
int flash_attention_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                           const float* lse, const float* dd, void* dq, int B, int H, int Hkv,
                           int Sq, int Sk, int hd, int causal, float scale,
                           const int64_t* strides, void* stream) {
  if (H % Hkv != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32: return launch_dq<32>(q, k, v, dout, lse, dd, dq, B, H, Hkv, Sq, Sk, causal, scale, strides, s);
    case 64: return launch_dq<64>(q, k, v, dout, lse, dd, dq, B, H, Hkv, Sq, Sk, causal, scale, strides, s);
    case 128: return launch_dq<128>(q, k, v, dout, lse, dd, dq, B, H, Hkv, Sq, Sk, causal, scale, strides, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
