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
// Forward design (one template for hd 32, 64 and 128, with and without LSE;
// hd 16 has kernels of its own, below):
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
//   The serving forward at hd 64 takes three consumer warpgroups (items of
//   192 rows, 512 threads, 160 and 32 registers): see Fwd.
// * One producer thread loads with TMA (cp.async.bulk.tensor) through 4-D
//   tiled tensor maps over the strided (B, heads, S, hd) views, dims
//   (hd, heads, S, B): Q into one of two buffers, then K and V tiles of
//   128 keys into two rings of shared-memory stages, K_{j+1} ahead of V_j.
//   Each load completes on a "full" mbarrier with expect_tx bytes; before
//   reusing a buffer the producer waits on its "empty" mbarrier, which the
//   8 consumer warps arrive on once the product reading it has finished.
//   The ragged S edge is zero-filled by TMA and masked in the scores.
// * Shared memory is swizzled as the products read it: 128-byte swizzle
//   (64-byte at hd 32, 32-byte at hd 16, whose rows are that wide), boxes
//   at most one swizzle span wide, so an hd 128 row is two 64-column
//   chunks, each its own TMA box. hd 128: 2 x 32 KB of Q and two stages of
//   32 KB per ring, 192 KB; hd 64, 32 and 16: four stages per ring, 160,
//   80 and 40 KB.
// * Each consumer warpgroup computes S = Q K^T as wgmma.m64n128k16 with
//   both operands in shared memory (K-major) and O += P V as
//   wgmma.m64n{hd}k16 with P in registers (the f32 accumulator of S packs
//   into bf16 A fragments with no shuffle) and V read MN-major
//   (transposed B). S of tile j and P V of tile j - 1 are in flight
//   together, and the softmax of tile j runs while P V does.
// * Ping-pong: the warpgroups take turns (named barriers, in a ring) to
//   issue their products, so one's run on the tensor cores while another
//   does its softmax. The softmax is online in registers in the log2 domain: a
//   thread holds rows g and g + 8 of its warp's 16, the row max over 4
//   lanes by two shuffles, the scale folded into one FFMA before a single
//   ex2.approx.ftz; masking only on diagonal or ragged tiles.
// * The epilogue divides by l and writes o from registers through its
//   strides (rows past Sq are not written), and LSE = (m2 + log2 l) ln 2
//   with m2 kept in the log2 domain.
// * A pipeline fault (a load never issued, a wrong phase parity) would
//   leave a thread spinning on its mbarrier; after ~2^32 cycles the wait
//   gives up and sets a block-wide flag in shared memory. Every later wait
//   of the block returns at once, the producer issues no further load and
//   waits for the loads it did issue to land, and the block writes NaN
//   rows and exits cleanly, so a fault fails every check without hanging
//   the card or breaking the CUDA context. (A producer that goes on
//   loading once the waits return at once issues loads back to back into
//   stages whose phases have not completed, and the launch fails with
//   "unspecified launch failure", a drain or not: measured with the
//   planted faults of tools/flash_planted_faults.py.)
#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The first 1024-byte aligned address of dynamic shared memory (the
// swizzled tiles' alignment).
__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return p + ((1024 - (smem_addr(p) & 1023)) & 1023);
}

// Swizzled shared-memory geometry of a row of HD bf16 values, shared by
// every kernel here: rows are cut into chunks of one swizzle span (128
// bytes; 64 at hd 32, 32 at hd 16), each chunk its own TMA box and its own
// tile region. At hd 16 a row is one 32-byte chunk and one k-step: the
// 32-byte swizzle (16-byte units XORed with bit 7 of the address) has its
// own descriptor layout and its own TMA mode, and the products whose N is
// hd are m64n16k16.
template <int HD>
struct Geo {
  static constexpr int SW = HD * 2 < 128 ? HD * 2 : 128;  // swizzle span: bytes per chunk row
  static constexpr int CW = SW / 2;                       // columns per chunk (TMA box width)
  static constexpr int NC = HD / CW;                      // chunks per row
  static constexpr int KPC = SW / 32;                     // 16-column k-steps per chunk
  // wgmma descriptor layout: 1 = 128-byte swizzle, 2 = 64-byte, 3 = 32-byte
  static constexpr uint64_t LAYOUT = SW == 128 ? 1 : SW == 64 ? 2 : 3;
  static_assert(SW == 32 || SW == 64 || SW == 128, "hd in {16, 32, 64, 128}");
};

// ------------------------------- forward -------------------------------------

constexpr int FBN = 128;           // keys per K/V tile
constexpr int CONSUMER_WARPS = 8;  // the backward kernels' two consumer warpgroups

// The forward's shape. Consumer warpgroups of 64 query rows take turns to
// issue their products, so one's softmax runs while another's products
// do. Two hide the softmax where the products are the longer part (hd 32,
// 128). At hd 64 the exponentials (one a (head, query, key) pair, 16 a
// clock an SM) take as long as the two products, and two warpgroups leave
// the tensor cores waiting, so the serving forward there (SeamlessM4T's)
// takes three, on items of 192 rows: O is 32 registers a thread at hd 64,
// so setmaxnreg gives each consumer 160 and the producer 32. Its
// softmaxes take turns too, in the same order (the assembler moves a
// turn's arrive, and the wait for P V after it, up into the softmax: 1-3
// % faster than no turns), and alpha is one ex2.approx.ftz. Measured
// (tools/kernel_compare.py --hd 64, H100 80GB HBM3, 700 W; PERF.md
// section 6): ~5 % faster than two warpgroups at SeamlessM4T's shapes;
// its products alone reach 46 % of the tensor cores' peak, so the
// products' pipeline, not the special function unit, sets the pace. The
// forward with LSE at hd 64 (no serving path) keeps two.
template <int HD, bool LSE>
struct Fwd : Geo<HD> {
  using G = Geo<HD>;
  static constexpr bool WG3 = HD == 64 && !LSE;
  static constexpr int WG = WG3 ? 3 : 2;          // consumer warpgroups
  static constexpr int BM = 64 * WG;              // query rows per work item
  static constexpr int THREADS = 128 * (WG + 1);  // and one producer warpgroup
  static constexpr int CONSUMER_WARPS = 4 * WG;
  static constexpr int REGS = WG3 ? 160 : 232;    // a consumer thread's, by setmaxnreg
  static constexpr int PRODUCER_REGS = WG3 ? 32 : 40;
  static constexpr bool SOFTMAX_TURNS = WG3;      // named barriers 1 + WG .. 2 WG
  static constexpr int Q_CHUNK = BM * G::SW;      // bytes of one chunk of Q
  static constexpr int KV_CHUNK = FBN * G::SW;    // bytes of one chunk of a K or V tile
  static constexpr int Q_BYTES = G::NC * Q_CHUNK;  // one of two Q buffers
  static constexpr int KV_BYTES = G::NC * KV_CHUNK;
  static constexpr int STAGES = HD == 128 ? 2 : 4;  // per ring (K, V)
  // tiles (1024-byte aligned): two Q buffers, the K ring, the V ring; then
  // 4 + 4 * STAGES mbarriers and the stuck flag; plus alignment slack
  static constexpr int SMEM =
      1024 + 2 * Q_BYTES + STAGES * 2 * KV_BYTES + 8 * (4 + 4 * STAGES) + 16;
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
// millisecond) the thread gives up and sets the block's `stuck` flag in
// shared memory; every wait of the block then returns at once, the
// producer stops loading and drains, and the epilogues write NaN, so a
// fault fails every check instead of hanging the card. (No __trap: a trap
// block shared by both roles makes ptxas cap the consumers at the
// launch's 168 registers.)
constexpr long long WATCHDOG_CYCLES = 1ll << 32;

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity, volatile int* stuck) {
  const uint32_t a = smem_addr(bar);
  if (*stuck || mbar_try_wait(a, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(a, parity)) {
    if (*stuck) return;
    if (clock64() - t0 > WATCHDOG_CYCLES) {
      *stuck = 1;
      return;
    }
  }
}

// The producer's last wait, whatever the flag says: until the load that
// completes phase `parity` of `bar` has landed, so that no bulk copy into
// shared memory is in flight when the block exits. Bounded by the same
// watchdog, in case a fault left the phase without its arrival.
__device__ __forceinline__ void mbar_drain(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  const long long t0 = clock64();
  while (!mbar_try_wait(a, parity) && clock64() - t0 <= WATCHDOG_CYCLES) {
  }
}

// Drain the last min(count, stages) loads of a ring of `stages` full
// barriers into which `count` loads were issued in order.
__device__ __forceinline__ void drain_ring(uint64_t* full, int stages, int count) {
  for (int n = count > stages ? count - stages : 0; n < count; ++n)
    mbar_drain(full + n % stages, (n / stages) & 1);
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

// Rows [row, row + ROWS) of one head into a tile: one box per chunk (the
// map's box is ROWS rows high), all completing on `bar`.
template <int HD, int ROWS>
__device__ __forceinline__ void load_rows(const CUtensorMap* map, uint8_t* dst, uint64_t* bar,
                                          int row, int head, int batch) {
  using C = Geo<HD>;
  mbar_expect_tx(bar, C::NC * ROWS * C::SW);
#pragma unroll
  for (int c = 0; c < C::NC; ++c)
    tma_load_4d(dst + c * ROWS * C::SW, map, bar, c * C::CW, head, row, batch);
}

// Two tiles of ROWS rows (Q and dO, or K and V) into dst and dst2, both
// completing on `bar`.
template <int HD, int ROWS>
__device__ __forceinline__ void load_pair(const CUtensorMap* map, const CUtensorMap* map2,
                                          uint8_t* dst, uint8_t* dst2, uint64_t* bar, int row,
                                          int head, int batch) {
  using C = Geo<HD>;
  mbar_expect_tx(bar, 2 * C::NC * ROWS * C::SW);
#pragma unroll
  for (int c = 0; c < C::NC; ++c) {
    tma_load_4d(dst + c * ROWS * C::SW, map, bar, c * C::CW, head, row, batch);
    tma_load_4d(dst2 + c * ROWS * C::SW, map2, bar, c * C::CW, head, row, batch);
  }
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

// d (64 x N, f32) (+)= A (64 x 16, shared, K-major) B^T (B: N x 16,
// shared, K-major); scale_d 0 overwrites d.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                                         int scale_d) {
  if constexpr (N == 32) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        WG_R16(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)
        "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : WG_F8(0), WG_F8(8)
        : "l"(da), "l"(db), "r"(scale_d));
  } else if constexpr (N == 64) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        WG_R16(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15) ", "
        WG_R16(16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31)
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : WG_F8(0), WG_F8(8), WG_F8(16), WG_F8(24)
        : "l"(da), "l"(db), "r"(scale_d));
  } else {
    static_assert(N == 128, "wgmma_ss: N in {32, 64, 128}");
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
}

// d (64 x N, f32) += A (64 x 16, bf16 fragments in registers, as
// mma.m16n8k16's A per warp) B (16 x N, shared, MN-major: transposed).
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (N == 16) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %13, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : WG_F8(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else if constexpr (N == 32) {
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
    static_assert(N == 128, "wgmma_rs: N in {16, 32, 64, 128}");
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

// d (64 x N) = A B^T for one warpgroup, A (64 x HD) and B (N x HD) both
// K-major swizzled tiles whose 64-column chunks lie a_chunk and b_chunk
// bytes apart: wgmma k-steps of 16 columns, KPC per chunk.
template <int HD, int N>
__device__ __forceinline__ void kmajor_product(float (&d)[N / 2], uint32_t a, uint32_t a_chunk,
                                               uint32_t b, uint32_t b_chunk) {
  using C = Geo<HD>;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int c = kk / C::KPC;
    const uint32_t off = (kk % C::KPC) * 32;  // bytes into the chunk's swizzled rows
    wgmma_ss<N>(d, smem_desc(a + c * a_chunk + off, 16, 8 * C::SW, C::LAYOUT),
                smem_desc(b + c * b_chunk + off, 16, 8 * C::SW, C::LAYOUT), kk > 0);
  }
}

// d (64 x HD) += A B for one warpgroup: A (64 x K) as bf16 fragments, K / 16
// k-steps; B (K rows x HD) a swizzled tile read MN-major (transposed), its
// 8-row groups 8 rows apart and its 64-column chunks b_chunk bytes apart.
template <int HD, int K>
__device__ __forceinline__ void mn_product(float (&d)[HD / 2], const uint32_t (&a)[K / 16][4],
                                           uint32_t b, uint32_t b_chunk) {
  using C = Geo<HD>;
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
    wgmma_rs<HD>(d, a[kk], smem_desc(b + kk * 16 * C::SW, b_chunk, 8 * C::SW, C::LAYOUT));
}

// S = Q K^T for one forward warpgroup: Q and K both K-major.
template <int HD, bool LSE>
__device__ __forceinline__ void qk_product(float (&s)[FBN / 2], uint32_t q_base, uint32_t k_base) {
  using C = Fwd<HD, LSE>;
  kmajor_product<HD, FBN>(s, q_base, C::Q_CHUNK, k_base, C::KV_CHUNK);
}

// O += P V: V is (keys, hd) with hd contiguous, the B operand MN-major.
template <int HD, bool LSE>
__device__ __forceinline__ void pv_product(float (&o)[HD / 2], const uint32_t (&pa)[FBN / 16][4],
                                           uint32_t v_base) {
  mn_product<HD, FBN>(o, pa, v_base, Fwd<HD, LSE>::KV_CHUNK);
}

// The accumulator of a 64 x N product (f32; columns 16 kk .. 16 kk + 15 are
// its 8-column tiles 2 kk and 2 kk + 1) as bf16 A fragments of the next
// product, with no shuffle.
template <int N>
__device__ __forceinline__ void pack_a(uint32_t (&a)[N / 16][4], const float (&d)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    a[kk][0] = pack_bf16(d[8 * kk + 0], d[8 * kk + 1]);
    a[kk][1] = pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);
    a[kk][2] = pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);
    a[kk][3] = pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);
  }
}

// A named barrier passes a turn from one consumer warpgroup to the next
// (256 threads: one group syncs, the other arrives).
__device__ __forceinline__ void turn_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void turn_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// Work item L of the persistent grid -> (batch * H + head, first query
// row), items of bm rows. Heads go in groups of `group` whose K/V fit in
// L2 together; inside a group the longest (last) query blocks of every
// head come first.
__device__ __forceinline__ void work_item(int L, int nm, int bh_all, int group, int& bh,
                                          int& m0, int bm) {
  const int span = group * nm, g0 = L / span * group;
  const int in_group = min(group, bh_all - g0), idx = L % span;
  bh = g0 + idx % in_group;
  m0 = (nm - 1 - idx / in_group) * bm;
}

template <int HD, bool LSE>
__global__ void __launch_bounds__(Fwd<HD, LSE>::THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ o,
                 float* __restrict__ lse, int B, int H, int Hkv, int Sq, int Sk, int causal,
                 float scale_log2, int group, int64_t o_sb, int64_t o_sh, int64_t o_ss) {
  using C = Fwd<HD, LSE>;
  constexpr int ST = C::STAGES, FBM = C::BM, WG = C::WG;  // FBM: query rows an item
  constexpr int NT = FBN / 8;  // 8-key column tiles of S
  constexpr int DT = HD / 8;   // 8-wide column tiles of O
  extern __shared__ uint8_t fwd_smem[];
  uint8_t* Qs = align_1024(fwd_smem);
  uint8_t* Ks = Qs + 2 * C::Q_BYTES;    // Q buffer i at Qs + i Q_BYTES; K stage s at Ks + s KV_BYTES
  uint8_t* Vs = Ks + ST * C::KV_BYTES;  // V stage s at Vs + s KV_BYTES
  uint64_t* full_q = reinterpret_cast<uint64_t*>(Vs + ST * C::KV_BYTES);
  uint64_t* empty_q = full_q + 2;
  uint64_t* full_k = empty_q + 2;
  uint64_t* empty_k = full_k + ST;
  uint64_t* full_v = empty_k + ST;
  uint64_t* empty_v = full_v + ST;
  volatile int* stuck = reinterpret_cast<volatile int*>(empty_v + ST);  // a wait gave up

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
      mbar_init(empty_q + i, C::CONSUMER_WARPS);
    }
    for (int s = 0; s < ST; ++s) {
      mbar_init(full_k + s, 1);
      mbar_init(full_v + s, 1);
      mbar_init(empty_k + s, C::CONSUMER_WARPS);
      mbar_init(empty_v + s, C::CONSUMER_WARPS);
    }
    *stuck = 0;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= C::CONSUMER_WARPS) {  // ---- producer warpgroup: one thread loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(C::PRODUCER_REGS) : "memory");
    if (warp == C::CONSUMER_WARPS && lane == 0) {
      // Per item: Q, K_0, then K_{it+1} ahead of V_it (the consumers need
      // tile it + 1's K before tile it's V). kt and vt count the tiles
      // loaded into each ring over the whole launch, nq the Q loads; each
      // ring's first lap finds it free. Once a wait has given up, nothing
      // more is loaded, and the loads issued are drained before exit.
      int kt = 0, vt = 0, qi = 0, nq = 0;
      for (int L = blockIdx.x; L < items && !*stuck; L = next_item(L), ++qi) {
        int bh, m0;
        work_item(L, nm, bh_all, group, bh, m0, FBM);
        const int b = bh / H, h = bh % H, kvh = h / n_rep;
        const int n_end = causal ? min(Sk, m0 + FBM) : Sk;
        const int n_tiles = (n_end + FBN - 1) / FBN;
        const int qb = qi & 1;  // Q buffer of this item
        mbar_wait(empty_q + qb, ((qi >> 1) & 1) ^ 1, stuck);
        if (*stuck) break;
        load_rows<HD, FBM>(&qmap, Qs + qb * C::Q_BYTES, full_q + qb, m0, h, b);
        ++nq;
        for (int it = -1; it < n_tiles; ++it) {
          if (it + 1 < n_tiles) {
            const int sk = kt % ST;
            mbar_wait(empty_k + sk, ((kt / ST) & 1) ^ 1, stuck);
            if (*stuck) break;
            load_rows<HD, FBN>(&kmap, Ks + sk * C::KV_BYTES, full_k + sk, (it + 1) * FBN, kvh, b);
            ++kt;
          }
          if (it >= 0) {
            const int sv = vt % ST;
            mbar_wait(empty_v + sv, ((vt / ST) & 1) ^ 1, stuck);
            if (*stuck) break;
            load_rows<HD, FBN>(&vmap, Vs + sv * C::KV_BYTES, full_v + sv, it * FBN, kvh, b);
            ++vt;
          }
        }
      }
      drain_ring(full_q, 2, nq);
      drain_ring(full_k, ST, kt);
      drain_ring(full_v, ST, vt);
    }
  } else {  // ---- consumer warpgroups: 64 query rows of each item
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(C::REGS) : "memory");
    const int wg = warp >> 2;
    const int g = lane >> 2, t = lane & 3;  // accumulator row group, column pair
    const int r0 = (warp & 3) * 16 + g;     // this thread's rows r0 and r0 + 8 of the group's 64
    const uint32_t q_base0 = smem_addr(Qs) + wg * 64 * C::SW;
    const uint32_t k_base = smem_addr(Ks), v_base = smem_addr(Vs);
    // Ping-pong: the groups take turns to issue their products, in a ring,
    // so one's run on the tensor cores while another does its softmax:
    // group wg syncs on barrier 1 + wg and passes the turn on barrier 1 +
    // (wg + 1) % WG. Group 0 goes first (the last group's arrival lets it);
    // group 0's last sync takes the last group's last turn.
    const int my_turn = 1 + wg, their_turn = 1 + (wg + 1) % WG;
    if (wg == WG - 1) turn_arrive(1);
    // With SOFTMAX_TURNS the softmaxes take turns too, in the same order
    // (barriers 1 + WG + wg).
    auto take_exp = [&]() {
      if constexpr (C::SOFTMAX_TURNS) turn_sync(1 + WG + wg);
    };
    auto pass_exp = [&]() {
      if constexpr (C::SOFTMAX_TURNS) turn_arrive(1 + WG + (wg + 1) % WG);
    };
    if (C::SOFTMAX_TURNS && wg == WG - 1) turn_arrive(1 + WG);

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
        alpha[rh] = C::WG3 ? ex2_ftz(mrow[rh] - base[rh]) : exp2f(mrow[rh] - base[rh]);
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
      pack_a<FBN>(pa, s);
    };

    int kt = 0, vt = 0, qi = 0;
    for (int L = blockIdx.x; L < items; L = next_item(L), ++qi) {
      int bh, m0;
      work_item(L, nm, bh_all, group, bh, m0, FBM);
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
        qk_product<HD, LSE>(s, q_base, k_base + sk * C::KV_BYTES);
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
        take_exp();
        softmax();
        pass_exp();
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
        qk_product<HD, LSE>(s, q_base, k_base + sk * C::KV_BYTES);
        wgmma_commit();
        pv_product<HD, LSE>(oacc, pa, v_base + sv * C::KV_BYTES);
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
        take_exp();
        softmax();
        pass_exp();
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
        pv_product<HD, LSE>(oacc, pa, v_base + sv * C::KV_BYTES);
        wgmma_commit();
        turn_arrive(their_turn);
        wgmma_wait<0>();
        fence_regs(oacc);
        if (lane == 0) mbar_arrive(empty_v + sv);
        ++vt;
      }

      float inv[2];
      const bool bad = *stuck != 0;  // a wait of the block gave up: poison the rows
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        float l = lrow[rh];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        inv[rh] = bad ? NAN : (l == 0.f) ? 1.f : 1.f / l;  // fully masked rows -> 0
        if (LSE && t == 0 && qrow[rh] < Sq)                 // m is per row, log2 domain
          lse[(int64_t)bh * Sq + qrow[rh]] =
              (l == 0.f ? mrow[rh] : mrow[rh] + log2f(l)) * LN2 * (bad ? NAN : 1.f);
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
    if (wg == 0) {  // the last group's last turns
      turn_sync(1);
      if (C::SOFTMAX_TURNS) turn_sync(1 + WG);
    }
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
// of (CW, box_heads, rows, 1), swizzled as the products read them; rows
// past S and heads past `heads` read as zeros. A box of several heads lands
// position-major: row p box_heads + j of the tile is head j at position p.
template <int HD>
cudaError_t make_map(CUtensorMap* map, const void* base, int B, int heads, int S,
                     const int64_t* st, int rows, int box_heads = 1) {
  using C = Geo<HD>;
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)heads, (cuuint64_t)(S > 0 ? S : 1),
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st[1] * 2, (cuuint64_t)st[2] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {(cuuint32_t)C::CW, (cuuint32_t)box_heads, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
      unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      C::SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
      : C::SW == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                    : CU_TENSOR_MAP_SWIZZLE_32B,
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
  using C = Fwd<HD, LSE>;
  static bool configured = false;
  cudaError_t err = allow_smem(flash_fwd_kernel<HD, LSE>, C::SMEM, configured);
  if (err != cudaSuccess) return err;
  CUtensorMap qm, km, vm;
  if ((err = make_map<HD>(&qm, q, B, H, Sq, st, C::BM)) != cudaSuccess) return err;
  if ((err = make_map<HD>(&km, k, B, Hkv, Sk, st + 3, FBN)) != cudaSuccess) return err;
  if ((err = make_map<HD>(&vm, v, B, Hkv, Sk, st + 6, FBN)) != cudaSuccess) return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  const int items = B * H * ((Sq + C::BM - 1) / C::BM);  // persistent: one block per SM at most
  flash_fwd_kernel<HD, LSE><<<items < sms ? items : sms, C::THREADS, C::SMEM, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), lse, B, H, Hkv, Sq, Sk, causal, scale_log2,
      head_group(B * H, H / Hkv, Sk, HD), st[9], st[10], st[11]);
  return cudaGetLastError();
}

// ------------------------------ backward -------------------------------------
//
// FlashAttention-2 backward (FA-2 section 3.2), the reference's deterministic
// two-kernel partition, without atomics: every output element is summed by
// one thread in one order, so two calls give the same bits. P = exp(s *
// scale - LSE) is recomputed tile by tile from the forward's LSE, so no
// (Sq, Sk) tensor exists; D = rowsum(dO * O) comes from outside (one
// elementwise pass).
//
// Replaces src/repro/kernels/flash_attention/backward.py,
// flash_attention_bwd: the dK/dV kernel (_fa_bwd_dkv_kernel, the
// pallas_call at backward.py:252) and the dQ kernel (_fa_bwd_dq_kernel,
// backward.py:283).
//
// Bound on this card: operations. At the training shape (8 x 16 heads x
// 2048 x 128, causal) the dK/dV kernel does four products (S, dP, dV, dK;
// 275 GFLOP, 0.278 ms at 989 TFLOP/s) and the dQ kernel three (S, dP, dQ;
// 206 GFLOP, 0.209 ms) over ~0.1 GB. Only warpgroup products (wgmma) fed
// by loads that overlap them approach that rate, so both kernels take the
// forward's shape:
// * 384 threads: two consumer warpgroups and one producer warp, the roles
//   split once (setmaxnreg: 232 registers per consumer thread, 40 per
//   producer thread). One block per work item, the heaviest items first,
//   so the block scheduler balances the causal triangle.
// * The producer loads with TMA through the forward's swizzled 4-D maps
//   into mbarrier rings; the consumers release a stage on its "empty"
//   mbarrier once the last product reading it has finished. Its waits are
//   the forward's watchdog: a wait that gives up stops the loads, drains
//   them, and the block writes NaN.
// * dQ (row 7): an item is 128 query rows of one (batch, head), 64 per
//   warpgroup, with Q and dO resident. The producer streams 64-key tiles
//   of K and V into one ring. For each tile, S = Q K^T and dP = dO V^T are
//   wgmma with both operands K-major in shared memory (m64n64k16);
//   P = ex2(S scale log2 e - LSE log2 e) with the row's LSE and D in
//   registers, dS = P (dP - D), masked by the forward's per-row column
//   limit; dS packs into bf16 A fragments and dQ += dS K is wgmma with K
//   read MN-major. S and dP of tile j are in flight with dQ += dS_{j-1}
//   K_{j-1}, and dS_j is computed while that product runs.
// * dK/dV (row 6): an item is 128 keys of one (batch, kv head), 64 per
//   warpgroup, with K and V resident; the block walks the n_rep query
//   heads of the group and, for each, the 64-query tiles at or below the
//   diagonal, summing the group in registers (no (B, H, Sk, hd) buffer as
//   in the reference). The producer warp streams Q and dO tiles by TMA and
//   copies each tile's LSE log2 e and D into the same ring stage. S^T =
//   K Q^T and dP^T = V dO^T are wgmma with K and V as A (K-major) and Q
//   and dO as B (K-major); P^T and dS^T = P^T (dP^T - D) pack into A
//   fragments, and dV += P^T dO and dK += dS^T Q read the same swizzled Q
//   and dO tiles MN-major, as the forward reads K and V. The f32 dK and dV
//   of 64 keys x hd 128 take 128 registers per thread, S^T and dP^T 64 more,
//   so one warpgroup's tiles run one after another (S/dP, then P/dS, then
//   dV/dK), and the two warpgroups take turns to issue their products
//   (ping-pong), each one's elementwise work under the other's products.
// * Accumulators are f32; P and dS are rounded to bf16 for their products,
//   as the forward rounds P. Masked entries are set to 0 by a select, never
//   through exp of an infinity. Causal masking is top-left aligned
//   (key <= query), as in the reference; rows past Sq or Sk read as zeros
//   through TMA, masked columns give 0, and output rows past the end are
//   not written; all tensors are read and written through strides; any
//   GQA group.

struct Str3 {  // element strides of a (B, heads, S, hd) tensor
  int64_t b, h, s;
};

constexpr int BWD_THREADS = 384;  // warpgroups 0 and 1 consume, warp 8 produces

// Write this thread's rows row0 and row0 + 8 of a 64 x HD f32 accumulator
// as bf16, times `mul`; rows at or past n_rows are not written.
template <int HD>
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, int64_t row_stride,
                                           const float (&acc)[HD / 2], int row0, int n_rows,
                                           int t, float mul) {
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    const int row = row0 + 8 * rh;
    if (row < n_rows) {
      __nv_bfloat16* out = base + (int64_t)row * row_stride + 2 * t;
#pragma unroll
      for (int d = 0; d < HD / 8; ++d)
        *reinterpret_cast<__nv_bfloat162*>(out + d * 8) =
            __floats2bfloat162_rn(acc[4 * d + 2 * rh] * mul, acc[4 * d + 2 * rh + 1] * mul);
    }
  }
}

template <int HD>
struct Dq : Geo<HD> {
  using G = Geo<HD>;
  static constexpr int BM = 128;  // query rows per item: two warpgroups of 64
  static constexpr int BN = 64;   // keys per K/V tile
  static constexpr int ST = 4;    // ring stages (K and V tile pairs)
  static constexpr int Q_CHUNK = BM * G::SW;
  static constexpr int Q_BYTES = G::NC * Q_CHUNK;  // Q, and dO after it
  static constexpr int KV_CHUNK = BN * G::SW;
  static constexpr int KV_BYTES = G::NC * KV_CHUNK;  // K, and V after it
  // Q, dO, the ring; 1 + 2 ST mbarriers and the stuck flag; alignment slack
  static constexpr int SMEM = 1024 + 2 * Q_BYTES + ST * 2 * KV_BYTES + 8 * (1 + 2 * ST) + 16;
};

template <int HD>
__global__ void __launch_bounds__(BWD_THREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const __grid_constant__ CUtensorMap domap, const float* __restrict__ lse,
                    const float* __restrict__ dd, __nv_bfloat16* __restrict__ dq, int B, int H,
                    int Hkv, int Sq, int Sk, int causal, float scale, Str3 dqs) {
  using C = Dq<HD>;
  constexpr int ST = C::ST, BN = C::BN;
  constexpr int NT = BN / 8;  // 8-key column tiles of S
  extern __shared__ uint8_t dq_smem[];
  uint8_t* Qs = align_1024(dq_smem);            // Q, then dO at Qs + Q_BYTES
  uint8_t* KVs = Qs + 2 * C::Q_BYTES;           // stage s: K at KVs + 2 s KV_BYTES, V after it
  uint64_t* full_q = reinterpret_cast<uint64_t*>(KVs + ST * 2 * C::KV_BYTES);
  uint64_t* full = full_q + 1;
  uint64_t* empty = full + ST;
  volatile int* stuck = reinterpret_cast<volatile int*>(empty + ST);

  // the last query blocks, the most keys, first
  const int nm = (Sq + C::BM - 1) / C::BM, bh_all = B * H;
  const int m0 = (nm - 1 - (int)blockIdx.x / bh_all) * C::BM;
  const int bh = blockIdx.x % bh_all, b = bh / H, h = bh % H, kvh = h / (H / Hkv);
  const int n_end = causal ? min(Sk, m0 + C::BM) : Sk;
  const int n_tiles = (n_end + BN - 1) / BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, CONSUMER_WARPS);
    }
    *stuck = 0;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= CONSUMER_WARPS) {  // ---- producer: one thread loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == CONSUMER_WARPS && lane == 0) {
      load_pair<HD, C::BM>(&qmap, &domap, Qs, Qs + C::Q_BYTES, full_q, m0, h, b);
      int j = 0;  // tiles loaded
      for (; j < n_tiles; ++j) {
        const int s = j % ST;
        mbar_wait(empty + s, ((j / ST) & 1) ^ 1, stuck);
        if (*stuck) break;
        uint8_t* kv = KVs + s * 2 * C::KV_BYTES;
        load_pair<HD, BN>(&kmap, &vmap, kv, kv + C::KV_BYTES, full + s, j * BN, kvh, b);
      }
      drain_ring(full_q, 1, 1);
      drain_ring(full, ST, j);
    }
  } else {  // ---- consumer warpgroups: 64 query rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int wg = warp >> 2;
    const int g = lane >> 2, t = lane & 3;  // accumulator row group, column pair
    const int r0 = (warp & 3) * 16 + g;     // this thread's rows r0 and r0 + 8 of the group's 64
    const int m0w = m0 + wg * 64;
    const int qrow[2] = {m0w + r0, m0w + r0 + 8};
    const float scale_log2 = scale * LOG2E;
    float lse2[2], Dr[2];
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {  // rows past Sq: zero Q and dO give dS = 0
      const bool ok = qrow[rh] < Sq;
      const int64_t idx = (int64_t)bh * Sq + qrow[rh];
      lse2[rh] = ok ? lse[idx] * LOG2E : 0.f;
      Dr[rh] = ok ? dd[idx] : 0.f;
    }
    const uint32_t q_base = smem_addr(Qs) + wg * 64 * C::SW;
    const uint32_t do_base = q_base + C::Q_BYTES;
    const uint32_t kv_base = smem_addr(KVs);

    float dqa[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dqa[i] = 0.f;
    float s[BN / 2], dp[BN / 2];  // S and dP of one tile, then P and dS
    uint32_t da[BN / 16][4];      // the previous tile's dS as bf16 A fragments

    // S, dP of the tile at keys n0 -> dS in dp (f32)
    auto grad_scores = [&](int n0) {
      int vis[2] = {BN, BN};  // columns c of row rh with c - 2t >= vis[rh] are masked
      if ((n0 + BN > Sk) || (causal && n0 + BN - 1 > m0w)) {
#pragma unroll
        for (int rh = 0; rh < 2; ++rh)
          vis[rh] = (causal ? min(Sk, qrow[rh] + 1) : Sk) - n0 - 2 * t;
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e, rh = e >> 1;
          const float p = ex2_ftz(fmaf(s[i], scale_log2, -lse2[rh]));
          const float pv = j * 8 + (e & 1) < vis[rh] ? p : 0.f;
          dp[i] = pv * (dp[i] - Dr[rh]);
        }
    };

    mbar_wait(full_q, 0, stuck);
    if (n_tiles > 0) {  // tile 0: S and dP alone
      mbar_wait(full, 0, stuck);
      wgmma_fence();
      kmajor_product<HD, BN>(s, q_base, C::Q_CHUNK, kv_base, C::KV_CHUNK);
      kmajor_product<HD, BN>(dp, do_base, C::Q_CHUNK, kv_base + C::KV_BYTES, C::KV_CHUNK);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      grad_scores(0);
      pack_a<BN>(da, dp);
    }
    // Tile j: S_j and dP_j in flight with dQ += dS_{j-1} K_{j-1}; dS_j is
    // computed while that product runs.
    for (int j = 1; j < n_tiles; ++j) {
      const int st = j % ST, ps = (j - 1) % ST;
      const uint32_t kv = kv_base + st * 2 * C::KV_BYTES;
      mbar_wait(full + st, (j / ST) & 1, stuck);
      wgmma_fence();
      kmajor_product<HD, BN>(s, q_base, C::Q_CHUNK, kv, C::KV_CHUNK);
      kmajor_product<HD, BN>(dp, do_base, C::Q_CHUNK, kv + C::KV_BYTES, C::KV_CHUNK);
      wgmma_commit();
      mn_product<HD, BN>(dqa, da, kv_base + ps * 2 * C::KV_BYTES, C::KV_CHUNK);
      wgmma_commit();
      wgmma_wait<1>();  // S_j and dP_j are done
      fence_regs(s);
      fence_regs(dp);
      grad_scores(j * BN);
      wgmma_wait<0>();  // dS_{j-1} K_{j-1} is done: its stage is free
      fence_regs(dqa);
      fence_regs(da);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + ps);
      pack_a<BN>(da, dp);
    }
    if (n_tiles > 0) {  // the last tile's dS K alone
      const int ls = (n_tiles - 1) % ST;
      wgmma_fence();
      mn_product<HD, BN>(dqa, da, kv_base + ls * 2 * C::KV_BYTES, C::KV_CHUNK);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dqa);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + ls);
    }
    const float mul = *stuck ? NAN : scale;  // a wait of the block gave up: poison the rows
    store_rows<HD>(dq + b * dqs.b + h * dqs.h, dqs.s, dqa, qrow[0], Sq, t, mul);
  }
}

template <int HD>
struct Dkv : Geo<HD> {
  using G = Geo<HD>;
  static constexpr int BK = 128;  // keys per item: two warpgroups of 64
  static constexpr int BQ = 64;   // queries per Q/dO tile
  static constexpr int ST = HD == 128 ? 3 : 4;  // ring stages (Q, dO and row statistics)
  static constexpr int KV_CHUNK = BK * G::SW;
  static constexpr int KV_BYTES = G::NC * KV_CHUNK;  // K, and V after it
  static constexpr int Q_CHUNK = BQ * G::SW;
  static constexpr int Q_BYTES = G::NC * Q_CHUNK;  // a Q tile, and the dO tile after it
  static constexpr int ROWS = 2 * BQ;              // floats: LSE log2 e, then D, of a tile
  // K, V, the ring, the ring's row statistics; 1 + 2 ST mbarriers and the
  // stuck flag; alignment slack
  static constexpr int SMEM =
      1024 + 2 * KV_BYTES + ST * 2 * Q_BYTES + ST * ROWS * 4 + 8 * (1 + 2 * ST) + 16;
};

template <int HD>
__global__ void __launch_bounds__(BWD_THREADS, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap,
                     const __grid_constant__ CUtensorMap domap, const float* __restrict__ lse,
                     const float* __restrict__ dd, __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int B, int H, int Hkv, int Sq, int Sk,
                     int causal, float scale, Str3 dks, Str3 dvs) {
  using C = Dkv<HD>;
  constexpr int ST = C::ST, BQ = C::BQ;
  constexpr int NT = BQ / 8;  // 8-query column tiles of S^T
  extern __shared__ uint8_t dkv_smem[];
  uint8_t* KVs = align_1024(dkv_smem);       // K, then V at KVs + KV_BYTES
  uint8_t* Qs = KVs + 2 * C::KV_BYTES;       // stage s: Q at Qs + 2 s Q_BYTES, dO after it
  float* rows = reinterpret_cast<float*>(Qs + ST * 2 * C::Q_BYTES);  // stage s at s ROWS
  uint64_t* full_kv = reinterpret_cast<uint64_t*>(rows + ST * C::ROWS);
  uint64_t* full = full_kv + 1;
  uint64_t* empty = full + ST;
  volatile int* stuck = reinterpret_cast<volatile int*>(empty + ST);

  // the first keys, the most query tiles, first
  const int bkv_all = B * Hkv;
  const int n0 = ((int)blockIdx.x / bkv_all) * C::BK;
  const int bkv = blockIdx.x % bkv_all, b = bkv / Hkv, kvh = bkv % Hkv;
  const int n_rep = H / Hkv;
  // query tiles wholly above the diagonal see no key of this item
  const int m_begin = causal ? (n0 / BQ) * BQ : 0;
  const int nqt = m_begin < Sq ? (Sq - m_begin + BQ - 1) / BQ : 0;
  const int tiles = n_rep * nqt;  // (query head, query tile) pairs
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(full_kv, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + s, 1 + 32);  // the TMA bytes, and each producer lane's rows
      mbar_init(empty + s, CONSUMER_WARPS);
    }
    *stuck = 0;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= CONSUMER_WARPS) {  // ---- producer: one warp
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == CONSUMER_WARPS) {
      // lane 0 loads the tiles, every lane copies two rows' LSE log2 e and D
      if (lane == 0) load_pair<HD, C::BK>(&kmap, &vmap, KVs, KVs + C::KV_BYTES, full_kv, n0, kvh, b);
      int i = 0;  // tiles loaded
      for (; i < tiles; ++i) {
        const int s = i % ST;
        mbar_wait(empty + s, ((i / ST) & 1) ^ 1, stuck);
        if (__any_sync(0xffffffffu, *stuck)) break;
        const int h = kvh * n_rep + i / nqt, m0 = m_begin + (i % nqt) * BQ;
        if (lane == 0) {
          uint8_t* qd = Qs + s * 2 * C::Q_BYTES;
          load_pair<HD, BQ>(&qmap, &domap, qd, qd + C::Q_BYTES, full + s, m0, h, b);
        }
        float* rv = rows + s * C::ROWS;
        const int64_t base = (int64_t)(b * H + h) * Sq;
#pragma unroll
        for (int r = lane; r < BQ; r += 32) {  // rows past Sq: masked
          const bool ok = m0 + r < Sq;
          rv[r] = ok ? lse[base + m0 + r] * LOG2E : 0.f;
          rv[BQ + r] = ok ? dd[base + m0 + r] : 0.f;
        }
        mbar_arrive(full + s);
      }
      if (lane == 0) {
        drain_ring(full_kv, 1, 1);
        drain_ring(full, ST, i);
      }
    }
  } else {  // ---- consumer warpgroups: 64 keys each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int wg = warp >> 2;
    const int g = lane >> 2, t = lane & 3;  // accumulator row group, column pair
    const int r0 = (warp & 3) * 16 + g;     // this thread's keys r0 and r0 + 8 of the group's 64
    const int n0w = n0 + wg * 64;
    const int key[2] = {n0w + r0, n0w + r0 + 8};
    const float scale_log2 = scale * LOG2E;
    const uint32_t k_base = smem_addr(KVs) + wg * 64 * C::SW;
    const uint32_t v_base = k_base + C::KV_BYTES;
    const uint32_t q_ring = smem_addr(Qs);

    float dka[HD / 2], dva[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dka[i] = dva[i] = 0.f;
    float s[BQ / 2], dp[BQ / 2];     // S^T and dP^T of one tile, then P^T and dS^T
    uint32_t pa[BQ / 16][4], da[BQ / 16][4];

    // Ping-pong: the groups take turns to issue their products (named
    // barriers 1 and 2), so one's run on the tensor cores while the other
    // computes P^T and dS^T. Group 0 goes first; its last sync takes group
    // 1's last turn.
    mbar_wait(full_kv, 0, stuck);
    const int my_turn = 1 + wg, their_turn = 2 - wg;
    if (wg == 1) turn_arrive(1);
    for (int i = 0; i < tiles; ++i) {
      const int st = i % ST;
      const int m0 = m_begin + (i % nqt) * BQ;
      const uint32_t qt = q_ring + st * 2 * C::Q_BYTES, dot = qt + C::Q_BYTES;
      mbar_wait(full + st, (i / ST) & 1, stuck);
      __syncwarp();
      turn_sync(my_turn);
      // S^T = K Q^T and dP^T = V dO^T: rows this group's 64 keys, columns BQ queries
      wgmma_fence();
      kmajor_product<HD, BQ>(s, k_base, C::KV_CHUNK, qt, C::Q_CHUNK);
      kmajor_product<HD, BQ>(dp, v_base, C::KV_CHUNK, dot, C::Q_CHUNK);
      wgmma_commit();
      turn_arrive(their_turn);
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      // P^T and dS^T = P^T (dP^T - D): visible columns c (queries m0 + c)
      // of key row rh are c - 2t in [lo[rh], hi)
      const float* lse2 = rows + st * C::ROWS;
      const float* Dc = lse2 + BQ;
      int lo[2] = {-BQ, -BQ}, hi = BQ;
      if ((m0 + BQ > Sq) || (causal && m0 < n0w + 63)) {
        hi = Sq - m0 - 2 * t;
#pragma unroll
        for (int rh = 0; rh < 2; ++rh) lo[rh] = causal ? key[rh] - m0 - 2 * t : -BQ;
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(lse2 + 8 * j + 2 * t);
        const float2 d2 = *reinterpret_cast<const float2*>(Dc + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int x = 4 * j + e, c = 8 * j + (e & 1);
          const float p = ex2_ftz(fmaf(s[x], scale_log2, -((e & 1) ? l2.y : l2.x)));
          const float pv = c >= lo[e >> 1] && c < hi ? p : 0.f;
          s[x] = pv;
          dp[x] = pv * (dp[x] - ((e & 1) ? d2.y : d2.x));
        }
      }
      pack_a<BQ>(pa, s);
      pack_a<BQ>(da, dp);
      // dV += P^T dO, dK += dS^T Q (the k dimension is the query)
      turn_sync(my_turn);
      wgmma_fence();
      mn_product<HD, BQ>(dva, pa, dot, C::Q_CHUNK);
      mn_product<HD, BQ>(dka, da, qt, C::Q_CHUNK);
      wgmma_commit();
      turn_arrive(their_turn);
      wgmma_wait<0>();
      fence_regs(dva);
      fence_regs(dka);
      fence_regs(pa);
      fence_regs(da);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + st);
    }
    if (wg == 0) turn_sync(1);
    const bool bad = *stuck != 0;  // a wait of the block gave up: poison the rows
    store_rows<HD>(dk + b * dks.b + kvh * dks.h, dks.s, dka, key[0], Sk, t, bad ? NAN : scale);
    store_rows<HD>(dv + b * dvs.b + kvh * dvs.h, dvs.s, dva, key[0], Sk, t, bad ? NAN : 1.f);
  }
}

// ---- dK/dV at hd 16: flash_bwd_dkv_cluster_kernel<16>
//
// The kernel above, instantiated at hd 16, read 0.12171 ms at (4, 8/2,
// 2048, 16) causal, 7 % of its tensor bound (PERF.md section 6, row "3/5-7,
// hd 16"): an item of 128 keys walked its n_rep query heads' tiles one after
// another (the first keys' item 4 x 32 = 128 tiles, the last one's 8, one
// wave of 128 items on 132 SMs), and at hd 16 a tile is little work (S and
// dP one k-step each, ~32 exponentials a thread) behind four mbarrier
// handshakes and two ping-pong turns. The exponentials set the floor: one a
// (head, query, key) pair, 67.1 M at that shape, 0.0172 ms at the special
// function units' 3.9e12 a second. This design shortens and balances the
// chain and trims each tile's work:
// * An item is 64 keys of one (batch, kv head), and its (query head, query
//   tile) list is split across the DKV16_CL = 4 blocks of a thread-block
//   cluster, block r taking tiles r, r + CL, ...: the first keys' item is
//   four chains of 32 tiles. Items go heaviest first (blockIdx order).
//   Clusters of 2 and 8 read 0.078 and 0.069-0.077 ms against 0.063-0.072
//   for 4 (tools/hd16_compare.py, H100 80GB HBM3, 700 W).
// * A block is one warpgroup that also loads: warp 0 issues tile i - 1 + ST's
//   TMA loads (Q, dO) and cp.async copies (LSE, D, arriving on the stage's
//   barrier when they land; laid out for 16-byte reads) into tile i - 1's
//   stage while tile i's first products run. No producer warp, no empty
//   barriers: tile i - 1's dV/dK, a warpgroup product that completes only
//   once every warp has issued it, frees the stage. A block barrier a tile
//   makes a wait that gave up end the loop for every warp at once. 128
//   threads of at most 128 registers, DKV16_MINB = 4 blocks an SM (2 read
//   the same).
// * Only a tile on the diagonal or past Sq is masked: the compares and
//   selects on every tile cost 13-18 % (variant mask-always). Without the
//   exponentials (no-exp) or without dV/dK's products (no-dvdk) the kernel
//   reads only ~7 % faster, and tile i + 1's scores in flight during tile
//   i's elementwise work (two score sets, 202 registers, two blocks an SM)
//   read 0.107 ms: the time is spread over the tile's steps, not one unit.
// * The products' shared-memory descriptors are made once; a stage or a
//   k-step adds to the address field.
// * Each block keeps its f32 dK/dV partial (64 keys x 16, 8 registers a
//   thread for each) in registers; rank r owns a quarter of the item's
//   outputs, every block stores that quarter of its partial into rank r's
//   shared memory (distributed shared memory), and after one cluster
//   barrier rank r sums the four in rank order and writes: two calls give
//   the same bits, and no atomics are used.
// * The rest is the kernel above: the swizzled TMA maps, the watchdog (a
//   block whose wait gave up writes NaN into its partial, so the item's
//   outputs are NaN), top-left causal masking, ragged edges, any GQA group.
constexpr int DKV16_CL = 4;          // blocks a cluster: an item's tiles split four ways
constexpr int DKV16_MINB = 4;        // blocks an SM (__launch_bounds__)
constexpr int DKV16_THREADS = 128;   // one warpgroup

// 4 bytes from global to shared memory by cp.async, zeros where !ok.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}

// An arrival on `bar` once this thread's cp.async copies so far have landed
// (counted among the barrier's expected arrivals).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

template <bool V>
struct Flag {  // a compile-time choice passed to a generic lambda
  static constexpr bool value = V;
};

template <int HD>
struct Dkv16 : Geo<HD> {
  using G = Geo<HD>;
  static_assert(HD == 16, "the cluster dK/dV design is for hd 16");
  static constexpr int BK = 64;  // keys an item
  static constexpr int BQ = 64;  // queries a Q/dO tile
  static constexpr int ST = 4;   // ring stages (Q, dO and row statistics)
  static constexpr int KV_BYTES = BK * G::SW;  // K, and V after it
  static constexpr int Q_BYTES = BQ * G::SW;   // a Q tile, and the dO tile after it
  static constexpr int ROWS = 2 * BQ;          // floats: the LSE, then D, of a tile
  static constexpr int PART = 2 * BK * HD * 4; // the f32 dK and dV partials of the item
  // K, V, the ring, its row statistics, every rank's slice of the partials
  // (the rank's own outputs), 1 + ST mbarriers and the stuck flag
  static constexpr int SMEM =
      1024 + 2 * KV_BYTES + ST * 2 * Q_BYTES + ST * ROWS * 4 + PART + 8 * (1 + ST) + 16;
};

template <int HD>
__global__ void __launch_bounds__(DKV16_THREADS, DKV16_MINB)
flash_bwd_dkv_cluster_kernel(const __grid_constant__ CUtensorMap qmap,
                             const __grid_constant__ CUtensorMap kmap,
                             const __grid_constant__ CUtensorMap vmap,
                             const __grid_constant__ CUtensorMap domap,
                             const float* __restrict__ lse, const float* __restrict__ dd,
                             __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                             int B, int H, int Hkv, int Sq, int Sk, int causal, float scale,
                             Str3 dks, Str3 dvs) {
  using C = Dkv16<HD>;
  constexpr int ST = C::ST, BQ = C::BQ, CL = DKV16_CL;
  constexpr int NT = BQ / 8;  // 8-query column tiles of S^T
  extern __shared__ uint8_t dkv16_smem[];
  uint8_t* KVs = align_1024(dkv16_smem);      // K, then V at KVs + KV_BYTES
  uint8_t* Qs = KVs + 2 * C::KV_BYTES;        // stage s: Q at Qs + 2 s Q_BYTES, dO after it
  float* rows = reinterpret_cast<float*>(Qs + ST * 2 * C::Q_BYTES);  // stage s at s ROWS
  float* inbox = rows + ST * C::ROWS;  // [rank][slice]: the cluster's partials of my slice
  uint64_t* full_kv = reinterpret_cast<uint64_t*>(inbox + C::PART / 4);
  uint64_t* full = full_kv + 1;
  volatile int* stuck = reinterpret_cast<volatile int*>(full + ST);

  // item blockIdx.x / CL: the first keys, the most query tiles, first
  const int rank = (int)blockIdx.x % CL, item = (int)blockIdx.x / CL;
  const int bkv_all = B * Hkv;
  const int n0 = (item / bkv_all) * C::BK;
  const int bkv = item % bkv_all, b = bkv / Hkv, kvh = bkv % Hkv;
  const int n_rep = H / Hkv;
  // query tiles wholly above the diagonal see no key of this item
  const int m_begin = causal ? (n0 / BQ) * BQ : 0;
  const int nqt = m_begin < Sq ? (Sq - m_begin + BQ - 1) / BQ : 0;
  const int all = n_rep * nqt;  // the item's (query head, query tile) pairs
  const int mine = all > rank ? (all - rank + CL - 1) / CL : 0;  // tiles rank + CL x
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // accumulator row group, column pair
  const int r0 = warp * 16 + g;           // this thread's keys r0 and r0 + 8 of the item's 64

  if (threadIdx.x == 0) {
    mbar_init(full_kv, 1);
    for (int s = 0; s < ST; ++s) mbar_init(full + s, 1 + 32);  // the TMA bytes, warp 0's rows
    *stuck = 0;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // this block has started: the cluster barrier's first phase, waited for
  // before the first write into a peer's shared memory
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");

  // Warp 0: this block's tile i into stage i % ST; lane 0 the Q and dO
  // boxes, each lane two rows' LSE and D (zeros past Sq, where the rows are
  // masked), all completing on the stage's barrier. Query c of the tile is
  // stored at (c % 8 / 2) 16 + (c / 8) 2 + c % 2, so that the 16 a thread
  // reads (columns 8 j + 2t, 8 j + 2t + 1) lie together: four 16-byte loads.
  auto col_at = [](int c) { return (c % 8 / 2) * 16 + (c / 8) * 2 + c % 2; };
  int issued = 0;
  auto issue = [&](int i) {
    const int s = i % ST, x = rank + i * CL;
    const int h = kvh * n_rep + x / nqt, m0 = m_begin + (x % nqt) * BQ;
    if (lane == 0) {
      uint8_t* qd = Qs + s * 2 * C::Q_BYTES;
      load_pair<HD, BQ>(&qmap, &domap, qd, qd + C::Q_BYTES, full + s, m0, h, b);
    }
    float* rv = rows + s * C::ROWS;
    const int64_t base = (int64_t)(b * H + h) * Sq;
#pragma unroll
    for (int r = lane; r < BQ; r += 32) {
      const bool ok = m0 + r < Sq;
      cp_async4(rv + col_at(r), lse + (ok ? base + m0 + r : 0), ok);
      cp_async4(rv + BQ + col_at(r), dd + (ok ? base + m0 + r : 0), ok);
    }
    cp_async_arrive(full + s);
    ++issued;
  };
  if (warp == 0) {
    if (lane == 0) load_pair<HD, C::BK>(&kmap, &vmap, KVs, KVs + C::KV_BYTES, full_kv, n0, kvh, b);
    for (int i = 0; i < ST && i < mine; ++i) issue(i);
  }

  float dka[HD / 2], dva[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dka[i] = dva[i] = 0.f;
  const int key[2] = {n0 + r0, n0 + r0 + 8};
  const float scale_log2 = scale * LOG2E;
  const uint32_t k_base = smem_addr(KVs), v_base = k_base + C::KV_BYTES;
  float sa[BQ / 2], pd[BQ / 2];             // S^T and dP^T of a tile, then P^T and dS^T
  uint32_t pf[BQ / 16][4], df[BQ / 16][4];  // P^T and dS^T as A fragments
  // The products' shared-memory descriptors (kmajor_product's and
  // mn_product's at hd 16: one k-step, the 32-byte swizzle), made once: a
  // stage or a k-step moves only the address field (bytes / 16, no carry
  // within shared memory's 228 KB), one 64-bit add a product.
  const uint64_t k_desc = smem_desc(k_base, 16, 8 * C::SW, C::LAYOUT);
  const uint64_t v_desc = smem_desc(v_base, 16, 8 * C::SW, C::LAYOUT);
  const uint64_t q_kmaj = smem_desc(smem_addr(Qs), 16, 8 * C::SW, C::LAYOUT);
  const uint64_t q_mnmaj = smem_desc(smem_addr(Qs), C::Q_BYTES, 8 * C::SW, C::LAYOUT);

  mbar_wait(full_kv, 0, stuck);  // the item's K and V
  for (int i = 0; i < mine; ++i) {
    const int st = i % ST;
    const uint64_t off = st * 2 * C::Q_BYTES >> 4, do_off = C::Q_BYTES >> 4;
    mbar_wait(full + i % ST, (i / ST) & 1, stuck);
    // S^T = K Q^T and dP^T = V dO^T: rows the item's 64 keys, columns BQ queries
    wgmma_fence();
    wgmma_ss<BQ>(sa, k_desc, q_kmaj + off, 0);
    wgmma_ss<BQ>(pd, v_desc, q_kmaj + off + do_off, 0);
    wgmma_commit();
    // while the products run, warp 0 refills tile i - 1's stage: its dV/dK,
    // a warpgroup product that could complete only once every warp had
    // issued it (after reading the stage's rows), is done
    if (warp == 0 && i >= 1 && i - 1 + ST < mine) issue(i - 1 + ST);
    wgmma_wait<0>();
    fence_regs(sa);
    fence_regs(pd);
    // P^T and dS^T = P^T (dP^T - D). Only a tile on the diagonal or past Sq
    // is masked: visible columns c (queries m0 + c) of key row rh are c - 2t
    // in [lo[rh], hi). The mask's compares and selects on every tile cost
    // 18 % of the time (tools/hd16_compare.py, variant no-mask).
    {
      const int m0 = m_begin + ((rank + i * CL) % nqt) * BQ;
      const float* l2s = rows + st * C::ROWS;  // the LSE, natural log
      const float* dcol = l2s + BQ;
      auto probs = [&](auto masked) {
        int lo[2] = {-BQ, -BQ}, hi = BQ;
        if constexpr (decltype(masked)::value) {
          hi = Sq - m0 - 2 * t;
#pragma unroll
          for (int rh = 0; rh < 2; ++rh) lo[rh] = causal ? key[rh] - m0 - 2 * t : -BQ;
        }
        float lsev[2 * NT], dv2[2 * NT];  // columns 8 j + 2t (+ 1), j = 0 .. NT - 1
#pragma unroll
        for (int v = 0; v < 2 * NT / 4; ++v) {
          const float4 a = reinterpret_cast<const float4*>(l2s + 16 * t)[v];
          const float4 d = reinterpret_cast<const float4*>(dcol + 16 * t)[v];
          lsev[4 * v] = a.x, lsev[4 * v + 1] = a.y, lsev[4 * v + 2] = a.z, lsev[4 * v + 3] = a.w;
          dv2[4 * v] = d.x, dv2[4 * v + 1] = d.y, dv2[4 * v + 2] = d.z, dv2[4 * v + 3] = d.w;
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int x = 4 * j + e, c = 8 * j + (e & 1);
            float pm = ex2_ftz(fmaf(sa[x], scale_log2, -lsev[2 * j + (e & 1)] * LOG2E));
            if constexpr (decltype(masked)::value) pm = c >= lo[e >> 1] && c < hi ? pm : 0.f;
            sa[x] = pm;
            pd[x] = pm * (pd[x] - dv2[2 * j + (e & 1)]);
          }
        }
      };
      if ((m0 + BQ > Sq) || (causal && m0 < n0 + C::BK - 1))
        probs(Flag<true>{});
      else
        probs(Flag<false>{});
    }
    pack_a<BQ>(pf, sa);
    pack_a<BQ>(df, pd);
    // dV += P^T dO, dK += dS^T Q (the k dimension is the query)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {  // 16 queries a k-step: 16 rows of 32 bytes
      wgmma_rs<HD>(dva, pf[kk], q_mnmaj + off + do_off + kk * (16 * C::SW >> 4));
      wgmma_rs<HD>(dka, df[kk], q_mnmaj + off + kk * (16 * C::SW >> 4));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dva);
    fence_regs(dka);
    fence_regs(pf);
    fence_regs(df);
    if (__syncthreads_or(*stuck)) break;  // a wait of the block gave up: every warp stops
  }
  if (warp == 0 && lane == 0) {  // nothing in flight into the ring from here on
    drain_ring(full_kv, 1, 1);
    drain_ring(full, ST, issued);
  }

  // Rank r owns slice r of the item's [dK | dV][key][column] outputs: every
  // block stores its f32 partial of slice r into rank r's inbox (distributed
  // shared memory), once every block of the cluster has started; after the
  // cluster barrier each rank sums its inbox in rank order and writes. NaN
  // where a wait gave up.
  constexpr int N = 2 * C::BK * HD, PER = N / CL;
  static_assert(N % (CL * 2) == 0, "slices of whole column pairs");
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const float bad = *stuck ? NAN : 1.f;
#pragma unroll
  for (int which = 0; which < 2; ++which)
#pragma unroll
    for (int rh = 0; rh < 2; ++rh)
#pragma unroll
      for (int d = 0; d < HD / 8; ++d) {
        const int idx = which * C::BK * HD + (r0 + 8 * rh) * HD + d * 8 + 2 * t;
        const float* acc = which == 0 ? dka : dva;
        float* dst = cluster.map_shared_rank(inbox + rank * PER + idx % PER, idx / PER);
        *reinterpret_cast<float2*>(dst) =
            make_float2(acc[4 * d + 2 * rh] * bad, acc[4 * d + 2 * rh + 1] * bad);
      }
  cluster.sync();  // every partial is in its owner's inbox
#pragma unroll
  for (int x = 0; x < (PER + DKV16_THREADS - 1) / DKV16_THREADS; ++x) {
    const int j = x * DKV16_THREADS + threadIdx.x;
    if (j < PER) {
      float sum = 0.f;
#pragma unroll
      for (int s = 0; s < CL; ++s) sum += inbox[s * PER + j];
      const int idx = rank * PER + j;
      const int which = idx / (C::BK * HD), row = idx / HD % C::BK, col = idx % HD;
      if (n0 + row < Sk) {
        if (which == 0)
          dk[b * dks.b + kvh * dks.h + (int64_t)(n0 + row) * dks.s + col] =
              __float2bfloat16(sum * scale);
        else
          dv[b * dvs.b + kvh * dvs.h + (int64_t)(n0 + row) * dvs.s + col] =
              __float2bfloat16(sum);
      }
    }
  }
}

// ---- the forward and dQ at hd 16: flash_fwd_group_kernel<16, LSE> and
// flash_bwd_dq_group_kernel<16>
//
// The kernels above, instantiated at hd 16, read 0.04921 ms (the forward),
// 0.04947 (with the LSE) and 0.05184 (dQ) at (4, 8/2, 2048, 16) causal
// (PERF.md section 6, rows "3/5, hd 16" and "7, hd 16"), 33-35 % of the bound the
// softmax's exponentials set (one a (head, query, key) pair, 67.1 M at that
// shape, 0.0172 ms at the special function units' 3.9e12 a second). At hd
// 16 the products are small (S one k-step; P V and dS K one m64n16k16 step
// a 16 keys), so the exponentials and their row bookkeeping are the work,
// and their latency was left bare: the forward ran one block an SM of two
// consumer warpgroups taking turns (8 warps, two a scheduler), dQ one block
// of 128 rows an item, one chain of products and exponentials a tile. Both
// designs here:
// * Pack the query heads of one GQA group into an item's 64 rows: row
//   p hpi + j is head j of the group at position p0 + p, with hpi =
//   min(n_rep, 64) heads and 64 / hpi positions an item (a group of more
//   than 64 heads in chunks of 64; rows hpi (64 / hpi) .. 63 are zeros and
//   are not written). One TMA box over (hd, hpi heads, positions) loads Q
//   (and dO) so; each K/V tile is loaded once for the group's heads, and an
//   item's causal key range is its few positions'.
// * A block is one warpgroup of at most 128 registers a thread, four blocks
//   an SM (16 warps); no producer warp and no ping-pong. The grid is
//   persistent, a whole number of blocks an SM, all resident: block b takes
//   item b, then items in zigzag rounds (2P - 1 - b, 2P + b, ...), so one
//   that took a heavy item (the last positions, the most key tiles) takes a
//   light one next, and every block, so every SM, has about the same work.
//   (One block an item in one wave left the busiest SM a quarter more
//   tiles than the mean: tools/hd16_compare.py, variant fwd-trace.) The grid
//   depends on the shapes and the card only.
// * Thread 0 loads the block's stream of tiles, item after item, each
//   item's Q (and dO) into the buffer of its place in the stream before its
//   first K/V tile, and refills tile f - 1's stage with tile f - 1 + ST
//   while tile f's first products run: a block barrier a tile follows tile
//   f - 1's last product in every warp, and makes a wait that gave up end
//   the block's work for every warp at once (its items' rows are NaN).
//   A tile's products and elementwise work run one after another in the
//   warpgroup; the SM's other blocks fill the gaps.
// * Only a tile on the causal diagonal or past Sk is masked; every
//   exponential is one ex2.approx on the special function unit; the
//   shared-memory descriptors are made once (a stage, a buffer or a k-step
//   adds to the address).
// * The forward: K/V tiles of 128 keys; S = Q K^T (m64n128k16, both operands
//   in shared memory), the online softmax in registers in the log2 domain,
//   O rescaled, P rounded to bf16 A fragments, O += P V (V read MN-major);
//   the epilogue as the kernel above (O / l in bf16, the natural-log LSE,
//   rows past Sq not written, NaN where a wait gave up).
// * dQ: K/V tiles of 64 keys; S = Q K^T and dP = dO V^T, P = exp2(S scale
//   log2 e - LSE log2 e) with each row's LSE and D in registers, dS = P
//   (dP - D) rounded to bf16, dQ += dS K (K read MN-major); each item's f32
//   dQ lives in registers and is written once, scaled: no atomics, and two
//   calls give the same bits. (Splitting an item's key tiles over a
//   cluster, the partials summed through distributed shared memory, read
//   slower: each block's loads and merge cost more than the shorter chain
//   saved.)
// * Measured and left out (tools/hd16_compare.py, H100 80GB HBM3, 700 W):
//   one block an item in one wave (the busiest SM a quarter over the mean);
//   64-key forward tiles (slower by ~5 %); the next tile's S issued before
//   this tile's softmax into a second score buffer, or right after P is
//   packed (both slower: the issuing warp waits on the in-flight P V). What
//   bounds both kernels is stated in PERF.md section 6: the
//   exponentials keep the special function units ~55 % busy, the products,
//   waits and barrier of each tile leave the rest idle.
constexpr int HD16_THREADS = 128;  // one warpgroup a block
constexpr int GROUP_ROWS = 64;     // rows of an item: (position, head) pairs
constexpr int FWD16_MINB = 4;      // forward blocks an SM (__launch_bounds__)
constexpr int DQ16_MINB = 4;       // dQ blocks an SM (__launch_bounds__)
constexpr int HD16_ROUNDS = 2;     // items a block takes, where there are enough

// The rows of an item: hpi heads of a GQA group (a chunk of the group when
// it has more than GROUP_ROWS heads) at pos positions.
struct GroupRows {
  int hpi, pos, chunks;
  __host__ __device__ explicit GroupRows(int n_rep)
      : hpi(n_rep < GROUP_ROWS ? n_rep : GROUP_ROWS),
        pos(GROUP_ROWS / hpi),
        chunks((n_rep + hpi - 1) / hpi) {}
};

// Item `item` of the B Hkv chunks ceil(Sq / pos) items, the last positions
// first: its batch, kv head, chunk, first query head and first position.
struct GroupItem {
  int b, kvh, chunk, head0, p0;
};

__device__ __forceinline__ GroupItem group_item(int item, const GroupRows& gr, int B, int Hkv,
                                                int n_rep, int Sq) {
  const int groups = B * Hkv * gr.chunks, npb = (Sq + gr.pos - 1) / gr.pos;
  const int grp = item % groups;
  GroupItem it;
  it.b = grp / (Hkv * gr.chunks);
  it.kvh = grp / gr.chunks % Hkv;
  it.chunk = grp % gr.chunks;
  it.head0 = it.kvh * n_rep + it.chunk * gr.hpi;
  it.p0 = (npb - 1 - item / groups) * gr.pos;
  return it;
}

// Row r of an item: its query head and position; whether it is an output
// row (inside the chunk's heads of the group, before Sq, not a tail row).
__device__ __forceinline__ bool group_row(int r, const GroupRows& gr, const GroupItem& it,
                                          int n_rep, int Sq, int& head, int& qpos) {
  const int j = r % gr.hpi;
  head = it.head0 + j;
  qpos = it.p0 + r / gr.hpi;
  return r < gr.hpi * gr.pos && it.chunk * gr.hpi + j < n_rep && qpos < Sq;
}

// An item's key tiles of `bn` keys: up to its last position's (causal).
__device__ __forceinline__ int group_tiles(const GroupItem& it, const GroupRows& gr, int Sk,
                                           int causal, int bn) {
  const int n_end = causal ? min(Sk, it.p0 + gr.pos) : Sk;
  return (n_end + bn - 1) / bn;
}

// The item after `item` in this block's share of a persistent grid: zigzag
// rounds of gridDim.x items, block b taking b, 2P - 1 - b, 2P + b, ...
__device__ __forceinline__ int next_group_item(int item) {
  const int P = gridDim.x;
  const int k = (item / P) % 2 == 0 ? (int)blockIdx.x : P - 1 - (int)blockIdx.x;
  return item - k + P + (P - 1 - k);
}

// Zero the rows a 64-row tile's box leaves unwritten (rows `rows` .. 63,
// where the group's heads do not divide 64), before a product reads them:
// generic stores, made visible to the tensor cores' (async) proxy. Every
// thread of the block calls it before the block barrier.
__device__ __forceinline__ void zero_tail(uint8_t* tile, int rows, int sw) {
  for (int i = rows * sw / 16 + (int)threadIdx.x; i < GROUP_ROWS * sw / 16; i += blockDim.x)
    reinterpret_cast<uint4*>(tile)[i] = make_uint4(0u, 0u, 0u, 0u);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <int HD>
struct Fwd16 : Geo<HD> {
  using G = Geo<HD>;
  static_assert(HD == 16, "the grouped forward is for hd 16");
  static constexpr int BN = 128;                      // keys a K/V tile
  static constexpr int ST = 4;                        // ring stages, and Q buffers
  static constexpr int Q_BYTES = GROUP_ROWS * G::SW;  // an item's Q rows
  static constexpr int TILE = BN * G::SW;             // a K or a V tile
  static constexpr int STAGE = 2 * TILE;              // K, and V after it
  // the Q buffers, the ring; 2 ST mbarriers and the stuck flag; alignment slack
  static constexpr int SMEM = 1024 + ST * Q_BYTES + ST * STAGE + 8 * 2 * ST + 16;
};

template <int HD, bool LSE>
__global__ void __launch_bounds__(HD16_THREADS, FWD16_MINB)
flash_fwd_group_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ o,
                       float* __restrict__ lse, int B, int H, int Hkv, int Sq, int Sk,
                       int causal, float scale_log2, int64_t o_sb, int64_t o_sh, int64_t o_ss) {
  using C = Fwd16<HD>;
  constexpr int ST = C::ST, BN = C::BN;
  constexpr int NT = BN / 8;  // 8-key column tiles of S
  extern __shared__ uint8_t fwd16_smem[];
  uint8_t* Qs = align_1024(fwd16_smem);  // the n-th item's Q in buffer n % ST
  uint8_t* ring = Qs + ST * C::Q_BYTES;  // stage s: K at ring + s STAGE, V after it
  uint64_t* full_q = reinterpret_cast<uint64_t*>(ring + ST * C::STAGE);
  uint64_t* full = full_q + ST;
  volatile int* stuck = reinterpret_cast<volatile int*>(full + ST);

  const int n_rep = H / Hkv;
  const GroupRows gr(n_rep);
  const int rows = gr.hpi * gr.pos;
  const int items = B * Hkv * gr.chunks * ((Sq + gr.pos - 1) / gr.pos);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // accumulator row group, column pair

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full_q + s, 1);
      mbar_init(full + s, 1);
    }
    *stuck = 0;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (rows < GROUP_ROWS)
    for (int s = 0; s < ST; ++s) zero_tail(Qs + s * C::Q_BYTES, rows, C::SW);
  __syncthreads();

  // Thread 0 loads the block's stream: item after item, the item's Q (into
  // buffer n % ST for the block's n-th item) before its first K/V tile, the
  // stream's tile f into stage f % ST. With Sk > 0 every item has a tile.
  int ld_item = blockIdx.x, ld_nth = 0, ld_tile = 0, ld_tiles = 0, issued = 0, q_issued = 0;
  GroupItem ld;
  auto load_next = [&]() {
    if (ld_item >= items) return;
    if (ld_tile == 0) {
      ld = group_item(ld_item, gr, B, Hkv, n_rep, Sq);
      ld_tiles = group_tiles(ld, gr, Sk, causal, BN);
      const int qb = ld_nth % ST;
      mbar_expect_tx(full_q + qb, rows * C::SW);
      tma_load_4d(Qs + qb * C::Q_BYTES, &qmap, full_q + qb, 0, ld.head0, ld.p0, ld.b);
      ++q_issued;
    }
    uint8_t* kv = ring + (issued % ST) * C::STAGE;
    load_pair<HD, BN>(&kmap, &vmap, kv, kv + C::TILE, full + issued % ST, ld_tile * BN, ld.kvh,
                      ld.b);
    ++issued;
    if (++ld_tile == ld_tiles) {
      ld_tile = 0;
      ld_item = next_group_item(ld_item);
      ++ld_nth;
    }
  };
  if (threadIdx.x == 0 && Sk > 0)
    while (issued < ST && ld_item < items) load_next();

  float oacc[HD / 2];
  float mrow[2], lrow[2];   // log2-domain row max, row sum
  float s[BN / 2];          // scores of a tile, then probabilities
  uint32_t pa[BN / 16][4];  // P as bf16 A fragments
  int head[2], qpos[2];     // this thread's rows warp 16 + g (+ 8) of the item
  const uint64_t q_desc0 = smem_desc(smem_addr(Qs), 16, 8 * C::SW, C::LAYOUT);
  const uint64_t k_desc = smem_desc(smem_addr(ring), 16, 8 * C::SW, C::LAYOUT);
  const uint64_t v_desc = smem_desc(smem_addr(ring + C::TILE), C::TILE, 8 * C::SW, C::LAYOUT);

  // The scores of the tile at keys n0 -> probabilities in s; the online max
  // and sum updated and O rescaled. Masked: column c of row rh is a key
  // the row sees if c - 2t < its limit.
  auto online_softmax = [&](int n0, auto masked) {
    float mx[2][4], ls[2][4];  // 4 interleaved partial chains a row
#pragma unroll
    for (int rh = 0; rh < 2; ++rh)
#pragma unroll
      for (int c = 0; c < 4; ++c) mx[rh][c] = -INFINITY, ls[rh][c] = 0.f;
    if constexpr (decltype(masked)::value) {
      int sees[2];
#pragma unroll
      for (int rh = 0; rh < 2; ++rh)
        sees[rh] = (causal ? min(Sk, qpos[rh] + 1) : Sk) - n0 - 2 * t;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (j * 8 + (e & 1) >= sees[e >> 1]) s[4 * j + e] = -INFINITY;
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1][j & 3] = fmaxf(mx[e >> 1][j & 3], s[4 * j + e]);
    float base[2], alpha[2];
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      float m = fmaxf(fmaxf(mx[rh][0], mx[rh][1]), fmaxf(mx[rh][2], mx[rh][3]));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      const float m_new = fmaxf(mrow[rh], m * scale_log2);
      base[rh] = m_new == -INFINITY ? 0.f : m_new;  // a row with no key yet
      alpha[rh] = ex2_ftz(mrow[rh] - base[rh]);
      mrow[rh] = m_new;
    }
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      s[i] = ex2_ftz(fmaf(s[i], scale_log2, -base[(i >> 1) & 1]));
      ls[(i >> 1) & 1][(i >> 2) & 3] += s[i];
    }
#pragma unroll
    for (int rh = 0; rh < 2; ++rh)
      lrow[rh] = lrow[rh] * alpha[rh] + ((ls[rh][0] + ls[rh][1]) + (ls[rh][2] + ls[rh][3]));
#pragma unroll
    for (int d = 0; d < HD / 8; ++d) {
      oacc[4 * d + 0] *= alpha[0];
      oacc[4 * d + 1] *= alpha[0];
      oacc[4 * d + 2] *= alpha[1];
      oacc[4 * d + 3] *= alpha[1];
    }
  };

  bool bad = false;  // a wait of the block gave up (the same in every thread)
  int f = 0;         // tiles of the block's stream taken
  for (int item = blockIdx.x, nth = 0; item < items; item = next_group_item(item), ++nth) {
    const GroupItem it = group_item(item, gr, B, Hkv, n_rep, Sq);
    const int n_tiles = Sk > 0 ? group_tiles(it, gr, Sk, causal, BN) : 0;
    bool out_row[2];
#pragma unroll
    for (int rh = 0; rh < 2; ++rh)
      out_row[rh] = group_row(warp * 16 + g + 8 * rh, gr, it, n_rep, Sq, head[rh], qpos[rh]);
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) oacc[i] = 0.f;
    mrow[0] = mrow[1] = -INFINITY;
    lrow[0] = lrow[1] = 0.f;
    const uint64_t q_desc = q_desc0 + (uint64_t)((nth % ST) * C::Q_BYTES >> 4);
    if (!bad && n_tiles > 0) mbar_wait(full_q + nth % ST, (uint32_t)(nth / ST) & 1u, stuck);
    for (int j = 0; j < n_tiles && !bad; ++j, ++f) {
      const int st = f % ST;
      const uint64_t off = (uint64_t)(st * C::STAGE) >> 4;
      mbar_wait(full + st, (uint32_t)(f / ST) & 1u, stuck);
      wgmma_fence();
      wgmma_ss<BN>(s, q_desc, k_desc + off, 0);
      wgmma_commit();
      // tile f - 1's stage is free: its P V ended in every warp before the
      // barrier that closed tile f - 1
      if (threadIdx.x == 0 && f >= 1) load_next();
      wgmma_wait<0>();
      fence_regs(s);
      const int n0 = j * BN;
      if ((n0 + BN > Sk) || (causal && n0 + BN - 1 > it.p0))
        online_softmax(n0, Flag<true>{});
      else
        online_softmax(n0, Flag<false>{});
      pack_a<BN>(pa, s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)  // 16 keys a k-step: 16 rows of 32 bytes
        wgmma_rs<HD>(oacc, pa[kk], v_desc + off + kk * (16 * C::SW >> 4));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(oacc);
      fence_regs(pa);
      bad = __syncthreads_or(*stuck) != 0;
    }

#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      float l = lrow[rh];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float inv = bad ? NAN : (l == 0.f) ? 1.f : 1.f / l;  // fully masked rows -> 0
      if (!out_row[rh]) continue;
      if (LSE && t == 0)
        lse[(int64_t)(it.b * H + head[rh]) * Sq + qpos[rh]] =
            (l == 0.f ? mrow[rh] : mrow[rh] + log2f(l)) * LN2 * (bad ? NAN : 1.f);
      __nv_bfloat16* orow = o + it.b * o_sb + head[rh] * o_sh + (int64_t)qpos[rh] * o_ss + 2 * t;
#pragma unroll
      for (int d = 0; d < HD / 8; ++d)
        *reinterpret_cast<__nv_bfloat162*>(orow + d * 8) = __floats2bfloat162_rn(
            oacc[4 * d + 2 * rh] * inv, oacc[4 * d + 2 * rh + 1] * inv);
    }
  }
  if (threadIdx.x == 0) {  // nothing in flight into shared memory from here on
    drain_ring(full_q, ST, q_issued);
    drain_ring(full, ST, issued);
  }
}

template <int HD>
struct Dq16 : Geo<HD> {
  using G = Geo<HD>;
  static_assert(HD == 16, "the grouped dQ is for hd 16");
  static constexpr int BN = 64;                       // keys a K/V tile
  static constexpr int ST = 4;                        // ring stages, and Q/dO buffers
  static constexpr int Q_BYTES = GROUP_ROWS * G::SW;  // an item's Q rows
  static constexpr int QD_BYTES = 2 * Q_BYTES;        // its Q, and its dO after them
  static constexpr int TILE = BN * G::SW;             // a K or a V tile
  static constexpr int STAGE = 2 * TILE;              // K, and V after it
  // the Q/dO buffers, the ring; 2 ST mbarriers and the stuck flag; alignment slack
  static constexpr int SMEM = 1024 + ST * QD_BYTES + ST * STAGE + 8 * 2 * ST + 16;
};

template <int HD>
__global__ void __launch_bounds__(HD16_THREADS, DQ16_MINB)
flash_bwd_dq_group_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap,
                          const __grid_constant__ CUtensorMap domap,
                          const float* __restrict__ lse, const float* __restrict__ dd,
                          __nv_bfloat16* __restrict__ dq, int B, int H, int Hkv, int Sq, int Sk,
                          int causal, float scale, Str3 dqs) {
  using C = Dq16<HD>;
  constexpr int ST = C::ST, BN = C::BN;
  constexpr int NT = BN / 8;  // 8-key column tiles of S
  extern __shared__ uint8_t dq16_smem[];
  uint8_t* Qs = align_1024(dq16_smem);    // the n-th item's Q, dO in buffer n % ST
  uint8_t* ring = Qs + ST * C::QD_BYTES;  // stage s: K at ring + s STAGE, V after it
  uint64_t* full_q = reinterpret_cast<uint64_t*>(ring + ST * C::STAGE);
  uint64_t* full = full_q + ST;
  volatile int* stuck = reinterpret_cast<volatile int*>(full + ST);

  const int n_rep = H / Hkv;
  const GroupRows gr(n_rep);
  const int rows = gr.hpi * gr.pos;
  const int items = B * Hkv * gr.chunks * ((Sq + gr.pos - 1) / gr.pos);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // accumulator row group, column pair

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full_q + s, 1);
      mbar_init(full + s, 1);
    }
    *stuck = 0;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (rows < GROUP_ROWS)
    for (int s = 0; s < 2 * ST; ++s) zero_tail(Qs + s * C::Q_BYTES, rows, C::SW);
  __syncthreads();

  // Thread 0 loads the block's stream: item after item, the item's Q and dO
  // (into buffer n % ST for the block's n-th item) before its first K/V
  // tile, the stream's tile f into stage f % ST. The wrapper launches no
  // kernel when Sk is 0, so every item has a tile.
  int ld_item = blockIdx.x, ld_nth = 0, ld_tile = 0, ld_tiles = 0, issued = 0, q_issued = 0;
  GroupItem ld;
  auto load_next = [&]() {
    if (ld_item >= items) return;
    if (ld_tile == 0) {
      ld = group_item(ld_item, gr, B, Hkv, n_rep, Sq);
      ld_tiles = group_tiles(ld, gr, Sk, causal, BN);
      const int qb = ld_nth % ST;
      uint8_t* qd = Qs + qb * C::QD_BYTES;
      mbar_expect_tx(full_q + qb, 2 * rows * C::SW);
      tma_load_4d(qd, &qmap, full_q + qb, 0, ld.head0, ld.p0, ld.b);
      tma_load_4d(qd + C::Q_BYTES, &domap, full_q + qb, 0, ld.head0, ld.p0, ld.b);
      ++q_issued;
    }
    uint8_t* kv = ring + (issued % ST) * C::STAGE;
    load_pair<HD, BN>(&kmap, &vmap, kv, kv + C::TILE, full + issued % ST, ld_tile * BN, ld.kvh,
                      ld.b);
    ++issued;
    if (++ld_tile == ld_tiles) {
      ld_tile = 0;
      ld_item = next_group_item(ld_item);
      ++ld_nth;
    }
  };
  if (threadIdx.x == 0)
    while (issued < ST && ld_item < items) load_next();

  const float scale_log2 = scale * LOG2E;
  float dqa[HD / 2];
  float s[BN / 2], dp[BN / 2];  // S and dP of a tile, then dS in dp
  uint32_t da[BN / 16][4];      // dS as bf16 A fragments
  int head[2], qpos[2];         // this thread's rows warp 16 + g (+ 8) of the item
  float lse2[2], drow[2];       // their LSE log2 e and D; 0 off the output rows
  const uint64_t q_desc0 = smem_desc(smem_addr(Qs), 16, 8 * C::SW, C::LAYOUT);
  const uint64_t k_kmaj = smem_desc(smem_addr(ring), 16, 8 * C::SW, C::LAYOUT);
  const uint64_t v_kmaj = k_kmaj + (C::TILE >> 4);
  const uint64_t k_mnmaj = smem_desc(smem_addr(ring), C::TILE, 8 * C::SW, C::LAYOUT);

  // dS = P (dP - D) of the tile at keys n0 into dp. Masked: column c of row
  // rh is a key the row sees if c - 2t < its limit; the others give 0.
  auto grad_scores = [&](int n0, auto masked) {
    int sees[2] = {BN, BN};
    if constexpr (decltype(masked)::value) {
#pragma unroll
      for (int rh = 0; rh < 2; ++rh)
        sees[rh] = (causal ? min(Sk, qpos[rh] + 1) : Sk) - n0 - 2 * t;
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = 4 * j + e, rh = e >> 1;
        float p = ex2_ftz(fmaf(s[x], scale_log2, -lse2[rh]));
        if constexpr (decltype(masked)::value) p = j * 8 + (e & 1) < sees[rh] ? p : 0.f;
        dp[x] = p * (dp[x] - drow[rh]);
      }
  };

  bool bad = false;  // a wait of the block gave up (the same in every thread)
  int f = 0;         // tiles of the block's stream taken
  for (int item = blockIdx.x, nth = 0; item < items; item = next_group_item(item), ++nth) {
    const GroupItem it = group_item(item, gr, B, Hkv, n_rep, Sq);
    const int n_tiles = group_tiles(it, gr, Sk, causal, BN);
    bool out_row[2];
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      lse2[rh] = drow[rh] = 0.f;
      out_row[rh] = group_row(warp * 16 + g + 8 * rh, gr, it, n_rep, Sq, head[rh], qpos[rh]);
      if (out_row[rh]) {
        const int64_t at = (int64_t)(it.b * H + head[rh]) * Sq + qpos[rh];
        lse2[rh] = lse[at] * LOG2E;
        drow[rh] = dd[at];
      }
    }
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dqa[i] = 0.f;
    const uint64_t q_desc = q_desc0 + (uint64_t)((nth % ST) * C::QD_BYTES >> 4);
    const uint64_t do_desc = q_desc + (C::Q_BYTES >> 4);
    if (!bad) mbar_wait(full_q + nth % ST, (uint32_t)(nth / ST) & 1u, stuck);
    for (int j = 0; j < n_tiles && !bad; ++j, ++f) {
      const int st = f % ST;
      const uint64_t off = (uint64_t)(st * C::STAGE) >> 4;
      mbar_wait(full + st, (uint32_t)(f / ST) & 1u, stuck);
      // S = Q K^T and dP = dO V^T: rows the item's 64, columns the tile's keys
      wgmma_fence();
      wgmma_ss<BN>(s, q_desc, k_kmaj + off, 0);
      wgmma_ss<BN>(dp, do_desc, v_kmaj + off, 0);
      wgmma_commit();
      // tile f - 1's stage is free: its dS K ended in every warp before the
      // barrier that closed tile f - 1
      if (threadIdx.x == 0 && f >= 1) load_next();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      const int n0 = j * BN;
      if ((n0 + BN > Sk) || (causal && n0 + BN - 1 > it.p0))
        grad_scores(n0, Flag<true>{});
      else
        grad_scores(n0, Flag<false>{});
      pack_a<BN>(da, dp);
      // dQ += dS K (the k dimension is the key)
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)  // 16 keys a k-step: 16 rows of 32 bytes
        wgmma_rs<HD>(dqa, da[kk], k_mnmaj + off + kk * (16 * C::SW >> 4));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dqa);
      fence_regs(da);
      bad = __syncthreads_or(*stuck) != 0;
    }

    const float mul = bad ? NAN : scale;  // a wait of the block gave up: poison the rows
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      if (!out_row[rh]) continue;
      __nv_bfloat16* out = dq + it.b * dqs.b + head[rh] * dqs.h + (int64_t)qpos[rh] * dqs.s + 2 * t;
#pragma unroll
      for (int d = 0; d < HD / 8; ++d)
        *reinterpret_cast<__nv_bfloat162*>(out + d * 8) = __floats2bfloat162_rn(
            dqa[4 * d + 2 * rh] * mul, dqa[4 * d + 2 * rh + 1] * mul);
    }
  }
  if (threadIdx.x == 0) {  // nothing in flight into shared memory from here on
    drain_ring(full_q, ST, q_issued);
    drain_ring(full, ST, issued);
  }
}

template <int HD>
cudaError_t launch_dkv_cluster(const void* q, const void* k, const void* v, const void* dout,
                               const float* lse, const float* dd, void* dk, void* dv, int B,
                               int H, int Hkv, int Sq, int Sk, int causal, float scale,
                               const int64_t* st, cudaStream_t stream) {
  using C = Dkv16<HD>;
  static bool configured = false;
  cudaError_t err = allow_smem(flash_bwd_dkv_cluster_kernel<HD>, C::SMEM, configured);
  if (err != cudaSuccess) return err;
  CUtensorMap qm, km, vm, dom;
  if ((err = make_map<HD>(&qm, q, B, H, Sq, st, C::BQ)) != cudaSuccess) return err;
  if ((err = make_map<HD>(&km, k, B, Hkv, Sk, st + 3, C::BK)) != cudaSuccess) return err;
  if ((err = make_map<HD>(&vm, v, B, Hkv, Sk, st + 6, C::BK)) != cudaSuccess) return err;
  if ((err = make_map<HD>(&dom, dout, B, H, Sq, st + 9, C::BQ)) != cudaSuccess) return err;
  const int items = (Sk + C::BK - 1) / C::BK * B * Hkv;
  if (items == 0) return cudaSuccess;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = DKV16_CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(items * DKV16_CL);
  cfg.blockDim = dim3(DKV16_THREADS);
  cfg.dynamicSmemBytes = C::SMEM;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, flash_bwd_dkv_cluster_kernel<HD>, qm, km, vm, dom, lse, dd,
                           static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), B,
                           H, Hkv, Sq, Sk, causal, scale, Str3{st[12], st[13], st[14]},
                           Str3{st[15], st[16], st[17]});
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int HD>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* dd, void* dk, void* dv, int B, int H,
                       int Hkv, int Sq, int Sk, int causal, float scale, const int64_t* st,
                       cudaStream_t stream) {
  using C = Dkv<HD>;
  static bool configured = false;
  cudaError_t err = allow_smem(flash_bwd_dkv_kernel<HD>, C::SMEM, configured);
  if (err != cudaSuccess) return err;
  CUtensorMap qm, km, vm, dom;
  if ((err = make_map<HD>(&qm, q, B, H, Sq, st, C::BQ)) != cudaSuccess) return err;
  if ((err = make_map<HD>(&km, k, B, Hkv, Sk, st + 3, C::BK)) != cudaSuccess) return err;
  if ((err = make_map<HD>(&vm, v, B, Hkv, Sk, st + 6, C::BK)) != cudaSuccess) return err;
  if ((err = make_map<HD>(&dom, dout, B, H, Sq, st + 9, C::BQ)) != cudaSuccess) return err;
  const int items = (Sk + C::BK - 1) / C::BK * B * Hkv;
  flash_bwd_dkv_kernel<HD><<<items, BWD_THREADS, C::SMEM, stream>>>(
      qm, km, vm, dom, lse, dd, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), B, H, Hkv, Sq, Sk, causal, scale,
      Str3{st[12], st[13], st[14]}, Str3{st[15], st[16], st[17]});
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* dd, void* dq, int B, int H, int Hkv, int Sq,
                      int Sk, int causal, float scale, const int64_t* st, cudaStream_t stream) {
  using C = Dq<HD>;
  static bool configured = false;
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<HD>, C::SMEM, configured);
  if (err != cudaSuccess) return err;
  CUtensorMap qm, km, vm, dom;
  if ((err = make_map<HD>(&qm, q, B, H, Sq, st, C::BM)) != cudaSuccess) return err;
  if ((err = make_map<HD>(&km, k, B, Hkv, Sk, st + 3, C::BN)) != cudaSuccess) return err;
  if ((err = make_map<HD>(&vm, v, B, Hkv, Sk, st + 6, C::BN)) != cudaSuccess) return err;
  if ((err = make_map<HD>(&dom, dout, B, H, Sq, st + 9, C::BM)) != cudaSuccess) return err;
  const int items = (Sq + C::BM - 1) / C::BM * B * H;
  flash_bwd_dq_kernel<HD><<<items, BWD_THREADS, C::SMEM, stream>>>(
      qm, km, vm, dom, lse, dd, static_cast<__nv_bfloat16*>(dq), B, H, Hkv, Sq, Sk, causal,
      scale, Str3{st[12], st[13], st[14]});
  return cudaGetLastError();
}

// The persistent grid of a grouped hd-16 kernel: a whole number of blocks
// an SM, as many as fit but no more than leave each block HD16_ROUNDS items
// where there are enough, so that every block is resident at once; never
// more blocks than items. The grid depends on the shapes and the card only.
// `fit` caches the kernel's blocks an SM (0 until the first launch asks).
template <typename Kernel>
cudaError_t group_grid(Kernel kernel, int smem, int items, int& fit, int& grid) {
  int dev = 0, sms = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if (fit == 0 && (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                       &fit, kernel, HD16_THREADS, smem)) != cudaSuccess)
    return err;
  int per_sm = (items + HD16_ROUNDS * sms - 1) / (HD16_ROUNDS * sms);
  per_sm = per_sm < 1 ? 1 : per_sm > fit ? (fit > 0 ? fit : 1) : per_sm;
  grid = items < sms * per_sm ? items : sms * per_sm;
  return cudaSuccess;
}

// The hd-16 forward (kernel<16, LSE>): a persistent grid over items of 64
// packed (position, head) rows.
template <int HD, bool LSE>
cudaError_t launch_fwd_group(const void* q, const void* k, const void* v, void* o, float* lse,
                             int B, int H, int Hkv, int Sq, int Sk, int causal,
                             float scale_log2, const int64_t* st, cudaStream_t stream) {
  using C = Fwd16<HD>;
  static bool configured = false;
  cudaError_t err = allow_smem(flash_fwd_group_kernel<HD, LSE>, C::SMEM, configured);
  if (err != cudaSuccess) return err;
  const GroupRows gr(H / Hkv);
  CUtensorMap qm, km, vm;
  if ((err = make_map<HD>(&qm, q, B, H, Sq, st, gr.pos, gr.hpi)) != cudaSuccess) return err;
  if ((err = make_map<HD>(&km, k, B, Hkv, Sk, st + 3, C::BN)) != cudaSuccess) return err;
  if ((err = make_map<HD>(&vm, v, B, Hkv, Sk, st + 6, C::BN)) != cudaSuccess) return err;
  const int items = B * Hkv * gr.chunks * ((Sq + gr.pos - 1) / gr.pos);
  if (items == 0) return cudaSuccess;
  static int fit = 0;
  int grid = 0;
  if ((err = group_grid(flash_fwd_group_kernel<HD, LSE>, C::SMEM, items, fit, grid)) !=
      cudaSuccess)
    return err;
  flash_fwd_group_kernel<HD, LSE><<<grid, HD16_THREADS, C::SMEM, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), lse, B, H, Hkv, Sq, Sk, causal, scale_log2,
      st[9], st[10], st[11]);
  return cudaGetLastError();
}

// The hd-16 dQ: a persistent grid over items of 64 packed rows. The wrapper
// launches nothing when Sk is 0 (dQ is then zero).
template <int HD>
cudaError_t launch_dq_group(const void* q, const void* k, const void* v, const void* dout,
                            const float* lse, const float* dd, void* dq, int B, int H, int Hkv,
                            int Sq, int Sk, int causal, float scale, const int64_t* st,
                            cudaStream_t stream) {
  using C = Dq16<HD>;
  static bool configured = false;
  cudaError_t err = allow_smem(flash_bwd_dq_group_kernel<HD>, C::SMEM, configured);
  if (err != cudaSuccess) return err;
  const GroupRows gr(H / Hkv);
  CUtensorMap qm, km, vm, dom;
  if ((err = make_map<HD>(&qm, q, B, H, Sq, st, gr.pos, gr.hpi)) != cudaSuccess) return err;
  if ((err = make_map<HD>(&km, k, B, Hkv, Sk, st + 3, C::BN)) != cudaSuccess) return err;
  if ((err = make_map<HD>(&vm, v, B, Hkv, Sk, st + 6, C::BN)) != cudaSuccess) return err;
  if ((err = make_map<HD>(&dom, dout, B, H, Sq, st + 9, gr.pos, gr.hpi)) != cudaSuccess)
    return err;
  const int items = B * Hkv * gr.chunks * ((Sq + gr.pos - 1) / gr.pos);
  if (items == 0 || Sk == 0) return cudaSuccess;
  static int fit = 0;
  int grid = 0;
  if ((err = group_grid(flash_bwd_dq_group_kernel<HD>, C::SMEM, items, fit, grid)) != cudaSuccess)
    return err;
  flash_bwd_dq_group_kernel<HD><<<grid, HD16_THREADS, C::SMEM, stream>>>(
      qm, km, vm, dom, lse, dd, static_cast<__nv_bfloat16*>(dq), B, H, Hkv, Sq, Sk, causal,
      scale, Str3{st[12], st[13], st[14]});
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q: (B, H, Sq, hd), k and v: (B, Hkv, Sk, hd), o: (B, H, Sq, hd), all bf16,
// any strides with a unit last stride. strides: (sb, sh, ss) of q, k, v
// and o in elements. Every row must start on 16 bytes. hd in {16, 32, 64, 128}.
// Returns cudaGetLastError().
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int B, int H,
                        int Hkv, int Sq, int Sk, int hd, int causal, float scale_log2,
                        const int64_t* strides, void* stream) {
  if (H % Hkv != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch_fwd_group<16, false>(q, k, v, o, nullptr, B, H, Hkv, Sq, Sk, causal, scale_log2, strides, s);
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
    case 16: return launch_fwd_group<16, true>(q, k, v, o, lse, B, H, Hkv, Sq, Sk, causal, scale_log2, strides, s);
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
    case 16: return launch_dkv_cluster<16>(q, k, v, dout, lse, dd, dk, dv, B, H, Hkv, Sq, Sk, causal, scale, strides, s);
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
    case 16: return launch_dq_group<16>(q, k, v, dout, lse, dd, dq, B, H, Hkv, Sq, Sk, causal, scale, strides, s);
    case 32: return launch_dq<32>(q, k, v, dout, lse, dd, dq, B, H, Hkv, Sq, Sk, causal, scale, strides, s);
    case 64: return launch_dq<64>(q, k, v, dout, lse, dd, dq, B, H, Hkv, Sq, Sk, causal, scale, strides, s);
    case 128: return launch_dq<128>(q, k, v, dout, lse, dd, dq, B, H, Hkv, Sq, Sk, causal, scale, strides, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Dynamic shared memory a launch takes, in bytes: kernel 0 the forward
// with LSE (and without it, but at hd 64), 1 dK/dV, 2 dQ, and the kernels
// of their own: at hd 16 3 the cluster dK/dV, 4 the grouped forward, 5 the
// grouped dQ; at hd 64 6 the three-warpgroup serving forward; 0 for
// another hd.
int flash_attention_smem_bytes(int kernel, int hd) {
  if (kernel == 6) return hd == 64 ? Fwd<64, false>::SMEM : 0;
  if (kernel == 3) return hd == 16 ? Dkv16<16>::SMEM : 0;
  if (kernel == 4) return hd == 16 ? Fwd16<16>::SMEM : 0;
  if (kernel == 5) return hd == 16 ? Dq16<16>::SMEM : 0;
  switch (hd) {
    case 16: return kernel == 0 ? Fwd<16, true>::SMEM : kernel == 1 ? Dkv<16>::SMEM : Dq<16>::SMEM;
    case 32: return kernel == 0 ? Fwd<32, true>::SMEM : kernel == 1 ? Dkv<32>::SMEM : Dq<32>::SMEM;
    case 64: return kernel == 0 ? Fwd<64, true>::SMEM : kernel == 1 ? Dkv<64>::SMEM : Dq<64>::SMEM;
    case 128: return kernel == 0 ? Fwd<128, true>::SMEM : kernel == 1 ? Dkv<128>::SMEM : Dq<128>::SMEM;
    default: return 0;
  }
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
