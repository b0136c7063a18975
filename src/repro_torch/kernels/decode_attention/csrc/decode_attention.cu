// Decode attention for Hopper (sm_90a): one graph-safe launch per call.
//
// Replaces: src/repro/kernels/decode_attention/kernel.py, decode_attention_fwd
// (Pallas body _dec_kernel): one query token per sequence attends over the
// first kv_len positions of a KV cache; the n_rep query heads of a GQA group
// share one pass over their kv head. f32 online softmax. Returns o in q's
// dtype and the f32 log-sum-exp, with the kernel's l == 0 guard (o = 0,
// lse = -1e30 where no position is valid). kv_len is a device scalar, as the
// Pallas kernel's len_ref in SMEM.
//
// Bound on this card: bytes. Every valid K and V row is read once and used
// for n_rep (4 for Mistral-Nemo) dot products each: ~2 flops per byte, far
// below the ~295 the H100 can do per byte. At 4 sequences x 8 kv heads x
// ~2080 positions x 128 x bf16 that is ~34 MB per layer, ~10 us at 3.35 TB/s.
//
// Design:
// * Graph-safe. kv_len is read from device memory by every block and clamped
//   to [0, S] here; the grid (n_split, groups) depends on B, H, Hkv, hd and
//   the kernel's occupancy only, never on kv_len, so one captured launch
//   stays right while the position advances between replays. Block `split`
//   takes tiles split, split + n_split, ... of the T 16-key tiles of
//   [0, kv_len): parts differ by at most one tile at any length, the blocks
//   of a cluster move through the cache side by side (a run of tiles per
//   block measured the same with the L2 flushed by a write, 0.0240 against
//   0.0232-0.0238 ms with a clean L2), and an empty part contributes
//   (m = -inf, l = 0).
// * One launch: the n_split blocks of a (sequence, head group) merge their
//   partials in the same launch. CLUSTER_MERGE: they form a thread-block
//   cluster along x; each block leaves its partial (m, l, acc) in its shared
//   memory, and after a cluster barrier each block merges a slice of the
//   group's outputs, reading its peers' partials through distributed shared
//   memory. Otherwise (the counter variant, kept for tools/decode_variants.py)
//   each block writes its partial to a global scratch, and the last block of
//   a group to arrive on its counter merges and resets the counter, so that
//   replays start clean. The cluster won the probe (0.0271 against 0.0395
//   ms, tools/decode_variants.py; PERF.md section 6): no scratch, no
//   fence, no atomic and no serial merge in a last block.
// * Bytes in flight: one producer thread streams K and V with TMA through
//   two 4-D tensor maps over the cache's (hd, Hkv, S, B) layout, one box of
//   16 keys x 64 columns (128 bytes, swizzled; 32 columns at hd 32) per
//   copy, into a ring of ST stages; each stage completes on a "full"
//   mbarrier with expect_tx bytes, and the consumer warp that used it
//   releases it on its "empty" mbarrier. ST = 4 stages of 16 keys, one a
//   consumer warp, keep 32 KB per block and ~64 KB per SM in flight at hd
//   128 (the previous two-pass kernel kept one 8-key step per warp); 8 stages read
//   0.0287 against 0.0271 ms, 12 stages 0.0279. The first design copied each
//   256-byte row with its own
//   cp.async.bulk (32 copies a tile): streaming alone then took 0.028 ms,
//   the TMA unit's rate for small copies, not the memory, setting the pace
//   (tools/decode_variants.py, PERF.md section 6). The swizzle lets
//   ldmatrix and the V reads hit distinct banks. kv_len is one dependent
//   read from device memory (after 24 GB of weights stream through the L2
//   in a decode step, a miss): the producer issues its split's first ST
//   tiles before the value arrives, so that read overlaps the first loads.
//   Past those, tiles beyond kv_len are never loaded; rows of the last tile
//   past kv_len are loaded but never used.
// * Q K^T on tensor cores: S^T = K Q^T on mma.sync m16n8k16 (bf16 in, f32
//   accumulate: the products are exact), a tile's 16 keys as M, the group's
//   heads (padded to 8) as N, hd as K. Q's B fragments live in registers for
//   the whole launch. The shuffles go: only a tile's maxima are reduced
//   across lanes (3 rounds), the sums stay per lane until the end.
// * P V in f32 on the CUDA cores, never rounded to bf16 (the reference keeps
//   this product in f32: one bf16 rounding of P makes greedy decode disagree
//   on near-ties). Each lane owns hd / 32 columns of every head's
//   accumulator; a tile's P and rescale factors pass through a 544-byte
//   buffer per warp.
// * hd 16 and 64 run a kernel of their own (decode_attention_lanes_kernel,
//   below).
// * Consumer warp w takes its block's tiles w, w + NCW, ...; each warp keeps
//   its own (m, l, acc) and the warps merge in shared memory (reusing the
//   ring) before the blocks merge.
// * The query heads a block serves are a template parameter NREP, so lanes
//   hold exactly those accumulators. Groups 1, 2, 3, 4 and 8 are compiled as
//   they are; any other group is cut into ceil(n_rep / 8) chunks of 8 heads,
//   each chunk its own head group reading its kv head (group 16 reads each
//   kv head twice).
// * A wait that never ends (a pipeline fault) gives up after ~2^32 cycles
//   and sets the block's `stuck` flag: the producer stops and drains, and
//   the block's outputs are NaN, so a fault fails the checks instead of
//   hanging the card (as flash_attention.cu).
#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

constexpr int TK = 16;                    // keys per tile (one mma M tile)
constexpr int NCW = 4;                    // consumer warps
constexpr int THREADS = (NCW + 1) * 32;   // and one producer warp
constexpr int ST = 4;                     // ring stages
constexpr bool CLUSTER_MERGE = true;      // merge in a cluster, else by a counter
constexpr int MAX_SPLIT = CLUSTER_MERGE ? 8 : 32;  // 8: the portable cluster size
constexpr bool PORTABLE = !CLUSTER_MERGE || MAX_SPLIT <= 8;
// Each stage belongs to one consumer warp (tile i: stage i % ST, warp
// i % NCW). A stage shared by two warps lets one warp wait two phases
// ahead of the barrier, where a parity wait passes on the old phase: the
// ring-3 variant with 4 warps ended in "unspecified launch failure".
static_assert(ST % NCW == 0, "every ring stage is used by one consumer warp");
constexpr float LN2 = 0.6931471805599453f;
constexpr long long WATCHDOG_CYCLES = 1ll << 32;

// Dynamic shared memory of one block: the ring (1024-byte aligned, as the
// swizzle needs), the warps' P buffers, the block's partial (m[8], l[8],
// acc[8][HD]) and the mbarriers. A tile's K (then V) is NC chunks of TK rows
// of SW bytes, each chunk one TMA box.
template <int HD>
struct Smem {
  static constexpr int SW = HD * 2 < 128 ? HD * 2 : 128;  // swizzle span: bytes a box row
  static constexpr int CW = SW / 2;                       // columns a box
  static constexpr int NC = HD / CW;                      // boxes a row
  // P V's lane map: E columns a lane, LPR lanes a row, so a warp takes RPW
  // rows of V at once (hd 16: two rows of 16 lanes, summed at the end)
  static constexpr int E = HD >= 32 ? HD / 32 : 1;
  static constexpr int LPR = HD / E;
  static constexpr int RPW = 32 / LPR;
  static_assert(SW == 32 || SW == 64 || SW == 128, "hd in {16, 32, 64, 128}");
  static constexpr int TILE = TK * HD * 2;                // a tile's K (or V) bytes
  static constexpr int STAGE = 2 * TILE;
  static constexpr int RING = ST * STAGE;
  static constexpr int PBUF = (TK * 8 + 8) * 4;  // P (TK x 8) and 8 rescale factors
  static constexpr int PART = (16 + 8 * HD) * 4;
  static constexpr int BARS = 2 * ST * 8 + 16;   // full, empty, the stuck flag
  static constexpr int TOTAL = 1024 + RING + NCW * PBUF + PART + BARS;
  static_assert(NCW * PART <= RING, "the warps' partials fit in the ring");
};

// Byte offset `off` of a chunk (rows of SW bytes from a 1024-byte aligned
// base) as the TMA swizzle stores it: the 16-byte unit index XORed with the
// row bits above it (128-byte swizzle: row % 8; 64-byte: (row / 2) % 4;
// 32-byte: (row / 4) % 2).
template <int SW>
__device__ __forceinline__ uint32_t swz(uint32_t off) {
  return off ^ (((off >> 7) & (SW / 16 - 1)) << 4);
}

template <int BYTES> struct Vec;
template <> struct Vec<2> { using type = unsigned short; };
template <> struct Vec<4> { using type = unsigned int; };
template <> struct Vec<8> { using type = uint2; };

// One lane's columns of a row: E bf16 elements as one vector register.
template <int E>
using Slice = typename Vec<E * sizeof(bf16)>::type;

template <int E>
__device__ __forceinline__ void unpack(const Slice<E>& raw, float (&out)[E]) {
  alignas(16) bf16 buf[E];
  *reinterpret_cast<Slice<E>*>(buf) = raw;
#pragma unroll
  for (int i = 0; i < E; ++i) out[i] = __bfloat162float(buf[i]);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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

// Wait for the phase of `bar` with parity `parity`; give up after the
// watchdog and set `stuck` (see the header).
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

// Until the last min(count, STAGES) loads issued into a ring of STAGES
// stages have landed, so that no bulk copy into shared memory is in flight
// when the block exits; bounded by the watchdog.
template <int STAGES = ST>
__device__ __forceinline__ void drain_ring(uint64_t* full, int count) {
  for (int n = count > STAGES ? count - STAGES : 0; n < count; ++n) {
    const uint32_t a = smem_addr(full + n % STAGES);
    const long long t0 = clock64();
    while (!mbar_try_wait(a, (n / STAGES) & 1) && clock64() - t0 <= WATCHDOG_CYCLES) {
    }
  }
}

// One box of a 4-D map at (col, head, row, batch), completing on `bar`.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int col, int head, int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(col), "r"(head), "r"(row),
      "r"(batch)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a b, m16n8k16, bf16 in, f32 accumulate.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct Params {
  const bf16* q;
  bf16* o;
  float* lse;
  const int* kv_len;
  float* part;      // counter merge only: the blocks' partials
  unsigned* count;  // counter merge only: arrivals per head group
  int S, H, Hkv, group;
  int64_t q_sb, q_sh;
  float scale_log2;
};

// acc[r] = acc[r] * alpha[r] + sum_j p[j][r] v[j] over a tile's first
// `rows` keys: this lane's E columns, every head, f32; where a warp takes
// RPW rows at once, over the rows j with j % RPW == lane / LPR.
template <int HD, int NREP>
__device__ __forceinline__ void pv_tile(float (&acc)[NREP][Smem<HD>::E], const float* pb,
                                        const uint8_t* vt, int rows, int lane) {
  constexpr int E = Smem<HD>::E, LPR = Smem<HD>::LPR, RPW = Smem<HD>::RPW;
  const float* alpha = pb + TK * 8;
#pragma unroll
  for (int r = 0; r < NREP; ++r)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[r][e] *= alpha[r];
#pragma unroll
  for (int j0 = 0; j0 < TK; j0 += RPW) {
    const int j = j0 + lane / LPR;
    if (j < rows) {
      float vf[E], pr[8];
      constexpr int SW = Smem<HD>::SW;
      const int byte = lane % LPR * E * 2;  // this lane's columns: box byte / SW
      unpack<E>(*reinterpret_cast<const Slice<E>*>(
                    vt + byte / SW * TK * SW + swz<SW>(j * SW + byte % SW)),
                vf);
      const float4 p0 = reinterpret_cast<const float4*>(pb + j * 8)[0];
      pr[0] = p0.x, pr[1] = p0.y, pr[2] = p0.z, pr[3] = p0.w;
      if (NREP > 4) {
        const float4 p1 = reinterpret_cast<const float4*>(pb + j * 8)[1];
        pr[4] = p1.x, pr[5] = p1.y, pr[6] = p1.z, pr[7] = p1.w;
      }
#pragma unroll
      for (int r = 0; r < NREP; ++r)
#pragma unroll
        for (int e = 0; e < E; ++e) acc[r][e] = fmaf(pr[r], vf[e], acc[r][e]);
    }
  }
}

// Scores are kept in base 2: s = (q . k) * scale * log2(e).
template <int HD, int NREP>
__global__ void __launch_bounds__(THREADS)
    decode_attention_kernel(const __grid_constant__ CUtensorMap kmap,
                            const __grid_constant__ CUtensorMap vmap, const Params p) {
  using G = Smem<HD>;
  constexpr int E = G::E;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* ring = smem;
  float* pbuf = reinterpret_cast<float*>(smem + G::RING);
  float* bm = reinterpret_cast<float*>(smem + G::RING + NCW * G::PBUF);  // block partial
  float* bl = bm + 8;
  float* bacc = bm + 16;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + G::RING + NCW * G::PBUF + G::PART);
  uint64_t* empty = full + ST;
  volatile int* stuck = reinterpret_cast<volatile int*>(empty + ST);

  // blockIdx.y = (b * Hkv + kvh) * n_chunks + chunk: heads h0 .. h0 + valid - 1;
  // only NREP 8 serves a group in chunks, the others serve group == NREP
  constexpr bool CHUNKED = NREP == 8;
  const int split = blockIdx.x, n_split = gridDim.x, gi = blockIdx.y;
  const int n_chunks = CHUNKED ? (p.group + NREP - 1) / NREP : 1;
  const int chunk = CHUNKED ? gi % n_chunks : 0;
  const int bkv = CHUNKED ? gi / n_chunks : gi;
  const int b = bkv / p.Hkv, kvh = bkv % p.Hkv;
  const int h0 = kvh * p.group + chunk * NREP;
  const int valid = CHUNKED ? min(NREP, p.group - chunk * NREP) : NREP;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  const int kv_in = __ldg(p.kv_len);  // waited for where first used
  auto tile_key = [&](int i) { return (split + i * n_split) * TK; };  // tile i's first key
  // kv_len clamped to [0, S], and how many of its tiles this split takes:
  // worked out where first needed, so that the read of kv_len overlaps the
  // set-up and the producer's first loads
  int kv_len = 0;
  auto count_tiles = [&]() {
    kv_len = min(max(kv_in, 0), p.S);
    const int tiles = (kv_len + TK - 1) / TK;
    return split < tiles ? (tiles - split + n_split - 1) / n_split : 0;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 1);
    }
    *stuck = 0;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // lanes of the S^T fragment: key rows g, g + 8; head columns 2t, 2t + 1
  const int g = lane >> 2, t = lane & 3;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float acc[NREP][E];
#pragma unroll
  for (int r = 0; r < NREP; ++r)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[r][e] = 0.f;

  if (warp == NCW) {
    // producer: lane 0 loads each tile's K and V boxes. The first ST tiles
    // of the split that lie in the cache are issued before kv_len, a
    // dependent read from device memory, is known: a tile at or past kv_len
    // is then loaded and not used (only while kv_len < ST * n_split * TK).
    if (lane == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&kmap)) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&vmap)) : "memory");
      auto issue = [&](int i) {
        const int s = i % ST;
        uint8_t* kt = ring + s * G::STAGE;
        mbar_expect_tx(full + s, G::STAGE);
#pragma unroll
        for (int c = 0; c < G::NC; ++c) {
          tma_load_4d(kt + c * TK * G::SW, &kmap, full + s, c * G::CW, kvh, tile_key(i), b);
          tma_load_4d(kt + G::TILE + c * TK * G::SW, &vmap, full + s, c * G::CW, kvh,
                      tile_key(i), b);
        }
      };
      int i = 0;
      for (; i < ST && tile_key(i) < p.S; ++i) issue(i);
      const int ntiles = count_tiles();
      for (; i < ntiles; ++i) {
        mbar_wait(empty + i % ST, ((i / ST) & 1) ^ 1, stuck);
        if (*stuck) break;
        issue(i);
      }
      drain_ring(full, i);
    }
  } else {
    // Q^T's B fragments: head g of the chunk, columns 16 ks + 2t (+1, +8, +9)
    uint32_t qf[HD / 16][2];
    const bf16* qh = p.q + b * p.q_sb + (int64_t)(h0 + min(g, valid - 1)) * p.q_sh + 2 * t;
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      qf[ks][0] = g < valid ? *reinterpret_cast<const uint32_t*>(qh + ks * 16) : 0u;
      qf[ks][1] = g < valid ? *reinterpret_cast<const uint32_t*>(qh + ks * 16 + 8) : 0u;
    }
    float* pb = pbuf + warp * (TK * 8 + 8);
    const int ntiles = count_tiles();
    // ldmatrix: this lane's row of the A operand (keys) and 8-column half
    const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 16;
    for (int i = warp; i < ntiles; i += NCW) {
      const int s = i % ST;
      mbar_wait(full + s, (i / ST) & 1, stuck);
      if (*stuck) break;
      const int rows = min(TK, kv_len - tile_key(i));
      const uint8_t* kt = ring + s * G::STAGE;
      // two accumulators, even and odd k-steps: half the dependent chain
      float c[4] = {0.f, 0.f, 0.f, 0.f}, c2[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks) {
        uint32_t a[4];
        const int byte = ks * 32 + a_col;  // column byte of the row: box byte / SW
        ldsm_x4(a, smem_addr(kt) + byte / G::SW * TK * G::SW +
                       swz<G::SW>(a_row * G::SW + byte % G::SW));
        mma(ks % 2 ? c2 : c, a, qf[ks][0], qf[ks][1]);
      }
#pragma unroll
      for (int x = 0; x < 4; ++x) c[x] += c2[x];
      float s0 = g < rows ? c[0] * p.scale_log2 : -INFINITY;
      float s1 = g < rows ? c[1] * p.scale_log2 : -INFINITY;
      float s2 = g + 8 < rows ? c[2] * p.scale_log2 : -INFINITY;
      float s3 = g + 8 < rows ? c[3] * p.scale_log2 : -INFINITY;
      float x0 = fmaxf(s0, s2), x1 = fmaxf(s1, s3);
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, o));
        x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, o));
      }
      const float n0 = fmaxf(m0, x0), n1 = fmaxf(m1, x1);  // finite: key 0 is valid
      const float a0 = exp2f(m0 - n0), a1 = exp2f(m1 - n1);
      s0 = exp2f(s0 - n0), s1 = exp2f(s1 - n1), s2 = exp2f(s2 - n0), s3 = exp2f(s3 - n1);
      l0 = l0 * a0 + s0 + s2;
      l1 = l1 * a1 + s1 + s3;
      m0 = n0, m1 = n1;
      pb[g * 8 + 2 * t] = s0;
      pb[g * 8 + 2 * t + 1] = s1;
      pb[(g + 8) * 8 + 2 * t] = s2;
      pb[(g + 8) * 8 + 2 * t + 1] = s3;
      if (g == 0) {
        pb[TK * 8 + 2 * t] = a0;
        pb[TK * 8 + 2 * t + 1] = a1;
      }
      __syncwarp();
      pv_tile<HD, NREP>(acc, pb, kt + G::TILE, rows, lane);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + s);
    }
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, o);
      l1 += __shfl_xor_sync(0xffffffffu, l1, o);
    }
    // the rows the warp's lane groups took apart: lane and lane + LPR hold
    // the same columns
#pragma unroll
    for (int o = G::LPR; o < 32; o <<= 1)
#pragma unroll
      for (int r = 0; r < NREP; ++r)
#pragma unroll
        for (int e = 0; e < E; ++e) acc[r][e] += __shfl_xor_sync(0xffffffffu, acc[r][e], o);
  }
  __syncthreads();  // the ring is idle: the warps' partials go there

  float* wm = reinterpret_cast<float*>(ring);  // [NCW][8]
  float* wl = wm + NCW * 8;                    // [NCW][8]
  float* wacc = wl + NCW * 8;                  // [NCW][8][HD]
  if (warp < NCW) {
    if (g == 0) {
      wm[warp * 8 + 2 * t] = m0, wm[warp * 8 + 2 * t + 1] = m1;
      wl[warp * 8 + 2 * t] = l0, wl[warp * 8 + 2 * t + 1] = l1;
    }
    if (lane < G::LPR) {
#pragma unroll
      for (int r = 0; r < NREP; ++r)
#pragma unroll
        for (int e = 0; e < E; ++e) wacc[(warp * 8 + r) * HD + lane * E + e] = acc[r][e];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < valid * HD; i += THREADS) {
    const int r = i / HD;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < NCW; ++w) M = fmaxf(M, wm[w * 8 + r]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < NCW; ++w) {
      if (wm[w * 8 + r] != -INFINITY) {
        const float c = exp2f(wm[w * 8 + r] - M);
        L += wl[w * 8 + r] * c;
        A += wacc[(w * 8 + r) * HD + i % HD] * c;
      }
    }
    bacc[i] = *stuck ? NAN : A;
    if (i % HD == 0) bm[r] = M, bl[r] = L;
  }

  // Merge the n_split partials of this head group: output element i of
  // (valid heads x HD) from every block's (m, l, acc) via `read`.
  // Every peer's (m, l, acc) is read in one unrolled round, all in flight
  // at once; an empty part holds (-inf, 0, 0).
  auto merge = [&](int i, auto read) {
    const int r = i / HD, d = i % HD;
    float ms[MAX_SPLIT], ls[MAX_SPLIT], as[MAX_SPLIT], M = -INFINITY;
#pragma unroll
    for (int s = 0; s < MAX_SPLIT; ++s) {
      const bool in = s < n_split;
      ms[s] = in ? read(s, r) : -INFINITY;
      ls[s] = in ? read(s, 8 + r) : 0.f;
      as[s] = in ? read(s, 16 + i) : 0.f;
      M = fmaxf(M, ms[s]);
    }
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int s = 0; s < MAX_SPLIT; ++s) {
      const float c = ms[s] == -INFINITY ? 0.f : exp2f(ms[s] - M);
      L += ls[s] * c;
      A += as[s] * c;
    }
    const float safe = L == 0.f ? 1.f : L;
    const int64_t row = (int64_t)b * p.H + h0 + r;
    p.o[row * HD + d] = __float2bfloat16(A / safe);
    if (d == 0) p.lse[row] = M == -INFINITY ? -1e30f : (M + log2f(safe)) * LN2;
  };
  if constexpr (CLUSTER_MERGE) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // every block's partial is in its shared memory
    const int n = valid * HD, per = (n + n_split - 1) / n_split;
    const int lo = (int)cluster.block_rank() * per, hi = min(n, lo + per);
    for (int i = lo + threadIdx.x; i < hi; i += THREADS)
      merge(i, [&](int s, int idx) { return *cluster.map_shared_rank(bm + idx, s); });
    cluster.sync();  // the peers' shared memory outlives their readers
  } else {
    __shared__ int last;
    constexpr int PART = 16 + 8 * HD;
    __syncthreads();  // the block's partial is complete
    float* mine = p.part + ((int64_t)gi * n_split + split) * PART;
    for (int i = threadIdx.x; i < PART; i += THREADS) mine[i] = bm[i];
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) last = atomicAdd(p.count + gi, 1u) == (unsigned)(n_split - 1);
    __syncthreads();
    if (!last) return;
    __threadfence();
    const float* parts = p.part + (int64_t)gi * n_split * PART;
    for (int i = threadIdx.x; i < valid * HD; i += THREADS)
      merge(i, [&](int s, int idx) { return __ldcg(parts + s * PART + idx); });
    if (threadIdx.x == 0) p.count[gi] = 0;  // the next launch starts clean
  }
}

// ------------------------- head dims 16 and 64 --------------------------------
//
// decode_attention_lanes_kernel<HD, NREP>: the same contract at hd 16 and 64,
// a design of their own.
// * hd 16. The kernel above, instantiated at hd 16, moved 512 bytes
//   of K and 512 of V a TMA round trip (16-key tiles, 4 in flight a block,
//   ~4 tiles one after another a warp) and spent a 3-round shuffle and a
//   pass through the P buffer on each: at (4, 8/2, cache 2081, 16) it read
//   0.01363 ms, 43x its bytes bound and 1.09x SDPA (PERF.md section 6, row
//   "2, hd 16").
// * hd 64. The kernel above, instantiated at hd 64 (SeamlessM4T's
//   MHA, group 1), kept 16 KB in flight a block in 2 KB boxes, used one of
//   the 8 columns of each Q K^T mma, and its blocks held 8-16 tiles, so the
//   prologue and the merges weighed against a 5-10 us bytes bound: at
//   (4, 16/16, 1024, 64) 0.01765 ms, 28.4 % of the bound, a tie with SDPA.
// The design:
// * Tiles of TK keys, one TMA box of K and one of V each (hd 16: 64 keys, 2
//   KB boxes; hd 64: 32 keys, 4 KB boxes), and a ring of ST stages of which
//   the first EARLY tiles are issued before kv_len arrives (hd 16: all 8, so a
//   block of the (4, 8/2, 2081) plan holds its whole share in flight at once;
//   hd 64: 8 stages, 64 KB a block, two a warp, so a warp's next tile is in
//   flight while it takes this one: 2-5 % faster in a step's graph than
//   64-key tiles in 4 stages, one a warp, which waited a round trip between
//   its tiles). Rows are HD * 2 bytes, read in 16-byte pieces by the LPK =
//   HD / 8 lanes of a key: a quarter warp reads whole 128-byte lines, so no
//   swizzle is needed.
// * Up to MAX_SPLIT = 8 blocks a head group (the portable cluster), as many
//   as fill the card in one wave with every cluster resident: hd 16 16
//   blocks (a non-portable cluster) read 0.0064 against 0.0059 ms a launch
//   in a graph of 81, 4 blocks 0.0065; hd 64 (SeamlessM4T's 64 groups: 3
//   blocks a group) 1, 2, 4 and 16 read the same or slower
//   (tools/hd16_compare.py, H100 80GB HBM3, 700 W). What an hd-64 launch
//   spends (a block timeline, PERF.md section 6): its first tile arrives
//   2.3-2.8 us after the start (the blocks' early loads queue at the
//   memory's rate), its tile loop runs at ~89 % of the HBM rate, the merge
//   and tail add 1.4-2.5 us.
// * Q K^T and P V in f32 on the CUDA cores: lane (j, u) holds columns 8u ..
//   8u + 7 of q (every head of the chunk) and of its keys j, j + KPP, j + 2
//   KPP, ... of a tile (KPP = 32 / LPK keys a warp pass), so a score is 8
//   FMAs and log2(LPK) shuffles (a butterfly: every lane of the key gets the
//   same bits), and P never leaves the lanes that computed it: no P buffer,
//   no bf16 rounding of P. Each lane keeps its own online softmax (m, l,
//   acc) over its keys, updated every CH passes; a key at or past kv_len
//   scores -inf; the lanes of a warp merge by shuffles at the end, then the
//   warps in shared memory. At group 1 a score on the tensor cores would
//   fill 1 of 8 mma columns: the FMAs cost less than the memory's latency
//   hides.
// * The blocks of a cluster merge by pushing: each stores its partial into
//   block 0's shared memory (distributed shared memory) once every block
//   has started (a cluster barrier's first phase, arrived at the start),
//   and after one cluster barrier block 0 merges them from its own shared
//   memory and writes; each block pulling every peer's partial (the
//   kernel above's merge) read 0.0077 ms a launch in a graph, pushing
//   0.0065, at 16 blocks a group (hd 16, two calls of tools/hd16_compare.py).
// * The contract is the kernel above's: one graph-safe launch (kv_len read
//   on the device, the grid from the shapes and the occupancy only), any
//   GQA group through the NREP chunks, strided q/K/V, o in bf16 and the f32
//   LSE, the l == 0 guard, and the watchdog's NaN on a stuck wait.
constexpr int LANES_W = 4;  // consumer warps
constexpr int LANES_THREADS = (LANES_W + 1) * 32;

template <int HD>
struct Lanes;
template <>
struct Lanes<16> {
  static constexpr int TK = 64;         // keys a tile: one TMA box of K, one of V
  static constexpr int ST = 8;          // ring stages
  static constexpr int EARLY = ST;      // tiles a block issues before kv_len is known
  static constexpr int MAX_SPLIT = 8;   // blocks a head group (the portable cluster)
};
template <>
struct Lanes<64> {
  static constexpr int TK = 32;
  static constexpr int ST = 8;
  static constexpr int EARLY = ST;
  static constexpr int MAX_SPLIT = 8;
};

template <int HD>
struct LaneGeo : Lanes<HD> {
  using T = Lanes<HD>;
  static constexpr int LPK = HD / 8;          // lanes a key, 8 columns (16 bytes) each
  static constexpr int KPP = 32 / LPK;        // keys a warp pass
  static constexpr int PASSES = T::TK / KPP;  // passes a tile
  static constexpr int ROW = HD * 2;          // bytes a key's row
  static constexpr int TILE = T::TK * ROW;    // a tile's K (or V) bytes
  static constexpr int STAGE = 2 * TILE;
  static constexpr int RING = T::ST * STAGE;
  static constexpr int PART = (16 + 8 * HD) * 4;  // (m[8], l[8], acc[8][HD])
  static constexpr int GATHER = T::MAX_SPLIT * PART;  // rank 0: every block's partial
  static constexpr int BARS = 2 * T::ST * 8 + 16;     // full, empty, the stuck flag
  static constexpr int TOTAL = 1024 + RING + GATHER + BARS;
  static_assert(T::ST % LANES_W == 0, "every ring stage is used by one consumer warp");
  static_assert(T::EARLY <= T::ST, "the early tiles fit the ring");
  static_assert(LANES_W * PART <= RING, "the warps' partials fit in the ring");
};

// 16 bytes of a bf16 row as 8 floats (element 0 in the low half of a word).
__device__ __forceinline__ void bf16x8(const uint4& w, float (&x)[8]) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(u[i] << 16);
    x[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

// Merge (m, l, acc) of another part into this one (base-2 scores; an empty
// part holds m = -inf, l = 0, acc = 0).
__device__ __forceinline__ void merge_part(float& m, float& l, float (&acc)[8], float mo,
                                           float lo, const float (&ao)[8]) {
  const float mn = fmaxf(m, mo);
  const float ca = m == -INFINITY ? 0.f : exp2f(m - mn);
  const float cb = mo == -INFINITY ? 0.f : exp2f(mo - mn);
  l = l * ca + lo * cb;
#pragma unroll
  for (int c = 0; c < 8; ++c) acc[c] = acc[c] * ca + ao[c] * cb;
  m = mn;
}

// Scores are kept in base 2: s = (q . k) * scale * log2(e).
template <int HD, int NREP>
__global__ void __launch_bounds__(LANES_THREADS)
    decode_attention_lanes_kernel(const __grid_constant__ CUtensorMap kmap,
                                  const __grid_constant__ CUtensorMap vmap, const Params p) {
  using G = LaneGeo<HD>;
  constexpr int TK = G::TK, ST = G::ST, W = LANES_W, LPK = G::LPK, KPP = G::KPP;
  // passes an online-softmax step: fewer at hd 64 for 8 heads, whose
  // scores would not fit the registers beside q and acc
  constexpr int CH = HD == 16 || NREP <= 4 ? 4 : 2;
  static_assert(G::PASSES % CH == 0, "a tile is whole steps");
  extern __shared__ __align__(16) uint8_t lanes_smem_raw[];
  uint8_t* smem = lanes_smem_raw + ((1024 - (smem_addr(lanes_smem_raw) & 1023)) & 1023);
  uint8_t* ring = smem;
  float* gather = reinterpret_cast<float*>(smem + G::RING);  // [split][16 + 8 x HD], rank 0's
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + G::RING + G::GATHER);
  uint64_t* empty = full + ST;
  volatile int* stuck = reinterpret_cast<volatile int*>(empty + ST);

  // blockIdx.y = (b * Hkv + kvh) * n_chunks + chunk, as the kernel above
  constexpr bool CHUNKED = NREP == 8;
  const int split = blockIdx.x, n_split = gridDim.x, gi = blockIdx.y;
  const int n_chunks = CHUNKED ? (p.group + NREP - 1) / NREP : 1;
  const int chunk = CHUNKED ? gi % n_chunks : 0;
  const int bkv = CHUNKED ? gi / n_chunks : gi;
  const int b = bkv / p.Hkv, kvh = bkv % p.Hkv;
  const int h0 = kvh * p.group + chunk * NREP;
  const int valid = CHUNKED ? min(NREP, p.group - chunk * NREP) : NREP;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  const int kv_in = __ldg(p.kv_len);  // waited for where first used
  auto tile_key = [&](int i) { return (split + i * n_split) * TK; };  // tile i's first key
  int kv_len = 0;
  auto count_tiles = [&]() {  // kv_len clamped to [0, S], and this split's tiles
    kv_len = max(0, min(kv_in, p.S));
    const int tiles = (kv_len + TK - 1) / TK;
    return split >= tiles ? 0 : (tiles - split + n_split - 1) / n_split;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 1);
    }
    *stuck = 0;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // this block has started: the cluster barrier's first phase, waited for
  // before the first write into block 0's shared memory
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");

  // lane (j, u): keys j + KPP x of a tile, columns 8u .. 8u + 7
  const int j = lane / LPK, u = lane % LPK;
  float m[NREP], l[NREP], acc[NREP][8];
#pragma unroll
  for (int r = 0; r < NREP; ++r) {
    m[r] = -INFINITY, l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
  }

  if (warp == W) {
    // producer: lane 0 loads each tile's K and V box; the first EARLY tiles
    // of the split that lie in the cache before kv_len is known
    if (lane == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&kmap)) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&vmap)) : "memory");
      auto issue = [&](int i) {
        const int s = i % ST;
        uint8_t* kt = ring + s * G::STAGE;
        mbar_expect_tx(full + s, G::STAGE);
        tma_load_4d(kt, &kmap, full + s, 0, kvh, tile_key(i), b);
        tma_load_4d(kt + G::TILE, &vmap, full + s, 0, kvh, tile_key(i), b);
      };
      int i = 0;
      for (; i < G::EARLY && tile_key(i) < p.S; ++i) issue(i);
      const int ntiles = count_tiles();
      for (; i < ntiles; ++i) {
        if (i >= ST) {  // the stage's previous tile released by its warp
          mbar_wait(empty + i % ST, ((i / ST) & 1) ^ 1, stuck);
          if (*stuck) break;
        }
        issue(i);
      }
      drain_ring<ST>(full, i);
    }
  } else {
    // q of the chunk's heads, this lane's 8 columns, f32
    float qf[NREP][8];
#pragma unroll
    for (int r = 0; r < NREP; ++r) {
      const bf16* qh = p.q + b * p.q_sb + (int64_t)(h0 + min(r, valid - 1)) * p.q_sh + 8 * u;
      bf16x8(*reinterpret_cast<const uint4*>(qh), qf[r]);
#pragma unroll
      for (int c = 0; c < 8; ++c) qf[r][c] = r < valid ? qf[r][c] : 0.f;
    }
    const int ntiles = count_tiles();
    for (int i = warp; i < ntiles; i += W) {
      const int s = i % ST;
      mbar_wait(full + s, (i / ST) & 1, stuck);
      if (__any_sync(0xffffffffu, *stuck)) break;  // warp-uniform: shuffles follow
      const int rows = min(TK, kv_len - tile_key(i));
      const uint8_t* kt = ring + s * G::STAGE;
      const uint8_t* vt = kt + G::TILE;
#pragma unroll
      for (int x0 = 0; x0 < G::PASSES; x0 += CH) {
        float sc[CH][NREP];
#pragma unroll
        for (int x = 0; x < CH; ++x) {
          float kx[8];
          bf16x8(*reinterpret_cast<const uint4*>(kt + ((x0 + x) * KPP + j) * G::ROW + 16 * u),
                 kx);
#pragma unroll
          for (int r = 0; r < NREP; ++r) {
            float d = 0.f;
#pragma unroll
            for (int c = 0; c < 8; ++c) d = fmaf(qf[r][c], kx[c], d);
            sc[x][r] = d;
          }
        }
#pragma unroll
        for (int x = 0; x < CH; ++x)
#pragma unroll
          for (int r = 0; r < NREP; ++r) {
            float d = sc[x][r];
#pragma unroll
            for (int o = 1; o < LPK; o <<= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
            sc[x][r] = (x0 + x) * KPP + j < rows ? d * p.scale_log2 : -INFINITY;
          }
#pragma unroll
        for (int r = 0; r < NREP; ++r) {
          float mx = sc[0][r];
#pragma unroll
          for (int x = 1; x < CH; ++x) mx = fmaxf(mx, sc[x][r]);
          const float mn = fmaxf(m[r], mx);
          const float base = mn == -INFINITY ? 0.f : mn;  // no valid key of the lane yet
          const float alpha = exp2f(m[r] - base);         // m = -inf: 0
          float sum = 0.f;
#pragma unroll
          for (int x = 0; x < CH; ++x) {
            sc[x][r] = exp2f(sc[x][r] - base);
            sum += sc[x][r];
          }
          l[r] = l[r] * alpha + sum;
          m[r] = mn;
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[r][c] *= alpha;
        }
#pragma unroll
        for (int x = 0; x < CH; ++x) {
          float vx[8];
          bf16x8(*reinterpret_cast<const uint4*>(vt + ((x0 + x) * KPP + j) * G::ROW + 16 * u),
                 vx);
#pragma unroll
          for (int r = 0; r < NREP; ++r)
#pragma unroll
            for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(sc[x][r], vx[c], acc[r][c]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + s);
    }
    // the warp's key lanes of each column piece merge by shuffles
#pragma unroll
    for (int o = LPK; o < 32; o <<= 1)
#pragma unroll
      for (int r = 0; r < NREP; ++r) {
        float ao[8];
#pragma unroll
        for (int c = 0; c < 8; ++c) ao[c] = __shfl_xor_sync(0xffffffffu, acc[r][c], o);
        const float mo = __shfl_xor_sync(0xffffffffu, m[r], o);
        const float lo = __shfl_xor_sync(0xffffffffu, l[r], o);
        merge_part(m[r], l[r], acc[r], mo, lo, ao);
      }
  }
  __syncthreads();  // the ring is idle: the warps' partials go there

  float* wm = reinterpret_cast<float*>(ring);  // [W][8]
  float* wl = wm + W * 8;                      // [W][8]
  float* wacc = wl + W * 8;                    // [W][8][HD]
  if (warp < W && j == 0) {
#pragma unroll
    for (int r = 0; r < NREP; ++r) {
      if (u == 0) wm[warp * 8 + r] = m[r], wl[warp * 8 + r] = l[r];
#pragma unroll
      for (int c = 0; c < 8; ++c) wacc[(warp * 8 + r) * HD + 8 * u + c] = acc[r][c];
    }
  }
  __syncthreads();
  // the block's partial, merged over its warps, goes to its slot in the
  // shared memory of the cluster's block 0 (distributed shared memory),
  // once every block of the cluster has started
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
  cg::cluster_group cluster = cg::this_cluster();
  float* slot = cluster.map_shared_rank(gather + split * (16 + 8 * HD), 0);
  for (int i = threadIdx.x; i < valid * HD; i += LANES_THREADS) {
    const int r = i / HD;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < W; ++w) M = fmaxf(M, wm[w * 8 + r]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      if (wm[w * 8 + r] != -INFINITY) {
        const float c = exp2f(wm[w * 8 + r] - M);
        L += wl[w * 8 + r] * c;
        A += wacc[(w * 8 + r) * HD + i % HD] * c;
      }
    }
    slot[16 + i] = *stuck ? NAN : A;
    if (i % HD == 0) slot[r] = M, slot[8 + r] = L;
  }
  cluster.sync();  // every partial is in block 0's shared memory
  if (split != 0) return;  // nothing reads the others' shared memory
  // block 0 merges the (valid heads x HD) outputs from the n_split partials
  for (int i = threadIdx.x; i < valid * HD; i += LANES_THREADS) {
    const int r = i / HD, d = i % HD;
    float M = -INFINITY;
    for (int s = 0; s < n_split; ++s) M = fmaxf(M, gather[s * (16 + 8 * HD) + r]);
    float L = 0.f, A = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float* part = gather + s * (16 + 8 * HD);
      const float c = part[r] == -INFINITY ? 0.f : exp2f(part[r] - M);
      L += part[8 + r] * c;
      A += part[16 + i] * c;
    }
    const float safe = L == 0.f ? 1.f : L;
    const int64_t row = (int64_t)b * p.H + h0 + r;
    p.o[row * HD + d] = __float2bfloat16(A / safe);
    if (d == 0) p.lse[row] = M == -INFINITY ? -1e30f : (M + log2f(safe)) * LN2;
  }
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

// The TMA map of a (B, Hkv, S, hd) bf16 view with element strides
// st = (sb, sh, ss) and a unit last stride: dims (hd, Hkv, S, B), boxes of
// (CW, 1, TK, 1), swizzled as the kernel reads them; rows past S read as
// zeros.
template <int HD>
cudaError_t make_map(CUtensorMap* map, const void* base, int B, int Hkv, int S,
                     const int64_t* st) {
  using G = Smem<HD>;
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)Hkv, (cuuint64_t)(S > 0 ? S : 1),
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st[1] * 2, (cuuint64_t)st[2] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {(cuuint32_t)G::CW, 1, (cuuint32_t)TK, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
      unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      G::SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
      : G::SW == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                    : CU_TENSOR_MAP_SWIZZLE_32B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The launch geometry of one instantiation: split count, dynamic shared
// memory and the scratch the counter merge needs.
struct Plan {
  int n_split, groups, smem, clusters;
  size_t scratch;
};

template <int HD, int NREP>
cudaError_t plan(int B, int H, int Hkv, Plan* out) {
  // queried once: blocks the card holds at once, and (cluster merge) how
  // many clusters of each size up to MAX_SPLIT it runs at once
  static int slots = 0, active[MAX_SPLIT + 1] = {};
  constexpr int smem = Smem<HD>::TOTAL;
  auto kernel = decode_attention_kernel<HD, NREP>;
  if (slots == 0) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess && !PORTABLE)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    int per_sm = 0, sms = 0, dev = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
    if (e != cudaSuccess) return e;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    for (int n = 1; CLUSTER_MERGE && n <= MAX_SPLIT; ++n) {
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = n;
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(n, 1);
      cfg.blockDim = dim3(THREADS);
      cfg.dynamicSmemBytes = smem;
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      e = cudaOccupancyMaxActiveClusters(&active[n], kernel, &cfg);
      if (e != cudaSuccess) return e;
    }
    slots = per_sm * sms > 0 ? per_sm * sms : 1;
  }
  const int group = H / Hkv;
  out->groups = B * Hkv * ((group + NREP - 1) / NREP);
  // as many blocks a head group as fill the card in one wave; with the
  // cluster merge, no more than let every cluster run at once (a cluster
  // that has to wait for a GPC doubles the time)
  int n = max(1, min(MAX_SPLIT, slots / out->groups));
  while (CLUSTER_MERGE && n > 1 && active[n] < out->groups) --n;
  out->n_split = n;
  out->clusters = CLUSTER_MERGE ? active[n] : 0;
  out->smem = smem;
  out->scratch = CLUSTER_MERGE ? 0
                               : (size_t)out->groups * MAX_SPLIT * (16 + 8 * HD) * 4 +
                                     (size_t)out->groups * 4;
  return cudaSuccess;
}

// The TMA map of a (B, Hkv, S, HD) bf16 view for the lanes kernel: boxes of
// (HD, 1, TK, 1), one HD * 2-byte row a key, not swizzled; rows past S read
// as zeros.
template <int HD>
cudaError_t make_map_lanes(CUtensorMap* map, const void* base, int B, int Hkv, int S,
                           const int64_t* st) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {HD, (cuuint64_t)Hkv, (cuuint64_t)(S > 0 ? S : 1), (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st[1] * 2, (cuuint64_t)st[2] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {HD, 1, (cuuint32_t)Lanes<HD>::TK, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The lanes kernel's plan: as plan() with the cluster merge, up to
// MAX_SPLIT blocks a head group (a non-portable size, allowed on the
// kernel, above 8), as many as fill the card in one wave with every
// cluster resident.
template <int HD, int NREP>
cudaError_t plan_lanes(int B, int H, int Hkv, Plan* out) {
  constexpr int MAX_SPLIT = Lanes<HD>::MAX_SPLIT;
  static int slots = 0, active[MAX_SPLIT + 1] = {};
  constexpr int smem = LaneGeo<HD>::TOTAL;
  auto kernel = decode_attention_lanes_kernel<HD, NREP>;
  if (slots == 0) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess && MAX_SPLIT > 8)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    int per_sm = 0, sms = 0, dev = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, LANES_THREADS, smem);
    if (e != cudaSuccess) return e;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    for (int n = 1; n <= MAX_SPLIT; ++n) {
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = n;
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(n, 1);
      cfg.blockDim = dim3(LANES_THREADS);
      cfg.dynamicSmemBytes = smem;
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      e = cudaOccupancyMaxActiveClusters(&active[n], kernel, &cfg);
      if (e != cudaSuccess) return e;
    }
    slots = per_sm * sms > 0 ? per_sm * sms : 1;
  }
  const int group = H / Hkv;
  out->groups = B * Hkv * ((group + NREP - 1) / NREP);
  int n = max(1, min(MAX_SPLIT, slots / max(1, out->groups)));
  while (n > 1 && active[n] < out->groups) --n;
  out->n_split = n;
  out->clusters = active[n];
  out->smem = smem;
  out->scratch = 0;
  return cudaSuccess;
}

struct Args {
  const void *q, *k, *v, *kv_len;
  void *o, *lse, *scratch;
  int B, H, Hkv, S;
  const int64_t* strides;
  float scale_log2;
  cudaStream_t stream;
  Plan* plan_only;  // non-null: report the plan, launch nothing
};

template <int HD, int NREP>
cudaError_t run(const Args& a) {
  Plan pl;
  cudaError_t err = plan<HD, NREP>(a.B, a.H, a.Hkv, &pl);
  if (err != cudaSuccess || a.plan_only) {
    if (a.plan_only) *a.plan_only = pl;
    return err;
  }
  const int64_t* st = a.strides;
  CUtensorMap km, vm;
  if ((err = make_map<HD>(&km, a.k, a.B, a.Hkv, a.S, st + 2)) != cudaSuccess) return err;
  if ((err = make_map<HD>(&vm, a.v, a.B, a.Hkv, a.S, st + 5)) != cudaSuccess) return err;
  Params p{static_cast<const bf16*>(a.q), static_cast<bf16*>(a.o), static_cast<float*>(a.lse),
           static_cast<const int*>(a.kv_len), nullptr, nullptr, a.S, a.H, a.Hkv, a.H / a.Hkv,
           st[0], st[1], a.scale_log2};
  const dim3 grid(pl.n_split, pl.groups);
  if constexpr (CLUSTER_MERGE) {
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = pl.n_split;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = pl.smem;
    cfg.stream = a.stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, decode_attention_kernel<HD, NREP>, km, vm, p);
    return err != cudaSuccess ? err : cudaGetLastError();
  } else {
    if (!a.scratch) return cudaErrorInvalidValue;
    p.part = static_cast<float*>(a.scratch);
    p.count = reinterpret_cast<unsigned*>(p.part + (size_t)pl.groups * MAX_SPLIT * (16 + 8 * HD));
    decode_attention_kernel<HD, NREP><<<grid, THREADS, pl.smem, a.stream>>>(km, vm, p);
    return cudaGetLastError();
  }
}

template <int HD>
cudaError_t dispatch_group(const Args& a) {
  switch (a.H / a.Hkv) {
    case 1: return run<HD, 1>(a);
    case 2: return run<HD, 2>(a);
    case 3: return run<HD, 3>(a);
    case 4: return run<HD, 4>(a);
    default: return run<HD, 8>(a);  // 8, or chunks of 8 heads
  }
}

template <int HD, int NREP>
cudaError_t run_lanes(const Args& a) {
  Plan pl;
  cudaError_t err = plan_lanes<HD, NREP>(a.B, a.H, a.Hkv, &pl);
  if (err != cudaSuccess || a.plan_only) {
    if (a.plan_only) *a.plan_only = pl;
    return err;
  }
  const int64_t* st = a.strides;
  CUtensorMap km, vm;
  if ((err = make_map_lanes<HD>(&km, a.k, a.B, a.Hkv, a.S, st + 2)) != cudaSuccess) return err;
  if ((err = make_map_lanes<HD>(&vm, a.v, a.B, a.Hkv, a.S, st + 5)) != cudaSuccess) return err;
  Params p{static_cast<const bf16*>(a.q), static_cast<bf16*>(a.o), static_cast<float*>(a.lse),
           static_cast<const int*>(a.kv_len), nullptr, nullptr, a.S, a.H, a.Hkv, a.H / a.Hkv,
           st[0], st[1], a.scale_log2};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = pl.n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(pl.n_split, pl.groups);
  cfg.blockDim = dim3(LANES_THREADS);
  cfg.dynamicSmemBytes = pl.smem;
  cfg.stream = a.stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, decode_attention_lanes_kernel<HD, NREP>, km, vm, p);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int HD>
cudaError_t dispatch_lanes(const Args& a) {
  switch (a.H / a.Hkv) {
    case 1: return run_lanes<HD, 1>(a);
    case 2: return run_lanes<HD, 2>(a);
    case 3: return run_lanes<HD, 3>(a);
    case 4: return run_lanes<HD, 4>(a);
    default: return run_lanes<HD, 8>(a);  // 8, or chunks of 8 heads
  }
}

cudaError_t dispatch_hd(int hd, const Args& a) {
  switch (hd) {
    case 16: return dispatch_lanes<16>(a);
    case 32: return dispatch_group<32>(a);
    case 64: return dispatch_lanes<64>(a);
    case 128: return dispatch_group<128>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q: (B, H, hd) bf16 with strides (q_sb, q_sh, 1); k, v: (B, Hkv, S, hd)
// bf16 with strides (sb, sh, ss, 1), any layout. o: contiguous (B, H, hd)
// bf16; lse: contiguous (B, H) f32. kv_len: one int32 in device memory,
// read by the kernel and clamped to [0, S]; only [0, kv_len) is used
// (each split's first tiles are read before kv_len is known).
// scratch: decode_attention_plan's info[4] bytes, zeroed once (null when
// that is 0). strides: q_sb, q_sh, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss in
// elements. hd in {16, 32, 64, 128}; any H / Hkv. One launch; returns
// cudaGetLastError().
int decode_attention_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                         const void* kv_len, void* scratch, int B, int H, int Hkv, int S,
                         int hd, const int64_t* strides, float scale_log2, void* stream) {
  if (Hkv < 1 || H % Hkv != 0) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, kv_len, o, lse, scratch, B, H, Hkv, S, strides, scale_log2,
               static_cast<cudaStream_t>(stream), nullptr};
  return (int)dispatch_hd(hd, a);
}

// The launch a call at this shape makes, whatever kv_len: info[0] the
// split count (blocks per head group, the cluster size when info[3] is 1),
// info[1] the head groups, info[2] the dynamic shared memory of a block,
// info[3] 1 for the cluster merge, 0 for the counter, info[4] the scratch
// bytes the counter merge needs (0 for the cluster), info[5] the clusters
// of that size the card runs at once (0 for the counter).
int decode_attention_plan(int B, int H, int Hkv, int hd, int64_t* info) {
  if (Hkv < 1 || H % Hkv != 0) return (int)cudaErrorInvalidValue;
  Plan pl{};
  const Args a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, B, H, Hkv, 0,
               nullptr, 0.f, nullptr, &pl};
  const cudaError_t err = dispatch_hd(hd, a);
  info[0] = pl.n_split, info[1] = pl.groups, info[2] = pl.smem;
  info[3] = CLUSTER_MERGE || hd == 16 || hd == 64 ? 1 : 0, info[4] = (int64_t)pl.scratch,
  info[5] = pl.clusters;
  return (int)err;
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
