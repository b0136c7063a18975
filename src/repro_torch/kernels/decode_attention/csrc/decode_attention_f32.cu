// Decode attention in float32 for Hopper (sm_90a) on the CUDA cores: one
// graph-safe launch per call.
//
// Replaces, for a float32 q: src/repro/kernels/decode_attention/kernel.py,
// decode_attention_fwd (the pallas_call at kernel.py:89), as
// decode_attention.cu does for bfloat16. The cache is float32, or bfloat16
// as a float32 model keeps it (its K/V cache is bf16 whatever the compute
// dtype, as the reference's), read as f32. One query token per sequence
// attends over the first kv_len positions of a KV cache, query head h
// reading kv head h // n_rep (any group); f32 online softmax; returns o and
// the f32 log-sum-exp, with the kernel's l == 0 guard (o = 0, lse = -1e30
// where no position is valid).
//
// Why the CUDA cores: the reference holds float32 to 2e-5; TF32 products
// would miss it, and the work is ~4 flops per bf16 cache byte at GQA 4, far
// below what the CUDA cores do per byte. Bound on this card: bytes, each
// valid K and V row read once. At mistral_nemo_12b's float32 decode (1
// sequence, 32 query heads on 8 kv heads, ~2080 positions, hd 128, a bf16
// cache) that is 8.5 MB, 2.5 us at 3.35 TB/s.
//
// Design (the bf16 kernel's, decode_attention.cu, on the CUDA cores):
// * One read of K/V per group. A block serves every query head of a kv head
//   (NREP heads; groups 1, 2, 3, 4 and 8 as they are, any other in chunks
//   of 8 heads, each chunk reading its kv head), so each valid K and V row
//   is read once and used for NREP dot products and NREP P V updates.
// * Split over the keys, graph-safe. n_split blocks per (sequence, head
//   group) form one thread-block cluster along x; block `split` takes tiles
//   split, split + n_split, ... of the TK-key tiles of [0, kv_len). kv_len is
//   read from device memory by every block and clamped to [0, S]; the grid
//   (n_split, groups) depends on B, H, Hkv, hd and the kernel's occupancy
//   only (plan below), never on kv_len, so one captured launch stays right
//   while the position advances between replays. Up to 16 blocks a group (a
//   non-portable cluster size), as many as fill the card in one wave with
//   every cluster resident: at one sequence of 8 kv heads, 9 blocks a group
//   (72 blocks of one an SM; clusters of more fit on fewer than 8 GPCs at
//   once). Variants that put 128 blocks on the card, two an SM (warps-4,
//   lanes-x2 in tools/decode_f32_compare.py), read 6-9 % slower there: the
//   launch and the merges, not the streaming, take most of the time (the
//   variant no-loads: 0.0091 of 0.0171 ms on an H100 80GB HBM3, 700 W).
//   An empty part contributes (m = -inf, l = 0).
// * Bytes in flight: each of the NW warps streams its own tiles (block tiles
//   warp, warp + NW, ...) through its own ring of STW stages by cp.async, 16
//   bytes a copy, zero-filled past S; a stage is ~9 KB (TK rows of K and of
//   V), so a block keeps NW x STW stages, ~147 KB, in flight, where the
//   previous kernel had one dependent load per warp step. cp.async, not
//   TMA: the rows are f32 or bf16 behind any strides (the model's cache is
//   read through a transposed view), the products read them on the CUDA
//   cores in any layout, and a warp's ring needs no barrier but its own
//   cp.async.wait_group and a __syncwarp: no mbarrier, so no wait that can
//   hang (and no watchdog). The first STW tiles of each warp are issued
//   before kv_len, a dependent read from device memory, is known; a tile at
//   or past kv_len is then loaded and not used.
// * Q K^T: LPK lanes a key (one 128-byte span of the row each, as
//   interleaved 16-byte chunks), TK = 32 / LPK keys a tile; q of the group's
//   heads, scaled by scale * log2(e), sits in shared memory and is read by
//   broadcast; each key's score is summed over its LPK lanes by shuffles.
//   Rows are padded by 16 LPK bytes, so the 8 lanes of each 16-byte phase
//   meet distinct banks.
// * The online softmax per head in the log2 domain (exp2f): the tile's max
//   by shuffles, the sums per lane until the end.
// * P V: each lane owns E = hd / 32 columns of every head's accumulator
//   (hd 16: 16 lanes a row, the warp's halves on even and odd keys, added at
//   the end); a tile's P goes through a TK x 8 buffer of the warp.
// * Products: f32 FMA, never TF32.
// * Merge in one launch: the warps of a block merge in shared memory (the
//   idle ring); then each block of the cluster merges a slice of the group's
//   outputs from every block's partial (m, l, acc) through distributed
//   shared memory, which beat a counter merge for the bf16 kernel (0.0271
//   against 0.0395 ms, tools/decode_variants.py, H100 80GB HBM3, 700 W).
// * ptxas (sm_90a; no spill): 86-177 registers over the 40 instantiations
//   (hd 16, 32, 64, 128 x NREP 1, 2, 3, 4, 8 x a bf16 or f32 cache);
//   dynamic shared memory 58,432 (hd 16, bf16) to 159,808 bytes (hd 128,
//   bf16): one block an SM at hd 128.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NW = 8;              // warps a block, each with its own ring
constexpr int THREADS = NW * 32;
constexpr int STW = 2;             // ring stages a warp
constexpr int MAX_SPLIT = 16;      // blocks a head group: the largest cluster (non-portable)
constexpr float LN2 = 0.6931471805599453f;

// Shared memory of one block for hd HD and cache element KV: the warps'
// rings, q of the chunk's heads, the warps' P buffers and the block's
// partial (m[8], l[8], acc[8][HD]).
template <int HD, typename KV>
struct Geo {
  static_assert(HD == 16 || HD == 32 || HD == 64 || HD == 128, "hd in {16, 32, 64, 128}");
  static constexpr int ROW = HD * (int)sizeof(KV);       // bytes of a cache row
  static constexpr int LPK = ROW > 128 ? ROW / 128 : 1;  // lanes a key in Q K^T
  static constexpr int TK = 32 / LPK;                    // keys a tile
  static constexpr int VE = 16 / (int)sizeof(KV);        // values in 16 bytes
  static constexpr int NCH = ROW / 16 / LPK;             // 16-byte chunks a lane in Q K^T
  static constexpr int ROWB = ROW + 16 * LPK;            // bytes a row in shared memory
  static constexpr int TILE = TK * ROWB;                 // a tile's K (or V)
  static constexpr int STAGE = 2 * TILE;
  static constexpr int RING = NW * STW * STAGE;
  // P V's lane map: E columns a lane, LPR lanes a row, RPW rows a warp at once
  static constexpr int E = HD >= 32 ? HD / 32 : 1;
  static constexpr int LPR = HD / E;
  static constexpr int RPW = 32 / LPR;
  static constexpr int QBYTES = 8 * HD * 4;
  static constexpr int PBUF = TK * 8 * 4;
  static constexpr int PART = (16 + 8 * HD) * 4;
  static constexpr int TOTAL = RING + QBYTES + NW * PBUF + PART;
  static_assert(NW * PART <= RING, "the warps' partials fit in the ring");
  static_assert(TK * (ROW / 16) % 32 == 0, "a tile is whole 16-byte copies for every lane");
};

// ---- cp.async
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 16 bytes of a cache row as f32: 4 floats, or 8 bf16 (element 0 in the low
// half of a word).
__device__ __forceinline__ void to_float(const uint4& w, float (&x)[4]) {
  x[0] = __uint_as_float(w.x), x[1] = __uint_as_float(w.y);
  x[2] = __uint_as_float(w.z), x[3] = __uint_as_float(w.w);
}
__device__ __forceinline__ void to_float(const uint4& w, float (&x)[8]) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(u[i] << 16);
    x[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

// E consecutive values of a cache row (aligned to their size) as f32.
template <int E>
__device__ __forceinline__ void load_vals(const float* src, float (&x)[E]) {
  if constexpr (E == 4) {
    const float4 t = *reinterpret_cast<const float4*>(src);
    x[0] = t.x, x[1] = t.y, x[2] = t.z, x[3] = t.w;
  } else if constexpr (E == 2) {
    const float2 t = *reinterpret_cast<const float2*>(src);
    x[0] = t.x, x[1] = t.y;
  } else {
    x[0] = *src;
  }
}
template <int E>
__device__ __forceinline__ void load_vals(const __nv_bfloat16* src, float (&x)[E]) {
  if constexpr (E == 4) {
    const uint2 t = *reinterpret_cast<const uint2*>(src);
    x[0] = __uint_as_float(t.x << 16), x[1] = __uint_as_float(t.x & 0xffff0000u);
    x[2] = __uint_as_float(t.y << 16), x[3] = __uint_as_float(t.y & 0xffff0000u);
  } else if constexpr (E == 2) {
    const uint32_t t = *reinterpret_cast<const uint32_t*>(src);
    x[0] = __uint_as_float(t << 16), x[1] = __uint_as_float(t & 0xffff0000u);
  } else {
    x[0] = __uint_as_float((uint32_t)*reinterpret_cast<const unsigned short*>(src) << 16);
  }
}

struct Params {
  const float* q;
  const void *k, *v;  // float or bf16
  float *o, *lse;
  const int* kv_len;
  int S, H, Hkv, group;
  int64_t q_sb, q_sh, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  float scale_log2;
};

// KV the cache's element type (float or __nv_bfloat16); NREP the query
// heads a block serves (8: a chunk of up to 8 heads of a larger group).
// Scores are kept in base 2: s = (q . k) * scale * log2(e).
template <int HD, int NREP, typename KV>
__global__ void __launch_bounds__(THREADS, 1) decode_f32_kernel(const Params p) {
  using G = Geo<HD, KV>;
  constexpr int TK = G::TK, LPK = G::LPK, VE = G::VE, E = G::E;
  extern __shared__ float4 dec_smem[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(dec_smem);
  float* qs = reinterpret_cast<float*>(ring + G::RING);  // [NREP][HD], scaled
  float* pbuf = qs + 8 * HD;                             // [NW][TK][8]
  float* bm = pbuf + NW * TK * 8;                        // the block's partial
  float* bl = bm + 8;
  float* bacc = bm + 16;

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
  const KV* kb = static_cast<const KV*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const KV* vb = static_cast<const KV*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  auto tile_key = [&](int i) { return (split + i * n_split) * TK; };  // block tile i's first key
  uint8_t* wring = ring + warp * STW * G::STAGE;
  // block tile i's K and V rows into this warp's stage st, rows past S as zeros
  auto issue = [&](int i, int st) {
    uint8_t* dst = wring + st * G::STAGE;
    const int key0 = tile_key(i);
    constexpr int CPR = G::ROW / 16;  // copies a row
#pragma unroll
    for (int x = lane; x < TK * CPR; x += 32) {
      const int r = x / CPR, ch = x % CPR;
      const bool ok = key0 + r < p.S;
      const int64_t key = ok ? key0 + r : 0;
      cp_async16(dst + r * G::ROWB + ch * 16, kb + key * p.k_ss + ch * VE, ok);
      cp_async16(dst + G::TILE + r * G::ROWB + ch * 16, vb + key * p.v_ss + ch * VE, ok);
    }
  };
#pragma unroll
  for (int st = 0; st < STW; ++st) {
    if (tile_key(warp + st * NW) < p.S) issue(warp + st * NW, st);
    cp_async_commit();
  }
  for (int x = threadIdx.x; x < NREP * HD; x += THREADS) {
    const int r = x / HD;
    qs[x] = r < valid ? p.q[b * p.q_sb + (int64_t)(h0 + r) * p.q_sh + x % HD] * p.scale_log2
                      : 0.f;
  }
  __syncthreads();

  const int kv_len = min(max(kv_in, 0), p.S);
  const int tiles = (kv_len + TK - 1) / TK;
  const int ntiles = split < tiles ? (tiles - split + n_split - 1) / n_split : 0;

  float m[NREP], l[NREP], acc[NREP][E];
#pragma unroll
  for (int r = 0; r < NREP; ++r) {
    m[r] = -INFINITY, l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[r][e] = 0.f;
  }
  const int j = lane / LPK, u = lane % LPK;  // Q K^T: this lane's key and part of it
  float* pb = pbuf + warp * TK * 8;
  const int col = lane % G::LPR * E;          // P V: this lane's first column
  for (int t = 0;; ++t) {
    const int i = warp + t * NW;
    if (i >= ntiles) break;
    const int st = t % STW;
    cp_async_wait<STW - 1>();  // this lane's copies of tile i landed
    __syncwarp();              // and the other lanes'
    const uint8_t* kt = wring + st * G::STAGE;
    const uint8_t* vt = kt + G::TILE;
    const int rows = min(TK, kv_len - tile_key(i));

    // S: lane (j, u) sums the 16-byte chunks u, u + LPK, ... of key j
    float s[NREP];
#pragma unroll
    for (int r = 0; r < NREP; ++r) s[r] = 0.f;
#pragma unroll
    for (int x = 0; x < G::NCH; ++x) {
      const int ch = u + x * LPK;
      float kx[VE];
      to_float(*reinterpret_cast<const uint4*>(kt + j * G::ROWB + ch * 16), kx);
#pragma unroll
      for (int r = 0; r < NREP; ++r) {
        const float4* qr = reinterpret_cast<const float4*>(qs + r * HD + ch * VE);
#pragma unroll
        for (int w = 0; w < VE / 4; ++w) {
          const float4 qv = qr[w];
          s[r] = fmaf(qv.x, kx[4 * w], s[r]);
          s[r] = fmaf(qv.y, kx[4 * w + 1], s[r]);
          s[r] = fmaf(qv.z, kx[4 * w + 2], s[r]);
          s[r] = fmaf(qv.w, kx[4 * w + 3], s[r]);
        }
      }
    }
#pragma unroll
    for (int o = 1; o < LPK; o <<= 1)
#pragma unroll
      for (int r = 0; r < NREP; ++r) s[r] += __shfl_xor_sync(0xffffffffu, s[r], o);

    // the online softmax; a key at or past kv_len scores -inf
    float alpha[NREP];
#pragma unroll
    for (int r = 0; r < NREP; ++r) {
      const float sr = j < rows ? s[r] : -INFINITY;
      float mx = sr;
#pragma unroll
      for (int o = LPK; o < 32; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float mn = fmaxf(m[r], mx);  // finite: key 0 of a tile is valid
      alpha[r] = exp2f(m[r] - mn);       // m = -inf: 0
      s[r] = exp2f(sr - mn);
      l[r] = l[r] * alpha[r] + (u == 0 ? s[r] : 0.f);
      m[r] = mn;
    }
    if (u == 0) {
      float pr[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) pr[r] = r < NREP ? s[r] : 0.f;
      reinterpret_cast<float4*>(pb + j * 8)[0] = make_float4(pr[0], pr[1], pr[2], pr[3]);
      if (NREP > 4)
        reinterpret_cast<float4*>(pb + j * 8)[1] = make_float4(pr[4], pr[5], pr[6], pr[7]);
    }
    __syncwarp();

    // O = O alpha + P V over the tile's first `rows` keys, this lane's columns
#pragma unroll
    for (int r = 0; r < NREP; ++r)
#pragma unroll
      for (int e = 0; e < E; ++e) acc[r][e] *= alpha[r];
#pragma unroll 8
    for (int j0 = 0; j0 < TK; j0 += G::RPW) {
      const int jj = j0 + lane / G::LPR;
      if (jj < rows) {
        float vx[E], pr[8];
        load_vals<E>(reinterpret_cast<const KV*>(vt + jj * G::ROWB) + col, vx);
        const float4 p0 = reinterpret_cast<const float4*>(pb + jj * 8)[0];
        pr[0] = p0.x, pr[1] = p0.y, pr[2] = p0.z, pr[3] = p0.w;
        if (NREP > 4) {
          const float4 p1 = reinterpret_cast<const float4*>(pb + jj * 8)[1];
          pr[4] = p1.x, pr[5] = p1.y, pr[6] = p1.z, pr[7] = p1.w;
        }
#pragma unroll
        for (int r = 0; r < NREP; ++r)
#pragma unroll
          for (int e = 0; e < E; ++e) acc[r][e] = fmaf(pr[r], vx[e], acc[r][e]);
      }
    }
    __syncwarp();  // every lane is done with the stage and with P
    if (i + STW * NW < ntiles) issue(i + STW * NW, st);
    cp_async_commit();
  }
  cp_async_wait<0>();  // no copy into the ring is left in flight (the first
                       // tiles may lie past kv_len)
#pragma unroll
  for (int o = 1; o < 32; o <<= 1)
#pragma unroll
    for (int r = 0; r < NREP; ++r) l[r] += __shfl_xor_sync(0xffffffffu, l[r], o);
  // the rows the warp's halves took apart (hd 16): lane and lane + LPR hold
  // the same columns
#pragma unroll
  for (int o = G::LPR; o < 32; o <<= 1)
#pragma unroll
    for (int r = 0; r < NREP; ++r)
#pragma unroll
      for (int e = 0; e < E; ++e) acc[r][e] += __shfl_xor_sync(0xffffffffu, acc[r][e], o);
  __syncthreads();  // the ring is idle: the warps' partials go there

  float* wm = reinterpret_cast<float*>(ring);  // [NW][8]
  float* wl = wm + NW * 8;                     // [NW][8]
  float* wacc = wl + NW * 8;                   // [NW][8][HD]
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < NREP; ++r) wm[warp * 8 + r] = m[r], wl[warp * 8 + r] = l[r];
  }
  if (lane < G::LPR) {
#pragma unroll
    for (int r = 0; r < NREP; ++r)
#pragma unroll
      for (int e = 0; e < E; ++e) wacc[(warp * 8 + r) * HD + col + e] = acc[r][e];
  }
  __syncthreads();
  for (int x = threadIdx.x; x < valid * HD; x += THREADS) {
    const int r = x / HD;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < NW; ++w) M = fmaxf(M, wm[w * 8 + r]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      if (wm[w * 8 + r] != -INFINITY) {
        const float c = exp2f(wm[w * 8 + r] - M);
        L += wl[w * 8 + r] * c;
        A += wacc[(w * 8 + r) * HD + x % HD] * c;
      }
    }
    bacc[x] = A;
    if (x % HD == 0) bm[r] = M, bl[r] = L;
  }

  // Merge the n_split partials of this head group: each block of the cluster
  // merges a slice of the (valid heads x HD) outputs, every peer's (m, l,
  // acc) read in one unrolled round, all in flight at once; an empty part
  // holds (-inf, 0, 0).
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every block's partial is in its shared memory
  const int n = valid * HD, per = (n + n_split - 1) / n_split;
  const int lo = (int)cluster.block_rank() * per, hi = min(n, lo + per);
  for (int x = lo + threadIdx.x; x < hi; x += THREADS) {
    const int r = x / HD, d = x % HD;
    float ms[MAX_SPLIT], ls[MAX_SPLIT], as[MAX_SPLIT], M = -INFINITY;
#pragma unroll
    for (int s = 0; s < MAX_SPLIT; ++s) {
      const bool in = s < n_split;
      ms[s] = in ? *cluster.map_shared_rank(bm + r, s) : -INFINITY;
      ls[s] = in ? *cluster.map_shared_rank(bl + r, s) : 0.f;
      as[s] = in ? *cluster.map_shared_rank(bacc + x, s) : 0.f;
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
    p.o[row * HD + d] = A / safe;
    if (d == 0) p.lse[row] = M == -INFINITY ? -1e30f : (M + log2f(safe)) * LN2;
  }
  cluster.sync();  // the peers' shared memory outlives their readers
}

// The launch geometry of one instantiation.
struct Plan {
  int n_split, groups, smem, clusters;
};

template <int HD, int NREP, typename KV>
cudaError_t plan(int B, int H, int Hkv, Plan* out) {
  // queried once: blocks the card holds at once, and how many clusters of
  // each size up to MAX_SPLIT it runs at once
  static int slots = 0, active[MAX_SPLIT + 1] = {};
  constexpr int smem = Geo<HD, KV>::TOTAL;
  auto kernel = decode_f32_kernel<HD, NREP, KV>;
  if (slots == 0) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    int per_sm = 0, sms = 0, dev = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
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
  // as many blocks a head group as fill the card in one wave, and no more
  // than let every cluster run at once (a cluster that has to wait for a
  // GPC doubles the time)
  int n = max(1, min(MAX_SPLIT, slots / out->groups));
  while (n > 1 && active[n] < out->groups) --n;
  out->n_split = n;
  out->clusters = active[n];
  out->smem = smem;
  return cudaSuccess;
}

struct Args {
  const void *q, *k, *v, *kv_len;
  void *o, *lse;
  int B, H, Hkv, S;
  const int64_t* strides;
  float scale_log2;
  cudaStream_t stream;
  Plan* plan_only;  // non-null: report the plan, launch nothing
};

template <int HD, int NREP, typename KV>
cudaError_t run(const Args& a) {
  Plan pl;
  cudaError_t err = plan<HD, NREP, KV>(a.B, a.H, a.Hkv, &pl);
  if (err != cudaSuccess || a.plan_only) {
    if (a.plan_only) *a.plan_only = pl;
    return err;
  }
  const int64_t* st = a.strides;
  Params p{static_cast<const float*>(a.q), a.k, a.v, static_cast<float*>(a.o),
           static_cast<float*>(a.lse), static_cast<const int*>(a.kv_len), a.S, a.H, a.Hkv,
           a.H / a.Hkv, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], a.scale_log2};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = pl.n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(pl.n_split, pl.groups);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = pl.smem;
  cfg.stream = a.stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, decode_f32_kernel<HD, NREP, KV>, p);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int HD, typename KV>
cudaError_t dispatch_group(const Args& a) {
  switch (a.H / a.Hkv) {
    case 1: return run<HD, 1, KV>(a);
    case 2: return run<HD, 2, KV>(a);
    case 3: return run<HD, 3, KV>(a);
    case 4: return run<HD, 4, KV>(a);
    default: return run<HD, 8, KV>(a);  // 8, or chunks of 8 heads
  }
}

template <typename KV>
cudaError_t dispatch_hd(int hd, const Args& a) {
  switch (hd) {
    case 16: return dispatch_group<16, KV>(a);
    case 32: return dispatch_group<32, KV>(a);
    case 64: return dispatch_group<64, KV>(a);
    case 128: return dispatch_group<128, KV>(a);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch(int hd, bool bf16_cache, const Args& a) {
  return bf16_cache ? dispatch_hd<__nv_bfloat16>(hd, a) : dispatch_hd<float>(hd, a);
}

}  // namespace

extern "C" {

// q: (B, H, hd) float32 with strides (q_sb, q_sh, 1); k, v: (B, Hkv, S, hd)
// float32 (bf16_cache 0) or bfloat16 (bf16_cache 1), both of one dtype,
// with strides (sb, sh, ss, 1), rows on 16 bytes. o: contiguous
// (B, H, hd) float32; lse: contiguous (B, H) float32. kv_len: one int32 in
// device memory, read by the kernel and clamped to [0, S]; only [0, kv_len)
// is used (each warp's first tiles are read before kv_len is known).
// strides: q_sb, q_sh, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss in elements. hd in
// {16, 32, 64, 128}; any H / Hkv. One launch; returns cudaGetLastError().
int decode_attention_f32_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                             const void* kv_len, int B, int H, int Hkv, int S, int hd,
                             int bf16_cache, const int64_t* strides, float scale_log2,
                             void* stream) {
  if (Hkv < 1 || H % Hkv != 0 || B * H == 0) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, kv_len, o, lse, B, H, Hkv, S, strides, scale_log2,
               static_cast<cudaStream_t>(stream), nullptr};
  return (int)dispatch(hd, bf16_cache != 0, a);
}

// The launch a call at this shape makes, whatever kv_len: info[0] the split
// count (blocks per head group, the cluster size), info[1] the head groups,
// info[2] the dynamic shared memory of a block, info[3] the clusters of that
// size the card runs at once.
int decode_attention_f32_plan(int B, int H, int Hkv, int hd, int bf16_cache, int64_t* info) {
  if (Hkv < 1 || H % Hkv != 0) return (int)cudaErrorInvalidValue;
  Plan pl{};
  const Args a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, B, H, Hkv, 0,
               nullptr, 0.f, nullptr, &pl};
  const cudaError_t err = dispatch(hd, bf16_cache != 0, a);
  info[0] = pl.n_split, info[1] = pl.groups, info[2] = pl.smem, info[3] = pl.clusters;
  return (int)err;
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
