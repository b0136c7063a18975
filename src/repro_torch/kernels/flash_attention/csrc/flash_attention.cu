// FlashAttention-2 for Hopper (sm_90a), bf16 in, f32 softmax: the forward,
// the forward with a per-row LSE, and the two backward kernels.
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
// cores (989 TFLOP/s dense) and not its memory become the limit.
//
// Design (FlashAttention-2 with warp-level tensor-core MMAs):
// * A block owns 64 query rows of one (batch, head); each of its 4 warps
//   owns 16 rows. Q is staged once through shared memory into registers as
//   mma.sync m16n8k16 A fragments.
// * K and V stream through shared memory in tiles of 64 keys, two stages
//   deep: cp.async brings the next tile while the warps compute on this
//   one. ldmatrix (transposing for V) turns the tiles into B fragments.
//   S = Q K^T and O += P V are mma.sync.m16n8k16 bf16 products with f32
//   accumulators; the accumulator layout is known, so the online-softmax
//   rescale of each row happens in registers and P goes from the S
//   accumulators straight into A fragments for the PV product, never
//   through memory.
// * Rows of shared memory are padded by 8 elements, which keeps the
//   fragment reads free of bank conflicts.
// * Q, K, V and O are addressed through strides, so the model's (B, S, H, hd)
//   activations need no transposed copy. Ragged Sq and Sk are masked in the
//   kernel (zero-filled tiles, -inf scores), so no length has to be a
//   multiple of a tile.
// * Causal blocks are launched heaviest first (last query rows first) so
//   the long blocks do not trail at the end of the grid.
// * With LSE the kernel keeps m in the log2 domain (scores times
//   scale * log2 e, for exp2f), so LSE = (m2 + log2 l) * ln 2.
// Not yet here: TMA and wgmma (warpgroup products from shared memory).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;    // query rows per block
constexpr int BN = 64;    // keys per tile
constexpr int NWARP = 4;  // 16 query rows per warp
constexpr int PAD = 8;    // elements of padding per shared-memory row
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

__device__ __forceinline__ uint32_t ld32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
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

template <int HD, bool LSE>
__global__ void __launch_bounds__(NWARP * 32)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                 float* __restrict__ lse, int H,
                 int Hkv, int Sq, int Sk, int causal, float scale_log2, int64_t q_sb,
                 int64_t q_sh, int64_t q_ss, int64_t k_sb, int64_t k_sh, int64_t k_ss,
                 int64_t v_sb, int64_t v_sh, int64_t v_ss, int64_t o_sb, int64_t o_sh,
                 int64_t o_ss) {
  constexpr int LDS = HD + PAD;
  constexpr int KSTEPS = HD / 16;  // k-steps of Q K^T
  constexpr int NT = BN / 8;       // 8-key column tiles of S
  constexpr int DT = HD / 8;       // 8-wide column tiles of O
  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* Qs = smem;
  uint16_t* kv = Qs + BM * LDS;  // stage s: K tile at kv + s * STAGE, V tile after it
  constexpr int STAGE = 2 * BN * LDS;

  const int m0 = (gridDim.x - 1 - blockIdx.x) * BM;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int kvh = h / (H / Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group, column pair

  const __nv_bfloat16* kg = k + b * k_sb + kvh * k_sh;
  const __nv_bfloat16* vg = v + b * v_sb + kvh * v_sh;
  const int n_end = causal ? min(Sk, m0 + BM) : Sk;
  load_tile<HD, BM>(Qs, q + b * q_sb + h * q_sh, q_ss, m0, Sq - m0);
  if (n_end > 0) {  // the first K/V tile, in flight with Q
    load_tile<HD, BN>(kv, kg, k_ss, 0, Sk);
    load_tile<HD, BN>(kv + BN * LDS, vg, v_ss, 0, Sk);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int r0 = warp * 16 + g;  // this thread's rows r0 and r0 + 8 of the block
  uint32_t qa[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const uint16_t* p = Qs + r0 * LDS + kk * 16 + 2 * t;
    qa[kk][0] = ld32(p);
    qa[kk][1] = ld32(p + 8 * LDS);
    qa[kk][2] = ld32(p + 8);
    qa[kk][3] = ld32(p + 8 * LDS + 8);
  }

  float oacc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d) oacc[d][0] = oacc[d][1] = oacc[d][2] = oacc[d][3] = 0.f;
  float mrow[2] = {-INFINITY, -INFINITY}, lrow[2] = {0.f, 0.f};
  const int qrow[2] = {m0 + r0, m0 + r0 + 8};
  // ldmatrix row addresses of this lane: matrix lane / 8, row lane % 8
  const int ld_row = lane & 7, ld_mat = lane >> 3;

  for (int n0 = 0, it = 0; n0 < n_end; n0 += BN, ++it) {
    const uint16_t* Ks = kv + (it & 1) * STAGE;
    const uint16_t* Vs = Ks + BN * LDS;
    if (n0 + BN < n_end) {  // next tile into the other stage, in flight
      uint16_t* nxt = kv + ((it + 1) & 1) * STAGE;
      load_tile<HD, BN>(nxt, kg, k_ss, n0 + BN, Sk - n0 - BN);
      load_tile<HD, BN>(nxt + BN * LDS, vg, v_ss, n0 + BN, Sk - n0 - BN);
    }
    cp_async_commit();

    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; kk += 2) {
        // K rows j*8.., hd columns kk*16 + {0, 8, 16, 24}: b0, b1 of kk, kk+1
        uint32_t kb[4];
        ldmatrix_x4<false>(kb, Ks + (j * 8 + ld_row) * LDS + kk * 16 + ld_mat * 8);
        mma_bf16(s[j], qa[kk], kb[0], kb[1]);
        mma_bf16(s[j], qa[kk + 1], kb[2], kb[3]);
      }
    }

    const bool mask = (n0 + BN > Sk) || (causal && n0 + BN - 1 > m0);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float val = s[j][e] * scale_log2;
        if (mask) {
          const int key = n0 + j * 8 + 2 * t + (e & 1);
          if (key >= Sk || (causal && key > qrow[e >> 1])) val = -INFINITY;
        }
        s[j][e] = val;
        mx[e >> 1] = fmaxf(mx[e >> 1], val);
      }
    }
    float base[2], alpha[2], ls[2] = {0.f, 0.f};
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      mx[rh] = fmaxf(mx[rh], __shfl_xor_sync(0xffffffffu, mx[rh], 1));
      mx[rh] = fmaxf(mx[rh], __shfl_xor_sync(0xffffffffu, mx[rh], 2));
      const float m_new = fmaxf(mrow[rh], mx[rh]);
      base[rh] = (m_new == -INFINITY) ? 0.f : m_new;  // a row with no key yet
      alpha[rh] = exp2f(mrow[rh] - base[rh]);
      mrow[rh] = m_new;
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - base[e >> 1]);
        ls[e >> 1] += s[j][e];
      }
    }
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) lrow[rh] = lrow[rh] * alpha[rh] + ls[rh];
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      oacc[d][0] *= alpha[0];
      oacc[d][1] *= alpha[0];
      oacc[d][2] *= alpha[1];
      oacc[d][3] *= alpha[1];
    }

#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int d = 0; d < DT; d += 2) {
        // V rows kk*16 + {0, 8} + .., hd columns d*8, (d+1)*8, transposed:
        // b0, b1 of output tiles d and d + 1
        uint32_t vb[4];
        ldmatrix_x4<true>(vb, Vs + (kk * 16 + (ld_mat & 1) * 8 + ld_row) * LDS +
                                  (d + (ld_mat >> 1)) * 8);
        mma_bf16(oacc[d], pa, vb[0], vb[1]);
        mma_bf16(oacc[d + 1], pa, vb[2], vb[3]);
      }
    }
    cp_async_wait<0>();  // the next tile has landed
    __syncthreads();     // and every warp is done with this one
  }

  float inv[2];
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    float l = lrow[rh];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[rh] = (l == 0.f) ? 1.f : 1.f / l;  // fully masked rows -> 0
    if (LSE && t == 0 && qrow[rh] < Sq)     // m is per row, log2 domain
      lse[(int64_t)blockIdx.y * Sq + qrow[rh]] =
          (l == 0.f ? mrow[rh] : mrow[rh] + log2f(l)) * LN2;
  }
  __nv_bfloat16* ob = o + b * o_sb + h * o_sh + 2 * t;
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    if (qrow[rh] < Sq) {
      __nv_bfloat16* orow = ob + (int64_t)qrow[rh] * o_ss;
#pragma unroll
      for (int d = 0; d < DT; ++d)
        *reinterpret_cast<__nv_bfloat162*>(orow + d * 8) = __floats2bfloat162_rn(
            oacc[d][2 * rh] * inv[rh], oacc[d][2 * rh + 1] * inv[rh]);
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

template <int HD, bool LSE>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                   int H, int Hkv, int Sq, int Sk, int causal, float scale_log2,
                   const int64_t* st, cudaStream_t stream) {
  const size_t smem = (size_t)(BM + 4 * BN) * (HD + PAD) * sizeof(uint16_t);
  static bool configured = false;
  cudaError_t err = allow_smem(flash_fwd_kernel<HD, LSE>, smem, configured);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BM - 1) / BM, B * H);
  flash_fwd_kernel<HD, LSE><<<grid, NWARP * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse, H, Hkv, Sq,
      Sk, causal, scale_log2, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11]);
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
