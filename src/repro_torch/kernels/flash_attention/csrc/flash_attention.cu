// FlashAttention forward for Hopper (sm_90a), bf16 in, f32 softmax.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py, flash_attention_fwd
// (Pallas body _fa_kernel): causal or full GQA attention with an online
// softmax; the kv head of query head h is h // n_rep (no repeated K/V);
// tiles above the causal diagonal are skipped; fully masked rows give 0.
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

template <int HD>
__global__ void __launch_bounds__(NWARP * 32)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int H,
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

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int H,
                   int Hkv, int Sq, int Sk, int causal, float scale_log2, const int64_t* st,
                   cudaStream_t stream) {
  const size_t smem = (size_t)(BM + 4 * BN) * (HD + PAD) * sizeof(uint16_t);
  static bool configured = false;  // once per process, and never inside a
  if (!configured) {               // CUDA graph capture after the first call
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((Sq + BM - 1) / BM, B * H);
  flash_fwd_kernel<HD><<<grid, NWARP * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), H, Hkv, Sq, Sk,
      causal, scale_log2, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], st[11]);
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
    case 32: return launch<32>(q, k, v, o, B, H, Hkv, Sq, Sk, causal, scale_log2, strides, s);
    case 64: return launch<64>(q, k, v, o, B, H, Hkv, Sq, Sk, causal, scale_log2, strides, s);
    case 128: return launch<128>(q, k, v, o, B, H, Hkv, Sq, Sk, causal, scale_log2, strides, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
