// FlashAttention in float32 for Hopper (sm_90a) on the CUDA cores: the
// forward, the forward with a per-row LSE, and the two backward kernels.
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
// Why the CUDA cores. The reference holds its float32 kernels to 2e-5
// (forward) and 2e-4 (backward). The tensor cores take float32 operands
// only as TF32 (10 mantissa bits), which misses that by two orders of
// magnitude, so every product here is an f32 FMA. Bound on this card:
// operations, at the 67 TFLOP/s of the CUDA cores (a causal 4 x 32 heads x
// 2048^2 x 128 prefill is ~69 GFLOP, ~1 ms) against its ~270 MB.
//
// Design, a simple one (FA-2 loops, no pipelining; making it fast is later
// work):
// * One block of 256 threads per 64-row tile: 64 queries (forward, dQ) or
//   64 keys (dK/dV) of one (batch, head), the longest items first. The
//   threads form a 16 x 16 grid; thread (ty, tx) holds rows 4 ty .. 4 ty + 3
//   of every 64 x 64 score tile, columns 4 tx .. 4 tx + 3, and hd / 16
//   columns of each of its rows' outputs.
// * Operands of a product A B^T over hd (S = Q K^T, dP = dO V^T, and their
//   transposes in dK/dV) sit in shared memory transposed (hd rows of 64 + 4
//   floats), so each step of the product is two 16-byte loads and 16 FMAs.
//   Operands of P V, dS K, P^T dO and dS^T Q sit row-major (64 rows of hd),
//   P or dS transposed, so each step is one 16-byte load of P, hd / 16
//   floats of the other and 4 hd / 16 FMAs.
// * The softmax is online in the log2 domain (exp2f, not the approximate
//   unit), each row's max and sum reduced over its 16 threads by shuffles.
// * The backward follows FA-2 as flash_attention.cu does, deterministic,
//   without atomics: the dQ kernel walks the keys of its 64 queries, the
//   dK/dV kernel walks every query tile at or below its 64 keys for each
//   query head of the group, summing in registers.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr int BT = 64;        // rows of every tile: 64 queries or 64 keys
constexpr int THREADS = 256;  // a 16 x 16 grid of threads
constexpr int LDT = BT + 4;   // floats a row of a transposed tile (rows on 16 bytes)

struct Str3 {  // element strides of a (B, heads, S, hd) tensor
  int64_t b, h, s;
};

template <int HD>
struct Tiles {
  static_assert(HD == 16 || HD == 32 || HD == 64 || HD == 128, "hd in {16, 32, 64, 128}");
  static constexpr int CPT = HD / 16;        // output columns a thread
  static constexpr int T_FLOATS = HD * LDT;  // a transposed (hd x 64) tile
  static constexpr int M_FLOATS = BT * HD;   // a row-major (64 x hd) tile
  static constexpr int P_FLOATS = BT * LDT;  // a 64 x 64 tile, transposed
  // dynamic shared memory of each kernel, in bytes
  static constexpr int FWD = 4 * (2 * T_FLOATS + M_FLOATS + P_FLOATS);
  static constexpr int DQ = 4 * (4 * T_FLOATS + M_FLOATS + P_FLOATS);
  static constexpr int DKV = 4 * (4 * T_FLOATS + 2 * M_FLOATS + P_FLOATS + 2 * BT);
};

// Rows [r0, r0 + 64) of one head (base: its row 0, ss its row stride) of
// a view with n rows, rows past n as zeros, into shared memory: transposed
// (t[d * LDT + r]; consecutive threads take consecutive rows, so the
// stores meet distinct banks) and/or row-major (m[r * HD + d]).
template <int HD>
__device__ __forceinline__ void load_tile(const float* __restrict__ base, int64_t ss, int r0,
                                          int n, float* t, float* m) {
  constexpr int C4 = HD / 4;  // 16-byte vectors a row
  for (int i = threadIdx.x; t && i < BT * C4; i += THREADS) {
    const int r = i % BT, c = i / BT * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < n) x = *reinterpret_cast<const float4*>(base + (int64_t)(r0 + r) * ss + c);
    t[(c + 0) * LDT + r] = x.x;
    t[(c + 1) * LDT + r] = x.y;
    t[(c + 2) * LDT + r] = x.z;
    t[(c + 3) * LDT + r] = x.w;
  }
  for (int i = threadIdx.x; m && i < BT * C4; i += THREADS) {
    const int r = i / C4, c = i % C4 * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < n) x = *reinterpret_cast<const float4*>(base + (int64_t)(r0 + r) * ss + c);
    *reinterpret_cast<float4*>(m + r * HD + c) = x;
  }
}

__device__ __forceinline__ void unpack4(const float4& x, float (&a)[4]) {
  a[0] = x.x, a[1] = x.y, a[2] = x.z, a[3] = x.w;
}

// acc[i][j] += sum_d a[d][ra + i] b[d][cb + j]: a and b transposed tiles.
template <int HD>
__device__ __forceinline__ void product_abt(float (&acc)[4][4], const float* a, const float* b,
                                            int ra, int cb) {
#pragma unroll 8
  for (int d = 0; d < HD; ++d) {
    float x[4], y[4];
    unpack4(*reinterpret_cast<const float4*>(a + d * LDT + ra), x);
    unpack4(*reinterpret_cast<const float4*>(b + d * LDT + cb), y);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
  }
}

// CPT consecutive floats from shared memory (aligned to their size).
template <int CPT>
__device__ __forceinline__ void load_cols(const float* src, float (&y)[CPT]) {
  if constexpr (CPT % 4 == 0) {
#pragma unroll
    for (int u = 0; u < CPT / 4; ++u) {
      float x[4];
      unpack4(reinterpret_cast<const float4*>(src)[u], x);
#pragma unroll
      for (int e = 0; e < 4; ++e) y[4 * u + e] = x[e];
    }
  } else if constexpr (CPT == 2) {
    const float2 x = *reinterpret_cast<const float2*>(src);
    y[0] = x.x, y[1] = x.y;
  } else {
    y[0] = *src;
  }
}

// acc[i][c] += sum_k p[k][rp + i] m[k][cm + c]: p a transposed 64 x 64
// tile (p[k * LDT + row]), m a row-major (64 x hd) tile.
template <int HD>
__device__ __forceinline__ void product_pm(float (&acc)[4][HD / 16], const float* p,
                                           const float* m, int rp, int cm) {
  constexpr int CPT = HD / 16;
#pragma unroll 4
  for (int k = 0; k < BT; ++k) {
    float x[4], y[CPT];
    unpack4(*reinterpret_cast<const float4*>(p + k * LDT + rp), x);
    load_cols<CPT>(m + k * HD + cm, y);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(x[i], y[c], acc[i][c]);
  }
}

// Column j of a thread's 4 x 4 block, written as row 4 tx + j of the
// transposed tile t (t[(4 tx + j) * LDT + 4 ty + i] = v[i][j]).
__device__ __forceinline__ void store_transposed(float* t, const float (&v)[4][4], int r0,
                                                 int c0) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    *reinterpret_cast<float4*>(t + (c0 + j) * LDT + r0) =
        make_float4(v[0][j], v[1][j], v[2][j], v[3][j]);
}

// Sum over the 16 threads of a row (tx = lane % 16).
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Write rows row0 .. row0 + 3 of a thread's outputs (columns cc .. cc +
// CPT - 1) times mul; rows at or past n are not written.
template <int HD>
__device__ __forceinline__ void store_rows(float* base, int64_t ss, const float (&acc)[4][HD / 16],
                                           int row0, int n, int cc, float mul) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (row0 + i < n) {
      float* out = base + (int64_t)(row0 + i) * ss + cc;
#pragma unroll
      for (int c = 0; c < HD / 16; ++c) out[c] = acc[i][c] * mul;
    }
  }
}

// ------------------------------- forward -------------------------------------
template <int HD, bool LSE>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         float* __restrict__ lse, int H, int Hkv, int Sq, int Sk, int causal,
                         float scale_log2, Str3 qs, Str3 ks, Str3 vs, Str3 os) {
  using G = Tiles<HD>;
  constexpr int CPT = G::CPT;
  extern __shared__ float4 fwd_smem[];
  float* Qt = reinterpret_cast<float*>(fwd_smem);
  float* Kt = Qt + G::T_FLOATS;
  float* Vm = Kt + G::T_FLOATS;
  float* Pt = Vm + G::M_FLOATS;
  const int m0 = (gridDim.x - 1 - blockIdx.x) * BT;  // the longest rows first
  const int bh = blockIdx.y, b = bh / H, h = bh % H, kvh = h / (H / Hkv);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int r0 = 4 * ty, c0 = 4 * tx, cc = CPT * tx;
  load_tile<HD>(q + b * qs.b + h * qs.h, qs.s, m0, Sq, Qt, nullptr);
  const float* kb = k + b * ks.b + kvh * ks.h;
  const float* vb = v + b * vs.b + kvh * vs.h;

  float oacc[4][CPT], mrow[4], lrow[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    mrow[i] = -INFINITY, lrow[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) oacc[i][c] = 0.f;
  }
  const int n_end = causal ? min(Sk, m0 + BT) : Sk;
  for (int n0 = 0; n0 < n_end; n0 += BT) {
    __syncthreads();  // the previous tile's P V is done
    load_tile<HD>(kb, ks.s, n0, Sk, Kt, nullptr);
    load_tile<HD>(vb, vs.s, n0, Sk, nullptr, Vm);
    __syncthreads();
    float s[4][4] = {};
    product_abt<HD>(s, Qt, Kt, r0, c0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = m0 + r0 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = n0 + c0 + j;
        const bool vis = key < Sk && (!causal || key <= row);
        s[i][j] = vis ? s[i][j] * scale_log2 : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(mrow[i], row_max(mx));
      const float base = m_new == -INFINITY ? 0.f : m_new;  // a row with no key yet
      const float alpha = exp2f(mrow[i] - base);
      mrow[i] = m_new;
      float ls = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = exp2f(s[i][j] - base);
        ls += s[i][j];
      }
      lrow[i] = lrow[i] * alpha + ls;  // this thread's columns; summed at the end
#pragma unroll
      for (int c = 0; c < CPT; ++c) oacc[i][c] *= alpha;
    }
    store_transposed(Pt, s, r0, c0);
    __syncthreads();
    product_pm<HD>(oacc, Pt, Vm, r0, cc);
  }
  float inv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float l = row_sum(lrow[i]);
    inv[i] = l == 0.f ? 1.f : 1.f / l;  // fully masked rows -> 0
    const int row = m0 + r0 + i;
    if (LSE && tx == 0 && row < Sq)
      lse[(int64_t)bh * Sq + row] = (l == 0.f ? mrow[i] : mrow[i] + log2f(l)) * LN2;
  }
  float* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + r0 + i;
    if (row < Sq) {
      float* out = ob + (int64_t)row * os.s + cc;
#pragma unroll
      for (int c = 0; c < CPT; ++c) out[c] = oacc[i][c] * inv[i];
    }
  }
}

// ------------------------------ backward -------------------------------------
// dQ: 64 query rows of one (batch, head), Q and dO resident (transposed);
// for each 64-key tile S = Q K^T, dP = dO V^T, P = exp2(S scale log2 e -
// LSE log2 e) masked, dS = P (dP - D), dQ += dS K.
template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const float* __restrict__ dout,
                            const float* __restrict__ lse, const float* __restrict__ dd,
                            float* __restrict__ dq, int H, int Hkv, int Sq, int Sk, int causal,
                            float scale, Str3 qs, Str3 ks, Str3 vs, Str3 dos, Str3 dqs) {
  using G = Tiles<HD>;
  constexpr int CPT = G::CPT;
  extern __shared__ float4 dq_smem[];
  float* Qt = reinterpret_cast<float*>(dq_smem);
  float* dOt = Qt + G::T_FLOATS;
  float* Kt = dOt + G::T_FLOATS;
  float* Vt = Kt + G::T_FLOATS;
  float* Km = Vt + G::T_FLOATS;
  float* dSt = Km + G::M_FLOATS;
  const int m0 = (gridDim.x - 1 - blockIdx.x) * BT;  // the most keys first
  const int bh = blockIdx.y, b = bh / H, h = bh % H, kvh = h / (H / Hkv);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int r0 = 4 * ty, c0 = 4 * tx, cc = CPT * tx;
  const float scale_log2 = scale * LOG2E;
  load_tile<HD>(q + b * qs.b + h * qs.h, qs.s, m0, Sq, Qt, nullptr);
  load_tile<HD>(dout + b * dos.b + h * dos.h, dos.s, m0, Sq, dOt, nullptr);
  const float* kb = k + b * ks.b + kvh * ks.h;
  const float* vb = v + b * vs.b + kvh * vs.h;
  float lse2[4], Dr[4], dqa[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // rows past Sq: zero Q and dO give dS = 0
    const int row = m0 + r0 + i;
    const bool ok = row < Sq;
    lse2[i] = ok ? lse[(int64_t)bh * Sq + row] * LOG2E : 0.f;
    Dr[i] = ok ? dd[(int64_t)bh * Sq + row] : 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) dqa[i][c] = 0.f;
  }
  const int n_end = causal ? min(Sk, m0 + BT) : Sk;
  for (int n0 = 0; n0 < n_end; n0 += BT) {
    __syncthreads();  // the previous tile's dS K is done
    load_tile<HD>(kb, ks.s, n0, Sk, Kt, Km);
    load_tile<HD>(vb, vs.s, n0, Sk, Vt, nullptr);
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    product_abt<HD>(s, Qt, Kt, r0, c0);
    product_abt<HD>(dp, dOt, Vt, r0, c0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = m0 + r0 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = n0 + c0 + j;
        const bool vis = key < Sk && (!causal || key <= row);
        const float p = vis ? exp2f(fmaf(s[i][j], scale_log2, -lse2[i])) : 0.f;
        dp[i][j] = p * (dp[i][j] - Dr[i]);
      }
    }
    store_transposed(dSt, dp, r0, c0);
    __syncthreads();
    product_pm<HD>(dqa, dSt, Km, r0, cc);
  }
  store_rows<HD>(dq + b * dqs.b + h * dqs.h, dqs.s, dqa, m0 + r0, Sq, cc, scale);
}

// dK/dV: 64 keys of one (batch, kv head), K and V resident (transposed);
// for each query head of the group and each 64-query tile at or below the
// diagonal S^T = K Q^T, dP^T = V dO^T, P^T masked, dS^T = P^T (dP^T - D),
// dV += P^T dO, dK += dS^T Q.
template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, const float* __restrict__ dout,
                             const float* __restrict__ lse, const float* __restrict__ dd,
                             float* __restrict__ dk, float* __restrict__ dv, int H, int Hkv,
                             int Sq, int Sk, int causal, float scale, Str3 qs, Str3 ks,
                             Str3 vs, Str3 dos, Str3 dks, Str3 dvs) {
  using G = Tiles<HD>;
  constexpr int CPT = G::CPT;
  extern __shared__ float4 dkv_smem[];
  float* Kt = reinterpret_cast<float*>(dkv_smem);
  float* Vt = Kt + G::T_FLOATS;
  float* Qt = Vt + G::T_FLOATS;
  float* dOt = Qt + G::T_FLOATS;
  float* Qm = dOt + G::T_FLOATS;
  float* dOm = Qm + G::M_FLOATS;
  float* Bt = dOm + G::M_FLOATS;  // P^T, then dS^T, stored [query][key]
  float* rows = Bt + G::P_FLOATS;  // a tile's LSE log2 e, then its D
  const int n0 = blockIdx.x * BT;  // the first keys, the most query tiles, first
  const int bkv = blockIdx.y, b = bkv / Hkv, kvh = bkv % Hkv, n_rep = H / Hkv;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int r0 = 4 * ty, c0 = 4 * tx, cc = CPT * tx;
  const float scale_log2 = scale * LOG2E;
  load_tile<HD>(k + b * ks.b + kvh * ks.h, ks.s, n0, Sk, Kt, nullptr);
  load_tile<HD>(v + b * vs.b + kvh * vs.h, vs.s, n0, Sk, Vt, nullptr);
  float dka[4][CPT], dva[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) dka[i][c] = dva[i][c] = 0.f;
  // query tiles wholly above the diagonal see no key of this tile
  const int m_begin = causal ? n0 : 0;
  for (int hh = 0; hh < n_rep; ++hh) {
    const int h = kvh * n_rep + hh;
    const float* qb = q + b * qs.b + h * qs.h;
    const float* dob = dout + b * dos.b + h * dos.h;
    const int64_t rb = (int64_t)(b * H + h) * Sq;
    for (int m0 = m_begin; m0 < Sq; m0 += BT) {
      __syncthreads();  // the previous tile's products are done
      load_tile<HD>(qb, qs.s, m0, Sq, Qt, Qm);
      load_tile<HD>(dob, dos.s, m0, Sq, dOt, dOm);
      for (int r = threadIdx.x; r < BT; r += THREADS) {  // rows past Sq: masked
        const bool ok = m0 + r < Sq;
        rows[r] = ok ? lse[rb + m0 + r] * LOG2E : 0.f;
        rows[BT + r] = ok ? dd[rb + m0 + r] : 0.f;
      }
      __syncthreads();
      float s[4][4] = {}, dp[4][4] = {};
      product_abt<HD>(s, Kt, Qt, r0, c0);
      product_abt<HD>(dp, Vt, dOt, r0, c0);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = n0 + r0 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qi = m0 + c0 + j;
          const bool vis = key < Sk && qi < Sq && (!causal || key <= qi);
          const float p = vis ? exp2f(fmaf(s[i][j], scale_log2, -rows[c0 + j])) : 0.f;
          s[i][j] = p;
          dp[i][j] = p * (dp[i][j] - rows[BT + c0 + j]);
        }
      }
      store_transposed(Bt, s, r0, c0);
      __syncthreads();
      product_pm<HD>(dva, Bt, dOm, r0, cc);
      __syncthreads();  // P^T read: dS^T takes its place
      store_transposed(Bt, dp, r0, c0);
      __syncthreads();
      product_pm<HD>(dka, Bt, Qm, r0, cc);
    }
  }
  store_rows<HD>(dk + b * dks.b + kvh * dks.h, dks.s, dka, n0 + r0, Sk, cc, scale);
  store_rows<HD>(dv + b * dvs.b + kvh * dvs.h, dvs.s, dva, n0 + r0, Sk, cc, 1.f);
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
  cudaError_t err = allow_smem(kernel, Tiles<HD>::FWD, configured);
  if (err != cudaSuccess) return err;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(o);
  Str3 qs = str3(st), ks = str3(st + 3), vs = str3(st + 6), os = str3(st + 9);
  void* args[] = {&qf, &kf, &vf, &of, &lse, &H, &Hkv, &Sq, &Sk, &causal, &scale_log2,
                  &qs, &ks, &vs, &os};
  err = cudaLaunchKernel((const void*)kernel, dim3((Sq + BT - 1) / BT, B * H), dim3(THREADS),
                         args, Tiles<HD>::FWD, stream);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int HD>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* dd, void* dq, int B, int H, int Hkv,
                      int Sq, int Sk, int causal, float scale, const int64_t* st,
                      cudaStream_t stream) {
  static bool configured = false;
  auto kernel = flash_bwd_dq_f32_kernel<HD>;
  cudaError_t err = allow_smem(kernel, Tiles<HD>::DQ, configured);
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
  err = cudaLaunchKernel((const void*)kernel, dim3((Sq + BT - 1) / BT, B * H), dim3(THREADS),
                         args, Tiles<HD>::DQ, stream);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int HD>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* dd, void* dk, void* dv, int B, int H,
                       int Hkv, int Sq, int Sk, int causal, float scale, const int64_t* st,
                       cudaStream_t stream) {
  static bool configured = false;
  auto kernel = flash_bwd_dkv_f32_kernel<HD>;
  cudaError_t err = allow_smem(kernel, Tiles<HD>::DKV, configured);
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
  err = cudaLaunchKernel((const void*)kernel, dim3((Sk + BT - 1) / BT, B * Hkv), dim3(THREADS),
                         args, Tiles<HD>::DKV, stream);
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
#define CALL(HD) kernel == 0 ? Tiles<HD>::FWD : kernel == 1 ? Tiles<HD>::DKV : Tiles<HD>::DQ
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
