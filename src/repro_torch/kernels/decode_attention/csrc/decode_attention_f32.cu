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
// where no position is valid). kv_len is a device scalar, read by every
// block and clamped to [0, S]; the grid depends on B and H only, so one
// captured launch stays right while the position advances between replays.
//
// Why the CUDA cores: the reference holds float32 to 2e-5; TF32 products
// would miss it. Bound on this card: bytes (each valid K and V row read
// once per query head of its group: ~0.5 flop a byte).
//
// Design, a simple one: one block of 8 warps per (sequence, query head).
// A lane holds 4 consecutive columns of q (hd / 4 lanes a key), so a warp
// takes 128 / hd keys at once and the 8 warps walk the cache side by side;
// a key's score is reduced over its lanes by shuffles, and each lane group
// keeps its own online softmax (m, l, acc) in the log2 domain (exp2f).
// The groups merge by shuffles, the warps through shared memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr float LN2 = 0.6931471805599453f;

struct Params {
  const float* q;
  const void *k, *v;  // float or bf16
  float *o, *lse;
  const int* kv_len;
  int H, Hkv, S;
  int64_t q_sb, q_sh, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  float scale_log2;
};

// (m, l, acc) <- the merge of two online-softmax states (log2 domain); an
// empty state has m = -inf, l = 0, acc = 0.
__device__ __forceinline__ void merge(float& m, float& l, float4& acc, float m2, float l2,
                                      const float4& acc2) {
  const float M = fmaxf(m, m2);
  const float a = m == -INFINITY ? 0.f : exp2f(m - M);
  const float b = m2 == -INFINITY ? 0.f : exp2f(m2 - M);
  l = l * a + l2 * b;
  acc.x = acc.x * a + acc2.x * b;
  acc.y = acc.y * a + acc2.y * b;
  acc.z = acc.z * a + acc2.z * b;
  acc.w = acc.w * a + acc2.w * b;
  m = M;
}

// Four consecutive values of a cache row as f32: one 16-byte load of
// float32, one 8-byte load of bf16.
__device__ __forceinline__ float4 load4(const float* src) {
  return *reinterpret_cast<const float4*>(src);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* src) {
  const uint2 raw = *reinterpret_cast<const uint2*>(src);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  return make_float4(__bfloat162float(lo.x), __bfloat162float(lo.y), __bfloat162float(hi.x),
                     __bfloat162float(hi.y));
}

// KV the cache's element type (float or __nv_bfloat16).
template <int HD, typename KV>
__global__ void __launch_bounds__(THREADS) decode_f32_kernel(const Params p) {
  constexpr int LPK = HD / 4;   // lanes a key
  constexpr int KPW = 32 / LPK;  // keys a warp at once
  __shared__ float wm[WARPS], wl[WARPS];
  __shared__ float4 wacc[WARPS][HD / 4];
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H, kvh = h / (p.H / p.Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane / LPK, c = lane % LPK * 4;
  const int kv_len = min(max(__ldg(p.kv_len), 0), p.S);
  float4 qv = *reinterpret_cast<const float4*>(p.q + b * p.q_sb + h * p.q_sh + c);
  qv.x *= p.scale_log2, qv.y *= p.scale_log2, qv.z *= p.scale_log2, qv.w *= p.scale_log2;
  const KV* kb = static_cast<const KV*>(p.k) + b * p.k_sb + kvh * p.k_sh + c;
  const KV* vb = static_cast<const KV*>(p.v) + b * p.v_sb + kvh * p.v_sh + c;
  float m = -INFINITY, l = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int base = warp * KPW; base < kv_len; base += WARPS * KPW) {
    const int key = base + grp;
    const bool ok = key < kv_len;
    float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
    if (ok) {
      kx = load4(kb + (int64_t)key * p.k_ss);
      vx = load4(vb + (int64_t)key * p.v_ss);
    }
    float s = qv.x * kx.x + qv.y * kx.y + qv.z * kx.z + qv.w * kx.w;
#pragma unroll
    for (int o = 1; o < LPK; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (ok) {
      const float mn = fmaxf(m, s);
      const float a = exp2f(m - mn), e = exp2f(s - mn);  // m = -inf: a = 0
      l = l * a + e;
      acc.x = acc.x * a + e * vx.x;
      acc.y = acc.y * a + e * vx.y;
      acc.z = acc.z * a + e * vx.z;
      acc.w = acc.w * a + e * vx.w;
      m = mn;
    }
  }
  // the lane groups of a warp took different keys: lane and lane + LPK
  // hold the same columns
#pragma unroll
  for (int o = LPK; o < 32; o <<= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
    const float l2 = __shfl_xor_sync(0xffffffffu, l, o);
    float4 a2;
    a2.x = __shfl_xor_sync(0xffffffffu, acc.x, o);
    a2.y = __shfl_xor_sync(0xffffffffu, acc.y, o);
    a2.z = __shfl_xor_sync(0xffffffffu, acc.z, o);
    a2.w = __shfl_xor_sync(0xffffffffu, acc.w, o);
    merge(m, l, acc, m2, l2, a2);
  }
  if (lane < LPK) wacc[warp][lane] = acc;
  if (lane == 0) wm[warp] = m, wl[warp] = l;
  __syncthreads();
  for (int i = threadIdx.x; i < HD / 4; i += THREADS) {
    float M = wm[0], L = wl[0];
    float4 A = wacc[0][i];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) merge(M, L, A, wm[w], wl[w], wacc[w][i]);
    const float inv = L == 0.f ? 0.f : 1.f / L;
    reinterpret_cast<float4*>(p.o + ((int64_t)b * p.H + h) * HD)[i] =
        make_float4(A.x * inv, A.y * inv, A.z * inv, A.w * inv);
    if (i == 0) p.lse[(int64_t)b * p.H + h] = M == -INFINITY ? -1e30f : (M + log2f(L)) * LN2;
  }
}

template <int HD>
cudaError_t run(const Params& p, int B, bool bf16_cache, cudaStream_t stream) {
  Params a = p;
  void* args[] = {&a};
  const void* kernel = bf16_cache ? (const void*)decode_f32_kernel<HD, __nv_bfloat16>
                                  : (const void*)decode_f32_kernel<HD, float>;
  const cudaError_t err =
      cudaLaunchKernel(kernel, dim3(B * p.H), dim3(THREADS), args, 0, stream);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

extern "C" {

// q: (B, H, hd) float32 with strides (q_sb, q_sh, 1); k, v: (B, Hkv, S, hd)
// float32 (bf16_cache 0) or bfloat16 (bf16_cache 1), both of one dtype,
// with strides (sb, sh, ss, 1), rows on 16 bytes. o: contiguous
// (B, H, hd) float32; lse: contiguous (B, H) float32. kv_len: one int32 in
// device memory, clamped to [0, S]. strides: q_sb, q_sh, k_sb, k_sh, k_ss,
// v_sb, v_sh, v_ss in elements. hd in {16, 32, 64, 128}; any H / Hkv. One
// launch; returns cudaGetLastError().
int decode_attention_f32_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                             const void* kv_len, int B, int H, int Hkv, int S, int hd,
                             int bf16_cache, const int64_t* strides, float scale_log2,
                             void* stream) {
  if (Hkv < 1 || H % Hkv != 0 || B * H == 0) return (int)cudaErrorInvalidValue;
  const Params p{static_cast<const float*>(q), k, v, static_cast<float*>(o),
                 static_cast<float*>(lse), static_cast<const int*>(kv_len), H, Hkv, S,
                 strides[0], strides[1], strides[2], strides[3], strides[4], strides[5],
                 strides[6], strides[7], scale_log2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool bf = bf16_cache != 0;
  switch (hd) {
    case 16: return (int)run<16>(p, B, bf, s);
    case 32: return (int)run<32>(p, B, bf, s);
    case 64: return (int)run<64>(p, B, bf, s);
    case 128: return (int)run<128>(p, B, bf, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
