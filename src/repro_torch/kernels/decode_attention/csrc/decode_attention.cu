// Split-KV decode attention for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/decode_attention/kernel.py, decode_attention_fwd
// (Pallas body _dec_kernel): one query token per sequence attends over the
// first kv_len positions of a KV cache; the n_rep query heads of a GQA group
// share one pass over their kv head. f32 online softmax. Returns o in q's
// dtype and the f32 log-sum-exp, with the kernel's l == 0 guard (o = 0,
// lse = -1e30 where no position is valid).
//
// Bound on this card: bytes. Every valid K and V row is read once and used
// for n_rep (4 for Mistral-Nemo) dot products each: ~2 flops per byte,
// far below the ~295 the H100 can do per byte. At 4 sequences x 8 kv heads x
// ~2080 positions x 128 x bf16 that is ~34 MB per layer, ~10 us at 3.35 TB/s.
//
// Design:
// * The cache is read in its model layout (B, S, Hkv, hd) through strides;
//   the wrapper passes the (B, Hkv, S, hd) view, never a transposed copy.
// * B * Hkv is only 32 at the serving shape, far too few blocks for 132 SMs,
//   so the sequence is split: grid (n_split, B * Hkv), each block streams one
//   chunk of [0, kv_len) and writes an unnormalised partial (acc, m, l); a
//   second kernel merges the partials by their maxima. n_split fills one
//   wave at the kernel's occupancy. Positions at or past kv_len are never
//   read, so no tile past kv_len is loaded, and a cache length that is not a
//   multiple of any tile needs no padding.
// * The query heads a block serves are a template parameter NREP, so
//   registers hold exactly those rows and their accumulators. Groups 1, 2,
//   3, 4 and 8 are compiled as they are; any other group is cut into
//   ceil(n_rep / 8) chunks of 8 heads, each chunk a block reading its kv
//   head, the last chunk's missing rows computed on a valid row and never
//   written (group 16 reads each kv head twice, groups 5-7 once).
// * Inside a block each warp takes 8 keys per step: each lane holds hd/32
//   contiguous elements of a row (256-byte coalesced rows), and the next
//   step's 8 K and 8 V rows are loaded before this step's arithmetic, so
//   loads overlap compute. The 8 x n_rep dot products of a step reduce
//   across the warp by shuffles, all interleaved; each warp keeps its own
//   (m, l, acc) per query head in registers, and the warps merge in shared
//   memory at the end of the chunk.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NW = 4;  // warps per block
constexpr int G = 8;   // keys per warp and step

using bf16 = __nv_bfloat16;

template <int BYTES> struct Vec;
template <> struct Vec<2> { using type = unsigned short; };
template <> struct Vec<4> { using type = unsigned int; };
template <> struct Vec<8> { using type = uint2; };

// One lane's slice of a row: E bf16 elements as one vector register.
template <int E>
using Slice = typename Vec<E * sizeof(bf16)>::type;

template <int E>
__device__ __forceinline__ void unpack(const Slice<E>& raw, float (&out)[E]) {
  alignas(16) bf16 buf[E];
  *reinterpret_cast<Slice<E>*>(buf) = raw;
#pragma unroll
  for (int i = 0; i < E; ++i) out[i] = __bfloat162float(buf[i]);
}

// Scores are kept in base 2: s = (q . k) * scale * log2(e).
template <int HD, int NREP>
__global__ void __launch_bounds__(NW * 32)
decode_split_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, float* __restrict__ part_acc,
                    float* __restrict__ part_ml, int H, int Hkv, int group, int kv_len,
                    int chunk, int64_t q_sb, int64_t q_sh, int64_t k_sb, int64_t k_sh, int64_t k_ss,
                    int64_t v_sb, int64_t v_sh, int64_t v_ss, float scale_log2) {
  constexpr int E = HD / 32;  // elements of a row per lane
  using Raw = Slice<E>;
  __shared__ float sm_m[NW][NREP], sm_l[NW][NREP];
  __shared__ float sm_acc[NW][NREP][HD];

  const int split = blockIdx.x, n_split = gridDim.x;
  // blockIdx.y = (b * Hkv + kvh) * n_chunks + part: heads h0 .. h0 + valid - 1;
  // only NREP 8 serves a group in chunks, the others serve group == NREP
  constexpr bool CHUNKED = NREP == 8;
  const int n_chunks = CHUNKED ? (group + NREP - 1) / NREP : 1;
  const int part = CHUNKED ? blockIdx.y % n_chunks : 0;
  const int bkv = CHUNKED ? blockIdx.y / n_chunks : blockIdx.y;
  const int b = bkv / Hkv, kvh = bkv % Hkv;
  const int h0 = kvh * (CHUNKED ? group : NREP) + part * NREP;
  const int valid = CHUNKED ? min(NREP, group - part * NREP) : NREP;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int start = split * chunk;
  const int end = min(kv_len, start + chunk);

  float qr[NREP][E], acc[NREP][E], m[NREP], l[NREP];
#pragma unroll
  for (int r = 0; r < NREP; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
    unpack<E>(*reinterpret_cast<const Raw*>(
        q + b * q_sb + (int64_t)(h0 + min(r, valid - 1)) * q_sh + lane * E), qr[r]);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      qr[r][e] *= scale_log2;
      acc[r][e] = 0.f;
    }
  }

  const bf16* kb = k + b * k_sb + kvh * k_sh + lane * E;
  const bf16* vb = v + b * v_sb + kvh * v_sh + lane * E;
  // The G keys of a step are loaded one step ahead, so each warp keeps the
  // next step's 2 * G rows in flight while it computes on this step's.
  Raw kn[G], vn[G];
  auto fetch = [&](int j0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const bool ok = j0 + g < end;
      kn[g] = ok ? *reinterpret_cast<const Raw*>(kb + (int64_t)(j0 + g) * k_ss) : Raw{};
      vn[g] = ok ? *reinterpret_cast<const Raw*>(vb + (int64_t)(j0 + g) * v_ss) : Raw{};
    }
  };
  fetch(start + warp * G);
  for (int j0 = start + warp * G; j0 < end; j0 += NW * G) {
    Raw kc[G], vc[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      kc[g] = kn[g];
      vc[g] = vn[g];
    }
    if (j0 + NW * G < end) fetch(j0 + NW * G);

    float s[NREP][G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float kf[E];
      unpack<E>(kc[g], kf);
#pragma unroll
      for (int r = 0; r < NREP; ++r) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) part += qr[r][e] * kf[e];
        s[r][g] = part;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {  // all G x NREP sums at once: ILP
#pragma unroll
      for (int r = 0; r < NREP; ++r)
#pragma unroll
        for (int g = 0; g < G; ++g) s[r][g] += __shfl_xor_sync(0xffffffffu, s[r][g], o);
    }
    float alpha[NREP];
#pragma unroll
    for (int r = 0; r < NREP; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (j0 + g >= end) s[r][g] = -INFINITY;
        mx = fmaxf(mx, s[r][g]);
      }
      const float m_new = fmaxf(m[r], mx);  // finite: key j0 is valid
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      float ps = 0.f;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        s[r][g] = exp2f(s[r][g] - m_new);
        ps += s[r][g];
      }
      l[r] = l[r] * alpha[r] + ps;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[r][e] *= alpha[r];
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float vf[E];
      unpack<E>(vc[g], vf);
#pragma unroll
      for (int r = 0; r < NREP; ++r)
#pragma unroll
        for (int e = 0; e < E; ++e) acc[r][e] += s[r][g] * vf[e];
    }
  }

#pragma unroll
  for (int r = 0; r < NREP; ++r) {
    if (lane == 0) {
      sm_m[warp][r] = m[r];
      sm_l[warp][r] = l[r];
    }
#pragma unroll
    for (int e = 0; e < E; ++e) sm_acc[warp][r][lane * E + e] = acc[r][e];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < valid * HD; i += blockDim.x) {
    const int r = i / HD, d = i % HD;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < NW; ++w) M = fmaxf(M, sm_m[w][r]);
    float L = 0.f, a = 0.f;
    if (M != -INFINITY) {
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const float c = exp2f(sm_m[w][r] - M);
        L += sm_l[w][r] * c;
        a += sm_acc[w][r][d] * c;
      }
    }
    const int64_t row = ((int64_t)(b * H + h0 + r)) * n_split + split;
    part_acc[row * HD + d] = a;
    if (d == 0) {
      part_ml[row * 2] = M;
      part_ml[row * 2 + 1] = L;
    }
  }
}

// One block per (b, h), one thread per output element: merge the splits.
template <int HD>
__global__ void decode_combine_kernel(const float* __restrict__ part_acc,
                                      const float* __restrict__ part_ml, bf16* __restrict__ o,
                                      float* __restrict__ lse, int n_split) {
  const int64_t row = blockIdx.x;
  const int d = threadIdx.x;
  const float* ml = part_ml + row * n_split * 2;
  float M = -INFINITY;
  for (int s = 0; s < n_split; ++s) M = fmaxf(M, ml[2 * s]);
  float L = 0.f, a = 0.f;
  if (M != -INFINITY) {
    for (int s = 0; s < n_split; ++s) {
      const float c = exp2f(ml[2 * s] - M);
      L += ml[2 * s + 1] * c;
      a += part_acc[(row * n_split + s) * HD + d] * c;
    }
  }
  const float safe = (L == 0.f) ? 1.f : L;
  o[row * HD + d] = __float2bfloat16(a / safe);
  if (d == 0)
    lse[row] = (M == -INFINITY) ? -1e30f : (M + log2f(safe)) * 0.69314718055994531f;
}

// The split count fills one wave: as many blocks as the SMs hold at this
// kernel's occupancy, at least NW * G positions per block, at most
// max_split, and no empty split. Queried once per instantiation.
template <int HD, int NREP>
void plan_splits(int groups, int kv_len, int max_split, int* n_split, int* chunk) {
  static int slots = 0;
  if (slots == 0) {
    int per_sm = 0, sms = 0, dev = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, decode_split_kernel<HD, NREP>, NW * 32, 0);
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    slots = per_sm * sms > 0 ? per_sm * sms : 1;
  }
  if (kv_len <= 0) {
    *n_split = 1;
    *chunk = 0;
    return;
  }
  int n = slots / groups;
  n = min(n, (kv_len + NW * G - 1) / (NW * G));
  n = max(1, min(n, max_split));
  *chunk = (kv_len + n - 1) / n;
  *n_split = (kv_len + *chunk - 1) / *chunk;
}

template <int HD, int NREP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse,
                   float* part_acc, float* part_ml, int B, int H, int Hkv, int kv_len,
                   int max_split, const int64_t* st, float scale_log2, cudaStream_t stream) {
  const int group = H / Hkv, blocks = B * Hkv * ((group + NREP - 1) / NREP);
  int n_split, chunk;
  plan_splits<HD, NREP>(blocks, kv_len, max_split, &n_split, &chunk);
  decode_split_kernel<HD, NREP><<<dim3(n_split, blocks), NW * 32, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      part_acc, part_ml, H, Hkv, group, kv_len, chunk, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], scale_log2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<HD><<<B * H, HD, 0, stream>>>(
      part_acc, part_ml, static_cast<bf16*>(o), lse, n_split);
  return cudaGetLastError();
}

struct Args {
  const void *q, *k, *v;
  void* o;
  float *lse, *part_acc, *part_ml;
  int B, H, Hkv, kv_len, max_split;
  const int64_t* strides;
  float scale_log2;
  cudaStream_t stream;
};

template <int HD, int NREP>
cudaError_t run(const Args& a) {
  return launch<HD, NREP>(a.q, a.k, a.v, a.o, a.lse, a.part_acc, a.part_ml, a.B, a.H,
                          a.Hkv, a.kv_len, a.max_split, a.strides, a.scale_log2,
                          a.stream);
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

cudaError_t dispatch_hd(int hd, const Args& a) {
  switch (hd) {
    case 32: return dispatch_group<32>(a);
    case 64: return dispatch_group<64>(a);
    case 128: return dispatch_group<128>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q: (B, H, hd) bf16 with strides (q_sb, q_sh, 1); k, v: (B, Hkv, S, hd)
// bf16 with strides (sb, sh, ss, 1), any layout. o: contiguous (B, H, hd)
// bf16; lse: contiguous (B, H) f32. part_acc: (B*H*max_split*hd) f32 and
// part_ml: (B*H*max_split*2) f32 scratch. strides: q_sb, q_sh, k_sb, k_sh,
// k_ss, v_sb, v_sh, v_ss in elements. Only [0, kv_len) is read, split in
// at most max_split chunks. hd in {32, 64, 128}; any H / Hkv.
// Returns cudaGetLastError().
int decode_attention_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                         void* part_acc, void* part_ml, int B, int H, int Hkv, int hd,
                         int kv_len, int max_split, const int64_t* strides,
                         float scale_log2, void* stream) {
  if (H % Hkv != 0 || max_split < 1) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, o, static_cast<float*>(lse), static_cast<float*>(part_acc),
               static_cast<float*>(part_ml), B, H, Hkv, kv_len, max_split, strides,
               scale_log2, static_cast<cudaStream_t>(stream)};
  return (int)dispatch_hd(hd, a);
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
