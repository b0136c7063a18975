// Mamba2 SSD chunk scan for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/ssd/kernel.py, ssd_chunk_fwd (Pallas body
// _ssd_kernel). Per chunk of Q positions, csum the running sum of dA inside
// the chunk and L[i,j] = exp(csum_i - csum_j) for i >= j, else 0:
//   y = (C B^T . L)(x dt) + (C h) exp(csum)
//   h <- h exp(csum_Q) + B^T (x dt exp(csum_Q - csum))
// with the state h carried across the chunks of a sequence inside one
// launch, as the TPU kernel carries it across its sequential grid axis.
// All math is float32 (the reference casts every input to float32); x, B
// and C may be bfloat16, widened in registers to the same values.
//
// Bound on this card: operations. At the serving shape (8 sequences of
// 2048, 24 heads of P = 64, N = 128) the scan is ~15 GFLOP of f32 FMAs
// against ~170 MB of traffic: ~0.22 ms at 67 TFLOP/s, ~0.05 ms at 3.35 TB/s.
//
// Design: one block per (sequence, head) walks its chunks in order and keeps
// h (N x P f32) in shared memory beside the chunk's B and C (transposed,
// N x Q), x dt (Q x P) and the masked scores (Q x Q). Each product is tiled
// 4 x 4 per thread with float4 reads from shared memory, f32 FMAs on the
// CUDA cores: TF32 tensor cores would not hold the reference's 2e-4. The
// TPU kernel's 128-row chunk becomes a 64-row tile (the result does not
// depend on the chunk length up to f32 rounding): four 128-row f32 tiles
// would not fit in 227 KB. A ragged tail is read as zeros, which is exact
// (x dt = 0 adds nothing and dA = 0 keeps the decay at 1), so any length is
// taken. exp(csum_i - csum_j) is evaluated only where i >= j: above the
// diagonal the difference is positive and may overflow, and inf * 0 is NaN.
//
// Inputs are read through strides (sequence b, head h, position s), so the
// model's x (B, S, H, P) slice of the convolution output and its B/C shared
// by all heads (head stride 0) are read in place. h_final is written in the
// model's orientation (B, H, P, N); the TPU kernel's is (BH, N, P).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int Q = 64;            // rows per chunk
constexpr int QP = Q + 4;        // padded row of the (N, Q) and (Q, Q) tiles
constexpr int THREADS = 256;
constexpr int MAX_SMEM = 232448; // 227 KB, the most a block may use

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

struct Strides {
  long long b, h, s;
  __device__ __forceinline__ long long at(int b_, int h_, int s_) const {
    return b_ * b + h_ * h + s_ * s;
  }
};

struct Args {
  const void* x;
  const float* dt;
  const float* da;
  const void* B;
  const void* C;
  float* y;
  float* hout;
  int nh, S, P, N;
  Strides sx, sdt, sda, sB, sC, sy;
};

__host__ __device__ __forceinline__ int round4(int v) { return (v + 3) & ~3; }

// Shared memory floats for state width P and size N.
__host__ __device__ __forceinline__ int smem_floats(int P, int N) {
  const int PP = round4(P), NP = round4(N), HP = PP + 4;
  return 2 * NP * QP + Q * QP + Q * PP + NP * HP + 2 * Q;
}

__device__ __forceinline__ void fma4x4(float (&acc)[4][4], float4 a, float4 b) {
  const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_chunk_kernel(const Args a) {
  extern __shared__ __align__(16) float sm[];
  const int P = a.P, N = a.N, S = a.S;
  const int PP = round4(P), NP = round4(N), HP = PP + 4;
  float* Bt = sm;                  // (NP, QP): B of the chunk, transposed
  float* Ct = Bt + NP * QP;        // (NP, QP): C, transposed
  float* St = Ct + NP * QP;        // (Q, QP): St[j][i] = scores[i][j] . L[i][j]
  float* xdt = St + Q * QP;        // (Q, PP): x dt, later x dt exp(csum_Q - csum)
  float* hs = xdt + Q * PP;        // (NP, HP): the carried state h[n][p]
  float* cs = hs + NP * HP;        // (Q): csum
  float* dts = cs + Q;             // (Q): dt

  const int head = blockIdx.x, seq = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int NW = THREADS / 32;
  const T* x = static_cast<const T*>(a.x);
  const T* Bg = static_cast<const T*>(a.B);
  const T* Cg = static_cast<const T*>(a.C);

  for (int e = tid; e < NP * HP; e += THREADS) hs[e] = 0.f;

  for (int c0 = 0; c0 < S; c0 += Q) {
    const int rows = min(Q, S - c0);
    // A. dt, dA, and B, C transposed; rows past the end and columns past N
    // read as zeros.
    for (int r = tid; r < Q; r += THREADS) {
      const bool ok = r < rows;
      dts[r] = ok ? a.dt[a.sdt.at(seq, head, c0 + r)] : 0.f;
      cs[r] = ok ? a.da[a.sda.at(seq, head, c0 + r)] : 0.f;
    }
    for (int r = warp; r < Q; r += NW) {
      const long long ob = a.sB.at(seq, head, c0 + r), oc = a.sC.at(seq, head, c0 + r);
      for (int n = lane; n < NP; n += 32) {
        const bool ok = r < rows && n < N;
        Bt[n * QP + r] = ok ? to_f32(Bg[ob + n]) : 0.f;
        Ct[n * QP + r] = ok ? to_f32(Cg[oc + n]) : 0.f;
      }
    }
    __syncthreads();
    // B. warp 0: inclusive scan of dA; the other warps: x dt.
    if (warp == 0) {
      const float v0 = cs[2 * lane], v1 = v0 + cs[2 * lane + 1];
      float incl = v1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += t;
      }
      float prev = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) prev = 0.f;
      cs[2 * lane] = prev + v0;
      cs[2 * lane + 1] = prev + v1;
    } else {
      for (int r = warp - 1; r < Q; r += NW - 1) {
        const long long ox = a.sx.at(seq, head, c0 + r);
        for (int p = lane; p < PP; p += 32)
          xdt[r * PP + p] = (r < rows && p < P) ? to_f32(x[ox + p]) * dts[r] : 0.f;
      }
    }
    __syncthreads();
    // C. masked scores, stored transposed: St[j][i] = (C B^T)[i][j] L[i][j].
    for (int t = tid; t < (Q / 4) * (Q / 4); t += THREADS) {
      const int ti = t / (Q / 4), tj = t % (Q / 4);
      float acc[4][4] = {};
      if (tj <= ti) {              // tiles wholly above the diagonal stay 0
        for (int n = 0; n < N; ++n)
          fma4x4(acc, *reinterpret_cast<const float4*>(&Ct[n * QP + 4 * ti]),
                 *reinterpret_cast<const float4*>(&Bt[n * QP + 4 * tj]));
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int i = 4 * ti + u, j = 4 * tj + v;
          St[j * QP + i] = i >= j ? acc[u][v] * expf(cs[i] - cs[j]) : 0.f;
        }
    }
    __syncthreads();
    // D. y = St^T xdt + exp(csum) (C h), the second term only once h != 0.
    for (int t = tid; t < (Q / 4) * (PP / 4); t += THREADS) {
      const int ti = t / (PP / 4), tj = t % (PP / 4);
      float acc[4][4] = {}, inter[4][4] = {};
      for (int j = 0; j < 4 * ti + 4; ++j)    // St[j][i] = 0 for j > i
        fma4x4(acc, *reinterpret_cast<const float4*>(&St[j * QP + 4 * ti]),
               *reinterpret_cast<const float4*>(&xdt[j * PP + 4 * tj]));
      if (c0 > 0)
        for (int n = 0; n < N; ++n)
          fma4x4(inter, *reinterpret_cast<const float4*>(&Ct[n * QP + 4 * ti]),
                 *reinterpret_cast<const float4*>(&hs[n * HP + 4 * tj]));
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = 4 * ti + u;
        if (i >= rows) continue;
        const float e = expf(cs[i]);
        float* yr = a.y + a.sy.at(seq, head, c0 + i);
#pragma unroll
        for (int v = 0; v < 4; ++v)
          if (4 * tj + v < P) yr[4 * tj + v] = fmaf(e, inter[u][v], acc[u][v]);
      }
    }
    __syncthreads();
    // E. xdt <- xdt exp(csum_Q - csum).
    const float last = cs[Q - 1];
    for (int r = warp; r < Q; r += NW) {
      const float w = expf(last - cs[r]);
      for (int p = lane; p < PP; p += 32) xdt[r * PP + p] *= w;
    }
    __syncthreads();
    // F. h <- h exp(csum_Q) + B^T xdt.
    const float decay = expf(last);
    for (int t = tid; t < (NP / 4) * (PP / 4); t += THREADS) {
      const int tn = t / (PP / 4), tp = t % (PP / 4);
      float acc[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 h4 = *reinterpret_cast<const float4*>(&hs[(4 * tn + u) * HP + 4 * tp]);
        acc[u][0] = h4.x * decay; acc[u][1] = h4.y * decay;
        acc[u][2] = h4.z * decay; acc[u][3] = h4.w * decay;
      }
      for (int j = 0; j < rows; ++j) {
        const float4 b = make_float4(Bt[(4 * tn) * QP + j], Bt[(4 * tn + 1) * QP + j],
                                     Bt[(4 * tn + 2) * QP + j], Bt[(4 * tn + 3) * QP + j]);
        fma4x4(acc, b, *reinterpret_cast<const float4*>(&xdt[j * PP + 4 * tp]));
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        *reinterpret_cast<float4*>(&hs[(4 * tn + u) * HP + 4 * tp]) =
            make_float4(acc[u][0], acc[u][1], acc[u][2], acc[u][3]);
    }
    __syncthreads();
  }
  // h_final in the model's orientation (P, N), n fastest for the global write.
  float* ho = a.hout + ((long long)seq * a.nh + head) * P * N;
  for (int p = warp; p < P; p += NW)
    for (int n = lane; n < N; n += 32) ho[p * N + n] = hs[n * HP + p];
}

template <typename T>
cudaError_t launch(const Args& a, int nb, cudaStream_t stream) {
  const size_t smem = (size_t)smem_floats(a.P, a.N) * sizeof(float);
  if (smem > MAX_SMEM || nb > 65535) return cudaErrorInvalidValue;
  static bool opted_in = false;    // once, so no attribute call during graph capture
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  ssd_chunk_kernel<T><<<dim3(a.nh, nb), THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, B, C: float32 (bf16 = 0) or bfloat16 (bf16 = 1); dt, dA: float32.
// strides: 18 element strides, (sequence, head, position) for x, dt, dA, B,
// C and y in that order; the last dimension of x, B, C and y is contiguous.
// y: float32; h_final: float32 (nb, nh, P, N), contiguous.
// Grid: heads on x, sequences on y (at most 65535). Returns
// cudaGetLastError(), or cudaErrorInvalidValue if the shapes need more
// shared memory than a block has or nb exceeds the grid.
int ssd_chunk_fwd(const void* x, const void* dt, const void* da, const void* B,
                  const void* C, void* y, void* hout, int nb, int nh, int S, int P,
                  int N, int bf16, const long long* strides, void* stream) {
  Args a{x, static_cast<const float*>(dt), static_cast<const float*>(da), B, C,
         static_cast<float*>(y), static_cast<float*>(hout), nh, S, P, N};
  Strides* dst[6] = {&a.sx, &a.sdt, &a.sda, &a.sB, &a.sC, &a.sy};
  for (int k = 0; k < 6; ++k) *dst[k] = {strides[3 * k], strides[3 * k + 1], strides[3 * k + 2]};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? launch<__nv_bfloat16>(a, nb, st) : launch<float>(a, nb, st));
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
