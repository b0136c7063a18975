// Fused residual add + RMSNorm for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/rmsnorm/kernel.py, fused_rmsnorm_fwd
// (Pallas body _rms_kernel): s = x (+ residual) in f32, y = s * rsqrt(mean(s^2)
// + eps) * w; writes y and the new residual s, each once, in x's dtype.
//
// Bound on this card: bytes. Per row it reads x, the residual and w and
// writes y and the residual; two flops per element are nothing beside the
// 295 flops per byte the H100 can afford. At prefill (8192 rows of 5120
// bf16) it moves ~335 MB; in decode (4 rows) it is launch-bound.
//
// Design: one block per row, one 16-byte vector (8 bf16) per thread and
// pass, so that each row is read from device memory exactly once. The
// f32 sum s is kept in shared memory between the reduction and the scaling
// pass, which is what the TPU kernel keeps in VMEM; the new residual is
// written in the first pass. Rows whose width or addresses do not allow
// 16-byte vectors take a scalar loop with the same arithmetic.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using T = __nv_bfloat16;
__device__ __forceinline__ float to_f32(T v) { return __bfloat162float(v); }
__device__ __forceinline__ T from_f32(float v) { return __float2bfloat16(v); }

__device__ __forceinline__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  const int nw = (blockDim.x + 31) >> 5;
  v = (lane < nw) ? red[lane] : 0.f;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;  // every thread holds the total
}

template <bool VEC>
__global__ void rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ r,
                               const float* __restrict__ w, T* __restrict__ y,
                               T* __restrict__ rout, int d, float eps) {
  extern __shared__ float s[];  // the row's f32 sum, d floats
  __shared__ float red[32];
  const int64_t base = (int64_t)blockIdx.x * d;
  constexpr int V = 16 / sizeof(T);
  float sq = 0.f;
  if (VEC) {
    for (int i = threadIdx.x * V; i < d; i += blockDim.x * V) {
      alignas(16) T px[V], pr[V], po[V];
      *reinterpret_cast<uint4*>(px) = *reinterpret_cast<const uint4*>(x + base + i);
      if (r) *reinterpret_cast<uint4*>(pr) = *reinterpret_cast<const uint4*>(r + base + i);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        float v = to_f32(px[j]) + (r ? to_f32(pr[j]) : 0.f);
        s[i + j] = v;
        sq += v * v;
        po[j] = from_f32(v);
      }
      *reinterpret_cast<uint4*>(rout + base + i) = *reinterpret_cast<const uint4*>(po);
    }
  } else {
    for (int i = threadIdx.x; i < d; i += blockDim.x) {
      float v = to_f32(x[base + i]) + (r ? to_f32(r[base + i]) : 0.f);
      s[i] = v;
      sq += v * v;
      rout[base + i] = from_f32(v);
    }
  }
  const float inv = rsqrtf(block_sum(sq, red) / (float)d + eps);
  if (VEC) {
    for (int i = threadIdx.x * V; i < d; i += blockDim.x * V) {
      alignas(16) T po[V];
#pragma unroll
      for (int j = 0; j < V; ++j) po[j] = from_f32(s[i + j] * inv * w[i + j]);
      *reinterpret_cast<uint4*>(y + base + i) = *reinterpret_cast<const uint4*>(po);
    }
  } else {
    for (int i = threadIdx.x; i < d; i += blockDim.x)
      y[base + i] = from_f32(s[i] * inv * w[i]);
  }
}

cudaError_t launch(const void* x, const void* r, const float* w, void* y, void* rout,
                   int rows, int d, float eps, int vec, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const int per = vec ? (d + V - 1) / V : d;
  int threads = ((per + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > 1024 ? 1024 : threads);
  const size_t smem = (size_t)d * sizeof(float);
  auto kernel = vec ? rmsnorm_kernel<true> : rmsnorm_kernel<false>;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  kernel<<<rows, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(r), w, static_cast<T*>(y),
      static_cast<T*>(rout), d, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, residual, y and the new residual are bfloat16; w is float32. r may be
// null (no residual). vec: 1 when d and every pointer allow 16-byte vectors.
// Returns cudaGetLastError().
int rmsnorm_fwd(const void* x, const void* r, const void* w, void* y, void* rout,
                int rows, int d, float eps, int vec, void* stream) {
  return (int)launch(x, r, static_cast<const float*>(w), y, rout, rows, d, eps, vec,
                     static_cast<cudaStream_t>(stream));
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
