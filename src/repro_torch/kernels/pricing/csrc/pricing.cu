// Batched DSE design-point pricing for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/pricing/kernel.py, run_columns (Pallas body
// _columns_kernel: the elementwise f64 formula, bit-identical to
// price_plan_scalar) and run_columns_f32 (_columns_kernel_f32: the same
// formula in f32, settled through the drift band). Two formulas, each a
// line-by-line transcription of its Python original in
// src/repro_torch/core/pricing.py: _price (25 columns in, 10 out) and
// _roofline (8 in, 6 out).
//
// Bound on this card: bytes. A row reads 25 doubles and writes 10 values
// for some 60 floating-point operations (9 of them divisions), far below
// what the card can do per byte it moves. At 2^20 rows the f64 price
// entry moves ~294 MB.
//
// Design: one thread per candidate row. Inputs are one (n_in, n) float64
// stack, column c of row i at c * n + i, so a warp's load of one column
// is 32 consecutive doubles; outputs are the (n_out, n) stack in the same
// layout. There is no padding: i < n guards the tail (the TPU kernel's
// 512-row tiles, its (8, 128) f32 tiles and their validity column are for
// the TPU's vregs and XLA's executable cache).
//
// Numerics. The f64 instantiation pins every operation to IEEE
// round-to-nearest with __dadd_rn / __dsub_rn / __dmul_rn / __ddiv_rn,
// which the compiler never contracts into an FMA, and keeps the Python
// operation order (left-to-right products stay left-to-right, no constant
// is folded), so it is bit-identical to numpy. maximum and minimum follow
// numpy's rule, a if (a > b or isnan(a)) else b (with < for minimum):
// NaN propagates, and of two zeros the second operand wins. The f32
// instantiation reads the same doubles, rounds them to float in
// registers, and may contract freely: its contract is the drift band.
// Bool outputs (feasible) are written as 0 / 1.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
struct Ops;

template <>
struct Ops<double> {
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double div(double a, double b) { return __ddiv_rn(a, b); }
};

template <>
struct Ops<float> {
  static __device__ __forceinline__ float add(float a, float b) { return a + b; }
  static __device__ __forceinline__ float sub(float a, float b) { return a - b; }
  static __device__ __forceinline__ float mul(float a, float b) { return a * b; }
  static __device__ __forceinline__ float div(float a, float b) { return a / b; }
};

// numpy's maximum / minimum (see the header)
template <typename T>
__device__ __forceinline__ T np_max(T a, T b) { return (a > b || isnan(a)) ? a : b; }
template <typename T>
__device__ __forceinline__ T np_min(T a, T b) { return (a < b || isnan(a)) ? a : b; }

// pricing._price, expression by expression
template <typename T>
__device__ __forceinline__ void price_row(const double* __restrict__ in,
                                          T* __restrict__ out, int64_t n,
                                          int64_t i) {
  using O = Ops<T>;
  T v[25];
#pragma unroll
  for (int c = 0; c < 25; ++c) v[c] = static_cast<T>(in[c * n + i]);
  // pricing.FIELDS order
  const T t_comp_stage = v[0], t_net_stage = v[1], t_p2p = v[2], t_dp = v[3];
  const T n_micro = v[4], tp = v[5], pp = v[6];
  const T bwd_flop_mult = v[7], bwd_comm_mult = v[8], opt_mult = v[9];
  const T model_flops = v[10], weight_bytes = v[11], act_bytes_layer = v[12];
  const T layers_per_stage = v[13], stage_layers = v[14];
  const T n_chips = v[15], chip_peak = v[16], mem_capacity = v[17];
  const T sys_peak_flops = v[18], sys_price = v[19], sys_power = v[20];
  const T intra_comp = v[21], intra_mem = v[22], intra_net = v[23];
  const T intra_total = v[24];
  const T zero_c = T(0), one = T(1), half = T(0.5);

  // Eq. 7 forward stage time + 1F1B backward composition
  const T t_fwd = np_max(np_max(t_comp_stage, t_net_stage), t_p2p);
  const T t_bwd_comp = O::mul(t_comp_stage, bwd_flop_mult);
  const T t_bwd_net = O::mul(t_net_stage, O::mul(bwd_flop_mult, bwd_comm_mult));
  const T t_bwd = np_max(np_max(t_bwd_comp, t_bwd_net), t_p2p);
  const T t_pipe = O::mul(O::sub(O::add(n_micro, pp), one), O::add(t_fwd, t_bwd));
  const T exposed_dp =
      np_max(zero_c, O::sub(t_dp, O::mul(O::mul(n_micro, t_bwd_comp), half)));
  const T iter_time = O::add(t_pipe, exposed_dp);
  const T util_inter =
      O::div(model_flops, O::mul(O::mul(iter_time, n_chips), chip_peak));

  // per-chip memory footprint + capacity check
  const T w_bytes = O::div(weight_bytes, O::mul(tp, pp));
  const T opt_bytes = O::mul(w_bytes, opt_mult);
  const T act_per_layer = O::div(act_bytes_layer, tp);
  const T act_bytes =
      O::mul(O::mul(act_per_layer, layers_per_stage), np_min(n_micro, pp));
  const T mem = O::add(O::add(w_bytes, opt_bytes), act_bytes);
  const bool feasible = mem <= mem_capacity;

  // memory-bound derate from the intra-chip pass
  const bool derate_on = (intra_total > zero_c) & (t_fwd > zero_c);
  const T safe_intra = derate_on ? intra_total : one;
  const T per_layer_inter = O::div(np_max(t_comp_stage, t_net_stage), stage_layers);
  const T derate = np_min(one, O::div(per_layer_inter, safe_intra));
  const T utilization = derate_on ? O::mul(util_inter, derate) : util_inter;

  // compute/memory/network latency breakdown
  const T total = O::add(O::add(intra_comp, intra_mem), intra_net);
  const bool nz = total != zero_c;
  const T safe_total = nz ? total : one;
  const T zero = O::mul(total, zero_c);
  const T frac_compute = nz ? O::div(intra_comp, safe_total) : zero;
  const T frac_memory = nz ? O::div(intra_mem, safe_total) : zero;
  const T frac_network = nz ? O::div(intra_net, safe_total) : zero;

  // efficiency metrics
  const T cost_eff = O::div(O::mul(utilization, sys_peak_flops), sys_price);
  const T power_eff = O::div(O::mul(utilization, sys_peak_flops), sys_power);

  // ref.PRICE_OUT order
  out[0 * n + i] = utilization;
  out[1 * n + i] = cost_eff;
  out[2 * n + i] = power_eff;
  out[3 * n + i] = frac_compute;
  out[4 * n + i] = frac_memory;
  out[5 * n + i] = frac_network;
  out[6 * n + i] = iter_time;
  out[7 * n + i] = util_inter;
  out[8 * n + i] = mem;
  out[9 * n + i] = feasible ? one : zero_c;
}

// pricing._roofline, expression by expression
template <typename T>
__device__ __forceinline__ void roofline_row(const double* __restrict__ in,
                                             T* __restrict__ out, int64_t n,
                                             int64_t i) {
  using O = Ops<T>;
  T v[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) v[c] = static_cast<T>(in[c * n + i]);
  // ref.ROOFLINE_FIELDS order
  const T hlo_flops = v[0], hlo_bytes = v[1], collective_bytes = v[2];
  const T chips = v[3], model_flops = v[4], peak_flops = v[5];
  const T hbm_bw = v[6], link_bw = v[7];
  const T zero_c = T(0), one = T(1);

  const T t_compute = O::div(hlo_flops, O::mul(chips, peak_flops));
  const T t_memory = O::div(hlo_bytes, O::mul(chips, hbm_bw));
  const T t_collective = O::div(collective_bytes, O::mul(chips, link_bw));
  const T t_bound = np_max(np_max(t_compute, t_memory), t_collective);
  const T zero = O::mul(t_bound, zero_c);
  const T denom = O::mul(O::mul(t_bound, chips), peak_flops);
  const bool nz_denom = denom != zero_c;
  const T safe_denom = nz_denom ? denom : one;
  const T frac = nz_denom ? O::div(model_flops, safe_denom) : zero;
  const bool nz_flops = hlo_flops != zero_c;
  const T safe_flops = nz_flops ? hlo_flops : one;
  const T useful = nz_flops ? O::div(model_flops, safe_flops) : zero;

  // ref.ROOFLINE_OUT order
  out[0 * n + i] = t_compute;
  out[1 * n + i] = t_memory;
  out[2 * n + i] = t_collective;
  out[3 * n + i] = t_bound;
  out[4 * n + i] = frac;
  out[5 * n + i] = useful;
}

constexpr int kThreads = 256;

template <typename T, int ENTRY>
__global__ void __launch_bounds__(kThreads)
    pricing_kernel(const double* __restrict__ in, T* __restrict__ out, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  if (ENTRY == 0)
    price_row<T>(in, out, n, i);
  else
    roofline_row<T>(in, out, n, i);
}

template <typename T>
void launch(int entry, const double* in, void* out, int64_t n, cudaStream_t s) {
  const dim3 grid((unsigned)((n + kThreads - 1) / kThreads));
  if (entry == 0)
    pricing_kernel<T, 0><<<grid, kThreads, 0, s>>>(in, static_cast<T*>(out), n);
  else
    pricing_kernel<T, 1><<<grid, kThreads, 0, s>>>(in, static_cast<T*>(out), n);
}

}  // namespace

extern "C" {

// in: the (n_in, n) float64 column stack; out: the (n_out, n) stack, float64
// when f32 == 0 and float32 when f32 == 1. entry 0 is the price formula (25
// columns in, 10 out), entry 1 the roofline formula (8 in, 6 out).
int pricing_run(const double* in, void* out, long long n, int entry, int f32,
                void* stream) {
  if (entry != 0 && entry != 1) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f32)
    launch<float>(entry, in, out, (int64_t)n, s);
  else
    launch<double>(entry, in, out, (int64_t)n, s);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
