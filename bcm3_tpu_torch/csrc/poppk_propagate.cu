// Kernel B1: the one-compartment PopPK dosing-interval recurrence.
//
// Replaces the Pallas TPU kernel bcm3_tpu/ops/poppk_pallas.py
// `_propagate_kernel` / `_propagate_call` (public entry
// `propagate_intervals_one_compartment`). For each (chain, patient) lane
// it runs the exact two-state (gut, central) recurrence over K dosing
// intervals and returns the state at the START of every interval:
//
//     eg = exp(-(ka+ke) dt), ec = exp(-kel dt)
//     ratio = (ec - eg) / (ka + ke - kel)     (dt * ec when that is ~0)
//     cen <- cen * ec + gut * ka * ratio
//     gut <- gut * eg + dose[k]
//
// What bounds it on an H100: memory. Each lane reads 3 values and writes
// 2*K values, with a handful of flops per value, so the kernel moves
// about (3 + 2K) * sizeof(T) bytes per lane and is far below the card's
// flop/byte ridge. Design: one thread per lane, the recurrence and its
// hoisted factors in registers, nothing in shared memory. Lanes are
// indexed patient-minor (lane = chain * P + patient), so the per-interval
// stores to the (K, lanes) outputs are coalesced across a warp, and the
// per-patient tables (P and P*K values) stay in L1/L2. The TPU version's
// lane constraints (P | 128, 128 | B*P) do not apply: any B and P work,
// and the ragged last block is masked by a bounds check.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float dev_exp(float x) { return expf(x); }
__device__ __forceinline__ double dev_exp(double x) { return exp(x); }
__device__ __forceinline__ float dev_abs(float x) { return fabsf(x); }
__device__ __forceinline__ double dev_abs(double x) { return fabs(x); }

template <typename T>
__global__ void poppk_propagate_kernel(
    const T* __restrict__ ka, const T* __restrict__ ke,
    const T* __restrict__ kel, const T* __restrict__ initial_dose,
    const T* __restrict__ interval, const T* __restrict__ dose,
    T* __restrict__ out_gut, T* __restrict__ out_cen,
    long long lanes, int P, int K) {
  const long long l = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (l >= lanes) return;
  const int p = static_cast<int>(l % P);

  const T a = ka[l] + ke[l];
  const T k_el = kel[l];
  const T dt = interval[p];
  // closed-form per-interval factors are loop-invariant: hoisted
  const T eg = dev_exp(-a * dt);
  const T ec = dev_exp(-k_el * dt);
  const T d = a - k_el;
  const bool degenerate = dev_abs(d) < T(1e-12);
  const T ratio = degenerate ? dt * ec : (ec - eg) / d;
  const T ka_ratio = ka[l] * ratio;

  const T* dose_p = dose + static_cast<long long>(p) * K;
  T gut = initial_dose[p];
  T cen = T(0);
  for (int k = 0; k < K; ++k) {
    out_gut[k * lanes + l] = gut;
    out_cen[k * lanes + l] = cen;
    cen = cen * ec + gut * ka_ratio;
    gut = gut * eg + dose_p[k];
  }
}

template <typename T>
int launch(const void* ka, const void* ke, const void* kel,
           const void* initial_dose, const void* interval, const void* dose,
           void* out_gut, void* out_cen, long long lanes, int P, int K,
           void* stream) {
  if (lanes <= 0) return static_cast<int>(cudaGetLastError());
  const int threads = 256;
  const long long blocks = (lanes + threads - 1) / threads;
  poppk_propagate_kernel<T><<<static_cast<unsigned>(blocks), threads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(ka), static_cast<const T*>(ke),
      static_cast<const T*>(kel), static_cast<const T*>(initial_dose),
      static_cast<const T*>(interval), static_cast<const T*>(dose),
      static_cast<T*>(out_gut), static_cast<T*>(out_cen), lanes, P, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int bcm3_poppk_propagate_f32(
    const void* ka, const void* ke, const void* kel, const void* initial_dose,
    const void* interval, const void* dose, void* out_gut, void* out_cen,
    long long lanes, int P, int K, void* stream) {
  return launch<float>(ka, ke, kel, initial_dose, interval, dose, out_gut,
                       out_cen, lanes, P, K, stream);
}

extern "C" int bcm3_poppk_propagate_f64(
    const void* ka, const void* ke, const void* kel, const void* initial_dose,
    const void* interval, const void* dose, void* out_gut, void* out_cen,
    long long lanes, int P, int K, void* stream) {
  return launch<double>(ka, ke, kel, initial_dose, interval, dose, out_gut,
                        out_cen, lanes, P, K, stream);
}
