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

// Kernel B1T: the reverse mode of B1.
//
// Replaces the reverse mode of bcm3_tpu/ops/poppk_pallas.py:82, which the
// JAX package never takes: its gradient samplers differentiate the
// lax.scan path (bcm3_tpu/likelihoods/poppk.py:617 `log_prob`). Given the
// forward's outputs (gut, cen), each (K, lanes), and the incoming
// gradients (grad_gut, grad_cen) of the same shape, each lane runs the
// adjoint recurrence from interval K-1 down to 0 in registers:
//
//     acc_ec += lam_c * cen[k];  acc_kr += lam_c * gut[k];  acc_eg += lam_g * gut[k]
//     lam_g  <- grad_gut[k] + lam_g * eg + lam_c * ka_ratio
//     lam_c  <- grad_cen[k] + lam_c * ec
//
// (lam = the adjoint of the state at the start of interval k + 1; the
// transition out of the last interval feeds no output), then chains the
// three sums through the closed forms of eg, ec and ratio, which it
// rebuilds from ka, ke, kel and dt as B1 does, including the degenerate
// branch (ratio = dt * ec, whose derivative in a is 0, as autograd takes
// it through the where of the plain version). It writes d/dka, d/dke and
// d/dkel per lane; the doses are data and get no gradient.
//
// What bounds it: memory. A lane reads 4K values (two gradients and the
// two saved outputs) and writes 3, with ~10 flops per interval. One thread
// per lane, loads coalesced across a warp as in B1; no shared memory.

template <typename T>
__global__ void poppk_propagate_adjoint_kernel(
    const T* __restrict__ ka, const T* __restrict__ ke,
    const T* __restrict__ kel, const T* __restrict__ interval,
    const T* __restrict__ gut, const T* __restrict__ cen,
    const T* __restrict__ grad_gut, const T* __restrict__ grad_cen,
    T* __restrict__ d_ka, T* __restrict__ d_ke, T* __restrict__ d_kel,
    long long lanes, int P, int K) {
  const long long l = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (l >= lanes) return;
  const int p = static_cast<int>(l % P);

  const T k_a = ka[l];
  const T a = k_a + ke[l];
  const T k_el = kel[l];
  const T dt = interval[p];
  const T eg = dev_exp(-a * dt);
  const T ec = dev_exp(-k_el * dt);
  const T d = a - k_el;
  const bool degenerate = dev_abs(d) < T(1e-12);
  const T ratio = degenerate ? dt * ec : (ec - eg) / d;
  const T ka_ratio = k_a * ratio;

  T acc_eg = T(0), acc_ec = T(0), acc_kr = T(0);
  T lam_g = grad_gut[(K - 1) * lanes + l];
  T lam_c = grad_cen[(K - 1) * lanes + l];
  for (int k = K - 2; k >= 0; --k) {
    const long long i = k * lanes + l;
    const T g = gut[i];
    const T c = cen[i];
    acc_ec = acc_ec + lam_c * c;
    acc_kr = acc_kr + lam_c * g;
    acc_eg = acc_eg + lam_g * g;
    const T next_g = grad_gut[i] + (lam_g * eg + lam_c * ka_ratio);
    lam_c = grad_cen[i] + lam_c * ec;
    lam_g = next_g;
  }

  const T g_ratio = acc_kr * k_a;
  T g_ec, g_eg, g_d;
  if (degenerate) {
    g_ec = acc_ec + g_ratio * dt;
    g_eg = acc_eg;
    g_d = T(0);
  } else {
    const T q = g_ratio / d;
    g_ec = acc_ec + q;
    g_eg = acc_eg - q;
    g_d = -(q * ratio);
  }
  const T g_a = -((g_eg * eg) * dt) + g_d;
  d_ka[l] = g_a + acc_kr * ratio;
  d_ke[l] = g_a;
  d_kel[l] = -((g_ec * ec) * dt) - g_d;
}

template <typename T>
int launch_adjoint(const void* ka, const void* ke, const void* kel,
                   const void* interval, const void* gut, const void* cen,
                   const void* grad_gut, const void* grad_cen, void* d_ka,
                   void* d_ke, void* d_kel, long long lanes, int P, int K,
                   void* stream) {
  if (lanes <= 0 || K <= 0) return static_cast<int>(cudaGetLastError());
  const int threads = 256;
  const long long blocks = (lanes + threads - 1) / threads;
  poppk_propagate_adjoint_kernel<T><<<static_cast<unsigned>(blocks), threads, 0,
                                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(ka), static_cast<const T*>(ke),
      static_cast<const T*>(kel), static_cast<const T*>(interval),
      static_cast<const T*>(gut), static_cast<const T*>(cen),
      static_cast<const T*>(grad_gut), static_cast<const T*>(grad_cen),
      static_cast<T*>(d_ka), static_cast<T*>(d_ke), static_cast<T*>(d_kel),
      lanes, P, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int bcm3_poppk_propagate_adjoint_f32(
    const void* ka, const void* ke, const void* kel, const void* interval,
    const void* gut, const void* cen, const void* grad_gut,
    const void* grad_cen, void* d_ka, void* d_ke, void* d_kel,
    long long lanes, int P, int K, void* stream) {
  return launch_adjoint<float>(ka, ke, kel, interval, gut, cen, grad_gut,
                               grad_cen, d_ka, d_ke, d_kel, lanes, P, K, stream);
}

extern "C" int bcm3_poppk_propagate_adjoint_f64(
    const void* ka, const void* ke, const void* kel, const void* interval,
    const void* gut, const void* cen, const void* grad_gut,
    const void* grad_cen, void* d_ka, void* d_ke, void* d_kel,
    long long lanes, int P, int K, void* stream) {
  return launch_adjoint<double>(ka, ke, kel, interval, gut, cen, grad_gut,
                                grad_cen, d_ka, d_ke, d_kel, lanes, P, K, stream);
}

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
