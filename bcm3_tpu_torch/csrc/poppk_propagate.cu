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
// lax.scan path (bcm3_tpu/likelihoods/poppk.py:617 `log_prob`). Given B1's
// inputs and the incoming gradients (grad_gut, grad_cen), each (K, lanes),
// of a loss in B1's outputs, it writes d/dka, d/dke and d/dkel per lane as
// one (3, lanes) array; the doses are data and get no gradient.
//
// What bounds it on an H100: memory. The function must read the two
// incoming gradients (2K values a lane) and B1's inputs once and write 3
// values a lane, with 22 float operations per interval. Two choices
// follow from that.
//
// 1. It recomputes B1's states in registers rather than read B1's saved
//    outputs (2K more values a lane, about as many bytes as the
//    gradients): the forward costs 5 operations an interval from ka, ke,
//    kel, dt and the per-patient doses, which stay in L1/L2. Rather than
//    run the forward and then the adjoint backward (which needs all K
//    states at once: registers that grow with K, or shared memory), it
//    carries forward-mode tangents of the state in the same pass, one
//    per scalar the recurrence depends on:
//
//        tg  = d gut/d eg,  tce = d cen/d eg,  tcc = d cen/d ec,
//        tck = d cen/d ka_ratio
//
//        acc_eg += grad_gut[k] * tg + grad_cen[k] * tce
//        acc_ec += grad_cen[k] * tcc;  acc_kr += grad_cen[k] * tck
//        tce <- tce * ec + tg * ka_ratio;  tcc <- tcc * ec + cen
//        tck <- tck * ec + gut;            tg  <- tg * eg + gut
//        cen <- cen * ec + gut * ka_ratio; gut <- gut * eg + dose[k]
//
//    (the state at the start of interval k; every tangent is 0 at k = 0).
//    It needs no state storage for any K and reads the gradients in
//    address order. Then it chains the three sums through the closed forms
//    of eg, ec and ratio, including the degenerate branch (ratio = dt * ec,
//    whose derivative in a is 0, as autograd takes it through the where of
//    the plain version).
// 2. It keeps a lane's loads in flight. The NUTS and HMC paths launch it
//    on 2,048 x 16 = 32,768 lanes, a few warps per SM, where a loop that
//    waits for each interval's loads is a chain of K memory round trips.
//    The intervals are taken in chunks of kChunk, double-buffered in
//    registers: a chunk's gradients and doses are loaded one chunk ahead
//    of their use, so K = 14 waits about one round trip in all. Each value
//    is used once by its own thread, so staging it in shared memory would
//    add a copy and a barrier and share nothing. Blocks of 128 threads
//    spread 32,768 lanes over 256 blocks, all 132 SMs.
//
// One thread per lane; loads coalesced across a warp as in B1. Without
// FMA contraction (ops/build.py) it rounds operation by operation like its
// plain version, which takes the same operations in the same order.

constexpr int kAdjointThreads = 128;
constexpr int kChunk = 8;

template <typename T>
struct Chunk {
  T grad_gut[kChunk], grad_cen[kChunk], dose[kChunk];
};

template <typename T>
__device__ __forceinline__ void load_chunk(
    Chunk<T>& ch, const T* __restrict__ grad_gut, const T* __restrict__ grad_cen,
    const T* __restrict__ dose_p, int k0, int K, long long lanes, long long l) {
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    const int k = k0 + j;
    if (k < K) {
      const long long i = static_cast<long long>(k) * lanes + l;
      ch.grad_gut[j] = grad_gut[i];
      ch.grad_cen[j] = grad_cen[i];
      ch.dose[j] = dose_p[k];
    }
  }
}

template <typename T>
struct Tangents {
  T gut, cen, tg, tce, tcc, tck, acc_eg, acc_ec, acc_kr;
};

template <typename T>
__device__ __forceinline__ void step_chunk(const Chunk<T>& ch, Tangents<T>& s, int k0,
                                           int K, T eg, T ec, T ka_ratio) {
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    if (k0 + j < K) {
      const T G = ch.grad_gut[j], C = ch.grad_cen[j];
      s.acc_eg = s.acc_eg + (G * s.tg + C * s.tce);
      s.acc_ec = s.acc_ec + C * s.tcc;
      s.acc_kr = s.acc_kr + C * s.tck;
      // each right-hand side reads the values at the start of interval k
      s.tce = s.tce * ec + s.tg * ka_ratio;
      s.tcc = s.tcc * ec + s.cen;
      s.tck = s.tck * ec + s.gut;
      s.tg = s.tg * eg + s.gut;
      s.cen = s.cen * ec + s.gut * ka_ratio;
      s.gut = s.gut * eg + ch.dose[j];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kAdjointThreads) poppk_propagate_adjoint_kernel(
    const T* __restrict__ ka, const T* __restrict__ ke,
    const T* __restrict__ kel, const T* __restrict__ initial_dose,
    const T* __restrict__ interval, const T* __restrict__ dose,
    const T* __restrict__ grad_gut, const T* __restrict__ grad_cen,
    T* __restrict__ d_rates, long long lanes, int P, int K) {
  const long long l = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (l >= lanes) return;
  const int p = static_cast<int>(l % P);
  const T* dose_p = dose + static_cast<long long>(p) * K;

  // the first chunk's loads go out before the set-up waits on the rates
  Chunk<T> a_chunk, b_chunk;
  load_chunk(a_chunk, grad_gut, grad_cen, dose_p, 0, K, lanes, l);

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

  Tangents<T> s{initial_dose[p], T(0), T(0), T(0), T(0), T(0), T(0), T(0), T(0)};
  for (int k0 = 0; k0 < K; k0 += 2 * kChunk) {
    load_chunk(b_chunk, grad_gut, grad_cen, dose_p, k0 + kChunk, K, lanes, l);
    step_chunk(a_chunk, s, k0, K, eg, ec, ka_ratio);
    load_chunk(a_chunk, grad_gut, grad_cen, dose_p, k0 + 2 * kChunk, K, lanes, l);
    step_chunk(b_chunk, s, k0 + kChunk, K, eg, ec, ka_ratio);
  }

  const T g_ratio = s.acc_kr * k_a;
  T g_ec, g_eg, g_d;
  if (degenerate) {
    g_ec = s.acc_ec + g_ratio * dt;
    g_eg = s.acc_eg;
    g_d = T(0);
  } else {
    const T q = g_ratio / d;
    g_ec = s.acc_ec + q;
    g_eg = s.acc_eg - q;
    g_d = -(q * ratio);
  }
  const T g_a = -((g_eg * eg) * dt) + g_d;
  d_rates[l] = g_a + s.acc_kr * ratio;
  d_rates[lanes + l] = g_a;
  d_rates[2 * lanes + l] = -((g_ec * ec) * dt) - g_d;
}

template <typename T>
int launch_adjoint(const void* ka, const void* ke, const void* kel,
                   const void* initial_dose, const void* interval, const void* dose,
                   const void* grad_gut, const void* grad_cen, void* d_rates,
                   long long lanes, int P, int K, void* stream) {
  if (lanes <= 0) return static_cast<int>(cudaGetLastError());
  const long long blocks = (lanes + kAdjointThreads - 1) / kAdjointThreads;
  poppk_propagate_adjoint_kernel<T><<<static_cast<unsigned>(blocks), kAdjointThreads, 0,
                                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(ka), static_cast<const T*>(ke),
      static_cast<const T*>(kel), static_cast<const T*>(initial_dose),
      static_cast<const T*>(interval), static_cast<const T*>(dose),
      static_cast<const T*>(grad_gut), static_cast<const T*>(grad_cen),
      static_cast<T*>(d_rates), lanes, P, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int bcm3_poppk_propagate_adjoint_f32(
    const void* ka, const void* ke, const void* kel, const void* initial_dose,
    const void* interval, const void* dose, const void* grad_gut,
    const void* grad_cen, void* d_rates, long long lanes, int P, int K,
    void* stream) {
  return launch_adjoint<float>(ka, ke, kel, initial_dose, interval, dose, grad_gut,
                               grad_cen, d_rates, lanes, P, K, stream);
}

extern "C" int bcm3_poppk_propagate_adjoint_f64(
    const void* ka, const void* ke, const void* kel, const void* initial_dose,
    const void* interval, const void* dose, const void* grad_gut,
    const void* grad_cen, void* d_rates, long long lanes, int P, int K,
    void* stream) {
  return launch_adjoint<double>(ka, ke, kel, initial_dose, interval, dose, grad_gut,
                                grad_cen, d_rates, lanes, P, K, stream);
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
