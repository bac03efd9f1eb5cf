// Kernel B2: budgeted Dormand-Prince 5(4) integration of the PopPK
// transit-compartment model.
//
// Replaces the Pallas TPU kernel bcm3_tpu/ops/transit_pallas.py `_kernel`
// / `_solve_call` (public entry `transit_solve_pallas`). For each lane
// (one chain x patient) it integrates
//
//     gut'     = k_t * (k_t s)^n e^{-k_t s} / n! * dose - (ka + ke) gut
//     central' = ka gut - kel central,          s = t - last_treatment,
//
// with log n! by Stirling, over a merged grid of S stop times, for a fixed
// budget of `trips` adaptive steps. A stop pointer `seg` walks the grid:
// central is recorded at every stop reached, and a stop with a dose amount
// > 0 resets the last-treatment time and the dose. A lane soft-fails (all
// stops NaN, ok = false) on a non-finite state, on dt <= min_dt, or when
// the budget runs out before the last stop.
//
// What bounds it on an H100: arithmetic, and divergence between lanes.
// Each trip costs 7 right-hand sides with one exp and one log each plus
// the error norm, a few hundred flops on 10 values in registers, while
// the lane's memory traffic is its parameters once and S stores. Design:
// one thread per lane with the whole integrator state in registers; the
// stop grid and dose amounts are read at the lane's current stop only
// (the TPU version gathers them with one-hot masks over all S stops on
// every trip); a stop is written once, when it is reached (the TPU version
// rewrites the whole VMEM stop buffer under a mask on every trip); a lane
// leaves the trip loop as soon as it is finished or failed, which does not
// change its result because an inactive lane's state is frozen. The
// ragged last block is masked by a bounds check, so no padding is needed.
// The row-per-thread stores into the (L, S) output are not coalesced; at
// S stores per several hundred trips they are a small share of the time.
//
// Arithmetic follows the Pallas kernel operation by operation in float32,
// including the Stirling log n! (not lgammaf), so that both compute the
// same thing up to rounding. Built with --fmad=false (ops/build.py), the
// kernel also rounds like its plain PyTorch version.

#include <cuda_runtime.h>
#include <math.h>

namespace {

// Dormand-Prince 5(4) tableau, rounded to float32 from the double values
// (the same rounding the Pallas kernel's Python-float constants get).
#define F(x) static_cast<float>(x)
__constant__ float kC[7] = {F(0.0), F(1.0 / 5), F(3.0 / 10), F(4.0 / 5), F(8.0 / 9), F(1.0), F(1.0)};
__constant__ float kA[7][6] = {
    {0, 0, 0, 0, 0, 0},
    {F(1.0 / 5), 0, 0, 0, 0, 0},
    {F(3.0 / 40), F(9.0 / 40), 0, 0, 0, 0},
    {F(44.0 / 45), F(-56.0 / 15), F(32.0 / 9), 0, 0, 0},
    {F(19372.0 / 6561), F(-25360.0 / 2187), F(64448.0 / 6561), F(-212.0 / 729), 0, 0},
    {F(9017.0 / 3168), F(-355.0 / 33), F(46732.0 / 5247), F(49.0 / 176), F(-5103.0 / 18656), 0},
    {F(35.0 / 384), F(0.0), F(500.0 / 1113), F(125.0 / 192), F(-2187.0 / 6784), F(11.0 / 84)},
};
__constant__ float kB5[7] = {F(35.0 / 384), F(0.0), F(500.0 / 1113), F(125.0 / 192),
                             F(-2187.0 / 6784), F(11.0 / 84), F(0.0)};
// B5 - B4, differenced in double before rounding
__constant__ float kE[7] = {
    F(35.0 / 384 - 5179.0 / 57600), F(0.0), F(500.0 / 1113 - 7571.0 / 16695),
    F(125.0 / 192 - 393.0 / 640), F(-2187.0 / 6784 + 92097.0 / 339200),
    F(11.0 / 84 - 187.0 / 2100), F(0.0 - 1.0 / 40)};
#undef F

constexpr float kSafety = 0.9f;
constexpr float kMinFactor = 0.2f;
constexpr float kMaxFactor = 10.0f;

// max/min that return NaN when either operand is NaN, as jnp.maximum and
// torch.maximum do (fmaxf/fminf would drop the NaN)
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || isnan(a)) ? a : b;
}
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || isnan(a)) ? a : b;
}

struct Params {
  float ka, ke, kel, k_transit, n_transit, log_nfac;
};

__device__ __forceinline__ void deriv(const Params& p, float t, float gut,
                                      float cen, float lt, float dose,
                                      float* dgut, float* dcen) {
  const float ts = nan_max(t - lt, 0.0f);
  const float log_t = logf(nan_max(p.k_transit * ts, 1e-30f));
  const float transit = expf(p.n_transit * log_t - p.k_transit * ts - p.log_nfac);
  const float inflow = p.k_transit * transit * dose;
  *dgut = inflow - (p.ka + p.ke) * gut;
  *dcen = p.ka * gut - p.kel * cen;
}

__global__ void transit_dp5_kernel(
    const float* __restrict__ ka, const float* __restrict__ ke,
    const float* __restrict__ kel, const float* __restrict__ k_transit,
    const float* __restrict__ n_transit, const float* __restrict__ dose0,
    const float* __restrict__ grid, const float* __restrict__ amt,
    float* __restrict__ central, bool* __restrict__ ok_out, long long L,
    int S, int trips, float rtol, float atol, float min_dt, float first_dt) {
  const long long l = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (l >= L) return;

  Params p;
  p.ka = ka[l];
  p.ke = ke[l];
  p.kel = kel[l];
  p.k_transit = k_transit[l];
  p.n_transit = n_transit[l];
  const float n = p.n_transit;
  // Erlang log-normalizer (Stirling), loop-invariant
  p.log_nfac = 0.9189385332046727f + (n + 0.5f) * logf(n) - n +
               logf(1.0f + 1.0f / (12.0f * n));

  const float* g_row = grid + l * S;
  const float* a_row = amt + l * S;
  float* out_row = central + l * S;

  float t = g_row[0];
  float gut = 0.0f, cen = 0.0f;
  float lt = 0.0f;  // last treatment: the initial dose at t = 0
  float dose = dose0[l];
  float dt = first_dt;
  int seg = 1;
  bool ok = true;

  for (int trip = 0; trip < trips; ++trip) {
    const bool active = (seg < S) && ok;
    if (!active) break;  // an inactive lane's state no longer changes
    const float t1 = g_row[seg];
    const float remaining = nan_max(t1 - t, 0.0f);
    const bool clipped = dt >= remaining;
    const float h = nan_min(dt, remaining);

    // 7-stage embedded RK5(4)
    float kg[7], kc[7];
#pragma unroll
    for (int i = 0; i < 7; ++i) {
      float gi = gut, ci = cen;
#pragma unroll
      for (int j = 0; j < i; ++j) {
        if (kA[i][j] != 0.0f) {
          gi = gi + h * kA[i][j] * kg[j];
          ci = ci + h * kA[i][j] * kc[j];
        }
      }
      deriv(p, t + kC[i] * h, gi, ci, lt, dose, &kg[i], &kc[i]);
    }
    float g5 = gut, c5 = cen, eg = 0.0f, ec = 0.0f;
#pragma unroll
    for (int i = 0; i < 7; ++i) {
      if (kB5[i] != 0.0f) {
        g5 = g5 + h * kB5[i] * kg[i];
        c5 = c5 + h * kB5[i] * kc[i];
      }
      if (kE[i] != 0.0f) {
        eg = eg + h * kE[i] * kg[i];
        ec = ec + h * kE[i] * kc[i];
      }
    }

    const float sc_g = atol + rtol * nan_max(fabsf(gut), fabsf(g5));
    const float sc_c = atol + rtol * nan_max(fabsf(cen), fabsf(c5));
    const float rg = eg / sc_g, rc = ec / sc_c;
    float err_norm = sqrtf(0.5f * (rg * rg + rc * rc));
    err_norm = remaining > 0.0f ? err_norm : 0.0f;
    const bool accept = err_norm <= 1.0f;  // the lane is active here
    float factor = kSafety * powf(err_norm + 1e-30f, -0.2f);
    // clip that keeps a NaN factor NaN, like jnp.clip / torch.clamp
    factor = factor < kMinFactor ? kMinFactor : (factor > kMaxFactor ? kMaxFactor : factor);
    const float new_dt = (clipped && accept) ? dt : h * factor;
    const float t_new = accept ? (clipped ? t1 : t + h) : t;
    if (accept) {
      gut = g5;
      cen = c5;
    }
    t = t_new;
    dt = new_dt;
    const bool reached = accept && (t_new >= t1);
    if (reached) {
      out_row[seg] = cen;  // record central at the stop
      const float a = a_row[seg];
      if (a > 0.0f) {  // dose event
        lt = t1;
        dose = a;
      }
      seg += 1;
    }
    const bool finite = isfinite(gut) && isfinite(cen) && (new_dt > min_dt);
    ok = ok && finite;
  }

  ok = ok && (seg >= S);
  ok_out[l] = ok;
  if (ok) {
    out_row[0] = 0.0f;  // stop 0 records the initial state
  } else {
    for (int s = 0; s < S; ++s) out_row[s] = nanf("");
  }
}

}  // namespace

extern "C" int bcm3_transit_dp5_f32(
    const void* ka, const void* ke, const void* kel, const void* k_transit,
    const void* n_transit, const void* dose0, const void* grid,
    const void* amt, void* central, void* ok, long long L, int S, int trips,
    float rtol, float atol, float min_dt, float first_dt, void* stream) {
  if (L <= 0) return static_cast<int>(cudaGetLastError());
  const int threads = 128;
  const long long blocks = (L + threads - 1) / threads;
  transit_dp5_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ka), static_cast<const float*>(ke),
      static_cast<const float*>(kel), static_cast<const float*>(k_transit),
      static_cast<const float*>(n_transit), static_cast<const float*>(dose0),
      static_cast<const float*>(grid), static_cast<const float*>(amt),
      static_cast<float*>(central), static_cast<bool*>(ok), L, S, trips, rtol,
      atol, min_dt, first_dt);
  return static_cast<int>(cudaGetLastError());
}
