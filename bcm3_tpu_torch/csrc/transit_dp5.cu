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
// with log n! by Stirling, over the merged grid of S stop times of the
// lane's patient, for a budget of `trips` adaptive steps. A stop pointer
// `seg` walks the grid: central is recorded at every stop reached, and a
// stop with a dose amount > 0 resets the last-treatment time and the dose.
// A lane soft-fails (all stops NaN, ok = false) on a non-finite state, on
// dt <= min_dt, or when the budget runs out before the last stop.
//
// What bounds it on an H100: arithmetic, and divergence between lanes.
// The lane's memory traffic is its 5 parameters once and S stores, while
// it takes several hundred trips of a few hundred operations each, all on
// values in registers. Float operations per trip, counting each add,
// multiply, compare, compare-and-select (max, min, clamp), divide and
// special function (logf, expf, sqrtf, powf) as one, fabsf as free (an
// operand modifier) and integer bookkeeping not at all (built without
// contraction, so there are no FMAs):
//
//     right-hand side (deriv + its time t + c_i h)   16 + 2 special = 18
//     stages 2-7: 20 non-zero a_ij, 5 each               100
//     error estimate: 6 non-zero e_i, 5 each              30
//     error norm, step control, stop bookkeeping          35
//
// A trip that reuses its first stage (below) evaluates 6 right-hand
// sides: 6 * 18 + 100 + 30 + 35 = 273 operations; a trip that evaluates
// all 7 takes 291. A lane's set-up (log n! by Stirling) takes 10.
// ops/transit_kernels.py holds these counts for the bound that
// chip_smoke.py computes from a run's trip counts.
//
// Design:
//
// - Persistent launch with lane refill. A static one-thread-per-lane
//   launch lets a warp run as long as its slowest lane, and the trip
//   counts of prior draws are spread wide (about a fifth of lanes run the
//   whole budget). Here the C launcher starts as many blocks as fit on the
//   card at once, each thread carries one lane, and when its lane ends the
//   thread writes that lane's result and takes the next lane index from a
//   global counter (one atomicAdd for the threads of a warp that need a
//   lane, a rank for each). The budget stays per lane: the trip counter
//   starts at 0 when a thread takes a lane. Which thread runs a lane does
//   not enter the lane's arithmetic, so the result does not depend on it.
//
// - Exact reuse of the first stage (FSAL). The next trip's first stage is
//   deriv(t_new + 0 * h_new, gut, cen, lt, dose). It equals a stage this
//   trip already computed, operand for operand, in two cases:
//   * after an accepted trip with t_new == t + h bit for bit and no dose
//     event: the 7th stage was evaluated at t + c_7 h = t + h (c_7 = 1) on
//     the state g_7 = gut + sum_j h a_7j k_j. That sum runs over the same
//     non-zero coefficients in the same order as the 5th-order solution
//     (a_7j = b5_j, b5_7 = 0), so it IS the accepted state (the kernel
//     takes it as the new state), and lt and dose are unchanged;
//   * after a rejected trip: t, the state, lt and dose are unchanged, so
//     the next first stage equals this one.
//   Both need t + 0 * h == t, i.e. a finite h (c_1 = 0). h is finite on
//   every trip a lane can survive: a trip with an infinite or NaN h ends
//   with a non-finite state or a NaN new_dt, so the lane fails (all NaN)
//   whatever its first stage held, with the same trip count. Otherwise
//   the first stage is evaluated.
//
// - Per-patient stop tables. Lane l belongs to patient l % P (the
//   likelihood's patient-minor layout). The (P, S) grid and dose amounts
//   and the (P,) initial doses are staged in shared memory once per block,
//   and a lane keeps its current stop's time and amount in registers,
//   reloading them only when it reaches a stop.
//
// - Early exit. A trip advances seg by at most one, so a lane with fewer
//   trips left than stops to reach cannot finish: it ends failed at once.
//   Its output is the same (a failed lane is all NaN).
//
// - Trip counts on request: the trips each lane ran (lane_trips), and the
//   trip slots each warp issued (warp_slots: per trip, the lowest thread
//   of the group of threads that run it counts one). Both pointers may be
//   null; the likelihood asks for neither.
//
// Arithmetic follows the Pallas kernel operation by operation in float32,
// including the Stirling log n! (not lgammaf). Built with --fmad=false
// (ops/build.py) and with the accurate logf/expf/powf (no fast-math
// intrinsics), the kernel rounds like its plain PyTorch version, and the
// float32 step sequence, which is sensitive to the last bit, is the same.
// The row-per-lane stores to the (L, S) output are strided; at S stores
// per several hundred trips they are a small share of the time.

#include <cuda_runtime.h>
#include <math.h>

namespace {

// Dormand-Prince 5(4) tableau, rounded to float32 from the double values
// (the same rounding the Pallas kernel's Python-float constants get). The
// 5th-order weights are the last row of dp_a (b5_7 = 0). Compile-time
// constants: in the unrolled stage loops the zero entries drop out and the
// others become immediates (a __constant__ array may be rewritten at run
// time, so the compiler could not fold its entries).
#define F(x) static_cast<float>(x)
__device__ __forceinline__ constexpr float dp_c(int i) {
  return i == 1 ? F(1.0 / 5) : i == 2 ? F(3.0 / 10) : i == 3 ? F(4.0 / 5)
       : i == 4 ? F(8.0 / 9) : i >= 5 ? 1.0f : 0.0f;
}
__device__ __forceinline__ constexpr float dp_a(int i, int j) {
  switch (i * 8 + j) {
    case 8: return F(1.0 / 5);
    case 16: return F(3.0 / 40);
    case 17: return F(9.0 / 40);
    case 24: return F(44.0 / 45);
    case 25: return F(-56.0 / 15);
    case 26: return F(32.0 / 9);
    case 32: return F(19372.0 / 6561);
    case 33: return F(-25360.0 / 2187);
    case 34: return F(64448.0 / 6561);
    case 35: return F(-212.0 / 729);
    case 40: return F(9017.0 / 3168);
    case 41: return F(-355.0 / 33);
    case 42: return F(46732.0 / 5247);
    case 43: return F(49.0 / 176);
    case 44: return F(-5103.0 / 18656);
    case 48: return F(35.0 / 384);
    case 50: return F(500.0 / 1113);
    case 51: return F(125.0 / 192);
    case 52: return F(-2187.0 / 6784);
    case 53: return F(11.0 / 84);
    default: return 0.0f;
  }
}
// B5 - B4, differenced in double before rounding
__device__ __forceinline__ constexpr float dp_e(int i) {
  return i == 0 ? F(35.0 / 384 - 5179.0 / 57600)
       : i == 2 ? F(500.0 / 1113 - 7571.0 / 16695)
       : i == 3 ? F(125.0 / 192 - 393.0 / 640)
       : i == 4 ? F(-2187.0 / 6784 + 92097.0 / 339200)
       : i == 5 ? F(11.0 / 84 - 187.0 / 2100)
       : i == 6 ? F(0.0 - 1.0 / 40) : 0.0f;
}
#undef F

constexpr float kSafety = 0.9f;
constexpr float kMinFactor = 0.2f;
constexpr float kMaxFactor = 10.0f;
constexpr int kThreads = 256;

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

__global__ void __launch_bounds__(kThreads) transit_dp5_kernel(
    const float* __restrict__ ka, const float* __restrict__ ke,
    const float* __restrict__ kel, const float* __restrict__ k_transit,
    const float* __restrict__ n_transit, const float* __restrict__ dose0,
    const float* __restrict__ grid, const float* __restrict__ amt,
    float* __restrict__ central, bool* __restrict__ ok_out,
    int* __restrict__ next_lane, int* __restrict__ lane_trips,
    unsigned long long* __restrict__ warp_slots, int L, int P, int S,
    int trips, float rtol, float atol, float min_dt, float first_dt) {
  extern __shared__ float tables[];
  float* s_grid = tables;              // (P, S)
  float* s_amt = tables + P * S;       // (P, S)
  float* s_dose0 = tables + 2 * P * S; // (P,)
  for (int i = threadIdx.x; i < P * S; i += blockDim.x) {
    s_grid[i] = grid[i];
    s_amt[i] = amt[i];
  }
  for (int i = threadIdx.x; i < P; i += blockDim.x) s_dose0[i] = dose0[i];
  __syncthreads();

  const unsigned my_bit = 1u << (threadIdx.x & 31u);
  unsigned slots = 0;  // trips this thread counted for its warp

  int l = -1;  // the lane this thread runs; -1 while it holds none
  Params p;
  const float* g_row = nullptr;
  const float* a_row = nullptr;
  float* out_row = nullptr;
  float t = 0.0f, gut = 0.0f, cen = 0.0f, lt = 0.0f, dose = 0.0f, dt = 0.0f;
  float t1 = 0.0f, a1 = 0.0f;  // the current stop's time and dose amount
  float k1g = 0.0f, k1c = 0.0f;  // the next trip's first stage, if `reuse`
  bool reuse = false, ok = true;
  int seg = S, trip = 0;

  for (;;) {
    if (l < 0) {
      // take the next lane: one atomicAdd for the threads of this warp that
      // need one, each taking the index of its rank among them
      const unsigned group = __activemask();
      const int leader = __ffs(group) - 1;
      int base = 0;
      if (static_cast<int>(threadIdx.x & 31u) == leader) {
        base = atomicAdd(next_lane, __popc(group));
      }
      base = __shfl_sync(group, base, leader);
      l = base + __popc(group & (my_bit - 1u));
      if (l >= L) break;

      const int row = l % P;
      p.ka = ka[l];
      p.ke = ke[l];
      p.kel = kel[l];
      p.k_transit = k_transit[l];
      p.n_transit = n_transit[l];
      const float n = p.n_transit;
      // Erlang log-normalizer (Stirling), fixed for the lane
      p.log_nfac = 0.9189385332046727f + (n + 0.5f) * logf(n) - n +
                   logf(1.0f + 1.0f / (12.0f * n));
      g_row = s_grid + row * S;
      a_row = s_amt + row * S;
      out_row = central + static_cast<long long>(l) * S;
      t = g_row[0];
      gut = 0.0f;
      cen = 0.0f;
      lt = 0.0f;  // last treatment: the initial dose at t = 0
      dose = s_dose0[row];
      dt = first_dt;
      seg = 1;
      if (S > 1) {
        t1 = g_row[1];
        a1 = a_row[1];
      }
      trip = 0;
      ok = true;
      reuse = false;
    }

    bool done = seg >= S || !ok;
    if (!done && trips - trip < S - seg) {  // cannot reach its last stop
      ok = false;
      done = true;
    }
    if (done) {
      ok_out[l] = ok;
      if (ok) {
        out_row[0] = 0.0f;  // stop 0 records the initial state
      } else {
        for (int s = 0; s < S; ++s) out_row[s] = nanf("");
      }
      if (lane_trips != nullptr) lane_trips[l] = trip;
      l = -1;
      continue;
    }

    if (warp_slots != nullptr) {  // the same branch for every thread
      const unsigned running = __activemask();
      if ((running & (~running + 1u)) == my_bit) ++slots;
    }

    const float remaining = nan_max(t1 - t, 0.0f);
    const bool clipped = dt >= remaining;
    const float h = nan_min(dt, remaining);

    // 7-stage embedded RK5(4); the first stage reused where exact
    float kg[7], kc[7];
    if (reuse) {
      kg[0] = k1g;
      kc[0] = k1c;
    } else {
      deriv(p, t + dp_c(0) * h, gut, cen, lt, dose, &kg[0], &kc[0]);
    }
    float gi = gut, ci = cen;
#pragma unroll
    for (int i = 1; i < 7; ++i) {
      gi = gut;
      ci = cen;
#pragma unroll
      for (int j = 0; j < i; ++j) {
        if (dp_a(i, j) != 0.0f) {
          gi = gi + h * dp_a(i, j) * kg[j];
          ci = ci + h * dp_a(i, j) * kc[j];
        }
      }
      deriv(p, t + dp_c(i) * h, gi, ci, lt, dose, &kg[i], &kc[i]);
    }
    // the 7th stage's state is the 5th-order solution (see the note)
    const float g5 = gi, c5 = ci;
    const float t7 = t + dp_c(6) * h;
    float eg = 0.0f, ec = 0.0f;
#pragma unroll
    for (int i = 0; i < 7; ++i) {
      if (dp_e(i) != 0.0f) {
        eg = eg + h * dp_e(i) * kg[i];
        ec = ec + h * dp_e(i) * kc[i];
      }
    }

    const float sc_g = atol + rtol * nan_max(fabsf(gut), fabsf(g5));
    const float sc_c = atol + rtol * nan_max(fabsf(cen), fabsf(c5));
    const float rg = eg / sc_g, rc = ec / sc_c;
    float err_norm = sqrtf(0.5f * (rg * rg + rc * rc));
    err_norm = remaining > 0.0f ? err_norm : 0.0f;
    const bool accept = err_norm <= 1.0f;
    float factor = kSafety * powf(err_norm + 1e-30f, -0.2f);
    // clip that keeps a NaN factor NaN, like jnp.clip / torch.clamp
    factor = factor < kMinFactor ? kMinFactor : (factor > kMaxFactor ? kMaxFactor : factor);
    const float new_dt = (clipped && accept) ? dt : h * factor;
    const float t_new = accept ? (clipped ? t1 : t + h) : t;
    bool fire = false;
    if (accept) {
      gut = g5;
      cen = c5;
    }
    t = t_new;
    dt = new_dt;
    if (accept && t_new >= t1) {  // reached the stop
      out_row[seg] = cen;  // record central at the stop
      if (a1 > 0.0f) {  // dose event
        lt = t1;
        dose = a1;
        fire = true;
      }
      seg += 1;
      if (seg < S) {
        t1 = g_row[seg];
        a1 = a_row[seg];
      }
    }
    // the lane was live (ok) when the trip began
    ok = isfinite(gut) && isfinite(cen) && (new_dt > min_dt);
    if (accept) {
      reuse = !fire && t_new == t7;
      k1g = kg[6];
      k1c = kc[6];
    } else {
      reuse = true;
      k1g = kg[0];
      k1c = kc[0];
    }
    ++trip;
  }

  if (warp_slots != nullptr) {
    __syncwarp();
    const unsigned warp_total = __reduce_add_sync(0xffffffffu, slots);
    if ((threadIdx.x & 31u) == 0u) {
      atomicAdd(warp_slots, static_cast<unsigned long long>(warp_total));
    }
  }
}

}  // namespace

extern "C" int bcm3_transit_dp5_f32(
    const void* ka, const void* ke, const void* kel, const void* k_transit,
    const void* n_transit, const void* dose0, const void* grid,
    const void* amt, void* central, void* ok, void* next_lane,
    void* lane_trips, void* warp_slots, int L, int P, int S, int trips,
    float rtol, float atol, float min_dt, float first_dt, void* stream) {
  if (L <= 0) return static_cast<int>(cudaGetLastError());
  // the card decides whether the (P, S) tables fit a block's shared memory
  const size_t smem = (2 * static_cast<size_t>(P) * S + P) * sizeof(float);
  cudaError_t err = cudaSuccess;
  // a failed runtime call also sets the last error: clear it, so that it
  // is reported once, here, and not again by the next launch
  auto fail = [](cudaError_t e) {
    cudaGetLastError();
    return static_cast<int>(e);
  };
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(transit_dp5_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return fail(err);
  }
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return fail(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return fail(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, transit_dp5_kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return fail(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  // every block that fits at once, and no more than the lanes need
  const long long needed = (static_cast<long long>(L) + kThreads - 1) / kThreads;
  const long long resident = static_cast<long long>(per_sm) * sms;
  const long long blocks = needed < resident ? needed : resident;
  transit_dp5_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ka), static_cast<const float*>(ke),
      static_cast<const float*>(kel), static_cast<const float*>(k_transit),
      static_cast<const float*>(n_transit), static_cast<const float*>(dose0),
      static_cast<const float*>(grid), static_cast<const float*>(amt),
      static_cast<float*>(central), static_cast<bool*>(ok),
      static_cast<int*>(next_lane), static_cast<int*>(lane_trips),
      static_cast<unsigned long long*>(warp_slots), L, P, S, trips, rtol, atol,
      min_dt, first_dt);
  return static_cast<int>(cudaGetLastError());
}
