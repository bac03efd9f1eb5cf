// Kernel B2J: budgeted Dormand-Prince 5(4) integration of the PopPK
// transit-compartment models with forward-mode tangents in the lane rates.
//
// Replaces no TPU kernel. The JAX package's gradient samplers differentiate
// the transit models through its XLA path, `_simulate_transit` ->
// `solve_at_times_budget` (bcm3_tpu/ode/dp5.py:234-349 with the right-hand
// side and dose events of bcm3_tpu/likelihoods/poppk.py:514-562), by
// reverse mode. This kernel is the port's own for that loop, as B1T is for
// B1's: one thread runs one lane (one chain x patient) through the solve
// and carries, beside the state, its derivatives in the lane's K rates:
//
//     one_transit (N = 2, K = 5): ka, ke, kel, k_transit, n_transit
//     two_transit (N = 3, K = 7): the same and kpf, kpb
//
//     gut'     = k_t (k_t s)^n e^{-k_t s} / n! * dose - (ka + ke) gut
//     central' = ka gut - kel central [- kpf central + kpb periph]
//     periph'  = kpf central - kpb periph,       s = t - last_treatment,
//
// with log n! by Stirling, over the merged grid of S stop times of the
// lane's patient, for a budget of `trips` adaptive steps, in float32 or
// float64 (a template parameter, as N is). The error norm is the root mean
// square over the n + 2 augmented components (gut, central, [periph],
// last_treatment, dose), as the XLA path takes it, not B2's two-component
// Pallas norm. Its outputs: the central amount at each observation, the
// lane's ok, and the (T, K) derivatives of those amounts. The derivatives
// flow where JAX's reverse mode sends them: through the seven stages, the
// controller's factor 0.9 (err + 1e-30)^-0.2 except where it is clipped to
// [0.2, 10], hence the step size, t through the step (t + h), and the
// recorded states; not through accept, clipped or reached, nor through a
// clipped landing on a stop or a dose event, which set constants. A
// minimum or maximum of two equal operands passes half of each tangent, as
// torch and jax differentiate them; a clamp passes its operand's tangent
// at its bound.
//
// The sqrt of the error norm is zero-safe (a zero derivative where its
// argument is exactly 0, the departure from bcm3_tpu/ode/dp5.py:308-310 that
// ode/dp5.py `_safe_sqrt` makes). In float32 the floor 1e-300 of
// log(k_t s) is 0: at s = 0 the Erlang term is set to its value
// exp(n * -inf - log n!) with a zero tangent, as
// likelihoods/poppk.py `_simulate_transit` does where autograd records.
//
// Arithmetic follows the plain version (ops/transit_tangent_kernels.py
// `transit_jacobian_plain`, itself the eager solve of
// likelihoods/poppk.py `_simulate_transit` operation for operation) in its
// order, built with --fmad=false and the accurate exp/log/pow: the primal
// rounds as torch's elementwise kernels on the card do, so the step
// sequence follows the plain version's. The mean of the n + 2 squared
// scaled errors is summed in the order torch's reduction takes on the card
// ((e0 + e2) + e1, then the zeros; for n = 2 every order is exact) and
// scaled by the reciprocal of n + 2, as torch's mean on the card does (on
// the CPU torch divides, and the plain version may round otherwise there).
// Zero coefficients of the tableau, which the plain version multiplies in
// (0 * k), are left out: the same value unless k is not finite, and then
// the lane fails in both.
//
// What bounds it on an H100: arithmetic, and divergence between lanes. A
// lane reads its K rates once and writes (1 + K) T values, while it runs
// tens to hundreds of trips of thousands of float operations on values held
// in registers. Operations per trip with n states and K directions,
// counting each add, multiply, divide, compare, select (max, min, clamp, a
// choice between two computed values), log, exp, pow and sqrt as one,
// fabs and negation as free, a common subexpression once, and integer
// bookkeeping not at all (built without contraction, so there are no FMAs):
//
//     step size h and its tangents             6 + 4K
//     stage times and their tangents           7 (2 + 2K)
//     stage states: 20 non-zero a_ij           20 (1 + 2n + K + 4nK)
//     7 right-hand sides                       7 (22 + 15K + 9) at n = 2,
//                                              7 (27 + 20K + 11) at n = 3
//                                              (the last terms: the seeds)
//     5th- and 4th-order sums                  20n + 20nK
//     solution, error and norm                 18n - 1 + 21nK
//     controller and bookkeeping               26 + n + 13K
//
// which makes 2,430 operations a trip at n = 2, K = 5 and 4,446 at n = 3,
// K = 7, and 25 for a lane's set-up (log n!, its derivative, the fill)
// (ops/transit_tangent_kernels.py OPS_PER_TRIP, OPS_LANE_SETUP);
// chip_smoke.py computes the bound from a run's trip counts.
//
// Design:
//
// - All K directions at once: each value of the solve carries a K-vector of
//   tangents, and a trip computes the primal and every direction together,
//   so the right-hand side's logs and exps are evaluated once for all K.
//   A direction's seed (the derivative of a rate in itself) is a
//   compile-time index: the products with a seed of 0 or 1 drop out. The
//   stage tangents (7 x N x K) live in registers; the compiler keeps only
//   the stages still needed (stage 1's until stage 7, stage 2's until
//   stage 6, ...). chip_smoke.py prints ptxas's registers and spills of
//   each instance.
// - Persistent launch with lane refill, as B2: as many blocks as fit on the
//   card at once, each thread takes a lane from a global counter (one
//   atomicAdd a warp) and the next when its lane ends; the budget stays per
//   lane.
// - Per-patient stop tables in shared memory: the (P, S) grid, dose amounts
//   and stop -> observation map, and the (P,) initial doses.
// - Early exit: a trip reaches at most one stop, so a lane with fewer trips
//   left than stops to reach fails at once (its outputs are those of a
//   failed lane either way).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;

// the tangent directions, in the order of the Jacobian's last axis
constexpr int KA = 0, KE = 1, KEL = 2, KTR = 3, NTR = 4, KPF = 5, KPB = 6;

// Dormand-Prince 5(4) tableau, rounded to T from the double values (as
// torch rounds a Python float multiplying a tensor of dtype T)
template <typename T>
__device__ __forceinline__ constexpr T dp_c(int i) {
  return i == 1 ? T(1.0 / 5) : i == 2 ? T(3.0 / 10) : i == 3 ? T(4.0 / 5)
       : i == 4 ? T(8.0 / 9) : i >= 5 ? T(1.0) : T(0.0);
}
template <typename T>
__device__ __forceinline__ constexpr T dp_a(int i, int j) {
  switch (i * 8 + j) {
    case 8: return T(1.0 / 5);
    case 16: return T(3.0 / 40);
    case 17: return T(9.0 / 40);
    case 24: return T(44.0 / 45);
    case 25: return T(-56.0 / 15);
    case 26: return T(32.0 / 9);
    case 32: return T(19372.0 / 6561);
    case 33: return T(-25360.0 / 2187);
    case 34: return T(64448.0 / 6561);
    case 35: return T(-212.0 / 729);
    case 40: return T(9017.0 / 3168);
    case 41: return T(-355.0 / 33);
    case 42: return T(46732.0 / 5247);
    case 43: return T(49.0 / 176);
    case 44: return T(-5103.0 / 18656);
    case 48: return T(35.0 / 384);
    case 50: return T(500.0 / 1113);
    case 51: return T(125.0 / 192);
    case 52: return T(-2187.0 / 6784);
    case 53: return T(11.0 / 84);
    default: return T(0.0);
  }
}
template <typename T>
__device__ __forceinline__ constexpr T dp_b5(int i) {
  return i < 6 ? dp_a<T>(6, i) : T(0.0);
}
template <typename T>
__device__ __forceinline__ constexpr T dp_b4(int i) {
  return i == 0 ? T(5179.0 / 57600) : i == 2 ? T(7571.0 / 16695)
       : i == 3 ? T(393.0 / 640) : i == 4 ? T(-92097.0 / 339200)
       : i == 5 ? T(187.0 / 2100) : i == 6 ? T(1.0 / 40) : T(0.0);
}

__device__ __forceinline__ float d_log(float x) { return logf(x); }
__device__ __forceinline__ double d_log(double x) { return log(x); }
__device__ __forceinline__ float d_exp(float x) { return expf(x); }
__device__ __forceinline__ double d_exp(double x) { return exp(x); }
__device__ __forceinline__ float d_pow(float x, float y) { return powf(x, y); }
__device__ __forceinline__ double d_pow(double x, double y) { return pow(x, y); }
__device__ __forceinline__ float d_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double d_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float d_abs(float x) { return fabsf(x); }
__device__ __forceinline__ double d_abs(double x) { return fabs(x); }
__device__ __forceinline__ float d_nan() { return nanf(""); }

// max/min that return NaN when the first operand is NaN, as torch.clamp
// and torch.minimum/maximum do where it matters here
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  return (a > b || isnan(a)) ? a : b;
}
template <typename T>
__device__ __forceinline__ T nan_min(T a, T b) {
  return (a < b || isnan(a)) ? a : b;
}
template <typename T>
__device__ __forceinline__ T sgn(T x) {
  return x > T(0) ? T(1) : (x < T(0) ? T(-1) : T(0));
}

template <typename T>
struct Lane {
  T ka, ke, kel, ktr, ntr, kpf, kpb;
  T ka_ke, log_nfac, d_log_nfac, fill;
};

// s * x + y where s is a tangent seed known at compile time: 1 for the
// direction that is the rate itself, 0 for every other
template <typename T>
__device__ __forceinline__ T seeded(bool is_rate, T x, T y) {
  return is_rate ? x + y : y;
}

// The right-hand side at (ti, yi) and its tangents from those of ti (dti)
// and of the state (dyi), in the order of operations of the plain version.
template <typename T, int N, int K>
__device__ __forceinline__ void rhs(const Lane<T>& p, T ti, const T (&dti)[K],
                                    const T (&yi)[N], const T (&dyi)[N][K], T lt,
                                    T dose, T (&k)[N], T (&dk)[N][K]) {
  const T diff = ti - lt;
  const T ts = nan_max(diff, T(0));
  const bool pass_ts = diff >= T(0);
  const T karg = p.ktr * ts;
  const T floor_ = static_cast<T>(1e-300);  // 0 in float32
  T arg = nan_max(karg, floor_);
  const bool pass_arg = karg >= floor_;
  const bool zero = arg == T(0);
  if (zero) arg = T(1);
  const T log_t = d_log(arg);
  T tr = d_exp(p.ntr * log_t - p.ktr * ts - p.log_nfac);
  T d_tr[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const T d_ts = pass_ts ? dti[j] : T(0);
    const T d_arg = pass_arg ? seeded(j == KTR, ts, p.ktr * d_ts) : T(0);
    const T d_lg = d_arg / arg;
    T d_e = seeded(j == NTR, log_t, p.ntr * d_lg) - seeded(j == KTR, ts, p.ktr * d_ts);
    if (j == NTR) d_e = d_e - p.d_log_nfac;
    d_tr[j] = zero ? T(0) : tr * d_e;
  }
  if (zero) tr = p.fill;
  const T gut = yi[0], cen = yi[1];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const T d_in = seeded(j == KTR, tr, p.ktr * d_tr[j]) * dose;
    dk[0][j] = d_in - seeded(j == KA || j == KE, gut, p.ka_ke * dyi[0][j]);
    const T d_a = seeded(j == KA, gut, p.ka * dyi[0][j]) - seeded(j == KEL, cen, p.kel * dyi[1][j]);
    if constexpr (N == 2) {
      dk[1][j] = d_a;
    } else {
      const T d_f = seeded(j == KPF, cen, p.kpf * dyi[1][j]);
      const T d_b = seeded(j == KPB, yi[2], p.kpb * dyi[2][j]);
      dk[1][j] = (d_a - d_f) + d_b;
      dk[2][j] = d_f - d_b;
    }
  }
  k[0] = (p.ktr * tr) * dose - p.ka_ke * gut;
  const T a = p.ka * gut - p.kel * cen;
  if constexpr (N == 2) {
    k[1] = a;
  } else {
    k[1] = (a - p.kpf * cen) + p.kpb * yi[2];
    k[2] = p.kpf * cen - p.kpb * yi[2];
  }
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads) transit_dp5_tangent_kernel(
    const T* __restrict__ r_ka, const T* __restrict__ r_ke, const T* __restrict__ r_kel,
    const T* __restrict__ r_ktr, const T* __restrict__ r_ntr,
    const T* __restrict__ r_kpf, const T* __restrict__ r_kpb,
    const T* __restrict__ dose0, const T* __restrict__ grid, const T* __restrict__ amt,
    const int* __restrict__ obs_slot, T* __restrict__ central, T* __restrict__ jac,
    bool* __restrict__ ok_out, int* __restrict__ next_lane, int* __restrict__ lane_trips,
    int L, int P, int S, int T_obs, int trips, T rtol, T atol, T min_dt, T first_dt) {
  constexpr int K = N == 2 ? 5 : 7;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_grid = reinterpret_cast<T*>(smem_raw);  // (P, S)
  T* s_amt = s_grid + P * S;                   // (P, S)
  T* s_dose0 = s_amt + P * S;                  // (P,)
  int* s_obs = reinterpret_cast<int*>(s_dose0 + P);  // (P, S)
  for (int i = threadIdx.x; i < P * S; i += blockDim.x) {
    s_grid[i] = grid[i];
    s_amt[i] = amt[i];
    s_obs[i] = obs_slot[i];
  }
  for (int i = threadIdx.x; i < P; i += blockDim.x) s_dose0[i] = dose0[i];
  __syncthreads();

  const unsigned my_bit = 1u << (threadIdx.x & 31u);
  const T inv_aug = T(1) / T(N + 2);  // the mean over the n + 2 components

  int l = -1;  // the lane this thread runs; -1 while it holds none
  Lane<T> p;
  const T* g_row = nullptr;
  const T* a_row = nullptr;
  const int* o_row = nullptr;
  T t = T(0), lt = T(0), dose = T(0), dt = T(0), t1 = T(0), a1 = T(0);
  T y[N], dy[N][K], d_t[K], d_dt[K];
  bool ok = true;
  int seg = S, trip = 0;

  for (;;) {
    if (l < 0) {
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
      p.ka = r_ka[l];
      p.ke = r_ke[l];
      p.kel = r_kel[l];
      p.ktr = r_ktr[l];
      p.ntr = r_ntr[l];
      p.kpf = N == 3 ? r_kpf[l] : T(0);
      p.kpb = N == 3 ? r_kpb[l] : T(0);
      const T n = p.ntr;
      // Erlang log-normalizer (Stirling) and its derivative in n
      p.log_nfac = ((T(0.9189385332046727) + (n + T(0.5)) * d_log(n)) - n) +
                   d_log(T(1) + T(1) / (T(12) * n));
      const T rec = T(1) / (T(12) * n);
      p.d_log_nfac = ((d_log(n) + (n + T(0.5)) / n) - T(1)) - ((T(12) * rec) * rec) / (T(1) + rec);
      p.ka_ke = p.ka + p.ke;
      p.fill = d_exp(n * -static_cast<T>(INFINITY) - p.log_nfac);
      g_row = s_grid + row * S;
      a_row = s_amt + row * S;
      o_row = s_obs + row * S;
      t = g_row[0];
#pragma unroll
      for (int c = 0; c < N; ++c) {
        y[c] = T(0);
#pragma unroll
        for (int j = 0; j < K; ++j) dy[c][j] = T(0);
      }
#pragma unroll
      for (int j = 0; j < K; ++j) {
        d_t[j] = T(0);
        d_dt[j] = T(0);
      }
      lt = T(0);  // last treatment: the initial dose at t = 0
      dose = s_dose0[row];
      if (a_row[0] > T(0)) {  // the event at stop 0
        lt = t;
        dose = a_row[0];
      }
      dt = first_dt;
      seg = 1;
      if (S > 1) {
        t1 = g_row[1];
        a1 = a_row[1];
      }
      trip = 0;
      ok = true;
    }

    bool done = seg >= S || !ok;
    if (!done && trips - trip < S - seg) {  // cannot reach its last stop
      ok = false;
      done = true;
    }
    if (done) {
      ok_out[l] = ok;
      T* c_row = central + static_cast<long long>(l) * T_obs;
      T* j_row = jac + static_cast<long long>(l) * T_obs * K;
      if (ok) {
        const int o = o_row[0];  // stop 0 records the initial state
        if (o >= 0) {
          c_row[o] = T(0);
#pragma unroll
          for (int j = 0; j < K; ++j) j_row[o * K + j] = T(0);
        }
      } else {
        for (int o = 0; o < T_obs; ++o) {
          c_row[o] = static_cast<T>(d_nan());
          for (int j = 0; j < K; ++j) j_row[o * K + j] = T(0);
        }
      }
      if (lane_trips != nullptr) lane_trips[l] = trip;
      l = -1;
      continue;
    }

    const T diff = t1 - t;
    const T rem = nan_max(diff, T(0));
    const bool pass_rem = diff >= T(0);
    const bool clipped = dt >= rem;
    const T h = nan_min(dt, rem);
    T d_h[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const T d_rem = pass_rem ? -d_t[j] : T(0);
      d_h[j] = dt == rem ? T(0.5) * (d_dt[j] + d_rem) : (dt < rem ? d_dt[j] : d_rem);
    }

    // 7-stage embedded RK5(4), the 5th- and 4th-order sums kept as they go
    T ks[7][N], dks[7][N][K];
    T s5[N], s4[N], ds5[N][K], ds4[N][K];
#pragma unroll
    for (int i = 0; i < 7; ++i) {
      const T ti = t + dp_c<T>(i) * h;
      T d_ti[K];
#pragma unroll
      for (int j = 0; j < K; ++j) d_ti[j] = d_t[j] + dp_c<T>(i) * d_h[j];
      T yi[N], dyi[N][K];
#pragma unroll
      for (int c = 0; c < N; ++c) {
        yi[c] = y[c];
#pragma unroll
        for (int j = 0; j < K; ++j) dyi[c][j] = dy[c][j];
      }
#pragma unroll
      for (int m = 0; m < i; ++m) {
        if (dp_a<T>(i, m) != T(0)) {
          const T a = h * dp_a<T>(i, m);
#pragma unroll
          for (int c = 0; c < N; ++c) {
            yi[c] = yi[c] + a * ks[m][c];
#pragma unroll
            for (int j = 0; j < K; ++j) {
              dyi[c][j] = dyi[c][j] + ((d_h[j] * dp_a<T>(i, m)) * ks[m][c] + a * dks[m][c][j]);
            }
          }
        }
      }
      rhs<T, N, K>(p, ti, d_ti, yi, dyi, lt, dose, ks[i], dks[i]);
#pragma unroll
      for (int c = 0; c < N; ++c) {
        if (i == 0) {
          s5[c] = dp_b5<T>(0) * ks[0][c];
          s4[c] = dp_b4<T>(0) * ks[0][c];
#pragma unroll
          for (int j = 0; j < K; ++j) {
            ds5[c][j] = dp_b5<T>(0) * dks[0][c][j];
            ds4[c][j] = dp_b4<T>(0) * dks[0][c][j];
          }
        } else {
          if (dp_b5<T>(i) != T(0)) {
            s5[c] = s5[c] + dp_b5<T>(i) * ks[i][c];
#pragma unroll
            for (int j = 0; j < K; ++j) ds5[c][j] = ds5[c][j] + dp_b5<T>(i) * dks[i][c][j];
          }
          if (dp_b4<T>(i) != T(0)) {
            s4[c] = s4[c] + dp_b4<T>(i) * ks[i][c];
#pragma unroll
            for (int j = 0; j < K; ++j) ds4[c][j] = ds4[c][j] + dp_b4<T>(i) * dks[i][c][j];
          }
        }
      }
    }

    // the 5th-order solution, the error and its norm, with their tangents
    T y5[N], dy5[N][K], q[N], sc[N], sq[N], d_sq[N][K];
#pragma unroll
    for (int c = 0; c < N; ++c) {
      y5[c] = y[c] + h * s5[c];
      const T y4 = y[c] + h * s4[c];
      const T err = y5[c] - y4;
      const T ay = d_abs(y[c]), ay5 = d_abs(y5[c]);
      sc[c] = atol + rtol * nan_max(ay, ay5);
      q[c] = err / sc[c];
      sq[c] = q[c] * q[c];
      const T sy = sgn(y[c]);
#pragma unroll
      for (int j = 0; j < K; ++j) {
        dy5[c][j] = dy[c][j] + (d_h[j] * s5[c] + h * ds5[c][j]);
        const T dy4 = dy[c][j] + (d_h[j] * s4[c] + h * ds4[c][j]);
        const T d_err = dy5[c][j] - dy4;
        const T d_ay = sy * dy[c][j];
        const T d_ay5 = sgn(y5[c]) * dy5[c][j];
        const T d_max = ay == ay5 ? T(0.5) * (d_ay + d_ay5) : (ay > ay5 ? d_ay : d_ay5);
        const T d_q = (d_err - q[c] * (rtol * d_max)) / sc[c];
        d_sq[c][j] = (T(2) * q[c]) * d_q;
      }
    }
    // the sum over the n + 2 components in the order of torch's reduction
    // on the card (components 0 and 2 first; the two bookkeeping ones add 0)
    T msq = N == 2 ? sq[0] + sq[1] : (sq[0] + sq[N - 1]) + sq[1];
    msq = msq * inv_aug;
    T d_msq[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      d_msq[j] = N == 2 ? d_sq[0][j] + d_sq[1][j] : (d_sq[0][j] + d_sq[N - 1][j]) + d_sq[1][j];
    }
    const bool live_rem = rem > T(0);
    const T err_norm = !live_rem ? T(0) : (msq == T(0) ? T(0) : d_sqrt(msq));
    const bool accept = err_norm <= T(1);
    const T base = err_norm + T(1e-30);
    const T raw = T(0.9) * d_pow(base, T(-0.2));
    // a clip that keeps a NaN factor NaN, like torch.clamp
    const T factor = raw < T(0.2) ? T(0.2) : (raw > T(10) ? T(10) : raw);
    const bool pass_factor = raw >= T(0.2) && raw <= T(10);
    const T d_pw = T(-0.2) * d_pow(base, T(-1.2));
    const bool keep = clipped && accept;
    const T new_dt = keep ? dt : h * factor;
    const T t_new = accept ? (clipped ? t1 : t + h) : t;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      // torch divides by a scalar on the card as a product with its reciprocal
      const T d_mean = d_msq[j] * inv_aug;
      const T d_norm = (!live_rem || msq == T(0)) ? T(0) : d_mean / (T(2) * err_norm);
      const T d_fac = pass_factor ? T(0.9) * (d_norm * d_pw) : T(0);
      d_dt[j] = keep ? d_dt[j] : d_h[j] * factor + h * d_fac;
      if (accept) d_t[j] = clipped ? T(0) : d_t[j] + d_h[j];
    }
    if (accept) {
#pragma unroll
      for (int c = 0; c < N; ++c) {
        y[c] = y5[c];
#pragma unroll
        for (int j = 0; j < K; ++j) dy[c][j] = dy5[c][j];
      }
    }
    t = t_new;
    dt = new_dt;
    if (accept && t_new >= t1) {  // reached the stop: record, then the dose event
      const int o = o_row[seg];
      if (o >= 0) {
        central[static_cast<long long>(l) * T_obs + o] = y[1];
        T* j_out = jac + (static_cast<long long>(l) * T_obs + o) * K;
#pragma unroll
        for (int j = 0; j < K; ++j) j_out[j] = dy[1][j];
      }
      if (a1 > T(0)) {
        lt = t1;
        dose = a1;
      }
      seg += 1;
      if (seg < S) {
        t1 = g_row[seg];
        a1 = a_row[seg];
      }
    }
    // the lane was live (ok) when the trip began
    bool finite = new_dt > min_dt;
#pragma unroll
    for (int c = 0; c < N; ++c) finite = finite && isfinite(y[c]);
    ok = finite;
    ++trip;
  }
}

template <typename T, int N>
int launch(const void* const* rates, const void* dose0, const void* grid, const void* amt,
           const void* obs_slot, void* central, void* jac, void* ok, void* next_lane,
           void* lane_trips, int L, int P, int S, int T_obs, int trips, double rtol,
           double atol, double min_dt, double first_dt, void* stream) {
  auto kernel = transit_dp5_tangent_kernel<T, N>;
  const size_t smem = (2 * static_cast<size_t>(P) * S + P) * sizeof(T) +
                      static_cast<size_t>(P) * S * sizeof(int);
  cudaError_t err = cudaSuccess;
  // a failed runtime call also sets the last error: clear it, so that it
  // is reported once, here, and not again by the next launch
  auto fail = [](cudaError_t e) {
    cudaGetLastError();
    return static_cast<int>(e);
  };
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return fail(err);
  }
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return fail(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return fail(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return fail(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long needed = (static_cast<long long>(L) + kThreads - 1) / kThreads;
  const long long resident = static_cast<long long>(per_sm) * sms;
  const long long blocks = needed < resident ? needed : resident;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(rates[0]), static_cast<const T*>(rates[1]),
      static_cast<const T*>(rates[2]), static_cast<const T*>(rates[3]),
      static_cast<const T*>(rates[4]), static_cast<const T*>(rates[5]),
      static_cast<const T*>(rates[6]), static_cast<const T*>(dose0),
      static_cast<const T*>(grid), static_cast<const T*>(amt),
      static_cast<const int*>(obs_slot), static_cast<T*>(central), static_cast<T*>(jac),
      static_cast<bool*>(ok), static_cast<int*>(next_lane), static_cast<int*>(lane_trips), L,
      P, S, T_obs, trips, static_cast<T>(rtol), static_cast<T>(atol), static_cast<T>(min_dt),
      static_cast<T>(first_dt));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* ka, const void* ke, const void* kel, const void* ktr, const void* ntr,
             const void* kpf, const void* kpb, const void* dose0, const void* grid,
             const void* amt, const void* obs_slot, void* central, void* jac, void* ok,
             void* next_lane, void* lane_trips, int L, int P, int S, int T_obs, int n,
             int trips, double rtol, double atol, double min_dt, double first_dt, void* stream) {
  if (L <= 0) return static_cast<int>(cudaGetLastError());
  const void* rates[7] = {ka, ke, kel, ktr, ntr, kpf, kpb};
  if (n == 2) {
    return launch<T, 2>(rates, dose0, grid, amt, obs_slot, central, jac, ok, next_lane,
                        lane_trips, L, P, S, T_obs, trips, rtol, atol, min_dt, first_dt, stream);
  }
  if (n == 3 && kpf != nullptr && kpb != nullptr) {
    return launch<T, 3>(rates, dose0, grid, amt, obs_slot, central, jac, ok, next_lane,
                        lane_trips, L, P, S, T_obs, trips, rtol, atol, min_dt, first_dt, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// rates ka, ke, kel, k_transit, n_transit, kpf, kpb ((L,) each; kpf and kpb
// null for n = 2), dose0 (P,), grid, amt (P, S), obs_slot (P, S) int32 (-1
// at a stop without an observation), outputs central (L, T), jac (L, T, K),
// ok (L,) bool, the lane counter next_lane (1,) int32 (0 at launch) and
// lane_trips (L,) int32 or null; every entry returns cudaGetLastError()
extern "C" int bcm3_transit_dp5_tangent_f32(
    const void* ka, const void* ke, const void* kel, const void* ktr, const void* ntr,
    const void* kpf, const void* kpb, const void* dose0, const void* grid, const void* amt,
    const void* obs_slot, void* central, void* jac, void* ok, void* next_lane,
    void* lane_trips, int L, int P, int S, int T_obs, int n, int trips, double rtol,
    double atol, double min_dt, double first_dt, void* stream) {
  return dispatch<float>(ka, ke, kel, ktr, ntr, kpf, kpb, dose0, grid, amt, obs_slot, central,
                         jac, ok, next_lane, lane_trips, L, P, S, T_obs, n, trips, rtol, atol,
                         min_dt, first_dt, stream);
}

extern "C" int bcm3_transit_dp5_tangent_f64(
    const void* ka, const void* ke, const void* kel, const void* ktr, const void* ntr,
    const void* kpf, const void* kpb, const void* dose0, const void* grid, const void* amt,
    const void* obs_slot, void* central, void* jac, void* ok, void* next_lane,
    void* lane_trips, int L, int P, int S, int T_obs, int n, int trips, double rtol,
    double atol, double min_dt, double first_dt, void* stream) {
  return dispatch<double>(ka, ke, kel, ktr, ntr, kpf, kpb, dose0, grid, amt, obs_slot, central,
                          jac, ok, next_lane, lane_trips, L, P, S, T_obs, n, trips, rtol, atol,
                          min_dt, first_dt, stream);
}
