// Kernel B2J: budgeted Dormand-Prince 5(4) integration of the PopPK
// transit-compartment models with forward-mode tangents in the lane rates.
//
// Replaces no TPU kernel. The JAX package's gradient samplers differentiate
// the transit models through its XLA path, `_simulate_transit` ->
// `solve_at_times_budget` (bcm3_tpu/ode/dp5.py:234-349 with the right-hand
// side and dose events of bcm3_tpu/likelihoods/poppk.py:514-562), by
// reverse mode. This kernel is the port's own for that loop, as B1T is for
// B1's: it runs each lane (one chain x patient) through the solve and
// carries, beside the state, its derivatives in the lane's K rates, so a
// gradient evaluation of HMC, NUTS or VI is one launch and one contraction:
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
// order, without fused multiply-adds (see `mul`) and with the accurate
// exp/log/pow: it rounds as torch's elementwise kernels on the card do, so
// the step sequence follows the plain version's. The mean of the n + 2 squared
// scaled errors is summed in the order torch's reduction takes on the card
// ((e0 + e2) + e1, then the zeros; for n = 2 every order is exact) and
// scaled by the reciprocal of n + 2, as torch's mean on the card does (on
// the CPU torch divides, and the plain version may round otherwise there).
// Zero coefficients of the tableau, which the plain version multiplies in
// (0 * k), are left out: the same value unless k is not finite, and then
// the lane fails in both.
//
// Operations per trip with n states and K directions, counting each add,
// multiply, divide, compare, select (max, min, clamp, a choice between two
// computed values), log, exp, pow and sqrt as one, fabs and negation as
// free, a common subexpression once, and integer bookkeeping not at all
// (built without contraction, so there are no FMAs):
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
// chip_smoke.py computes the bound from a run's trip counts. A lane reads
// its K rates once and writes (1 + K) T values, so the bytes are far
// below the operations' time.
//
// What bounds it on an H100: instruction issue and latency, not the card's
// peak rates. A trip is a chain of dependent accurate logs, exps, pows and
// IEEE divisions without contraction; the lanes' trip counts differ (98 to
// 768 at prior draws, a quarter of the lanes at the budget) and a warp runs
// as long as its slowest lane; the NUTS width (32,768 lanes) and the HMC/VI
// width (1,024 lanes) are small for the card; and the code is large (seven
// unrolled stages with their logs and exps), so warps that run different
// code compete for the instruction caches. This kernel's first design, a
// lane a thread with all K directions in that thread, kept 166 to 255
// registers a thread and spilled in three of its four instances; an SM held
// 8 such warps, and 1,024 lanes filled 8 of 132 SMs.
//
// Design: warp specialisation, a producer warp and K consumer warps a block.
//
// - The producer warp runs the primal solve (step size, stages, error
//   norm, controller, stops and dose events) of up to 32 lanes, a lane a
//   thread, as the plain version orders it. Consumer warp j carries tangent
//   direction j of the same lanes, a lane a thread, in the plain version's
//   arithmetic: a direction reads only the primal and its own tangents, so
//   it rounds as in a solve that carries all K at once. j is a warp-uniform
//   runtime index and a seed (the derivative of a rate in itself) a select
//   on it: all consumer warps run one copy of the code (a copy a direction,
//   with the seeds known at compile time, took 1.5 to 3 times as long).
// - A trip's primal values that the directions read (per stage: the time
//   since the dose, log(k_t s) and its argument, the Erlang term, the
//   stage state and slope, the clamp flags; per trip: h, the sums, the
//   scaled errors, the norm, the factor and the controller's choices, the
//   stop reached; per lane: its rates) go to the consumers through a ring
//   of `slots` trip records in shared memory, each record 32 lanes wide
//   (structure of arrays). A full and an empty named barrier a slot
//   (bar.arrive / bar.sync) hand a record over and back; the producer may
//   run slots - 1 trips ahead.
// - Lanes come from a global counter: a producer thread whose lane ends
//   takes the next (one atomicAdd per group of threads asking together),
//   and its consumers follow through the record's "new lane" flag; the
//   budget stays per lane. A lane that ends before its first trip is
//   finished by the producer alone.
// - The launch plan comes from the wrapper (transit_tangent_kernels.py
//   `launch_plan`): 32 lanes a producer warp, or 16 or 8 where the lanes
//   are too few to give every SM a block; blocks persistent, at most what
//   is resident.
// - Per-patient stop tables in shared memory beside the ring: the (P, S)
//   grid, dose amounts and stop -> observation map, and the (P,) initial
//   doses.
// - The file is compiled with contraction on, so that libdevice's float64
//   pow rounds as torch's does, and every product of the solve goes
//   through `mul` (__fmul_rn / __dmul_rn), which is never fused.
// - Early exit: a trip reaches at most one stop, so a lane with fewer trips
//   left than stops to reach fails at once (its outputs are those of a
//   failed lane either way).

#include <cuda_runtime.h>
#include <math.h>

namespace {

// ring slots at most; named barriers 1..kMaxSlots are the slots' "full",
// kMaxSlots + 1 .. 2 kMaxSlots their "empty" (barrier 0 is __syncthreads)
constexpr int kMaxSlots = 7;

__host__ __device__ constexpr int num_directions(int N) { return N == 2 ? 5 : 7; }
// a block: the producer warp and a consumer warp a direction
__host__ __device__ constexpr int block_threads(int N) { return 32 * (1 + num_directions(N)); }

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

// A product the compiler may not fuse into an FMA. build.py compiles this
// file with contraction on: under --fmad=false libdevice's float64 pow
// rounds otherwise than torch's on the card (on an H100, pow(x, -0.2) and
// pow(x, -1.2) differ in the last bit on a few inputs in a million; log,
// exp, sqrt and the float32 functions agree either way). The solve's own
// products all go through here, so that each rounds on its own as in the
// plain version.
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }

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

// s * x + y where s is a tangent seed: 1 for the direction that is the
// rate itself, 0 for every other (a select, warp-uniform in a consumer)
template <typename T>
__device__ __forceinline__ T seeded(bool is_rate, T x, T y) {
  return is_rate ? x + y : y;
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// A trip record of the ring: 32 lanes of each field, the T fields first,
// then the int fields.
template <int N>
struct Record {
  // per lane, written when the lane starts: its rates and d log n! / dn
  static constexpr int kKa = 0, kKaKe = 1, kKel = 2, kKtr = 3, kNtr = 4, kDLogNfac = 5,
                       kKpf = 6, kKpb = 7;
  static constexpr int kLaneFields = N == 3 ? 8 : 6;
  // per trip
  static constexpr int kH = kLaneFields, kDose = kH + 1, kErrNorm = kH + 2, kDPow = kH + 3,
                       kFactor = kH + 4;
  static constexpr int kS5 = kH + 5, kS4 = kS5 + N, kQ = kS4 + N, kSc = kQ + N;
  // per stage i, at kStage0 + i * kStageFields: the time since the dose,
  // the argument of the log and the log, the Erlang term, the stage state
  // and the stage slope
  static constexpr int kStage0 = kSc + N;
  static constexpr int kTs = 0, kArg = 1, kLogT = 2, kTr = 3, kYi = 4, kK = 4 + N;
  static constexpr int kStageFields = 4 + 2 * N;
  static constexpr int kTFields = kStage0 + 7 * kStageFields;
  // int fields: the control word, the stages' flags, the observation
  // recorded (-1 if none), the lane (when it starts)
  static constexpr int kCtrl = 0, kStageFlags = 1, kObs = 2, kLane = 3;
  static constexpr int kIntFields = 4;
  template <typename T>
  __host__ __device__ static constexpr int bytes() {
    return 32 * (kTFields * static_cast<int>(sizeof(T)) + kIntFields * 4);
  }
};

// the control word of a lane's record
constexpr unsigned kActive = 1u << 0;    // a trip of the lane
constexpr unsigned kNewLane = 1u << 1;   // the lane's first trip
constexpr unsigned kEndFail = 1u << 2;   // the lane failed after this trip
constexpr unsigned kPassRem = 1u << 3;   // t1 - t >= 0
constexpr unsigned kDtEqRem = 1u << 4;   // dt == rem
constexpr unsigned kDtLtRem = 1u << 5;   // dt < rem
constexpr unsigned kNormZero = 1u << 6;  // rem <= 0 or mean square 0
constexpr unsigned kPassFactor = 1u << 7;
constexpr unsigned kKeep = 1u << 8;
constexpr unsigned kAccept = 1u << 9;
constexpr unsigned kClipped = 1u << 10;
constexpr int kComp0 = 11;  // 6 bits a component: |y| == |y5|, |y| > |y5|, sgn y, sgn y5
constexpr unsigned kStop = 1u << 31;  // no trip any more: the consumers end

// a sign as two bits, and back
template <typename T>
__device__ __forceinline__ unsigned sign_bits(T x) {
  return x > T(0) ? 1u : (x < T(0) ? 2u : 0u);
}
template <typename T>
__device__ __forceinline__ T sign_of(unsigned bits) {
  return bits == 1u ? T(1) : (bits == 2u ? T(-1) : T(0));
}

template <typename T>
struct Params {
  const T* rate[7];
  const T* dose0;
  const T* grid;
  const T* amt;
  const int* obs_slot;
  T* central;
  T* jac;
  bool* ok_out;
  int* next_lane;
  int* lane_trips;
  unsigned long long* warp_slots;
  int L, P, S, T_obs, trips, lanes_per_warp, slots;
  T rtol, atol, min_dt, first_dt;
};

template <typename T>
struct Lane {
  T ka, ke, kel, ktr, ntr, kpf, kpb;
  T ka_ke, log_nfac, d_log_nfac, fill;
};

// the per-patient stop tables in shared memory
template <typename T>
struct Tables {
  const T* grid;
  const T* amt;
  const T* dose0;
  const int* obs;
};

// The primal right-hand side at (ti, yi), in the order of operations of the
// plain version; what the directions read goes to the record.
template <typename T, int N>
__device__ __forceinline__ void rhs_primal(const Lane<T>& p, T ti, const T (&yi)[N], T lt,
                                           T dose, T (&k)[N], T* rec, int ln, unsigned& flags,
                                           int i) {
  using R = Record<N>;
  T* st = rec + (R::kStage0 + i * R::kStageFields) * 32 + ln;
  const T diff = ti - lt;
  const T ts = nan_max(diff, T(0));
  const bool pass_ts = diff >= T(0);
  const T karg = mul(p.ktr, ts);
  const T floor_ = static_cast<T>(1e-300);  // 0 in float32
  T arg = nan_max(karg, floor_);
  const bool pass_arg = karg >= floor_;
  const bool zero = arg == T(0);
  if (zero) arg = T(1);
  const T log_t = d_log(arg);
  T tr = d_exp(mul(p.ntr, log_t) - mul(p.ktr, ts) - p.log_nfac);
  if (zero) tr = p.fill;
  const T gut = yi[0], cen = yi[1];
  k[0] = mul(mul(p.ktr, tr), dose) - mul(p.ka_ke, gut);
  const T a = mul(p.ka, gut) - mul(p.kel, cen);
  if constexpr (N == 2) {
    k[1] = a;
  } else {
    k[1] = (a - mul(p.kpf, cen)) + mul(p.kpb, yi[2]);
    k[2] = mul(p.kpf, cen) - mul(p.kpb, yi[2]);
  }
  st[R::kTs * 32] = ts;
  st[R::kArg * 32] = arg;
  st[R::kLogT * 32] = log_t;
  st[R::kTr * 32] = tr;
#pragma unroll
  for (int c = 0; c < N; ++c) {
    st[(R::kYi + c) * 32] = yi[c];
    st[(R::kK + c) * 32] = k[c];
  }
  flags |= (pass_ts ? 1u : 0u) << (3 * i);
  flags |= (pass_arg ? 2u : 0u) << (3 * i);
  flags |= (zero ? 4u : 0u) << (3 * i);
}

// The producer warp: the primal solve of its lanes, a lane a thread, one
// record a trip.
template <typename T, int N>
__device__ void producer(const Params<T>& a, unsigned char* ring, const Tables<T>& tb) {
  using R = Record<N>;
  constexpr int K = num_directions(N);
  constexpr int kThreads = block_threads(N);
  constexpr int kSlotBytes = R::template bytes<T>();
  const int ln = threadIdx.x & 31;
  const unsigned my_bit = 1u << ln;
  const T inv_aug = T(1) / T(N + 2);  // the mean over the n + 2 components

  bool exhausted = ln >= a.lanes_per_warp;  // no lane any more
  int l = -1;  // the lane this thread runs; -1 while it holds none
  Lane<T> p;
  const T* g_row = nullptr;
  const T* a_row = nullptr;
  const int* o_row = nullptr;
  T t = T(0), lt = T(0), dose = T(0), dt = T(0), t1 = T(0), a1 = T(0);
  T y[N];
  bool ok = true;
  int seg = a.S, trip = 0;
  unsigned long long trip_slots = 0;

  int it = 0, s = 0;
  for (;; ++it, s = s + 1 == a.slots ? 0 : s + 1) {
    if (it >= a.slots) bar_sync(1 + kMaxSlots + s, kThreads);  // the record is free
    T* rec = reinterpret_cast<T*>(ring + static_cast<size_t>(s) * kSlotBytes);
    int* irec = reinterpret_cast<int*>(rec + R::kTFields * 32);
    unsigned ctrl = 0;

    bool fresh = false;
    while (!exhausted && l < 0) {
      const unsigned group = __activemask();
      const int leader = __ffs(group) - 1;
      int base = 0;
      if (ln == leader) base = atomicAdd(a.next_lane, __popc(group));
      base = __shfl_sync(group, base, leader);
      l = base + __popc(group & (my_bit - 1u));
      if (l >= a.L) {
        exhausted = true;
        l = -1;
        break;
      }
      const int row = l % a.P;
      p.ka = a.rate[KA][l];
      p.ke = a.rate[KE][l];
      p.kel = a.rate[KEL][l];
      p.ktr = a.rate[KTR][l];
      p.ntr = a.rate[NTR][l];
      p.kpf = N == 3 ? a.rate[KPF][l] : T(0);
      p.kpb = N == 3 ? a.rate[KPB][l] : T(0);
      const T n = p.ntr;
      // Erlang log-normalizer (Stirling) and its derivative in n
      p.log_nfac = ((T(0.9189385332046727) + mul(n + T(0.5), d_log(n))) - n) +
                   d_log(T(1) + T(1) / mul(T(12), n));
      const T rc = T(1) / mul(T(12), n);
      p.d_log_nfac =
          ((d_log(n) + (n + T(0.5)) / n) - T(1)) - mul(mul(T(12), rc), rc) / (T(1) + rc);
      p.ka_ke = p.ka + p.ke;
      p.fill = d_exp(mul(n, -static_cast<T>(INFINITY)) - p.log_nfac);
      g_row = tb.grid + row * a.S;
      a_row = tb.amt + row * a.S;
      o_row = tb.obs + row * a.S;
      t = g_row[0];
#pragma unroll
      for (int c = 0; c < N; ++c) y[c] = T(0);
      lt = T(0);  // last treatment: the initial dose at t = 0
      dose = tb.dose0[row];
      if (a_row[0] > T(0)) {  // the event at stop 0
        lt = t;
        dose = a_row[0];
      }
      dt = a.first_dt;
      seg = 1;
      if (a.S > 1) {
        t1 = g_row[1];
        a1 = a_row[1];
      }
      trip = 0;
      ok = true;
      // a lane that ends before its first trip: all of it here
      bool done = seg >= a.S;
      if (!done && a.trips < a.S - seg) {  // cannot reach its last stop
        ok = false;
        done = true;
      }
      if (done) {
        a.ok_out[l] = ok;
        T* c_row = a.central + static_cast<long long>(l) * a.T_obs;
        T* j_row = a.jac + static_cast<long long>(l) * a.T_obs * K;
        for (int o = 0; o < a.T_obs; ++o) {
          if (ok && o != o_row[0]) continue;
          c_row[o] = ok ? T(0) : static_cast<T>(d_nan());
          for (int j = 0; j < K; ++j) j_row[o * K + j] = T(0);
        }
        if (a.lane_trips != nullptr) a.lane_trips[l] = 0;
        l = -1;
        continue;
      }
      fresh = true;
    }

    if (l >= 0) {
      ctrl = kActive;
      if (fresh) {
        ctrl |= kNewLane;
        rec[R::kKa * 32 + ln] = p.ka;
        rec[R::kKaKe * 32 + ln] = p.ka_ke;
        rec[R::kKel * 32 + ln] = p.kel;
        rec[R::kKtr * 32 + ln] = p.ktr;
        rec[R::kNtr * 32 + ln] = p.ntr;
        rec[R::kDLogNfac * 32 + ln] = p.d_log_nfac;
        if constexpr (N == 3) {
          rec[R::kKpf * 32 + ln] = p.kpf;
          rec[R::kKpb * 32 + ln] = p.kpb;
        }
        irec[R::kLane * 32 + ln] = l;
      }
      const T diff = t1 - t;
      const T rem = nan_max(diff, T(0));
      if (diff >= T(0)) ctrl |= kPassRem;
      if (dt == rem) ctrl |= kDtEqRem;
      if (dt < rem) ctrl |= kDtLtRem;
      const bool clipped = dt >= rem;
      const T h = nan_min(dt, rem);

      // 7-stage embedded RK5(4), the 5th- and 4th-order sums kept as they go
      T ks[7][N], s5[N], s4[N];
      unsigned sflags = 0;
#pragma unroll
      for (int i = 0; i < 7; ++i) {
        const T ti = t + mul(dp_c<T>(i), h);
        T yi[N];
#pragma unroll
        for (int c = 0; c < N; ++c) yi[c] = y[c];
#pragma unroll
        for (int m = 0; m < i; ++m) {
          if (dp_a<T>(i, m) != T(0)) {
            const T am = mul(h, dp_a<T>(i, m));
#pragma unroll
            for (int c = 0; c < N; ++c) yi[c] = yi[c] + mul(am, ks[m][c]);
          }
        }
        rhs_primal<T, N>(p, ti, yi, lt, dose, ks[i], rec, ln, sflags, i);
#pragma unroll
        for (int c = 0; c < N; ++c) {
          if (i == 0) {
            s5[c] = mul(dp_b5<T>(0), ks[0][c]);
            s4[c] = mul(dp_b4<T>(0), ks[0][c]);
          } else {
            if (dp_b5<T>(i) != T(0)) s5[c] = s5[c] + mul(dp_b5<T>(i), ks[i][c]);
            if (dp_b4<T>(i) != T(0)) s4[c] = s4[c] + mul(dp_b4<T>(i), ks[i][c]);
          }
        }
      }

      // the 5th-order solution, the error and its norm
      T y5[N], sq[N];
#pragma unroll
      for (int c = 0; c < N; ++c) {
        y5[c] = y[c] + mul(h, s5[c]);
        const T y4 = y[c] + mul(h, s4[c]);
        const T err = y5[c] - y4;
        const T ay = d_abs(y[c]), ay5 = d_abs(y5[c]);
        const T sc = a.atol + mul(a.rtol, nan_max(ay, ay5));
        const T q = err / sc;
        sq[c] = mul(q, q);
        unsigned cb = (ay == ay5 ? 1u : 0u) | (ay > ay5 ? 2u : 0u);
        cb |= sign_bits(y[c]) << 2;
        cb |= sign_bits(y5[c]) << 4;
        ctrl |= cb << (kComp0 + 6 * c);
        rec[(R::kS5 + c) * 32 + ln] = s5[c];
        rec[(R::kS4 + c) * 32 + ln] = s4[c];
        rec[(R::kQ + c) * 32 + ln] = q;
        rec[(R::kSc + c) * 32 + ln] = sc;
      }
      // the sum over the n + 2 components in the order of torch's reduction
      // on the card (components 0 and 2 first; the two bookkeeping ones add 0)
      T msq = N == 2 ? sq[0] + sq[1] : (sq[0] + sq[N - 1]) + sq[1];
      msq = mul(msq, inv_aug);
      const bool live_rem = rem > T(0);
      const T err_norm = !live_rem ? T(0) : (msq == T(0) ? T(0) : d_sqrt(msq));
      if (!live_rem || msq == T(0)) ctrl |= kNormZero;
      const bool accept = err_norm <= T(1);
      const T base = err_norm + T(1e-30);
      const T raw = mul(T(0.9), d_pow(base, T(-0.2)));
      // a clip that keeps a NaN factor NaN, like torch.clamp
      const T factor = raw < T(0.2) ? T(0.2) : (raw > T(10) ? T(10) : raw);
      if (raw >= T(0.2) && raw <= T(10)) ctrl |= kPassFactor;
      const T d_pw = mul(T(-0.2), d_pow(base, T(-1.2)));
      const bool keep = clipped && accept;
      if (keep) ctrl |= kKeep;
      if (accept) ctrl |= kAccept;
      if (clipped) ctrl |= kClipped;
      const T new_dt = keep ? dt : mul(h, factor);
      const T t_new = accept ? (clipped ? t1 : t + h) : t;
      rec[R::kH * 32 + ln] = h;
      rec[R::kDose * 32 + ln] = dose;
      rec[R::kErrNorm * 32 + ln] = err_norm;
      rec[R::kDPow * 32 + ln] = d_pw;
      rec[R::kFactor * 32 + ln] = factor;
      if (accept) {
#pragma unroll
        for (int c = 0; c < N; ++c) y[c] = y5[c];
      }
      t = t_new;
      dt = new_dt;
      int recorded = -1;
      if (accept && t_new >= t1) {  // reached the stop: record, then the dose event
        const int o = o_row[seg];
        if (o >= 0) {
          a.central[static_cast<long long>(l) * a.T_obs + o] = y[1];
          recorded = o;
        }
        if (a1 > T(0)) {
          lt = t1;
          dose = a1;
        }
        seg += 1;
        if (seg < a.S) {
          t1 = g_row[seg];
          a1 = a_row[seg];
        }
      }
      irec[R::kStageFlags * 32 + ln] = static_cast<int>(sflags);
      irec[R::kObs * 32 + ln] = recorded;
      // the lane was live (ok) when the trip began
      bool finite = new_dt > a.min_dt;
#pragma unroll
      for (int c = 0; c < N; ++c) finite = finite && isfinite(y[c]);
      ok = finite;
      ++trip;

      bool done = seg >= a.S || !ok;
      if (!done && a.trips - trip < a.S - seg) {  // cannot reach its last stop
        ok = false;
        done = true;
      }
      if (done) {
        a.ok_out[l] = ok;
        T* c_row = a.central + static_cast<long long>(l) * a.T_obs;
        const int o0 = o_row[0];  // stop 0 records the initial state
        if (ok) {
          if (o0 >= 0) {
            c_row[o0] = T(0);
            T* j_row = a.jac + (static_cast<long long>(l) * a.T_obs + o0) * K;
#pragma unroll
            for (int j = 0; j < K; ++j) j_row[j] = T(0);
          }
        } else {
          // the consumers zero the Jacobian, after their own records
          for (int o = 0; o < a.T_obs; ++o) c_row[o] = static_cast<T>(d_nan());
          ctrl |= kEndFail;
        }
        if (a.lane_trips != nullptr) a.lane_trips[l] = trip;
        l = -1;
      }
    }

    const bool stop = !__any_sync(0xffffffffu, !exhausted);
    if (__any_sync(0xffffffffu, (ctrl & kActive) != 0)) ++trip_slots;
    irec[R::kCtrl * 32 + ln] = static_cast<int>(stop ? kStop : ctrl);
    __syncwarp();
    bar_arrive(1 + s, kThreads);  // the record is full
    if (stop) break;
  }
  // wait for the consumers' last releases, so that no barrier is left half
  // way when the block ends
  for (int k = it - a.slots + 1 < 0 ? 0 : it - a.slots + 1; k < it; ++k) {
    bar_sync(1 + kMaxSlots + k % a.slots, kThreads);
  }
  if (ln == 0 && a.warp_slots != nullptr) atomicAdd(a.warp_slots, trip_slots);
}

// A consumer warp: the tangent direction j of the producer's lanes, a lane
// a thread, one record a trip, in the plain version's arithmetic. j is a
// warp-uniform runtime index, not a template parameter: every consumer warp
// runs the same code, so the warps of a block share one copy of it in the
// instruction caches (on an H100, K copies, one a direction with its seeds
// known at compile time, took 1.5 to 3 times as long).
template <typename T, int N>
__device__ __forceinline__ void consumer(const Params<T>& a, unsigned char* ring, const int j) {
  using R = Record<N>;
  constexpr int K = num_directions(N);
  constexpr int kThreads = block_threads(N);
  constexpr int kSlotBytes = R::template bytes<T>();
  const int ln = threadIdx.x & 31;
  const T inv_aug = T(1) / T(N + 2);

  int l = -1;
  T ka = T(0), ka_ke = T(0), kel = T(0), ktr = T(0), ntr = T(0), kpf = T(0), kpb = T(0);
  T d_log_nfac = T(0);
  T dy[N], d_t = T(0), d_dt = T(0);

  for (int s = 0;; s = s + 1 == a.slots ? 0 : s + 1) {
    bar_sync(1 + s, kThreads);  // the record is full
    const T* rec = reinterpret_cast<const T*>(ring + static_cast<size_t>(s) * kSlotBytes);
    const int* irec = reinterpret_cast<const int*>(rec + R::kTFields * 32);
    const unsigned ctrl = static_cast<unsigned>(irec[R::kCtrl * 32 + ln]);
    if (ctrl & kStop) break;
    if (ctrl & kActive) {
      if (ctrl & kNewLane) {
        l = irec[R::kLane * 32 + ln];
        ka = rec[R::kKa * 32 + ln];
        ka_ke = rec[R::kKaKe * 32 + ln];
        kel = rec[R::kKel * 32 + ln];
        ktr = rec[R::kKtr * 32 + ln];
        ntr = rec[R::kNtr * 32 + ln];
        d_log_nfac = rec[R::kDLogNfac * 32 + ln];
        if constexpr (N == 3) {
          kpf = rec[R::kKpf * 32 + ln];
          kpb = rec[R::kKpb * 32 + ln];
        }
#pragma unroll
        for (int c = 0; c < N; ++c) dy[c] = T(0);
        d_t = T(0);
        d_dt = T(0);
      }
      const T h = rec[R::kH * 32 + ln];
      const T dose = rec[R::kDose * 32 + ln];
      const unsigned sflags = static_cast<unsigned>(irec[R::kStageFlags * 32 + ln]);
      const T d_rem = (ctrl & kPassRem) ? -d_t : T(0);
      const T d_h =
          (ctrl & kDtEqRem) ? mul(T(0.5), d_dt + d_rem) : ((ctrl & kDtLtRem) ? d_dt : d_rem);

      T ks[7][N], dks[7][N], ds5[N], ds4[N];
#pragma unroll
      for (int i = 0; i < 7; ++i) {
        const T* st = rec + (R::kStage0 + i * R::kStageFields) * 32 + ln;
        T dyi[N];
#pragma unroll
        for (int c = 0; c < N; ++c) dyi[c] = dy[c];
#pragma unroll
        for (int m = 0; m < i; ++m) {
          if (dp_a<T>(i, m) != T(0)) {
            const T am = mul(h, dp_a<T>(i, m));
#pragma unroll
            for (int c = 0; c < N; ++c) {
              dyi[c] = dyi[c] + (mul(mul(d_h, dp_a<T>(i, m)), ks[m][c]) + mul(am, dks[m][c]));
            }
          }
        }
        // the right-hand side's tangent at stage i
        const bool pass_ts = (sflags >> (3 * i)) & 1u;
        const bool pass_arg = (sflags >> (3 * i)) & 2u;
        const bool zero = (sflags >> (3 * i)) & 4u;
        const T ts = st[R::kTs * 32];
        const T arg = st[R::kArg * 32];
        const T tr = st[R::kTr * 32];
        const T gut = st[R::kYi * 32];
        const T cen = st[(R::kYi + 1) * 32];
        const T d_ti = d_t + mul(dp_c<T>(i), d_h);
        const T d_ts = pass_ts ? d_ti : T(0);
        const T d_arg = pass_arg ? seeded(j == KTR, ts, mul(ktr, d_ts)) : T(0);
        const T d_lg = d_arg / arg;
        T d_e = seeded(j == NTR, j == NTR ? st[R::kLogT * 32] : T(0), mul(ntr, d_lg)) -
                seeded(j == KTR, ts, mul(ktr, d_ts));
        if (j == NTR) d_e = d_e - d_log_nfac;
        const T d_tr = zero ? T(0) : mul(tr, d_e);
        const T d_in = mul(seeded(j == KTR, tr, mul(ktr, d_tr)), dose);
        dks[i][0] = d_in - seeded(j == KA || j == KE, gut, mul(ka_ke, dyi[0]));
        const T d_a =
            seeded(j == KA, gut, mul(ka, dyi[0])) - seeded(j == KEL, cen, mul(kel, dyi[1]));
        if constexpr (N == 2) {
          dks[i][1] = d_a;
        } else {
          const T per = st[(R::kYi + 2) * 32];
          const T d_f = seeded(j == KPF, cen, mul(kpf, dyi[1]));
          const T d_b = seeded(j == KPB, per, mul(kpb, dyi[2]));
          dks[i][1] = (d_a - d_f) + d_b;
          dks[i][2] = d_f - d_b;
        }
#pragma unroll
        for (int c = 0; c < N; ++c) {
          ks[i][c] = st[(R::kK + c) * 32];
          if (i == 0) {
            ds5[c] = mul(dp_b5<T>(0), dks[0][c]);
            ds4[c] = mul(dp_b4<T>(0), dks[0][c]);
          } else {
            if (dp_b5<T>(i) != T(0)) ds5[c] = ds5[c] + mul(dp_b5<T>(i), dks[i][c]);
            if (dp_b4<T>(i) != T(0)) ds4[c] = ds4[c] + mul(dp_b4<T>(i), dks[i][c]);
          }
        }
      }

      // the tangents of the 5th-order solution, the error and its norm
      T dy5[N], d_sq[N];
#pragma unroll
      for (int c = 0; c < N; ++c) {
        const T s5 = rec[(R::kS5 + c) * 32 + ln];
        const T s4 = rec[(R::kS4 + c) * 32 + ln];
        const T q = rec[(R::kQ + c) * 32 + ln];
        const T sc = rec[(R::kSc + c) * 32 + ln];
        const unsigned cb = (ctrl >> (kComp0 + 6 * c)) & 63u;
        dy5[c] = dy[c] + (mul(d_h, s5) + mul(h, ds5[c]));
        const T dy4 = dy[c] + (mul(d_h, s4) + mul(h, ds4[c]));
        const T d_err = dy5[c] - dy4;
        const T d_ay = mul(sign_of<T>((cb >> 2) & 3u), dy[c]);
        const T d_ay5 = mul(sign_of<T>((cb >> 4) & 3u), dy5[c]);
        const T d_max = (cb & 1u) ? mul(T(0.5), d_ay + d_ay5) : ((cb & 2u) ? d_ay : d_ay5);
        const T d_q = (d_err - mul(q, mul(a.rtol, d_max))) / sc;
        d_sq[c] = mul(mul(T(2), q), d_q);
      }
      const T d_msq = N == 2 ? d_sq[0] + d_sq[1] : (d_sq[0] + d_sq[N - 1]) + d_sq[1];
      // torch divides by a scalar on the card as a product with its reciprocal
      const T d_mean = mul(d_msq, inv_aug);
      const T d_norm =
          (ctrl & kNormZero) ? T(0) : d_mean / mul(T(2), rec[R::kErrNorm * 32 + ln]);
      const T d_fac =
          (ctrl & kPassFactor) ? mul(T(0.9), mul(d_norm, rec[R::kDPow * 32 + ln])) : T(0);
      d_dt = (ctrl & kKeep) ? d_dt : mul(d_h, rec[R::kFactor * 32 + ln]) + mul(h, d_fac);
      if (ctrl & kAccept) {
        d_t = (ctrl & kClipped) ? T(0) : d_t + d_h;
#pragma unroll
        for (int c = 0; c < N; ++c) dy[c] = dy5[c];
      }
      const int recorded = irec[R::kObs * 32 + ln];
      if (recorded >= 0) a.jac[(static_cast<long long>(l) * a.T_obs + recorded) * K + j] = dy[1];
      if (ctrl & kEndFail) {
        T* j_col = a.jac + static_cast<long long>(l) * a.T_obs * K + j;
        for (int o = 0; o < a.T_obs; ++o) j_col[o * K] = T(0);
      }
    }
    __syncwarp();
    bar_arrive(1 + kMaxSlots + s, kThreads);  // the record is free
  }
}

template <int N, typename T>
__host__ __device__ size_t ring_bytes(int slots) {
  return static_cast<size_t>(slots) * Record<N>::template bytes<T>();
}

template <typename T>
size_t table_bytes(int P, int S) {
  return (2 * static_cast<size_t>(P) * S + P) * sizeof(T) + static_cast<size_t>(P) * S * sizeof(int);
}

template <typename T, int N>
__global__ void __launch_bounds__(block_threads(N)) transit_dp5_tangent_kernel(Params<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring = smem_raw;  // (slots, record)
  T* s_grid = reinterpret_cast<T*>(smem_raw + ring_bytes<N, T>(a.slots));  // (P, S)
  T* s_amt = s_grid + a.P * a.S;                                         // (P, S)
  T* s_dose0 = s_amt + a.P * a.S;                                        // (P,)
  int* s_obs = reinterpret_cast<int*>(s_dose0 + a.P);                    // (P, S)
  for (int i = threadIdx.x; i < a.P * a.S; i += blockDim.x) {
    s_grid[i] = a.grid[i];
    s_amt[i] = a.amt[i];
    s_obs[i] = a.obs_slot[i];
  }
  for (int i = threadIdx.x; i < a.P; i += blockDim.x) s_dose0[i] = a.dose0[i];
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  if (warp == 0) {
    producer<T, N>(a, ring, Tables<T>{s_grid, s_amt, s_dose0, s_obs});
  } else {
    consumer<T, N>(a, ring, warp - 1);  // consumer warp w carries direction w - 1
  }
}

template <typename T, int N>
size_t smem_bytes(int P, int S, int slots) {
  return ring_bytes<N, T>(slots) + table_bytes<T>(P, S);
}

// a failed runtime call also sets the last error: clear it, so that it
// is reported once, here, and not again by the next launch
int fail(cudaError_t e) {
  cudaGetLastError();
  return static_cast<int>(e);
}

template <typename T, int N>
int allow_smem(size_t smem) {
  auto kernel = transit_dp5_tangent_kernel<T, N>;
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return fail(err);
  }
  // the most shared memory the SM can carve out of L1, so that as many
  // blocks as the registers allow fit (the kernel reads almost nothing
  // through L1)
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return fail(err);
  return 0;
}

template <typename T, int N>
int occupancy(int P, int S, int slots, int* out) {
  const size_t smem = smem_bytes<T, N>(P, S, slots);
  if (int code = allow_smem<T, N>(smem)) return code;
  int device = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return fail(err);
  err = cudaDeviceGetAttribute(&out[1], cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return fail(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], transit_dp5_tangent_kernel<T, N>,
                                                      block_threads(N), smem);
  if (err != cudaSuccess) return fail(err);
  out[2] = block_threads(N);
  out[3] = static_cast<int>(smem);
  out[4] = Record<N>::template bytes<T>();
  return 0;
}

template <typename T, int N>
int launch(Params<T> a, int blocks, void* stream) {
  if (a.slots < 1 || a.slots > kMaxSlots || blocks < 1 || a.lanes_per_warp < 1 ||
      a.lanes_per_warp > 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = smem_bytes<T, N>(a.P, a.S, a.slots);
  if (int code = allow_smem<T, N>(smem)) return code;
  transit_dp5_tangent_kernel<T, N>
      <<<static_cast<unsigned>(blocks), block_threads(N), smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* ka, const void* ke, const void* kel, const void* ktr, const void* ntr,
             const void* kpf, const void* kpb, const void* dose0, const void* grid,
             const void* amt, const void* obs_slot, void* central, void* jac, void* ok,
             void* next_lane, void* lane_trips, void* warp_slots, int L, int P, int S,
             int T_obs, int n, int trips, int lanes_per_warp, int slots, int blocks, double rtol,
             double atol, double min_dt, double first_dt, void* stream) {
  if (L <= 0) return static_cast<int>(cudaGetLastError());
  Params<T> a;
  const void* rates[7] = {ka, ke, kel, ktr, ntr, kpf, kpb};
  for (int k = 0; k < 7; ++k) a.rate[k] = static_cast<const T*>(rates[k]);
  a.dose0 = static_cast<const T*>(dose0);
  a.grid = static_cast<const T*>(grid);
  a.amt = static_cast<const T*>(amt);
  a.obs_slot = static_cast<const int*>(obs_slot);
  a.central = static_cast<T*>(central);
  a.jac = static_cast<T*>(jac);
  a.ok_out = static_cast<bool*>(ok);
  a.next_lane = static_cast<int*>(next_lane);
  a.lane_trips = static_cast<int*>(lane_trips);
  a.warp_slots = static_cast<unsigned long long*>(warp_slots);
  a.L = L;
  a.P = P;
  a.S = S;
  a.T_obs = T_obs;
  a.trips = trips;
  a.lanes_per_warp = lanes_per_warp;
  a.slots = slots;
  a.rtol = static_cast<T>(rtol);
  a.atol = static_cast<T>(atol);
  a.min_dt = static_cast<T>(min_dt);
  a.first_dt = static_cast<T>(first_dt);
  if (n == 2) return launch<T, 2>(a, blocks, stream);
  if (n == 3 && kpf != nullptr && kpb != nullptr) return launch<T, 3>(a, blocks, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// rates ka, ke, kel, k_transit, n_transit, kpf, kpb ((L,) each; kpf and kpb
// null for n = 2), dose0 (P,), grid, amt (P, S), obs_slot (P, S) int32 (-1
// at a stop without an observation), outputs central (L, T), jac (L, T, K),
// ok (L,) bool, the lane counter next_lane (1,) int32 (0 at launch),
// lane_trips (L,) int32 or null, warp_slots (1,) uint64 or null (adds the
// trip records the producer warps wrote, those with a trip in them); the
// launch plan: lanes a producer warp (1-32), ring slots (1-7), blocks;
// every entry returns cudaGetLastError()
extern "C" int bcm3_transit_dp5_tangent_f32(
    const void* ka, const void* ke, const void* kel, const void* ktr, const void* ntr,
    const void* kpf, const void* kpb, const void* dose0, const void* grid, const void* amt,
    const void* obs_slot, void* central, void* jac, void* ok, void* next_lane,
    void* lane_trips, void* warp_slots, int L, int P, int S, int T_obs, int n, int trips,
    int lanes_per_warp, int slots, int blocks, double rtol, double atol, double min_dt,
    double first_dt, void* stream) {
  return dispatch<float>(ka, ke, kel, ktr, ntr, kpf, kpb, dose0, grid, amt, obs_slot, central,
                         jac, ok, next_lane, lane_trips, warp_slots, L, P, S, T_obs, n, trips,
                         lanes_per_warp, slots, blocks, rtol, atol, min_dt, first_dt, stream);
}

extern "C" int bcm3_transit_dp5_tangent_f64(
    const void* ka, const void* ke, const void* kel, const void* ktr, const void* ntr,
    const void* kpf, const void* kpb, const void* dose0, const void* grid, const void* amt,
    const void* obs_slot, void* central, void* jac, void* ok, void* next_lane,
    void* lane_trips, void* warp_slots, int L, int P, int S, int T_obs, int n, int trips,
    int lanes_per_warp, int slots, int blocks, double rtol, double atol, double min_dt,
    double first_dt, void* stream) {
  return dispatch<double>(ka, ke, kel, ktr, ntr, kpf, kpb, dose0, grid, amt, obs_slot, central,
                          jac, ok, next_lane, lane_trips, warp_slots, L, P, S, T_obs, n, trips,
                          lanes_per_warp, slots, blocks, rtol, atol, min_dt, first_dt, stream);
}

// The instance's occupancy for a launch plan's shared memory: out[0] blocks
// resident an SM, out[1] the card's SMs, out[2] threads a block, out[3]
// shared bytes a block (ring and stop tables), out[4] bytes a ring slot;
// itemsize 4 (float32) or 8 (float64), n 2 or 3
extern "C" int bcm3_transit_dp5_tangent_occupancy(int itemsize, int n, int P, int S, int slots,
                                                  void* out) {
  int* o = static_cast<int*>(out);
  if (slots < 1 || slots > kMaxSlots) return static_cast<int>(cudaErrorInvalidValue);
  if (itemsize == 4 && n == 2) return occupancy<float, 2>(P, S, slots, o);
  if (itemsize == 4 && n == 3) return occupancy<float, 3>(P, S, slots, o);
  if (itemsize == 8 && n == 2) return occupancy<double, 2>(P, S, slots, o);
  if (itemsize == 8 && n == 3) return occupancy<double, 3>(P, S, slots, o);
  return static_cast<int>(cudaErrorInvalidValue);
}
