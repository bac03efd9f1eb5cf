"""Kernel B2J: the transit models' budgeted DP5 solve with forward-mode tangents.

The gradient samplers (HMC, NUTS, VI) differentiate the transit PopPK
models through the XLA path of the JAX package: `log_prob` ->
`_simulate_transit` -> `solve_at_times_budget` (bcm3_tpu/ode/dp5.py:234-349
with the right-hand side and dose events of
bcm3_tpu/likelihoods/poppk.py:514-562), which JAX's reverse mode
differentiates. No Pallas kernel computes it: B2J is the port's own
kernel for that loop, as B1T is for B1's, and replaces no TPU kernel.

`transit_jacobian` runs the CUDA kernel in csrc/transit_dp5_tangent.cu for
tensors on a CUDA device and the plain PyTorch version
`transit_jacobian_plain` for tensors on the CPU. On a CUDA tensor it
launches the kernel or raises; it never falls back. Both return, for each
lane, the central amount at the observations, the lane's `ok`, and the
derivatives of the central amounts in the lane's K rates: ka, ke, kel,
k_transit, n_transit (`one_transit`, K = 5) and kpf, kpb (`two_transit`,
K = 7). The derivatives flow where JAX's reverse mode sends them: through
the seven stages, the controller's factor (err + 1e-30)^-0.2 where it is
not clipped, hence the step size, t through the step, and the recorded
states; not through `accept`, `clipped` or `reached`, nor through a
clipped landing on a stop or a dose event, which set constants. The error
norm is the mean over the n + 2 augmented components (the XLA path's, not
B2's two-component Pallas norm), its sqrt zero-safe as in ode/dp5.py.

The plain version runs `PopPKLikelihood._simulate_transit`'s eager solve
(ode/dp5.py `solve_at_times_budget`) operation for operation, so its
values are that solve's bit for bit, and carries the K tangents beside
the state as forward-mode AD would, all K directions in one pass with a
trailing axis (`torch.autograd.forward_ad` through the same solve takes
13 times the primal's time on the CPU). `TransitCentral` is the autograd
Function of the likelihood's gradient mode: its forward returns the
central amounts and saves the (L, T, K) Jacobian, its backward contracts
it with the incoming gradient.

Lane l belongs to patient l % P (the likelihood's patient-minor layout);
the stop grid, dose amounts and observation positions are per patient.

The kernel's launch plan is decided here, in a plain function the CPU
tests cover: `launch_plan` (lanes a producer warp, consumer warps, ring
slots, blocks) from the lanes, the model and the card's occupancy.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from bcm3_tpu_torch.ops import build

# Dormand-Prince 5(4) tableau (the constants of ode/dp5.py)
_C = [0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0]
_A = [
    [],
    [1 / 5],
    [3 / 40, 9 / 40],
    [44 / 45, -56 / 15, 32 / 9],
    [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729],
    [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656],
    [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84],
]
_B5 = [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0]
_B4 = [5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200, 187 / 2100, 1 / 40]
_SAFETY = 0.9
_MIN_FACTOR = 0.2
_MAX_FACTOR = 10.0

# the lane rates, in the order of the Jacobian's last axis: the first five
# for one_transit, all seven for two_transit
RATES = ("ka", "ke", "kel", "k_transit", "n_transit", "kpf", "kpb")

# the floor of log(k_transit * t_since) (bcm3_tpu/likelihoods/poppk.py:527)
TRANSIT_LOG_FLOOR = 1e-300

# Float operations of the kernel per lane, as counted in the note of
# csrc/transit_dp5_tangent.cu: a trip, by number of states n, and a lane's
# set-up. The work of a lane that runs m trips is SETUP + m * TRIP[n].
OPS_PER_TRIP = {2: 2430, 3: 4446}
OPS_LANE_SETUP = 25

# the lane index is int32 and the lane counter overshoots L by at most the
# card's resident threads
_MAX_LANES = 2**31 - 2**20

# The kernel's launch plan (csrc/transit_dp5_tangent.cu): a block is one
# producer warp, which runs the primal solve of up to 32 lanes, and a
# consumer warp a tangent direction, handed over through a ring of
# RING_SLOTS trip records in shared memory; LANES_PER_WARP the producer
# warp's choices.
RING_SLOTS = 2
LANES_PER_WARP = (32, 16, 8)
# shared memory a block may use on an H100: the ring and the stop tables
# must fit in it (at bench.py's 16 patients x 38 stops they take 28-62 KB)
SHARED_LIMIT = 232_448


def record_bytes(n, itemsize):
    """Bytes of one ring slot (csrc's Record<N>): 32 lanes of the lane's
    rates, the trip's fields and seven stages' fields in the dtype, and
    four int fields."""
    lane = 8 if n == 3 else 6
    fields = lane + 5 + 4 * n + 7 * (4 + 2 * n)
    return 32 * (fields * itemsize + 4 * 4)


def shared_bytes(n, itemsize, P, S, slots=RING_SLOTS):
    """A block's shared memory: the ring and the per-patient stop tables
    (grid and dose amounts in the dtype, initial doses, stop ->
    observation as int32)."""
    return slots * record_bytes(n, itemsize) + (2 * P * S + P) * itemsize + P * S * 4


def launch_plan(L, n, sms, blocks_per_sm):
    """B2J's launch plan for L lanes of a model of n states, on a card of
    `sms` SMs that holds `blocks_per_sm` of the kernel's blocks each: 32
    lanes a producer warp, or 16 or 8 where fewer blocks would leave SMs
    without one; consumer warps a block; ring slots; blocks, persistent
    and at most what is resident (the lane counter refills the threads
    whose lanes end)."""
    K = 5 if n == 2 else 7
    lanes = next((w for w in LANES_PER_WARP[:-1] if -(-L // w) >= sms), LANES_PER_WARP[-1])
    return dict(lanes_per_warp=lanes, consumer_warps=K, slots=RING_SLOTS, threads=32 * (1 + K),
                blocks=max(1, min(-(-L // lanes), blocks_per_sm * sms)))


@functools.lru_cache(maxsize=None)
def _occupancy(device_index, itemsize, n, P, S):
    """The card's SMs and the kernel instance's resident blocks an SM at
    this table size (asked of the CUDA runtime once per shape); raises if
    the compiled block is not the plan's."""
    out = (ctypes.c_int * 5)()
    with torch.cuda.device(device_index):
        code = build.library().bcm3_transit_dp5_tangent_occupancy(itemsize, n, P, S, RING_SLOTS,
                                                                   out)
    build.check_launch("transit_dp5_tangent occupancy", code)
    per_sm, sms, threads, smem, record = out
    want = (launch_plan(1, n, 1, 1)["threads"], shared_bytes(n, itemsize, P, S),
            record_bytes(n, itemsize))
    if (threads, smem, record) != want:
        raise RuntimeError(f"transit_dp5_tangent: the kernel's block (threads, shared bytes, "
                           f"record bytes) {(threads, smem, record)}, the plan's {want}")
    if per_sm < 1:
        raise RuntimeError(f"transit_dp5_tangent: no block fits an SM ({smem} shared bytes)")
    return sms, per_sm


def log_floor_is_zero(dtype) -> bool:
    """Whether TRANSIT_LOG_FLOOR rounds to 0 in dtype (it does in float32)."""
    return float(torch.tensor(TRANSIT_LOG_FLOOR, dtype=dtype)) == 0.0


def num_states(rates) -> int:
    """The model's compartments, from the rates given: 2 (one_transit) or 3."""
    return 3 if "kpf" in rates else 2


def _check_tables(rates, grid, obs_pos):
    n = num_states(rates)
    names = RATES[: 5 if n == 2 else 7]
    missing = [k for k in names if k not in rates]
    if missing:
        raise ValueError(f"rates miss {missing}")
    L, (P, S), T = rates["ka"].shape[0], grid.shape, obs_pos.shape[1]
    if P < 1 or L % P != 0:
        raise ValueError(f"{L} lanes do not split evenly over {P} patients")
    return n, names, L, P, S, T


def transit_jacobian_plain(
    rates, grid, amt, dose0, obs_pos, trips=768, rtol=1e-6, atol=1e-4, min_dt=1e-5,
    first_dt=1e-2, trip_counts=False,
):
    """Plain PyTorch version: the eager solve of `_simulate_transit` with
    forward-mode tangents carried beside the state.

    rates: dict of (L,) tensors (RATES[:5], or all seven for the
    two-compartment model); grid, amt: (P, S) stop times and dose amounts
    (0 where none); dose0: (P,) initial doses; obs_pos: (P, T) int64, the
    stop of each observation. Computes in the dtype of `grid`. Returns
    (central (L, T), jac (L, T, K), ok (L,) bool), and with `trip_counts`
    also the trips each lane was active, (L,) int32. A failed lane has NaN
    central amounts and a zero Jacobian."""
    n, names, L, P, S, T = _check_tables(rates, grid, obs_pos)
    K = len(names)
    dev, dtype = grid.device, grid.dtype
    pat = torch.arange(L, device=dev) % P
    ka, ke, kel, k_tr, n_tr = (rates[k] for k in names[:5])
    kpf, kpb = (rates["kpf"], rates["kpb"]) if n == 3 else (None, None)
    eye = torch.eye(K, dtype=dtype, device=dev)
    seed = {name: eye[i] for i, name in enumerate(names)}  # each rate's own tangent

    # the lane constants of _simulate_transit, and their tangents
    log_nfac = (
        0.9189385332046727
        + (n_tr + 0.5) * torch.log(n_tr)
        - n_tr
        + torch.log(1.0 + 1.0 / (12.0 * n_tr))
    )
    rec = 1.0 / (12.0 * n_tr)
    d_log_nfac = (torch.log(n_tr) + (n_tr + 0.5) / n_tr - 1.0 - 12.0 * rec * rec / (1.0 + rec))
    d_log_nfac = d_log_nfac[:, None] * seed["n_transit"]  # (L, K)
    ka_ke = ka + ke
    d_ka_ke = seed["ka"] + seed["ke"]
    floor = float(torch.tensor(TRANSIT_LOG_FLOOR, dtype=dtype))
    guard = floor == 0.0
    if guard:
        fill = torch.exp(n_tr * -math.inf - log_nfac)

    def rhs(t, y, dt_, dy):
        """The right-hand side at stage time t (L,) and state y (L, n + 2),
        and its tangent from those of t (L, K) and the state (L, n, K)."""
        diff = t - y[:, n]
        t_since = torch.clamp(diff, min=0.0)
        d_ts = torch.where((diff >= 0.0)[:, None], dt_, 0.0)
        karg = k_tr * t_since
        arg = torch.clamp(karg, min=TRANSIT_LOG_FLOOR)
        d_arg = torch.where((karg >= floor)[:, None],
                            seed["k_transit"] * t_since[:, None] + k_tr[:, None] * d_ts, 0.0)
        if guard:
            zero = arg == 0
            arg = torch.where(zero, 1.0, arg)
        log_t = torch.log(arg)
        d_log = d_arg / arg[:, None]
        transit = torch.exp(n_tr * log_t - k_tr * t_since - log_nfac)
        d_exp = ((seed["n_transit"] * log_t[:, None] + n_tr[:, None] * d_log)
                 - (seed["k_transit"] * t_since[:, None] + k_tr[:, None] * d_ts) - d_log_nfac)
        d_tr = transit[:, None] * d_exp
        if guard:
            transit = torch.where(zero, fill, transit)
            d_tr = torch.where(zero[:, None], 0.0, d_tr)
        dose = y[:, n + 1]
        d_in = (seed["k_transit"] * transit[:, None] + k_tr[:, None] * d_tr) * dose[:, None]
        transit = k_tr * transit * dose
        gut, cen = y[:, 0], y[:, 1]
        dg, dc = dy[:, 0], dy[:, 1]
        k_gut = transit - ka_ke * gut
        d_gut = d_in - (d_ka_ke * gut[:, None] + ka_ke[:, None] * dg)
        a = ka * gut - kel * cen
        d_a = ((seed["ka"] * gut[:, None] + ka[:, None] * dg)
               - (seed["kel"] * cen[:, None] + kel[:, None] * dc))
        z = torch.zeros_like(k_gut)
        if n == 2:
            return (torch.stack([k_gut, a, z, z], dim=-1), torch.stack([d_gut, d_a], dim=1))
        per, dp = y[:, 2], dy[:, 2]
        k_cen = a - kpf * cen + kpb * per
        d_cen = (d_a - (seed["kpf"] * cen[:, None] + kpf[:, None] * dc)
                 + (seed["kpb"] * per[:, None] + kpb[:, None] * dp))
        k_per = kpf * cen - kpb * per
        d_per = ((seed["kpf"] * cen[:, None] + kpf[:, None] * dc)
                 - (seed["kpb"] * per[:, None] + kpb[:, None] * dp))
        return (torch.stack([k_gut, k_cen, k_per, z, z], dim=-1),
                torch.stack([d_gut, d_cen, d_per], dim=1))

    times = grid[pat]  # (L, S)
    amt_flat = amt.reshape(-1)

    def event(i, t, y):
        a = amt_flat[pat * S + i]
        fire = a > 0
        return torch.cat([y[:, :n], torch.where(fire, t, y[:, n])[:, None],
                          torch.where(fire, a, y[:, n + 1])[:, None]], dim=-1)

    y0 = torch.zeros(L, n + 2, dtype=dtype, device=dev)
    y0[:, n + 1] = dose0[pat]
    # slot S of the record takes the lanes that reached no stop in a trip
    central = torch.full((L, S + 1), math.nan, dtype=dtype, device=dev)
    central[:, 0] = y0[:, 1]
    jac = torch.zeros(L, S + 1, K, dtype=dtype, device=dev)
    t = times[:, 0].clone()
    y = event(torch.zeros(L, dtype=torch.long, device=dev), t, y0)
    dt = torch.full_like(t, first_dt)
    seg = torch.ones(L, dtype=torch.long, device=dev)
    ok = torch.ones(L, dtype=torch.bool, device=dev)
    counts = torch.zeros(L, dtype=torch.int32, device=dev)
    dy = torch.zeros(L, n, K, dtype=dtype, device=dev)
    d_t = torch.zeros(L, K, dtype=dtype, device=dev)
    d_dt = torch.zeros(L, K, dtype=dtype, device=dev)
    for _ in range(trips):
        seg_c = torch.clamp(seg, max=S - 1)
        t1 = times.gather(1, seg_c[:, None])[:, 0]
        active = (seg < S) & ok
        counts += active.int()
        diff = t1 - t
        remaining = torch.clamp(diff, min=0.0)
        d_rem = torch.where((diff >= 0.0)[:, None], -d_t, 0.0)
        clipped = dt >= remaining
        h = torch.minimum(dt, remaining)
        # torch.minimum's derivative: the smaller operand's, halves at a tie
        d_h = torch.where((dt == remaining)[:, None], 0.5 * (d_dt + d_rem),
                          torch.where((dt < remaining)[:, None], d_dt, d_rem))

        # the 7-stage embedded RK5(4) of ode/dp5.py `_step`
        ks, dks = [], []
        for i in range(7):
            ti = t + _C[i] * h
            d_ti = d_t + _C[i] * d_h
            yi, dyi = y, dy
            for j in range(i):
                a = h * _A[i][j]
                yi = yi + a[:, None] * ks[j]
                if _A[i][j] != 0.0:
                    dyi = dyi + ((d_h * _A[i][j])[:, None, :] * ks[j][:, :n, None]
                                 + a[:, None, None] * dks[j])
            k, dk = rhs(ti, yi, d_ti, dyi)
            ks.append(k)
            dks.append(dk)
        s5, s4 = _B5[0] * ks[0], _B4[0] * ks[0]
        ds5, ds4 = _B5[0] * dks[0], _B4[0] * dks[0]
        for i in range(1, 7):
            s5 = s5 + _B5[i] * ks[i]
            s4 = s4 + _B4[i] * ks[i]
            if _B5[i] != 0.0:
                ds5 = ds5 + _B5[i] * dks[i]
            if _B4[i] != 0.0:
                ds4 = ds4 + _B4[i] * dks[i]
        y5 = y + h[:, None] * s5
        y4 = y + h[:, None] * s4
        err = y5 - y4
        dy5 = dy + (d_h[:, None, :] * s5[:, :n, None] + h[:, None, None] * ds5)
        dy4 = dy + (d_h[:, None, :] * s4[:, :n, None] + h[:, None, None] * ds4)
        d_err = dy5 - dy4

        # the error norm of ode/dp5.py `_error_norm`, and its tangent (the
        # two bookkeeping components have no error and no tangent)
        ay, ay5 = y.abs(), y5.abs()
        scale = atol + rtol * torch.maximum(ay, ay5)
        q = err / scale
        mean_sq = (q**2).mean(dim=-1)
        zero = mean_sq == 0
        err_norm = torch.where(zero, 0.0, torch.sqrt(torch.where(zero, 1.0, mean_sq)))
        d_ay = torch.sgn(y[:, :n, None]) * dy
        d_ay5 = torch.sgn(y5[:, :n, None]) * dy5
        ay, ay5 = ay[:, :n, None], ay5[:, :n, None]
        d_max = torch.where(ay == ay5, 0.5 * (d_ay + d_ay5), torch.where(ay > ay5, d_ay, d_ay5))
        qn, sn = q[:, :n, None], scale[:, :n, None]
        d_q = (d_err - qn * (rtol * d_max)) / sn
        d_sq = 2.0 * qn * d_q
        # the kernel's order: components 0 and 2 first
        d_sum = d_sq[:, 0] + d_sq[:, 1] if n == 2 else (d_sq[:, 0] + d_sq[:, 2]) + d_sq[:, 1]
        d_mean = d_sum / (n + 2)  # on the card a product with 1 / (n + 2), as the kernel's
        d_norm = torch.where(zero[:, None], 0.0, d_mean / (2.0 * err_norm[:, None]))
        # zero-length remainder (repeated stop times): trivially accepted
        err_norm = torch.where(remaining > 0, err_norm, 0.0)
        d_norm = torch.where((remaining > 0)[:, None], d_norm, 0.0)
        accept = (err_norm <= 1.0) & active
        base = err_norm + 1e-30
        raw = _SAFETY * base**-0.2
        factor = torch.clamp(raw, _MIN_FACTOR, _MAX_FACTOR)
        d_factor = torch.where(((raw >= _MIN_FACTOR) & (raw <= _MAX_FACTOR))[:, None],
                               _SAFETY * (d_norm * (-0.2 * base**-1.2)[:, None]), 0.0)
        # keep the controller's dt across clipped stop-time landings
        keep = clipped & accept
        new_dt = torch.where(active, torch.where(keep, dt, h * factor), dt)
        d_new = torch.where((active & ~keep)[:, None],
                            d_h * factor[:, None] + h[:, None] * d_factor, d_dt)
        # snap clipped landings exactly onto the stop time (no tangent)
        t = torch.where(accept, torch.where(clipped, t1, t + h), t)
        d_t = torch.where(accept[:, None], torch.where(clipped[:, None], 0.0, d_t + d_h), d_t)
        y = torch.where(accept[:, None], y5, y)
        dy = torch.where(accept[:, None, None], dy5, dy)
        reached = accept & (t >= t1)
        slot = torch.where(reached, seg_c, S)
        central.scatter_(1, slot[:, None], y[:, 1:2])
        jac.scatter_(1, slot[:, None, None].expand(L, 1, K), dy[:, 1:2])
        y = torch.where(reached[:, None], event(seg_c, t1, y), y)
        seg = seg + reached.long()
        ok = ok & (~active | (torch.isfinite(y).all(dim=-1) & (new_dt > min_dt)))
        dt, d_dt = new_dt, d_new
    ok = ok & (seg >= S)
    pos = obs_pos[pat]  # (L, T)
    central = torch.where(ok[:, None], central.gather(1, pos), math.nan)
    jac = torch.where(ok[:, None, None], jac.gather(1, pos[:, :, None].expand(L, T, K)), 0.0)
    return (central, jac, ok, counts) if trip_counts else (central, jac, ok)


def transit_jacobian(
    rates, grid, amt, dose0, obs_pos, trips=768, rtol=1e-6, atol=1e-4, min_dt=1e-5,
    first_dt=1e-2, trip_counts=False, warp_slots=None,
):
    """B2J: the transit solve's central amounts at the observations, ok,
    and their Jacobian in the lane rates (see `transit_jacobian_plain` for
    the arguments and results). The CUDA kernel on a CUDA device, the plain
    version on the CPU; on a CUDA tensor it launches the kernel or raises.
    On CUDA every input must be contiguous and of the grid's dtype, float32
    or float64, and obs_pos int64, with tables that fit in shared memory
    beside the ring (`shared_bytes` <= SHARED_LIMIT);
    `warp_slots`, a (1,) int64 CUDA tensor, is then increased by the trip
    records the kernel's producer warps wrote (for the slot efficiency
    sum(trips) / (lanes a producer warp * slots); the plain version has no
    warps). The launch plan is `launch_plan`'s and is kept in
    `transit_jacobian.last_plan`."""
    if grid.device.type == "cpu":
        if warp_slots is not None:
            raise ValueError("warp_slots counts the CUDA kernel's warps")
        return transit_jacobian_plain(rates, grid, amt, dose0, obs_pos, trips, rtol, atol,
                                      min_dt, first_dt, trip_counts)
    n, names, L, P, S, T = _check_tables(rates, grid, obs_pos)
    K = len(names)
    dtype, dev = grid.dtype, grid.device
    named = [(k, rates[k], (L,)) for k in names]
    named += [("dose0", dose0, (P,)), ("grid", grid, (P, S)), ("amt", amt, (P, S))]
    build.refuse_grad("transit_jacobian (use TransitCentral)", [x for _, x, _ in named])
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"grid: dtype {dtype}, the kernel takes float32 or float64")
    for name, x, shape in named + [("obs_pos", obs_pos, (P, T))]:
        if x.device != dev:
            raise ValueError(f"{name} must be on {dev}, got {x.device}")
        want = torch.int64 if name == "obs_pos" else dtype
        if x.dtype != want:
            raise ValueError(f"{name}: dtype {x.dtype}, expected {want}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(x.shape)}, expected {shape}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if L > _MAX_LANES:
        raise ValueError(f"{L} lanes: the kernel takes at most {_MAX_LANES}")
    if shared_bytes(n, grid.element_size(), P, S) > SHARED_LIMIT:
        raise ValueError(f"{P} x {S} stops: the stop tables and the ring do not fit in a "
                         f"block's {SHARED_LIMIT} bytes of shared memory")
    if warp_slots is not None and (
        warp_slots.device != dev or warp_slots.dtype != torch.int64
        or tuple(warp_slots.shape) != (1,)
    ):
        raise ValueError(f"warp_slots must be a (1,) int64 tensor on {dev}")
    # each stop's observation index, -1 at a stop that is only a dose
    obs_slot = torch.full((P, S), -1, dtype=torch.int32, device=dev)
    obs_slot.scatter_(1, obs_pos, torch.arange(T, dtype=torch.int32, device=dev).expand(P, T))
    central = torch.empty((L, T), dtype=dtype, device=dev)
    jac = torch.empty((L, T, K), dtype=dtype, device=dev)
    ok = torch.empty((L,), dtype=torch.bool, device=dev)
    next_lane = torch.zeros((1,), dtype=torch.int32, device=dev)
    counts = torch.empty((L,), dtype=torch.int32, device=dev) if trip_counts else None
    lib = build.library()
    fn = (lib.bcm3_transit_dp5_tangent_f32 if dtype == torch.float32
          else lib.bcm3_transit_dp5_tangent_f64)
    ptrs = [rates[k].data_ptr() if k in rates else None for k in RATES]
    with torch.cuda.device(dev):
        sms, per_sm = _occupancy(torch.cuda.current_device(), grid.element_size(), n, P, S)
        plan = launch_plan(L, n, sms, per_sm)
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(*ptrs, dose0.data_ptr(), grid.data_ptr(), amt.data_ptr(), obs_slot.data_ptr(),
                  central.data_ptr(), jac.data_ptr(), ok.data_ptr(), next_lane.data_ptr(),
                  None if counts is None else counts.data_ptr(),
                  None if warp_slots is None else warp_slots.data_ptr(),
                  L, P, S, T, n, int(trips), plan["lanes_per_warp"], plan["slots"],
                  plan["blocks"], float(rtol), float(atol), float(min_dt), float(first_dt),
                  stream)
    build.check_launch("transit_dp5_tangent", code)
    transit_jacobian.launches += 1
    transit_jacobian.last_plan = plan
    return (central, jac, ok, counts) if trip_counts else (central, jac, ok)


# kernel launches since the count was last set to 0, and the last launch's plan
transit_jacobian.launches = 0
transit_jacobian.last_plan = None


class TransitCentral(torch.autograd.Function):
    """The transit solve's central amounts (L, T) at the observations, NaN
    on failed lanes, differentiable in the lane rates: forward =
    `transit_jacobian` (B2J on the card), which also gives the Jacobian
    (L, T, K); backward = its contraction with the incoming gradient. The
    tables are data and get no gradient.

    apply(tables, options, *rates): tables = dict(grid, amt, dose0,
    obs_pos), options = transit_jacobian's keywords, rates = the (L,) lane
    rates in RATES order (5 or 7)."""

    @staticmethod
    def forward(ctx, tables, options, *rates):
        central, jac, ok = transit_jacobian(dict(zip(RATES, rates)), **tables, **options)
        ctx.save_for_backward(jac, ok)
        return central

    @staticmethod
    def backward(ctx, grad):
        jac, ok = ctx.saved_tensors
        # a failed lane's NaN amounts may bring a NaN gradient (0 times the
        # derivative at NaN); its Jacobian is 0 and so is its share
        grad = torch.where(ok[:, None], grad, 0.0)
        d = torch.einsum("lt,ltk->kl", grad, jac)
        return (None, None, *d)
