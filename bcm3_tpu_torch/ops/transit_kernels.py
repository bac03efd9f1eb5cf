"""Kernel B2: the budgeted DP5 transit-model solve.

Counterpart of bcm3_tpu/ops/transit_pallas.py. `transit_solve` runs the
CUDA kernel in csrc/transit_dp5.cu for tensors on a CUDA device and the
plain PyTorch version `transit_solve_plain` for tensors on the CPU. On a
CUDA tensor it launches the kernel or raises; it never falls back to the
plain version. The kernel computes in float32, as the Pallas kernel does
(transit_pallas.py:248).

Both take the stop grid and dose amounts per patient, (P, S), and the
initial doses as (P,): lane l belongs to patient l % P, the likelihood's
patient-minor layout (the Pallas kernel takes the same tables tiled to
(L, S)). Both end a lane as failed as soon as it has fewer trips left
than stops to reach, which changes no output (a failed lane is all NaN),
and both can return the number of trips each lane ran.
"""

from __future__ import annotations

import torch

from bcm3_tpu_torch.ops import build

# Dormand-Prince 5(4) tableau (same constants as bcm3_tpu/ode/dp5.py)
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

# per-lane parameters (L,); dose0 is per patient (P,)
LANE_PARAMS = ("ka", "ke", "kel", "k_transit", "n_transit")
PARAM_NAMES = LANE_PARAMS + ("dose0",)

# Float operations of the kernel, as counted in the note of
# csrc/transit_dp5.cu: a trip whose first stage is reused, the first
# stage's right-hand side, and a lane's set-up. The least work of a lane
# that runs n >= 1 trips is SETUP + FIRST_STAGE + n * TRIP.
OPS_PER_TRIP = 273
OPS_FIRST_STAGE = 18
OPS_LANE_SETUP = 10

# the lane index is int32 and the lane counter overshoots L by at most the
# card's resident threads (132 SMs x 2048 on an H100)
_MAX_LANES = 2**31 - 2**20

# the plain version checks every this many trips whether any lane is still
# active (a host sync); finished lanes no longer change, so stopping early
# gives the same result as running the whole budget
_ACTIVE_CHECK_EVERY = 32


def _lanes_and_patients(params, grid):
    L, P = params["ka"].shape[0], grid.shape[0]
    if P < 1 or L % P != 0:
        raise ValueError(f"{L} lanes do not split evenly over {P} patients")
    return L, P


def transit_solve_plain(
    params, grid, dose_amt, trips=768, rtol=1e-6, atol=1e-4, min_dt=1e-5,
    first_dt=1e-2, trip_counts=False,
):
    """Plain PyTorch version: a loop over `trips` on (L,) tensors.

    Same semantics as the Pallas kernel body (transit_pallas.py:53-187):
    indexing by the lane's patient and stop pointer in place of the
    one-hot gathers, and a masked scatter for recording. Computes in the
    dtype of `grid`. Returns (central (L, S), ok (L,) bool), and with
    `trip_counts` also the trips each lane ran, (L,) int32."""
    L, P = _lanes_and_patients(params, grid)
    S = grid.shape[1]
    dev = grid.device
    ka, ke, kel, k_transit, n_transit = (params[k] for k in LANE_PARAMS)
    pat = torch.arange(L, device=dev) % P

    log_nfac = (
        0.9189385332046727
        + (n_transit + 0.5) * torch.log(n_transit)
        - n_transit
        + torch.log(1.0 + 1.0 / (12.0 * n_transit))
    )

    def deriv(t, gut, cen, lt, dose):
        ts = torch.clamp(t - lt, min=0.0)
        log_t = torch.log(torch.clamp(k_transit * ts, min=1e-30))
        transit = torch.exp(n_transit * log_t - k_transit * ts - log_nfac)
        inflow = k_transit * transit * dose
        return inflow - (ka + ke) * gut, ka * gut - kel * cen

    central = torch.full((L, S), float("nan"), dtype=grid.dtype, device=dev)
    central[:, 0] = 0.0
    t = grid[pat, 0]
    gut = torch.zeros_like(t)
    cen = torch.zeros_like(t)
    lt = torch.zeros_like(t)  # last treatment: the initial dose at t = 0
    dose = params["dose0"][pat]
    dt = torch.full_like(t, first_dt)
    seg = torch.ones(L, dtype=torch.long, device=dev)
    ok = torch.ones(L, dtype=torch.bool, device=dev)
    counts = torch.zeros(L, dtype=torch.int32, device=dev)

    for trip in range(trips):
        live = (seg < S) & ok
        # a trip reaches at most one stop: a lane with fewer trips left than
        # stops to reach cannot finish, and ends as failed now
        doomed = live & (S - seg > trips - trip)
        ok = ok & ~doomed
        active = live & ~doomed
        if trip % _ACTIVE_CHECK_EVERY == 0 and not bool(active.any()):
            break
        counts += active.int()
        seg_c = torch.clamp(seg, max=S - 1)
        t1 = grid[pat, seg_c]
        amt = dose_amt[pat, seg_c]
        seg_c = seg_c[:, None]
        remaining = torch.clamp(t1 - t, min=0.0)
        clipped = dt >= remaining
        h = torch.minimum(dt, remaining)

        # 7-stage embedded RK5(4)
        kg, kc = [], []
        for i in range(7):
            gi, ci = gut, cen
            for j, a in enumerate(_A[i]):
                if a != 0.0:
                    gi = gi + h * a * kg[j]
                    ci = ci + h * a * kc[j]
            dg, dc = deriv(t + _C[i] * h, gi, ci, lt, dose)
            kg.append(dg)
            kc.append(dc)
        g5, c5 = gut, cen
        eg = torch.zeros_like(t)
        ec = torch.zeros_like(t)
        for i in range(7):
            if _B5[i] != 0.0:
                g5 = g5 + h * _B5[i] * kg[i]
                c5 = c5 + h * _B5[i] * kc[i]
            diff = _B5[i] - _B4[i]
            if diff != 0.0:
                eg = eg + h * diff * kg[i]
                ec = ec + h * diff * kc[i]

        sc_g = atol + rtol * torch.maximum(gut.abs(), g5.abs())
        sc_c = atol + rtol * torch.maximum(cen.abs(), c5.abs())
        err_norm = torch.sqrt(0.5 * ((eg / sc_g) ** 2 + (ec / sc_c) ** 2))
        err_norm = torch.where(remaining > 0, err_norm, 0.0)
        accept = (err_norm <= 1.0) & active
        factor = torch.clamp(
            _SAFETY * (err_norm + 1e-30) ** -0.2, _MIN_FACTOR, _MAX_FACTOR
        )
        new_dt = torch.where(active, torch.where(clipped & accept, dt, h * factor), dt)
        t_new = torch.where(accept, torch.where(clipped, t1, t + h), t)
        gut = torch.where(accept, g5, gut)
        cen = torch.where(accept, c5, cen)
        reached = accept & (t_new >= t1)

        # record central at the stop just reached
        cur = central.gather(1, seg_c)
        central.scatter_(1, seg_c, torch.where(reached[:, None], cen[:, None], cur))

        # dose event: last_treatment <- t1 when an amount is given
        fire = reached & (amt > 0)
        lt = torch.where(fire, t1, lt)
        dose = torch.where(fire, amt, dose)

        seg = seg + reached.long()
        finite = torch.isfinite(gut) & torch.isfinite(cen) & (new_dt > min_dt)
        ok = ok & (~active | finite)
        t, dt = t_new, new_dt

    ok = ok & (seg >= S)
    central = torch.where(ok[:, None], central, float("nan"))
    return (central, ok, counts) if trip_counts else (central, ok)


def transit_solve(
    params, grid, dose_amt, trips=768, rtol=1e-6, atol=1e-4, min_dt=1e-5,
    first_dt=1e-2, trip_counts=False, warp_slots=None,
):
    """Batched budgeted-DP5 transit solve over L lanes of P patients.

    params: dict of (L,) tensors ka, ke, kel, k_transit, n_transit and the
    (P,) initial doses dose0; grid: (P, S) stop times; dose_amt: (P, S)
    dose amounts (0 where none). Lane l is patient l % P. Returns
    (central (L, S), ok (L,) bool), and with `trip_counts` also the trips
    each lane ran, (L,) int32. On CUDA every input must be float32 and
    contiguous; `warp_slots`, a (1,) int64 CUDA tensor, is then increased
    by the trip slots the kernel's warps issued (for the warp efficiency
    sum(trips) / (32 * slots); the plain version has no warps). On a CUDA
    tensor that requires grad it raises: the kernel has no reverse mode (the
    likelihood's gradient mode differentiates the transit models through
    kernel B2J)."""
    if grid.device.type == "cpu":
        if warp_slots is not None:
            raise ValueError("warp_slots counts the CUDA kernel's warps")
        return transit_solve_plain(
            params, grid, dose_amt, trips, rtol, atol, min_dt, first_dt, trip_counts
        )
    L, P = params["ka"].shape[0], grid.shape[0]
    S = grid.shape[1]
    named = [(k, params[k], (L,)) for k in LANE_PARAMS]
    named += [("dose0", params["dose0"], (P,)), ("grid", grid, (P, S)),
              ("dose_amt", dose_amt, (P, S))]
    # B2 has no reverse mode: gradients of the transit models go through the
    # likelihood's gradient mode, kernel B2J (ops/transit_tangent_kernels.py)
    build.refuse_grad(
        "transit_solve (no reverse mode; the gradient samplers use PopPKLikelihood's "
        "gradient_mode, kernel B2J)", [x for _, x, _ in named])
    for name, x, shape in named:
        if x.device != grid.device or x.device.type != "cuda":
            raise ValueError(f"{name} must be on {grid.device} (CUDA), got {x.device}")
        if x.dtype != torch.float32:
            raise ValueError(f"{name}: dtype {x.dtype}, the kernel takes float32")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(x.shape)}, expected {shape}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    _lanes_and_patients(params, grid)
    if L > _MAX_LANES:
        raise ValueError(f"{L} lanes: the kernel takes at most {_MAX_LANES}")
    if warp_slots is not None and (
        warp_slots.device != grid.device or warp_slots.dtype != torch.int64
        or tuple(warp_slots.shape) != (1,)
    ):
        raise ValueError(f"warp_slots must be a (1,) int64 tensor on {grid.device}")
    central = torch.empty((L, S), dtype=torch.float32, device=grid.device)
    ok = torch.empty((L,), dtype=torch.bool, device=grid.device)
    # the kernel's lane counter: the next lane a thread takes
    next_lane = torch.zeros((1,), dtype=torch.int32, device=grid.device)
    counts = (
        torch.empty((L,), dtype=torch.int32, device=grid.device) if trip_counts else None
    )
    with torch.cuda.device(grid.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = build.library().bcm3_transit_dp5_f32(
            *(x.data_ptr() for _, x, _ in named),
            central.data_ptr(), ok.data_ptr(), next_lane.data_ptr(),
            None if counts is None else counts.data_ptr(),
            None if warp_slots is None else warp_slots.data_ptr(),
            L, P, S, int(trips), float(rtol), float(atol), float(min_dt),
            float(first_dt), stream,
        )
    build.check_launch("transit_dp5", code)
    transit_solve.launches += 1
    return (central, ok, counts) if trip_counts else (central, ok)


# kernel launches since the count was last set to 0
transit_solve.launches = 0
