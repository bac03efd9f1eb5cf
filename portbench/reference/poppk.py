"""The PopPK log-likelihood in plain PyTorch: the benchmark's reference.

Frozen copies, as of commit d9dda7d00f62b25b3647d9a412570757ad8fc7e2, of
- `bcm3_tpu_torch/likelihoods/poppk.py` `_patient_params` (with the
  gradient mode's guard on the rates), `_central_one`, `_central_transit`,
  `_simulate_transit` and `log_prob_batched` (the scoring);
- `bcm3_tpu_torch/ops/poppk_kernels.py` `propagate_intervals_plain` and
  `bcm3_tpu_torch/ode/linear_pk.py` `_expm_ratio`: the one-compartment
  dosing recurrence (kernel B1's function);
- `bcm3_tpu_torch/ops/transit_kernels.py` `transit_solve_plain`: the
  budgeted DP5 transit solve of the population path, two-component error
  norm (kernel B2's function);
- `bcm3_tpu_torch/ode/dp5.py` `solve_at_times_budget`, `_step`,
  `_error_norm`, `_safe_sqrt`, `_factor`: the budgeted DP5 solve of the
  gradient path, error norm over the four augmented components (kernel
  B2J's function; its derivative is autograd's).

Every function computes in the dtype it is given: the configuration's
(float32) for the reference, bfloat16 for the check's control, float32
for the trip counts of the rooflines, float64 in the CPU tests. An operation that a dtype lacks on a device runs in
float32 and is rounded back (`_op`). Nothing here imports the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_LOG_TNU4_C = -0.9808292530117262  # log(Gamma(2.5)/(Gamma(2) sqrt(4 pi)))
_EPS = 1e-12

# Dormand-Prince 5(4)
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
_SAFETY, _MIN_FACTOR, _MAX_FACTOR = 0.9, 0.2, 10.0

# structural values read by position, by model (LikelihoodPopPKTrajectory.cpp:102-119)
NUM_PK_PARAMS = {"one": 4, "one_transit": 6}
TRANSIT_TYPES = ("one_transit",)
# every this many trips the population solve checks whether a lane is still active
_ACTIVE_CHECK_EVERY = 32


def _op(fn, x):
    """fn(x) in x's dtype; in float32, rounded back, where the dtype is
    bfloat16 (some special functions have no bfloat16 kernel)."""
    if x.dtype == torch.bfloat16:
        return fn(x.float()).to(x.dtype)
    return fn(x)


def device_tables(tb: dict, device, dtype) -> dict:
    """The numpy tables of trial.tables as tensors in dtype on device."""
    out = {}
    for k, v in tb.items():
        if isinstance(v, np.ndarray):
            if v.dtype == bool:
                out[k] = torch.as_tensor(v, device=device)
            elif np.issubdtype(v.dtype, np.integer):
                out[k] = torch.as_tensor(v, dtype=torch.long, device=device)
            else:
                out[k] = torch.as_tensor(v, device=device).to(dtype)
        else:
            out[k] = v
    return out


def patient_params(x, prior, pk_type):
    """Per-patient rates of rows x (B, D): ka, kel (B, P); ke, vod, and
    for the transit model n_transit, k_transit (B,); the residual sds.
    Where a rate's exponent or value is not finite the rate keeps its
    value with derivative 0 (the gradient mode's guard)."""
    npk = NUM_PK_PARAMS[pk_type]
    P = (x.shape[1] - npk - 4) // 2
    j = torch.arange(P, device=x.device)
    u_abs = x[:, npk + 2 * (j + 1)]
    u_elim = x[:, npk + 2 * (j + 1) + 1]

    def ten(v):
        return torch.pow(10.0, v)

    def rate(mean, sd, u, per=None):
        def f(u):
            r = ten(mean + sd * _op(torch.special.ndtri, u))
            return r if per is None else r / per

        with torch.no_grad():
            value = f(u)
            ok = torch.isfinite(mean + sd * _op(torch.special.ndtri, u)) & torch.isfinite(value)
        return torch.where(ok, f(torch.where(ok, u, 0.5)), value)

    def tr(name):
        ix = prior.index(name)
        return ten(x[:, ix]) if prior.logspace[ix] else x[:, ix]

    p = {"ka": rate(x[:, 0:1], x[:, npk:npk + 1], u_abs)}
    p["ke"] = tr("mean_excretion")
    p["vod"] = tr("volume_of_distribution")
    p["kel"] = rate(x[:, 2:3], x[:, npk + 1:npk + 2], u_elim, p["vod"][:, None])
    if pk_type in TRANSIT_TYPES:
        p["n_transit"] = tr("n_transit")
        p["k_transit"] = (p["n_transit"] + 1.0) / tr("mean_transit_time")
    return p, tr("standard_deviation"), tr("standard_deviation2")


def central_one(p, tb):
    """Central amounts (B, P, T) of the one-compartment model: the dosing
    recurrence over the K intervals, then each observation propagated in
    closed form from the start of its interval."""
    ka, kel = p["ka"], p["kel"]
    B, P = ka.shape
    ke = p["ke"][:, None].expand(B, P)
    K = tb["dose_amount"].shape[1]
    a = ka + ke
    dt = tb["interval"][None, :]
    eg, ec = torch.exp(-a * dt), torch.exp(-kel * dt)
    d = a - kel
    degenerate = d.abs() < _EPS
    ratio = torch.where(degenerate, dt * ec, (ec - eg) / torch.where(degenerate, _EPS, d))
    ka_ratio = ka * ratio
    gut = tb["initial_dose"][None, :].expand_as(ka)
    cen = torch.zeros_like(ka)
    guts, cens = [], []
    for k in range(K):
        guts.append(gut)
        cens.append(cen)
        cen = cen * ec + gut * ka_ratio
        gut = gut * eg + tb["dose_amount"][None, :, k]
    T = tb["obs_interval"].shape[1]
    idx = tb["obs_interval"][None].expand(B, P, T)
    gut_b = torch.stack(guts, dim=2).gather(2, idx)
    cen_b = torch.stack(cens, dim=2).gather(2, idx)
    dt = tb["obs_offset"][None]
    ka3, kel3 = ka[:, :, None], kel[:, :, None]
    a3 = ka3 + p["ke"][:, None, None]
    d3 = a3 - kel3
    deg3 = d3.abs() < _EPS
    general = (torch.exp(-kel3 * dt) - torch.exp(-a3 * dt)) / torch.where(deg3, _EPS, d3)
    expm_ratio = torch.where(deg3, dt * torch.exp(-kel3 * dt), general)
    return cen_b * torch.exp(-kel3 * dt) + ka3 * gut_b * expm_ratio


def lanes(p, B, P):
    """The lane rates (B * P,) of per-patient parameters p, lane b * P + j patient j."""
    def flat(v):
        return (v[:, None] if v.dim() == 1 else v).expand(B, P).reshape(B * P)

    return {k: flat(p[k]) for k in ("ka", "ke", "kel", "k_transit", "n_transit")}


def _log_nfac(n):
    return (0.9189385332046727 + (n + 0.5) * torch.log(n) - n
            + torch.log(1.0 + 1.0 / (12.0 * n)))


def transit_population(lane, tb, trips, first_dt=1e-2, min_dt=1e-5, rtol=1e-6):
    """The population path's budgeted DP5 solve (kernel B2): lane l is
    patient l % P, state (gut, central), the error norm over those two, a
    lane with fewer trips left than stops to reach fails at once. Returns
    (central (L, S), ok (L,), trips each lane ran (L,) int32) in the
    dtype of the tables."""
    grid, dose_amt = tb["grid"], tb["amt"]
    atol = tb["atol"]
    L, (P, S) = lane["ka"].shape[0], grid.shape
    dev, dtype = grid.device, grid.dtype
    ka, ke, kel, k_tr, n_tr = (lane[k] for k in ("ka", "ke", "kel", "k_transit", "n_transit"))
    pat = torch.arange(L, device=dev) % P
    log_nfac = _log_nfac(n_tr)
    floor = float(torch.tensor(1e-30, dtype=dtype))

    def deriv(t, gut, cen, lt, dose):
        ts = torch.clamp(t - lt, min=0.0)
        log_t = torch.log(torch.clamp(k_tr * ts, min=floor))
        transit = torch.exp(n_tr * log_t - k_tr * ts - log_nfac)
        return k_tr * transit * dose - (ka + ke) * gut, ka * gut - kel * cen

    central = torch.full((L, S), float("nan"), dtype=dtype, device=dev)
    central[:, 0] = 0.0
    t = grid[pat, 0]
    gut, cen, lt = torch.zeros_like(t), torch.zeros_like(t), torch.zeros_like(t)
    dose = tb["initial_dose"][pat]
    dt = torch.full_like(t, first_dt)
    seg = torch.ones(L, dtype=torch.long, device=dev)
    ok = torch.ones(L, dtype=torch.bool, device=dev)
    counts = torch.zeros(L, dtype=torch.int32, device=dev)
    for trip in range(trips):
        live = (seg < S) & ok
        doomed = live & (S - seg > trips - trip)
        ok = ok & ~doomed
        active = live & ~doomed
        if trip % _ACTIVE_CHECK_EVERY == 0 and not bool(active.any()):
            break
        counts += active.int()
        seg_c = torch.clamp(seg, max=S - 1)
        t1 = grid[pat, seg_c]
        amt = dose_amt[pat, seg_c]
        remaining = torch.clamp(t1 - t, min=0.0)
        clipped = dt >= remaining
        h = torch.minimum(dt, remaining)
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
        eg, ec = torch.zeros_like(t), torch.zeros_like(t)
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
        err = torch.sqrt(0.5 * ((eg / sc_g) ** 2 + (ec / sc_c) ** 2))
        err = torch.where(remaining > 0, err, 0.0)
        accept = (err <= 1.0) & active
        factor = torch.clamp(_SAFETY * (err + 1e-30) ** -0.2, _MIN_FACTOR, _MAX_FACTOR)
        new_dt = torch.where(active, torch.where(clipped & accept, dt, h * factor), dt)
        t_new = torch.where(accept, torch.where(clipped, t1, t + h), t)
        gut = torch.where(accept, g5, gut)
        cen = torch.where(accept, c5, cen)
        reached = accept & (t_new >= t1)
        cur = central.gather(1, seg_c[:, None])
        central.scatter_(1, seg_c[:, None], torch.where(reached[:, None], cen[:, None], cur))
        fire = reached & (amt > 0)
        lt = torch.where(fire, t1, lt)
        dose = torch.where(fire, amt, dose)
        seg = seg + reached.long()
        ok = ok & (~active | (torch.isfinite(gut) & torch.isfinite(cen) & (new_dt > min_dt)))
        t, dt = t_new, new_dt
    ok = ok & (seg >= S)
    return torch.where(ok[:, None], central, float("nan")), ok, counts


def transit_gradient_path(lane, tb, trips, first_dt=1e-2, min_dt=1e-5, rtol=1e-6,
                          early_exit=True):
    """The gradient path's budgeted DP5 solve (kernel B2J's function):
    augmented state (gut, central, last treatment, dose level), the error
    norm the mean over the four components with a zero-safe sqrt, dose
    events after each stop's record. Differentiable by autograd in the
    lane rates. With `early_exit` the loop ends once no lane is active
    (a finished lane no longer changes). Returns (central at the stops
    (L, S), ok (L,), trips each lane was active (L,) int32)."""
    grid, amt_tab = tb["grid"], tb["amt"]
    atol = tb["atol"]
    L, (P, S) = lane["ka"].shape[0], grid.shape
    dev, dtype = grid.device, grid.dtype
    ka, ke, kel, k_tr, n_tr = (lane[k] for k in ("ka", "ke", "kel", "k_transit", "n_transit"))
    pat = torch.arange(L, device=dev) % P
    log_nfac = _log_nfac(n_tr)
    ka_ke = ka + ke
    floor = float(torch.tensor(1e-300, dtype=dtype))
    guard = floor == 0.0 and any(v.requires_grad for v in lane.values())
    fill = torch.exp(n_tr * -math.inf - log_nfac).detach() if guard else None

    def f(t, y):
        t_since = torch.clamp(t - y[:, 2], min=0.0)
        arg = torch.clamp(k_tr * t_since, min=floor)
        if guard:
            zero = arg == 0
            log_t = torch.log(torch.where(zero, 1.0, arg))
        else:
            log_t = torch.log(arg)
        transit = torch.exp(n_tr * log_t - k_tr * t_since - log_nfac)
        if guard:
            transit = torch.where(zero, fill, transit)
        transit = k_tr * transit * y[:, 3]
        z = torch.zeros_like(transit)
        return torch.stack([transit - ka_ke * y[:, 0], ka * y[:, 0] - kel * y[:, 1], z, z],
                           dim=-1)

    amt_flat = amt_tab.reshape(-1)

    def event(i, t, y):
        a = amt_flat[pat * S + i]
        fire = a > 0
        return torch.cat([y[:, :2], torch.where(fire, t, y[:, 2])[:, None],
                          torch.where(fire, a, y[:, 3])[:, None]], dim=-1)

    def step(t, y, dt):
        ks = []
        for i in range(7):
            yi = y
            for j in range(i):  # every coefficient, zeros too, as ode/dp5.py adds them
                yi = yi + (dt * _A[i][j])[:, None] * ks[j]
            ks.append(f(t + _C[i] * dt, yi))
        s5, s4 = _B5[0] * ks[0], _B4[0] * ks[0]
        for i in range(1, 7):
            s5 = s5 + _B5[i] * ks[i]
            s4 = s4 + _B4[i] * ks[i]
        y5 = y + dt[:, None] * s5
        return y5, y5 - (y + dt[:, None] * s4)

    def safe_sqrt(v):
        zero = v == 0
        return torch.where(zero, 0.0, torch.sqrt(torch.where(zero, 1.0, v)))

    times = grid[pat]
    y0 = torch.zeros(L, 4, dtype=dtype, device=dev)
    y0[:, 3] = tb["initial_dose"][pat]
    ys = torch.full((L, S + 1), float("nan"), dtype=dtype, device=dev)
    ys[:, 0] = y0[:, 1]
    t = times[:, 0].clone()
    y = event(torch.zeros(L, dtype=torch.long, device=dev), t, y0)
    dt = torch.full_like(t, first_dt)
    seg = torch.ones(L, dtype=torch.long, device=dev)
    ok = torch.ones(L, dtype=torch.bool, device=dev)
    counts = torch.zeros(L, dtype=torch.int32, device=dev)
    for trip in range(trips):
        seg_c = torch.clamp(seg, max=S - 1)
        t1 = times.gather(1, seg_c[:, None])[:, 0]
        active = (seg < S) & ok
        if early_exit and trip % _ACTIVE_CHECK_EVERY == 0 and not bool(active.any()):
            break
        counts += active.int()
        remaining = torch.clamp(t1 - t, min=0.0)
        clipped = dt >= remaining
        dt_step = torch.minimum(dt, remaining)
        y5, err = step(t, y, dt_step)
        scale = atol + rtol * torch.maximum(y.abs(), y5.abs())
        err_norm = safe_sqrt(((err / scale) ** 2).mean(dim=-1))
        err_norm = torch.where(remaining > 0, err_norm, 0.0)
        accept = (err_norm <= 1.0) & active
        factor = torch.clamp(_SAFETY * (err_norm + 1e-30) ** -0.2, _MIN_FACTOR, _MAX_FACTOR)
        new_dt = torch.where(active, torch.where(clipped & accept, dt, dt_step * factor), dt)
        t = torch.where(accept, torch.where(clipped, t1, t + dt_step), t)
        y = torch.where(accept[:, None], y5, y)
        reached = accept & (t >= t1)
        slot = torch.where(reached, seg_c, S)
        ys = ys.scatter(1, slot[:, None], y[:, 1:2])
        y = torch.where(reached[:, None], event(seg_c, t1, y), y)
        seg = seg + reached.long()
        ok = ok & (~active | (torch.isfinite(y).all(dim=-1) & (new_dt > min_dt)))
        dt = new_dt
    ok = ok & (seg >= S)
    return torch.where(ok[:, None], ys[:, :S], float("nan")), ok, counts


def central(x, prior, tb, pk_type, path, trips):
    """Central amounts (B, P, T) of rows x and the per-patient parameters:
    `path` "population" (kernel B2's solve) or "gradient" (B2J's) for the
    transit model; the recurrence for `one`."""
    p, sd, sd2 = patient_params(x, prior, pk_type)
    if pk_type == "one":
        return central_one(p, tb), p, sd, sd2
    B, P = p["ka"].shape
    solve = transit_population if path == "population" else transit_gradient_path
    c, _, _ = solve(lanes(p, B, P), tb, trips)
    T = tb["obs_pos"].shape[1]
    c = c.reshape(B, P, -1).gather(2, tb["obs_pos"][None].expand(B, P, T))
    return c, p, sd, sd2


def log_likelihood(x, prior, tb, pk_type, path="population", trips=768):
    """Log-likelihood (B,) of rows x (B, D): a Student-t(4) residual with
    additive and proportional sd over the scored observations, -inf where
    the simulated window holds a NaN."""
    c, p, sd, sd2 = central(x, prior, tb, pk_type, path, trips)
    failed = torch.isnan(c)
    c = torch.where(failed, 0.0, c)
    conc = c * (tb["conversion_base"] / p["vod"])[:, None, None]
    mask = tb["obs_mask"][None]
    x_sc = torch.where(mask, conc, 0.0)
    obs = torch.where(mask, tb["observed"][None], 0.0)
    sigma = sd[:, None, None] + sd2[:, None, None] * torch.clamp(x_sc, min=0.0)
    xn = (x_sc - obs) / sigma
    pointwise = _LOG_TNU4_C - 2.5 * torch.log1p(0.25 * xn * xn) - torch.log(sigma)
    logp = torch.where(mask, pointwise, 0.0).sum(dim=(1, 2))
    nan = torch.isnan(conc) | failed
    bad = (tb["window_mask"][None] & nan).any(dim=2).any(dim=1) | torch.isnan(logp)
    return torch.where(bad, -math.inf, logp)


def log_posterior_z(z, prior, tb, pk_type, trips=768):
    """The gradient samplers' target at unbounded rows z (B, D): log prior
    + log-Jacobian + log-likelihood on the gradient path, NaN -> -inf."""
    x = prior.to_x(z)
    total = prior.log_density(x) + prior.log_jacobian(z) + log_likelihood(
        x, prior, tb, pk_type, "gradient", trips)
    return torch.where(torch.isnan(total), -math.inf, total)
