"""Batched adaptive Dormand-Prince RK5(4) integrator on torch tensors.

Counterpart of bcm3_tpu/ode/dp5.py (reference:
src/odecommon/ODESolverDP5.{h,cpp}). The JAX package writes each solver
for one trajectory and vmaps it; here every function takes a lane axis
first: L independent trajectories advance together, each with its own
time, step size, stop pointer and failure flag.

- `solve_at_times_budget`: one static loop of `total_trips` adaptive
  steps over a per-lane stop-time grid, the controller's dt preserved
  across stops, min-step fail-fast; the path of the `two_transit` PopPK
  model.
- `solve_at_times`: segment by segment, each integrated until every lane
  has reached its end (per-segment and whole-trajectory step budgets, a
  host read a step); the oracle the budget solver is held to. With
  `fixed_trips` each segment runs exactly that many trips instead, the
  lanes that have finished masked, and the solve reads the host never.

Failure is a value, not an exception: a lane that exhausts its budget,
falls below `min_dt` or goes non-finite has ok = False and NaN states,
which the likelihood maps to -inf (reference: ODESolverCVODE.cpp:354-370).

The right-hand side is ``f(t (L,), y (L, n), args) -> (L, n)``; an
event, ``event_fn(i (L,) int64, t (L,), y (L, n), args) -> (L, n)``, is
applied at each stop after the state is recorded (dose additions).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

# Dormand-Prince 5(4) Butcher tableau
_C = np.array([0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0])
_A = np.zeros((7, 7))
_A[1, 0] = 1 / 5
_A[2, :2] = [3 / 40, 9 / 40]
_A[3, :3] = [44 / 45, -56 / 15, 32 / 9]
_A[4, :4] = [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729]
_A[5, :5] = [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656]
_A[6, :6] = [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84]
_B5 = np.array([35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0])
_B4 = np.array(
    [5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200, 187 / 2100, 1 / 40]
)

_SAFETY = 0.9
_MIN_FACTOR = 0.2
_MAX_FACTOR = 10.0


class DP5Result(NamedTuple):
    ys: torch.Tensor  # (L, S, n) solution at each stop time
    ok: torch.Tensor  # (L,) bool: the whole trajectory is valid
    n_steps: torch.Tensor  # (L,) int32 steps taken (the budget solver: its trip count)


def _step(f, t, y, dt, args):
    """One embedded RK5(4) step of every lane. Returns (y5, y5 - y4)."""
    ks = []
    for i in range(7):
        ti = t + _C[i] * dt
        yi = y
        for j in range(i):
            yi = yi + (dt * _A[i, j])[:, None] * ks[j]
        ks.append(f(ti, yi, args))
    s5, s4 = _B5[0] * ks[0], _B4[0] * ks[0]
    for i in range(1, 7):
        s5 = s5 + _B5[i] * ks[i]
        s4 = s4 + _B4[i] * ks[i]
    y5 = y + dt[:, None] * s5
    y4 = y + dt[:, None] * s4
    return y5, y5 - y4


def _safe_sqrt(x):
    """sqrt(x) whose derivative is 0 where x is exactly 0 (the double-where
    rule: the untaken branch takes the root of 1), with every value bit for
    bit sqrt's, NaN and inf included. Departure from bcm3_tpu/ode/dp5.py:308-310,
    whose plain sqrt has an infinite derivative at 0: a lane with a
    zero-length remainder (a lane past its last stop) multiplies it by the
    zero cotangent of `where(remaining > 0, ...)` and turns every
    gradient of the solve into NaN."""
    zero = x == 0
    return torch.where(zero, 0.0, torch.sqrt(torch.where(zero, 1.0, x)))


def _error_norm(y, y5, err, rtol, atol):
    scale = atol + rtol * torch.maximum(y.abs(), y5.abs())
    return _safe_sqrt(((err / scale) ** 2).mean(dim=-1))


def _factor(err_norm):
    return torch.clamp(_SAFETY * (err_norm + 1e-30) ** -0.2, _MIN_FACTOR, _MAX_FACTOR)


def _finite(y):
    return torch.isfinite(y).all(dim=-1)


def _lane_times(stop_times, L):
    stop_times = torch.as_tensor(stop_times)
    return stop_times.expand(L, stop_times.shape[-1]) if stop_times.dim() == 1 else stop_times


def _event(event_fn, i, t, y, args):
    return y if event_fn is None else event_fn(i, t, y, args)


def _integrate_segment(f, t0, t1, y0, dt0, args, rtol, atol, max_steps, min_dt=0.0):
    """Adaptively integrate every lane from t0 to t1 (t1 >= t0), each lane
    stepping until it reaches t1, fails, or uses `max_steps` (a number or
    an (L,) tensor). Returns (y(t1), dt_next, steps_used, ok), as
    bcm3_tpu/ode/dp5.py `_integrate_segment` does under vmap: a lane whose
    loop condition is false is left as it is."""
    t, y = t0.clone(), y0.clone()
    dt = torch.clamp(dt0, min=1e-12)
    steps = torch.zeros_like(t, dtype=torch.int32)
    ok = torch.ones_like(t, dtype=torch.bool)
    while True:
        live = (t < t1) & ok & (steps < max_steps)
        if not bool(live.any()):
            break
        dt_clip = torch.minimum(dt, t1 - t)
        y5, err = _step(f, t, y, dt_clip, args)
        err_norm = _error_norm(y, y5, err, rtol, atol)
        accept = err_norm <= 1.0
        new_dt = dt_clip * _factor(err_norm)
        t_new = torch.where(accept, t + dt_clip, t)
        y_new = torch.where(accept[:, None], y5, y)
        ok_new = ok & _finite(y_new) & (new_dt > min_dt)
        t = torch.where(live, t_new, t)
        y = torch.where(live[:, None], y_new, y)
        dt = torch.where(live, new_dt, dt)
        ok = torch.where(live, ok_new, ok)
        steps = steps + live.to(torch.int32)
    ok = ok & (steps < max_steps) | (t >= t1)
    ok = ok & _finite(y)
    return y, dt, steps, ok


def _integrate_segment_fixed(f, t0, t1, y0, dt0, args, rtol, atol, trips, min_dt=0.0):
    """`_integrate_segment` as exactly `trips` trips of every lane, a lane
    that has reached t1 or failed left as it is (bcm3_tpu/ode/dp5.py
    `_integrate_segment_fori`): no host read. Where `trips` covers a lane's
    steps it ends as the while form does; a lane that needs more fails."""
    t, y = t0.clone(), y0.clone()
    dt = torch.clamp(dt0, min=1e-12)
    steps = torch.zeros_like(t, dtype=torch.int32)
    ok = torch.ones_like(t, dtype=torch.bool)
    for _ in range(trips):
        active = (t < t1) & ok
        dt_clip = torch.minimum(dt, t1 - t)
        y5, err = _step(f, t, y, dt_clip, args)
        err_norm = _error_norm(y, y5, err, rtol, atol)
        accept = (err_norm <= 1.0) & active
        dt = torch.where(active, dt_clip * _factor(err_norm), dt)
        t = torch.where(accept, t + dt_clip, t)
        y = torch.where(accept[:, None], y5, y)
        ok = ok & (~active | (_finite(y) & (dt > min_dt)))
        steps = steps + active.to(torch.int32)
    ok = ok & (t >= t1) & _finite(y)
    return y, dt, steps, ok


def solve_at_times(
    f: Callable,
    y0,
    stop_times,
    args=None,
    event_fn: Optional[Callable] = None,
    rtol: float = 1e-6,
    atol: float = 1e-6,
    max_steps_per_segment: int = 2000,
    first_dt: float = 1e-2,
    max_steps_total: Optional[int] = None,
    min_dt: float = 0.0,
    fixed_trips: Optional[int] = None,
) -> DP5Result:
    """Integrate y' = f(t, y, args) of L lanes across sorted stop times,
    segment by segment (bcm3_tpu/ode/dp5.py `solve_at_times`).

    y0: (L, n); stop_times: (S,) shared or (L, S) per lane, increasing,
    starting at the initial time (ys[:, 0] = y0). Repeated times are
    zero-length segments. `event_fn` is applied at every stop after the
    state is recorded. `max_steps_total` bounds each lane's whole
    trajectory, `min_dt` fails a lane whose step size collapses below it;
    a failed lane's later states are NaN and its ok is False.

    `fixed_trips`: each segment runs exactly this many masked trips and
    reads the host never (`_integrate_segment_fixed`); the step budgets are
    then ignored, as in the JAX package. Where the trips cover a lane's
    steps its results are the while form's; a lane that needs more fails."""
    L = y0.shape[0]
    times = _lane_times(stop_times, L).to(y0)
    S = times.shape[1]
    t = times[:, 0]
    y = _event(event_fn, torch.zeros(L, dtype=torch.long, device=y0.device), t, y0, args)
    dt = torch.full_like(t, first_dt)
    total_steps = torch.zeros(L, dtype=torch.int32, device=y0.device)
    ok = torch.ones(L, dtype=torch.bool, device=y0.device)
    ys = [y0]
    for i in range(1, S):
        t_next = times[:, i]
        seg_len = t_next - t
        if fixed_trips is not None:
            y_new, dt, steps, seg_ok = _integrate_segment_fixed(
                f, t, t_next, y, dt, args, rtol, atol, fixed_trips, min_dt
            )
        else:
            if max_steps_total is None:
                budget = max_steps_per_segment
            else:
                budget = torch.clamp(max_steps_total - total_steps, max=max_steps_per_segment)
            y_new, dt, steps, seg_ok = _integrate_segment(
                f, t, t_next, y, dt, args, rtol, atol, budget, min_dt
            )
        y_new = torch.where((seg_len > 0)[:, None], y_new, y)
        ok = ok & torch.where(seg_len > 0, seg_ok, True)
        ys.append(torch.where(ok[:, None], y_new, torch.nan))
        y = _event(event_fn, torch.full((L,), i, dtype=torch.long, device=y0.device),
                   t_next, y_new, args)
        t = t_next
        total_steps = total_steps + steps
    return DP5Result(ys=torch.stack(ys, dim=1), ok=ok, n_steps=total_steps)


def solve_at_times_budget(
    f: Callable,
    y0,
    stop_times,
    args=None,
    event_fn: Optional[Callable] = None,
    rtol: float = 1e-6,
    atol: float = 1e-6,
    total_trips: int = 768,
    first_dt: float = 1e-2,
    min_dt: float = 0.0,
    record: Optional[Callable] = None,
) -> DP5Result:
    """`solve_at_times` with one whole-trajectory step budget
    (bcm3_tpu/ode/dp5.py `solve_at_times_budget`): a static loop of
    `total_trips` adaptive steps, each lane carrying its stop pointer, so
    the work is bounded by what a trajectory needs rather than by segments
    times a per-segment budget. A step clipped to land on a stop keeps the
    controller's dt for the next segment. A lane that has not reached its
    last stop after `total_trips` trips, or whose step size falls to
    `min_dt`, fails (NaN states, ok False).

    y0: (L, n); stop_times: (S,) or (L, S). Returns ys (L, S, m): with
    `record`, a projection ``y (L, n) -> (L, m)`` applied to y0 and to each
    stop's state before it is stored (only what the caller scores), else
    the whole state (m = n)."""
    if record is None:
        record = lambda y: y  # noqa: E731
    L = y0.shape[0]
    dev = y0.device
    times = _lane_times(stop_times, L).to(y0)
    S = times.shape[1]
    rec0 = record(y0)
    m = rec0.shape[1]
    # slot S of the record is where a lane that reached no stop in a trip
    # writes, so every trip scatters one row per lane without a mask
    ys = torch.full((L, S + 1, m), torch.nan, dtype=y0.dtype, device=dev)
    ys[:, 0] = rec0
    t = times[:, 0].clone()
    y = _event(event_fn, torch.zeros(L, dtype=torch.long, device=dev), t, y0, args)
    dt = torch.full_like(t, first_dt)
    seg = torch.ones(L, dtype=torch.long, device=dev)
    ok = torch.ones(L, dtype=torch.bool, device=dev)
    for _ in range(total_trips):
        seg_c = torch.clamp(seg, max=S - 1)
        t1 = times.gather(1, seg_c[:, None])[:, 0]
        active = (seg < S) & ok
        remaining = torch.clamp(t1 - t, min=0.0)
        clipped = dt >= remaining
        dt_step = torch.minimum(dt, remaining)
        y5, err = _step(f, t, y, dt_step, args)
        err_norm = _error_norm(y, y5, err, rtol, atol)
        # zero-length remainder (repeated stop times): trivially accepted
        err_norm = torch.where(remaining > 0, err_norm, 0.0)
        accept = (err_norm <= 1.0) & active
        # keep the controller's dt across clipped stop-time landings
        new_dt = torch.where(
            active, torch.where(clipped & accept, dt, dt_step * _factor(err_norm)), dt
        )
        # snap clipped landings exactly onto the stop time
        t = torch.where(accept, torch.where(clipped, t1, t + dt_step), t)
        y = torch.where(accept[:, None], y5, y)
        reached = accept & (t >= t1)
        slot = torch.where(reached, seg_c, S)
        ys.scatter_(1, slot[:, None, None].expand(L, 1, m), record(y)[:, None, :])
        y = torch.where(reached[:, None], _event(event_fn, seg_c, t1, y, args), y)
        seg = seg + reached.to(torch.long)
        ok = ok & (~active | (_finite(y) & (new_dt > min_dt)))
        dt = new_dt
    ok = ok & (seg >= S)
    ys = torch.where(ok[:, None, None], ys[:, :S], torch.nan)
    return DP5Result(ys=ys, ok=ok, n_steps=torch.full((L,), total_trips, dtype=torch.int32,
                                                      device=dev))
