"""Batched L-stable Rosenbrock integrator (RODAS3) for stiff systems, lanes first.

Counterpart of bcm3_tpu/ode/rosenbrock.py (reference: the CVODE BDF wrapper
src/odecommon/ODESolverCVODE.cpp). The JAX package writes the solver for one
trajectory and vmaps it; here every function takes a lane axis first: L
independent trajectories, each with its own time, step size, stop pointer
and failure flag, advance together.

Method: RODAS3 (4 stages, order 3(2) embedded, L-stable, stiffly accurate;
the KPP ros_Rodas3 tableau). Each step takes the right-hand side's
derivatives by forward mode: one vmapped `torch.func.jvp` along t and the
n unit directions of y, the derivatives `jax.jacfwd` takes. The stage
matrix G = I/(h gamma) - J is factored by `torch.linalg.lu_factor_ex`
(partial pivoting, no host read, a singular G gives non-finite stages and a
rejected step) or, given a `SparseStageSolver` (ode/sparse_lu.py), over
its static fill pattern from coloured JVPs.

- `solve_at_times_stiff`: the adaptive solve across stop times. Each lane
  runs the JAX package's per-segment loop on its own: a lane that has
  finished a segment records it and starts the next at the same step of
  the loop as the others take theirs, so lanes never wait at a stop, and
  the results are the JAX package's lane by lane (a masked step changes no
  lane). Whether every lane is done is read from the card every
  `STOP_CHECK_EVERY` steps. With `fixed_trips` the segments run in
  lockstep with a static trip count each, and no host read at all.
- `solve_at_times_stiff_budget`: one static loop of `total_trips` steps
  with a stop pointer a lane; no host read.

Failure is a value: a lane that exhausts its step limit, whose step size
collapses or whose state goes non-finite has ok False and NaN states
(reference: ODESolverCVODE.cpp:354-370).

The right-hand side is ``f(t (L,), y (L, n), args) -> (L, n)``; an event,
``event_fn(i (L,) int64, t (L,), y (L, n), args) -> (L, n)``, is applied at
each stop after the state is recorded. A right-hand side that knows its
own derivatives passes them as ``jac(t, y, args) -> (f (L, n), df/dt (L,
n), df/dy (L, n, n))`` (the SBML models' compiled tangents,
sbml/model.py `make_rhs_jacobian`), which the solvers then take in place
of `linearize`.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

# RODAS3 tableau (KPP ros_Rodas3): 4 stages, order 3(2), L-stable
_GAMMA = 0.5
_ALPHA = np.array([0.0, 0.0, 1.0, 1.0])
_GAMMA_I = np.array([0.5, 1.5, 0.0, 0.0])
_A = np.zeros((4, 4))
_A[2, 0] = 2.0
_A[3, 0] = 2.0
_A[3, 2] = 1.0
_C = np.zeros((4, 4))
_C[1, 0] = 4.0
_C[2, 0] = 1.0
_C[2, 1] = -1.0
_C[3, 0] = 1.0
_C[3, 1] = -1.0
_C[3, 2] = -8.0 / 3.0
_M = np.array([2.0, 0.0, 1.0, 1.0])
_E = np.array([0.0, 0.0, 0.0, 1.0])
_ORDER = 3.0

_SAFETY = 0.9
_MIN_FACTOR = 0.2
_MAX_FACTOR = 6.0

# steps between the adaptive solve's reads of "is every lane done?"
STOP_CHECK_EVERY = 4


class StiffResult(NamedTuple):
    ys: torch.Tensor  # (L, S, n) solution at each stop time
    ok: torch.Tensor  # (L,) bool
    n_steps: torch.Tensor  # (L,) int32 steps taken (the budget solver: its trip count)


def linearize(f, t, y, args, seeds):
    """f(t, y, args) (L, n), its derivative in t (L, n) and its derivatives
    along each row of seeds (K, n) (K, L, n), by one vmapped forward-mode
    JVP over the K + 1 directions (t and the seeds, each the same for every
    lane)."""
    K, n = seeds.shape
    L = y.shape[0]
    # forward-mode primals must own their memory (not an expanded view)
    t, y = t.contiguous(), y.contiguous()
    tt = torch.zeros(K + 1, dtype=t.dtype, device=t.device)
    tt[0] = 1.0
    ty = torch.cat([seeds.new_zeros(1, n), seeds]).to(y)
    out, d = torch.func.vmap(
        lambda a, b: torch.func.jvp(lambda tt_, yy: f(tt_, yy, args), (t, y), (a, b)),
        out_dims=(None, 0),
    )(tt[:, None].expand(K + 1, L), ty[:, None, :].expand(K + 1, L, n))
    return out, d[0], d[1:]


def jacobian(f, t, y, args):
    """(f(t, y), df/dt (L, n), df/dy (L, n, n)), J[l, i, j] = d f_i / d y_j."""
    eye = torch.eye(y.shape[-1], dtype=y.dtype, device=y.device)
    f0, ft, jv = linearize(f, t, y, args, eye)
    return f0, ft, jv.permute(1, 2, 0)


def _rosenbrock_step(f, t, y, h, args, sparse=None, jac=None):
    """One RODAS3 step of every lane. Returns (y_new, err). `jac(t, y,
    args) -> (f, df/dt, df/dy)`, when given, supplies the derivatives in
    place of `linearize`."""
    if sparse is not None:
        inv_hg = 1.0 / (h * _GAMMA)
        if jac is None:
            f0, ft, jv = linearize(f, t, y, args, sparse.seeds_like(y))
            entries = sparse.entries_from_jvps(jv)
        else:
            f0, ft, J = jac(t, y, args)
            entries = sparse.entries_from_jacobian(J)
        A = sparse.factor_G(entries, inv_hg)
        solve = lambda rhs: sparse.solve(A, rhs)  # noqa: E731
    else:
        f0, ft, J = jacobian(f, t, y, args) if jac is None else jac(t, y, args)
        eye = torch.eye(y.shape[-1], dtype=y.dtype, device=y.device)
        G = eye / (h * _GAMMA)[:, None, None] - J
        LU, piv, _ = torch.linalg.lu_factor_ex(G)
        solve = lambda rhs: torch.linalg.lu_solve(LU, piv, rhs[..., None])[..., 0]  # noqa: E731

    # The JAX package also adds the tableau's zero terms (0 k_j, 0 h ft):
    # for finite stages they change nothing, and a non-finite stage makes
    # the step's error non-finite (rejected) either way.
    ks = []
    for i in range(4):
        yi = y
        for j in range(i):
            if _A[i, j] != 0.0:
                yi = yi + float(_A[i, j]) * ks[j]
        # stage 0 evaluates f at the linearization point (t + 0 h, y)
        fi = f0 if i == 0 else f(t + float(_ALPHA[i]) * h, yi, args)
        rhs = fi if _GAMMA_I[i] == 0.0 else fi + (float(_GAMMA_I[i]) * h)[:, None] * ft
        for j in range(i):
            rhs = rhs + (float(_C[i, j]) / h)[:, None] * ks[j]
        ks.append(solve(rhs))

    y_new, err = y, None
    for i in range(4):
        if _M[i] != 0.0:
            y_new = y_new + float(_M[i]) * ks[i]
        if _E[i] != 0.0:
            term = float(_E[i]) * ks[i]
            err = term if err is None else err + term
    return y_new, err


def _error_norm(y, y_new, err, rtol, atol):
    scale = atol + rtol * torch.maximum(y.abs(), y_new.abs())
    err_norm = torch.sqrt(((err / scale) ** 2).mean(dim=-1))
    return torch.where(torch.isfinite(err_norm), err_norm, torch.inf)


def _factor(err_norm):
    return torch.clamp(_SAFETY * (err_norm + 1e-30) ** (-1.0 / _ORDER), _MIN_FACTOR, _MAX_FACTOR)


def _finite(y):
    return torch.isfinite(y).all(dim=-1)


def _min_dt(t1):
    return 1e-14 * torch.clamp(t1.abs(), min=1.0)


def _lane_times(stop_times, y0):
    times = torch.as_tensor(stop_times).to(y0)
    return times.expand(y0.shape[0], times.shape[-1]) if times.dim() == 1 else times


def _event(event_fn, i, t, y, args):
    return y if event_fn is None else event_fn(i, t, y, args)


def _segment_fori(f, t0, t1, y0, dt0, args, rtol, atol, trips, sparse, jac):
    """bcm3_tpu/ode/rosenbrock.py `_integrate_segment_fori` over lanes:
    `trips` steps with finished lanes masked; a lane that has not reached
    t1 fails."""
    t, y = t0, y0
    dt = torch.clamp(dt0, min=1e-12)
    steps = torch.zeros_like(t, dtype=torch.int32)
    ok = torch.ones_like(t, dtype=torch.bool)
    for _ in range(trips):
        active = (t < t1) & ok
        dt_clip = torch.minimum(dt, t1 - t)
        y_new, err = _rosenbrock_step(f, t, y, dt_clip, args, sparse, jac)
        err_norm = _error_norm(y, y_new, err, rtol, atol)
        accept = (err_norm <= 1.0) & active
        new_dt = torch.where(active, dt_clip * _factor(err_norm), dt)
        t = torch.where(accept, t + dt_clip, t)
        y = torch.where(accept[:, None], y_new, y)
        ok = ok & (~active | (_finite(y) & (new_dt > _min_dt(t1))))
        steps = steps + active.to(torch.int32)
        dt = new_dt
    ok = ok & (t >= t1) & _finite(y)
    return y, dt, steps, ok


def solve_at_times_stiff(
    f: Callable,
    y0,
    stop_times,
    args=None,
    event_fn: Optional[Callable] = None,
    rtol: float = 1e-6,
    atol: float = 1e-9,
    max_steps_per_segment: int = 5000,
    first_dt: float = 1e-4,
    fixed_trips: Optional[int] = None,
    sparse=None,
    jac: Optional[Callable] = None,
) -> StiffResult:
    """Integrate y' = f(t, y, args) of L lanes across sorted stop times
    (bcm3_tpu/ode/rosenbrock.py `solve_at_times_stiff`).

    y0: (L, n); stop_times: (S,) shared or (L, S) per lane, starting at the
    initial time (ys[:, 0] = y0). `event_fn` is applied at the first stop
    before integrating and at every later stop after its state is
    recorded. A lane's step size carries over from one segment to the
    next, floored at 1e-12 at each segment's start. A segment fails when it
    uses `max_steps_per_segment` steps without reaching its stop, or its
    step size falls below 1e-14 max(|t1|, 1) or its state goes non-finite;
    from the first failed segment on, a lane's states are NaN and its ok is
    False (it goes on integrating, as the JAX package's does, so its step
    count is the same)."""
    L, n = y0.shape
    dev = y0.device
    times = _lane_times(stop_times, y0)
    S = times.shape[1]
    t = times[:, 0].clone()
    y = _event(event_fn, torch.zeros(L, dtype=torch.long, device=dev), t, y0, args)
    dt = torch.full_like(t, first_dt)
    if fixed_trips is not None:
        ok = torch.ones(L, dtype=torch.bool, device=dev)
        total = torch.zeros(L, dtype=torch.int32, device=dev)
        ys = [y0]
        for i in range(1, S):
            t_next = times[:, i]
            grows = (t_next - t) > 0
            y_new, dt, steps, seg_ok = _segment_fori(
                f, t, t_next, y, dt, args, rtol, atol, fixed_trips, sparse, jac
            )
            y_new = torch.where(grows[:, None], y_new, y)
            ok = ok & torch.where(grows, seg_ok, True)
            ys.append(torch.where(ok[:, None], y_new, torch.nan))
            y = _event(event_fn, torch.full((L,), i, dtype=torch.long, device=dev), t_next,
                       y_new, args)
            t = t_next
            total = total + steps
        return StiffResult(ys=torch.stack(ys, dim=1), ok=ok, n_steps=total)

    # slot S of the record takes the rows of lanes that end no segment in a
    # step, so every transition scatters one row a lane without a mask
    ys = torch.full((L, S + 1, n), torch.nan, dtype=y0.dtype, device=dev)
    ys[:, 0] = y0
    seg = torch.ones(L, dtype=torch.long, device=dev)
    steps = torch.zeros(L, dtype=torch.int32, device=dev)
    total = torch.zeros(L, dtype=torch.int32, device=dev)
    seg_ok = torch.ones(L, dtype=torch.bool, device=dev)
    ok = torch.ones(L, dtype=torch.bool, device=dev)
    dt = torch.clamp(dt, min=1e-12)

    def bounds():
        seg_c = torch.clamp(seg, max=S - 1)
        return seg_c, times.gather(1, seg_c[:, None])[:, 0]

    def live(t1):
        return (seg < S) & (t < t1) & seg_ok & (steps < max_steps_per_segment)

    def end_segments():
        """The segment's end for every lane whose loop condition fails:
        its ok, its recorded state, the event, the next segment's start."""
        nonlocal t, y, dt, seg, steps, total, seg_ok, ok
        seg_c, t1 = bounds()
        ending = (seg < S) & ~live(t1)
        grows = (t1 - times.gather(1, (seg_c - 1)[:, None])[:, 0]) > 0
        s_ok = ((seg_ok & (steps < max_steps_per_segment)) | (t >= t1)) & _finite(y)
        ok = torch.where(ending & grows, ok & s_ok, ok)
        slot = torch.where(ending, seg_c, S)
        ys.scatter_(1, slot[:, None, None].expand(L, 1, n),
                    torch.where(ok[:, None], y, torch.nan)[:, None, :])
        if event_fn is not None:
            y = torch.where(ending[:, None], event_fn(seg_c, t1, y, args), y)
        t = torch.where(ending, t1, t)
        total = total + torch.where(ending, steps, 0)
        steps = torch.where(ending, 0, steps)
        seg_ok = seg_ok | ending
        dt = torch.where(ending, torch.clamp(dt, min=1e-12), dt)
        seg = seg + ending.to(torch.long)

    def step():
        nonlocal t, y, dt, steps, seg_ok
        _, t1 = bounds()
        lv = live(t1)
        dt_clip = torch.minimum(dt, t1 - t)
        y_new, err = _rosenbrock_step(f, t, y, dt_clip, args, sparse, jac)
        err_norm = _error_norm(y, y_new, err, rtol, atol)
        accept = err_norm <= 1.0
        new_dt = dt_clip * _factor(err_norm)
        t_acc = torch.where(accept, t + dt_clip, t)
        y_acc = torch.where(accept[:, None], y_new, y)
        s_ok = seg_ok & (new_dt > _min_dt(t1)) & _finite(y_acc)
        t = torch.where(lv, t_acc, t)
        y = torch.where(lv[:, None], y_acc, y)
        dt = torch.where(lv, new_dt, dt)
        seg_ok = torch.where(lv, s_ok, seg_ok)
        steps = steps + lv.to(torch.int32)

    if S > 1:
        end_segments()
    while bool((seg < S).any()):
        for _ in range(STOP_CHECK_EVERY):
            step()
            end_segments()
    return StiffResult(ys=ys[:, :S], ok=ok, n_steps=total)


def solve_at_times_stiff_budget(
    f: Callable,
    y0,
    stop_times,
    args=None,
    rtol: float = 1e-6,
    atol: float = 1e-9,
    total_trips: int = 1024,
    first_dt: float = 1e-4,
    sparse=None,
    jac: Optional[Callable] = None,
) -> StiffResult:
    """Whole-trajectory step-budget form of `solve_at_times_stiff`
    (bcm3_tpu/ode/rosenbrock.py `solve_at_times_stiff_budget`): one static
    loop of `total_trips` steps with a stop-time pointer a lane and a
    masked record; a clipped landing keeps the controller's dt; no event
    hook and no host read. A lane that has not reached its last stop fails
    (NaN states, ok False)."""
    L, n = y0.shape
    dev = y0.device
    times = _lane_times(stop_times, y0)
    S = times.shape[1]
    ys = torch.full((L, S + 1, n), torch.nan, dtype=y0.dtype, device=dev)
    ys[:, 0] = y0
    t = times[:, 0].clone()
    y = y0
    dt = torch.full_like(t, first_dt)
    seg = torch.ones(L, dtype=torch.long, device=dev)
    ok = torch.ones(L, dtype=torch.bool, device=dev)
    for _ in range(total_trips):
        seg_c = torch.clamp(seg, max=S - 1)
        t1 = times.gather(1, seg_c[:, None])[:, 0]
        active = (seg < S) & ok
        remaining = torch.clamp(t1 - t, min=0.0)
        clipped = dt >= remaining
        # zero-length remainder: a tiny step keeps G finite; it is accepted
        dt_step = torch.clamp(torch.minimum(dt, remaining), min=1e-30)
        y_new, err = _rosenbrock_step(f, t, y, dt_step, args, sparse, jac)
        err_norm = _error_norm(y, y_new, err, rtol, atol)
        err_norm = torch.where(remaining > 0, err_norm, 0.0)
        y_new = torch.where((remaining > 0)[:, None], y_new, y)
        accept = (err_norm <= 1.0) & active
        new_dt = torch.where(
            active, torch.where(clipped & accept, dt, dt_step * _factor(err_norm)), dt
        )
        t_new = torch.where(accept, torch.where(clipped, t1, t + dt_step), t)
        y_new = torch.where(accept[:, None], y_new, y)
        reached = accept & (t_new >= t1)
        slot = torch.where(reached, seg_c, S)
        ys.scatter_(1, slot[:, None, None].expand(L, 1, n), y_new[:, None, :])
        seg = seg + reached.to(torch.long)
        ok = ok & (~active | (_finite(y_new) & (new_dt > _min_dt(t1))))
        t, y, dt = t_new, y_new, new_dt
    ok = ok & (seg >= S)
    ys = torch.where(ok[:, None, None], ys[:, :S], torch.nan)
    return StiffResult(ys=ys, ok=ok,
                       n_steps=torch.full((L,), total_trips, dtype=torch.int32, device=dev))
