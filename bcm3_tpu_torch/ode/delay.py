"""Batched delay-ODE integrators on torch tensors (method of steps).

Counterpart of bcm3_tpu/ode/delay.py (reference:
src/odecommon/CVODESolverDelay.{h,cpp}, which keeps the solution history
inside the solver and interpolates delayed states from it). The JAX
package writes each solver for one trajectory and vmaps it; here every
function takes a lane axis first: L independent trajectories advance
together, each with its own delay, step size and failure flag.

- `solve_dde_grid`: classical RK4 on a uniform grid with the whole
  history, the delayed state a linear interpolation in a three-row window;
- `solve_dde_ring`: the same RK4 reading only the last `ring_size` grid
  rows (the incucyte default): a window sliding over the trajectory,
  each lane's delayed rows and weights found once a solve. Ring and grid
  agree where the delay fits the ring; delays beyond `ring_size - 2` grid
  steps clamp to the oldest row;
- `solve_dde_adaptive`: Bogacki-Shampine 3(2) with local error control,
  `trips_per_interval` masked substeps a grid interval, and a
  cubic-Hermite history lookup;
- `solve_dde_budget`: one loop of `total_trips` BS3(2) steps with a
  grid-stop pointer per lane; each lane writes its history row when it
  reaches its next grid stop (a masked scatter).

The step loops are Python loops of a fixed trip count, as `lax.scan` and
`fori_loop` are: no solve reads a tensor on the host, and `ok` stays a
tensor. Failure is a value: a lane that goes non-finite or exhausts its
budget has ok = False and NaN states (NaN -> -inf in the likelihood).

The right-hand side is ``f(t, y (L, n), y_delayed (L, n), args) -> (L, n)``
with t a 0-d tensor or a (L,) tensor; `delay` is a number or a (L,) tensor.
History before the first grid time is clamped to y0.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class DDEResult(NamedTuple):
    ys: torch.Tensor  # (L, G, n) solution on the grid
    ok: torch.Tensor  # (L,) bool


def _setup(y0, grid, delay):
    L = y0.shape[0]
    delay = torch.as_tensor(delay, dtype=y0.dtype, device=y0.device).expand(L)
    lanes = torch.arange(L, device=y0.device)
    return grid[0], grid[1] - grid[0], delay, lanes


def _rk4_step(f, t, h, y, yd0, ydh, yd1, args):
    """One classical RK4 step; the stage times are t, t + h/2 (twice) and
    t + h, so stages 2 and 3 share one delayed value."""
    k1 = f(t, y, yd0, args)
    k2 = f(t + 0.5 * h, y + 0.5 * h * k1, ydh, args)
    k3 = f(t + 0.5 * h, y + 0.5 * h * k2, ydh, args)
    k4 = f(t + h, y + h * k3, yd1, args)
    return y + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)


def _fail_nonfinite(y_new, ok):
    ok = ok & torch.isfinite(y_new).all(dim=-1)
    return torch.where(ok[:, None], y_new, torch.full_like(y_new, float("nan"))), ok


def solve_dde_grid(
    f: Callable,  # f(t, y, y_delayed, args) -> dy/dt
    y0: torch.Tensor,  # (L, n)
    grid: torch.Tensor,  # (G,) uniform, increasing
    delay,
    args=None,
) -> DDEResult:
    """Integrate y'(t) = f(t, y(t), y(t - delay)) on a uniform grid with
    RK4, the whole history kept (bcm3_tpu/ode/delay.py:30-107). All four
    stage times of a step lie in [t, t + h], so three consecutive history
    rows from a per-lane base cover every delayed lookup of the step."""
    G = grid.shape[0]
    L, n = y0.shape
    t0, h, delay, lanes = _setup(y0, grid, delay)
    window = torch.arange(3, device=y0.device)[:, None]
    hist = y0.new_zeros((G, L, n))
    hist[0] = y0
    ok = torch.ones(L, dtype=torch.bool, device=y0.device)
    for i in range(1, G):
        t = t0 + (i - 1) * h
        y = hist[i - 1]
        pos_lo = (t - delay - t0) / h
        base = torch.floor(pos_lo).long().clamp(0, G - 3)
        win = hist[base[None, :] + window, lanes]  # (3, L, n)

        def lookup(tt):
            pos = ((tt - t0) / h).clamp(0.0, float(i - 1))
            rel = (pos - base).clamp(0.0, 2.0)
            i0 = torch.floor(rel).long().clamp(0, 1)
            frac = (rel - i0)[:, None]
            first = (i0 == 0)[:, None]
            a = torch.where(first, win[0], win[1])
            b = torch.where(first, win[1], win[2])
            return a * (1.0 - frac) + b * frac

        y_new = _rk4_step(f, t, h, y, lookup(t - delay), lookup(t + 0.5 * h - delay),
                          lookup(t + h - delay), args)
        y_new, ok = _fail_nonfinite(y_new, ok)
        hist[i] = y_new
    return DDEResult(ys=hist.transpose(0, 1), ok=ok)


def solve_dde_ring(
    f: Callable,  # f(t, y, y_delayed, args) -> dy/dt
    y0: torch.Tensor,  # (L, n)
    grid: torch.Tensor,  # (G,) uniform, increasing
    delay,
    args=None,
    ring_size: int = 64,
) -> DDEResult:
    """RK4 as `solve_dde_grid` with a ring of the last `ring_size` grid
    rows as its history (bcm3_tpu/ode/delay.py:227-300).

    The JAX package shifts its ring by one row a step. Here the ring is a
    sliding window over the trajectory, which a step writes once: buffer
    row K - 1 + m holds grid row m and the K - 1 rows before it hold y0,
    the history clamp before t0, so the window of step i is buffer rows
    i - 1 .. i + K - 2. A delayed time t + c h - delay (c = 0, 1/2, 1)
    lies delay / h - c grid steps behind the step's newest row whatever
    the step, so each lane's two ring rows and their weights are found
    once per solve; the JAX package recomputes them each step, which
    rounds them apart by a few ulps. Delays beyond K - 2 grid steps clamp
    to the oldest row. A lane that goes non-finite keeps integrating; its
    rows from that step on are set to NaN at the end, as the JAX package
    sets them step by step."""
    G = grid.shape[0]
    L, n = y0.shape
    K = ring_size
    t0, h, delay, lanes = _setup(y0, grid, delay)
    hh, h6 = 0.5 * h, h / 6.0
    ts = t0 + torch.arange(G - 1, dtype=y0.dtype, device=y0.device) * h  # step starts
    th, t1 = ts + hh, ts + h
    taps = []  # per stage time: flat rows (2L,) into the window, weights (L, 1)
    for c in (0.0, 0.5, 1.0):
        j = (K - 1) - (delay / h - c).clamp(0.0, K - 1.0)
        j0 = torch.floor(j).long().clamp(0, K - 2)
        frac = (j - j0)[:, None]
        taps.append((torch.cat([j0 * L + lanes, (j0 + 1) * L + lanes]), 1.0 - frac, frac))
    hist = y0[None].expand(G + K - 1, L, n).contiguous()

    def lookup(window, tap):
        rows, w0, w1 = tap
        ab = window.index_select(0, rows).view(2, L, n)
        return torch.addcmul(ab[0] * w0, ab[1], w1)

    y = y0
    for i in range(1, G):
        window = hist[i - 1:i - 1 + K].view(K * L, n)
        yd0, ydh, yd1 = (lookup(window, tap) for tap in taps)
        k1 = f(ts[i - 1], y, yd0, args)
        k2 = f(th[i - 1], torch.addcmul(y, hh, k1), ydh, args)
        k3 = f(th[i - 1], torch.addcmul(y, hh, k2), ydh, args)
        k4 = f(t1[i - 1], torch.addcmul(y, h, k3), yd1, args)
        y = torch.addcmul(y, h6, (k1 + k4).add_(k2 + k3, alpha=2.0))
        hist[K - 1 + i] = y
    ys = hist[K - 1:]
    if G == 1:
        return DDEResult(ys=ys.transpose(0, 1), ok=torch.ones_like(lanes, dtype=torch.bool))
    failed = (~torch.isfinite(ys[1:]).all(dim=-1)).cumsum(dim=0) > 0  # (G - 1, L)
    ys[1:] = torch.where(failed[..., None], float("nan"), ys[1:])
    return DDEResult(ys=ys.transpose(0, 1), ok=~failed[-1])


# Bogacki-Shampine 3(2) embedded pair: 4 stages, order 3 with an order-2
# error estimate
_BS_C = (0.0, 0.5, 0.75, 1.0)
_BS_A = ((), (0.5,), (0.0, 0.75), (2 / 9, 1 / 3, 4 / 9))
_BS_B3 = (2 / 9, 1 / 3, 4 / 9, 0.0)
_BS_B2 = (7 / 24, 1 / 4, 1 / 3, 1 / 8)


def _hermite_lookup(hist, filled, t, t0, h, lanes):
    """Cubic-Hermite interpolation of each lane's history at its time t,
    clamped to [t0, grid time `filled`] (filled: a number or (L,)).
    hist (G, L, 2n) holds each grid row's state and its derivative times
    h; the cubic is evaluated in Horner form."""
    G, n = hist.shape[0], hist.shape[2] // 2
    pos = ((t - t0) / h).clamp(min=0.0)
    pos = pos.clamp(max=filled) if isinstance(filled, float) else torch.minimum(pos, filled)
    i0 = torch.floor(pos).long().clamp(0, G - 1)  # a NaN time casts to the least long
    s = (pos - i0)[:, None]
    a, b = hist[i0, lanes], hist[(i0 + 1).clamp(max=G - 1), lanes]
    y_a, d_a, d_b = a[:, :n], a[:, n:], b[:, n:]
    dy = b[:, :n] - y_a
    c3 = torch.add(d_a + d_b, dy, alpha=-2.0)  # 2 y_a + d_a - 2 y_b + d_b
    c2 = torch.sub(3.0 * dy - d_b, d_a, alpha=2.0)  # -3 y_a - 2 d_a + 3 y_b - d_b
    return torch.addcmul(y_a, s, torch.addcmul(d_a, s, torch.addcmul(c2, s, c3)))


def _bs32_step(fd, t, y, dts, rtol, atol):
    """One embedded BS3(2) step of every lane at its step dts (L,):
    the order-3 state and the error norm."""
    dcol = dts[:, None]
    scaled = {}

    def step_times(c):  # dts * c, once for each coefficient
        if c not in scaled:
            scaled[c] = dcol * c
        return scaled[c]

    ks = []
    for s in range(4):
        yi = y
        for j, a in enumerate(_BS_A[s]):
            yi = torch.addcmul(yi, step_times(a), ks[j])
        ks.append(fd(torch.add(t, dts, alpha=_BS_C[s]), yi))
    y3 = y
    err = torch.zeros_like(y)
    for s in range(4):
        y3 = torch.addcmul(y3, step_times(_BS_B3[s]), ks[s])
        err = torch.addcmul(err, step_times(_BS_B3[s] - _BS_B2[s]), ks[s])
    scale = atol + rtol * torch.maximum(y.abs(), y3.abs())
    return y3, ((err / scale) ** 2).mean(dim=-1).sqrt()


def _step_factor(err_norm):
    return (0.9 * (err_norm + 1e-30) ** (-1 / 3)).clamp(0.2, 5.0)


def solve_dde_adaptive(
    f: Callable,  # f(t, y, y_delayed, args) -> dy/dt
    y0: torch.Tensor,  # (L, n)
    grid: torch.Tensor,  # (G,) uniform, increasing: history/output grid
    delay,
    args=None,
    rtol: float = 1e-6,
    atol: float = 1e-2,
    trips_per_interval: int = 8,
    min_dt: float = 0.0,
) -> DDEResult:
    """Adaptive method of steps on a uniform history grid
    (bcm3_tpu/ode/delay.py:110-224): each grid interval is integrated by
    up to `trips_per_interval` masked BS3(2) substeps with per-lane
    step-size control, the history read by cubic-Hermite interpolation.
    Substeps inside interval i read history up to grid point i-1 only.
    A lane that does not reach the interval's end within its trips, falls
    to min_dt or goes non-finite fails."""
    G = grid.shape[0]
    L, n = y0.shape
    t0, h, delay, lanes = _setup(y0, grid, delay)
    hist = y0.new_zeros((G, L, 2 * n))  # each row's state and h * its derivative
    hist[0, :, :n] = y0
    hist[0, :, n:] = f(t0, y0, y0, args) * h  # history before t0 is clamped to y0
    dt = h.expand(L)
    ok = torch.ones(L, dtype=torch.bool, device=y0.device)
    for i in range(1, G):
        t_end = t0 + i * h
        filled = float(i - 1)

        def fd(tt, yy):
            return f(tt, yy, _hermite_lookup(hist, filled, tt - delay, t0, h, lanes), args)

        t = (t0 + (i - 1) * h).expand(L)
        y = hist[i - 1, :, :n]
        sok = ok
        for _ in range(trips_per_interval):
            active = (t < t_end) & sok
            remaining = (t_end - t).clamp(min=0.0)
            clipped = dt >= remaining
            dts = torch.minimum(dt, remaining)
            y3, err_norm = _bs32_step(fd, t, y, dts, rtol, atol)
            err_norm = torch.where(remaining > 0, err_norm, 0.0)
            accept = (err_norm <= 1.0) & active
            new_dt = torch.where(active & ~(clipped & accept), dts * _step_factor(err_norm), dt)
            t = torch.where(accept, torch.where(clipped, t_end, t + dts), t)
            y = torch.where(accept[:, None], y3, y)
            sok = sok & (~active | (torch.isfinite(y).all(dim=-1) & (new_dt > min_dt)))
            dt = new_dt
        ok = sok & (t >= t_end)
        y = torch.where(ok[:, None], y, torch.full_like(y, float("nan")))
        hist[i, :, :n] = y
        hist[i, :, n:] = fd(t_end, y) * h
    return DDEResult(ys=hist[:, :, :n].transpose(0, 1), ok=ok)


def solve_dde_budget(
    f: Callable,  # f(t, y, y_delayed, args) -> dy/dt
    y0: torch.Tensor,  # (L, n)
    grid: torch.Tensor,  # (G,) uniform, increasing: history/output grid
    delay,
    args=None,
    rtol: float = 1e-6,
    atol: float = 1e-2,
    total_trips: int = 256,
    min_dt: float = 0.0,
) -> DDEResult:
    """Whole-trajectory step-budget form of `solve_dde_adaptive`
    (bcm3_tpu/ode/delay.py:303-416): one loop of `total_trips` BS3(2)
    steps with a grid-stop pointer per lane, steps clipped to the grid
    stops so that every history row is an accepted solution point. A lane
    writes its row (and the derivative there) when it reaches its stop.
    Lanes needing more than `total_trips` steps fail."""
    G = grid.shape[0]
    L, n = y0.shape
    t0, h, delay, lanes = _setup(y0, grid, delay)
    dtype = y0.dtype
    hist = y0.new_zeros((G, L, 2 * n))  # each row's state and h * its derivative
    hist[0, :, :n] = y0
    hist[0, :, n:] = f(t0, y0, y0, args) * h
    t = t0.expand(L)
    y = y0
    dt = h.expand(L)
    seg = torch.ones(L, dtype=torch.long, device=y0.device)
    ok = torch.ones(L, dtype=torch.bool, device=y0.device)
    for _ in range(total_trips):
        seg_c = seg.clamp(max=G - 1)
        t_stop = t0 + seg_c.to(dtype) * h
        filled = (seg_c - 1).to(dtype)

        def fd(tt, yy):
            return f(tt, yy, _hermite_lookup(hist, filled, tt - delay, t0, h, lanes), args)

        active = (seg < G) & ok
        remaining = (t_stop - t).clamp(min=0.0)
        clipped = dt >= remaining
        dts = torch.minimum(dt, remaining).clamp(min=1e-30)
        y3, err_norm = _bs32_step(fd, t, y, dts, rtol, atol)
        moved = remaining > 0
        err_norm = torch.where(moved, err_norm, 0.0)
        y3 = torch.where(moved[:, None], y3, y)
        accept = (err_norm <= 1.0) & active
        new_dt = torch.where(active & ~(clipped & accept), dts * _step_factor(err_norm), dt)
        t = torch.where(accept, torch.where(clipped, t_stop, t + dts), t)
        y = torch.where(accept[:, None], y3, y)
        reached = accept & (t >= t_stop)
        # the grid node and its derivative, written where the lane reached it
        node = torch.cat([y, fd(t_stop, y) * h], dim=-1)
        hist[seg_c, lanes] = torch.where(reached[:, None], node, hist[seg_c, lanes])
        seg = seg + reached.long()
        ok = ok & (~active | (torch.isfinite(y).all(dim=-1) & (new_dt > min_dt)))
        dt = new_dt
    ok = ok & (seg >= G)
    ys = torch.where(ok[None, :, None], hist[:, :, :n], float("nan"))
    return DDEResult(ys=ys.transpose(0, 1), ok=ok)
