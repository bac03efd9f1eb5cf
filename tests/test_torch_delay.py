"""The port's delay-ODE solvers (bcm3_tpu_torch/ode/delay.py) against the
JAX package's (bcm3_tpu/ode/delay.py), vmapped over the same lanes.

Eight lanes with per-lane delays in [0.5, 1.5] (and, for the delayed
logistic, per-lane rates as solver args) on the problems of
tests/test_cellmisc.py: y' = -y(t - tau) with y = 1 before 0 (:28-38) and
the delayed logistic y' = r y (1 - y(t - tau)) (:224-253). For the ring,
one lane's delay exceeds the ring, so both packages clamp it to the oldest
row; for grid and ring, lanes with delays below a step and lanes that blow
up. Tolerances, float64: `ys` rtol 1e-12 for `grid` and `ring`, 1e-9 for
`adaptive` and `budget` (their step-size control rounds its pow and mean
apart), with atol 1e-14 where the decay solution crosses zero; `ok`
equal. Budget exhaustion fails soft in both. No solve reads
a tensor on the host: each runs with `Tensor.item`, `__bool__` and the
other host reads patched to raise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bcm3_tpu.ode import delay as jd
from bcm3_tpu_torch.ode import delay as td

L = 8
_RTOL = {"grid": 1e-12, "ring": 1e-12, "adaptive": 1e-9, "budget": 1e-9}


def _decay(t, y, yd, args):
    return -yd


def _logistic(t, y, yd, args):
    return args * y * (1.0 - yd)


def _problem(name):
    """(f, y0 (L, 1), grid, delays (L,), rates (L,) or None)."""
    rng = np.random.default_rng(3)
    delays = rng.uniform(0.5, 1.5, L)
    if name == "decay":
        return _decay, np.ones((L, 1)), np.linspace(0.0, 2.0, 41), delays, None
    return _logistic, np.full((L, 1), 0.1), np.linspace(0.0, 8.0, 33), delays, \
        rng.uniform(1.0, 1.8, L)


def _kw(solver, grid):
    if solver == "ring":
        # 1.1 time units of ring at the decay grid's h = 0.05: the lanes
        # with delays beyond it clamp
        return dict(ring_size=24)
    if solver == "adaptive":
        return dict(rtol=1e-6, atol=1e-6, trips_per_interval=16)
    if solver == "budget":
        return dict(rtol=1e-6, atol=1e-6, total_trips=10 * len(grid))
    return {}


_SOLVE = {"grid": "solve_dde_grid", "ring": "solve_dde_ring",
          "adaptive": "solve_dde_adaptive", "budget": "solve_dde_budget"}


def _both(solver, f, y0, grid, delays, rates, **kw):
    """(port's ys (L, G, n), ok (L,)), (JAX's) on the same lanes."""
    jfn = getattr(jd, _SOLVE[solver])
    if rates is None:
        ref = jax.vmap(lambda y, d: jfn(f, y, jnp.asarray(grid), d, **kw))(
            jnp.asarray(y0), jnp.asarray(delays))
        args = None
    else:
        ref = jax.vmap(lambda y, d, r: jfn(f, y, jnp.asarray(grid), d, args=r, **kw))(
            jnp.asarray(y0), jnp.asarray(delays), jnp.asarray(rates))
        args = torch.as_tensor(rates)[:, None]
    got = getattr(td, _SOLVE[solver])(f, torch.as_tensor(y0), torch.as_tensor(grid),
                                       torch.as_tensor(delays), args=args, **kw)
    return (got.ys.numpy(), got.ok.numpy()), (np.asarray(ref.ys), np.asarray(ref.ok))


@pytest.mark.parametrize("problem", ["decay", "logistic"])
@pytest.mark.parametrize("solver", ["grid", "ring", "adaptive", "budget"])
def test_solver_matches_jax(solver, problem):
    f, y0, grid, delays, rates = _problem(problem)
    (ys, ok), (ref_ys, ref_ok) = _both(solver, f, y0, grid, delays, rates,
                                       **_kw(solver, grid))
    assert ys.shape == ref_ys.shape == (L, len(grid), 1)
    np.testing.assert_array_equal(ok, ref_ok)
    assert ok.all()
    np.testing.assert_allclose(ys, ref_ys, rtol=_RTOL[solver], atol=1e-14)


def test_ring_clamps_delays_beyond_it_as_jax():
    """The decay problem's lanes whose delay exceeds the ring (22 steps =
    1.1) are clamped alike in both packages and differ from the grid
    solver's; the others equal the grid solver's."""
    f, y0, grid, delays, _ = _problem("decay")
    beyond = delays > 1.1
    assert beyond.any() and not beyond.all()
    (ring, _), (ref_ring, _) = _both("ring", f, y0, grid, delays, None, ring_size=24)
    full = td.solve_dde_grid(f, torch.as_tensor(y0), torch.as_tensor(grid),
                             torch.as_tensor(delays)).ys.numpy()
    np.testing.assert_allclose(ring, ref_ring, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(ring[~beyond], full[~beyond], rtol=1e-12, atol=1e-14)
    assert (np.abs(ring[beyond] - full[beyond]).max(axis=(1, 2)) > 1e-6).all()


@pytest.mark.parametrize("solver", ["grid", "ring"])
def test_short_delays_and_blow_up_as_jax(solver):
    """Lanes whose delay is shorter than a step or half a step (their
    delayed values clamp to the newest row) and lanes that blow up
    (y' = r y y(t - tau) with r y0 above 1 / 2: non-finite within the
    grid): ok and every row equal the JAX package's, the failed lanes NaN
    from their failing step on."""
    f = lambda t, y, yd, args: args * y * yd
    grid = np.linspace(0.0, 2.0, 41)  # h = 0.05
    delays = np.array([0.01, 0.03, 0.05, 0.2, 0.01, 0.03, 0.2, 1.0])
    rates = np.array([0.5, 0.5, 0.5, 0.5, 80.0, 40.0, 60.0, 50.0])
    (ys, ok), (ref_ys, ref_ok) = _both(solver, f, np.ones((L, 1)), grid, delays, rates,
                                       **_kw(solver, grid))
    np.testing.assert_array_equal(ok, ref_ok)
    assert ok[:4].all() and not ok[4:].any()
    np.testing.assert_array_equal(np.isnan(ys), np.isnan(ref_ys))
    assert np.isnan(ys[4:, -1]).all() and not np.isnan(ys[4:, 1]).any()
    np.testing.assert_allclose(ys, ref_ys, rtol=1e-12, atol=1e-14)


def test_budget_exhaustion_fails_soft_as_jax():
    """tests/test_small_expm.py:100-113: fast dynamics, 16 trips."""
    f = lambda t, y, yd, args: 50.0 * y * (1.0 - yd)
    grid = np.linspace(0.0, 20.0, 128)
    (ys, ok), (ref_ys, ref_ok) = _both(
        "budget", f, np.full((L, 1), 0.1), grid, np.ones(L), None,
        rtol=1e-10, atol=1e-12, total_trips=16)
    np.testing.assert_array_equal(ok, ref_ok)
    assert not ok.any() and np.isnan(ys).all() and np.isnan(ref_ys).all()


def test_adaptive_exhaustion_fails_soft_as_jax():
    """tests/test_cellmisc.py:256-267: a fast decay, 3 substeps an interval."""
    f = lambda t, y, yd, args: -4000.0 * y + yd
    (ys, ok), (ref_ys, ref_ok) = _both(
        "adaptive", f, np.ones((L, 1)), np.linspace(0.0, 1.0, 6), np.full(L, 10.0), None,
        rtol=1e-10, atol=1e-12, trips_per_interval=3)
    np.testing.assert_array_equal(ok, ref_ok)
    assert not ok.any()
    np.testing.assert_array_equal(np.isnan(ys), np.isnan(ref_ys))


def _no_host_read(*args, **kwargs):
    raise AssertionError("a solve read a tensor on the host")


@pytest.mark.parametrize("solver", ["grid", "ring", "adaptive", "budget"])
def test_solve_makes_no_host_read(monkeypatch, solver):
    f, y0, grid, delays, rates = _problem("logistic")
    y0, grid, delays = map(torch.as_tensor, (y0, grid[:16], delays))
    args = torch.as_tensor(rates)[:, None]
    for name in ("item", "tolist", "numpy", "__bool__", "__float__", "__int__", "__index__"):
        monkeypatch.setattr(torch.Tensor, name, _no_host_read)
    kw = dict(_kw(solver, grid), total_trips=160) if solver == "budget" else _kw(solver, grid)
    res = getattr(td, _SOLVE[solver])(f, y0, grid, delays, args=args, **kw)
    monkeypatch.undo()
    assert res.ok.all()
