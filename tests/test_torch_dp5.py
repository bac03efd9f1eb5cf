"""The port's batched DP5 solvers against the JAX package's, lane by lane.

A 3-state test system with a forcing term and dose events at flagged
stops, on per-lane stop grids with repeated times, over rates from slow
to stiff: the port's `solve_at_times_budget` and `solve_at_times` (lanes
first) against the JAX package's solvers vmapped over lanes, float64 on
the CPU, states to rtol 1e-8 (atol 1e-12, for states that decay to
nearly 0) and equal `ok` flags. The budget is tight
enough that some lanes fail in both, by the budget and by `min_dt`. The
budget solver also agrees with the segment-wise oracle where both
succeed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bcm3_tpu.ode import dp5 as jdp5
from bcm3_tpu_torch.ode import dp5

L, S = 48, 12


def _problem(seed):
    rng = np.random.default_rng(seed)
    k = 10 ** rng.uniform(-2.0, 2.0, L)
    w = rng.uniform(0.1, 2.0, L)
    times = np.sort(rng.uniform(0.0, 48.0, (L, S)), axis=1)
    times[:, 0] = 0.0
    times[::3, 5] = times[::3, 4]  # zero-length segments
    is_dose = rng.uniform(size=(L, S)) < 0.4
    amount = np.where(is_dose, rng.uniform(1.0, 10.0, (L, S)), 0.0)
    y0 = np.stack([rng.uniform(0, 5, L), np.zeros(L), rng.uniform(0, 1, L)], -1)
    return y0, times, amount, k, w


def _port_f(t, y, args):
    k, w = args
    d0 = -k * y[:, 0]
    d1 = k * y[:, 0] - 0.3 * y[:, 1] + 0.1 * torch.sin(w * t)
    return torch.stack([d0, d1, torch.zeros_like(d0)], dim=-1)


def _jax_f(t, y, args):
    k, w = args
    d0 = -k * y[0]
    d1 = k * y[0] - 0.3 * y[1] + 0.1 * jnp.sin(w * t)
    return jnp.stack([d0, d1, jnp.zeros_like(d0)])


def _port_event(amount):
    amount = torch.as_tensor(amount)

    def event(i, t, y, args):
        add = amount.gather(1, i[:, None])[:, 0]
        return torch.stack([y[:, 0] + add, y[:, 1], y[:, 2] + (add > 0)], dim=-1)

    return event


def _jax_event(i, t, y, args):
    amt_row = args[2]
    add = jnp.sum(jnp.where(jnp.arange(S) == i, amt_row, 0.0))
    return y.at[0].add(add).at[2].add((add > 0).astype(y.dtype))


_KW = dict(rtol=1e-6, atol=1e-6, min_dt=1e-4)


def _args_t(k, w):
    return (torch.as_tensor(k), torch.as_tensor(w))


def _check(port, ref_ys, ref_ok):
    np.testing.assert_array_equal(port.ok.numpy(), np.asarray(ref_ok))
    ys = port.ys.numpy()
    ref_ys = np.asarray(ref_ys)
    np.testing.assert_array_equal(np.isnan(ys), np.isnan(ref_ys))
    fin = ~np.isnan(ref_ys)
    # atol: a gut state decayed to ~1e-7 carries the sums' rounding of the
    # states around it (~1e-14), a million times below the solver's atol
    np.testing.assert_allclose(ys[fin], ref_ys[fin], rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("trips", [60, 400])
def test_budget_solver_matches_jax(trips):
    y0, times, amount, k, w = _problem(0)
    port = dp5.solve_at_times_budget(
        _port_f, torch.as_tensor(y0), torch.as_tensor(times), args=_args_t(k, w),
        event_fn=_port_event(amount), total_trips=trips, **_KW,
    )

    def one(y0, ts, amt, k, w):
        r = jdp5.solve_at_times_budget(
            lambda t, y, a: _jax_f(t, y, a[:2]), y0, ts, args=(k, w, amt),
            event_fn=_jax_event, total_trips=trips, **_KW,
        )
        return r.ys, r.ok

    ys, ok = jax.vmap(one)(*(jnp.asarray(a) for a in (y0, times, amount, k, w)))
    _check(port, ys, ok)
    ok = np.asarray(ok)
    assert ok.any()
    if trips == 60:
        assert not ok.all()  # the budget fails some lanes in both


@pytest.mark.parametrize("total", [None, 150])
def test_segment_solver_matches_jax(total):
    y0, times, amount, k, w = _problem(1)
    port = dp5.solve_at_times(
        _port_f, torch.as_tensor(y0), torch.as_tensor(times), args=_args_t(k, w),
        event_fn=_port_event(amount), max_steps_per_segment=60, max_steps_total=total,
        **_KW,
    )

    def one(y0, ts, amt, k, w):
        r = jdp5.solve_at_times(
            lambda t, y, a: _jax_f(t, y, a[:2]), y0, ts, args=(k, w, amt),
            event_fn=_jax_event, max_steps_per_segment=60, max_steps_total=total, **_KW,
        )
        return r.ys, r.ok, r.n_steps

    ys, ok, steps = jax.vmap(one)(*(jnp.asarray(a) for a in (y0, times, amount, k, w)))
    _check(port, ys, ok)
    np.testing.assert_array_equal(port.n_steps.numpy(), np.asarray(steps))
    assert np.asarray(ok).any() and not np.asarray(ok).all()


def test_budget_solver_agrees_with_the_segment_oracle():
    """Where both succeed, the two step sequences land within the
    tolerance's reach of each other."""
    y0, times, amount, k, w = _problem(2)
    args = dict(args=_args_t(k, w), event_fn=_port_event(amount), **_KW)
    budget = dp5.solve_at_times_budget(_port_f, torch.as_tensor(y0), torch.as_tensor(times),
                                       total_trips=2000, **args)
    oracle = dp5.solve_at_times(_port_f, torch.as_tensor(y0), torch.as_tensor(times), **args)
    both = (budget.ok & oracle.ok).numpy()
    assert both.sum() >= L // 2
    np.testing.assert_allclose(budget.ys.numpy()[both], oracle.ys.numpy()[both],
                               rtol=1e-4, atol=1e-4)
