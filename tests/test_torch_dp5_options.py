"""dp5's `fixed_trips` and `record` options against the JAX package's.

A damped oscillator with a dose at one stop, over lanes of different
frequencies and damping, float64 on the CPU:

- `solve_at_times(..., fixed_trips=n)` against the JAX package's
  `solve_at_times(..., fixed_trips=n)` vmapped over lanes: with trips that
  cover every segment, `ok` and `n_steps` agree exactly and the states
  within RTOL of the lane's largest state (the oscillator crosses 0), and
  the fixed form equals the port's while form bit for bit; with too few trips
  for some lanes, the same lanes fail in both (NaN rows) and the port's
  fixed form equals its while form under a per-segment budget of n;
- `solve_at_times_budget(..., record=...)` against the JAX package's with
  the same projection, within RTOL of the lane's largest recorded value.

RTOL is 1e-10, not 1e-12: XLA's and ATen's float64 pow differ in the last
bit on ~1.3% of inputs, so the step-size factor (err_norm ** -0.2) moves a
step by an ulp now and then, and over ~100 steps of a lightly damped lane
the states drift apart by up to ~4e-11 of their scale (the step counts
stay equal). Port against port is held bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bcm3_tpu.ode import dp5 as jdp5
from bcm3_tpu_torch.ode import dp5

L = 24
TIMES = np.array([0.0, 0.7, 1.5, 1.5, 3.0, 4.2, 6.0, 9.0])
DOSE_STOP, DOSE = 2, 2.5
_KW = dict(rtol=1e-6, atol=1e-6)
RTOL = 1e-10
# enough for every lane of the budget form (the while form takes at most ~260 steps)
BUDGET_TRIPS = 300


def _lanes():
    rng = np.random.default_rng(11)
    w = 10 ** rng.uniform(-0.5, 0.8, L)  # slow to fast
    c = rng.uniform(0.05, 1.5, L)
    y0 = np.stack([rng.uniform(-1.0, 1.0, L), rng.uniform(-1.0, 1.0, L)], -1)
    return y0, w, c


def _port_f(t, y, args):
    w, c = args
    return torch.stack([y[:, 1], -w * w * y[:, 0] - c * y[:, 1]], dim=-1)


def _port_event(i, t, y, args):
    return torch.stack([y[:, 0], y[:, 1] + torch.where(i == DOSE_STOP, DOSE, 0.0)], dim=-1)


def _jax_f(t, y, args):
    w, c = args
    return jnp.stack([y[1], -w * w * y[0] - c * y[1]])


def _jax_event(i, t, y, args):
    return y.at[1].add(jnp.where(i == DOSE_STOP, DOSE, 0.0))


def _port(y0, w, c, **kw):
    return dp5.solve_at_times(
        _port_f, torch.as_tensor(y0), torch.as_tensor(TIMES),
        args=(torch.as_tensor(w), torch.as_tensor(c)), event_fn=_port_event, **_KW, **kw,
    )


def _jax(y0, w, c, **kw):
    def one(y0, w, c):
        r = jdp5.solve_at_times(_jax_f, y0, jnp.asarray(TIMES), args=(w, c),
                                event_fn=_jax_event, **_KW, **kw)
        return r.ys, r.ok, r.n_steps

    return [np.asarray(a) for a in jax.vmap(one)(*(jnp.asarray(a) for a in (y0, w, c)))]


def _same(a, b):
    """Two port results bit for bit, NaN rows included."""
    assert torch.equal(a.ok, b.ok) and torch.equal(a.n_steps, b.n_steps)
    assert torch.equal(a.ys.isnan(), b.ys.isnan())
    assert torch.equal(a.ys.nan_to_num(), b.ys.nan_to_num())


def _close(got, ref):
    """Equal NaN rows, and every finite state within RTOL of its lane's
    largest finite state."""
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    scale = np.nanmax(np.abs(ref), axis=(1, 2), keepdims=True)
    fin = ~np.isnan(ref)
    assert (np.abs(got - ref)[fin] <= RTOL * np.broadcast_to(scale, ref.shape)[fin]).all()


def _segment_steps(y0, w, c):
    """(S - 1, L): the while form's steps in each segment."""
    totals = [torch.zeros(L, dtype=torch.int32)]
    for i in range(2, len(TIMES) + 1):
        totals.append(dp5.solve_at_times(
            _port_f, torch.as_tensor(y0), torch.as_tensor(TIMES[:i]),
            args=(torch.as_tensor(w), torch.as_tensor(c)), event_fn=_port_event, **_KW).n_steps)
    return torch.diff(torch.stack(totals), dim=0)


@pytest.mark.parametrize("covering", [True, False])
def test_fixed_trips_matches_jax_and_the_while_form(covering):
    y0, w, c = _lanes()
    # the most steps a lane takes in a segment: the fewest trips that cover
    worst = int(_segment_steps(y0, w, c).max())
    trips = worst if covering else max(2, worst // 3)
    port = _port(y0, w, c, fixed_trips=trips)
    ys, ok, n_steps = _jax(y0, w, c, fixed_trips=trips)

    np.testing.assert_array_equal(port.ok.numpy(), ok)
    _close(port.ys.numpy(), ys)
    if covering:
        assert ok.all()
        np.testing.assert_array_equal(port.n_steps.numpy(), n_steps)
        _same(port, _port(y0, w, c))
    else:
        assert ok.any() and not ok.all()
        assert np.isnan(ys[~ok][:, -1]).all()
        _same(port, _port(y0, w, c, max_steps_per_segment=trips))


def test_budget_record_matches_jax():
    y0, w, c = _lanes()

    def record_port(y):
        return y[:, 1:2]

    port = dp5.solve_at_times_budget(
        _port_f, torch.as_tensor(y0), torch.as_tensor(TIMES),
        args=(torch.as_tensor(w), torch.as_tensor(c)), event_fn=_port_event,
        total_trips=BUDGET_TRIPS, record=record_port, **_KW,
    )
    whole = dp5.solve_at_times_budget(
        _port_f, torch.as_tensor(y0), torch.as_tensor(TIMES),
        args=(torch.as_tensor(w), torch.as_tensor(c)), event_fn=_port_event,
        total_trips=BUDGET_TRIPS, **_KW,
    )

    def one(y0, w, c):
        r = jdp5.solve_at_times_budget(_jax_f, y0, jnp.asarray(TIMES), args=(w, c),
                                       event_fn=_jax_event, total_trips=BUDGET_TRIPS,
                                       record=lambda y: y[1:2], **_KW)
        return r.ys, r.ok

    ys, ok = (np.asarray(a) for a in jax.vmap(one)(*(jnp.asarray(a) for a in (y0, w, c))))
    assert port.ys.shape == (L, len(TIMES), 1) and ok.all()
    np.testing.assert_array_equal(port.ok.numpy(), ok)
    _close(port.ys.numpy(), ys)
    assert torch.equal(port.ys, whole.ys[:, :, 1:2])
