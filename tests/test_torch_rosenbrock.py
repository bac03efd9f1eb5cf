"""The port's RODAS3 solvers (bcm3_tpu_torch/ode/rosenbrock.py) against the
JAX package's (bcm3_tpu/ode/rosenbrock.py) on identical inputs, float64.

Mirrors tests/test_rosenbrock.py (linear decay, Robertson against scipy,
several lanes, events and failure, a non-autonomous system) and the stiff
half of tests/test_budget_solvers.py (:88-129), each lane of the port
against the JAX package's vmapped solve of the same lane: `ok` equal, the
step counts equal, the states within 1e-10. The stage LU differs (LAPACK's
getrf here, the JAX package's unrolled `_small_lu` at n <= 16), and the
adaptive loop lands a clipped step on its stop with t + (t1 - t), which can
round one ulp short of t1 when t < t1 / 2 (then one more step of ~1e-17
and a step size that regrows from 1e-12): which lanes do so turns on the
last bit of t. A lane whose step count differs is printed and held to the
solver's tolerance instead; `_lanes` bounds how many may. The port's
Jacobian (`linearize`, and the SBML models' compiled tangents) is held to
`jax.jacfwd`; the budget and fixed-trip forms read nothing from the host.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.integrate import solve_ivp

from bcm3_tpu.ode import rosenbrock as jr
from bcm3_tpu_torch.ode import rosenbrock as R

F64 = torch.float64


def _lanes(name, ys, steps, ok, ref_ys, ref_steps, ref_ok, tol, max_flips=0, rtol=1e-10):
    """Each lane of the port against the JAX package's: equal ok; with
    equal step counts the states within rtol (relative to each state's
    largest magnitude over the lane, at least 1e-300), otherwise within
    tol, and at most max_flips such lanes (printed)."""
    ys, ref_ys = np.asarray(ys), np.asarray(ref_ys)
    steps, ref_steps = np.asarray(steps), np.asarray(ref_steps)
    np.testing.assert_array_equal(np.asarray(ok), np.asarray(ref_ok))
    np.testing.assert_array_equal(np.isnan(ys), np.isnan(ref_ys))
    scale = np.maximum(np.nanmax(np.abs(ref_ys), axis=1, keepdims=True), 1e-300)
    err = np.nanmax(np.where(np.isnan(ref_ys), 0.0, np.abs(ys - ref_ys) / scale), axis=(1, 2))
    flips = np.flatnonzero(steps != ref_steps)
    for lane in flips:
        print(f"{name}: lane {lane} took {steps[lane]} steps, the JAX package "
              f"{ref_steps[lane]}; max scaled difference {err[lane]:.3e} (limit {tol})")
    same = steps == ref_steps
    assert err[same].max(initial=0.0) <= rtol, (name, err[same].max())
    assert err[~same].max(initial=0.0) <= tol, (name, err[~same].max())
    assert len(flips) <= max_flips, (name, flips)


def _robertson_jax(t, y, args):
    r1 = 0.04 * y[0]
    r2 = 3e7 * y[1] * y[1]
    r3 = 1e4 * y[1] * y[2]
    return jnp.array([-r1 + r3, r1 - r2 - r3, r2], dtype=y.dtype)


def _robertson(t, y, args):
    r1 = 0.04 * y[:, 0]
    r2 = 3e7 * y[:, 1] * y[:, 1]
    r3 = 1e4 * y[:, 1] * y[:, 2]
    return torch.stack([-r1 + r3, r1 - r2 - r3, r2], dim=1)


def _robertson_jac(t, y, args):
    """(f, df/dt, df/dy) of _robertson."""
    J = torch.zeros(y.shape[0], 3, 3, dtype=y.dtype)
    J[:, 0, 0], J[:, 0, 1], J[:, 0, 2] = -0.04, 1e4 * y[:, 2], 1e4 * y[:, 1]
    J[:, 1, 0] = 0.04
    J[:, 1, 1] = -6e7 * y[:, 1] - 1e4 * y[:, 2]
    J[:, 1, 2] = -1e4 * y[:, 1]
    J[:, 2, 1] = 6e7 * y[:, 1]
    return _robertson(t, y, args), torch.zeros_like(y), J


def test_linear_decay_exact():
    ts = np.linspace(0.0, 5.0, 11)
    res = R.solve_at_times_stiff(lambda t, y, a: -a[:, None] * y, torch.ones(1, 1, dtype=F64),
                                 torch.as_tensor(ts), args=torch.full((1,), 2.0, dtype=F64),
                                 rtol=1e-8, atol=1e-12)
    ref = jax.jit(lambda: jr.solve_at_times_stiff(
        lambda t, y, a: -a * y, jnp.asarray([1.0]), jnp.asarray(ts), args=jnp.asarray(2.0),
        rtol=1e-8, atol=1e-12))()
    assert bool(res.ok[0])
    np.testing.assert_allclose(res.ys[0, :, 0].numpy(), np.exp(-2.0 * ts), rtol=1e-6)
    _lanes("decay", res.ys, res.n_steps, res.ok, np.asarray(ref.ys)[None],
           [int(ref.n_steps)], [bool(ref.ok)], 1e-6)


def test_robertson_stiff_vs_scipy_and_jax():
    """Robertson (stiffness ratio ~1e11): a few hundred steps, scipy's Radau
    within 2e-4, mass conserved, and the JAX package's solve; the
    derivatives from an analytic `jac` (the JVPs' path, ~7 ms a step at
    one lane here, is held by the other tests)."""
    ts = np.asarray([0.0, 1e-2, 1e0, 1e2, 1e4])
    y0 = np.asarray([1.0, 0.0, 0.0])
    res = R.solve_at_times_stiff(_robertson, torch.as_tensor(y0)[None], torch.as_tensor(ts),
                                 rtol=1e-7, atol=1e-12, jac=_robertson_jac)
    assert bool(res.ok[0]) and int(res.n_steps[0]) < 5000
    sol = solve_ivp(lambda t, y: _robertson(t, torch.as_tensor(y)[None], None)[0].numpy(),
                    (0, 1e4), y0, method="Radau", t_eval=ts[1:], rtol=1e-10, atol=1e-14)
    got = res.ys[0, 1:].numpy()
    np.testing.assert_allclose(got, sol.y.T, rtol=2e-4, atol=1e-10)
    np.testing.assert_allclose(got.sum(axis=1), 1.0, rtol=1e-6)
    ref = jax.jit(lambda: jr.solve_at_times_stiff(_robertson_jax, jnp.asarray(y0),
                                                  jnp.asarray(ts), rtol=1e-7, atol=1e-12))()
    _lanes("robertson", res.ys, res.n_steps, res.ok, np.asarray(ref.ys)[None],
           [int(ref.n_steps)], [bool(ref.ok)], 1e-5, max_flips=1)


def test_lanes_match_vmapped_jax():
    """y' = -k y^2 at four k in one solve: y = 1 / (1 + k t), and each
    lane against the JAX package's vmapped solve."""
    ts = np.linspace(0.0, 2.0, 5)
    ks = np.asarray([0.5, 5.0, 50.0, 500.0])
    res = R.solve_at_times_stiff(lambda t, y, k: -k[:, None] * y * y, torch.ones(4, 1, dtype=F64),
                                 torch.as_tensor(ts), args=torch.as_tensor(ks), rtol=1e-8,
                                 atol=1e-10)
    for i, k in enumerate(ks):
        np.testing.assert_allclose(res.ys[i, :, 0].numpy(), 1.0 / (1.0 + k * ts), rtol=1e-5)
    ref = jax.jit(jax.vmap(lambda k: jr.solve_at_times_stiff(
        lambda t, y, a: jnp.array([-a * y[0] * y[0]], dtype=y.dtype), jnp.asarray([1.0]),
        jnp.asarray(ts), args=k, rtol=1e-8, atol=1e-10)))(jnp.asarray(ks))
    _lanes("k y^2", res.ys, res.n_steps, res.ok, ref.ys, ref.n_steps, ref.ok, 1e-6,
           max_flips=1)


def test_events_and_failure():
    """A bolus at each stop (exact); a step budget overrun is NaN and not
    ok, with no exception (ODESolverCVODE.cpp:354-370); both as the JAX
    package's."""
    ts = np.asarray([0.0, 1.0, 2.0])
    res = R.solve_at_times_stiff(lambda t, y, a: -y, torch.zeros(1, 1, dtype=F64), torch.as_tensor(ts),
                                 event_fn=lambda i, t, y, a: y + 1.0, rtol=1e-10, atol=1e-12)
    e = np.exp(-1.0)
    assert bool(res.ok[0])
    np.testing.assert_allclose(res.ys[0, 1, 0].item(), e, rtol=1e-7)
    np.testing.assert_allclose(res.ys[0, 2, 0].item(), (e + 1) * e, rtol=1e-7)
    ref = jax.jit(lambda: jr.solve_at_times_stiff(
        lambda t, y, a: -y, jnp.asarray([0.0]), jnp.asarray(ts),
        event_fn=lambda i, t, y, a: y + 1.0, rtol=1e-10, atol=1e-12))()
    _lanes("events", res.ys, res.n_steps, res.ok, np.asarray(ref.ys)[None],
           [int(ref.n_steps)], [bool(ref.ok)], 1e-8)

    kw = dict(rtol=1e-10, atol=1e-14, max_steps_per_segment=5)
    res2 = R.solve_at_times_stiff(_robertson, torch.tensor([[1.0, 0.0, 0.0]], dtype=F64),
                                  torch.tensor([0.0, 1e4], dtype=F64), **kw)
    ref2 = jax.jit(lambda: jr.solve_at_times_stiff(
        _robertson_jax, jnp.asarray([1.0, 0.0, 0.0]), jnp.asarray([0.0, 1e4]), **kw))()
    assert not bool(res2.ok[0]) and np.isnan(res2.ys[0, 1].numpy()).all()
    _lanes("overrun", res2.ys, res2.n_steps, res2.ok, np.asarray(ref2.ys)[None],
           [int(ref2.n_steps)], [bool(ref2.ok)], 0.0)


def test_nonautonomous():
    """y' = cos(t): the time-derivative term."""
    ts = np.linspace(0.0, 3.0, 7)
    res = R.solve_at_times_stiff(lambda t, y, a: torch.cos(t)[:, None], torch.zeros(1, 1, dtype=F64),
                                 torch.as_tensor(ts), rtol=1e-8, atol=1e-10)
    assert bool(res.ok[0])
    np.testing.assert_allclose(res.ys[0, :, 0].numpy(), np.sin(ts), atol=1e-6)
    ref = jax.jit(lambda: jr.solve_at_times_stiff(
        lambda t, y, a: jnp.array([jnp.cos(t)], dtype=y.dtype), jnp.asarray([0.0]),
        jnp.asarray(ts), rtol=1e-8, atol=1e-10))()
    _lanes("cos", res.ys, res.n_steps, res.ok, np.asarray(ref.ys)[None],
           [int(ref.n_steps)], [bool(ref.ok)], 1e-7, max_flips=1)


def _stiff(t, y, scale):
    return torch.stack([-scale * y[:, 0] + y[:, 1], -0.5 * y[:, 1]], dim=1)


def _stiff_jax(t, y, scale):
    return jnp.stack([-scale * y[0] + y[1], -0.5 * y[1]])


SCALES = np.asarray([100.0, 1000.0, 5000.0])


def _stiff_jac(t, y, scale):
    """(f, df/dt, df/dy) of _stiff, the `jac` a right-hand side may pass."""
    J = torch.zeros(y.shape[0], 2, 2, dtype=y.dtype)
    J[:, 0, 0], J[:, 0, 1], J[:, 1, 1] = -scale, 1.0, -0.5
    return _stiff(t, y, scale), torch.zeros_like(y), J


class _NoHostRead:
    """Any read of a tensor's value on the host raises (what a CUDA sync
    would be on the card)."""

    def __enter__(self):
        self.saved = torch.Tensor.__bool__, torch.Tensor.item

        def refuse(*a):
            raise AssertionError("a host read")

        torch.Tensor.__bool__ = torch.Tensor.item = refuse

    def __exit__(self, *exc):
        torch.Tensor.__bool__, torch.Tensor.item = self.saved


@pytest.mark.parametrize("form", ["budget", "fixed_trips"])
def test_static_forms_match_jax_without_host_reads(form):
    """The budget form (512 trips over the whole trajectory) and the
    fixed-trip form (320 a segment; the first segment takes ~300) of the stiff 2-species system at three
    scales, against the JAX package's vmapped forms, and against the
    adaptive solve (tests/test_budget_solvers.py:88-129); the derivatives
    from the right-hand side's own `jac`."""
    ts = np.linspace(0.0, 2.0, 9)
    y0 = torch.ones(3, 2, dtype=torch.float64)
    kw = dict(rtol=1e-6, atol=1e-9)
    with _NoHostRead():
        if form == "budget":
            res = R.solve_at_times_stiff_budget(_stiff, y0, torch.as_tensor(ts),
                                                args=torch.as_tensor(SCALES), total_trips=512,
                                                jac=_stiff_jac, **kw)
        else:
            res = R.solve_at_times_stiff(_stiff, y0, torch.as_tensor(ts),
                                         args=torch.as_tensor(SCALES), fixed_trips=320,
                                         jac=_stiff_jac, **kw)
    fn = (lambda s: jr.solve_at_times_stiff_budget(_stiff_jax, jnp.ones(2), jnp.asarray(ts),
                                                    args=s, total_trips=512, **kw)) \
        if form == "budget" else \
        (lambda s: jr.solve_at_times_stiff(_stiff_jax, jnp.ones(2), jnp.asarray(ts), args=s,
                                           fixed_trips=320, **kw))
    ref = jax.jit(jax.vmap(fn))(jnp.asarray(SCALES))
    assert res.ok.all() or form == "fixed_trips"  # 320 trips fail scale 5000's first segment
    _lanes(form, res.ys, res.n_steps, res.ok, ref.ys, ref.n_steps, ref.ok, 1e-5, max_flips=1)
    adaptive = R.solve_at_times_stiff(_stiff, y0, torch.as_tensor(ts),
                                      args=torch.as_tensor(SCALES), **kw)
    ok = res.ok.numpy()
    np.testing.assert_allclose(res.ys.numpy()[ok], adaptive.ys.numpy()[ok], rtol=1e-4, atol=1e-8)


def test_budget_exhausted_fails_soft():
    """Too few trips: NaN and not ok on every lane, as the JAX package's."""
    ts = np.linspace(0.0, 2.0, 9)
    res = R.solve_at_times_stiff_budget(_stiff, torch.ones(3, 2, dtype=torch.float64),
                                        torch.as_tensor(ts), args=torch.as_tensor(SCALES),
                                        total_trips=6)
    ref = jax.jit(jax.vmap(lambda s: jr.solve_at_times_stiff_budget(
        _stiff_jax, jnp.ones(2), jnp.asarray(ts), args=s, total_trips=6)))(jnp.asarray(SCALES))
    assert not res.ok.any() and not np.asarray(ref.ok).any()
    assert torch.isnan(res.ys).all()


def test_jacobian_matches_jacfwd():
    """`linearize`'s f, df/dt and df/dy against jax.jacfwd, lane by lane."""
    rng = np.random.default_rng(0)
    y = rng.uniform(0.1, 1.0, size=(5, 3))
    t = rng.uniform(0.0, 2.0, size=5)

    def f(t, y, a):
        return torch.stack([torch.sin(t) * y[:, 0] * y[:, 1], torch.exp(-y[:, 2]) + t * t,
                            y[:, 0] / (1.0 + y[:, 1] ** 2)], dim=1)

    def fj(t, y):
        return jnp.stack([jnp.sin(t) * y[0] * y[1], jnp.exp(-y[2]) + t * t,
                          y[0] / (1.0 + y[1] ** 2)])

    f0, ft, J = R.jacobian(f, torch.as_tensor(t), torch.as_tensor(y), None)
    for lane in range(5):
        np.testing.assert_allclose(f0[lane].numpy(), fj(t[lane], y[lane]), rtol=1e-14)
        np.testing.assert_allclose(ft[lane].numpy(), jax.jacfwd(fj, 0)(t[lane], y[lane]),
                                   rtol=1e-13)
        np.testing.assert_allclose(J[lane].numpy(), jax.jacfwd(fj, 1)(t[lane], y[lane]),
                                   rtol=1e-13)
