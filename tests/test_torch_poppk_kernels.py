"""Kernels B1 and B2 of the port against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version, which is held to
the JAX kernel run in interpret mode (as the JAX package's own tests run
it off-TPU). The CUDA kernels themselves are compared with the plain
versions in tests/test_torch_gpu.py, which skips where there is no card.

Tolerances:
- B1, float64: rtol 1e-12 (same closed form, rounding only).
- B2, float32 on both sides (the Pallas kernel always casts to float32,
  transit_pallas.py:248): the `ok` sets must be identical, and central
  must agree to rtol 3e-4, atol 3e-6 * dose. rtol 1e-4 with atol 1e-6 *
  dose does not hold: with the solver's rtol of 1e-6, close to float32's
  epsilon, XLA's and torch's float32 exp/log round differently and move
  the adaptive step sequence, and a few lanes then differ by up to twice
  that bound. That is the float32 solve's own accuracy: each side differs
  from a float64 solve of the same problem by as much.
"""

import jax.numpy as jnp
import numpy as np
import torch

from bcm3_tpu.ops.poppk_pallas import (
    propagate_intervals_one_compartment as jax_b1,
    propagate_intervals_reference as jax_b1_reference,
)
from bcm3_tpu.ops.transit_pallas import transit_solve_pallas as jax_b2
from bcm3_tpu_torch.ops.poppk_kernels import propagate_intervals_one_compartment
from bcm3_tpu_torch.ops.transit_kernels import transit_solve, transit_solve_plain


def _b1_problem(B, P, K, seed=0):
    rng = np.random.default_rng(seed)
    ka = rng.uniform(0.5, 2.0, (B, P))
    ke = rng.uniform(0.01, 0.1, (B, P))
    kel = rng.uniform(0.1, 0.5, (B, P))
    # one degenerate lane: ka + ke == kel exactly
    kel[0, 1] = ka[0, 1] + ke[0, 1]
    init = rng.uniform(100, 200, P)
    interval = rng.uniform(12, 24, P)
    dose = rng.uniform(50, 150, (P, K))
    dose[:, 3] = 0.0  # a skipped dose
    return ka, ke, kel, init, interval, dose


def _torch(args):
    return [torch.as_tensor(a) for a in args]


def test_b1_plain_matches_jax_kernel():
    args = _b1_problem(B=8, P=16, K=9)
    g_ref, c_ref = jax_b1(*(jnp.asarray(a) for a in args))
    g, c = propagate_intervals_one_compartment(*_torch(args))
    assert g.shape == (9, 8, 16) and g.dtype == torch.float64
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), rtol=1e-12)
    np.testing.assert_allclose(c.numpy(), np.asarray(c_ref), rtol=1e-12, atol=1e-12)


def test_b1_plain_any_patient_count():
    """P = 10 does not divide 128, which the Pallas kernel refuses; the
    port takes any B and P. Held to the JAX scan oracle."""
    args = _b1_problem(B=3, P=10, K=9, seed=1)
    g_ref, c_ref = jax_b1_reference(*(jnp.asarray(a) for a in args))
    g, c = propagate_intervals_one_compartment(*_torch(args))
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), rtol=1e-12)
    np.testing.assert_allclose(c.numpy(), np.asarray(c_ref), rtol=1e-12, atol=1e-12)


def _b2_problem(L=24, seed=0):
    """Lanes drawn like the one_transit likelihood's: 4 patients with a
    merged grid of 10 observations and 14 daily doses, one skipped."""
    rng = np.random.default_rng(seed)
    P = 4
    obs = np.array([0.5, 1.0, 2.0, 4.0, 8.0, 12.0, 24.0, 96.0, 200.0, 300.0])
    doses = 24.0 * np.arange(1, 15)
    grid_p, amt_p = [], []
    for j in range(P):
        times = np.concatenate([obs, doses])
        amts = np.concatenate([np.zeros(len(obs)), np.full(len(doses), 100.0 + 50 * j)])
        if j == 1:
            amts[len(obs) + 4] = 0.0  # a skipped dose
        order = np.argsort(times, kind="stable")
        grid_p.append(times[order])
        amt_p.append(amts[order])
    pat = np.arange(L) % P
    n_transit = 10 ** rng.uniform(0.0, 1.0, L)
    params = {
        "ka": 10 ** rng.uniform(-1.0, 0.5, L),
        "ke": 10 ** rng.uniform(-4.0, -1.0, L),
        "kel": 10 ** rng.uniform(-2.0, -0.5, L),
        "k_transit": (n_transit + 1.0) / 10 ** rng.uniform(-1.0, 1.5, L),
        "n_transit": n_transit,
        "dose0": (100.0 + 50 * pat).astype(float),
    }
    grid = np.stack(grid_p)[pat]
    amt = np.stack(amt_p)[pat]
    return params, grid, amt


_B2_KW = dict(trips=768, rtol=1e-6, atol=100.0 * 1e-6, min_dt=1e-5, first_dt=1e-2)


def test_b2_plain_matches_jax_kernel():
    params, grid, amt = _b2_problem()
    c_ref, ok_ref = jax_b2(
        {k: jnp.asarray(v) for k, v in params.items()},
        jnp.asarray(grid), jnp.asarray(amt), **_B2_KW,
    )
    c_ref, ok_ref = np.asarray(c_ref), np.asarray(ok_ref)
    f32 = torch.float32
    c, ok = transit_solve(
        {k: torch.as_tensor(v, dtype=f32) for k, v in params.items()},
        torch.as_tensor(grid, dtype=f32), torch.as_tensor(amt, dtype=f32), **_B2_KW,
    )
    assert c.dtype == f32 and c.shape == grid.shape and ok.dtype == torch.bool
    ok = ok.numpy()
    np.testing.assert_array_equal(ok, ok_ref)
    assert ok.sum() >= 6 and (~ok).sum() >= 1  # both outcomes are exercised
    c = c.numpy()
    assert np.isnan(c[~ok]).all()
    # _B2_KW's atol is 1e-6 * the smallest dose
    np.testing.assert_allclose(c[ok], c_ref[ok], rtol=3e-4, atol=3 * _B2_KW["atol"])


def test_b2_plain_dtype_follows_input():
    """The plain version computes in its input's dtype; float64 agrees with
    float32 to the solver's tolerance on the lanes both finish."""
    params, grid, amt = _b2_problem(L=8, seed=2)
    out = {}
    for dt in (torch.float32, torch.float64):
        out[dt] = transit_solve_plain(
            {k: torch.as_tensor(v, dtype=dt) for k, v in params.items()},
            torch.as_tensor(grid, dtype=dt), torch.as_tensor(amt, dtype=dt), **_B2_KW,
        )
    assert out[torch.float64][0].dtype == torch.float64
    both = (out[torch.float32][1] & out[torch.float64][1]).numpy()
    assert both.any()
    np.testing.assert_allclose(
        out[torch.float32][0].numpy()[both], out[torch.float64][0].numpy()[both],
        rtol=1e-3, atol=1e-3,
    )


def test_propagate_one_compartment_matches_jax():
    """The closed-form one-compartment step (ode/linear_pk.py), including
    the a == kel limit, in float64."""
    from bcm3_tpu.ode import linear_pk as jlp
    from bcm3_tpu_torch.ode import linear_pk as tlp

    rng = np.random.default_rng(8)
    y = rng.uniform(0.0, 200.0, (40, 2))
    dt = rng.uniform(0.0, 30.0, 40)
    ka, ke, kel = rng.uniform(0.05, 3.0, 40), rng.uniform(1e-4, 0.1, 40), rng.uniform(0.01, 0.5, 40)
    kel[:3] = ka[:3] + ke[:3]  # degenerate lanes
    args = (y, dt, ka, ke, kel)
    got = tlp.propagate_one_compartment(*(torch.as_tensor(a) for a in args)).numpy()
    ref = np.asarray(jlp.propagate_one_compartment(*(jnp.asarray(a) for a in args)))
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-300)
