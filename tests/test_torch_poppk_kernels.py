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
import pytest
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
    merged grid of 10 observations and 14 daily doses, one skipped. The
    stop tables are per patient, (P, S), and lane l is patient l % P."""
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
    n_transit = 10 ** rng.uniform(0.0, 1.0, L)
    params = {
        "ka": 10 ** rng.uniform(-1.0, 0.5, L),
        "ke": 10 ** rng.uniform(-4.0, -1.0, L),
        "kel": 10 ** rng.uniform(-2.0, -0.5, L),
        "k_transit": (n_transit + 1.0) / 10 ** rng.uniform(-1.0, 1.5, L),
        "n_transit": n_transit,
        "dose0": 100.0 + 50.0 * np.arange(P),
    }
    return params, np.stack(grid_p), np.stack(amt_p)


def _per_lane(params, grid, amt):
    """The same problem with its tables tiled to (L, S), as the Pallas
    kernel takes them: one patient per lane."""
    L, P = len(params["ka"]), len(grid)
    pat = np.arange(L) % P
    return dict(params, dose0=params["dose0"][pat]), grid[pat], amt[pat]


def _t(params, grid, amt, dtype=torch.float32):
    return (
        {k: torch.as_tensor(v, dtype=dtype) for k, v in params.items()},
        torch.as_tensor(grid, dtype=dtype), torch.as_tensor(amt, dtype=dtype),
    )


_B2_KW = dict(trips=768, rtol=1e-6, atol=100.0 * 1e-6, min_dt=1e-5, first_dt=1e-2)


def test_b2_plain_matches_jax_kernel():
    params, grid, amt = _b2_problem()
    lane_params, lane_grid, lane_amt = _per_lane(params, grid, amt)
    c_ref, ok_ref = jax_b2(
        {k: jnp.asarray(v) for k, v in lane_params.items()},
        jnp.asarray(lane_grid), jnp.asarray(lane_amt), **_B2_KW,
    )
    c_ref, ok_ref = np.asarray(c_ref), np.asarray(ok_ref)
    f32 = torch.float32
    c, ok = transit_solve(*_t(params, grid, amt), **_B2_KW)
    assert c.dtype == f32 and c.shape == lane_grid.shape and ok.dtype == torch.bool
    ok = ok.numpy()
    np.testing.assert_array_equal(ok, ok_ref)
    assert ok.sum() >= 6 and (~ok).sum() >= 1  # both outcomes are exercised
    c = c.numpy()
    assert np.isnan(c[~ok]).all()
    # _B2_KW's atol is 1e-6 * the smallest dose
    np.testing.assert_allclose(c[ok], c_ref[ok], rtol=3e-4, atol=3 * _B2_KW["atol"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_b2_plain_patient_tables_match_lane_tables(dtype):
    """(P, S) tables read by lane % P give bit for bit what the same call
    gives on the tables tiled to (L, S), one patient per lane."""
    problem = _b2_problem(L=24, seed=4)
    c, ok, n = transit_solve_plain(*_t(*problem, dtype), trip_counts=True, **_B2_KW)
    c_l, ok_l, n_l = transit_solve_plain(
        *_t(*_per_lane(*problem), dtype), trip_counts=True, **_B2_KW
    )
    assert ok.any() and (~ok).any()
    assert torch.equal(ok, ok_l) and torch.equal(n, n_l)
    assert torch.equal(c.isnan(), c_l.isnan())
    assert torch.equal(torch.nan_to_num(c), torch.nan_to_num(c_l))


def test_b2_plain_trip_counts():
    """Trip counts: at most the budget; at least S - 1 on lanes that finish
    (a trip reaches at most one stop). Lanes that fail for the budget (they
    finish under a larger one) are ended by the early exit within S - 2
    trips of the budget, and the larger budget shows they needed more."""
    params, grid, amt = _b2_problem(L=48, seed=6)
    S = grid.shape[1]
    kw = dict(_B2_KW, trips=450)
    c, ok, n = transit_solve_plain(*_t(params, grid, amt), trip_counts=True, **kw)
    c_big, ok_big, n_big = transit_solve_plain(
        *_t(params, grid, amt), trip_counts=True, **dict(kw, trips=1000)
    )
    assert n.dtype == torch.int32 and n.shape == ok.shape
    assert (n <= kw["trips"]).all() and (n[ok] >= S - 1).all()
    budget_failed = ok_big & ~ok
    assert budget_failed.sum() >= 3 and ok.sum() >= 3
    assert (n[budget_failed] >= kw["trips"] - (S - 2)).all()
    assert (n_big[budget_failed] > kw["trips"]).all()
    # the budget changes no step: lanes that finish under both agree
    assert torch.equal(n[ok], n_big[ok]) and torch.equal(c[ok], c_big[ok])


def test_b2_lanes_must_split_over_patients():
    params, grid, amt = _t(*_b2_problem(L=6))  # 6 lanes, 4 patients
    with pytest.raises(ValueError, match="split evenly"):
        transit_solve(params, grid, amt, **_B2_KW)


def test_b2_plain_dtype_follows_input():
    """The plain version computes in its input's dtype; float64 agrees with
    float32 to the solver's tolerance on the lanes both finish."""
    problem = _b2_problem(L=8, seed=2)
    out = {}
    for dt in (torch.float32, torch.float64):
        out[dt] = transit_solve_plain(*_t(*problem, dt), **_B2_KW)
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
