"""The port's host Hungarian matching against the JAX package's and against
scipy.

`bcm3_tpu_torch.cellpop.data_likelihood.batched_hungarian` (one copy to
the host, one native call for the batch) is held to the JAX package's
`hungarian_match_logp` row by row and to the plain version, scipy's
`linear_sum_assignment` row by row, on random costs with random masks and
the edge cases (no valid observation, too few simulations, non-finite
entries). Totals agree to rtol 1e-12 (one assignment problem solved in
float64 by two algorithms), -inf sets exactly. The port's native library
(`bcm3_tpu_torch/native.py`) is built on first use; a failed build raises
with the compiler's message.
"""

import shutil

import numpy as np
import pytest
import torch

from bcm3_tpu.cellpop.data_likelihood import hungarian_match_logp as jax_match
from bcm3_tpu_torch import native
from bcm3_tpu_torch.cellpop.data_likelihood import batched_hungarian, hungarian_match_logp


def _random_problems(B=48, n_obs=6, n_sim=9, seed=0):
    rng = np.random.default_rng(seed)
    cost = rng.normal(-20.0, 5.0, (B, n_obs, n_sim))
    ov = rng.random((B, n_obs)) < 0.8
    sv = rng.random((B, n_sim)) < 0.8
    # the edge cases: no valid observation; fewer valid simulations than
    # observations; non-finite entries a matching can avoid; an observed
    # cell that can only pair with impossible ones
    ov[0] = False
    ov[1], sv[1] = True, False
    sv[1, :3] = True
    cost[2, 0, :4] = -np.inf
    cost[2, 1, 5] = np.nan
    ov[2], sv[2] = True, True
    cost[3, 4, :] = -np.inf
    ov[3, 4] = True
    return cost, ov, sv


def test_batched_matches_jax_and_scipy():
    cost, ov, sv = _random_problems()
    got = batched_hungarian(torch.as_tensor(cost), torch.as_tensor(ov), torch.as_tensor(sv))
    assert got.dtype == torch.float64 and got.shape == (len(cost),)
    got = got.numpy()
    ref = np.array([jax_match(c, o, s) for c, o, s in zip(cost, ov, sv)])
    plain = native.lap_match_logp_batch_plain(cost, ov, sv)
    assert got[0] == 0.0 and np.isneginf(got[[1, 3]]).all() and np.isfinite(got[2])
    for other in (ref, plain):
        np.testing.assert_array_equal(np.isneginf(got), np.isneginf(other))
        fin = np.isfinite(other)
        np.testing.assert_allclose(got[fin], other[fin], rtol=1e-12)
    # the one-problem entry point is the JAX package's too
    single = np.array([hungarian_match_logp(c, o, s) for c, o, s in zip(cost, ov, sv)])
    np.testing.assert_array_equal(single, got)


def test_batched_keeps_the_costs_dtype_and_shared_masks():
    cost, _, _ = _random_problems(B=16, seed=1)
    c32 = torch.as_tensor(cost, dtype=torch.float32)
    ov, sv = np.ones(6, dtype=bool), np.ones(9, dtype=bool)
    got = batched_hungarian(c32, ov, sv)
    assert got.dtype == torch.float32
    ref = native.lap_match_logp_batch_plain(c32.double().numpy(), ov, sv)
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.float32))


@pytest.mark.parametrize("shape", [(7, 7), (4, 11), (1, 3)])
def test_lap_solve_matches_scipy(shape):
    cost = np.random.default_rng(2).normal(size=shape)
    assign, total = native.lap_solve(cost)
    plain_assign, plain_total = native.lap_solve_plain(cost)
    assert len(set(assign.tolist())) == shape[0]
    np.testing.assert_allclose(total, plain_total, rtol=1e-12)
    np.testing.assert_allclose(cost[np.arange(shape[0]), assign].sum(), total, rtol=1e-12)
    with pytest.raises(ValueError, match="n_rows <= n_cols"):
        native.lap_solve(cost.T if shape[0] < shape[1] else np.ones((3, 2)))


def test_failed_build_raises(monkeypatch, tmp_path):
    """A source that does not compile raises with the compiler's message;
    nothing falls back to scipy."""
    bad = tmp_path / "lap.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "LAP_SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lap_lib", None)
    with pytest.raises(RuntimeError, match="lap.cpp failed"):
        batched_hungarian(torch.zeros((2, 3, 3)), np.ones(3, bool), np.ones(3, bool))
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    shutil.rmtree(tmp_path / "build", ignore_errors=True)
    with pytest.raises(RuntimeError, match="not found"):
        native.lap_solve(np.zeros((2, 2)))
