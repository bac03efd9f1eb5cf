"""The port's block-proposal functions against the JAX package.

Both packages build a proposal from the same GMM parameters (shared
(L, K, ...) mixture layout with padding). The random numbers are made
from the JAX keys in the JAX package's own split structure and handed to
the port, so each function is compared step for step, float64, rtol 1e-12.
The JAX per-chain functions are vmapped over chain slices of the same
proposal, as SamplerPT._prop_apply gives them. Clustered proposals are
compared the same way, with the lanes' clusters given to both.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bcm3_tpu.sampler import proposal as jprop
from bcm3_tpu.stats.gmm import GMM as JGMM
from bcm3_tpu_torch.sampler import proposal as tprop
from bcm3_tpu_torch.stats.gmm import GMM

E, L, d = 4, 3, 3
C = E * L
RTOL = 1e-12
F64 = jnp.float64


def _gmm_params(seed=0, ks=(1, 2, 2)):
    """Per ladder position: 1, 2 and 2 components (so one is padded)."""
    rng = np.random.default_rng(seed)
    out = []
    for k in ks:
        means = rng.normal(0.0, 1.0, (k, d))
        a = rng.normal(0.0, 0.5, (k, d, d))
        covs = a @ np.swapaxes(a, 1, 2) + 0.3 * np.eye(d)
        w = rng.uniform(0.5, 1.0, k)
        out.append((means, covs, w / w.sum()))
    return out


def _build(proposal_type="gaussian_mixture", seed=0):
    # a clustered proposal has one component per cluster at every position
    params = _gmm_params(seed, (3, 3, 3) if proposal_type == "clustered_covariance" else (1, 2, 2))
    jp = jprop.build_block_proposal(
        [JGMM.from_params(*p) for p in params], C, d, F64, proposal_type=proposal_type
    )
    tp = tprop.build_block_proposal(
        [GMM.from_params(*p) for p in params], C, d, torch.float64, "cpu",
        proposal_type=proposal_type,
    )
    # per-chain adaptive state away from its initial values, identical in both
    rng = np.random.default_rng(seed + 1)
    K = tp.max_components
    scales = rng.uniform(0.2, 2.0, (C, K))
    ema = rng.choice([0.1, 0.234, 0.5], (C, K))
    selected = rng.integers(-1, K, C)
    jp = dataclasses.replace(
        jp, scales=jnp.asarray(scales), acc_ema=jnp.asarray(ema),
        selected=jnp.asarray(selected, jnp.int32),
    )
    tp = dataclasses.replace(
        tp, scales=torch.as_tensor(scales), acc_ema=torch.as_tensor(ema),
        selected=torch.as_tensor(selected),
    )
    return jp, tp


def _per_chain(jp):
    """The JAX proposal with its shared mixture fields tiled per chain
    (chain c at ladder position c % L)."""
    tile = {
        f: jnp.tile(getattr(jp, f), (E,) + (1,) * (getattr(jp, f).ndim - 1))
        for f in ("means", "chols", "inv_chols", "log_weights", "log_c")
    }
    return dataclasses.replace(jp, **tile)


def _keys(seed):
    return jax.random.split(jax.random.PRNGKey(seed), C)


def _np(t):
    return t.detach().numpy()


def test_proposal_tables_match():
    jp, tp = _build()
    for f in ("means", "chols", "inv_chols", "log_weights", "log_c"):
        np.testing.assert_allclose(_np(getattr(tp, f)), np.asarray(getattr(jp, f)), rtol=RTOL)
    assert tp.target_accept == jp.target_accept == 0.3  # d = 3


def test_reflect_on_bounds_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.normal(0.0, 4.0, (64, 5))
    x[:4, 0] = [-0.5, -3.7, -10.2, 1.0]  # below and at the lower bound
    lower = np.array([0.0, -1.0, 0.0, -np.inf, -np.inf])
    upper = np.array([1.0, 2.0, np.inf, 3.0, np.inf])
    got = tprop.reflect_on_bounds(*(torch.as_tensor(a) for a in (x, lower, upper)))
    ref = jprop.reflect_on_bounds(*(jnp.asarray(a) for a in (x, lower, upper)))
    np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=RTOL, atol=1e-15)
    g = _np(got)
    assert ((g[:, 0] >= 0.0) & (g[:, 0] <= 1.0)).all()
    assert (g[:, 2] >= 0.0).all() and (g[:, 3] <= 3.0).all()
    np.testing.assert_array_equal(g[:, 4], x[:, 4])


def _jax_propose_draws(keys, K):
    """Gumbel noise and normals exactly as propose_ensemble's per-lane
    draw() makes them: kk, kz, kg = split(key, 3)."""

    def one(key):
        kk, kz, _ = jax.random.split(key, 3)
        return jax.random.gumbel(kk, (K,), F64), jax.random.normal(kz, (d,), F64)

    g, z = jax.vmap(one)(keys)
    return np.array(g), np.array(z)


@pytest.fixture
def proposed():
    jp, tp = _build()
    rng = np.random.default_rng(5)
    x = rng.normal(0.0, 1.0, (E, L, d))
    lower = np.array([-1.5, -np.inf, 0.0])
    upper = np.array([1.5, np.inf, np.inf])
    keys = _keys(9).reshape(E, L, 2)
    jnb, jsel, jresp = jprop.propose_ensemble(
        jp, jnp.asarray(x), jnp.asarray(lower), jnp.asarray(upper), keys
    )
    g, z = _jax_propose_draws(keys.reshape(C, 2), tp.max_components)
    tnb, tsel, tresp = tprop.propose_ensemble(
        tp, torch.as_tensor(x), torch.as_tensor(lower), torch.as_tensor(upper),
        torch.as_tensor(g).reshape(E, L, -1), torch.as_tensor(z).reshape(E, L, d),
    )
    return jp, tp, x, (jnb, jsel, jresp), (tnb, tsel, tresp)


def test_propose_ensemble_matches_jax(proposed):
    _, _, _, (jnb, jsel, jresp), (tnb, tsel, tresp) = proposed
    np.testing.assert_array_equal(_np(tsel), np.asarray(jsel))
    np.testing.assert_allclose(_np(tnb), np.asarray(jnb), rtol=RTOL)
    fin = np.isfinite(np.asarray(jresp))
    np.testing.assert_array_equal(np.isfinite(_np(tresp)), fin)
    np.testing.assert_allclose(_np(tresp)[fin], np.asarray(jresp)[fin], rtol=RTOL)


def test_propose_ensemble_t_matches_jax():
    """t-distributed steps (nu = 5): the JAX package's per-lane gamma draw,
    jax.random.gamma(kg, nu/2) from the third key of split(key, 3), is
    handed to the port as its (E, L) standard-gamma draw."""
    nu = 5.0
    jp, tp = _build()
    jp, tp = dataclasses.replace(jp, t_dof=nu), dataclasses.replace(tp, t_dof=nu)
    x = np.random.default_rng(7).normal(0.0, 1.0, (E, L, d))
    lower, upper = np.full(d, -np.inf), np.full(d, np.inf)
    keys = _keys(12)
    jnb, jsel, _ = jprop.propose_ensemble(
        jp, jnp.asarray(x), jnp.asarray(lower), jnp.asarray(upper), keys.reshape(E, L, 2)
    )
    g, z = _jax_propose_draws(keys, tp.max_components)
    gam = jax.vmap(lambda k: jax.random.gamma(jax.random.split(k, 3)[2], 0.5 * nu, dtype=F64))(keys)
    tnb, tsel, _ = tprop.propose_ensemble(
        tp, torch.as_tensor(x), torch.as_tensor(lower), torch.as_tensor(upper),
        torch.as_tensor(g).reshape(E, L, -1), torch.as_tensor(z).reshape(E, L, d),
        torch.as_tensor(np.array(gam)).reshape(E, L),
    )
    np.testing.assert_array_equal(_np(tsel), np.asarray(jsel))
    np.testing.assert_allclose(_np(tnb), np.asarray(jnb), rtol=RTOL)
    # the t step differs from the Gaussian one on the same draws
    gauss, _, _ = tprop.propose_ensemble(
        dataclasses.replace(tp, t_dof=0.0), torch.as_tensor(x), torch.as_tensor(lower),
        torch.as_tensor(upper), torch.as_tensor(g).reshape(E, L, -1),
        torch.as_tensor(z).reshape(E, L, d),
    )
    assert not np.allclose(_np(gauss), _np(tnb))


@pytest.mark.parametrize("reuse", [True, False], ids=["reused_resp", "recomputed_resp"])
def test_mh_log_ratio_ensemble_matches_jax(proposed, reuse):
    """Both the responsibility-reuse path and the recompute path equal the
    JAX package's recompute path (its reuse path has no test of its own)."""
    jp, tp, x, (jnb, jsel, jresp), (tnb, tsel, tresp) = proposed
    jp = dataclasses.replace(jp, selected=jsel.reshape(C))
    tp = dataclasses.replace(tp, selected=tsel.reshape(C))
    ref = jprop.mh_log_ratio_ensemble(jp, jnp.asarray(x), jnb)
    got = tprop.mh_log_ratio_ensemble(
        tp, torch.as_tensor(x), tnb, log_fwd_resp=tresp if reuse else None
    )
    assert got.shape == (E, L)
    np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=RTOL, atol=1e-13)
    # and the JAX reuse path agrees with its recompute path
    np.testing.assert_allclose(
        np.asarray(jprop.mh_log_ratio_ensemble(jp, jnp.asarray(x), jnb, log_fwd_resp=jresp)),
        np.asarray(ref), rtol=RTOL, atol=1e-13,
    )


@pytest.mark.parametrize("ptype", ["gaussian_mixture", "global_covariance"])
def test_update_scales_matches_jax(ptype):
    jp, tp = _build(ptype)
    keys = _keys(3)
    ref = jax.vmap(jprop.update_scales)(_per_chain(jp), keys)
    u = jax.vmap(lambda k: jax.random.uniform(k, dtype=F64))(keys)
    got = tprop.update_scales(tp, torch.as_tensor(np.array(u)))
    np.testing.assert_allclose(_np(got.scales), np.asarray(ref.scales), rtol=RTOL)
    # something moved, something stayed
    moved = _np(got.scales) != _np(tp.scales)
    assert moved.any() and not moved.all()


@pytest.mark.parametrize("ptype", ["gaussian_mixture", "global_covariance"])
def test_notify_accepted_matches_jax(ptype):
    jp, tp = _build(ptype)
    accepted = np.random.default_rng(6).uniform(size=C) < 0.5
    ref = jax.vmap(jprop.notify_accepted)(_per_chain(jp), jnp.asarray(accepted))
    got = tprop.notify_accepted(tp, torch.as_tensor(accepted))
    np.testing.assert_allclose(_np(got.acc_ema), np.asarray(ref.acc_ema), rtol=RTOL)


def test_symmetric_proposal_has_zero_ratio():
    _, tp = _build("global_covariance")
    x = torch.zeros((E, L, d), dtype=torch.float64)
    assert torch.equal(tprop.mh_log_ratio_ensemble(tp, x, x + 1.0), torch.zeros(E, L, dtype=torch.float64))


def _clustered(nu=0.0):
    """A clustered proposal (3 clusters), states, clusters (one lane's out
    of range, clamped by both) and the JAX package's per-lane draws:
    kz, kg = split(key) (proposal.py:351-361)."""
    jp, tp = _build("clustered_covariance")
    jp, tp = dataclasses.replace(jp, t_dof=nu), dataclasses.replace(tp, t_dof=nu)
    assert tp.clustered and jp.clustered and tp.max_components == 3
    rng = np.random.default_rng(8)
    x = rng.normal(0.0, 1.0, (E, L, d))
    cur = rng.integers(0, 3, (E, L))
    cur[0, 0] = 5
    keys = _keys(13)
    kz, kg = jax.vmap(lambda k: tuple(jax.random.split(k)))(keys)
    z = jax.vmap(lambda k: jax.random.normal(k, (d,), F64))(kz)
    gam = jax.vmap(lambda k: jax.random.gamma(k, 0.5 * max(nu, 1.0), dtype=F64))(kg)
    return jp, tp, x, cur, keys.reshape(E, L, 2), np.array(z).reshape(E, L, d), np.array(gam)


@pytest.mark.parametrize("nu", [0.0, 5.0], ids=["gaussian", "t"])
def test_propose_clustered_ensemble_matches_jax(nu):
    jp, tp, x, cur, keys, z, gam = _clustered(nu)
    lower = np.array([-1.5, -np.inf, 0.0])
    upper = np.array([1.5, np.inf, np.inf])
    jnb, jsel = jprop.propose_clustered_ensemble(
        jp, jnp.asarray(x), jnp.asarray(cur), jnp.asarray(lower), jnp.asarray(upper), keys
    )
    tnb, tsel = tprop.propose_clustered_ensemble(
        tp, torch.as_tensor(x), torch.as_tensor(cur), torch.as_tensor(lower),
        torch.as_tensor(upper), torch.as_tensor(z),
        torch.as_tensor(gam).reshape(E, L) if nu > 0.0 else None,
    )
    np.testing.assert_array_equal(_np(tsel), np.asarray(jsel))
    assert int(tsel[0, 0]) == 2  # clamped
    np.testing.assert_allclose(_np(tnb), np.asarray(jnb), rtol=RTOL)


def test_mh_log_ratio_clustered_ensemble_matches_jax():
    """0 within a cluster, the ratio of the two clusters' step densities
    across clusters; the new clusters differ from the current ones on
    some lanes."""
    jp, tp, x, cur, keys, z, _ = _clustered()
    lower, upper = np.full(d, -np.inf), np.full(d, np.inf)
    jnb, _ = jprop.propose_clustered_ensemble(
        jp, jnp.asarray(x), jnp.asarray(cur), jnp.asarray(lower), jnp.asarray(upper), keys
    )
    new = np.random.default_rng(9).integers(0, 3, (E, L))
    ref = np.asarray(jprop.mh_log_ratio_clustered_ensemble(
        jp, jnp.asarray(x), jnb, jnp.asarray(cur), jnp.asarray(new)
    ))
    got = _np(tprop.mh_log_ratio_clustered_ensemble(
        tp, torch.as_tensor(x), torch.as_tensor(np.array(jnb)), torch.as_tensor(cur),
        torch.as_tensor(new),
    ))
    assert got.shape == (E, L)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=1e-13)
    same = np.clip(cur, 0, 2) == new
    assert (got[same] == 0.0).all() and (got[~same] != 0.0).all() and same.any() and (~same).any()


def test_clustered_proposal_needs_one_component_per_cluster():
    params = _gmm_params(0, (3, 2, 3))
    with pytest.raises(ValueError, match="cluster index"):
        tprop.build_block_proposal(
            [GMM.from_params(*p) for p in params], C, d, torch.float64, "cpu",
            proposal_type="clustered_covariance",
        )
