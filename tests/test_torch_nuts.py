"""The port's NUTS against the JAX package's, on the CPU in float64.

- The helpers case by case: `is_turning` against `_is_turning` on random
  momenta, `leaf_idx_to_ckpt_idxs` against `_leaf_idx_to_ckpt_idxs` for
  every leaf index of a depth-7 tree, `warmup_windows` against
  `_warmup_windows` for warmup lengths from 0 to 1000.
- One transition of every chain, given the JAX package's draws derived
  from each chain's key by its own splits (bcm3_tpu/sampler/nuts.py:151
  momentum, :285 each doubling's direction and acceptance, :218 each
  leaf's selection): new z, logp, tree depth, accept statistic and
  divergence equal to 1e-10, on the banana fixture at a step size that
  builds trees of several depths and at one that diverges. (PopPK
  `one`'s gradient, through B1's autograd Function and B1T's plain
  version, is held to the JAX package's in tests/test_torch_grad.py, and
  a sampler step through it in tests/test_torch_hmc.py.)
- A whole run on the banana fixture (128 chains, trees of depth 5 at most) against the quadrature
  oracle over its prior box, as tests/test_torch_hmc.py holds HMC: each
  coordinate's mean and sd within 4 Monte Carlo standard errors. The
  JAX package's whole runs are not repeated here: their while_loop
  compiles are slow, and the single transitions above hold the port to
  them.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bcm3_tpu.sampler.nuts import NUTSConfig as JNUTSConfig
from bcm3_tpu.sampler.nuts import SamplerNUTS as JSamplerNUTS
from bcm3_tpu.sampler.nuts import _is_turning, _leaf_idx_to_ckpt_idxs
from bcm3_tpu_torch.sampler import NUTSConfig, SamplerNUTS
from bcm3_tpu_torch.sampler.nuts import is_turning, leaf_idx_to_ckpt_idxs, warmup_windows
from test_torch_hmc import FIXTURES, models, oracle_z


def test_is_turning_matches_jax():
    rng = np.random.default_rng(0)
    for _ in range(50):
        inv_mass, r_left, r_right, r_sum = rng.uniform(0.2, 2.0, 3), *rng.normal(size=(3, 3))
        ref = bool(_is_turning(*(jnp.asarray(a) for a in (inv_mass, r_left, r_right, r_sum))))
        got = is_turning(*(torch.as_tensor(a) for a in (inv_mass, r_left, r_right, r_sum)))
        assert bool(got) == ref


def test_leaf_checkpoint_indices_match_jax():
    ref = jax.jit(jax.vmap(_leaf_idx_to_ckpt_idxs))(jnp.arange(2**7, dtype=jnp.int32))
    for n, lo, hi in zip(range(2**7), *(np.asarray(r).tolist() for r in ref)):
        assert leaf_idx_to_ckpt_idxs(n) == (lo, hi), n


def test_warmup_windows_match_jax():
    for n in list(range(0, 60)) + [75, 100, 150, 200, 256, 400, 500, 999, 1000]:
        assert warmup_windows(n) == JSamplerNUTS._warmup_windows(n), n


def jax_draws(keys, D, max_depth):
    """The draws of the JAX package's transition from each chain's key, by
    its own splits: (normal (C, D), forward (M, C), accept (M, C), select
    (2^M - 1, C))."""

    def one_chain(key):
        k_mom, tree_key = jax.random.split(key)
        forward, accept, select = [], [], []
        for d in range(max_depth):
            tree_key, k_dir, k_acc = jax.random.split(tree_key, 3)
            forward.append(jax.random.bernoulli(k_dir))
            accept.append(jax.random.uniform(k_acc))
            leaf_key = tree_key
            for _ in range(2**d):
                leaf_key, k_sel = jax.random.split(leaf_key)
                select.append(jax.random.uniform(k_sel))
        return (jax.random.normal(k_mom, (D,)), jnp.stack(forward), jnp.stack(accept),
                jnp.stack(select))

    normal, forward, accept, select = jax.vmap(one_chain)(keys)
    return np.asarray(normal), *(np.asarray(a).T for a in (forward, accept, select))


_JAX_STEPS = {}


def check_transition(port, ref, C, eps, max_depth, seed):
    (prior, lik), (jprior, jlik) = port, ref
    D = prior.num_variables
    key = (id(jlik), max_depth)
    if key not in _JAX_STEPS:  # one compile per model and depth
        js = JSamplerNUTS(jprior, jlik, JNUTSConfig(max_tree_depth=max_depth))
        _JAX_STEPS[key] = js, js._make_step_all()
    js, step_all = _JAX_STEPS[key]
    x = np.asarray(jprior.sample(jax.random.PRNGKey(seed), (C,)))
    z = js._reparam.from_x(x)
    inv_mass = np.random.default_rng(seed).uniform(0.5, 2.0, D)
    logp, grad = jax.jit(jax.vmap(js._vgrad))(z)
    keys = jax.random.split(jax.random.PRNGKey(seed + 1), C)
    ref_out = step_all(z, logp, grad, keys, eps, jnp.asarray(inv_mass))

    s = SamplerNUTS(prior, lik, NUTSConfig(max_tree_depth=max_depth, device="cpu"))
    draws = [torch.as_tensor(a) for a in jax_draws(keys, D, max_depth)]

    def t(a, **kw):
        return torch.as_tensor(np.array(a), **kw)

    out = s.transition(t(z), t(logp), t(grad),
                       t(eps, dtype=torch.float64), t(inv_mass), *draws)
    z1, lp1, g1, astat, div, depth = (np.asarray(a) for a in ref_out)
    np.testing.assert_array_equal(out[5].numpy(), depth)
    np.testing.assert_array_equal(out[4].numpy(), div)
    np.testing.assert_allclose(out[0].numpy(), z1, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(out[1].numpy(), lp1, rtol=1e-10)
    np.testing.assert_allclose(out[2].numpy(), g1, rtol=1e-10, atol=1e-10 * np.abs(g1).max())
    np.testing.assert_allclose(out[3].numpy(), astat, rtol=1e-10, atol=1e-12)
    return depth, div


@pytest.fixture(scope="module")
def banana():
    return models(os.path.join(FIXTURES, "banana"))


@pytest.mark.parametrize("eps", [0.3, 30.0])
def test_transition_matches_jax_on_banana(banana, eps):
    depth, div = check_transition(*banana, C=16, eps=eps, max_depth=6, seed=2)
    if eps < 1:
        assert len(set(depth.tolist())) >= 3  # trees of several depths
    else:
        assert div.all()


def test_banana_run_meets_the_oracle(banana):
    (prior, lik), _ = banana
    cfg = NUTSConfig(num_samples=40, num_warmup=60, num_chains=128, max_tree_depth=5, seed=3,
                     device="cpu")
    res = SamplerNUTS(prior, lik, cfg).run()
    assert res["samples"].shape == (40 * 128, 1, 2)
    assert res["divergences"] <= 40 * 128 // 500 and res["mean_tree_depth"] > 1.5
    # every leaf is one batched gradient evaluation and one host read
    # (the first leaf of a doubling needs none; each doubling needs one)
    evals = res["gradient_evaluations_per_transition"]
    assert 1 <= evals <= 2**5 - 1 and res["host_syncs_per_transition"] <= evals + 5
    z_mean, z_sd = oracle_z(res["samples_per_chain"])
    assert np.all(np.abs(z_mean) <= 4) and np.all(np.abs(z_sd) <= 4), (z_mean, z_sd)
