"""The port's analytic likelihoods against the JAX package's, on the fixtures.

Both packages read the same prior.xml and likelihood.xml from
tests/fixtures/examples; the port's batched log-likelihood of prior draws
(and of points outside the prior box) must equal the JAX package's
`vmap(log_prob)` to rtol 1e-10 in float64. The circular ridge's
width="=0.1" must parse to 0.1 in both, and the registry's attribute
errors are the JAX package's.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bcm3_tpu.likelihoods import create_likelihood as jax_create_likelihood
from bcm3_tpu.model.variables import VariableSet as JVariableSet
from bcm3_tpu_torch import Prior, VariableSet, create_likelihood
from bcm3_tpu_torch.likelihoods import parse_matrix, parse_vector

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "examples")
EXAMPLES = {
    "banana": "banana",
    "multimodal_circular_ridge": "circular",
    "multimodal_gaussians": "multimodal_gaussians",
    "truncated_t": "truncated_t",
}


def _both(prior_xml, lik_xml):
    vs = VariableSet.from_xml(prior_xml)
    jvs = JVariableSet.from_xml(prior_xml)
    return (Prior.from_xml(prior_xml, vs), create_likelihood(lik_xml, vs)), jax_create_likelihood(
        lik_xml, jvs
    )


def _points(prior, seed):
    """Prior draws, and as many points spread over twice the prior box."""
    xs = prior.sample(torch.Generator().manual_seed(seed), (200,), torch.float64)
    lo, hi = xs.min(dim=0).values, xs.max(dim=0).values
    rng = np.random.default_rng(seed)
    wide = rng.uniform(-1.5, 1.5, size=xs.shape) * (hi - lo).numpy() + ((lo + hi) / 2).numpy()
    return torch.cat([xs, torch.as_tensor(wide)])


@pytest.mark.parametrize("example", sorted(EXAMPLES))
def test_fixture_likelihood_matches_jax(example):
    d = os.path.join(FIXTURES, example)
    (prior, lik), jlik = _both(os.path.join(d, "prior.xml"), os.path.join(d, "likelihood.xml"))
    assert lik.name == jlik.name == EXAMPLES[example]
    xs = _points(prior, sorted(EXAMPLES).index(example))
    port = lik.log_prob_batched(xs)
    assert port.shape == (len(xs),) and port.dtype == torch.float64
    ref = np.asarray(jax.vmap(jlik.log_prob)(jnp.asarray(xs.numpy())))
    assert np.isfinite(ref).all()
    np.testing.assert_allclose(port.numpy(), ref, rtol=1e-10)


def test_dummy_is_zero(tmp_path):
    lik_xml = os.path.join(tmp_path, "likelihood.xml")
    with open(lik_xml, "w") as f:
        f.write('<bcm_likelihood type="dummy"/>')
    (prior, lik), jlik = _both(os.path.join(FIXTURES, "banana", "prior.xml"), lik_xml)
    xs = _points(prior, 0)
    out = lik.log_prob_batched(xs)
    ref = np.asarray(jax.vmap(jlik.log_prob)(jnp.asarray(xs.numpy())))
    assert out.shape == ref.shape and (out == 0).all() and (ref == 0).all()


def test_circular_width_strips_the_equals_sign():
    """width="=0.1" is the ridge of width 0.1, the value the reference
    example means, in both packages."""
    d = os.path.join(FIXTURES, "multimodal_circular_ridge")
    (_, lik), jlik = _both(os.path.join(d, "prior.xml"), os.path.join(d, "likelihood.xml"))
    x = np.array([[1.0, 1.5], [-1.5, 0.0]])
    d1 = np.linalg.norm(x - [-3.5, 0.0], axis=1)
    d2 = np.linalg.norm(x - [3.5, 0.0], axis=1)

    def lp(dist):
        return -0.5 * ((dist - 2.0) / 0.1) ** 2 - np.log(0.1) - 0.5 * np.log(2 * np.pi)

    expected = np.logaddexp(lp(d1), lp(d2))
    np.testing.assert_allclose(lik.log_prob_batched(torch.as_tensor(x)).numpy(), expected,
                               rtol=1e-12)
    np.testing.assert_allclose(np.asarray(jax.vmap(jlik.log_prob)(jnp.asarray(x))), expected,
                               rtol=1e-12)


def test_parse_vector_and_matrix():
    np.testing.assert_array_equal(parse_vector("0.5;2.0;0.0;"), [0.5, 2.0, 0.0])
    np.testing.assert_array_equal(parse_matrix("1,2;3,4"), [[1.0, 2.0], [3.0, 4.0]])


@pytest.mark.parametrize(
    "xml,nvars,match",
    [
        ('<bcm_likelihood type="banana" sd1="2" sd2="0"/>', 2, "positive"),
        ('<bcm_likelihood type="banana" sd1="2" sd2="1" dimension="3"/>', 2, "dimension"),
        ('<bcm_likelihood type="multimodal_gaussians"/>', 3, "exactly 2"),
        ('<bcm_likelihood type="truncated_t" dimensions="1" num_clusters="1" mu1="0"'
         ' sigma1="1" nus="3;4" weights="1"/>', 1, "nus/weights"),
        ('<bcm_likelihood type="no_such_type"/>', 1, "Unknown likelihood type"),
    ],
)
def test_attribute_errors_match_jax(tmp_path, xml, nvars, match):
    lik_xml = os.path.join(tmp_path, "likelihood.xml")
    with open(lik_xml, "w") as f:
        f.write(xml)
    vs, jvs = VariableSet(), JVariableSet()
    for i in range(nvars):
        vs.add_variable(f"x{i}")
        jvs.add_variable(f"x{i}")
    with pytest.raises(ValueError, match=match):
        create_likelihood(lik_xml, vs)
    with pytest.raises(ValueError, match=match):
        jax_create_likelihood(lik_xml, jvs)
