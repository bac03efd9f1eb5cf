"""The port's PopPK trajectories against the JAX package's, for every model.

`simulate_trajectories` and `simulate_states` of the port (batched over
rows) against the JAX package's (vmapped over the same rows), float64 on
the CPU, on the synthesized trial of tests/test_torch_poppk.py.
"""

import jax
import numpy as np
import pytest
import torch

from jax_shims import jax_biphasic_with_ka2
from test_torch_poppk import _setup


@pytest.mark.parametrize("pk_type", ["one", "two", "two_biphasic_uptake", "one_transit",
                                     "two_transit"])
def test_simulate_states_match_jax(tmp_path, monkeypatch, pk_type):
    """simulate_trajectories and simulate_states of each row against the
    JAX package's of the same vector: concentrations in nM and the
    compartment states in mg at the observation grid (float64; the transit
    models through the budgeted DP5 solve on both sides)."""
    (prior, lik), (jprior, jlik) = _setup(str(tmp_path), pk_type, P=3, T=8)
    if "biphasic" in pk_type:
        jax_biphasic_with_ka2(jlik, monkeypatch)
    xs = np.array(jprior.sample(jax.random.PRNGKey(6), (4,)))
    conc, states = lik.model.simulate_states(torch.as_tensor(xs))
    traj = lik.model.simulate_trajectories(torch.as_tensor(xs))
    jconc, jstates = jax.vmap(jlik.model.simulate_states)(xs)
    for port, ref in ((states, jstates), (conc, jconc), (traj, jconc)):
        np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-8, atol=1e-12)
    np.testing.assert_array_equal(
        np.asarray(jax.vmap(jlik.model.simulate_trajectories)(xs)), np.asarray(jconc)
    )
    assert states.shape == (4, 3, 8, lik.model.n_states)
