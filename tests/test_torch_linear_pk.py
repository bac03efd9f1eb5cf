"""The port's linear PK propagators against the JAX package and scipy.

Float64 on the CPU, inputs made from a seed with numpy: `_expm_2x2`,
`propagate_two_compartment`, `propagate`, `propagate_biphasic` and
`small_expm` of bcm3_tpu_torch/ode/linear_pk.py equal the JAX package's
to rtol 1e-10, including nearly equal eigenvalues (the `_EPS` guards);
`small_expm` and the two-compartment propagator also match
scipy.linalg.expm of the same system, and `small_expm` takes a different
number of squarings per matrix of one batch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.linalg import expm

from bcm3_tpu.ode import linear_pk as jlpk
from bcm3_tpu_torch.ode import linear_pk as lpk

RTOL = 1e-10


def _rates(rng, n):
    """ka, ke, kel, kpf, kpb over the ranges of the synthesized trials'
    priors, with the last quarter of the rows at nearly equal eigenvalues
    of the central/peripheral block (kel + kpf - kpb and kpf kpb small)."""
    ka, ke = 10 ** rng.uniform(-2, 1, n), 10 ** rng.uniform(-4, 0, n)
    kel, kpf, kpb = (10 ** rng.uniform(-3, 0.5, n) for _ in range(3))
    q = n // 4
    kpf[-q:] = 10 ** rng.uniform(-9, -7, q)
    kpb[-q:] = kel[-q:] + kpf[-q:] + 10 ** rng.uniform(-12, -8, q)
    return ka, ke, kel, kpf, kpb


def _t(*a):
    return [torch.as_tensor(v) for v in a]


def _j(*a):
    return [jnp.asarray(v) for v in a]


def test_expm_2x2_matches_jax_and_scipy():
    rng = np.random.default_rng(0)
    _, _, kel, kpf, kpb = _rates(rng, 64)
    dt = rng.uniform(0.1, 24.0, 64)
    m = (-(kel + kpf), kpb, kpf, -kpb)
    port = torch.stack(lpk._expm_2x2(*_t(*m, dt)), dim=-1).numpy()
    ref = np.stack([np.asarray(v) for v in jlpk._expm_2x2(*_j(*m, dt))], axis=-1)
    np.testing.assert_allclose(port, ref, rtol=RTOL)
    # the closed form is exact where the eigenvalues are apart
    for i in range(48):
        A = np.array([[m[0][i], m[1][i]], [m[2][i], m[3][i]]]) * dt[i]
        np.testing.assert_allclose(port[i], expm(A).ravel(), rtol=1e-7, atol=1e-12)


def _three_state(rng, n):
    ka, ke, kel, kpf, kpb = _rates(rng, n)
    y = np.stack([rng.uniform(0, 100, n), rng.uniform(0, 50, n), rng.uniform(0, 20, n)], -1)
    dt = rng.uniform(0.0, 24.0, n)
    return y, dt, ka, ke, kel, kpf, kpb


def test_propagate_two_compartment_matches_jax_and_scipy():
    rng = np.random.default_rng(1)
    y, dt, ka, ke, kel, kpf, kpb = _three_state(rng, 64)
    port = lpk.propagate_two_compartment(*_t(y, dt, ka, ke, kel, kpf, kpb)).numpy()
    ref = np.asarray(jlpk.propagate_two_compartment(*_j(y, dt, ka, ke, kel, kpf, kpb)))
    np.testing.assert_allclose(port, ref, rtol=RTOL, atol=1e-300)
    for i in range(48):
        A = np.array([
            [-(ka[i] + ke[i]), 0.0, 0.0],
            [ka[i], -(kel[i] + kpf[i]), kpb[i]],
            [0.0, kpf[i], -kpb[i]],
        ])
        np.testing.assert_allclose(port[i], expm(A * dt[i]) @ y[i], rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("n_states", [2, 3])
def test_propagate_and_biphasic_match_jax(n_states):
    rng = np.random.default_rng(2 + n_states)
    y, dt, ka, ke, kel, kpf, kpb = _three_state(rng, 64)
    y = y[:, :n_states]
    ka2 = 10 ** rng.uniform(-2, 1, 64)
    # switch offsets before, inside and after the window (clamped)
    sw = rng.uniform(-2.0, 30.0, 64)
    port = lpk.propagate(*_t(y, dt, ka, ke, kel, kpf, kpb)).numpy()
    ref = np.asarray(jlpk.propagate(*_j(y, dt, ka, ke, kel, kpf, kpb)))
    np.testing.assert_allclose(port, ref, rtol=RTOL, atol=1e-300)
    port = lpk.propagate_biphasic(*_t(y, dt, sw, ka, ka2, ke, kel, kpf, kpb)).numpy()
    ref = np.asarray(jlpk.propagate_biphasic(*_j(y, dt, sw, ka, ka2, ke, kel, kpf, kpb)))
    np.testing.assert_allclose(port, ref, rtol=RTOL, atol=1e-300)
    # a switch at 0 is ka2 throughout, a switch past the window ka1 throughout
    at0 = lpk.propagate_biphasic(*_t(y, dt, np.zeros(64), ka, ka2, ke, kel, kpf, kpb))
    torch.testing.assert_close(at0, lpk.propagate(*_t(y, dt, ka2, ke, kel, kpf, kpb)),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("n", [2, 3, 5])
def test_small_expm_matches_jax_and_scipy(n):
    rng = np.random.default_rng(10 + n)
    # norms from 1e-3 to ~2e3: 0 to 12 squarings within one batch
    scale = 10 ** rng.uniform(-3, 3.3, 40)
    A = rng.normal(size=(40, n, n)) * scale[:, None, None] / n
    A -= np.eye(n) * np.abs(A).sum(-1).max(-1)[:, None, None]  # decaying systems
    port = lpk.small_expm(torch.as_tensor(A)).numpy()
    ref = np.asarray(jax.vmap(jlpk.small_expm)(jnp.asarray(A)))
    np.testing.assert_allclose(port, ref, rtol=RTOL, atol=1e-300)
    for i in range(40):
        np.testing.assert_allclose(port[i], expm(A[i]), rtol=1e-6, atol=1e-12)
    norms = np.abs(A).sum(-1).max(-1)
    squarings = np.clip(np.ceil(np.log2(norms / 0.5)), 0, 12)
    assert len(set(squarings)) > 5
