"""The port's generic likelihoods (`ODE`, `dll`) against the JAX package
on the CPU, both built by bare type name through `create_likelihood`.

- `ODE`: the reference's empty derivative stub (rtol 1e-10) and a
  harmonic oscillator tuned to the data curve (rtol 1e-8), the port's
  derivative lane-first, the JAX package's per row;
- `dll`: a Python plugin's `evaluate_log_probability` (one file serves
  both packages), the port's batched `make_log_prob`, and the C plugin of
  tests/fixtures/plugins compiled with `cc` (the same library for both),
  whose false return scores -inf.
"""

import os
import subprocess
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bcm3_tpu.likelihoods import create_likelihood as jax_create_likelihood
from bcm3_tpu.model.variables import VariableSet as JVariableSet
from bcm3_tpu_torch.likelihoods import create_likelihood
from bcm3_tpu_torch.model.variables import VariableSet

PLUGIN_SOURCE = os.path.join(os.path.dirname(__file__), "fixtures", "plugins",
                             "gaussian_plugin.c")
W = 1.0 / 2300.0


def _varsets(names):
    vs, jvs = VariableSet(), JVariableSet()
    for name in names:
        vs.add_variable(name)
        jvs.add_variable(name)
    return vs, jvs


def _harmonic(t, y, params):
    # y0' = y1, y1' = -w^2 y0, plus two inert states; lanes first
    z = torch.zeros_like(y[:, 0])
    return torch.stack([y[:, 1], -W * W * y[:, 0], z, z], dim=-1)


def _jax_harmonic(t, y, p):
    return jnp.array([y[1], -W * W * y[0], 0.0, 0.0], dtype=y.dtype)


@pytest.mark.parametrize("harmonic", [False, True], ids=["stub", "harmonic"])
def test_ode_template_matches_jax(harmonic):
    vs, jvs = _varsets([f"p{i}" for i in range(13)])
    kw = dict(_derivative=_harmonic) if harmonic else {}
    lik = create_likelihood("ODE", vs, **kw)
    jlik = jax_create_likelihood("ODE", jvs, **(dict(_derivative=_jax_harmonic) if harmonic
                                                 else {}))
    xs = np.random.default_rng(3).uniform(0.1, 1.3, (4, 13))
    xs[:, 9] = [100.0, 90.0, 120.0, 300.0]  # y0 amplitude: data = 100 cos(wt) + 300
    xs[0, 10] = 0.0  # row 0 starts at rest: y0 = 100 cos(wt)
    ys, ok = lik.model.simulate(torch.as_tensor(xs))
    assert ys.shape == (4, 100, 4) and ok.all()
    got = lik.log_prob_batched(torch.as_tensor(xs)).numpy()
    ref = np.asarray(jax.vmap(jlik.log_prob)(xs))
    rtol = 1e-8 if harmonic else 1e-10
    np.testing.assert_allclose(got, ref, rtol=rtol)
    jys, _ = jax.vmap(jlik.model.simulate)(xs)
    np.testing.assert_allclose(ys.numpy(), np.asarray(jys), rtol=rtol, atol=1e-9)
    if harmonic:
        ts = np.linspace(0.0, 1000.0, 100)
        np.testing.assert_allclose(ys[0, :, 0].numpy(), 100 * np.cos(ts / 2300.0), rtol=1e-4)
    else:
        assert torch.equal(ys, torch.as_tensor(xs[:, None, 9:13]).expand(4, 100, 4))
    with pytest.raises(ValueError, match="Incorrect number of parameters"):
        create_likelihood("ODE", _varsets(["a"])[0])


def test_python_plugins(tmp_path):
    """`evaluate_log_probability` per row on the host, the same file for
    both packages; `make_log_prob` returning the port's batched torch
    function."""
    host = tmp_path / "hostlik.py"
    host.write_text("def evaluate_log_probability(values):\n"
                    "    return float(-(values**2).sum())\n")
    vs, jvs = _varsets(["a", "b"])
    xs = np.random.default_rng(0).normal(size=(5, 2))
    lik = create_likelihood("dll", vs, dll_filename_base=str(host)[:-3])
    jlik = jax_create_likelihood("dll", jvs, dll_filename_base=str(host)[:-3])
    got = lik.log_prob_batched(torch.as_tensor(xs))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np.asarray(jax.vmap(jlik.log_prob)(xs)),
                               rtol=1e-15)

    batched = tmp_path / "mylik.py"
    batched.write_text(textwrap.dedent("""
        def make_log_prob(variable_names):
            assert list(variable_names) == ["a", "b"]

            def log_prob_batched(xs):
                return -0.5 * (xs ** 2).sum(dim=1)

            return log_prob_batched
        """))
    lik = create_likelihood("dll", vs, dll_filename_base=str(batched)[:-3])
    got = lik.log_prob_batched(torch.as_tensor(xs, dtype=torch.float32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), -0.5 * (xs ** 2).sum(1), rtol=1e-6)


def test_c_plugin_matches_jax(tmp_path):
    """The fixture's C ABI library, compiled here, loaded by both packages
    through ctypes; the rows beyond its domain (a false return) are -inf
    on both sides. The XML form resolves the library next to the XML."""
    so = tmp_path / "gaussian_plugin.so"
    subprocess.run(["cc", "-shared", "-fPIC", "-O2", "-o", str(so), PLUGIN_SOURCE], check=True)
    vs, jvs = _varsets(["a", "b", "c"])
    xs = np.random.default_rng(1).normal(size=(8, 3)) * 3.0
    xs[2, 0] = 6.0
    lik = create_likelihood("dll", vs, dll_filename_base=str(so)[:-3])
    jlik = jax_create_likelihood("dll", jvs, dll_filename_base=str(so)[:-3])
    got = lik.log_prob_batched(torch.as_tensor(xs, dtype=torch.float32))
    assert got.dtype == torch.float32
    ref = np.asarray(jax.vmap(jlik.log_prob)(xs))
    got64 = lik.log_prob_batched(torch.as_tensor(xs)).numpy()
    np.testing.assert_array_equal(got64, ref)
    fails = np.abs(xs[:, 0]) > 5.0
    assert np.isneginf(ref[fails]).all() and np.isfinite(ref[~fails]).all() and fails.sum() >= 1
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6)

    xml = tmp_path / "likelihood.xml"
    xml.write_text('<bcm_likelihood type="dll" dll_filename_base="gaussian_plugin"/>')
    from_xml = create_likelihood(str(xml), vs)
    np.testing.assert_array_equal(from_xml.log_prob_batched(torch.as_tensor(xs)).numpy(), ref)
    with pytest.raises(FileNotFoundError, match="Cannot find plugin"):
        create_likelihood("dll", vs, dll_filename_base=str(tmp_path / "absent"))
