"""The port's SBML layer (bcm3_tpu_torch/sbml) against the JAX package's
(bcm3_tpu/sbml), float64: the parser's classification, the lanes-first
right-hand side against the JAX package's on each lane, the special
functions with their guards (tests/test_sbml.py), assignment rules and
function definitions, the structural Jacobian pattern, and the compiled
forward-mode tangents (`make_rhs_jacobian`) against `jax.jacfwd` of the
JAX package's right-hand side, with every special function and a
time-dependent law. Tolerance: 1e-12 relative."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_sbml import MATHML, MODEL, SBML_NS

from bcm3_tpu.sbml import SBMLModel as JModel
from bcm3_tpu.sbml import ratelaws as jrl
from bcm3_tpu_torch.sbml import SBMLModel
from bcm3_tpu_torch.sbml import ratelaws as rl

F64 = torch.float64

# every special function and safepow with a sampled exponent, constant
# species, a time-dependent law and a user function
SPECIAL = f"""<?xml version="1.0"?>
<sbml xmlns="{SBML_NS}" level="2" version="4">
<model id="m3">
<listOfFunctionDefinitions>
  <functionDefinition id="sq">
    <math xmlns="{MATHML}"><lambda><bvar><ci>x</ci></bvar>
      <apply><times/><ci>x</ci><ci>x</ci></apply></lambda></math>
  </functionDefinition>
</listOfFunctionDefinitions>
<listOfSpecies>
  <species id="a" initialAmount="1.0"/>
  <species id="b" initialAmount="0.5"/>
  <species id="c" initialAmount="0.2"/>
  <species id="e" initialAmount="1.5"/>
</listOfSpecies>
<listOfParameters><parameter id="KM" value="0.7"/></listOfParameters>
<listOfReactions>
  <reaction id="r1">
    <listOfReactants><speciesReference species="a"/></listOfReactants>
    <listOfProducts><speciesReference species="b"/></listOfProducts>
    <kineticLaw><math xmlns="{MATHML}">
      <apply><ci>hill</ci><ci>a</ci><ci>k1</ci><ci>n1</ci></apply></math></kineticLaw>
  </reaction>
  <reaction id="r2">
    <listOfReactants><speciesReference species="b"/></listOfReactants>
    <listOfProducts><speciesReference species="c" stoichiometry="2"/></listOfProducts>
    <kineticLaw><math xmlns="{MATHML}">
      <apply><ci>mm</ci><ci>k2</ci><ci>KM</ci><ci>e</ci><ci>b</ci></apply></math></kineticLaw>
  </reaction>
  <reaction id="r3">
    <listOfReactants><speciesReference species="c"/></listOfReactants>
    <kineticLaw><math xmlns="{MATHML}"><apply><times/><ci>k3</ci>
      <apply><ci>synthcap</ci><ci>c</ci></apply>
      <apply><ci>tQSSA</ci><ci>k1</ci><ci>KM</ci><ci>a</ci><ci>c</ci></apply></apply>
    </math></kineticLaw>
  </reaction>
  <reaction id="r4">
    <listOfProducts><speciesReference species="a"/></listOfProducts>
    <kineticLaw><math xmlns="{MATHML}"><apply><plus/>
      <apply><power/><ci>b</ci><ci>n1</ci></apply>
      <apply><exp/><apply><times/><cn>-0.5</cn><csymbol encoding="text"
        definitionURL="http://www.sbml.org/sbml/symbols/time">t</csymbol></apply></apply>
      <apply><ci>sq</ci><apply><ln/><apply><plus/><cn>1</cn><ci>a</ci></apply></apply></apply>
      <apply><divide/><apply><root/><ci>c</ci></apply><ci>k3</ci></apply>
    </apply></math></kineticLaw>
  </reaction>
</listOfReactions>
</model>
</sbml>
"""
SPECIAL_PARAMS = ["k1", "n1", "k2", "k3"]


def _lanes(m, L, seed):
    rng = np.random.default_rng(seed)
    y = rng.uniform(0.05, 2.0, size=(L, m.num_ode_species))
    y[0, 1] = -0.3  # a negative base: safepow's and mm's guards (species b)
    c = np.tile(m.initial_constant_values(), (L, 1))
    return y, c, rng.uniform(0.0, 3.0, size=L)


def test_parse_and_classify_match_jax():
    m, jm = SBMLModel.from_string(MODEL), JModel.from_string(MODEL)
    for attr in ("ode_species", "constant_species", "simulated_species"):
        assert getattr(m, attr) == getattr(jm, attr)
    assert m.species_full_name("sA") == "A_protein"
    assert m.get_parameter_names() == jm.get_parameter_names()
    np.testing.assert_array_equal(m.initial_ode_values(), jm.initial_ode_values())
    np.testing.assert_array_equal(m.initial_constant_values(), jm.initial_constant_values())


def test_special_functions():
    """tests/test_sbml.py::test_special_functions, with the guards."""
    t = lambda *v: [torch.tensor(x, dtype=F64) for x in v]  # noqa: E731
    np.testing.assert_allclose(float(rl.hill(*t(2.0, 1.0, 3.0))), 8 / 9)
    assert float(rl.michaelis_menten(*t(1.0, 0.5, -1.0, 2.0))) == 0.0
    np.testing.assert_allclose(float(rl.michaelis_menten(*t(2.0, 0.5, 1.0, -0.3))),
                               2 * 1 * -0.3 / 0.5)
    assert float(rl.synthcap(*t(-0.5))) == 0.0
    np.testing.assert_allclose(float(rl.synthcap(*t(0.5))), 1 - 0.5**8)
    np.testing.assert_allclose(float(rl.tqssa(*t(1.0, 0.5, 1.0, 2.0))),
                               0.5 * (3.5 - np.sqrt(3.5**2 - 8)))
    assert float(rl.safepow(*t(-2.0, 0.5))) == 0.0
    # Python numbers as the JAX package's functions take them
    assert float(rl.safepow(-2.0, 0.5)) == 0.0
    rng = np.random.default_rng(3)
    args = rng.uniform(-1.0, 2.0, size=(4, 64))
    for name, k in (("hill", 3), ("michaelis_menten", 4), ("synthcap", 1), ("tqssa", 4),
                    ("safepow", 2)):
        a = np.abs(args[:k]) if name in ("hill", "tqssa") else args[:k]
        got = getattr(rl, name)(*[torch.as_tensor(x) for x in a]).numpy()
        np.testing.assert_allclose(got, np.asarray(getattr(jrl, name)(*a)), rtol=1e-14)


@pytest.mark.parametrize("model,params", [(MODEL, ["k_syn", "kcat", "k_deg"]),
                                          (SPECIAL, SPECIAL_PARAMS)],
                         ids=["test_sbml_model", "special_functions"])
def test_rhs_and_jacobian_match_jax(model, params):
    """The right-hand side over 16 lanes against the JAX package's, lane by
    lane; its compiled df/dt and df/dy against jax.jacfwd; the structural
    pattern covers every nonzero and equals the JAX package's."""
    m, jm = SBMLModel.from_string(model), JModel.from_string(model)
    L = 16
    y, c, t = _lanes(m, L, 0)
    p = np.random.default_rng(1).uniform(0.3, 2.0, size=(L, len(params)))
    rhs, jrhs = m.make_rhs(params), jm.make_rhs(params)
    nsp = torch.zeros(0, dtype=F64)
    args = (torch.as_tensor(t), torch.as_tensor(y), torch.as_tensor(c), torch.as_tensor(p), nsp)
    got = rhs(*args)
    f, ft, J = m.make_rhs_jacobian(params)(*args)
    np.testing.assert_array_equal(f.numpy(), got.numpy())
    P = m.jacobian_sparsity()
    np.testing.assert_array_equal(P, jm.jacobian_sparsity())
    for lane in range(L):
        fj = lambda tt, yy: jrhs(tt, yy, jnp.asarray(c[lane]), jnp.asarray(p[lane]),  # noqa
                                 jnp.zeros(0))
        np.testing.assert_allclose(got[lane].numpy(), fj(t[lane], y[lane]), rtol=1e-12)
        np.testing.assert_allclose(ft[lane].numpy(), jax.jacfwd(fj, 0)(t[lane], y[lane]),
                                   rtol=1e-12, atol=1e-300)
        Jj = np.asarray(jax.jacfwd(fj, 1)(t[lane], y[lane]))
        np.testing.assert_allclose(J[lane].numpy(), Jj, rtol=1e-12, atol=1e-300)
        assert not ((J[lane].numpy() != 0) & ~P).any()


def test_assignment_rules_and_functions():
    """tests/test_sbml.py::test_assignment_rules_and_functions, on lanes."""
    model = f"""<?xml version="1.0"?>
<sbml xmlns="{SBML_NS}" level="2" version="4">
<model id="m2">
<listOfFunctionDefinitions>
  <functionDefinition id="double_it">
    <math xmlns="{MATHML}"><lambda>
      <bvar><ci>x</ci></bvar>
      <apply><times/><cn>2</cn><ci>x</ci></apply>
    </lambda></math>
  </functionDefinition>
</listOfFunctionDefinitions>
<listOfSpecies>
  <species id="u" name="u" initialAmount="1.0"/>
  <species id="v" name="v" initialAmount="0.0"/>
  <species id="w" name="w" initialAmount="0.0"/>
</listOfSpecies>
<listOfReactions>
  <reaction id="r1">
    <listOfReactants><speciesReference species="u"/></listOfReactants>
    <listOfProducts><speciesReference species="v" stoichiometry="2"/></listOfProducts>
    <kineticLaw><math xmlns="{MATHML}">
      <apply><ci>double_it</ci><apply><times/><ci>k</ci><ci>u</ci></apply></apply>
    </math></kineticLaw>
  </reaction>
</listOfReactions>
<listOfRules>
  <assignmentRule variable="w">
    <math xmlns="{MATHML}"><apply><plus/><ci>u</ci><ci>v</ci></apply></math>
  </assignmentRule>
</listOfRules>
</model>
</sbml>"""
    m = SBMLModel.from_string(model)
    y = torch.tensor([[1.5, 0.25], [0.5, 1.0]], dtype=F64)
    p = torch.tensor([[0.5], [2.0]], dtype=F64)
    c = torch.zeros(2, 1, dtype=F64)
    nsp = torch.zeros(0, dtype=F64)
    dy = m.make_rhs(["k"])(torch.zeros(2, dtype=F64), y, c, p, nsp).numpy()
    rate = 2 * p[:, 0].numpy() * y[:, 0].numpy()
    np.testing.assert_allclose(dy, np.stack([-rate, 2 * rate], axis=1), rtol=1e-12)
    out = m.make_assignments(["k"])(torch.zeros(2, dtype=F64), y, c, p, nsp).numpy()
    np.testing.assert_allclose(out, [[1.5, 0.25, 1.75], [0.5, 1.0, 1.5]], rtol=1e-12)
