"""The port's fISA likelihood (bcm3_tpu_torch/fisa) against the JAX package's.

Every scenario of tests/test_fisa.py, in float64 on the CPU, within 1e-10
relative: the acyclic network with drugs, a feedback loop, the bistable
network's 10 Sobol-started roots, best-root scoring, the
`multiroot_solves` attribute, a network with every drug effect and the
four error models with NaN observations, the incucyte-sequential
experiment (absolute, relative, with a NaN pair skipped), the observed and
modeled accessors; batches of rows against `jax.jit(jax.vmap(log_prob))`,
-inf rows included; the hand-written Newton Jacobian against `jax.jacfwd`
within 1e-12; the network carried across from the JAX package against the
port's own parse. The fixtures are chip_smoke.py's (`fisa_files`), whose
data groups the JAX package reads from an HDF5 file written here. One JAX
jit a likelihood, module-scoped.
"""

import dataclasses
import os

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from bcm3_tpu.likelihoods import create_likelihood as jax_create_likelihood
from bcm3_tpu.model.variables import VariableSet as JaxVariableSet
from bcm3_tpu_torch.convert import fisa_network_from_fields
from bcm3_tpu_torch.fisa.likelihood import FISALikelihood, first_max_index
from bcm3_tpu_torch.fisa.network import Dual, SignalingNetwork
from bcm3_tpu_torch.likelihoods import create_likelihood
from bcm3_tpu_torch.model.variables import VariableSet

RTOL = 1e-10
ROWS = 48
# a kept solve whose Newton residual stays above CONVERGED after the 20
# steps has not reached its root; such rows are held to UNCONVERGED_RTOL
CONVERGED = 1e-10
UNCONVERGED_RTOL = 1e-6

# name -> (fisa_files config, its options)
FIXTURES = {
    "bistable": ("bistable", {}),
    "network": ("network", dict(feedback=True)),
    "acyclic": ("network", dict(feedback=False)),
    "incucyte": ("incucyte", dict(relative=False)),
    "incucyte_relative": ("incucyte", dict(relative=True)),
    "incucyte_nan_pair": ("incucyte", dict(relative=False, nan_pair=True)),
}


def _write_h5(path, data):
    with h5py.File(path, "w") as f:
        for exp, group in data.items():
            g = f.create_group(exp)
            for k, v in group.items():
                g.create_dataset(k, data=v)


def _jax_varset(config):
    vs = JaxVariableSet()
    for name, logspace, _ in chip_smoke.FISA_VARIABLES[config]:
        vs.add_variable(name, logspace=logspace)
    return vs


class Pair:
    """One fixture in both packages: the port's likelihood (data in
    memory), the JAX package's (data from HDF5), the values and rows."""

    def __init__(self, root, name):
        config, opts = FIXTURES[name]
        self.dir = os.path.join(root, name)
        self.path, self.data = chip_smoke.fisa_files(self.dir, config, **opts)
        # the incucyte experiments name idata.nc, the others data.nc
        fname = "idata.nc" if config == "incucyte" else "data.nc"
        _write_h5(os.path.join(self.dir, fname), self.data)
        self.lik, self.values = chip_smoke.fisa_model(self.dir, config, **opts)
        self.jlik = jax_create_likelihood(self.path, _jax_varset(config))
        self.config = config
        rng = np.random.default_rng(1)
        self.rows = self.values[None] + 0.05 * rng.normal(size=(ROWS, len(self.values)))
        self.rows[0] = self.values
        self._ref = None

    @property
    def ref(self):
        """jax.jit(jax.vmap(log_prob)) of the rows, computed once."""
        if self._ref is None:
            self._ref = np.asarray(jax.jit(jax.vmap(self.jlik.log_prob))(self.rows))
        return self._ref

    def port(self, rows, dtype=torch.float64):
        return self.lik.log_prob_batched(torch.as_tensor(rows, dtype=dtype)).double().numpy()


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("fisa"))
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = Pair(root, name)
        return cache[name]

    return get


def _assert_rows(got, ref, unconverged=None):
    """Equal -inf sets; finite rows within RTOL, but rows whose kept solve
    the 20 Newton steps left short of its root (`unconverged`) within
    UNCONVERGED_RTOL."""
    fin = np.isfinite(ref)
    assert np.array_equal(fin, np.isfinite(got)), (got, ref)
    assert np.array_equal(got[~fin], ref[~fin])
    loose = np.zeros_like(fin) if unconverged is None else unconverged
    rel = np.zeros_like(ref)
    rel[fin] = np.abs(got[fin] - ref[fin]) / np.abs(ref[fin])
    assert rel[fin & ~loose].max(initial=0.0) <= RTOL, rel[fin & ~loose].max()
    assert rel[fin & loose].max(initial=0.0) <= UNCONVERGED_RTOL


@pytest.mark.parametrize("name", list(FIXTURES))
def test_log_prob_batched_matches_jax(pairs, name):
    """A batch of rows against jax.vmap(log_prob): the -inf rows (the
    network's negative sd_c rows) alike, every finite row within 1e-10,
    but those whose kept solve stopped short of its root after the fixed
    20 Newton steps (a residual above CONVERGED, near a fold of the
    network): there one ulp of XLA's exp against ATen's moves the iterate
    by ~1e-10, so they are held to UNCONVERGED_RTOL; at least half the
    rows are finite and converged."""
    p = pairs(name)
    got = p.port(p.rows)
    residual = p.lik.model.newton_residual(torch.as_tensor(p.rows)).numpy()
    unconverged = residual > CONVERGED
    _assert_rows(got, p.ref, unconverged)
    assert (np.isfinite(p.ref) & ~unconverged).sum() >= ROWS // 2
    if name == "network":
        assert (~np.isfinite(p.ref)).any(), "the fixture has no -inf row"


@pytest.mark.parametrize("name", ["bistable", "network", "incucyte"])
def test_carried_network_equals_parsed(pairs, name):
    """fisa_network_from_fields builds the JAX package's network as the
    port's; the port's own parse of the same SBML equals it."""
    p = pairs(name)
    for jexp, exp in zip(p.jlik.model.experiments, p.lik.model.experiments):
        jnet = jexp.network
        carried = fisa_network_from_fields({
            "molecules": [dataclasses.asdict(m) for m in jnet.molecules],
            "_order": jnet._order,
            "_multiroot_starts": jnet._multiroot_starts,
            "activation_limit": jnet.activation_limit,
            "multiroot_solves": jnet.multiroot_solves,
        })
        net = exp.network
        assert carried.molecules == net.molecules
        assert carried._order == net._order and carried.has_feedback == net.has_feedback
        assert carried.activation_limit == net.activation_limit
        assert len(carried._multiroot_starts) == len(net._multiroot_starts)
        for a, b in zip(carried._multiroot_starts, net._multiroot_starts):
            assert (a is None and b is None) or np.array_equal(a, b)


def _jax_jacobian(jnet, ci):
    """jax.jacfwd of the JAX package's Newton residual of component ci
    (`_calculate_impl`'s `residual`), jitted: (sub, acts, expression,
    values) -> (d, d)."""
    comp = jnet._order[ci]
    comp_arr = jnp.asarray(comp)

    def jacobian(sub, acts, expression, values):
        def residual(s):
            a = acts.at[comp_arr].set(s)
            return s - jnp.stack([jnet._molecule_activity(i, a, expression, values)
                                  for i in comp])

        return jax.jacfwd(residual)(sub)

    return jax.jit(jacobian)


@pytest.mark.parametrize("name", ["bistable", "network"])
def test_jacobian_matches_jacfwd(pairs, name):
    """The forward-mode tangents of the Newton system against jax.jacfwd
    of the JAX package's residual, at the Sobol starts and at the solution,
    for the first rows and cell lines: within 1e-12."""
    p = pairs(name)
    exp, jexp = p.lik.model.experiments[0], p.jlik.model.experiments[0]
    net = exp.network
    ci = next(k for k, c in enumerate(net._order) if len(c) > 1)
    tv = p.lik.model._transform(torch.as_tensor(p.rows[:3]))
    preset, expression = exp._prepare(tv)
    solved = net.calculate(tv[:, None, :], expression, preset)  # (3, P, n)
    P = len(exp.cell_lines)
    jacobian = _jax_jacobian(jexp.network, ci)
    checked = 0
    for r in range(3):
        for c in range(P):
            acts = solved[r, c]
            for sub in [torch.as_tensor(s) for s in net._multiroot_starts[ci]][:3] + [
                    acts[net._order[ci]]]:
                lanes = [Dual(acts[k]) for k in range(net.num_molecules)]
                vals = [tv[r, k] for k in range(tv.shape[1])]
                expr = [expression[min(r, expression.shape[0] - 1), c, k]
                        for k in range(net.num_molecules)]
                _, J = net.newton_system(ci, sub, lanes, expr, vals)
                ref = jacobian(sub.numpy(), acts.numpy(),
                               expression[min(r, expression.shape[0] - 1), c].numpy(),
                               tv[r].numpy())
                np.testing.assert_allclose(J.numpy(), np.asarray(ref), rtol=1e-12, atol=1e-12)
                checked += 1
    assert checked >= 12


def test_acyclic_network_with_drugs(pairs):
    """The acyclic network (minmax limit; drugs that inhibit activity with a
    dose-response, inhibit activation, alter susceptibility and activate; a
    complete-loss mutation; a transporter; expression levels and mixing):
    each cell line's activities against the JAX package's calculate."""
    p = pairs("acyclic")
    exp, jexp = p.lik.model.experiments[0], p.jlik.model.experiments[0]
    tv = p.lik.model._transform(torch.as_tensor(p.rows[:2]))
    preset, expression = exp._prepare(tv)
    got = exp.network.calculate(tv[:, None, :], expression, preset).numpy()
    for r in range(2):
        for c in range(len(exp.cell_lines)):
            jpre, jexpr = jexp._prepare(jnp.asarray(tv[r].numpy()), c)
            ref = np.asarray(jexp.network.calculate(jnp.asarray(tv[r].numpy()), jexpr, jpre))
            np.testing.assert_allclose(got[r, c], ref, rtol=1e-12, atol=1e-15)
    # the loss mutation of cell line c3 silences C's input: C = 0 there
    assert got[0, 2, exp.network.molecule_ix_by_name("C")] == 0.0


def _fb_net(tmp_path, positive, limit, pkg):
    """tests/test_fisa.py:_feedback_model in one package."""
    path = tmp_path / f"fb_{positive}.xml"
    path.write_text(chip_smoke.fisa_sbml(
        [chip_smoke.fisa_species("s1", "A", "PROTEIN"),
         chip_smoke.fisa_species("s2", "B", "PROTEIN")],
        [chip_smoke.fisa_reaction("r1", "s1", "s2"),
         chip_smoke.fisa_reaction("r2", "s2", "s1", positive=positive)]))
    if pkg == "jax":
        from bcm3_tpu.fisa.network import SignalingNetwork as JaxNetwork

        vs = JaxVariableSet()
        cls = JaxNetwork
    else:
        vs = VariableSet()
        cls = SignalingNetwork
    for name in ("base_A", "strength_A_B", "strength_B_A"):
        vs.add_variable(name)
    return cls.from_sbml(str(path), vs, limit)


def _logistic_fixed(x):
    return np.where(x > 3.5, 1.0, 1.0 / (1.0 + np.exp(-9.19024 * (x - 0.5))))


def test_feedback_component(tmp_path):
    """A -> B -| A converges by the damped Newton solve, to the JAX
    package's fixed point; feedback under the minmax limit is refused."""
    net = _fb_net(tmp_path, False, "logistic", "torch")
    jnet = _fb_net(tmp_path, False, "logistic", "jax")
    tv = np.array([[0.8, 0.9, 0.5], [0.3, 0.6, 1.2]])
    got = net.calculate(torch.as_tensor(tv), torch.ones(2, 2, dtype=torch.float64),
                        torch.full((2, 2), float("nan"), dtype=torch.float64)).numpy()
    ref = np.asarray(jnet.calculate(jnp.asarray(tv[0]), jnp.ones(2), jnp.full((2,), jnp.nan)))
    np.testing.assert_allclose(got[0], ref, rtol=RTOL, atol=1e-15)
    for r in range(2):
        a, b = got[r]
        np.testing.assert_allclose(a, _logistic_fixed(tv[r, 0] - tv[r, 2] * b), atol=1e-6)
        np.testing.assert_allclose(b, _logistic_fixed(tv[r, 1] * a), atol=1e-6)
    with pytest.raises(ValueError, match="logistic"):
        _fb_net(tmp_path, False, "minmax", "torch")


def test_bistable_multiroot(pairs):
    """The bistable network's 10 Sobol-started solves against the JAX
    package's: both stable roots found, each a fixed point; the single 0.5
    start lands on one of them only; no feedback would mean one solve."""
    p = pairs("bistable")
    exp, jexp = p.lik.model.experiments[0], p.jlik.model.experiments[0]
    net, jnet = exp.network, jexp.network
    tv = np.array([0.15, 0.15, 0.8, 0.8])
    ones, nan = torch.ones(2, dtype=torch.float64), torch.full((2,), float("nan"),
                                                                dtype=torch.float64)
    acts = net.calculate_multiroot(torch.as_tensor(tv), ones, nan).numpy()
    assert acts.shape == (10, 2)
    ref = np.asarray(jax.jit(lambda v: jnet.calculate_multiroot(
        v, jnp.ones(2), jnp.full((2,), jnp.nan)))(tv))
    # two starts stop short of the middle root after the 20 steps (see
    # test_log_prob_batched_matches_jax): there the packages part by ~1e-11
    np.testing.assert_allclose(acts, ref, rtol=1e-9, atol=1e-12)
    lows, highs = acts[acts[:, 0] < 0.2], acts[acts[:, 0] > 0.8]
    assert len(lows) and len(highs)
    for a, b in np.concatenate([lows, highs]):
        np.testing.assert_allclose(a, _logistic_fixed(0.15 + 0.8 * b), atol=1e-4)
        np.testing.assert_allclose(b, _logistic_fixed(0.15 + 0.8 * a), atol=1e-4)
    # the single solve starts at 0.5, the second Sobol point: the same lane
    single = net.calculate(torch.as_tensor(tv), ones, nan).numpy()
    np.testing.assert_array_equal(net._multiroot_starts[0][1], [0.5, 0.5])
    np.testing.assert_array_equal(single, acts[1])
    assert single[0] > 0.3 and len(acts[np.abs(acts[:, 0] - single[0]) > 0.3])


def test_best_root_scoring(pairs):
    """bench_fisa's data sit at the low root: the likelihood keeps the best
    root per (row, cell line), as the JAX package does, and scores far above
    the single start's root; the stored activities are the best root's."""
    p = pairs("bistable")
    exp = p.lik.model.experiments[0]
    tv = torch.as_tensor(p.values)
    stored = exp.modeled_activities(tv).numpy()
    roots = exp.network.calculate_multiroot(tv, torch.ones(2, dtype=torch.float64),
                                            torch.full((2,), float("nan"),
                                                       dtype=torch.float64)).numpy()
    np.testing.assert_array_equal(stored[0], roots[np.argmin(np.abs(roots[:, 0] - 0.057))])
    assert stored[0, 0] < 0.2
    single = exp.network.calculate(tv, torch.ones(2, dtype=torch.float64),
                                   torch.full((2,), float("nan"), dtype=torch.float64))
    lp_single = exp._data_logp(single[None, None, None], torch.ones(1, 1, 1, 2,
                                                                    dtype=torch.float64),
                               tv[None, None, None])
    lp_best = float(p.lik.log_prob_batched(tv[None])[0])
    assert lp_best > float(lp_single) + 100.0
    np.testing.assert_allclose(lp_best, p.ref[0], rtol=RTOL)


def test_first_max_index_is_argmax():
    """Ties, NaN and -inf pick what jnp.argmax picks."""
    x = np.array([[1.0, 3.0, 3.0, 2.0], [np.nan, 1.0, np.nan, 5.0], [1.0, np.nan, 7.0, 7.0],
                  [-np.inf, -np.inf, -np.inf, -np.inf], [-np.inf, 0.5, 0.5, -np.inf]])
    np.testing.assert_array_equal(first_max_index(torch.as_tensor(x)).numpy(),
                                  np.asarray(jnp.argmax(jnp.asarray(x), axis=-1)))


def test_multiroot_solves_attribute(tmp_path):
    """multiroot_solves="4" gives 4 starts; without feedback one solve."""
    lik, values = chip_smoke.fisa_model(str(tmp_path / "b"), "bistable", multiroot_solves=4)
    net = lik.model.experiments[0].network
    assert net.multiroot_solves == 4
    acts = net.calculate_multiroot(torch.as_tensor(values), torch.ones(2, dtype=torch.float64),
                                   torch.full((2,), float("nan"), dtype=torch.float64))
    assert acts.shape == (4, 2)
    lik2, values = chip_smoke.fisa_model(str(tmp_path / "a"), "network", feedback=False)
    exp = lik2.model.experiments[0]
    tv = lik2.model._transform(torch.as_tensor(values)[None])
    preset, expression = exp._prepare(tv)
    out = exp.network.calculate_multiroot(tv[:, None, :], expression, preset)
    assert out.shape[-2] == 1


@pytest.mark.parametrize("name", ["acyclic", "incucyte_relative"])
def test_accessors_match_jax(pairs, name):
    """observed_data, modeled_activities and modeled_data, one row and a
    batch, against the JAX package's on every experiment and data part
    (the JAX accessors run eagerly: the networks without a Newton solve)."""
    p = pairs(name)
    rows = p.rows[:3]
    tv = p.lik.model._transform(torch.as_tensor(rows))
    jtv = jax.vmap(p.jlik.model._transform)(rows)
    for exp, jexp in zip(p.lik.model.experiments, p.jlik.model.experiments):
        if hasattr(exp, "drug_concentrations"):
            nd = 2 * len(exp.drug_concentrations)
        else:
            nd = len(exp.data_parts)
        for k in range(nd):
            np.testing.assert_array_equal(exp.observed_data(k), jexp.observed_data(k))
        refs = jax.jit(jax.vmap(lambda v, jexp=jexp: [jexp.modeled_activities(v)] + [
            jexp.modeled_data(v, k) for k in range(nd)]))(jtv)
        got = [exp.modeled_activities(tv)] + [exp.modeled_data(tv, k) for k in range(nd)]
        for a, ref in zip(got, refs):
            np.testing.assert_allclose(a.numpy(), np.asarray(ref), rtol=RTOL, atol=1e-14)
        # one row gives the batch's first row, without the batch axis
        np.testing.assert_array_equal(exp.modeled_activities(tv[0]).numpy(), got[0][0].numpy())
        if nd:
            np.testing.assert_array_equal(exp.modeled_data(tv[0], nd - 1).numpy(),
                                          got[-1][0].numpy())


def test_file_and_memory_data_agree(pairs):
    """The likelihood built from its HDF5 data file equals the one built
    from `_data`."""
    p = pairs("network")
    from_file = create_likelihood(p.path, chip_smoke.fisa_varset("network"))
    assert isinstance(from_file.model, FISALikelihood)
    rows = torch.as_tensor(p.rows[:8])
    np.testing.assert_array_equal(from_file.log_prob_batched(rows).numpy(),
                                  p.lik.log_prob_batched(rows).numpy())


def test_float32_finite_rows_match_jax(pairs):
    """In float32 the drug signal's 1e-300 floor rounds to 0; the act == 0
    masks keep such rows finite, and the port's float32 rows are finite
    exactly where the JAX package's float32 rows are."""
    p = pairs("acyclic")
    rows = np.concatenate([p.rows, p.rows[:8] * 40.0]).astype(np.float32)
    got = p.port(rows, torch.float32)
    with jax.enable_x64(False):
        ref = np.asarray(jax.jit(jax.vmap(p.jlik.log_prob))(rows))
    assert ref.dtype == np.float32
    assert np.array_equal(np.isfinite(got), np.isfinite(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-4)


def test_incucyte_at_the_fixture_values(pairs):
    """At the values whose analytic steady states centre the mixture table
    (tests/test_fisa.py's oracle setup) the incucyte-sequential
    log-density, absolute, relative and with a NaN pair, equals the JAX
    package's, and the NaN pair's contribution is dropped."""
    for name in ("incucyte", "incucyte_relative", "incucyte_nan_pair"):
        p = pairs(name)
        got = float(p.lik.log_prob_batched(torch.as_tensor(p.values)[None])[0])
        np.testing.assert_allclose(got, p.ref[0], rtol=RTOL)
    full = float(pairs("incucyte").ref[0])
    skipped = float(pairs("incucyte_nan_pair").ref[0])
    assert np.isfinite(skipped) and skipped != full


@pytest.mark.parametrize("d", [2, 3, 5, 17])
def test_unrolled_solve_matches_jax(d):
    """The no-pivot LU over lanes against the JAX package's `_unrolled_solve`
    on diagonally dominant systems (d > 16: both packages' dense solve)."""
    from bcm3_tpu.fisa.network import _unrolled_solve as jax_solve
    from bcm3_tpu_torch.fisa.network import _unrolled_solve

    rng = np.random.default_rng(d)
    A = rng.normal(size=(6, d, d)) + d * np.eye(d)
    b = rng.normal(size=(6, d))
    got = _unrolled_solve(torch.as_tensor(A), torch.as_tensor(b)).numpy()
    ref = np.stack([np.asarray(jax_solve(jnp.asarray(A[i]), jnp.asarray(b[i])))
                    for i in range(6)])
    np.testing.assert_allclose(got, ref, rtol=1e-13, atol=1e-14)
    np.testing.assert_allclose(np.einsum("lij,lj->li", A, got), b, rtol=1e-10, atol=1e-12)
