"""The port's PT sampler against the JAX package on PopPK `one`.

- Step-exact: both packages start from the same state (the JAX package's,
  carried over by bcm3_tpu_torch.convert) and take two iterations
  (exchange + mutate) with the same random numbers, rebuilt from the JAX
  key in the JAX package's own split structure (pt.py:594-606, 727, 809,
  873-878). Chain positions, log-priors and log-likelihoods agree to rtol
  1e-10 in float64; counters and component picks are equal.
- Statistical: a short run() of each package at 64 ensembles; the
  per-temperature mutate and exchange acceptance rates agree within 4
  binomial standard errors (the random streams differ: threefry vs Philox).
- The port's output.nc loads through the JAX package's reader with the
  same dims as the JAX package's own.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bcm3_tpu.io.output import SampleHandlerHDF5 as JHandler
from bcm3_tpu.io.output import load_results
from bcm3_tpu.likelihoods import create_likelihood as jax_create_likelihood
from bcm3_tpu.model.prior import Prior as JPrior
from bcm3_tpu.model.variables import VariableSet as JVariableSet
from bcm3_tpu.sampler import PTConfig as JPTConfig
from bcm3_tpu.sampler import SamplerPT as JSamplerPT
from bcm3_tpu_torch import Prior, VariableSet, create_likelihood, convert
from bcm3_tpu_torch.io.output import SampleHandlerHDF5
from bcm3_tpu_torch.likelihoods.poppk_synth import (
    synthesize_trial,
    write_poppk_likelihood_xml,
    write_poppk_prior_xml,
)
from bcm3_tpu_torch.sampler import PTConfig, SamplerPT
from bcm3_tpu_torch.sampler.pt import BlockDraws, IterationDraws, MutateDraws

F64 = jnp.float64


@pytest.fixture(scope="module")
def poppk_files(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("poppk"))
    P = 4
    trial, _ = synthesize_trial(num_patients=P, num_timepoints=10, seed=5)
    pk = os.path.join(d, "pkdata.nc")
    trial.save(pk, "TRIAL1", "lapatinib")
    write_poppk_prior_xml(os.path.join(d, "prior.xml"), P, "one")
    write_poppk_likelihood_xml(
        os.path.join(d, "likelihood.xml"), pk, "TRIAL1", "lapatinib", "one"
    )
    return d


def _samplers(d, **cfg):
    prior_xml, lik_xml = os.path.join(d, "prior.xml"), os.path.join(d, "likelihood.xml")
    jvs = JVariableSet.from_xml(prior_xml)
    js = JSamplerPT(
        JPrior.from_xml(prior_xml, jvs), jax_create_likelihood(lik_xml, jvs),
        JPTConfig(**cfg),
    )
    vs = VariableSet.from_xml(prior_xml)
    ps = SamplerPT(
        Prior.from_xml(prior_xml, vs), create_likelihood(lik_xml, vs),
        PTConfig(**cfg, device="cpu", dtype=torch.float64),
    )
    return js, ps


_SMALL = dict(
    num_chains=4, num_ensembles=4, num_samples=4, use_every_nth=1,
    adapt_proposal_samples=0, adapt_proposal_times=0, seed=11,
)


def _jax_draws(js, key, proposals):
    """The random numbers of JAX SamplerPT._iteration(key) (deterministic
    even/odd scheme), rebuilt from the key for the port's `draws`."""
    C = js.num_chains
    t = lambda a: torch.as_tensor(np.array(a))  # noqa: E731
    k_exc, k_mut = jax.random.split(key)
    mutate = []
    for ei in range(js.config.num_exploration_steps):
        k_prior, kb_root = jax.random.split(jax.random.fold_in(k_mut, ei))
        prior = js.prior.sample(k_prior, (C,)).astype(F64)
        blocks = []
        for bi, block in enumerate(js.blocks):
            K = proposals[bi].max_components
            k_upd, k_prop, k_acc = jax.random.split(jax.random.fold_in(kb_root, bi), 3)
            u_scale = jax.vmap(lambda k: jax.random.uniform(k, dtype=F64))(
                jax.random.split(k_upd, C)
            )

            def per_lane(k):
                kk, kz, _ = jax.random.split(k, 3)
                return (
                    jax.random.gumbel(kk, (K,), F64),
                    jax.random.normal(kz, (len(block),), F64),
                )

            gumbel, z = jax.vmap(per_lane)(jax.random.split(k_prop, C))
            u_acc = jax.random.uniform(jax.random.fold_in(k_acc, 1), (C,), dtype=F64)
            blocks.append(BlockDraws(t(u_scale), t(gumbel), t(z), t(u_acc)))
        mutate.append(MutateDraws(t(prior), blocks))
    exchange_u = jax.random.uniform(k_exc, (C,), dtype=F64)
    return IterationDraws(t(exchange_u), mutate)


def _port_state(jstate):
    arrays = {f: np.asarray(getattr(jstate, f)) for f in convert.STATE_FIELDS}
    return convert.pt_state_from_arrays(arrays, "cpu", torch.float64)


def _port_proposal(jp):
    return convert.block_proposal_from_arrays(
        {f: np.asarray(getattr(jp, f)) for f in convert.PROPOSAL_FIELDS},
        {m: getattr(jp, m) for m in convert.PROPOSAL_META + ("clustered",)},
        "cpu",
        torch.float64,
    )


def test_iterations_step_exact(poppk_files):
    js, ps = _samplers(poppk_files, **_SMALL)
    jstate = js._init_state()
    jprops = tuple(js.proposals)
    pstate = _port_state(jstate)
    pprops = [_port_proposal(p) for p in jprops]
    jax_iteration = jax.jit(lambda carry, key: js._iteration(carry, key))
    for it in range(2):  # both exchange parities
        key = jax.random.PRNGKey(100 + it)
        draws = _jax_draws(js, key, jprops)
        jstate, jprops = jax_iteration((jstate, jprops), key)
        pstate, pprops = ps._iteration(pstate, pprops, draws)

        for f in ("x", "lprior", "llh"):
            np.testing.assert_allclose(
                getattr(pstate, f).numpy(), np.asarray(getattr(jstate, f)),
                rtol=1e-10, err_msg=f"{f}, iteration {it}",
            )
        for f in ("att_mut", "acc_mut", "att_exc", "acc_exc"):
            np.testing.assert_array_equal(
                getattr(pstate, f).numpy(), np.asarray(getattr(jstate, f)), err_msg=f
            )
        assert pstate.swap_parity == int(jstate.swap_parity)
        assert pstate.hist_adds == int(jstate.hist_adds)
        np.testing.assert_allclose(
            pstate.history.numpy(), np.asarray(jstate.history), rtol=1e-6
        )
        for pp, jp in zip(pprops, jprops):
            np.testing.assert_array_equal(pp.selected.numpy(), np.asarray(jp.selected))
            np.testing.assert_allclose(pp.scales.numpy(), np.asarray(jp.scales), rtol=1e-12)
            np.testing.assert_allclose(pp.acc_ema.numpy(), np.asarray(jp.acc_ema), rtol=1e-12)
    # the moves did something: some mutations and some swaps were accepted
    assert 0 < int(pstate.acc_mut.sum()) < int(pstate.att_mut.sum())
    assert int(pstate.att_exc.sum()) > 0


# ---------------------------------------------------------------------------
# Short runs of both packages


_RUN = dict(
    num_chains=4, num_ensembles=64, num_samples=30, use_every_nth=2,
    adapt_proposal_samples=0, adapt_proposal_times=0, emit_fixed_only=True,
)


@pytest.fixture(scope="module")
def short_runs(poppk_files, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("runs"))
    js, ps = _samplers(poppk_files, seed=21, **_RUN)
    results = {}
    for name, s, handler_cls in (("jax", js, JHandler), ("port", ps, SampleHandlerHDF5)):
        path = os.path.join(out, f"{name}_output.nc")
        with handler_cls(
            path, s.expected_emitted_samples, s.prior.varset.names,
            s.prior.varset.transforms, s.emit_ladder,
        ) as h:
            s.sample_handlers = [h]
            res = s.run()
        results[name] = (res, path)
    return results


def _rates(acc):
    L = _RUN["num_chains"]
    out = {}
    for move in ("mutate", "exchange"):
        att = acc[f"attempted_{move}"].astype(np.float64).reshape(-1, L).sum(0)
        ok = acc[f"accepted_{move}"].astype(np.float64).reshape(-1, L).sum(0)
        out[move] = (ok, att)
    return out


@pytest.mark.parametrize("move", ["mutate", "exchange"])
def test_short_run_acceptance_matches_jax(short_runs, move):
    (jres, _), (pres, _) = short_runs["jax"], short_runs["port"]
    jok, jatt = _rates(jres["acceptance"])[move]
    pok, patt = _rates(pres["acceptance"])[move]
    np.testing.assert_array_equal(patt, jatt)  # same number of attempts
    pj, pp = jok / np.maximum(jatt, 1), pok / np.maximum(patt, 1)
    pooled = (jok + pok) / np.maximum(jatt + patt, 1)
    se = np.sqrt(pooled * (1 - pooled) * (1 / np.maximum(jatt, 1) + 1 / np.maximum(patt, 1)))
    assert np.all(np.abs(pp - pj) <= 4 * se + 1e-12), (move, pj, pp, se)
    if move == "mutate":
        assert pp[-1] > 0.0 and pp[-1] < 1.0  # the T=1 chain moves, not always
        assert pp[0] == 1.0  # the T=0 chain takes every prior draw


def test_short_run_output_loads_like_jax(short_runs):
    (jres, jpath), (pres, ppath) = short_runs["jax"], short_runs["port"]
    jout, pout = load_results(jpath), load_results(ppath)
    for k in ("samples", "log_prior", "log_likelihood", "weights", "temperatures"):
        assert pout[k].shape == jout[k].shape, k
    assert pout["variables"] == jout["variables"]
    np.testing.assert_array_equal(pout["variable_transform"], jout["variable_transform"])
    E, S = _RUN["num_ensembles"], _RUN["num_samples"]
    assert pout["samples"].shape == (S * E, 1, jres["samples"].shape[-1])
    # the file holds what run() returned, and every emitted row is a
    # finite-posterior state
    np.testing.assert_allclose(pout["samples"], pres["samples"].astype(np.float64))
    assert np.isfinite(pout["log_prior"] + pout["log_likelihood"]).all()
    assert pres["evaluations"] == int(pres["acceptance"]["attempted_mutate"].sum())


@pytest.mark.parametrize(
    "override,item",
    [
        (dict(adapt_proposal_samples=2, adapt_proposal_times=1), "A6"),
        (dict(proposal_type="clustered_covariance"), "A6"),
        (dict(swapping_scheme="stochastic_even_odd"), "A3"),
        (dict(checkpoint_file="ckpt.npz"), "A7"),
        (dict(proposal_t_dof=5.0), "A6"),
    ],
)
def test_unported_options_raise(poppk_files, override, item):
    cfg = dict(_SMALL, **override)
    prior_xml = os.path.join(poppk_files, "prior.xml")
    vs = VariableSet.from_xml(prior_xml)
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        SamplerPT(
            Prior.from_xml(prior_xml, vs),
            create_likelihood(os.path.join(poppk_files, "likelihood.xml"), vs),
            PTConfig(**cfg, device="cpu", dtype=torch.float64),
        )


def test_config_runs_on_the_card_unless_asked():
    """The sampler's entry point runs on the card by default; the CPU is
    an explicit choice (as every CPU test here makes it)."""
    assert PTConfig().device == "cuda"
    assert PTConfig(device="cpu").device == "cpu"
