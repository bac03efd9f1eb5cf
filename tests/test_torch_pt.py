"""The port's PT sampler against the JAX package on PopPK `one`.

- Step-exact: both packages start from the same state (the JAX package's,
  carried over by bcm3_tpu_torch.convert) and take two iterations
  (exchange + mutate) with the same random numbers, rebuilt from the JAX
  key in the JAX package's own split structure (pt.py:594-606, 727, 809,
  873-878). Chain positions, log-priors and log-likelihoods agree to rtol
  1e-10 in float64; counters and component picks are equal.
  The stochastic swap schemes are stepped the same way, through both the
  exchange and the mutate branch.
- Adaptation boundary: both samplers, given the same history and seed,
  downsample the same rows and build the same proposal arrays (host EM
  and global covariance to rtol 1e-12, the batched EM to rtol 1e-8); with
  clustering, Turek and clustered_autoblock blocking and the MFA fit they
  also fit the same clustering, label the same rows, make the same blocks
  (rtol 1e-10) and leave the host RNG in the same state. A history that
  cannot be clustered degrades clustered proposals to one covariance in
  both. Clustered iterations are stepped like the others, both packages
  assigning with the same ClusterAssigner.
- Statistical: short run()s of each package at 64 ensembles, unadapted and
  adapted under each swap scheme and with clustered proposals; the
  per-temperature mutate and exchange
  acceptance rates agree within 4 binomial standard errors (the random
  streams differ: threefry vs Philox).
- The port's output.nc loads through the JAX package's reader with the
  same dims as the JAX package's own.
"""

import dataclasses
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
from bcm3_tpu.sampler.pt import PTState as JPTState
from bcm3_tpu_torch import Prior, VariableSet, create_likelihood, convert
from bcm3_tpu_torch.io.output import SampleHandlerHDF5
from bcm3_tpu_torch.likelihoods.poppk_synth import (
    synthesize_trial,
    write_poppk_likelihood_xml,
    write_poppk_prior_xml,
)
from bcm3_tpu_torch.sampler import PTConfig, SamplerPT, spectral
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


def _t(a):
    return torch.as_tensor(np.array(a))


def _jax_mutate_draws(js, key, proposals):
    """The random numbers of JAX SamplerPT._mutate(key)."""
    C = js.num_chains
    k_prior, kb_root = jax.random.split(key)
    prior = js.prior.sample(k_prior, (C,)).astype(F64)
    blocks = []
    for bi, block in enumerate(js.blocks):
        prop = proposals[bi]
        K, nu = prop.max_components, prop.t_dof
        k_upd, k_prop, k_acc = jax.random.split(jax.random.fold_in(kb_root, bi), 3)
        u_scale = jax.vmap(lambda k: jax.random.uniform(k, dtype=F64))(
            jax.random.split(k_upd, C)
        )

        def per_lane(k):
            # kk, kz, kg = split(key, 3); a clustered proposal draws no
            # component: kz, kg = split(key) (proposal.py:282, 352)
            if prop.clustered:
                kk, (kz, kg) = None, jax.random.split(k)
            else:
                kk, kz, kg = jax.random.split(k, 3)
            return (
                jnp.zeros(K, F64) if kk is None else jax.random.gumbel(kk, (K,), F64),
                jax.random.normal(kz, (len(block),), F64),
                jax.random.gamma(kg, 0.5 * max(nu, 1.0), dtype=F64),
            )

        gumbel, z, gamma = jax.vmap(per_lane)(jax.random.split(k_prop, C))
        u_acc = jax.random.uniform(jax.random.fold_in(k_acc, 1), (C,), dtype=F64)
        blocks.append(BlockDraws(
            _t(u_scale), None if prop.clustered else _t(gumbel), _t(z), _t(u_acc),
            _t(gamma) if nu > 0.0 else None,
        ))
    return MutateDraws(_t(prior), blocks)


def _jax_draws(js, key, proposals):
    """The random numbers of JAX SamplerPT._iteration(key), rebuilt from
    the key for the port's `draws` (pt.py:849-882)."""
    C, L = js.num_chains, js.ladder_size
    if js.config.swapping_scheme in ("stochastic_even_odd", "stochastic_random"):
        k_choice, k_move = jax.random.split(key)
        choice_u = float(jax.random.uniform(k_choice, dtype=F64))
        if choice_u >= js.config.exchange_probability:
            return IterationDraws(
                None, [_jax_mutate_draws(js, k_move, proposals)], choice_u=choice_u
            )
        pair = jax.random.randint(
            jax.random.fold_in(k_move, 7), (js.num_ensembles,), 0, max(L - 1, 1)
        )
        exchange_u = jax.random.uniform(k_move, (C,), dtype=F64)
        return IterationDraws(_t(exchange_u), choice_u=choice_u, pair=_t(pair).long())
    k_exc, k_mut = jax.random.split(key)
    mutate = [
        _jax_mutate_draws(js, jax.random.fold_in(k_mut, ei), proposals)
        for ei in range(js.config.num_exploration_steps)
    ]
    exchange_u = jax.random.uniform(k_exc, (C,), dtype=F64)
    return IterationDraws(_t(exchange_u), mutate)


def _port_state(jstate):
    arrays = {f: np.asarray(getattr(jstate, f)) for f in convert.STATE_FIELDS}
    return convert.pt_state_from_arrays(arrays, "cpu", torch.float64)


def _port_proposal(jp):
    return convert.block_proposal_from_arrays(
        {f: np.asarray(getattr(jp, f)) for f in convert.PROPOSAL_FIELDS},
        {m: getattr(jp, m) for m in convert.PROPOSAL_META},
        "cpu",
        torch.float64,
    )


@pytest.mark.parametrize(
    "scheme,keys",
    [
        ("deterministic_even_odd", (100, 101)),  # both exchange parities
        # keys whose choice uniform takes each branch, exchange at both parities
        ("stochastic_even_odd", (100, 101, 103, 104)),
        ("stochastic_random", (100, 101, 103, 104)),
    ],
)
def test_iterations_step_exact(poppk_files, scheme, keys):
    js, ps = _samplers(poppk_files, **dict(_SMALL, swapping_scheme=scheme))
    jstate = js._init_state()
    jprops = tuple(js.proposals)
    pstate = _port_state(jstate)
    pprops = [_port_proposal(p) for p in jprops]
    jax_iteration = jax.jit(lambda carry, key: js._iteration(carry, key))
    branches = set()
    for it, seed in enumerate(keys):
        key = jax.random.PRNGKey(seed)
        draws = _jax_draws(js, key, jprops)
        branches.add(draws.exchange_u is not None)
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
    # both moves ran and did something: some mutations and swaps accepted
    assert branches == {True, False} or scheme == "deterministic_even_odd"
    assert 0 < int(pstate.acc_mut.sum()) < int(pstate.att_mut.sum())
    assert 0 < int(pstate.acc_exc.sum()) <= int(pstate.att_exc.sum())


@pytest.mark.parametrize("scheme", ["deterministic_even_odd", "stochastic_random"])
def test_history_sizing_matches_jax(poppk_files, scheme):
    """Only deterministic even/odd multiplies the expected history by the
    moves per iteration (pt.py:313-322)."""
    js, ps = _samplers(
        poppk_files, **dict(_SMALL, swapping_scheme=scheme, adapt_proposal_samples=700,
                            use_every_nth=3, max_history_size=1000)
    )
    assert (ps.history_size, ps.history_subsampling) == (js.history_size, js.history_subsampling)
    assert ps.history_subsampling == (5 if scheme == "deterministic_even_odd" else 3)


def test_run_leaves_the_proposals_as_they_were(poppk_files):
    """run() adapts per-chain scales in its own copy: self.proposals
    changes only at an adaptation, so every run starts from fresh scales,
    as in the JAX package."""
    _, ps = _samplers(poppk_files, **_SMALL)
    fields = ("scales", "acc_ema", "selected", "means", "chols")
    before = [{f: getattr(p, f).clone() for f in fields} for p in ps.proposals]
    ps.run()
    for p, b in zip(ps.proposals, before):
        for f in fields:
            assert torch.equal(getattr(p, f), b[f]), f
    # the run's own state did move
    assert not torch.equal(ps.state.att_mut, torch.zeros_like(ps.state.att_mut))


# ---------------------------------------------------------------------------
# The adaptation boundary


_ADAPT = dict(
    num_chains=4, num_ensembles=8, num_samples=60, use_every_nth=2,
    adapt_proposal_samples=25, adapt_proposal_times=2,
    adapt_proposal_max_history_samples=130, seed=13,
)


def _states_with_history(js, degenerate=False):
    """JAX and port states whose history is full: per chain H rows of a
    mixture of four Gaussians (one shared full covariance shape) whose
    spread grows along the ladder. 130 rows per position in D = 16 leave
    k <= 4 eligible. `degenerate`: every T=1 row alike, a history that
    cannot be clustered."""
    C, D, H = js.num_chains, js.num_variables, js.history_size
    rng = np.random.default_rng(4)
    centers = rng.normal(0.0, 3.0, (4, D))
    spread = 0.5 + 0.3 * (np.arange(C) % js.ladder_size)[:, None, None]
    shape = np.eye(D) + 0.3 * rng.normal(size=(D, D))
    rows = centers[rng.integers(0, 4, (C, H))] + spread * rng.normal(size=(C, H, D)) @ shape
    if degenerate:
        rows[js.ladder_size - 1 :: js.ladder_size] = 1.0
    zeros, counts = np.zeros(C), np.zeros(C, np.int32)
    arrays = dict(
        x=np.zeros((C, D)), lprior=zeros, llh=zeros, att_mut=counts, acc_mut=counts,
        att_exc=counts, acc_exc=counts,
        history=rows.reshape(C, H * D).astype(np.float32),
        hist_adds=np.int32(H), swap_parity=np.int32(0),
    )
    jstate = JPTState(**{k: jnp.asarray(v) for k, v in arrays.items()},
                      key=jax.random.PRNGKey(0))
    return jstate, convert.pt_state_from_arrays(arrays, "cpu", torch.float64)


def test_downsampled_history_matches_jax(poppk_files):
    """The same rows from the same host stream, gathered on the device from
    the flat buffer; and the port's gather equals its host path."""
    js, ps = _samplers(poppk_files, **_ADAPT)
    jstate, pstate = _states_with_history(js)
    count = js.history_size
    got = ps._ladder_downsampled_history(pstate, count)
    ref = js._ladder_downsampled_history(jstate, count)
    assert [len(h) for h in got] == [130] * 4  # 8 x 100 rows cut to 130
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, np.asarray(r))
    ps._host_rng = np.random.default_rng(13 ^ 0x9E3779B9)
    hist, n = ps._history_matrices(pstate)
    L, D = ps.ladder_size, ps.num_variables
    host = [ps._downsample_history(hist[i::L].reshape(-1, D)) for i in range(L)]
    for g, h in zip(got, host):
        np.testing.assert_array_equal(g, h)


_CLUSTERED = dict(
    proposal_type="clustered_covariance", adapt_proposal_max_clustering_samples=500,
    output_sample_clustering=True,
)


@pytest.mark.parametrize(
    "override,rtol",
    [
        (dict(gmm_fit_backend="host"), 1e-12),
        (dict(gmm_fit_backend="device"), 1e-8),
        (dict(proposal_type="global_covariance"), 1e-12),
        (dict(proposal_type="gaussian_mixture_adjustedAIC", gmm_fit_backend="device"), 1e-8),
        (dict(_CLUSTERED, blocking_strategy="clustered_autoblock"), 1e-10),
        (dict(_CLUSTERED, proposal_type="global_covariance",
              blocking_strategy="clustered_autoblock"), 1e-10),
        (dict(blocking_strategy="Turek", proposal_type="global_covariance"), 1e-10),
        # few rows, so that the MFA grid stays small
        (dict(proposal_type="gaussian_mixture_fit_in_r",
              adapt_proposal_max_history_samples=80), 1e-10),
    ],
    ids=["host_em", "device_em", "global_covariance", "adjusted_aic",
         "clustered_autoblock", "covariance_clustered_autoblock", "turek", "fit_in_r"],
)
def test_adapt_proposals_matches_jax(poppk_files, override, rtol):
    """The factors are held per (position, component) matrix, normwise:
    a fitted covariance with eigenvalues at the EM's 1e-8 floor has
    factors whose small entries move by its condition number times the
    EM's last-bit differences. The batched EM's k selection matches on
    this history; on others the two eighs' rounding can flip a singular
    flag (see tests/test_torch_gmm.py). Where the boundary clusters, both
    fit the same clustering and label the pooled history alike (the
    clustering dump), and where it re-blocks, both make the same blocks."""
    js, ps = _samplers(poppk_files, **dict(_ADAPT, **override))
    jstate, pstate = _states_with_history(js)
    jstate, jrecord = js._adapt_proposals(jstate)
    pstate, precord = ps._adapt_proposals(pstate)
    assert pstate.hist_adds == int(jstate.hist_adds) == 0
    assert [b.tolist() for b in ps.blocks] == [np.asarray(b).tolist() for b in js.blocks]
    assert ps._host_rng.bit_generator.state == js._host_rng.bit_generator.state
    assert len(ps.clustering_dumps) == len(js.clustering_dumps)
    for (pi, pdump), (ji, jdump) in zip(ps.clustering_dumps, js.clustering_dumps):
        assert pi == ji and set(pdump) == set(jdump)
        for k in jdump:
            np.testing.assert_array_equal(pdump[k], jdump[k], err_msg=k)
    if "clustered" in override.get("blocking_strategy", override.get("proposal_type", "")):
        assert ps._assigner.num_clusters == 4 and len(ps.clustering_dumps) == 1
        for f in convert.ASSIGNER_FIELDS:
            np.testing.assert_array_equal(
                getattr(ps._assigner, f).numpy(), np.asarray(getattr(js._assigner, f)), err_msg=f
            )
        sizes = ps.adaptation_timings[-1]["cluster_sizes"]
        assert sum(sizes) == 8 * js.history_size and min(sizes) > 0
    if override.get("blocking_strategy") in ("Turek", "clustered_autoblock"):
        assert 1 < len(ps.blocks) < ps.num_variables  # the history's correlations block
    assert [g.num_components for _, g in precord] == [g.num_components for _, g in jrecord]
    for pp, jp in zip(ps.proposals, js.proposals):
        assert (pp.t_dof, pp.target_accept, pp.update_rule, pp.symmetric, pp.clustered) == (
            jp.t_dof, jp.target_accept, jp.update_rule, jp.symmetric, jp.clustered
        )
        for f in convert.PROPOSAL_FIELDS:
            a, b = getattr(pp, f).numpy(), np.asarray(getattr(jp, f))
            np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b), err_msg=f)
            if f in ("chols", "inv_chols"):
                err = np.linalg.norm(a - b, axis=(-2, -1)) / np.linalg.norm(b, axis=(-2, -1))
                assert err.max() <= rtol * np.linalg.cond(b).max(), (f, err.max())
            else:
                np.testing.assert_allclose(a[np.isfinite(b)], b[np.isfinite(b)], rtol=rtol,
                                           atol=rtol * 1e-4, err_msg=f)
    # the fits found structure: some position has more than one component
    if override.get("proposal_type") != "global_covariance":
        assert max(p.max_components for p in ps.proposals) > 1
    else:
        assert all(p.symmetric for p in ps.proposals)
    timing = ps.adaptation_timings[-1]
    assert set(timing) >= {
        "t1_pull_seconds", "spectral_fit_seconds", "labelling_seconds", "blocking_seconds",
        "gather_seconds", "fit_seconds", "build_seconds", "components", "block_sizes",
    }


def test_failed_clustering_degrades_to_global_covariance(poppk_files):
    """A T=1 history without spread fits no clustering: both packages build
    one covariance per position instead (pt.py:1254-1259), keep no dump
    and count the clustering iteration."""
    js, ps = _samplers(poppk_files, **dict(_ADAPT, **_CLUSTERED))
    jstate, pstate = _states_with_history(js, degenerate=True)
    js._adapt_proposals(jstate)
    ps._adapt_proposals(pstate)
    assert ps._assigner is None and js._assigner is None
    assert ps.clustering_iteration == js.clustering_iteration == 1
    assert ps.clustering_dumps == [] == js.clustering_dumps
    assert "cluster_sizes" not in ps.adaptation_timings[-1]
    for pp, jp in zip(ps.proposals, js.proposals):
        assert pp.symmetric and jp.symmetric and not (pp.clustered or jp.clustered)
        assert pp.update_rule == jp.update_rule == 1
        for f in ("means", "chols", "log_c"):
            np.testing.assert_allclose(getattr(pp, f).numpy(), np.asarray(getattr(jp, f)),
                                       rtol=1e-12, atol=1e-12, err_msg=f)
    assert ps._host_rng.bit_generator.state == js._host_rng.bit_generator.state


@pytest.mark.parametrize("t_dof", [0.0, 5.0], ids=["gaussian", "t"])
def test_clustered_iterations_step_exact(poppk_files, t_dof):
    """Clustered iterations (exchange + mutate) from the same state, with
    the JAX package's clustering carried across: each mutate assigns the
    current and the proposed positions to clusters and draws the step from
    the current cluster's covariance. The clustering is fitted by the JAX
    package on a history of prior draws, so the chains start in several
    clusters and some moves cross between them."""
    cfg = dict(_SMALL, proposal_type="clustered_covariance", adapt_proposal_samples=25,
               adapt_proposal_times=1, sample_clustering_num_clusters=3, proposal_t_dof=t_dof)
    js, ps = _samplers(poppk_files, **cfg)
    jstate = js._init_state()
    C, D, H = js.num_chains, js.num_variables, js.history_size
    prior_rows = np.asarray(js.prior.sample(jax.random.PRNGKey(3), (C * H,)), np.float32)
    jstate = dataclasses.replace(
        jstate, history=jnp.asarray(prior_rows.reshape(C, H * D)), hist_adds=jnp.int32(H)
    )
    jstate, _ = js._adapt_proposals(jstate)
    jprops, jasg = tuple(js.proposals), js._assigner
    assert jasg is not None and all(p.clustered for p in jprops)
    pstate = _port_state(jstate)
    pprops = [_port_proposal(p) for p in jprops]
    ps._set_blocks(js.blocks)
    ps._assigner = convert.cluster_assigner_from_arrays(
        {f: np.asarray(getattr(jasg, f)) for f in convert.ASSIGNER_FIELDS},
        {m: getattr(jasg, m) for m in convert.ASSIGNER_META}, "cpu",
    )
    clusters = set()
    jax_iteration = jax.jit(lambda carry, key, a: js._iteration(carry, key, a))
    for it, seed in enumerate((100, 101, 102)):
        key = jax.random.PRNGKey(seed)
        draws = _jax_draws(js, key, jprops)
        clusters |= set(spectral.assign_batch(ps._assigner, pstate.x).tolist())
        jstate, jprops = jax_iteration((jstate, jprops), key, jasg)
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
        for pp, jp in zip(pprops, jprops):
            np.testing.assert_array_equal(pp.selected.numpy(), np.asarray(jp.selected))
            np.testing.assert_allclose(pp.scales.numpy(), np.asarray(jp.scales), rtol=1e-12)
            np.testing.assert_allclose(pp.acc_ema.numpy(), np.asarray(jp.acc_ema), rtol=1e-12)
    assert len(clusters) > 1
    assert 0 < int(pstate.acc_mut.sum()) < int(pstate.att_mut.sum())


_OPTIONS = [
    ("proposal_type", p)
    for p in ("gaussian_mixture", "parametric_mixture", "gaussian_mixture_adjustedAIC",
              "gaussian_mixture_fit_in_r", "global_covariance", "clustered_covariance")
] + [("blocking_strategy", b) for b in ("one_block", "no_blocking", "Turek", "clustered_autoblock")]


@pytest.mark.parametrize("option,value", _OPTIONS, ids=[v for _, v in _OPTIONS])
def test_every_jax_option_is_accepted(poppk_files, option, value):
    """Every proposal type and blocking strategy of the JAX package builds
    a sampler with the same resolved proposal type, starting blocks and
    initial proposals; `parametric_mixture` is the legacy alias of
    `gaussian_mixture` (pt.py:277-279)."""
    js, ps = _samplers(poppk_files, **dict(_SMALL, **{option: value}))
    assert ps.proposal_type == js.proposal_type
    if value in ("parametric_mixture", "gaussian_mixture_fit_in_r"):
        assert ps.proposal_type == "gaussian_mixture"
    assert [b.tolist() for b in ps.blocks] == [np.asarray(b).tolist() for b in js.blocks]
    assert len(ps.proposals) == len(js.proposals)
    for pp, jp in zip(ps.proposals, js.proposals):
        for m in convert.PROPOSAL_META:
            assert getattr(pp, m) == getattr(jp, m), m
        for f in ("means", "chols", "log_c"):
            np.testing.assert_allclose(getattr(pp, f).numpy(), np.asarray(getattr(jp, f)),
                                       rtol=1e-12, err_msg=f)


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


_ADAPTED_RUN = dict(
    _RUN, num_samples=30, adapt_proposal_samples=10, adapt_proposal_times=2,
    gmm_fit_backend="host",
)
# One run per package cannot see the run-to-run spread of a GMM fit: the
# selected component count differs between runs (8 or 13 at T=1 here) and
# moves T=1 mutate acceptance by about +-0.04 in either package (under
# stochastic_random, seeds 23-26 on this model: JAX 0.29-0.37, the port
# 0.27-0.40). So GMM adaptation runs under the deterministic scheme, and
# the stochastic schemes adapt one covariance, whose fit hardly varies
# between runs.
_SCHEMES = [
    ("deterministic_even_odd", "gaussian_mixture"),
    ("stochastic_even_odd", "global_covariance"),
    ("stochastic_random", "global_covariance"),
]


@pytest.fixture(scope="module")
def light_tailed_files(poppk_files, tmp_path_factory):
    """The same model with uniform priors in place of the half-Cauchy
    population sds. Under the half-Cauchy the low-temperature chains draw
    outliers that decide the fitted covariances there, so acceptance after
    an adaptation varies from seed to seed far beyond binomial error, in
    either package alike."""
    d = str(tmp_path_factory.mktemp("poppk_light"))
    with open(os.path.join(poppk_files, "prior.xml")) as f:
        text = f.read()
    with open(os.path.join(d, "prior.xml"), "w") as f:
        light = text.replace('distribution="half_cauchy" scale="0.3"',
                             'distribution="uniform" lower="0.0" upper="1.0"')
        assert light.count('"uniform"') == text.count('"uniform"') + 2
        f.write(light)
    with open(os.path.join(poppk_files, "likelihood.xml")) as f:
        text = f.read()
    with open(os.path.join(d, "likelihood.xml"), "w") as f:
        f.write(text)
    return d


@pytest.fixture(scope="module", params=_SCHEMES, ids=[s for s, _ in _SCHEMES])
def adapted_runs(request, light_tailed_files):
    """Adapted runs of both packages under one swap scheme, then a second
    run() of each sampler."""
    scheme, ptype = request.param
    js, ps = _samplers(
        light_tailed_files, seed=23,
        **dict(_ADAPTED_RUN, swapping_scheme=scheme, proposal_type=ptype),
    )
    first = {"jax": js.run(), "port": ps.run()}
    second = {"jax": js.run(), "port": ps.run()}
    return scheme, ps, first, second


def _ensemble_rates(acc, move):
    """Per-temperature acceptance as the mean over ensembles of each
    ensemble's rate, and its standard error over the ensembles: the
    ensembles are independent replicas, while one chain's attempts are
    correlated from iteration to iteration, so a binomial error over all
    attempts would be too small. Positions that never attempt (the top of
    a stochastic_random ladder never leads an exchange) give 0 and 0."""
    L = _RUN["num_chains"]
    att = acc[f"attempted_{move}"].astype(np.float64).reshape(-1, L)
    ok = acc[f"accepted_{move}"].astype(np.float64).reshape(-1, L)
    rate = np.where(att > 0, ok / np.maximum(att, 1), 0.0)
    return rate.mean(0), rate.std(0, ddof=1) / np.sqrt(len(rate))


@pytest.mark.parametrize("move", ["mutate", "exchange"])
def test_adapted_run_acceptance_matches_jax(adapted_runs, move):
    """Adapted runs: per-temperature acceptance of the two packages within
    4 standard errors of their difference, each error taken over 64
    independent ensembles."""
    scheme, _, first, _ = adapted_runs
    pj, sj = _ensemble_rates(first["jax"]["acceptance"], move)
    pp, sp = _ensemble_rates(first["port"]["acceptance"], move)
    se = np.sqrt(sj**2 + sp**2)
    assert np.all(np.abs(pp - pj) <= 4 * se + 1e-12), (scheme, move, pj, pp, se)
    if move == "mutate":
        assert 0.0 < pp[-1] < 1.0 and pp[0] == 1.0
    else:
        assert (pp[:-1] > 0).all()


def test_adapted_runs_cross_their_boundaries_once(adapted_runs):
    """adapt_proposal_times boundaries in the first run(), none in the
    second, which starts from the adapted proposals with fresh scales."""
    _, ps, first, second = adapted_runs
    for name in ("jax", "port"):
        assert first[name]["adaptation_boundaries"] == 2, name
        assert second[name]["adaptation_boundaries"] == 0, name
        assert len(first[name]["adaptation_records"]) == 2
    assert ps.adaptations_done == 2
    breakdown = first["port"]["adaptation_breakdown"]
    assert len(breakdown) == 2 and breakdown[0]["components"][0] == 1  # T=0: prior fallback
    d = ps.num_variables
    for p in ps.proposals:
        torch.testing.assert_close(p.scales, torch.full_like(p.scales, 2.38 / np.sqrt(d)))
    for res in (first["port"], second["port"]):
        assert np.isfinite(res["log_prior"] + res["log_likelihood"]).all()
        assert res["samples"].shape == (30 * 64, 1, d)


@pytest.fixture(scope="module")
def clustered_runs(light_tailed_files):
    """A clustered_covariance run of each package with two adaptations,
    and a second run() of the port's sampler."""
    js, ps = _samplers(
        light_tailed_files, seed=23, **dict(_ADAPTED_RUN, proposal_type="clustered_covariance")
    )
    return ps, {"jax": js.run(), "port": ps.run()}, ps.run()


@pytest.mark.parametrize("move", ["mutate", "exchange"])
def test_clustered_run_acceptance_matches_jax(clustered_runs, move):
    """Clustered proposals after two boundaries: per-temperature acceptance
    of the two packages within 4 standard errors of their difference, as
    for the other adapted runs."""
    _, first, _ = clustered_runs
    pj, sj = _ensemble_rates(first["jax"]["acceptance"], move)
    pp, sp = _ensemble_rates(first["port"]["acceptance"], move)
    assert np.all(np.abs(pp - pj) <= 4 * np.sqrt(sj**2 + sp**2) + 1e-12), (move, pj, pp)
    if move == "mutate":
        assert 0.0 < pp[-1] < 1.0 and pp[0] == 1.0


def test_clustered_run_crosses_its_boundaries_once(clustered_runs):
    """Both boundaries cluster the pooled T=1 history (four non-empty
    clusters) and build clustered proposals, the T=0 position's prior
    fallback padded to one component per cluster; a second run() crosses
    none and still assigns clusters."""
    ps, first, second = clustered_runs
    assert first["jax"]["adaptation_boundaries"] == first["port"]["adaptation_boundaries"] == 2
    breakdown = first["port"]["adaptation_breakdown"]
    assert [b["components"][0] for b in breakdown] == [4, 4]
    assert all(len(b["cluster_sizes"]) == 4 and min(b["cluster_sizes"]) > 0 for b in breakdown)
    assert all(p.clustered for p in ps.proposals) and ps._assigner.num_clusters == 4
    assert second["adaptation_boundaries"] == 0
    for res in (first["port"], second):
        assert np.isfinite(res["log_prior"] + res["log_likelihood"]).all()
    assert 0.0 < ps.acceptance_rates(ps.state)[0][-1] < 1.0


@pytest.mark.parametrize("override", [dict(shard_over_devices=True, mesh_devices=1)])
def test_sharding_without_a_group_runs_unsharded(poppk_files, override):
    """shard_over_devices without an initialized process group runs the
    unsharded path, as the JAX package does on one device
    (bcm3_tpu/sampler/pt.py:1395): the same run bit for bit. The sharded
    path itself: tests/test_torch_parallel.py."""
    prior_xml = os.path.join(poppk_files, "prior.xml")
    vs = VariableSet.from_xml(prior_xml)
    runs = []
    for cfg in (_SMALL, dict(_SMALL, **override)):
        s = SamplerPT(
            Prior.from_xml(prior_xml, vs),
            create_likelihood(os.path.join(poppk_files, "likelihood.xml"), vs),
            PTConfig(**cfg, device="cpu", dtype=torch.float64),
        )
        assert s._block is None
        runs.append(s.run())
    plain, sharded = runs
    for k in ("samples", "log_prior", "log_likelihood"):
        np.testing.assert_array_equal(sharded[k], plain[k], err_msg=k)
    for k, v in plain["acceptance"].items():
        np.testing.assert_array_equal(sharded["acceptance"][k], v, err_msg=k)
    assert sharded["ensemble_shard"] is None and sharded["evaluations"] == plain["evaluations"]


def test_config_runs_on_the_card_unless_asked():
    """The sampler's entry point runs on the card by default; the CPU is
    an explicit choice (as every CPU test here makes it)."""
    assert PTConfig().device == "cuda"
    assert PTConfig(device="cpu").device == "cpu"
