"""The frozen references against the program they were copied from, at
small sizes on the CPU: the trial generator and its tables, the prior,
the log-likelihood on both transit paths and the one-compartment model,
the gradient samplers' target and its gradient (float64); and the
rooflines' counts against each kernel's plain version."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench.harness import main as harness
from portbench.reference import poppk as ref
from portbench.reference import prior as ref_prior
from portbench.reference import trial as ref_trial
from portbench_testing import TINY_CONFIG, load

P, T = 3, 10
F64 = torch.float64


def config(name, **kw):
    return dict(load("configs", name), num_patients=P, num_timepoints=T, **kw)


def program(cfg, tmp_path, seed=11):
    """The program's prior and likelihood over the reference's trial."""
    from bcm3_tpu_torch import Prior, VariableSet
    from bcm3_tpu_torch.likelihoods.poppk import PopPKLikelihood, PopPKTrial

    path = str(tmp_path / "prior.xml")
    ref_prior.write_xml(cfg, path)
    vs = VariableSet.from_xml(path)
    trial = ref_trial.synthesize_trial(cfg, seed)
    pk = PopPKLikelihood(vs, PopPKTrial(**trial), cfg["pk_type"], cfg["drug"],
                         solver_trips=cfg["solver_trips"])
    return Prior.from_xml(path, vs), pk, trial


def draws(cfg, n, seed=5, dtype=F64):
    prior = ref_prior.ReferencePrior(cfg)
    return prior, prior.sample(torch.Generator().manual_seed(seed), n, dtype)


def test_trial_generator_is_the_programs():
    from bcm3_tpu_torch.likelihoods.poppk_synth import synthesize_trial

    cfg = load("configs", "one")
    mine = ref_trial.synthesize_trial(cfg, 42)
    theirs, _ = synthesize_trial(num_patients=16, num_timepoints=24, seed=42)
    for k, v in mine.items():
        np.testing.assert_array_equal(v, getattr(theirs, k), err_msg=k)


@pytest.mark.parametrize("name", ["one", "one_transit"])
def test_tables_are_the_programs(name, tmp_path):
    cfg = config(name)
    _, pk, trial = program(cfg, tmp_path)
    tb = ref_trial.tables(trial, cfg["drug"])
    assert tb["K"] == pk.K
    for mine, theirs in (("dose_amount", "dose_amount"), ("obs_interval", "obs_interval"),
                         ("obs_offset", "obs_offset"), ("obs_mask", "obs_mask"),
                         ("window_mask", "window_mask"), ("initial_dose", "initial_dose")):
        np.testing.assert_array_equal(tb[mine], getattr(pk, theirs), err_msg=mine)
    if name == "one_transit":
        np.testing.assert_array_equal(tb["grid"], pk.tr_grid)
        np.testing.assert_array_equal(tb["obs_pos"], pk.tr_obs_pos)
        np.testing.assert_array_equal(tb["amt"], np.where(pk.tr_is_dose, pk.tr_dose_amt, 0.0))


@pytest.mark.parametrize("name", ["one", "one_transit"])
def test_prior_density_and_variables_are_the_programs(name, tmp_path):
    cfg = config(name)
    prog_prior, pk, _ = program(cfg, tmp_path)
    prior, x = draws(cfg, 64)
    x[0, 0] = 5.0  # outside its bounds: -inf on both sides
    assert prior.names == pk.varset.names
    np.testing.assert_allclose(prior.log_density(x).numpy(), prog_prior.log_pdf(x).numpy(),
                               rtol=1e-14)


def _likelihood_rows(cfg, tmp_path, n=48):
    prog_prior, pk, trial = program(cfg, tmp_path)
    prior, x = draws(cfg, n)
    tb = ref.device_tables(ref_trial.tables(trial, cfg["drug"]), "cpu", F64)
    return prog_prior, pk, prior, x, tb


def test_one_compartment_likelihood_is_the_programs(tmp_path):
    cfg = config("one")
    _, pk, prior, x, tb = _likelihood_rows(cfg, tmp_path)
    mine = ref.log_likelihood(x, prior, tb, "one")
    theirs = pk.log_prob_batched(x)
    assert torch.isfinite(mine).sum() > 10
    torch.testing.assert_close(mine, theirs, rtol=1e-12, atol=1e-9)


def test_population_transit_likelihood_is_the_programs(tmp_path):
    """The program's population path solves in float32 (as kernel B2 does):
    the reference in float32 is its twin, bit for bit on the solve."""
    cfg = config("one_transit", solver_trips=TINY_CONFIG["solver_trips"] * 2)
    _, pk, prior, x, _ = _likelihood_rows(cfg, tmp_path)
    f32 = torch.float32
    tb32 = ref.device_tables(ref_trial.tables(pk.trial.__dict__, cfg["drug"]), "cpu", f32)
    mine = ref.log_likelihood(x.to(f32), prior, tb32, "one_transit", "population",
                              cfg["solver_trips"])
    theirs = pk.log_prob_batched(x.to(f32))
    assert torch.isfinite(mine).sum() > 5
    torch.testing.assert_close(mine, theirs, rtol=1e-6, atol=1e-4, equal_nan=True)


def test_gradient_path_target_and_gradient_are_the_programs(tmp_path):
    """The gradient samplers' target in float64: the value and the gradient
    (autograd through the reference's solve against the program's B2J
    plain version with its Jacobian)."""
    from bcm3_tpu_torch.likelihoods import Likelihood
    from bcm3_tpu_torch.sampler.hmc import LogPosterior

    cfg = config("one_transit", solver_trips=TINY_CONFIG["solver_trips"] * 2)
    prog_prior, pk, prior, x, tb = _likelihood_rows(cfg, tmp_path, n=96)
    target = LogPosterior(prog_prior, Likelihood("pop_pk_trajectory", pk.log_prob_batched,
                                                 model=pk))
    with torch.no_grad():
        fin = torch.isfinite(target(target.reparam.from_x(x)))
    z = target.reparam.from_x(x[fin][:8])
    assert z.shape[0] >= 4
    v, g = target.value_and_grad(z)
    zz = z.clone().requires_grad_(True)
    mine = ref.log_posterior_z(zz, prior, tb, "one_transit", cfg["solver_trips"])
    (mg,) = torch.autograd.grad(mine.sum(), zz)
    torch.testing.assert_close(mine.detach(), v, rtol=1e-10, atol=1e-8)
    torch.testing.assert_close(mg, g, rtol=1e-7, atol=1e-7)
    np.testing.assert_allclose(prior.to_x(z).numpy(), target.reparam.to_x(z).numpy(),
                               rtol=1e-15)


def test_population_trip_counts_are_the_plain_kernels(tmp_path):
    """roofline/b2.py's trips: the reference's float32 population solve
    counts what kernel B2's plain version counts, lane by lane."""
    from bcm3_tpu_torch.ops.transit_kernels import transit_solve_plain

    cfg = config("one_transit")
    _, pk, prior, x, _ = _likelihood_rows(cfg, tmp_path, n=32)
    f32 = torch.float32
    tb = ref.device_tables(ref_trial.tables(pk.trial.__dict__, cfg["drug"]), "cpu", f32)
    p, _, _ = ref.patient_params(x.to(f32), prior, "one_transit")
    lanes = ref.lanes(p, *p["ka"].shape)
    c, ok, n = ref.transit_population(lanes, tb, cfg["solver_trips"])
    params = dict(lanes, dose0=tb["initial_dose"])
    cp, okp, n_p = transit_solve_plain(params, tb["grid"], tb["amt"], cfg["solver_trips"],
                                       atol=tb["atol"], trip_counts=True)
    assert torch.equal(n, n_p) and torch.equal(ok, okp) and n.sum() > 0
    torch.testing.assert_close(c, cp, equal_nan=True, rtol=0, atol=0)


def test_gradient_path_trip_counts_are_the_plain_kernels(tmp_path):
    """roofline/b2j.py's trips: the reference's gradient-path solve counts
    the active trips that kernel B2J's plain version counts."""
    from bcm3_tpu_torch.ops.transit_tangent_kernels import transit_jacobian_plain

    cfg = config("one_transit")
    _, pk, prior, x, _ = _likelihood_rows(cfg, tmp_path, n=16)
    f32 = torch.float32
    tb = ref.device_tables(ref_trial.tables(pk.trial.__dict__, cfg["drug"]), "cpu", f32)
    p, _, _ = ref.patient_params(x.to(f32), prior, "one_transit")
    lanes = ref.lanes(p, *p["ka"].shape)
    _, ok, m = ref.transit_gradient_path(lanes, tb, cfg["solver_trips"])
    _, _, okp, m_p = transit_jacobian_plain(
        lanes, tb["grid"], tb["amt"], tb["initial_dose"], tb["obs_pos"], cfg["solver_trips"],
        atol=tb["atol"], trip_counts=True)
    assert torch.equal(m, m_p) and torch.equal(ok, okp) and m.sum() > 0


def test_b1_work_is_the_plain_kernels_inputs_and_outputs():
    """roofline/b1.py's bytes are the plain version's input and output
    sizes, its operations 12 + 5K a lane."""
    from types import SimpleNamespace

    from bcm3_tpu_torch.ops.poppk_kernels import propagate_intervals_plain
    from portbench.harness import registry

    B, P, K = 5, 3, 14
    args = [torch.rand(B, P), torch.rand(B, P), torch.rand(B, P), torch.rand(P), torch.rand(P),
            torch.rand(P, K)]
    g, c = propagate_intervals_plain(*args)
    nbytes = sum(a.numel() * 4 for a in args) + (g.numel() + c.numel()) * 4
    ctx = SimpleNamespace(boundary=SimpleNamespace(call_rows=[B], call_grad=[False]),
                          tables={"dose_amount": np.zeros((P, K))},
                          traffic={"dtype": "float32"})
    work = registry.load_module("roofline", "b1").work(ctx)
    assert work["bytes"] == nbytes and work["ops"] == B * P * (12 + 5 * K)


def test_seeds_change_the_trial():
    cfg = load("configs", "one")
    a = ref_trial.synthesize_trial(cfg, harness.seeds(7)["trial"])
    b = ref_trial.synthesize_trial(cfg, harness.seeds(8)["trial"])
    assert not np.array_equal(a["observed"], b["observed"], equal_nan=True)
