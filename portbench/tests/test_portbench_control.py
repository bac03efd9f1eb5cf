"""The check fails what it must: the control (the reference in bfloat16 in
the program's place) and, with the harness's look for a card skipped and
the rest of a run driven at a tiny size on the CPU, the timed path broken
underneath: a step that returns its state unchanged, half of the patients
left out with the sum taken over the rest, and an answer altered where it
is produced. A one-card cell has no exchange between chips to leave out."""

from __future__ import annotations

import io
import json

import pytest
import torch

from portbench.harness import main as harness
from portbench_testing import tiny


def run(workload, config=None, control=None, seed=3000000003):
    out = io.StringIO()
    argv = ["--workload", workload, "--seed", str(seed), "--seconds", "0.05", "--trace", "0"]
    argv += ["--control", control] if control else []
    assert harness.main(argv, device="cpu", overrides=tiny(workload, config), out=out) == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def over(result):
    return {k for k, c in result["checks"].items() if not c["value"] <= c["limit"]}


@pytest.mark.parametrize("workload,config", [("pt.one", None), ("pt.one_transit", None),
                                             ("nuts.one_transit", "one")])
def test_the_control_is_not_correct(workload, config):
    r = run(workload, config, control="bfloat16")
    assert r["correct"] is False and over(r) & {"llh_gap", "lprior_gap", "logp_gap", "grad_gap"}


def _unchanged_pt(monkeypatch):
    from bcm3_tpu_torch.sampler.pt import SamplerPT

    monkeypatch.setattr(SamplerPT, "_iteration", lambda self, state, proposals, draws:
                        (state, proposals))


def _unchanged_nuts(monkeypatch):
    from bcm3_tpu_torch.sampler.nuts import SamplerNUTS

    def transition(self, z, logp, grad, *args):
        zero = torch.zeros_like(logp)
        return z, logp, grad, zero, zero.bool(), zero.long()

    monkeypatch.setattr(SamplerNUTS, "transition", transition)


def _half_the_patients(monkeypatch):
    """The observations of the first half of the patients only, their sum
    doubled (the mean over the rest in the place of the whole)."""
    from bcm3_tpu_torch.likelihoods.poppk import PopPKLikelihood

    real = PopPKLikelihood._tables

    def tables(self, device, dtype):
        tb = dict(real(self, device, dtype))
        mask = tb["obs_mask"].clone()
        mask[mask.shape[0] // 2:] = False
        tb["obs_mask"] = mask
        return tb

    real_lp = PopPKLikelihood.log_prob_batched
    monkeypatch.setattr(PopPKLikelihood, "_tables", tables)
    monkeypatch.setattr(PopPKLikelihood, "log_prob_batched",
                        lambda self, xs: 2.0 * real_lp(self, xs))


def _altered_answer(monkeypatch):
    """Every log-likelihood off by one part in a thousand."""
    from bcm3_tpu_torch.likelihoods.poppk import PopPKLikelihood

    real_lp = PopPKLikelihood.log_prob_batched
    monkeypatch.setattr(PopPKLikelihood, "log_prob_batched",
                        lambda self, xs: real_lp(self, xs) * 1.001)


FAULTS = {"unchanged": ({"pt": _unchanged_pt, "nuts": _unchanged_nuts}, "stuck_share"),
          "half": ({"pt": _half_the_patients, "nuts": _half_the_patients}, "llh_gap"),
          "altered": ({"pt": _altered_answer, "nuts": _altered_answer}, "llh_gap")}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload,config,kind", [("pt.one", None, "pt"),
                                                  ("nuts.one_transit", "one", "nuts")])
def test_a_broken_timed_path_is_not_correct(fault, workload, config, kind, monkeypatch):
    plant, number = FAULTS[fault]
    plant[kind](monkeypatch)
    r = run(workload, config)
    assert r["correct"] is False and number in over(r), r["checks"]
