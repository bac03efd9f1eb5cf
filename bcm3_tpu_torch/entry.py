"""Entry points of the port: one PT step, and a sharded dry run.

Counterpart of __graft_entry__.py. Both read the banana fixture from
tests/fixtures/examples/banana of this checkout.

- `entry(device="cuda")` returns a step and its arguments: one full PT
  iteration (replica exchange, then the block-proposal Metropolis-Hastings
  mutate) over the banana fixture's 6-chain population.
- `dryrun_multichip(n_devices, device="cuda")` runs the sharded sampler
  over `n_devices` ranks (parallel/launch.py): two sampling segments
  separated by an adaptation boundary (history gather, GMM fit, each
  rank's rows of the rebuilt proposals), the production run loop. On
  "cuda" it needs `n_devices` cards (NCCL); "cpu" is the explicit gloo
  form.
"""

from __future__ import annotations

import os

import numpy as np
import torch

BANANA = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "tests", "fixtures", "examples", "banana",
)


def _sampler(device: str, **config):
    from bcm3_tpu_torch import Prior, VariableSet, create_likelihood
    from bcm3_tpu_torch.sampler import PTConfig, SamplerPT

    prior_xml = os.path.join(BANANA, "prior.xml")
    varset = VariableSet.from_xml(prior_xml)
    prior = Prior.from_xml(prior_xml, varset)
    lik = create_likelihood(os.path.join(BANANA, "likelihood.xml"), varset)
    return SamplerPT(prior, lik, PTConfig(device=device, **config))


# the JAX entry's sampler (__graft_entry__.py:5-24)
ENTRY_CONFIG = dict(
    num_samples=4, use_every_nth=1, num_chains=6, adapt_proposal_samples=0,
    adapt_proposal_times=0, swapping_scheme="deterministic_even_odd", seed=17,
)


def entry(device: str = "cuda"):
    """(step, (state, proposals)): step(state, proposals) runs one PT
    iteration with the sampler's own random numbers and returns the new
    positions, log-priors and log-likelihoods."""
    s = _sampler(device, **ENTRY_CONFIG)
    state = s._init_state()
    proposals = list(s.proposals)

    def step(state, proposals):
        state, proposals = s._iteration(state, proposals, s.draw(proposals))
        return state.x, state.lprior, state.llh

    return step, (state, proposals)


def _dryrun_config(n_devices: int) -> dict:
    """The JAX dry run's configuration (__graft_entry__.py:43-82): a
    4-chain ladder, the ensembles padded to the mesh, 8 samples thinned
    by 2, one adaptation after 4."""
    L = 4
    E = max(1, -(-n_devices // L)) * 2
    while (L * E) % n_devices != 0:
        E += 1
    return dict(
        num_samples=8, use_every_nth=2, num_chains=L, num_ensembles=E,
        adapt_proposal_samples=4, adapt_proposal_times=1,
        swapping_scheme="deterministic_even_odd", shard_over_devices=True, seed=17,
    )


def _check(ok: bool, what: str):
    if not ok:
        raise RuntimeError(f"dry run: {what}")


def _dryrun_rank(rank: int, world: int, device: str) -> dict:
    s = _sampler(device, **_dryrun_config(world))
    res = s.run()
    e_local = res["ensemble_shard"][1] if res["ensemble_shard"] else s.num_ensembles
    shape = (8 * e_local, s.ladder_size, s.num_variables)
    _check(res["samples"].shape == shape, f"samples {res['samples'].shape}, expected {shape}")
    _check(res["adaptation_boundaries"] == 1, "no adaptation boundary")
    _check(bool(np.isfinite(res["samples"]).all()), "non-finite samples")
    _check(res["evaluations"] > 0, "no evaluation")
    keep = ("samples", "log_prior", "log_likelihood", "ensemble_shard", "num_ensembles",
            "evaluations")
    return {k: res[k] for k in keep}


def dryrun_multichip(n_devices: int, device: str = "cuda") -> dict:
    """The sharded run over `n_devices` ranks; returns the whole
    population's samples, log-priors and log-likelihoods (the ranks'
    shards merged) and the evaluations."""
    from bcm3_tpu_torch.io.output import merge_sharded_results
    from bcm3_tpu_torch.parallel import launch

    if torch.device(device).type == "cuda":
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if cards < n_devices:
            raise RuntimeError(
                f"dryrun_multichip({n_devices}) on {device!r} needs {n_devices} cards, "
                f"{cards} visible (device='cpu' runs the ranks over gloo on the CPU)"
            )
    ranks = launch.spawn(_dryrun_rank, n_devices, device, device)
    first = ranks[0]
    E = first["num_ensembles"]
    merged = merge_sharded_results(ranks) if first["ensemble_shard"] else first
    shape = (8 * E, 4, first["samples"].shape[-1])
    _check(merged["samples"].shape == shape, f"merged {merged['samples'].shape}, expected {shape}")
    _check(bool(np.isfinite(merged["samples"]).all()), "non-finite merged samples")
    _check(all(r["evaluations"] == first["evaluations"] for r in ranks),
           "the ranks count different evaluations")
    return dict(merged, evaluations=first["evaluations"])
