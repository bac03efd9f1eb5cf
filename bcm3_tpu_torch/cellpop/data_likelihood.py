"""Observed-to-simulated cell matching of the cell-population data
likelihoods.

Counterpart of the matching in bcm3_tpu/cellpop/data_likelihood.py
(:131-184; reference: src/cellpop/DataLikelihoodTimePoints.cpp:200-289
with hungarianMinimumWeightPerfectMatching): the cost matrices are built
on the device, the assignment is solved on the host by the native
solver (bcm3_tpu_torch/native.py). Where the JAX package runs one host
callback per batch row, `batched_hungarian` copies the whole batch to the
host once and solves it in one native call.
"""

from __future__ import annotations

import numpy as np
import torch

from bcm3_tpu_torch.native import lap_match_logp_batch, lap_solve


def hungarian_match_logp(cost_logp: np.ndarray, obs_valid: np.ndarray,
                         sim_valid: np.ndarray) -> float:
    """The total matched logp of one (n_obs, n_sim) log-likelihood matrix:
    0 without a valid observation, -inf when fewer valid simulated cells
    than observed ones exist or when an observed cell can only pair with
    an impossible one (non-finite entries count as -1e100, a total at or
    below -1e90 is -inf)."""
    obs_ix = np.where(obs_valid)[0]
    sim_ix = np.where(sim_valid)[0]
    if len(obs_ix) == 0:
        return 0.0
    if len(sim_ix) < len(obs_ix):
        return -np.inf
    sub = cost_logp[np.ix_(obs_ix, sim_ix)]
    sub = np.where(np.isfinite(sub), sub, -1e100)
    _, neg_total = lap_solve(-sub)
    total = -neg_total
    if not np.isfinite(total) or total <= -1e90:
        return -np.inf
    return float(total)


def host_costs(cost_logp: torch.Tensor) -> np.ndarray:
    """The costs as a float64 numpy array on the host: one copy, staged
    through pinned memory from a card (a pageable copy of this size runs
    at a fraction of the link's rate)."""
    host = torch.empty(cost_logp.shape, dtype=torch.float64,
                       pin_memory=cost_logp.device.type == "cuda")
    return host.copy_(cost_logp.detach()).numpy()


def batched_hungarian(cost_logp: torch.Tensor, obs_valid, sim_valid) -> torch.Tensor:
    """`hungarian_match_logp` of each of B matrices, cost_logp (B, n_obs,
    n_sim), masks (B, n_obs) and (B, n_sim) or shared (n_obs,) and
    (n_sim,): one copy of the costs to the host in float64 (into pinned
    memory from a card), one native call for the batch, the totals (B,) on the cost's device and in its
    dtype (the JAX callback rounds to the cost's dtype too)."""
    cost = host_costs(cost_logp)
    ov = torch.as_tensor(obs_valid).cpu().numpy().astype(bool)
    sv = torch.as_tensor(sim_valid).cpu().numpy().astype(bool)
    totals = lap_match_logp_batch(cost, ov, sv)
    return torch.from_numpy(totals).to(device=cost_logp.device, dtype=cost_logp.dtype)
