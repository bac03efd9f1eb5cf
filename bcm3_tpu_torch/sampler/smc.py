"""Adaptive tempered Sequential Monte Carlo on torch tensors.

Counterpart of bcm3_tpu/sampler/smc.py (Del Moral, Doucet & Jasra 2006;
adaptive tempering by effective-sample-size bisection):
1. draw N particles from the prior (beta = 0);
2. find the next beta so that the incremental weights' ESS is about
   ess_target * N (`find_beta`, a bisection on the host in float64);
3. systematic resampling (`systematic_resample`);
4. K Metropolis sweeps at the current tempered posterior with a Gaussian
   random walk scaled by the Cholesky factor of the particles' covariance
   (`mutate`), proposals reflected on the prior's bounds;
5. repeat until beta = 1. The log evidence accumulates from the
   incremental weights.

The population's likelihood goes through `log_prob_batched` on the
sampler's device (on the card, kernel B1 for PopPK `one` and B2 for
`one_transit`); the JAX package vmaps `log_prob`, the same function.
SMC takes no gradient, so it runs on every likelihood. The weights, the
bisection and the resampling indices are the JAX package's host numpy;
the mutation sweeps stay on the device. Every random number is an input
of the step that uses it (the resampling's uniform, each sweep's normals
and uniforms), so a test can hold a stage to the JAX package's with the
JAX package's draws.
"""

from __future__ import annotations

import logging
import math
import time
from dataclasses import dataclass
from typing import Any, List

import numpy as np
import torch

from bcm3_tpu_torch.sampler.proposal import reflect_on_bounds

logger = logging.getLogger(__name__)


@dataclass
class SMCConfig:
    num_particles: int = 2048
    mutation_steps: int = 5
    ess_target: float = 0.5
    seed: int = 0
    max_stages: int = 100
    step_scale: float = 0.5  # random-walk scale relative to particle sd
    device: str = "cuda"
    dtype: torch.dtype = torch.float64


def find_beta(llh: np.ndarray, beta: float, ess_target: float) -> float:
    """Bisection for the next temperature with ESS ~ ess_target * N
    (bcm3_tpu/sampler/smc.py:66-87)."""
    target = ess_target * len(llh)

    def ess_at(b):
        lw = (b - beta) * llh
        lw = lw - lw.max()
        w = np.exp(lw)
        return w.sum() ** 2 / (w * w).sum()

    if ess_at(1.0) >= target:
        return 1.0
    lo, hi = beta, 1.0
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        if ess_at(mid) >= target:
            lo = mid
        else:
            hi = mid
    return lo


def reweight(llh: np.ndarray, beta: float, new_beta: float):
    """The incremental weights from beta to new_beta: (the log evidence's
    increment, the normalized weights)."""
    lw = (new_beta - beta) * llh
    m = lw.max()
    w = np.exp(lw - m)
    return m + np.log(w.mean()), w / w.sum()


def systematic_resample(w_norm: np.ndarray, u: float) -> np.ndarray:
    """Indices of systematic resampling with the one uniform u in [0, 1)
    (bcm3_tpu/sampler/smc.py:138-142)."""
    N = len(w_norm)
    positions = u / N + np.arange(N) / N
    idx = np.searchsorted(np.cumsum(w_norm), positions)
    return np.clip(idx, 0, N - 1)


class SamplerSMC:
    def __init__(self, prior, likelihood, config: SMCConfig):
        self.prior = prior
        self.likelihood = likelihood
        self.config = config
        self.sample_handlers: List[Any] = []
        self.ladder = np.array([1.0])
        self.temperatures = self.ladder
        self.num_ensembles = 1
        self.device = torch.device(config.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(config.seed if config.seed else 7)
        self._bounds = {}

    @property
    def expected_emitted_samples(self) -> int:
        return self.config.num_particles

    def log_likelihood(self, x):
        """Tempered log-likelihood of every particle, NaN -> -inf."""
        ll = self.likelihood.log_prob_batched(x) * self.likelihood.learning_rate
        return torch.where(torch.isnan(ll), -math.inf, ll)

    def mutate(self, x, llh, lprior, beta, chol_scaled, normal, uniform):
        """One random-walk MH sweep of every particle at temperature beta
        (bcm3_tpu/sampler/smc.py:105-121): x (N, D), llh and lprior (N,),
        chol_scaled (D, D); draws `normal` (N, D) and `uniform` (N,).
        Returns (x, llh, lprior, acceptance rate as a 0-dim tensor)."""
        key = (str(x.device), x.dtype)
        if key not in self._bounds:
            self._bounds[key] = tuple(
                torch.as_tensor(b, dtype=x.dtype, device=x.device)
                for b in (self.prior.lower, self.prior.upper)
            )
        prop = reflect_on_bounds(x + normal @ chol_scaled.T, *self._bounds[key])
        lp_new = self.prior.log_pdf(prop)
        ll_new = self.log_likelihood(prop)
        logr = (lp_new + beta * ll_new) - (lprior + beta * llh)
        accept = torch.log(uniform) < logr
        x = torch.where(accept[:, None], prop, x)
        llh = torch.where(accept, ll_new, llh)
        lprior = torch.where(accept, lp_new, lprior)
        return x, llh, lprior, accept.to(x.dtype).mean()

    def scaled_cholesky(self, x):
        """The random walk's scale: chol(cov(x) + 1e-10 I) * step_scale * 2.38
        / sqrt(D), from the particles' covariance in float64."""
        D = x.shape[1]
        cov = torch.cov(x.double().T).reshape(D, D).cpu().numpy()
        cov += 1e-10 * np.eye(D)
        chol = np.linalg.cholesky(cov) * (self.config.step_scale * 2.38 / np.sqrt(D))
        return torch.as_tensor(chol, dtype=x.dtype, device=x.device)

    def run(self):
        cfg = self.config
        N = cfg.num_particles
        D = self.prior.num_variables
        dtype, dev, g = cfg.dtype, self.device, self.generator
        t0 = time.time()

        with torch.no_grad():
            x = self.prior.sample(g, (N,), dtype)
            llh = self.log_likelihood(x)
            beta, log_ml, stage = 0.0, 0.0, 0
            betas, accepts = [], []
            while beta < 1.0 and stage < cfg.max_stages:
                stage += 1
                llh_host = llh.double().cpu().numpy()
                new_beta = find_beta(llh_host, beta, cfg.ess_target)
                inc, w_norm = reweight(llh_host, beta, new_beta)
                log_ml += inc
                u = float(torch.rand((), generator=g, dtype=torch.float64, device=dev))
                idx = torch.as_tensor(systematic_resample(w_norm, u), device=dev)
                x, llh = x[idx], llh[idx]
                beta = new_beta

                chol = self.scaled_cholesky(x)
                lprior = self.prior.log_pdf(x)
                acc = torch.zeros((), dtype=dtype, device=dev)
                for _ in range(cfg.mutation_steps):
                    normal = torch.randn((N, D), generator=g, dtype=dtype, device=dev)
                    uniform = torch.rand((N,), generator=g, dtype=dtype, device=dev)
                    x, llh, lprior, acc = self.mutate(x, llh, lprior, beta, chol, normal,
                                                      uniform)
                betas.append(beta)
                accepts.append(float(acc))
                logger.info("SMC stage %d: beta=%.4f accept=%.3f log_ml=%.3f",
                            stage, beta, accepts[-1], log_ml)

            lprior = self.prior.log_pdf(x)
        elapsed = time.time() - t0
        xs = x.cpu().numpy()[:, None, :]
        lp = lprior.double().cpu().numpy()[:, None]
        ll = llh.double().cpu().numpy()[:, None]
        for handler in self.sample_handlers:
            handler.receive_samples(xs, lp, ll, self.ladder)
        logger.info("SMC finished: %d particles, %d stages, %.2fs", N, stage, elapsed)
        return {
            "samples": xs,
            "log_prior": lp,
            "log_likelihood": ll,
            "temperatures": self.ladder,
            "log_marginal_likelihood": float(log_ml),
            "stages": stage,
            "betas": betas,
            "acceptance": accepts,
            "elapsed_seconds": elapsed,
        }
