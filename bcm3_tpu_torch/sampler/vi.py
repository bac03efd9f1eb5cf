"""Automatic differentiation variational inference (mean-field ADVI) on
torch tensors.

Counterpart of bcm3_tpu/sampler/vi.py (Kucukelbir et al. 2017): a
diagonal Gaussian in the unbounded reparametrized space of the gradient
samplers (`hmc.Reparam`), fit by maximizing the reparametrized-gradient
ELBO with Adam. Each ELBO estimate is one batched evaluation of the
target at num_mc_samples rows (on the card, for PopPK `one`, through
kernel B1 and its reverse mode B1T; for the transit models through
kernel B2J).

`torch.optim.Adam` with its defaults (betas 0.9 and 0.999, eps 1e-8, no
weight decay) makes the update of `optax.adam`'s defaults,
lr * m_hat / (sqrt(v_hat) + eps); the two differ only in the order of
their roundings. The standard normals of each ELBO estimate are an input
of `elbo`, so a test can hold the ELBO, its gradient and the optimizer's
steps to the JAX package's at fixed draws.
"""

from __future__ import annotations

import logging
import math
import time
from dataclasses import dataclass
from typing import Any, List

import numpy as np
import torch

from bcm3_tpu_torch.sampler.hmc import LogPosterior

logger = logging.getLogger(__name__)

# prior draws whose z-space mean and sd start the fit
_INIT_DRAWS = 64


@dataclass
class VIConfig:
    num_iterations: int = 2000
    num_mc_samples: int = 32
    learning_rate: float = 0.05
    num_samples: int = 1000  # posterior draws emitted after the fit
    seed: int = 0
    device: str = "cuda"
    dtype: torch.dtype = torch.float64


class SamplerVI:
    def __init__(self, prior, likelihood, config: VIConfig):
        self.prior = prior
        self.likelihood = likelihood
        self.config = config
        self.sample_handlers: List[Any] = []
        self.ladder = np.array([1.0])
        self.temperatures = self.ladder
        self.num_ensembles = 1
        self.target = LogPosterior(prior, likelihood)
        self.device = torch.device(config.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(config.seed if config.seed else 11)

    @property
    def expected_emitted_samples(self) -> int:
        return self.config.num_samples

    def elbo(self, mu, log_sigma, eps):
        """The reparametrized ELBO estimate at standard normals eps (M, D)
        (bcm3_tpu/sampler/vi.py:78-84): the mean target over the M rows
        (non-finite values count as -1e10) plus the Gaussian's entropy."""
        D = mu.shape[0]
        z = mu + torch.exp(log_sigma) * eps
        logp = self.target(z)
        logp = torch.where(torch.isfinite(logp), logp, -1e10)
        entropy = log_sigma.sum() + 0.5 * D * (1.0 + math.log(2 * math.pi))
        return logp.mean() + entropy

    def initial_parameters(self):
        """(mu, log_sigma) from the z-space mean and sd of prior draws."""
        cfg = self.config
        x0 = self.prior.sample(self.generator, (_INIT_DRAWS,), cfg.dtype)
        z0 = self.target.reparam.from_x(x0).double()
        mu = z0.mean(dim=0)
        log_sigma = torch.log(z0.std(dim=0, unbiased=False) + 1e-2)
        return mu.to(cfg.dtype), log_sigma.to(cfg.dtype)

    def fit(self, mu, log_sigma, eps_draws):
        """Adam on -ELBO from (mu, log_sigma), one step per (M, D) block of
        eps_draws (an iterable). Returns (mu, log_sigma, the last ELBO
        estimate as a float)."""
        mu = mu.detach().clone().requires_grad_(True)
        log_sigma = log_sigma.detach().clone().requires_grad_(True)
        opt = torch.optim.Adam([mu, log_sigma], lr=self.config.learning_rate)
        cur = float("nan")
        n = 0
        for n, eps in enumerate(eps_draws, start=1):
            opt.zero_grad()
            loss = -self.elbo(mu, log_sigma, eps)
            loss.backward()
            self.target.gradient_evaluations += 1
            opt.step()
            # one host read per iteration, as the JAX package's loop makes
            cur = -float(loss.detach())
            if n % max(self.config.num_iterations // 5, 1) == 0:
                logger.info("VI iteration %d: ELBO %.4f", n, cur)
        return mu.detach(), log_sigma.detach(), cur

    def run(self):
        cfg = self.config
        D = self.prior.num_variables
        dev, dtype, g = self.device, cfg.dtype, self.generator
        t0 = time.time()
        mu, log_sigma = self.initial_parameters()
        draws = (
            torch.randn((cfg.num_mc_samples, D), generator=g, dtype=dtype, device=dev)
            for _ in range(cfg.num_iterations)
        )
        evals_before = self.target.gradient_evaluations
        t_fit = time.time()
        mu, log_sigma, cur = self.fit(mu, log_sigma, draws)
        fit_seconds = time.time() - t_fit

        eps = torch.randn((cfg.num_samples, D), generator=g, dtype=dtype, device=dev)
        xs, lprior, llh = self.target.score(mu + torch.exp(log_sigma) * eps)
        elapsed = time.time() - t0

        xs3, lp2, ll2 = xs[:, None, :], lprior[:, None], llh[:, None]
        for handler in self.sample_handlers:
            handler.receive_samples(xs3, lp2, ll2, self.ladder)
        logger.info("VI finished: ELBO %.4f, %d draws, %.2fs", cur, cfg.num_samples, elapsed)
        return {
            "samples": xs3,
            "log_prior": lp2,
            "log_likelihood": ll2,
            "temperatures": self.ladder,
            "elbo": cur,
            "mean": mu.cpu().numpy(),
            "log_sigma": log_sigma.cpu().numpy(),
            "elapsed_seconds": elapsed,
            "fit_seconds": fit_seconds,
            "gradient_evaluations": self.target.gradient_evaluations - evals_before,
        }
