"""Hamiltonian Monte Carlo with dual-averaging adaptation, on torch tensors.

Counterpart of bcm3_tpu/sampler/hmc.py (a backend beyond the reference's
derivative-free PT-MH/IS pair, BASELINE north star):

- C chains advance in lockstep: each leapfrog step is one batched
  gradient evaluation of the whole population through the likelihood's
  `log_prob_batched` (on the card, for PopPK `one`, kernel B1 forward and
  B1T backward, ops/poppk_kernels.py; for the transit models kernel B2J,
  the solve with its Jacobian, in the likelihood's gradient mode, which
  `LogPosterior` sets around every evaluation);
- constrained variables are reparametrized to unbounded space (logit for
  two-sided bounds, log for one-sided) with the log-Jacobian in the
  target (`Reparam`, also used by NUTS and VI);
- warmup: Nesterov dual averaging of the step size toward a target
  acceptance rate (Hoffman & Gelman 2014, Algorithm 5) and a diagonal
  mass from the variance of the second half of warmup.

The step takes its draws as inputs (the standard-normal momentum and the
acceptance uniform of every chain), so a test can hold it to the JAX
package's step with the JAX package's draws. The leapfrog evaluates the
gradient once per position: L evaluations for L steps, the gradient at
the start carried over from the previous step (the last evaluation also
gives the value the acceptance needs), where the JAX package's scan
evaluates it twice at each interior position; the arithmetic is the same.
Per-iteration statistics stay on the device: the host reads them once,
after the loop.
"""

from __future__ import annotations

import contextlib
import logging
import math
import time
from dataclasses import dataclass
from typing import Any, List

import numpy as np
import torch
import torch.nn.functional as F

from bcm3_tpu_torch.tracing import span

logger = logging.getLogger(__name__)

# rows per likelihood call when the stored samples are scored at the end
SCORE_BATCH = 65536


@dataclass
class HMCConfig:
    num_samples: int = 1000
    num_warmup: int = 500
    num_chains: int = 8
    num_leapfrog_steps: int = 16
    target_accept: float = 0.8
    initial_step_size: float = 0.1
    seed: int = 0
    use_every_nth: int = 1
    device: str = "cuda"
    dtype: torch.dtype = torch.float64


class Reparam:
    """Bounded -> unbounded transform per variable (bcm3_tpu/sampler/hmc.py:48-98).

    Both directions keep the untaken branches of their selections finite
    (the double-where rule): a value that is not used is computed at a
    harmless point, so its derivative cannot turn the selection's zero
    cotangent into NaN."""

    def __init__(self, lower: np.ndarray, upper: np.ndarray):
        self.lower = np.asarray(lower, dtype=np.float64)
        self.upper = np.asarray(upper, dtype=np.float64)
        self.two_sided = np.isfinite(self.lower) & np.isfinite(self.upper)
        self.lo_only = np.isfinite(self.lower) & ~np.isfinite(self.upper)
        self.hi_only = ~np.isfinite(self.lower) & np.isfinite(self.upper)
        self._tensors = {}

    def _t(self, z):
        key = (str(z.device), z.dtype)
        if key not in self._tensors:

            def f(a):
                return torch.as_tensor(a, dtype=z.dtype, device=z.device)

            two, lo_only, hi_only = (
                torch.as_tensor(m, device=z.device)
                for m in (self.two_sided, self.lo_only, self.hi_only)
            )
            lo = f(np.where(np.isfinite(self.lower), self.lower, 0.0))
            hi = f(np.where(np.isfinite(self.upper), self.upper, 0.0))
            span = f(np.where(self.two_sided, self.upper - self.lower, 1.0))
            self._tensors[key] = (lo, hi, span, two, lo_only, hi_only)
        return self._tensors[key]

    def to_x(self, z):
        lo, hi, span, two, lo_only, hi_only = self._t(z)
        one = lo_only | hi_only
        ez = torch.exp(torch.where(one, z, 0.0))
        x = torch.where(two, lo + span * torch.sigmoid(z), z)
        x = torch.where(lo_only, lo + ez, x)
        return torch.where(hi_only, hi - ez, x)

    def log_jacobian(self, z):
        _, _, span, two, lo_only, hi_only = self._t(z)
        lj = torch.where(two, torch.log(span) + F.logsigmoid(z) + F.logsigmoid(-z), 0.0)
        lj = torch.where(lo_only | hi_only, z, lj)
        return lj.sum(dim=-1)

    def from_x(self, x):
        """z of the points x, computed in float64 and returned in x's dtype."""
        lo, hi = (torch.as_tensor(v, device=x.device) for v in (self.lower, self.upper))
        z = x.double().clone()
        sel = torch.as_tensor(self.two_sided, device=x.device)
        frac = torch.clamp((z[..., sel] - lo[sel]) / (hi[sel] - lo[sel]), 1e-9, 1 - 1e-9)
        z[..., sel] = torch.log(frac / (1 - frac))
        sel = torch.as_tensor(self.lo_only, device=x.device)
        z[..., sel] = torch.log(torch.clamp(z[..., sel] - lo[sel], min=1e-12))
        sel = torch.as_tensor(self.hi_only, device=x.device)
        z[..., sel] = torch.log(torch.clamp(hi[sel] - z[..., sel], min=1e-12))
        return z.to(x.dtype)


@contextlib.contextmanager
def gradient_mode(likelihood):
    """The likelihood's gradient mode for the duration: a model with a
    `gradient_mode` switch (PopPK's transit models: the JAX package's
    `log_prob` path, which its gradient samplers differentiate, through
    kernel B2J) takes it; any other likelihood is left as it is."""
    model = getattr(likelihood, "model", None)
    if not hasattr(model, "gradient_mode"):
        yield
        return
    before = model.gradient_mode
    model.gradient_mode = True
    try:
        yield
    finally:
        model.gradient_mode = before


class LogPosterior:
    """The target of the gradient samplers in z-space, batched over rows:
    log prior + log-Jacobian + learning rate x log-likelihood, NaN -> -inf
    (bcm3_tpu/sampler/nuts.py:122-127). `gradient_evaluations` counts the
    batched calls of `value_and_grad`. Every evaluation, the stored scores
    of `score` included, runs in the likelihood's gradient mode, so that the
    values the sampler saw and the values it stores are the same."""

    def __init__(self, prior, likelihood):
        self.prior = prior
        self.likelihood = likelihood
        self.reparam = Reparam(prior.lower, prior.upper)
        self.gradient_evaluations = 0

    def _log_likelihood(self, x):
        with gradient_mode(self.likelihood):
            return self.likelihood.log_prob_batched(x) * self.likelihood.learning_rate

    def __call__(self, z):
        x = self.reparam.to_x(z)
        lp = self.prior.log_pdf(x) + self.reparam.log_jacobian(z)
        total = lp + self._log_likelihood(x)
        return torch.where(torch.isnan(total), -math.inf, total)

    def value_and_grad(self, z):
        """(logp (C,), d logp / dz (C, D)) of every row of z (C, D). The
        rows are independent, so the gradient of their sum is each row's."""
        self.gradient_evaluations += 1
        with span("LogPosterior.value_and_grad"), torch.enable_grad():
            zz = z.detach().requires_grad_(True)
            logp = self(zz)
            (grad,) = torch.autograd.grad(logp.sum(), zz)
        return logp.detach(), grad

    def score(self, zs):
        """The store's (x, log prior, tempered log-likelihood) of z rows (N, D),
        as host float64 arrays, in batches of SCORE_BATCH rows."""
        xs, lps, lls = [], [], []
        with torch.no_grad():
            for i in range(0, zs.shape[0], SCORE_BATCH):
                x = self.reparam.to_x(zs[i : i + SCORE_BATCH])
                xs.append(x.cpu().numpy())
                lps.append(self.prior.log_pdf(x).double().cpu().numpy())
                ll = self._log_likelihood(x)
                lls.append(ll.double().cpu().numpy())
        return np.concatenate(xs), np.concatenate(lps), np.concatenate(lls)


def emit(handlers, zs_by_sample, target, ladder):
    """Score the stored z (S, C, D), pool the chains into the (S*C, 1, D)
    layout of the single-temperature store, and hand it to the handlers.
    Returns (xs (S, C, D), x, log prior, log-likelihood in store layout)."""
    S, C, D = zs_by_sample.shape
    xs, lprior, llh = target.score(zs_by_sample.reshape(S * C, D))
    xs_flat, lp_flat, ll_flat = xs.reshape(S * C, 1, D), lprior[:, None], llh[:, None]
    for handler in handlers:
        handler.receive_samples(xs_flat, lp_flat, ll_flat, ladder)
    return xs.reshape(S, C, D), xs_flat, lp_flat, ll_flat


class SamplerHMC:
    """Batched HMC over the posterior lprior + llh."""

    def __init__(self, prior, likelihood, config: HMCConfig):
        self.prior = prior
        self.likelihood = likelihood
        self.config = config
        self.sample_handlers: List[Any] = []
        self.num_chains = config.num_chains
        self.num_ensembles = 1
        self.ladder = np.array([1.0])
        self.temperatures = self.ladder
        self.target = LogPosterior(prior, likelihood)
        self.device = torch.device(config.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(config.seed if config.seed else 42)

    @property
    def expected_emitted_samples(self) -> int:
        # chains are pooled into the single-temperature store
        return self.config.num_samples * self.config.num_chains

    def leapfrog(self, z, p, grad, eps, inv_mass):
        """L leapfrog steps from (z, p) with the gradient `grad` at z.
        Returns (z, p, logp, grad) at the end."""
        half = 0.5 * eps
        logp = None
        for _ in range(self.config.num_leapfrog_steps):
            p = p + half * grad
            z = z + eps * inv_mass * p
            logp, grad = self.target.value_and_grad(z)
            p = p + half * grad
        return z, p, logp, grad

    def step(self, z, logp, grad, eps, inv_mass, normal, uniform):
        """One HMC transition of every chain (bcm3_tpu/sampler/hmc.py:145-159)
        from z (C, D) with its logp (C,) and gradient, given the draws:
        `normal` (C, D) standard normals for the momentum and `uniform` (C,)
        for the acceptance. Returns (z, logp, grad, acceptance probability,
        accepted)."""
        p = normal / torch.sqrt(inv_mass)
        h0 = logp - 0.5 * (inv_mass * p * p).sum(dim=-1)
        z_new, p_new, logp_new, grad_new = self.leapfrog(z, p, grad, eps, inv_mass)
        h1 = logp_new - 0.5 * (inv_mass * p_new * p_new).sum(dim=-1)
        # divergent trajectories (non-finite Hamiltonian) are rejections
        dh = h1 - h0
        log_alpha = torch.where(torch.isnan(dh), -math.inf, torch.clamp(dh, max=0.0))
        accept = torch.log(uniform) < log_alpha
        z = torch.where(accept[:, None], z_new, z)
        logp = torch.where(accept, logp_new, logp)
        grad = torch.where(accept[:, None], grad_new, grad)
        return z, logp, grad, torch.exp(log_alpha), accept

    def draws(self, C, D, dtype):
        """The draws of one step from the sampler's generator."""
        g = self.generator
        normal = torch.randn((C, D), generator=g, dtype=dtype, device=self.device)
        uniform = torch.rand((C,), generator=g, dtype=dtype, device=self.device)
        return normal, uniform

    def run(self):
        cfg = self.config
        D = self.prior.num_variables
        C = cfg.num_chains
        dtype = cfg.dtype
        dev = self.device

        # start from prior draws mapped to unbounded space
        z = self.target.reparam.from_x(self.prior.sample(self.generator, (C,), dtype))
        logp, grad = self.target.value_and_grad(z)

        t0 = time.perf_counter()
        # ---- warmup with dual averaging (state on the device, float64) ----
        f64 = dict(dtype=torch.float64, device=dev)
        mu = math.log(10.0 * cfg.initial_step_size)
        log_eps = torch.tensor(math.log(cfg.initial_step_size), **f64)
        log_eps_bar = torch.zeros((), **f64)
        h_bar = torch.zeros((), **f64)
        gamma, t0_da, kappa = 0.05, 10.0, 0.75
        inv_mass = torch.ones(D, dtype=dtype, device=dev)

        warm_hist = []
        for it in range(cfg.num_warmup):
            z, logp, grad, alphas, _ = self.step(
                z, logp, grad, torch.exp(log_eps).to(dtype), inv_mass, *self.draws(C, D, dtype)
            )
            a = torch.nan_to_num(alphas, nan=0.0).double().mean()
            m = it + 1
            h_bar = (1 - 1 / (m + t0_da)) * h_bar + (cfg.target_accept - a) / (m + t0_da)
            log_eps = mu - math.sqrt(m) / gamma * h_bar
            eta = m ** (-kappa)
            log_eps_bar = eta * log_eps + (1 - eta) * log_eps_bar
            if it >= cfg.num_warmup // 2:
                warm_hist.append(z.clone())
            if it == int(cfg.num_warmup * 0.75) and warm_hist:
                h = torch.cat(warm_hist).double()
                inv_mass = (h.var(dim=0, unbiased=False) + 1e-6).to(dtype)

        eps_final = torch.exp(log_eps_bar).to(dtype)
        logger.info("HMC warmup done: step size %.4g", float(eps_final))

        # ---- sampling ----
        t_sampling = time.perf_counter()
        n_accept = torch.zeros((), dtype=torch.int64, device=dev)
        out_z = []
        total_iter = cfg.num_samples * cfg.use_every_nth
        evals_before = self.target.gradient_evaluations
        with span("SamplerHMC.sampling"):
            for it in range(total_iter):
                z, logp, grad, _, accept = self.step(
                    z, logp, grad, eps_final, inv_mass, *self.draws(C, D, dtype)
                )
                n_accept += accept.sum()
                if (it + 1) % cfg.use_every_nth == 0:
                    out_z.append(z.clone())
            n_accept = int(n_accept)
        sampling_seconds = time.perf_counter() - t_sampling
        # where the chains stand, with the adapted step size and mass
        self.state = (z, logp, grad)
        self.step_size, self.inv_mass = eps_final, inv_mass
        gradient_evaluations = self.target.gradient_evaluations - evals_before

        xs, xs_flat, lp_flat, ll_flat = emit(
            self.sample_handlers, torch.stack(out_z), self.target, self.ladder
        )
        elapsed = time.perf_counter() - t0
        accept_rate = n_accept / max(total_iter * C, 1)
        logger.info(
            "HMC: %d samples x %d chains in %.2fs (accept %.3f)",
            cfg.num_samples, C, elapsed, accept_rate,
        )
        return {
            "samples": xs_flat,
            "samples_per_chain": xs,  # (S, C, D)
            "log_prior": lp_flat,
            "log_likelihood": ll_flat,
            "temperatures": self.ladder,
            "accept_rate": accept_rate,
            "step_size": float(eps_final),
            "elapsed_seconds": elapsed,
            "sampling_seconds": sampling_seconds,
            "gradient_evaluations": gradient_evaluations,
        }
