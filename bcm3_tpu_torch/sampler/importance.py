"""Prior-importance sampler.

Counterpart of bcm3_tpu/sampler/importance.py (reference:
src/sampler/SamplerIS.cpp:47-90). The reference draws one prior sample
at a time on the host and evaluates the likelihood serially; here draws
come in batches of B from a `torch.Generator` on the sampler's device, and
each batch is evaluated by the prior's `log_pdf` and the likelihood's
`log_prob_batched` (on the card, the likelihood's kernel). Only the
running-max weight filter runs on the host.

Semantics preserved from the reference:
- weight of a sample is exp(log_likelihood) (``lweight = llh``);
- a running maximum of the log weight is kept and any sample with
  lweight < max - ln(1e10) = 23.02585 is dropped as "too small to
  contribute" (SamplerIS.cpp:70-76); dropped samples do not count
  toward the requested sample total;
- emitted chains have a single temperature of 1.0 (SamplerIS.cpp:29).
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Any, List

import numpy as np
import torch

logger = logging.getLogger(__name__)

LOG_WEIGHT_CUTOFF = 23.02585  # ln(1e10), reference: SamplerIS.cpp:73


@dataclass
class ISConfig:
    num_samples: int = 2500
    use_every_nth: int = 1
    seed: int = 0
    batch_size: int = 1024  # device batch per draw round
    max_rounds: int = 10_000
    device: str = "cuda"
    dtype: torch.dtype = torch.float64


def running_max_filter(xs, lp, ll, highest: float):
    """The reference's sequential running-max filter over one batch, in
    draw order (bcm3_tpu/sampler/importance.py:95-98): a row is kept if
    its log weight is within LOG_WEIGHT_CUTOFF of the maximum seen so far,
    this batch's earlier rows included, and its log-prior and
    log-likelihood are finite. Returns the kept (xs, lp, ll) and the new
    running maximum."""
    run_max = np.maximum.accumulate(np.maximum(ll, highest))
    keep = ll >= run_max - LOG_WEIGHT_CUTOFF
    keep &= np.isfinite(lp) & np.isfinite(ll)
    highest = max(highest, float(run_max[-1]))
    return xs[keep], lp[keep], ll[keep], highest


class SamplerIS:
    """Importance sampler: batched prior draws, weight = exp(llh)."""

    def __init__(self, prior, likelihood, config: ISConfig):
        self.prior = prior
        self.likelihood = likelihood
        self.config = config
        self.sample_handlers: List[Any] = []
        self.num_chains = 1
        self.num_ensembles = 1
        self.ladder = np.array([1.0])
        self.temperatures = self.ladder
        self.device = torch.device(config.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(config.seed)

    @property
    def expected_emitted_samples(self) -> int:
        return self.config.num_samples * self.config.use_every_nth

    def _batch_eval(self):
        """One batch of prior draws, their log-priors and their tempered
        log-likelihoods, on the host as numpy (float64 densities)."""
        cfg = self.config
        xs = self.prior.sample(self.generator, (cfg.batch_size,), cfg.dtype)
        lp = self.prior.log_pdf(xs)
        ll = self.likelihood.log_prob_batched(xs) * self.likelihood.learning_rate
        return (
            xs.cpu().numpy(),
            lp.cpu().numpy().astype(np.float64),
            ll.cpu().numpy().astype(np.float64),
        )

    def run(self):
        cfg = self.config
        # the reference counts emitted samples against
        # num_samples * use_every_nth (SamplerIS.cpp:55)
        target = cfg.num_samples * cfg.use_every_nth

        kept_x, kept_lp, kept_ll = [], [], []
        highest = -np.inf
        n_drawn = 0
        n_kept = 0
        t0 = time.time()
        for _ in range(cfg.max_rounds):
            if n_kept >= target:
                break
            xs, lp, ll = self._batch_eval()
            n_drawn += len(ll)
            xs, lp, ll, highest = running_max_filter(xs, lp, ll, highest)
            room = target - n_kept
            if len(ll) > room:
                xs, lp, ll = xs[:room], lp[:room], ll[:room]
            if len(ll):
                kept_x.append(xs)
                kept_lp.append(lp)
                kept_ll.append(ll)
                n_kept += len(ll)
        else:
            logger.warning(
                "Importance sampler hit max_rounds with %d/%d samples", n_kept, target
            )

        elapsed = time.time() - t0
        x = np.concatenate(kept_x, axis=0)[:, None, :]  # (S, 1, D)
        lprior = np.concatenate(kept_lp, axis=0)[:, None]
        llh = np.concatenate(kept_ll, axis=0)[:, None]
        weights = np.exp(llh)  # reference emits exp(lweight), SamplerIS.cpp:78
        logger.info(
            "Importance sampling: %d draws, %d kept, %.3fs (%.1f evals/s)",
            n_drawn,
            n_kept,
            elapsed,
            n_drawn / max(elapsed, 1e-9),
        )

        for handler in self.sample_handlers:
            handler.receive_samples(x, lprior, llh, self.ladder, weights=weights)

        return {
            "samples": x,
            "log_prior": lprior,
            "log_likelihood": llh,
            "weights": weights,
            "temperatures": self.ladder,
            "num_evaluations": n_drawn,
            "elapsed_seconds": elapsed,
        }
