"""No-U-Turn Sampler (NUTS) on torch tensors, chains in lockstep.

Counterpart of bcm3_tpu/sampler/nuts.py: multinomial NUTS with the
generalized U-turn criterion (Hoffman & Gelman 2014; Betancourt 2017),
built iteratively with O(max_tree_depth) momentum checkpoints whose
indices follow from the binary representation of the leaf index (Phan,
Pradhan & Jankowiak 2019), the biased progressive acceptance across
doublings (Betancourt 2017, A.3), and divergences (Delta H > 1000) ending
and rejecting a doubling.

The JAX package vmaps one chain's transition, and its `while_loop`s run
each chain to its own end. Here all C chains advance in lockstep: every
leaf is one batched gradient evaluation of all chains (on the card, for
PopPK `one`, kernel B1 forward and B1T backward; for the transit models
kernel B2J), and a chain whose tree or subtree has ended is masked, not
branched: it still goes through the evaluation, and its state does not
change. The doubling and the leaf
index are therefore the same for every chain that is still going, so the
checkpoint indices are host integers. The host reads one flag per leaf
(whether any chain is still growing its subtree) and one per doubling;
`host_syncs` counts them.

The transition takes its draws as inputs: the momentum's standard
normals, each doubling's direction bit and acceptance uniform, and each
leaf's selection uniform, so a test can derive them from a JAX key by the
JAX package's splits (nuts.py:151, :218, :285) and hold the transition to
the JAX package's.

Warmup follows Stan's windowed scheme as the JAX package does: dual
averaging of the step size toward `target_accept` throughout, restarted
at each window's end, and a diagonal mass from the positions of each
expanding window (75 | 25, 50, 100, ... | 50), merged batch by batch
(Chan et al.'s update, the same mean and M2 as the JAX package's row by
row Welford up to rounding).
"""

from __future__ import annotations

import logging
import math
import time
from dataclasses import dataclass
from typing import Any, List

import numpy as np
import torch

from bcm3_tpu_torch.sampler.hmc import LogPosterior, emit

logger = logging.getLogger(__name__)

_DIVERGENCE_THRESHOLD = 1000.0


@dataclass
class NUTSConfig:
    num_samples: int = 1000
    num_warmup: int = 500
    num_chains: int = 8
    max_tree_depth: int = 8
    target_accept: float = 0.8
    initial_step_size: float = 0.1
    seed: int = 0
    use_every_nth: int = 1
    device: str = "cuda"
    dtype: torch.dtype = torch.float64


def is_turning(inv_mass, r_left, r_right, r_sum):
    """Generalized U-turn criterion (Betancourt 2017, eq. A.4), over the last
    axis of (..., D) momenta."""
    mid = r_sum - 0.5 * (r_left + r_right)
    return ((inv_mass * r_left * mid).sum(dim=-1) <= 0.0) | (
        (inv_mass * r_right * mid).sum(dim=-1) <= 0.0
    )


def leaf_idx_to_ckpt_idxs(n: int):
    """Checkpoint range [idx_min, idx_max] a new leaf n is tested against:
    idx_max = popcount(n >> 1), idx_min = idx_max - (trailing one-bits of
    n) + 1 (bcm3_tpu/sampler/nuts.py:82-104)."""
    idx_max = bin(n >> 1).count("1")
    trailing = 0
    while (n >> trailing) & 1:
        trailing += 1
    return idx_max - trailing + 1, idx_max


def warmup_windows(num_warmup: int):
    """Stan's warmup schedule: 75 step-size-only, expanding mass windows
    25/50/100/..., 50 step-size-only at the end (bcm3_tpu/sampler/nuts.py:374-390)."""
    if num_warmup < 20:
        return [(0, num_warmup)]
    init = min(75, int(0.15 * num_warmup))
    term = min(50, int(0.1 * num_warmup))
    windows = []
    start = init
    size = 25
    while start + size < num_warmup - term:
        if start + 2 * size >= num_warmup - term:
            size = num_warmup - term - start  # merge the tail window
        windows.append((start, start + size))
        start += size
        size *= 2
    return windows


def num_draws(max_tree_depth: int) -> int:
    """Leaf selection uniforms a transition can use: 2^depth leaves in the
    doubling of each depth."""
    return 2**max_tree_depth - 1


class SamplerNUTS:
    """Batched multinomial NUTS over the posterior lprior + llh."""

    def __init__(self, prior, likelihood, config: NUTSConfig):
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
        self.host_syncs = 0

    @property
    def expected_emitted_samples(self) -> int:
        return self.config.num_samples * self.config.num_chains

    def _any(self, mask) -> bool:
        self.host_syncs += 1
        return bool(mask.any())

    def transition(self, z, logp, grad, eps, inv_mass, normal, forward, accept_u, select_u):
        """One NUTS transition of every chain (bcm3_tpu/sampler/nuts.py:139-358).

        z (C, D), logp (C,), grad (C, D): the current positions; eps: the
        step size; inv_mass (D,). Draws: `normal` (C, D) standard normals
        (the momentum), `forward` (max_depth, C) bool (doubling d grows to
        the right), `accept_u` (max_depth, C) uniforms (doubling d's biased
        acceptance), `select_u` (2^max_depth - 1, C) uniforms (leaf i of
        doubling d selects with row 2^d - 1 + i). Returns (z, logp, grad,
        accept statistic, diverging, tree depth), the last three (C,)."""
        max_depth = self.config.max_tree_depth
        C, D = z.shape
        dev = z.device
        r0 = normal / torch.sqrt(inv_mass)
        energy0 = logp - 0.5 * (inv_mass * r0 * r0).sum(dim=-1)

        def kinetic(r):
            return 0.5 * (inv_mass * r * r).sum(dim=-1)

        # the tree: both boundaries, the proposal, its log weight, statistics
        z_left, r_left, grad_left = z, r0, grad
        z_right, r_right, grad_right = z, r0, grad
        z_prop, logp_prop, grad_prop = z, logp, grad
        log_weight = torch.zeros_like(logp)
        r_sum = r0
        depth = torch.zeros(C, dtype=torch.int64, device=dev)
        turning = torch.zeros(C, dtype=torch.bool, device=dev)
        diverging = torch.zeros(C, dtype=torch.bool, device=dev)
        sum_accept = torch.zeros_like(logp)
        num_leaves = torch.zeros_like(logp)
        r_ckpts = torch.zeros((max_depth, C, D), dtype=z.dtype, device=dev)
        r_sum_ckpts = torch.zeros_like(r_ckpts)

        def col(mask):
            return mask[:, None]

        for d in range(max_depth):
            growing = ~turning & ~diverging  # depth == d on every such chain
            if not self._any(growing):
                break
            direction = torch.where(forward[d], 1.0, -1.0).to(z.dtype)
            e = (direction * eps)[:, None]
            right = col(forward[d])
            # the subtree starts at the boundary it grows from
            s_z = torch.where(right, z_right, z_left)
            s_r = torch.where(right, r_right, r_left)
            s_grad = torch.where(right, grad_right, grad_left)
            s_z_prop, s_logp_prop, s_grad_prop = z_prop, logp_prop, grad_prop
            s_log_weight = torch.full_like(logp, -math.inf)
            s_r_sum = torch.zeros_like(r0)
            s_leaves = torch.zeros_like(logp)
            s_turning = torch.zeros_like(turning)
            s_diverging = torch.zeros_like(diverging)
            s_accept = torch.zeros_like(logp)

            for leaf in range(2**d):
                live = growing & ~s_turning & ~s_diverging
                if leaf > 0 and not self._any(live):
                    break
                # one leapfrog step of every chain (the masked ones too)
                r1 = s_r + 0.5 * e * s_grad
                z1 = s_z + e * inv_mass * r1
                logp1, grad1 = self.target.value_and_grad(z1)
                r1 = r1 + 0.5 * e * grad1
                delta = logp1 - kinetic(r1) - energy0
                delta = torch.where(torch.isnan(delta), -math.inf, delta)
                div1 = delta < -_DIVERGENCE_THRESHOLD
                accept_prob = torch.clamp(torch.exp(delta), max=1.0)
                r_sum1 = s_r_sum + r1
                # multinomial proposal update within the subtree
                lw1 = torch.logaddexp(s_log_weight, delta)
                take = live & (torch.log(select_u[2**d - 1 + leaf]) < delta - lw1)
                s_z_prop = torch.where(col(take), z1, s_z_prop)
                s_logp_prop = torch.where(take, logp1, s_logp_prop)
                s_grad_prop = torch.where(col(take), grad1, s_grad_prop)
                # checkpoints and the U-turn checks inside the subtree
                lo, hi = leaf_idx_to_ckpt_idxs(leaf)
                if leaf % 2 == 0:
                    r_ckpts[hi] = r1
                    r_sum_ckpts[hi] = r_sum1
                    turn1 = torch.zeros_like(turning)
                else:
                    ck = r_ckpts[lo : hi + 1]
                    seg = r_sum1[None] - r_sum_ckpts[lo : hi + 1] + ck
                    turn1 = is_turning(inv_mass, ck, r1[None], seg).any(dim=0)
                s_z = torch.where(col(live), z1, s_z)
                s_r = torch.where(col(live), r1, s_r)
                s_grad = torch.where(col(live), grad1, s_grad)
                s_log_weight = torch.where(live, lw1, s_log_weight)
                s_r_sum = torch.where(col(live), r_sum1, s_r_sum)
                s_turning = torch.where(live, turn1, s_turning)
                s_diverging = torch.where(live, div1, s_diverging)
                s_accept = torch.where(live, s_accept + accept_prob, s_accept)
                s_leaves = s_leaves + live.to(s_leaves.dtype)

            # the doubling's outcome, on the chains that grew
            ok = ~s_turning & ~s_diverging
            take = growing & ok & (torch.log(accept_u[d]) < s_log_weight - log_weight)
            z_prop = torch.where(col(take), s_z_prop, z_prop)
            logp_prop = torch.where(take, s_logp_prop, logp_prop)
            grad_prop = torch.where(col(take), s_grad_prop, grad_prop)
            g = col(growing)
            z_left = torch.where(g & ~right, s_z, z_left)
            r_left = torch.where(g & ~right, s_r, r_left)
            grad_left = torch.where(g & ~right, s_grad, grad_left)
            z_right = torch.where(g & right, s_z, z_right)
            r_right = torch.where(g & right, s_r, r_right)
            grad_right = torch.where(g & right, s_grad, grad_right)
            r_sum_new = r_sum + s_r_sum
            turning_full = is_turning(inv_mass, r_left, r_right, r_sum_new)
            r_sum = torch.where(g, r_sum_new, r_sum)
            log_weight = torch.where(growing, torch.logaddexp(log_weight, s_log_weight),
                                     log_weight)
            depth = depth + growing.to(depth.dtype)
            turning = torch.where(growing, s_turning | (ok & turning_full), turning)
            diverging = torch.where(growing, s_diverging, diverging)
            sum_accept = torch.where(growing, sum_accept + s_accept, sum_accept)
            num_leaves = torch.where(growing, num_leaves + s_leaves, num_leaves)

        accept_stat = sum_accept / torch.clamp(num_leaves, min=1.0)
        return z_prop, logp_prop, grad_prop, accept_stat, diverging, depth

    def draws(self, C, D, dtype):
        """The draws of one transition from the sampler's generator."""
        g, dev = self.generator, self.device
        M = self.config.max_tree_depth
        normal = torch.randn((C, D), generator=g, dtype=dtype, device=dev)
        u = torch.rand((2 * M + num_draws(M), C), generator=g, dtype=dtype, device=dev)
        return normal, u[:M] < 0.5, u[M : 2 * M], u[2 * M :]

    def run(self, x0=None):
        """Warmup and sampling. The chains start at `x0` (C, D) where given,
        else at C prior draws, as the JAX package's do (a start of density
        -inf never moves, and its leaves, diverging, count as rejections in
        the step size's adaptation: ROADMAP C)."""
        cfg = self.config
        D = self.prior.num_variables
        C = cfg.num_chains
        dtype = cfg.dtype
        dev = self.device

        if x0 is None:
            x0 = self.prior.sample(self.generator, (C,), dtype)
        zs = self.target.reparam.from_x(torch.as_tensor(x0, dtype=dtype, device=dev))
        logps, grads = self.target.value_and_grad(zs)
        t0 = time.time()

        # ---- warmup: dual averaging + windowed diagonal mass, state on
        # the device (float64) so that no iteration waits for the host ----
        f64 = dict(dtype=torch.float64, device=dev)
        mu = torch.tensor(math.log(10.0 * cfg.initial_step_size), **f64)
        log_eps = torch.tensor(math.log(cfg.initial_step_size), **f64)
        log_eps_bar = torch.zeros((), **f64)
        h_bar = torch.zeros((), **f64)
        gamma, t0_da, kappa = 0.05, 10.0, 0.75
        inv_mass = torch.ones(D, dtype=dtype, device=dev)

        windows = warmup_windows(cfg.num_warmup)
        win_ix = 0
        w_n, w_mean, w_m2 = 0, torch.zeros(D, **f64), torch.zeros(D, **f64)
        n_div_warm = torch.zeros((), dtype=torch.int64, device=dev)
        # the dual-averaging counter is window-local, as in Stan (see
        # bcm3_tpu/sampler/nuts.py:452-459)
        da_m = 0
        for it in range(cfg.num_warmup):
            zs, logps, grads, astat, div, _ = self.transition(
                zs, logps, grads, torch.exp(log_eps).to(dtype), inv_mass,
                *self.draws(C, D, dtype),
            )
            n_div_warm += div.sum()
            da_m += 1
            a = torch.nan_to_num(astat, nan=0.0).double().mean()
            h_bar = (1 - 1 / (da_m + t0_da)) * h_bar + (cfg.target_accept - a) / (da_m + t0_da)
            log_eps = mu - math.sqrt(da_m) / gamma * h_bar
            eta = da_m ** (-kappa)
            log_eps_bar = eta * log_eps + (1 - eta) * log_eps_bar

            if win_ix < len(windows):
                lo, hi = windows[win_ix]
                if lo <= it < hi:
                    # merge the batch of C positions into the running moments
                    b = zs.double()
                    b_mean = b.mean(dim=0)
                    b_m2 = ((b - b_mean) ** 2).sum(dim=0)
                    n1 = w_n + C
                    delta = b_mean - w_mean
                    w_mean = w_mean + delta * (C / n1)
                    w_m2 = w_m2 + b_m2 + delta * delta * (w_n * C / n1)
                    w_n = n1
                if it == hi - 1:
                    if w_n > 4:
                        var = w_m2 / (w_n - 1)
                        # Stan's shrinkage toward the unit metric
                        var = (w_n / (w_n + 5.0)) * var + 1e-3 * (5.0 / (w_n + 5.0))
                        inv_mass = var.to(dtype)
                    # restart dual averaging around the current step size
                    mu = math.log(10.0) + log_eps
                    log_eps_bar = torch.zeros((), **f64)
                    h_bar = torch.zeros((), **f64)
                    da_m = 0
                    w_n, w_mean, w_m2 = 0, torch.zeros(D, **f64), torch.zeros(D, **f64)
                    win_ix += 1

        eps_final = torch.exp(log_eps_bar).to(dtype)
        logger.info(
            "NUTS warmup done: step size %.4g, %d divergences",
            float(eps_final), int(n_div_warm),
        )

        # ---- sampling: step size and mass frozen ----
        t_sampling = time.time()
        out_z = []
        n_div = torch.zeros((), dtype=torch.int64, device=dev)
        depth_sum = torch.zeros((), dtype=torch.int64, device=dev)
        total_iter = cfg.num_samples * cfg.use_every_nth
        evals_before = self.target.gradient_evaluations
        syncs_before = self.host_syncs
        with torch.profiler.record_function("SamplerNUTS.sampling"):
            for it in range(total_iter):
                zs, logps, grads, _, div, depth = self.transition(
                    zs, logps, grads, eps_final, inv_mass, *self.draws(C, D, dtype)
                )
                n_div += div.sum()
                depth_sum += depth.sum()
                if (it + 1) % cfg.use_every_nth == 0:
                    out_z.append(zs.clone())
            n_div, depth_sum = int(n_div), int(depth_sum)
        sampling_seconds = time.time() - t_sampling
        # where the chains stand, with the adapted step size and mass
        self.state = (zs, logps, grads)
        self.step_size, self.inv_mass = eps_final, inv_mass
        transitions = max(total_iter, 1)
        grad_evals = self.target.gradient_evaluations - evals_before
        syncs = self.host_syncs - syncs_before

        xs, xs_flat, lp_flat, ll_flat = emit(
            self.sample_handlers, torch.stack(out_z), self.target, self.ladder
        )
        elapsed = time.time() - t0
        mean_depth = depth_sum / max(total_iter * C, 1)
        logger.info(
            "NUTS: %d samples x %d chains in %.2fs (%d divergences, mean tree depth %.2f)",
            cfg.num_samples, C, elapsed, n_div, mean_depth,
        )
        return {
            "samples": xs_flat,
            "samples_per_chain": xs,
            "log_prior": lp_flat,
            "log_likelihood": ll_flat,
            "temperatures": self.ladder,
            "divergences": n_div,
            "mean_tree_depth": mean_depth,
            "step_size": float(eps_final),
            "elapsed_seconds": elapsed,
            # the post-warmup loop alone: the number to divide ESS by
            "sampling_seconds": sampling_seconds,
            # batched gradient evaluations (all C chains each) and host
            # reads of the sampling loop, per transition
            "gradient_evaluations_per_transition": grad_evals / transitions,
            "host_syncs_per_transition": syncs / transitions,
        }
