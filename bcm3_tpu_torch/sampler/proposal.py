"""Adaptive block proposals for the PT sampler, on torch tensors.

Counterpart of bcm3_tpu/sampler/proposal.py (reference: src/sampler/Proposal.cpp,
ProposalGaussianMixture.cpp, ProposalGlobalCovariance.cpp). A proposal for
one variable block keeps the JAX package's shared layout: the mixture
parameters (means, Cholesky factors, weights) are stored once per LADDER
POSITION, (L, K, ...), and broadcast to every ensemble, while the adaptive
scale state is per chain, (C, K) with C = E * L and chain c at ladder
position c % L. Every function works on explicit (E, L) batch dimensions,
so nothing of shape (C, K, d, d) is ever made (see proposal.py:240-252 of
the JAX package).

Every function takes its random numbers as tensor arguments: Gumbel noise
for the component pick (what `jax.random.categorical` adds to the logits),
standard normals `z` for the step and uniforms `u` for the scale update.
A run draws them from the sampler's `torch.Generator`; a test can feed the
JAX package's own draws and compare step for step.

Semantics as in the reference:
- responsibility-weighted component selection and per-component adaptive
  scales initialized to 2.38/sqrt(d) (ProposalGaussianMixture.cpp:20-42, 248)
- the mixture MH correction including its -log(scale^2)
  (ProposalGaussianMixture.cpp:44-63)
- acceptance-rate-EMA stochastic scale adaptation, clamped to [1e-4, 10]
  (ProposalGaussianMixture.cpp:65-99, Proposal.cpp:201-222)
- reflect-on-bounds for bounded priors (Proposal.cpp:385-397)
- dimension-dependent target acceptance rates 0.44/0.35/0.30/0.234
  (Proposal.cpp:47-55)
- the t-distributed proposal's Gamma(nu/2, scale=nu/2) mixing variable
  (ProposalGlobalCovariance.cpp:17-23 with RNG::GetGamma's shape/scale
  convention, src/utils/RNG.cpp:84-110), with the MH ratio kept Gaussian,
  as the JAX package has both
- clustered covariance (ProposalClusteredCovariance.cpp:26-84): the
  component is the spectral cluster of the chain's full position
  (bcm3_tpu_torch/sampler/spectral.py), and the MH ratio is 0 within a
  cluster, else the ratio of the two clusters' step densities

The JAX package also has per-chain forms of every function (`propose`,
`propose_clustered`, ...), for proposals whose mixture arrays are stored
per chain. The port's adaptation always builds one mixture per ladder
position, so it has the shared-layout functions only.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

SCALING_EMA_PERIOD = 1000.0
SCALING_LEARNING_RATE = 0.05

RULE_GMM = 0  # ProposalGaussianMixture::Update
RULE_BASE = 1  # Proposal::Update (used by global_covariance)


def target_acceptance_rate(num_variables: int) -> float:
    """reference: Proposal.cpp:47-55."""
    if num_variables == 1:
        return 0.44
    if num_variables == 2:
        return 0.35
    if num_variables == 3:
        return 0.3
    return 0.234


@dataclass
class BlockProposal:
    """Adaptive mixture proposal for one variable block.

    L = ladder positions, C = E * L chains, K = padded component count,
    d = block size. Padding components have log_weights = -inf and
    identity Cholesky factors."""

    means: torch.Tensor  # (L, K, d)
    chols: torch.Tensor  # (L, K, d, d) lower
    inv_chols: torch.Tensor  # (L, K, d, d) lower, chols^-1
    log_weights: torch.Tensor  # (L, K), -inf on padding
    log_c: torch.Tensor  # (L, K) log MVN normalization constants
    scales: torch.Tensor  # (C, K) per-component adaptive scales
    acc_ema: torch.Tensor  # (C, K) acceptance-rate EMAs
    selected: torch.Tensor  # (C,) int64, component of the previous draw; -1 none
    t_dof: float = 0.0
    target_accept: float = 0.234
    update_rule: int = RULE_GMM
    symmetric: bool = False  # True for global_covariance (MH ratio 0)
    # clustered_covariance: component = the chain's spectral cluster, not a
    # responsibility draw (reference: ProposalClusteredCovariance.cpp:26-56)
    clustered: bool = False

    @property
    def ladder_size(self) -> int:
        return self.means.shape[0]

    @property
    def max_components(self) -> int:
        return self.means.shape[1]


def reflect_on_bounds(x, lower, upper):
    """Closed form of the reference's reflection loop (Proposal.cpp:385-397):
    fold x into [lower, upper] as a triangle wave. Infinite bounds pass
    through unchanged. The fold is a floor modulo (torch.remainder), as
    jnp.mod is, so x below `lower` folds the right way."""
    span = upper - lower
    finite = torch.isfinite(lower) & torch.isfinite(upper)
    safe_span = torch.where(finite, span, 1.0)
    y = torch.remainder(x - lower, 2.0 * safe_span)
    y = torch.where(y > safe_span, 2.0 * safe_span - y, y)
    folded = lower + y
    # one-sided bounds: reflect once off the finite side
    lo_only = torch.isfinite(lower) & ~torch.isfinite(upper)
    hi_only = ~torch.isfinite(lower) & torch.isfinite(upper)
    folded = torch.where(lo_only, lower + (x - lower).abs(), folded)
    folded = torch.where(hi_only, upper - (upper - x).abs(), folded)
    return torch.where(finite | lo_only | hi_only, folded, x)


def _per_chain(a: torch.Tensor, E: int) -> torch.Tensor:
    """(L, ...) ladder-position values -> (E * L, ...) chain values."""
    return a.repeat((E,) + (1,) * (a.dim() - 1))


def update_scales(prop: BlockProposal, u: torch.Tensor) -> BlockProposal:
    """Adaptive scale update for every chain; u: (C,) uniforms (reference:
    ProposalGaussianMixture.cpp:66-86 for the GMM rule, Proposal.cpp:201-212
    for the base rule used by global_covariance)."""
    lr = SCALING_LEARNING_RATE
    t = prop.target_accept
    C, K = prop.scales.shape
    rows = torch.arange(C, device=u.device)
    if prop.update_rule == RULE_GMM:
        n_active = torch.isfinite(prop.log_weights).sum(dim=-1).to(u.dtype)
        n_active = _per_chain(n_active, C // prop.ladder_size)
        learn_rate = 1.0 + u * lr * n_active
        valid = prop.selected >= 0
        sel = torch.clamp(prop.selected, 0, K - 1)
        down_thr, up_thr = t / (1.0 - lr), (1.0 + lr) * t
    else:
        learn_rate = 1.0 + u * lr
        valid = torch.ones(C, dtype=torch.bool, device=u.device)
        sel = torch.zeros(C, dtype=torch.long, device=u.device)
        down_thr, up_thr = 0.952381 * t, 1.05 * t
    ema = prop.acc_ema[rows, sel]
    scale = prop.scales[rows, sel]
    new_scale = torch.where(
        ema < down_thr,
        torch.clamp(scale / learn_rate, min=1e-4),
        torch.where(ema > up_thr, torch.clamp(scale * learn_rate, max=10.0), scale),
    )
    scales = prop.scales.clone()
    scales[rows, sel] = torch.where(valid, new_scale, scale)
    return dataclasses.replace(prop, scales=scales)


def notify_accepted(prop: BlockProposal, accepted: torch.Tensor) -> BlockProposal:
    """EMA update of the selected component for every chain; accepted:
    (C,) bool (reference: ProposalGaussianMixture.cpp:89-99; the base rule,
    Proposal.cpp:214-222, also has the single slot 0)."""
    ema_alpha = 2.0 / (SCALING_EMA_PERIOD + 1.0)
    C, K = prop.acc_ema.shape
    rows = torch.arange(C, device=accepted.device)
    sel = torch.clamp(prop.selected, 0, K - 1)
    target = accepted.to(prop.acc_ema.dtype)
    old = prop.acc_ema[rows, sel]
    acc_ema = prop.acc_ema.clone()
    acc_ema[rows, sel] = old + (target - old) * ema_alpha
    return dataclasses.replace(prop, acc_ema=acc_ema)


def _ensemble_log_pdfs(prop: BlockProposal, x_el):
    """(E, L, K) log N(x; mean_lk, Sigma_lk); mixture fields at (L, ...)."""
    diff = x_el[:, :, None, :] - prop.means[None]  # (E, L, K, d)
    s = torch.einsum("lkij,elkj->elki", prop.inv_chols, diff)
    return prop.log_c[None] - 0.5 * (s * s).sum(dim=-1)


def _ensemble_log_resp(prop: BlockProposal, x_el):
    lp = _ensemble_log_pdfs(prop, x_el) + prop.log_weights[None]
    return lp - torch.logsumexp(lp, dim=-1, keepdim=True)


def propose_ensemble(
    prop: BlockProposal, x_el, lower, upper, gumbel_el, z_el, gamma_el=None
):
    """New block positions for every (ensemble, ladder) lane.

    x_el: (E, L, d); gumbel_el: (E, L, K) standard Gumbel noise for the
    component pick; z_el: (E, L, d) standard normals; gamma_el: (E, L)
    Gamma(nu/2, 1) draws, needed when prop.t_dof = nu > 0. Returns
    (new_block (E, L, d), selected (E, L) int64, log_resp (E, L, K)); the
    forward responsibilities are returned so `mh_log_ratio_ensemble` can
    reuse them (reference: ProposalGaussianMixture.cpp:20-42)."""
    E, L, d = x_el.shape
    log_resp = _ensemble_log_resp(prop, x_el)  # (E, L, K)
    sel = torch.argmax(gumbel_el + log_resp, dim=-1)  # (E, L)
    # steps for every component through the shared factors, then a pick:
    # never a per-chain (C, d, d) gather
    steps = torch.einsum("lkij,elj->elki", prop.chols, z_el)  # (E, L, K, d)
    step = steps.gather(2, sel[:, :, None, None].expand(E, L, 1, d))[:, :, 0]
    scale_sel = prop.scales.reshape(E, L, -1).gather(2, sel[:, :, None])
    if prop.t_dof > 0.0:
        # the reference's quirk, kept as the JAX package keeps it:
        # w ~ Gamma(nu/2, SCALE=nu/2), so the step scales by rsqrt(g nu/2)
        scale_sel = torch.rsqrt(gamma_el * (0.5 * prop.t_dof))[..., None] * scale_sel
    new_block = reflect_on_bounds(x_el + step * scale_sel, lower, upper)
    return new_block, sel, log_resp


def mh_log_ratio_ensemble(prop: BlockProposal, x_el, new_el, log_fwd_resp=None):
    """Mixture MH correction for every lane, (E, L) (reference:
    ProposalGaussianMixture.cpp:44-63, with its -log(scale^2) whatever the
    block dimension). Pass `log_fwd_resp` (the responsibilities at x_el
    that `propose_ensemble` returned) to skip one mixture pass."""
    if prop.symmetric:
        return torch.zeros(x_el.shape[:2], dtype=x_el.dtype, device=x_el.device)
    E, L, d = x_el.shape
    if log_fwd_resp is None:
        log_fwd_resp = _ensemble_log_resp(prop, x_el)
    log_rev_resp = _ensemble_log_resp(prop, new_el)
    scales_el = prop.scales.reshape(E, L, -1)
    v = (new_el - x_el)[:, :, None, :] / scales_el[..., None]  # (E, L, K, d)
    s = torch.einsum("lkij,elkj->elki", prop.inv_chols, v)
    # the Gaussian is symmetric in v: forward and reverse Mahalanobis
    # terms are equal, only the responsibilities differ
    base = -2.0 * torch.log(scales_el) + prop.log_c[None] - 0.5 * (s * s).sum(-1)
    fwd = torch.logsumexp(base + log_fwd_resp, dim=-1)
    rev = torch.logsumexp(base + log_rev_resp, dim=-1)
    return rev - fwd


def propose_clustered_ensemble(
    prop: BlockProposal, x_el, cluster_el, lower, upper, z_el, gamma_el=None
):
    """New block positions for every (ensemble, ladder) lane of a clustered
    proposal: the component is the lane's cluster (E, L), clamped to the
    components, instead of a responsibility draw (reference:
    ProposalClusteredCovariance.cpp GetNewSample:26-56). z_el: (E, L, d)
    standard normals; gamma_el: (E, L) Gamma(nu/2, 1) draws for t steps.
    Returns (new_block (E, L, d), selected (E, L) int64)."""
    E, L, d = x_el.shape
    sel = torch.clamp(cluster_el, 0, prop.max_components - 1)
    steps = torch.einsum("lkij,elj->elki", prop.chols, z_el)  # (E, L, K, d)
    step = steps.gather(2, sel[:, :, None, None].expand(E, L, 1, d))[:, :, 0]
    scale_sel = prop.scales.reshape(E, L, -1).gather(2, sel[:, :, None])
    if prop.t_dof > 0.0:
        # the same Gamma(nu/2, scale=nu/2) mixing quirk as the mixture
        # proposal (reference: ProposalClusteredCovariance.cpp:37-43)
        scale_sel = torch.rsqrt(gamma_el * (0.5 * prop.t_dof))[..., None] * scale_sel
    return reflect_on_bounds(x_el + step * scale_sel, lower, upper), sel


def mh_log_ratio_clustered_ensemble(
    prop: BlockProposal, x_el, new_el, cur_cluster_el, new_cluster_el
):
    """MH correction of a clustered move for every lane, (E, L) (reference:
    ProposalClusteredCovariance.cpp CalculateMHRatio:58-84): 0 within a
    cluster; across clusters the ratio of the two clusters' densities of
    the step (symmetric in its sign), each with its -log(scale^2)."""
    E, L, d = x_el.shape
    K = prop.max_components
    cc = torch.clamp(cur_cluster_el, 0, K - 1)
    nc = torch.clamp(new_cluster_el, 0, K - 1)
    scales_el = prop.scales.reshape(E, L, K)
    v = (new_el - x_el)[:, :, None, :] / scales_el[..., None]  # (E, L, K, d)
    s = torch.einsum("lkij,elkj->elki", prop.inv_chols, v)
    base = -2.0 * torch.log(scales_el) + prop.log_c[None] - 0.5 * (s * s).sum(-1)
    log_fwd = base.gather(2, cc[..., None])[..., 0]
    log_bwd = base.gather(2, nc[..., None])[..., 0]
    return torch.where(cc == nc, 0.0, log_bwd - log_fwd)


def build_block_proposal(
    gmms,
    num_chains: int,
    block_dim: int,
    dtype: torch.dtype,
    device,
    t_dof: float = 0.0,
    proposal_type: str = "gaussian_mixture",
) -> BlockProposal:
    """Assemble a BlockProposal from host GMM fits, one per LADDER POSITION
    (bcm3_tpu_torch.stats.gmm.GMM objects), shared by every ensemble;
    the scale state is per chain. Components are padded to the max K; a
    clustered proposal's GMMs must all have K components, component index
    = cluster index."""
    K = max(g.num_components for g in gmms)
    clustered = proposal_type == "clustered_covariance"
    if clustered and any(g.num_components != K for g in gmms):
        raise ValueError(
            "clustered proposals require component index == cluster index; "
            "every ladder position must carry exactly num_clusters components"
        )
    d = block_dim
    n_mix = len(gmms)
    means = np.zeros((n_mix, K, d))
    chols = np.tile(np.eye(d), (n_mix, K, 1, 1))
    inv_chols = np.tile(np.eye(d), (n_mix, K, 1, 1))
    log_w = np.full((n_mix, K), -np.inf)
    log_c = np.zeros((n_mix, K))
    ta = target_acceptance_rate(d)

    from scipy.linalg import solve_triangular

    inv_cache: dict[int, np.ndarray] = {}
    for c, g in enumerate(gmms):
        k = g.num_components
        means[c, :k] = g.means
        chols[c, :k] = g.chols
        if id(g) not in inv_cache:
            inv_cache[id(g)] = np.stack(
                [solve_triangular(g.chols[ki], np.eye(d), lower=True) for ki in range(k)]
            )
        inv_chols[c, :k] = inv_cache[id(g)]
        with np.errstate(divide="ignore"):
            log_w[c, :k] = np.log(g.weights)
        log_c[c, :k] = g.log_c

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    return BlockProposal(
        means=t(means),
        chols=t(chols),
        inv_chols=t(inv_chols),
        log_weights=t(log_w),
        log_c=t(log_c),
        scales=torch.full((num_chains, K), 2.38 / np.sqrt(d), dtype=dtype, device=device),
        acc_ema=torch.full((num_chains, K), ta, dtype=dtype, device=device),
        selected=torch.full((num_chains,), -1, dtype=torch.long, device=device),
        t_dof=float(t_dof),
        target_accept=ta,
        update_rule=RULE_BASE if proposal_type == "global_covariance" else RULE_GMM,
        symmetric=proposal_type == "global_covariance",
        clustered=clustered,
    )
