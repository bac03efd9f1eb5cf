"""Batched GMM EM on a torch device, for proposal adaptation.

Counterpart of the JAX package's bcm3_tpu/stats/gmm_device.py. The host EM
(bcm3_tpu_torch/stats/gmm.py, a mirror of the reference's GMM fit,
src/stats/GMM.cpp Fit:48-160) fits one (component count, retry) at a time;
here every fit of a component count runs as one batch of tensor
operations on the sampler's device. The M-step's ESS-aware eigenvalue
shrinkage (GMM.cpp CalculateMeanCovariance:248-336) is a batched
`torch.linalg.eigh`, and the E-step reads the M-step's factorization, so
each EM step runs exactly one eigendecomposition per component.

Semantics as in the JAX package, with its two documented deviations from
the host path:
- k-means++ seeds for all retries are drawn up front from the host
  `np.random.Generator` (the host path draws a retry's seed only when the
  previous retry failed), so the RNG stream differs from the host path's
  and equals the JAX package's device path draw for draw;
- all retries run at once and the first converged one (else the last
  non-singular one) is selected.
Selection across component counts (AIC with ESS gating, the adjusted-AIC
incumbent quirk) is the host path's (reference:
ProposalGaussianMixture.cpp InitializeImpl:129-210).

The JAX package runs each fit's early exit as a `lax.while_loop`. Here the
EM is a Python loop of at most `_MAX_EM_STEPS` batched steps with per-fit
freeze flags: a fit that stopped keeps its state while the others run on.
The loop asks the device whether every fit has stopped only every
`_STOP_CHECK_EVERY` steps, so the check is not a host sync per step (the
steps run after the last fit stopped change nothing).

The fits run in float64 on the device the caller names (the sampler's);
nothing here moves to another device.

Given a `stats` dict, the fit also sums the seconds spent in the
eigendecomposition, timed with CUDA events on a card (no host sync per
step) and with the host clock on the CPU.
"""

from __future__ import annotations

import contextlib
import math
import time
from typing import Optional

import numpy as np
import torch

from bcm3_tpu_torch.stats.gmm import (
    COMPONENT_LADDER,
    GMM,
    _EM_RETRIES,
    _LOGL_EPSILON,
    _MAX_EM_STEPS,
    _kmeanspp,
    fit_gmm,
)
from bcm3_tpu_torch.stats.summary import effective_sample_size

_STOP_CHECK_EVERY = 4


class _Clock:
    """Seconds of a code region summed over its runs: CUDA events around
    each run on a card, read once at the end; the host clock elsewhere."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.events = []
        self.host_seconds = 0.0

    @contextlib.contextmanager
    def region(self):
        if self.cuda:
            start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            yield
            stop.record()
            self.events.append((start, stop))
        else:
            t = time.perf_counter()
            yield
            self.host_seconds += time.perf_counter() - t

    def seconds(self) -> float:
        if self.events:
            self.events[-1][1].synchronize()
        return self.host_seconds + sum(a.elapsed_time(b) for a, b in self.events) / 1e3


def _m_step(samples, resp, active, ess_factor, clock: Optional[_Clock] = None):
    """Batched weighted mean/covariance with eigenvalue shrinkage
    (reference: GMM.cpp CalculateMeanCovariance:248-336).

    samples (F, n, D), resp (F, n, K), active (F, K) bool, ess_factor (F,).
    Returns (mean (F, K, D), cov_out (F, K, D, D), weights (F, K), factor,
    margin) where factor = (sd, V, lam, comp_pd) factors cov_out in
    correlation space, cov_out = diag(sd) V diag(lam) V^T diag(sd), as in
    the JAX package: the +1e-8*I jitter is a floor on the correlation
    eigenvalues, and the degenerate branches (diag-only, low weight,
    inactive) are V = I with the matching lam. margin (F,) is the singular
    test's least |margin| over the fit's tested components (see below)."""
    F, n, D = samples.shape
    finfo = torch.finfo(samples.dtype)
    w = torch.where(resp >= finfo.eps, resp, 0.0)  # (F, n, K)
    wsum = w.sum(dim=1)  # (F, K)
    safe_wsum = torch.clamp(wsum, min=finfo.tiny)
    mean = torch.einsum("fnk,fnd->fkd", w, samples) / safe_wsum[..., None]
    grand_mean = samples.mean(dim=1)  # (F, D)
    low_w = wsum < 2.0
    mean = torch.where(low_w[..., None], grand_mean[:, None, :], mean)

    d = samples[:, None, :, :] - mean[:, :, None, :]  # (F, K, n, D)
    wd = w.transpose(1, 2)[..., None] * d
    cov = wd.transpose(-1, -2) @ d / torch.clamp(wsum - 1.0, min=finfo.tiny)[..., None, None]

    # regularization
    n_eff = wsum / ess_factor[:, None]
    diag_only = n_eff < 2.0
    n_eff = torch.clamp(n_eff, min=float(D))

    var = torch.diagonal(cov, dim1=-2, dim2=-1)  # (F, K, D)
    sd = torch.sqrt(torch.clamp(var, min=0.0))
    sd = torch.where(sd > 0, sd, 1e-30)
    corr = cov / (sd[..., :, None] * sd[..., None, :])
    eye = torch.eye(D, dtype=samples.dtype, device=samples.device)
    corr = corr * (1.0 - eye) + eye

    # jnp.linalg.eigh symmetrizes its input, (A + A^T) / 2, where
    # torch.linalg.eigh reads one triangle: symmetrize as it does (the
    # product above is symmetric only up to rounding, and the singular
    # test below reads eigenvalues at the rounding level). torch's eigh
    # also refuses a matrix with a non-finite entry, where jnp's returns
    # NaNs (and the fit goes singular): give it the identity there and put
    # the NaNs back
    corr = 0.5 * (corr + corr.transpose(-1, -2))
    bad = ~torch.isfinite(corr).all(dim=-1).all(dim=-1)  # (F, K)
    with clock.region() if clock is not None else contextlib.nullcontext():
        eigval, eigvec = torch.linalg.eigh(torch.where(bad[..., None, None], eye, corr))
    eigval = torch.where(bad[..., None], math.nan, eigval)  # ascending
    eigvec = torch.where(bad[..., None, None], math.nan, eigvec)

    # descending-position shrinkage: position i (descending) scaled by
    # n_eff/(n_eff + D + 1 - 2i) while i < floor(n_eff), zeroed beyond
    i_desc = torch.arange(D, dtype=samples.dtype, device=samples.device)
    factor = n_eff[..., None] / (n_eff[..., None] + D + 1.0 - 2.0 * i_desc)
    keep = i_desc < torch.floor(n_eff)[..., None]
    eig_desc = torch.flip(eigval, dims=(-1,))
    shrunk = torch.flip(torch.where(keep, eig_desc * factor, 0.0), dims=(-1,))

    # singularity in correlation space: a shrunk spectrum that is not
    # positive beyond eigh noise is what the host path's Cholesky rejects
    tol = D * finfo.eps * torch.amax(shrunk.abs(), dim=-1, keepdim=True)
    comp_pd = (shrunk > -tol).all(dim=-1)
    lam = torch.maximum(shrunk, torch.clamp(tol, min=1e-8))
    # the test's margin: the least shrunk eigenvalue in units of tol. At or
    # below -1 the test fails; within a few units of 0 the correlation is
    # rank-deficient and the sign of eigh's rounding decides the test
    margin = (torch.amin(shrunk, dim=-1) / torch.clamp(tol[..., 0], min=finfo.tiny)).abs()

    corr_reg = (eigvec * lam[..., None, :]) @ eigvec.transpose(-1, -2)
    cov_reg = corr_reg * (sd[..., :, None] * sd[..., None, :])

    diag_cov = var[..., None] * eye
    cov_out = torch.where(diag_only[..., None, None], diag_cov, cov_reg)
    cov_out = torch.where(low_w[..., None, None], eye, cov_out)
    # inactive padding components: identity (never used)
    cov_out = torch.where(active[..., None, None], cov_out, eye)
    mean = torch.where(active[..., None], mean, 0.0)
    weights = torch.where(active, wsum / n, 0.0)

    # factored form matching cov_out's branches
    degenerate = diag_only | low_w | ~active
    sd_fac = torch.where(
        (low_w | ~active)[..., None],
        1.0,
        torch.where(diag_only[..., None], torch.sqrt(torch.clamp(var, min=1e-30)), sd),
    )
    V = torch.where(degenerate[..., None, None], eye, eigvec)
    lam_fac = torch.where(degenerate[..., None], 1.0, lam)
    margin = torch.where(degenerate, math.inf, margin).amin(dim=-1)  # (F,)
    return mean, cov_out, weights, (sd_fac, V, lam_fac, comp_pd | degenerate), margin


def _e_step(samples, means, fac, weights, active):
    """Batched expectation (reference: GMM.cpp EM_expectation) from the
    M-step's factorization: no factorization runs here. Returns
    (resp (F, n, K), logl (F,), singular (F,))."""
    F, n, D = samples.shape
    sd, V, lam, comp_pd = fac
    singular = ~(comp_pd | ~active).all(dim=-1)
    log_c = (
        -0.5 * torch.log(lam).sum(dim=-1)
        - torch.log(sd).sum(dim=-1)
        - 0.5 * D * math.log(2.0 * math.pi)
    )  # (F, K)
    diff = (samples[:, None, :, :] - means[:, :, None, :]) / sd[:, :, None, :]
    proj = (diff @ V) * torch.rsqrt(lam)[:, :, None, :]  # (F, K, n, D)
    quad = -0.5 * (proj * proj).sum(dim=-1)  # (F, K, n)
    logw = torch.where(
        active & (weights > 0), torch.log(torch.clamp(weights, min=1e-300)), -math.inf
    )
    comp_lp = (log_c[..., None] + quad + logw[..., None]).transpose(1, 2)  # (F, n, K)
    m = torch.amax(comp_lp, dim=-1, keepdim=True)
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    sum_exp = torch.exp(comp_lp - m_safe).sum(dim=-1)
    sample_logl = m_safe[..., 0] + torch.log(torch.clamp(sum_exp, min=1e-300))
    logl = sample_logl.sum(dim=-1)
    resp = torch.exp(comp_lp - sample_logl[..., None])
    zero_rows = resp.sum(dim=-1) == 0
    k_active = torch.clamp(active.sum(dim=-1), min=1)
    uniform = torch.where(active, 1.0 / k_active[:, None].to(samples.dtype), 0.0)
    resp = torch.where(zero_rows[..., None], uniform[:, None, :], resp)
    return resp, logl, singular


def _em_fits(
    samples, resp0, active, ess_factor, max_steps: int = _MAX_EM_STEPS,
    clock: Optional[_Clock] = None,
):
    """Run a batch of EM fits to the end of the slowest.

    samples (F, n, D), resp0 (F, n, K), active (F, K) bool, ess_factor (F,),
    all on one device. Returns means (F, K, D), covs (F, K, D, D), weights
    (F, K), logl (F,), converged (F,), singular (F,), steps (F,) (the
    E-steps each fit ran), edge (F,) (the least |margin| of the singular
    test over the factorizations each fit's E-steps read; a few units or
    less means that rounding could have decided the fit's course) and the
    number of batched steps the loop ran. `clock` times the
    eigendecompositions."""
    F = samples.shape[0]
    dev, dt = samples.device, samples.dtype
    mean, cov, _, fac, margin = _m_step(samples, resp0, active, ess_factor, clock)
    # initial weights are uniform over active components, as the host path
    k_act = torch.clamp(active.sum(dim=-1), min=1)
    w = torch.where(active, 1.0 / k_act[:, None].to(dt), 0.0)

    big_neg = torch.full((F,), torch.finfo(dt).min / 4, dtype=dt, device=dev)
    prev_logl, logl = big_neg, big_neg.clone()
    stopped = torch.zeros(F, dtype=torch.bool, device=dev)
    conv = torch.zeros_like(stopped)
    sing = torch.zeros_like(stopped)
    steps = torch.zeros(F, dtype=torch.int32, device=dev)
    edge = torch.full((F,), math.inf, dtype=dt, device=dev)
    trips = 0
    while trips < max_steps:
        if trips % _STOP_CHECK_EVERY == 0 and trips > 0 and bool(stopped.all()):
            break
        trips += 1
        edge = torch.minimum(edge, torch.where(stopped, math.inf, margin))
        resp, new_logl, singular = _e_step(samples, mean, fac, w, active)
        eps = new_logl.abs() * _LOGL_EPSILON
        decreased = new_logl < prev_logl
        small_dec = (prev_logl - new_logl) < eps * 10.0
        small_inc = (new_logl - prev_logl) < eps
        now_conv = torch.where(decreased, small_dec, small_inc)
        stop_now = singular | decreased | small_inc

        n_mean, n_cov, n_w, n_fac, n_margin = _m_step(samples, resp, active, ess_factor, clock)
        upd = ~(stopped | stop_now)
        margin = torch.where(upd, n_margin, margin)
        mean = torch.where(upd[:, None, None], n_mean, mean)
        cov = torch.where(upd[:, None, None, None], n_cov, cov)
        fac = tuple(
            torch.where(upd.reshape((F,) + (1,) * (new.dim() - 1)), new, old)
            for new, old in zip(n_fac, fac)
        )
        w = torch.where(upd[:, None], n_w, w)
        logl = torch.where(stopped, logl, new_logl)
        conv = torch.where(stopped, conv, now_conv & ~singular)
        sing = sing | (singular & ~stopped)
        prev_logl = torch.where(stopped, prev_logl, new_logl)
        steps = steps + (~stopped).to(torch.int32)
        stopped = stopped | stop_now
    # fits that ran out of steps without stopping: converged=False
    return mean, cov, w, logl, conv & stopped, sing, steps, edge, trips


def _prepare_fits(histories, rng: np.random.Generator, log=None):
    """The host's part before the EM. Per history: its ESS, the eligible
    component counts and the closed-form k = 1 fit; per (history, k,
    retry) fit: its k-means++ start. Every draw comes from `rng`, in the
    JAX package's order. Returns (metas, candidates, fits, fit_meta):
    metas[pos] = (history, ks, ess_factor, aic_adjust) or None,
    candidates[pos] the k = 1 GMM if any, fits[i] = (resp0, k) and
    fit_meta[i] = (pos, k)."""
    metas, fits, fit_meta = [], [], []
    candidates: list = [[] for _ in histories]
    for pos, history in enumerate(histories):
        history = np.asarray(history, dtype=np.float64)
        if history.ndim != 2 or len(history) < 2:
            metas.append(None)
            continue
        n, D = history.shape
        ess = np.array([effective_sample_size(history[:, i]) for i in range(D)])
        min_ess = float(np.min(ess))
        if not np.isfinite(min_ess) or min_ess <= 0:
            min_ess = 1.0
        aic_adjust_factor = min_ess / n
        ess_factor = n / min_ess

        # eligible multi-component ks (k=1 is closed form: host, cheap)
        ks = [
            k
            for k in COMPONENT_LADDER
            if k > 1 and min_ess >= k * (1 + min(D // 2, 10)) and n >= 2.0 * D * k
        ]
        metas.append((history, ks, ess_factor, aic_adjust_factor))

        if min_ess >= 1 * (1 + min(D // 2, 10)):
            g1 = fit_gmm(history, 1, rng, ess_factor)
            if g1 is not None:
                candidates[pos].append(g1)
            elif log:
                log(f"GMM pos={pos} k=1: fit failed")

        for k in ks:
            for _r in range(_EM_RETRIES):
                resp = _kmeanspp(history, k, rng)
                if resp is None:
                    continue
                fits.append((resp, k))
                fit_meta.append((pos, k))
    if fits:
        shapes = {metas[p][0].shape for p, _ in fit_meta}
        if len(shapes) > 1:
            raise ValueError(
                f"fit_gmm_best_aic_device_multi requires equal-shaped histories, got {shapes}"
            )
    return metas, candidates, fits, fit_meta


def _run_fits(metas, fits, fit_meta, device, stats: Optional[dict] = None) -> dict:
    """Every prepared fit's EM on `device`, float64, one batch per component
    count with no padding. Returns per-fit numpy arrays in fit order:
    means (F, K_max, D), covs, weights (zero beyond each fit's k), logl,
    converged, singular, steps and edge (see `_em_fits`). `stats` as in
    `fit_gmm_best_aic_device_multi`."""
    F = len(fits)
    Kmax = max([k for _, k in fits], default=1)
    D = metas[fit_meta[0][0]][0].shape[1] if fits else 0
    out = {
        "means": np.zeros((F, Kmax, D)),
        "covs": np.zeros((F, Kmax, D, D)),
        "weights": np.zeros((F, Kmax)),
        "logl": np.zeros(F),
        "converged": np.zeros(F, dtype=bool),
        "singular": np.zeros(F, dtype=bool),
        "steps": np.zeros(F, dtype=np.int32),
        "edge": np.zeros(F),
    }
    if not fits:
        return out
    by_k: dict = {}
    for i, (_resp, k) in enumerate(fits):
        by_k.setdefault(k, []).append(i)

    def put(a, dt=torch.float64):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=device)

    clock = _Clock(device) if stats is not None else None
    for k, idxs in by_k.items():
        res = _em_fits(
            put(np.stack([metas[fit_meta[i][0]][0] for i in idxs])),
            put(np.stack([fits[i][0] for i in idxs])),
            put(np.ones((len(idxs), k), dtype=bool), torch.bool),
            put(np.asarray([metas[fit_meta[i][0]][2] for i in idxs])),
            clock=clock,
        )
        arrays = [t.cpu().numpy() for t in res[:8]]
        for name, a in zip(out, arrays):
            if name in ("means", "covs", "weights"):
                out[name][idxs, :k] = a
            else:
                out[name][idxs] = a
        if stats is not None:
            stats.setdefault("fits", {})[k] = len(idxs)
            stats.setdefault("em_steps", {})[k] = res[8]
            stats.setdefault("em_steps_per_fit", {})[k] = float(arrays[6].mean())
    if stats is not None:
        stats["eigh_seconds"] = stats.get("eigh_seconds", 0.0) + clock.seconds()
    return out


def _select_fits(metas, candidates, fit_meta, per_fit, select_with_adjusted_aic, log=None):
    """Per history: per k the first converged retry, else the last
    non-singular one; then the best AIC (or adjusted AIC) over k, with the
    reference's incumbent quirk. Returns a list of Optional[GMM]."""
    results: list = [None] * len(metas)
    for pos, meta in enumerate(metas):
        if meta is None:
            continue
        history, ks, _ess, aic_adjust_factor = meta
        D = history.shape[1]
        cands = list(candidates[pos])
        for k in ks:
            idx = [i for i, (p, kk) in enumerate(fit_meta) if p == pos and kk == k]
            chosen = None
            for i in idx:
                if per_fit["converged"][i] and not per_fit["singular"][i]:
                    chosen = i
                    break
            if chosen is None:
                non_sing = [i for i in idx if not per_fit["singular"][i]]
                if non_sing:
                    chosen = non_sing[-1]
            if chosen is None:
                if log:
                    log(f"GMM pos={pos} k={k}: fit failed (all retries singular)")
                continue
            g = GMM.from_params(
                per_fit["means"][chosen][:k],
                per_fit["covs"][chosen][:k],
                per_fit["weights"][chosen][:k],
            )
            if g is None:
                if log:
                    log(f"GMM pos={pos} k={k}: final cholesky failed")
                continue
            nparam = k * (D + D * (D + 1) // 2) + k - 1
            g.logl = float(per_fit["logl"][chosen])
            g.aic = 2 * nparam - 2 * g.logl
            cands.append(g)

        best_gmm = None
        best_aic = np.inf
        for g in cands:
            adjusted_aic = g.aic + 2.0 * (1.0 - aic_adjust_factor) * g.logl
            crit = adjusted_aic if select_with_adjusted_aic else g.aic
            if log:
                log(
                    f"GMM pos={pos} k={g.num_components}: AIC={g.aic:.6g}, "
                    f"adjusted AIC={adjusted_aic:.6g}"
                )
            if crit < best_aic:
                best_gmm = g
                best_aic = g.aic
        results[pos] = best_gmm
    return results


def fit_gmm_best_aic_device_multi(
    histories,
    rng: np.random.Generator,
    select_with_adjusted_aic: bool = False,
    log=None,
    device="cuda",
    stats: Optional[dict] = None,
):
    """Fit a best-AIC GMM to every history, the EM fits batched on `device`.

    `histories` is a list of (n, D) matrices of one shape (one per ladder
    position after the sampler's downsample). The (position, component
    count, retry) fits are grouped by component count, one batch per count
    with no padding. Returns a list of Optional[GMM] aligned with
    `histories`. If `stats` is a dict, it receives per component count the
    number of fits ("fits"), the batched EM steps run ("em_steps") and the
    mean E-steps per fit ("em_steps_per_fit"), and over all counts the
    seconds of the eigendecompositions ("eigh_seconds", added to what the
    dict holds)."""
    metas, candidates, fits, fit_meta = _prepare_fits(histories, rng, log)
    per_fit = _run_fits(metas, fits, fit_meta, device, stats)
    return _select_fits(metas, candidates, fit_meta, per_fit, select_with_adjusted_aic, log)


def fit_gmm_best_aic_device(
    history: np.ndarray,
    rng: np.random.Generator,
    select_with_adjusted_aic: bool = False,
    log=None,
    device="cuda",
) -> Optional[GMM]:
    """Device-batched drop-in for `bcm3_tpu_torch.stats.gmm.fit_gmm_best_aic`."""
    return fit_gmm_best_aic_device_multi(
        [history], rng, select_with_adjusted_aic, log, device
    )[0]
