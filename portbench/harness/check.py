"""The correctness check: the program's outputs against the reference.

After the window, with the program's state freed, the reference
(portbench/reference: plain PyTorch in the configuration's dtype, with
its DP5 trip budget) scores what the timed path produced: a sample,
drawn from the seed, of the emitted rows of every completed run (their
log-prior and log-likelihood) and, for the gradient samplers, of the
chains' final states (log-posterior and its gradient in the unbounded
coordinates). Each number compared is the widest gap over the sample:

- a density's gap is |program - reference| / max(1, |reference|), and 1
  where one side is finite and the other not (so it reads at most 1);
- a gradient's gap is ||program - reference|| / max(||reference||, the
  median row's ||reference||), and 1 where either is not finite or it
  exceeds 1;
- `stuck_share` is the largest share, over the runs, of chains whose
  position never changed between a run's first and last emission (of
  those the driver counts: for NUTS, the chains at a finite density).

With `control`, the reference computed in that lower dtype stands in the
program's place: the check must fail it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import poppk as ref

BLOCK_ROWS = 2048  # reference rows a block (x 16 patients lanes)


def density_gap(prog, refv):
    """Saturating relative gaps (n,) of two density vectors (float64 numpy)."""
    prog, refv = np.asarray(prog, np.float64), np.asarray(refv, np.float64)
    both = np.isfinite(prog) & np.isfinite(refv)
    same = (~np.isfinite(prog)) & (~np.isfinite(refv)) & (prog == refv)
    gap = np.ones(prog.shape)
    with np.errstate(invalid="ignore"):
        rel = np.abs(prog - refv) / np.maximum(1.0, np.abs(refv))
    gap[both] = np.minimum(1.0, rel[both])
    gap[same] = 0.0
    return gap


def gradient_gap(prog, refv):
    """Saturating relative gaps (n,) of gradient rows (n, D)."""
    prog, refv = np.asarray(prog, np.float64), np.asarray(refv, np.float64)
    ok = np.isfinite(prog).all(axis=1) & np.isfinite(refv).all(axis=1)
    norms = np.linalg.norm(np.where(np.isfinite(refv), refv, 0.0), axis=1)
    floor = np.median(norms[ok]) if ok.any() else 1.0
    with np.errstate(invalid="ignore"):
        rel = np.linalg.norm(prog - refv, axis=1) / np.maximum(norms, max(floor, 1e-300))
    return np.where(ok, np.minimum(1.0, rel), 1.0)


def _blocks(fn, x, rows=BLOCK_ROWS):
    return torch.cat([fn(x[i:i + rows]) for i in range(0, x.shape[0], rows)])


class Reference:
    """The reference model of one configuration on one device, in the
    configuration's dtype. Not in float64: the configured model is the
    float32 solve with a 768-trip budget, and the adaptive DP5 keeps its
    step across a dose, so it can step over a narrow Erlang pulse; float32
    and float64 runs of it take other steps, skip other pulses and meet the
    budget on other lanes (log-likelihoods up to 2% apart on a few rows in
    a thousand; PERF.md)."""

    def __init__(self, cfg, prior, np_tables, device):
        self.cfg, self.prior, self.device = cfg, prior, device
        self.np_tables = np_tables
        self.dtype = getattr(torch, cfg["dtype"])
        self.trips = cfg["solver_trips"]
        self._tables = {}

    def tables(self, dtype):
        if dtype not in self._tables:
            self._tables[dtype] = ref.device_tables(self.np_tables, self.device, dtype)
        return self._tables[dtype]

    def densities(self, x, path, dtype=None):
        """(log prior, log-likelihood) of host rows x in dtype (the
        configuration's by default), as float64 numpy."""
        dtype = dtype or self.dtype
        xt = torch.as_tensor(np.asarray(x), device=self.device).to(dtype)
        tb = self.tables(dtype)
        with torch.no_grad():
            lp = _blocks(self.prior.log_density, xt)
            ll = _blocks(lambda b: ref.log_likelihood(b, self.prior, tb, self.cfg["pk_type"],
                                                      path, self.trips), xt)
        return lp.double().cpu().numpy(), ll.double().cpu().numpy()

    def posterior_and_gradient(self, z, dtype=None):
        """The gradient samplers' log-posterior (n,) and its gradient (n, D)
        at host rows z, as float64 numpy."""
        dtype = dtype or self.dtype
        tb = self.tables(dtype)
        out_v, out_g = [], []
        zt = torch.as_tensor(np.asarray(z), device=self.device).to(dtype)
        for i in range(0, zt.shape[0], BLOCK_ROWS):
            with torch.enable_grad():
                zz = zt[i:i + BLOCK_ROWS].detach().requires_grad_(True)
                v = ref.log_posterior_z(zz, self.prior, tb, self.cfg["pk_type"], self.trips)
                (g,) = torch.autograd.grad(v.sum(), zz)
            out_v.append(v.detach().double().cpu())
            out_g.append(g.double().cpu())
        return torch.cat(out_v).numpy(), torch.cat(out_g).numpy()


def run(reference, data, limits, control=None):
    """{number: value}, answers compared, answers beyond a limit."""
    numbers, failed, attempted = {}, 0, 0
    low = getattr(torch, control) if control else None
    path = data["path"]
    lp_r, ll_r = reference.densities(data["x"], path)
    if low is None:
        lp_p, ll_p = data["lprior"], data["llh"]
    else:
        lp_p, ll_p = reference.densities(data["x"], path, low)
    for name, gaps in (("lprior_gap", density_gap(lp_p, lp_r)),
                       ("llh_gap", density_gap(ll_p, ll_r))):
        numbers[name] = float(gaps.max()) if gaps.size else 0.0
        failed += int((gaps > limits[name]).sum())
        attempted += gaps.size
    if "z" in data:
        v_r, g_r = reference.posterior_and_gradient(data["z"])
        if low is None:
            v_p, g_p = data["logp"], data["grad"]
        else:
            v_p, g_p = reference.posterior_and_gradient(data["z"], low)
        for name, gaps in (("logp_gap", density_gap(v_p, v_r)),
                           ("grad_gap", gradient_gap(g_p, g_r))):
            numbers[name] = float(gaps.max()) if gaps.size else 0.0
            failed += int((gaps > limits[name]).sum())
            attempted += gaps.size
    numbers["stuck_share"] = float(max(data["stuck"])) if data["stuck"] else math.nan
    return numbers, attempted, failed
