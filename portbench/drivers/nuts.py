"""Traffic kind "nuts": SamplerNUTS.run(x0) back to back.

The mix file gives NUTSConfig's fields (chains, tree depth, target
acceptance, warm-up and sampling transitions) and `start_draws`. Set-up
draws that many rows from the reference prior on the device from the
seed, keeps the first `num_chains` at which the reference's
log-posterior (in the sampler's dtype, at the configuration's trip
budget) is finite as the first starts, and runs once;
every later run() starts where the previous one ended (its last emitted
row of each chain). The work of a run is one draw a chain a transition,
warm-up included: chains x (num_warmup + num_samples x use_every_nth).
The start selection is the reference's work: its time, `reference_s`, is
left out of the set-up time.

A chain can start a later run() at a density of -inf: the program emits
its positions in float32, and one within rounding of a bound maps, by
the program's own x -> z -> x, onto the bound. Such a chain never moves,
and its share grows with the runs. So the stuck share of a run is taken
over the chains whose first emitted row has a finite log-density (a
chain that moves never reaches -inf), and the others are counted apart
and printed.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from portbench.harness import program
from portbench.reference import poppk as ref

NUTS_FIELDS = ("num_chains", "num_warmup", "num_samples", "use_every_nth", "max_tree_depth",
               "target_accept")


class Driver:
    path = "gradient"

    def __init__(self, ctx):
        self.ctx = ctx
        t = ctx.traffic
        self.transitions = t["num_warmup"] + t["num_samples"] * t["use_every_nth"]
        self.sampling_transitions = t["num_samples"] * t["use_every_nth"]
        self.rng = np.random.default_rng(ctx.seeds["check"])
        self.kept = {k: [] for k in ("x", "lprior", "llh", "z", "logp", "grad")}
        self.stuck = []
        self.reference_s = 0.0

    def starts(self):
        """The first num_chains of start_draws reference prior draws whose
        reference log-posterior is finite, both in the sampler's dtype and
        with the configuration's trip budget: a start the configured model
        cannot evaluate never moves."""
        ctx, t = self.ctx, self.ctx.traffic
        dtype = getattr(torch, t["dtype"])
        gen = torch.Generator(device=ctx.device).manual_seed(ctx.seeds["starts"])
        draws = ctx.prior.sample(gen, t["start_draws"], dtype)
        tb = ref.device_tables(ctx.tables, ctx.device, dtype)
        with torch.no_grad():
            dens = ctx.prior.log_density(draws) + ref.log_likelihood(
                draws, ctx.prior, tb, ctx.config["pk_type"], "gradient", ctx.config["solver_trips"])
        keep = torch.isfinite(dens).nonzero()[:, 0]
        if keep.numel() < t["num_chains"]:
            raise RuntimeError(f"{keep.numel()} of {t['start_draws']} prior draws have a finite "
                               f"density; the mix needs {t['num_chains']}")
        return draws[keep[: t["num_chains"]]]

    def setup(self):
        from bcm3_tpu_torch.sampler import NUTSConfig, SamplerNUTS

        ctx, t = self.ctx, self.ctx.traffic
        prior, lik = program.build(ctx)
        cfg = NUTSConfig(**{k: t[k] for k in NUTS_FIELDS}, seed=ctx.seeds["sampler"],
                         device=ctx.device, dtype=getattr(torch, t["dtype"]))
        self.sampler = SamplerNUTS(prior, lik, cfg)
        t0 = time.perf_counter()
        starts = self.starts()
        self.reference_s = time.perf_counter() - t0
        res = self.sampler.run(starts)
        self.x0 = res["samples_per_chain"][-1]

    def run_once(self):
        t0 = time.perf_counter()
        res = self.sampler.run(self.x0)
        wall = time.perf_counter() - t0
        per_chain = res["samples_per_chain"]  # (S, C, D)
        self.x0 = per_chain[-1]
        C = per_chain.shape[1]
        # the chains' first emitted rows (sample-major: rows 0..C-1)
        finite = np.isfinite(res["log_prior"][:C, -1] + res["log_likelihood"][:C, -1])
        unmoved = (per_chain[0] == per_chain[-1]).all(axis=1)
        self.stuck.append(float(unmoved[finite].mean()) if finite.any() else 1.0)
        check = self.ctx.traffic["check"]
        x = res["samples"][:, -1, :]
        idx = np.sort(self.rng.choice(x.shape[0], min(check["rows_per_run"], x.shape[0]),
                                      replace=False))
        self.kept["x"].append(x[idx].astype(np.float64))
        self.kept["lprior"].append(res["log_prior"][idx, -1].astype(np.float64))
        self.kept["llh"].append(res["log_likelihood"][idx, -1].astype(np.float64))
        z, logp, grad = self.sampler.state
        rows = torch.as_tensor(np.sort(self.rng.choice(C, min(check["chains_per_run"], C),
                                                       replace=False)), device=z.device)
        for k, v in (("z", z), ("logp", logp), ("grad", grad)):
            self.kept[k].append(v[rows].double().cpu().numpy())
        return {"wall_s": wall, "work": C * self.transitions,
                "elapsed_seconds": res["elapsed_seconds"],
                "sampling_seconds": res["sampling_seconds"],
                "sampling_transitions": self.sampling_transitions,
                "gradient_evaluations_per_transition": res["gradient_evaluations_per_transition"],
                "host_syncs_per_transition": res["host_syncs_per_transition"],
                "mean_tree_depth": res["mean_tree_depth"], "step_size": res["step_size"],
                "nonfinite_chains": int((~finite).sum())}

    @staticmethod
    def describe(r):
        return (f"{r['wall_s']:.3f} s wall, {r['sampling_seconds']:.3f} s sampling, "
                f"{r['work']} draws, {r['gradient_evaluations_per_transition']:.2f} gradient "
                f"evaluations and {r['host_syncs_per_transition']:.2f} host reads a sampling "
                f"transition, mean depth {r['mean_tree_depth']:.3f}, step {r['step_size']:.4g}, "
                f"{r['nonfinite_chains']} chains at a density of -inf from the start")

    def check_data(self):
        return {"path": self.path, "stuck": self.stuck,
                **{k: np.concatenate(v) for k, v in self.kept.items()}}

    def release(self):
        del self.sampler
        gc.collect()
        if self.ctx.device == "cuda":
            torch.cuda.empty_cache()
