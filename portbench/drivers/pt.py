"""Traffic kind "pt": SamplerPT.run() back to back.

The mix file gives PTConfig's fields (chains, ensembles, emitted samples,
thinning, adaptation, swaps, emission) and the check's sample size. One
sampler is built in set-up and run once there; each window call is its
public run(): a fresh start-position search, the iterations, the
emission and the result. The work of a run is one likelihood evaluation
a chain an iteration: chains x num_samples x use_every_nth.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench.harness import program

PT_FIELDS = ("num_chains", "num_ensembles", "num_samples", "use_every_nth",
             "adapt_proposal_samples", "adapt_proposal_times", "swapping_scheme",
             "emit_fixed_only")


class Driver:
    path = "population"  # the likelihood path whose solve the reference follows

    def __init__(self, ctx):
        self.ctx = ctx
        t = ctx.traffic
        self.iterations = t["num_samples"] * t["use_every_nth"]
        self.chains = t["num_chains"] * t["num_ensembles"]
        self.rng = np.random.default_rng(ctx.seeds["check"])
        self.kept = {"x": [], "lprior": [], "llh": []}
        self.stuck = []

    def setup(self):
        from bcm3_tpu_torch.sampler import PTConfig, SamplerPT

        ctx, t = self.ctx, self.ctx.traffic
        prior, lik = program.build(ctx)
        cfg = PTConfig(**{k: t[k] for k in PT_FIELDS}, seed=ctx.seeds["sampler"],
                       emit_dtype=getattr(torch, t["emit_dtype"]), device=ctx.device,
                       dtype=getattr(torch, t["dtype"]))
        self.sampler = SamplerPT(prior, lik, cfg)
        self.sampler.run()

    def run_once(self):
        t0 = time.perf_counter()
        res = self.sampler.run()
        wall = time.perf_counter() - t0
        S, E = self.ctx.traffic["num_samples"], self.ctx.traffic["num_ensembles"]
        x = res["samples"][:, -1, :]  # (S * E, D), sample-major, the T=1 rows
        n = min(self.ctx.traffic["check"]["rows_per_run"], x.shape[0])
        idx = np.sort(self.rng.choice(x.shape[0], n, replace=False))
        self.kept["x"].append(x[idx].astype(np.float64))
        self.kept["lprior"].append(res["log_prior"][idx, -1].astype(np.float64))
        self.kept["llh"].append(res["log_likelihood"][idx, -1].astype(np.float64))
        by = x.reshape(S, E, -1)
        self.stuck.append(float((by[0] == by[-1]).all(axis=1).mean()))
        return {"wall_s": wall, "work": self.chains * self.iterations,
                "evaluations": res["evaluations"], "elapsed_seconds": res["elapsed_seconds"],
                "sampling_seconds": res["sampling_seconds"], "iterations": self.iterations}

    @staticmethod
    def describe(r):
        return (f"{r['wall_s']:.3f} s wall, {r['sampling_seconds']:.3f} s sampling, "
                f"{r['work']} evaluations counted, {r['evaluations']} by the sampler")

    def check_data(self):
        return {"path": self.path, "stuck": self.stuck,
                **{k: np.concatenate(v) for k, v in self.kept.items()}}

    def release(self):
        del self.sampler
        if self.ctx.device == "cuda":
            torch.cuda.empty_cache()
