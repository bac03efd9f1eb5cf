"""Sampler factory: ``sampler.type`` string -> sampler instance.

Counterpart of bcm3_tpu/sampler/factory.py (reference:
src/sampler/SamplerFactory.cpp:22-43): the parallel-tempered sampler, the
importance sampler and the backends beyond the reference (hmc, nuts, smc,
vi), with the JAX package's option names and defaults. Every sampler runs
on the option map's `device` in its `dtype` (the port's own options).
"""

from __future__ import annotations

from typing import Dict

from bcm3_tpu_torch.sampler.hmc import HMCConfig, SamplerHMC
from bcm3_tpu_torch.sampler.importance import ISConfig, SamplerIS
from bcm3_tpu_torch.sampler.nuts import NUTSConfig, SamplerNUTS
from bcm3_tpu_torch.sampler.pt import SamplerPT
from bcm3_tpu_torch.sampler.smc import SamplerSMC, SMCConfig
from bcm3_tpu_torch.sampler.vi import SamplerVI, VIConfig


def create_sampler(prior, likelihood, opts: Dict[str, str]):
    """Build a sampler from a merged option map (see io.config.load_options)."""
    from bcm3_tpu_torch.io.config import device_and_dtype, load_options, pt_config_from_options

    opts = load_options(None, opts)  # fill in defaults for missing keys
    stype = opts.get("sampler.type", "ptmh")
    if stype in ("ptmh", "parallel_tempered_Metropolis_Hastings"):
        return SamplerPT(prior, likelihood, pt_config_from_options(opts))
    device, dtype = device_and_dtype(opts)
    common = dict(seed=int(opts.get("sampler.rngseed", "0")), device=device, dtype=dtype)
    if stype in ("is", "importance_sampling"):
        cfg = ISConfig(
            num_samples=int(opts.get("sampler.num_samples", "2500")),
            use_every_nth=int(opts.get("sampler.use_every_nth", "1")),
            batch_size=int(opts.get("issampler.batch_size", "1024")),
            **common,
        )
        return SamplerIS(prior, likelihood, cfg)
    if stype == "hmc":
        cfg = HMCConfig(
            num_samples=int(opts.get("sampler.num_samples", "1000")),
            use_every_nth=int(opts.get("sampler.use_every_nth", "1")),
            num_warmup=int(opts.get("hmcsampler.num_warmup", "500")),
            num_chains=int(opts.get("hmcsampler.num_chains", "8")),
            num_leapfrog_steps=int(opts.get("hmcsampler.num_leapfrog_steps", "16")),
            target_accept=float(opts.get("hmcsampler.target_accept", "0.8")),
            **common,
        )
        return SamplerHMC(prior, likelihood, cfg)
    if stype == "nuts":
        cfg = NUTSConfig(
            num_samples=int(opts.get("sampler.num_samples", "1000")),
            use_every_nth=int(opts.get("sampler.use_every_nth", "1")),
            num_warmup=int(opts.get("nutssampler.num_warmup", "500")),
            num_chains=int(opts.get("nutssampler.num_chains", "8")),
            max_tree_depth=int(opts.get("nutssampler.max_tree_depth", "8")),
            target_accept=float(opts.get("nutssampler.target_accept", "0.8")),
            **common,
        )
        return SamplerNUTS(prior, likelihood, cfg)
    if stype == "smc":
        cfg = SMCConfig(
            num_particles=int(opts.get("smcsampler.num_particles", "2048")),
            mutation_steps=int(opts.get("smcsampler.mutation_steps", "5")),
            ess_target=float(opts.get("smcsampler.ess_target", "0.5")),
            **common,
        )
        return SamplerSMC(prior, likelihood, cfg)
    if stype == "vi":
        cfg = VIConfig(
            num_iterations=int(opts.get("visampler.num_iterations", "2000")),
            num_mc_samples=int(opts.get("visampler.num_mc_samples", "32")),
            learning_rate=float(opts.get("visampler.learning_rate", "0.05")),
            num_samples=int(opts.get("sampler.num_samples", "1000")),
            **common,
        )
        return SamplerVI(prior, likelihood, cfg)
    raise ValueError(f"Unknown sampler.type '{stype}' (expected ptmh|is|hmc|nuts|smc|vi)")
