"""Sampler factory: ``sampler.type`` string -> sampler instance.

Counterpart of bcm3_tpu/sampler/factory.py (reference:
src/sampler/SamplerFactory.cpp:22-43). The parallel-tempered sampler and
the importance sampler are ported; hmc, nuts, smc and vi are not yet
(ROADMAP A9) and raise NotImplementedError.
"""

from __future__ import annotations

from typing import Dict

from bcm3_tpu_torch.sampler.importance import ISConfig, SamplerIS
from bcm3_tpu_torch.sampler.pt import SamplerPT

_UNPORTED = ("hmc", "nuts", "smc", "vi")


def create_sampler(prior, likelihood, opts: Dict[str, str]):
    """Build a sampler from a merged option map (see io.config.load_options)."""
    from bcm3_tpu_torch.io.config import device_and_dtype, load_options, pt_config_from_options

    opts = load_options(None, opts)  # fill in defaults for missing keys
    stype = opts.get("sampler.type", "ptmh")
    if stype in ("ptmh", "parallel_tempered_Metropolis_Hastings"):
        return SamplerPT(prior, likelihood, pt_config_from_options(opts))
    if stype in ("is", "importance_sampling"):
        device, dtype = device_and_dtype(opts)
        cfg = ISConfig(
            num_samples=int(opts.get("sampler.num_samples", "2500")),
            use_every_nth=int(opts.get("sampler.use_every_nth", "1")),
            seed=int(opts.get("sampler.rngseed", "0")),
            batch_size=int(opts.get("issampler.batch_size", "1024")),
            device=device,
            dtype=dtype,
        )
        return SamplerIS(prior, likelihood, cfg)
    if stype in _UNPORTED:
        raise NotImplementedError(f"sampler.type '{stype}' is not ported yet (ROADMAP A9)")
    raise ValueError(f"Unknown sampler.type '{stype}' (expected ptmh|is|hmc|nuts|smc|vi)")
