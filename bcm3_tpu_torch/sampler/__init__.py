from bcm3_tpu_torch.sampler.factory import create_sampler
from bcm3_tpu_torch.sampler.hmc import HMCConfig, SamplerHMC
from bcm3_tpu_torch.sampler.importance import ISConfig, SamplerIS
from bcm3_tpu_torch.sampler.nuts import NUTSConfig, SamplerNUTS
from bcm3_tpu_torch.sampler.pt import PTConfig, SamplerPT, temperature_ladder
from bcm3_tpu_torch.sampler.smc import SamplerSMC, SMCConfig
from bcm3_tpu_torch.sampler.vi import SamplerVI, VIConfig

__all__ = [
    "PTConfig",
    "SamplerPT",
    "SamplerIS",
    "ISConfig",
    "SamplerHMC",
    "HMCConfig",
    "SamplerNUTS",
    "NUTSConfig",
    "SamplerSMC",
    "SMCConfig",
    "SamplerVI",
    "VIConfig",
    "create_sampler",
    "temperature_ladder",
]
