from bcm3_tpu_torch.sampler.factory import create_sampler
from bcm3_tpu_torch.sampler.importance import ISConfig, SamplerIS
from bcm3_tpu_torch.sampler.pt import PTConfig, SamplerPT, temperature_ladder

__all__ = [
    "PTConfig",
    "SamplerPT",
    "SamplerIS",
    "ISConfig",
    "create_sampler",
    "temperature_ladder",
]
