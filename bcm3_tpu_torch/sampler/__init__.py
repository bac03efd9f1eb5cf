from bcm3_tpu_torch.sampler.pt import PTConfig, SamplerPT, temperature_ladder

__all__ = ["PTConfig", "SamplerPT", "temperature_ladder"]
