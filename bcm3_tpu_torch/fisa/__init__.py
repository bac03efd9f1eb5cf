"""fISA: steady-state signaling networks scored against cell-line data
(counterpart of bcm3_tpu/fisa)."""

from bcm3_tpu_torch.fisa.likelihood import FISALikelihood, create_fisa_likelihood
from bcm3_tpu_torch.fisa.network import SignalingNetwork

__all__ = ["SignalingNetwork", "FISALikelihood", "create_fisa_likelihood"]
