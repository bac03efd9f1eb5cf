from bcm3_tpu_torch.model.prior import Prior
from bcm3_tpu_torch.model.variables import VariableSet

__all__ = ["VariableSet", "Prior"]
