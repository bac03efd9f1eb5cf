"""bcm3_tpu_torch: the PyTorch/CUDA port of bcm3_tpu for NVIDIA Hopper.

A second package beside the JAX one, with the same module paths. It runs
the parallel-tempered Metropolis-Hastings sampler over the population-PK
likelihood on one CUDA device (or on the CPU, where every kernel runs its
plain PyTorch version), and imports neither JAX nor bcm3_tpu. Its two
kernels, CUDA C++ under csrc/, replace the JAX package's Pallas kernels:

- ops/poppk_kernels.py: the one-compartment dosing recurrence
  (bcm3_tpu/ops/poppk_pallas.py);
- ops/transit_kernels.py: the budgeted DP5 transit solve
  (bcm3_tpu/ops/transit_pallas.py).
"""

__version__ = "0.1.0"

from bcm3_tpu_torch.likelihoods import create_likelihood
from bcm3_tpu_torch.model.prior import Prior
from bcm3_tpu_torch.model.variables import VariableSet

__all__ = ["VariableSet", "Prior", "create_likelihood", "__version__"]
