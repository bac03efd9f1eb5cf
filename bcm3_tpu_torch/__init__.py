"""bcm3_tpu_torch: the PyTorch/CUDA port of bcm3_tpu for NVIDIA Hopper.

A second package beside the JAX one, with the same module paths, which
imports neither JAX nor bcm3_tpu. It runs every sampler of the JAX
package on one CUDA device (or on the CPU, where every kernel runs its
plain PyTorch version, or over several devices through torch.distributed,
parallel/): parallel-tempered Metropolis-Hastings with every proposal,
blocking and swap scheme (sampler/pt.py), importance sampling, HMC, NUTS,
SMC and VI, over every likelihood type of the JAX package. Its four
kernels are CUDA C++ under csrc/:

- B1, ops/poppk_kernels.py: the one-compartment dosing recurrence, in
  place of the Pallas kernel of bcm3_tpu/ops/poppk_pallas.py;
- B1T, ops/poppk_kernels.py: B1's reverse mode, for the gradient samplers
  (the JAX package differentiates a lax.scan there);
- B2, ops/transit_kernels.py: the budgeted DP5 transit solve, in place of
  the Pallas kernel of bcm3_tpu/ops/transit_pallas.py;
- B2J, ops/transit_tangent_kernels.py: the transit models' DP5 solve with
  its forward-mode tangents, for the gradient samplers (XLA's reverse mode
  of bcm3_tpu/ode/dp5.py in the JAX package).
"""

__version__ = "0.1.0"

from bcm3_tpu_torch.likelihoods import create_likelihood
from bcm3_tpu_torch.model.prior import Prior
from bcm3_tpu_torch.model.variables import VariableSet

__all__ = ["VariableSet", "Prior", "create_likelihood", "__version__"]
