"""Template ODE likelihood with a pluggable right-hand side, batched.

Counterpart of bcm3_tpu/likelihoods/ode_template.py (reference:
src/likelihoods/LikelihoodODE.cpp:14-82): 13 inference variables, a
4-state ODE whose initial conditions are parameters 9-12, trajectories at
100 timepoints over [0, 1000], and the first state compared against
100*cos(t/2300)+300 with Student-t(nu=3, sd=10) errors.

The reference ships an empty derivative stub for users to fill in
(LikelihoodODE.cpp CalculateDerivative:75-82); here, as in the JAX
package, the derivative is a constructor argument with the same
do-nothing default. It follows the port's lane-first convention,
``f(t (L,), y (L, 4), params (L, 13)) -> (L, 4)``: every row of the batch
is a lane of one adaptive DP5 solve (ode/dp5.py `solve_at_times`), where
the JAX package vmaps a per-row ``f(t, y, params)``.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from bcm3_tpu_torch.distributions.univariate import logpdf_t
from bcm3_tpu_torch.model.variables import (
    TRANSFORM_LOG,
    TRANSFORM_LOG10,
    TRANSFORM_LOGIT,
    VariableSet,
)
from bcm3_tpu_torch.ode.dp5 import solve_at_times


def _zero_derivative(t, y, params):
    """The reference template's derivative is an empty stub the user must
    fill in (reference: LikelihoodODE.cpp:75-82); dy/dt = 0 reproduces its
    behavior exactly (dydt never written => trajectories constant)."""
    return torch.zeros_like(y)


class ODETemplateLikelihood:
    """``log_prob_batched(xs (B, 13)) -> (B,)`` for the reference ODE
    example model."""

    NUM_DYNAMIC = 4
    NUM_INFERENCE = 13

    def __init__(
        self,
        varset: VariableSet,
        derivative: Optional[Callable] = None,
        rtol: float = 1e-8,
        atol: float = 1e-8,
    ):
        if varset.num_variables != self.NUM_INFERENCE:
            raise ValueError(
                "Incorrect number of parameters "
                f"(reference requires {self.NUM_INFERENCE}, got {varset.num_variables})"
            )
        self.varset = varset
        self.derivative = derivative or _zero_derivative
        self.rtol = rtol
        self.atol = atol
        # 100 timepoints over [0, 1000] (reference: LikelihoodODE.cpp:36-42)
        self.timepoints = np.linspace(0.0, 1000.0, 100)
        self._transforms = np.asarray(varset.transforms)

    def _transform(self, xs):
        """Per-variable output transforms (reference applies
        varset->TransformVariable, LikelihoodODE.cpp:49-51)."""
        t = torch.as_tensor(self._transforms, device=xs.device)
        x = torch.where(t == TRANSFORM_LOG, torch.exp(xs), xs)
        x = torch.where(t == TRANSFORM_LOG10, torch.pow(10.0, xs), x)
        return torch.where(t == TRANSFORM_LOGIT, 1.0 / (1.0 + torch.exp(-xs)), x)

    def simulate(self, xs):
        """Integrate every row of xs (B, 13): trajectories (B, 100, 4) and
        ok (B,)."""
        p = self._transform(xs)
        ts = torch.as_tensor(self.timepoints, dtype=xs.dtype, device=xs.device)
        # initial conditions are parameters 9..12
        res = solve_at_times(self.derivative, p[:, 9:13], ts, args=p, rtol=self.rtol,
                             atol=self.atol)
        return res.ys, res.ok

    def log_prob_batched(self, xs: torch.Tensor) -> torch.Tensor:
        ys, ok = self.simulate(xs)
        ts = torch.as_tensor(self.timepoints, dtype=xs.dtype, device=xs.device)
        data = 100.0 * torch.cos(ts / 2300.0) + 300.0
        # Student-t nu=3, sd=10 on the first dynamic variable
        # (reference: LikelihoodODE.cpp:62-67 with LogPdfTnu3)
        sd, nu = (torch.tensor(v, dtype=xs.dtype, device=xs.device) for v in (10.0, 3.0))
        logp = logpdf_t(data, ys[:, :, 0], sd, nu).sum(dim=1)
        return torch.where(ok & torch.isfinite(logp), logp, -torch.inf)
