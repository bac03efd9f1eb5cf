"""The prior of a configuration: its variables, log-density, draws and the
gradient samplers' change of variables.

Frozen copies, in plain PyTorch, of `bcm3_tpu_torch/model/prior.py`
(`Prior.log_pdf` and `Prior.sample` for the uniform and half-Cauchy
families, `distributions/univariate.py` `logpdf_uniform`,
`logpdf_half_cauchy`, `quantile_uniform`, `quantile_half_cauchy`) and of
`bcm3_tpu_torch/sampler/hmc.py` `Reparam` (`to_x`, `log_jacobian`,
`from_x`), as of commit d9dda7d00f62b25b3647d9a412570757ad8fc7e2. The
variables are listed in the configuration file; `write_xml` writes the
same list as the prior.xml a user of the program reads. Nothing here
imports the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

_LOG_2_OVER_PI = math.log(2.0 / math.pi)


def variables(cfg: dict) -> list:
    """The configuration's prior variables in order, the per-patient
    entries (`"each_patient": true`, `{j}` in the name) expanded."""
    out = []
    for v in cfg["prior"]:
        if v.get("each_patient"):
            for j in range(cfg["num_patients"]):
                out.append({k: (val.format(j=j) if k == "name" else val)
                            for k, val in v.items() if k != "each_patient"})
        else:
            out.append(dict(v))
    return out


def write_xml(cfg: dict, path: str):
    """The prior.xml of the configuration (the reference's schema)."""
    lines = ['<?xml version="1.0" encoding="utf-8"?>', "<prior>"]
    for v in variables(cfg):
        attrs = " ".join(f'{k}="{val}"' for k, val in v.items()
                         if k not in ("name", "distribution", "logspace"))
        ls = ' logspace="true"' if v.get("logspace") else ""
        lines.append(f'  <variable name="{v["name"]}" distribution="{v["distribution"]}"'
                     f'{ls} {attrs}/>')
    lines.append("</prior>")
    with open(path, "w") as f:
        f.write("\n".join(lines))


class ReferencePrior:
    """Uniform and half-Cauchy marginals over a configuration's variables."""

    def __init__(self, cfg: dict):
        vs = variables(cfg)
        self.names = [v["name"] for v in vs]
        self.logspace = np.array([bool(v.get("logspace")) for v in vs])
        fam = [v["distribution"] for v in vs]
        unknown = sorted(set(fam) - {"uniform", "half_cauchy"})
        if unknown:
            raise ValueError(f"the reference prior has no family {unknown}")
        self.uniform = np.array([f == "uniform" for f in fam])
        self.lower = np.array([v["lower"] if f == "uniform" else 0.0 for v, f in zip(vs, fam)])
        self.upper = np.array([v["upper"] if f == "uniform" else np.inf
                               for v, f in zip(vs, fam)])
        self.scale = np.array([v.get("scale", 1.0) for v in vs], dtype=np.float64)

    @property
    def num_variables(self) -> int:
        return len(self.names)

    def index(self, name: str) -> int:
        return self.names.index(name)

    def _t(self, like):
        def f(a):
            return torch.as_tensor(a, device=like.device).to(like.dtype)

        uni = torch.as_tensor(self.uniform, device=like.device)
        return uni, f(self.lower), f(np.where(self.uniform, self.upper, 1.0)), f(self.scale)

    def log_density(self, x: torch.Tensor) -> torch.Tensor:
        """Sum of the marginal log-densities of rows x (..., D), in x's dtype."""
        uni, lo, hi, scale = self._t(x)
        hi = torch.where(hi > lo, hi, lo + 1.0)
        inside = (x >= lo) & (x <= hi)
        lu = torch.where(inside, -torch.log(hi - lo), -math.inf)
        lc = _LOG_2_OVER_PI - torch.log(scale + x * x / scale)
        lc = torch.where(x > 0, lc, -math.inf)
        return torch.where(uni, lu, lc).sum(dim=-1)

    def sample(self, generator: torch.Generator, n: int, dtype) -> torch.Tensor:
        """n draws (n, D) on the generator's device: one uniform a
        variable, mapped through its family's quantile."""
        uni, lo, hi, scale = self._t(torch.empty(0, dtype=dtype, device=generator.device))
        u = torch.rand((n, self.num_variables), generator=generator, dtype=dtype,
                       device=generator.device)
        return torch.where(uni, lo + u * (hi - lo), scale * torch.tan(0.5 * math.pi * u))

    # the gradient samplers' unbounded coordinates (hmc.py Reparam): logit
    # for two-sided bounds, log for a lower bound alone

    def _z(self, z):
        two = torch.as_tensor(np.isfinite(self.upper), device=z.device)
        lo = torch.as_tensor(self.lower, device=z.device).to(z.dtype)
        span = torch.as_tensor(np.where(np.isfinite(self.upper), self.upper - self.lower, 1.0),
                               device=z.device).to(z.dtype)
        return two, lo, span

    def to_x(self, z: torch.Tensor) -> torch.Tensor:
        two, lo, span = self._z(z)
        ez = torch.exp(torch.where(two, 0.0, z))
        return torch.where(two, lo + span * torch.sigmoid(z), lo + ez)

    def log_jacobian(self, z: torch.Tensor) -> torch.Tensor:
        two, _, span = self._z(z)
        lj = torch.where(two, torch.log(span) + F.logsigmoid(z) + F.logsigmoid(-z), z)
        return lj.sum(dim=-1)
