"""Vectorized prior over a variable set, on torch tensors.

Counterpart of bcm3_tpu/model/prior.py (reference: src/sampler/Prior.cpp:21-66,
PriorIndependence.cpp, UnivariateMarginal.cpp). The prior is a set of
parallel numpy parameter arrays over the variable axis; `log_pdf`
evaluates every family over the full (chains, variables) batch and
combines them with masks, so one call scores the whole population with
no per-variable control flow.

Dirichlet blocks (reference: src/sampler/MultivariateMarginal.h:26-31) are
contiguous index ranges whose last variable is the residual
1 - sum(others) (reference: src/sampler/Sampler.h:38-42).

`sample` draws from an explicit `torch.Generator`; the gamma, beta,
beta_prime and Dirichlet families take their draws from the port's gamma
sampler (`univariate.sample_standard_gamma`), which takes one.
"""

from __future__ import annotations

import math
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from typing import List

import numpy as np
import torch

from bcm3_tpu_torch.distributions import univariate as uv
from bcm3_tpu_torch.model.variables import VariableSet, _parse_bool

# Distribution family codes (same integers as the JAX package)
UNIFORM = 0
NORMAL = 1
EXPONENTIAL = 2
GAMMA = 3
BETA = 4
HALF_CAUCHY = 5
BETA_PRIME = 6
EXPONENTIAL_MIX = 7
DIRICHLET_MEMBER = 8  # handled by the Dirichlet block logic, not marginals

_FAMILY_NAMES = {
    "uniform": UNIFORM,
    "normal": NORMAL,
    "exponential": EXPONENTIAL,
    "gamma": GAMMA,
    "beta": BETA,
    "half_cauchy": HALF_CAUCHY,
    "beta_prime": BETA_PRIME,
    "exponential_mix": EXPONENTIAL_MIX,
}

@dataclass
class DirichletBlock:
    start: int  # first variable index of the block (variables are contiguous)
    alphas: np.ndarray  # concentration parameters, one per member variable

    @property
    def size(self) -> int:
        return len(self.alphas)

    @property
    def residual_index(self) -> int:
        return self.start + self.size - 1


@dataclass
class Prior:
    """Independent marginals + optional Dirichlet blocks."""

    varset: VariableSet
    dist_type: np.ndarray  # (D,) int
    p1: np.ndarray  # (D,) first parameter slot
    p2: np.ndarray  # (D,) second parameter slot
    p3: np.ndarray  # (D,) third parameter slot
    lower: np.ndarray  # (D,) bounds (inclusive)
    upper: np.ndarray
    dirichlet_blocks: List[DirichletBlock] = field(default_factory=list)
    # parameter tensors per (device, dtype), made on first use
    _tensors: dict = field(default_factory=dict, repr=False, compare=False)
    # the family codes some variable has
    _present: frozenset = field(init=False, repr=False, compare=False)

    def __post_init__(self):
        self._present = frozenset(np.unique(self.dist_type).tolist())

    # ------------------------------------------------------------------
    # Construction

    @classmethod
    def from_xml(cls, filename: str, varset: VariableSet | None = None) -> "Prior":
        if varset is None:
            varset = VariableSet.from_xml(filename)
        root = ET.parse(filename).getroot()
        if root.tag not in ("prior", "variableset"):
            raise ValueError(f"Incorrect prior XML format: root '{root.tag}'")
        ptype = root.get("type", "independence") or "independence"
        if ptype != "independence":
            raise ValueError(f"Unknown prior type '{ptype}'")

        D = varset.num_variables
        dist_type = np.full(D, -1, dtype=np.int32)
        p1 = np.zeros(D)
        p2 = np.zeros(D)
        p3 = np.zeros(D)
        lower = np.full(D, -np.inf)
        upper = np.full(D, np.inf)
        dirichlet: dict[int, DirichletBlock] = {}

        ix = 0
        for var in root.findall("variable"):
            if _parse_bool(var.get("multivariate", "false")):
                # Dirichlet member (reference: PriorIndependence.cpp:25-67)
                dist = var.get("distribution")
                if dist != "dirichlet":
                    raise ValueError(
                        f"Only dirichlet multivariate distributions supported, got {dist}"
                    )
                did = int(var.get("id"))
                if did <= 0:
                    raise ValueError("Multivariate distribution IDs start at 1")
                alpha = float(var.get("alpha"))
                if did - 1 in dirichlet:
                    blk = dirichlet[did - 1]
                    if ix != blk.start + blk.size:
                        raise ValueError(
                            "Variables in a multivariate distribution must be contiguous"
                        )
                    blk.alphas = np.append(blk.alphas, alpha)
                else:
                    dirichlet[did - 1] = DirichletBlock(ix, np.array([alpha]))
                dist_type[ix] = DIRICHLET_MEMBER
                lower[ix] = 0.0
                upper[ix] = 1.0
                ix += 1
            else:
                repeat = int(var.get("repeat", "1"))
                name = var.get("distribution")
                if name not in _FAMILY_NAMES:
                    raise ValueError(f"Invalid distribution type '{name}'")
                code = _FAMILY_NAMES[name]
                a = b = c = 0.0
                if code == UNIFORM:
                    a, b = float(var.get("lower")), float(var.get("upper"))
                    if b <= a:
                        raise ValueError("Uniform with upper <= lower")
                elif code == NORMAL:
                    a, b = float(var.get("mu")), float(var.get("sigma"))
                    if b <= 0:
                        raise ValueError("Normal with non-positive sigma")
                elif code == EXPONENTIAL:
                    a = float(var.get("lambda"))
                    if a <= 0:
                        raise ValueError("Exponential with non-positive lambda")
                elif code == GAMMA:
                    a, b = float(var.get("k")), float(var.get("theta"))
                    if a <= 0 or b <= 0:
                        raise ValueError("Gamma with non-positive k or theta")
                elif code == BETA:
                    a, b = float(var.get("a")), float(var.get("b"))
                    if a <= 0 or b <= 0:
                        raise ValueError("Beta with non-positive a or b")
                elif code == HALF_CAUCHY:
                    a = float(var.get("scale"))
                    if a <= 0:
                        raise ValueError("HalfCauchy with non-positive scale")
                elif code == BETA_PRIME:
                    a, b = float(var.get("a")), float(var.get("b"))
                    c = float(var.get("scale"))
                elif code == EXPONENTIAL_MIX:
                    a = float(var.get("lambda"))
                    b = float(var.get("lambda2"))
                    c = float(var.get("mix"))
                for _ in range(repeat):
                    dist_type[ix] = code
                    p1[ix], p2[ix], p3[ix] = a, b, c
                    lower[ix] = cls._family_lower(code, a, b, c)
                    upper[ix] = cls._family_upper(code, a, b, c)
                    ix += 1

        if ix != D:
            raise ValueError(f"Parsed {ix} prior entries for {D} variables")
        return cls(
            varset=varset,
            dist_type=dist_type,
            p1=p1,
            p2=p2,
            p3=p3,
            lower=lower,
            upper=upper,
            dirichlet_blocks=list(dirichlet.values()),
        )

    @staticmethod
    def _family_lower(code, a, b, c) -> float:
        # reference: UnivariateMarginal.cpp GetLowerBound
        if code == UNIFORM:
            return a
        if code in (BETA, EXPONENTIAL, GAMMA, HALF_CAUCHY, BETA_PRIME):
            return 0.0
        return -np.inf

    @staticmethod
    def _family_upper(code, a, b, c) -> float:
        # reference: UnivariateMarginal.cpp GetUpperBound
        if code == UNIFORM:
            return b
        if code == BETA:
            return 1.0
        return np.inf

    @property
    def num_variables(self) -> int:
        return len(self.dist_type)

    def _params(self, device, dtype):
        """(t, a, b, c) as tensors on the given device."""
        key = (str(device), dtype)
        if key not in self._tensors:
            t = torch.as_tensor(self.dist_type, device=device)
            a, b, c = (
                torch.as_tensor(p, dtype=dtype, device=device)
                for p in (self.p1, self.p2, self.p3)
            )
            self._tensors[key] = (t, a, b, c)
        return self._tensors[key]

    # ------------------------------------------------------------------
    # Device-side evaluation

    def log_pdf(self, x: torch.Tensor) -> torch.Tensor:
        """Sum of marginal log-densities. x: (..., D) -> (...)."""
        t, a, b, c = self._params(x.device, x.dtype)
        lp = torch.zeros_like(x)

        def put(code, values):
            return torch.where(t == code, values, lp)

        # Parameters of NON-member variables are substituted with neutral
        # values (sd/rate/shape = 1, mu = 0) so every masked branch stays
        # finite for any x in the batch (see bcm3_tpu/model/prior.py:226-237).
        tiny = torch.finfo(x.dtype).tiny

        def member_or(code, arr, neutral):
            return torch.where(t == code, torch.clamp(arr, min=tiny), neutral)

        families = {
            UNIFORM: lambda: uv.logpdf_uniform(x, a, torch.where(b > a, b, a + 1.0)),
            NORMAL: lambda: uv.logpdf_normal(
                x, torch.where(t == NORMAL, a, 0.0), member_or(NORMAL, b, 1.0)
            ),
            EXPONENTIAL: lambda: uv.logpdf_exponential(x, member_or(EXPONENTIAL, a, 1.0)),
            GAMMA: lambda: uv.logpdf_gamma(
                x, member_or(GAMMA, a, 1.0), member_or(GAMMA, b, 1.0)
            ),
            BETA: lambda: uv.logpdf_beta(x, member_or(BETA, a, 1.0), member_or(BETA, b, 1.0)),
            HALF_CAUCHY: lambda: uv.logpdf_half_cauchy(x, member_or(HALF_CAUCHY, a, 1.0)),
            BETA_PRIME: lambda: uv.logpdf_beta_prime(
                x,
                member_or(BETA_PRIME, a, 1.0),
                member_or(BETA_PRIME, b, 1.0),
                member_or(BETA_PRIME, c, 1.0),
            ),
            EXPONENTIAL_MIX: lambda: uv.logpdf_exponential_mix(
                x,
                member_or(EXPONENTIAL_MIX, a, 1.0),
                member_or(EXPONENTIAL_MIX, b, 1.0),
                torch.clamp(c, 1e-12, 1.0 - 1e-12),
            ),
        }
        # a family no variable has would only be selected away: it is not
        # evaluated (the same values, fewer launches)
        for code, logpdf in families.items():
            if code in self._present:
                lp = put(code, logpdf())
        # Dirichlet members contribute via the block density below
        lp = torch.where(t == DIRICHLET_MEMBER, 0.0, lp)
        total = lp.sum(dim=-1)

        for blk in self.dirichlet_blocks:
            xs = x[..., blk.start : blk.start + blk.size]
            alphas = torch.as_tensor(blk.alphas, dtype=x.dtype, device=x.device)
            inside = ((xs >= 0) & (xs <= 1)).all(dim=-1)
            simplex = (xs.sum(dim=-1) - 1.0).abs() < 1e-6
            logb = torch.lgamma(alphas).sum() - torch.lgamma(alphas.sum())
            xs_safe = torch.clamp(xs, tiny, 1.0)
            logd = ((alphas - 1.0) * torch.log(xs_safe)).sum(dim=-1) - logb
            total = total + torch.where(inside & simplex, logd, -math.inf)

        return total

    def sample(
        self, generator: torch.Generator, shape=(), dtype=torch.float64
    ) -> torch.Tensor:
        """Draw from the prior on the generator's device: (*shape, D).
        A family's random numbers are drawn only where the prior has it,
        so adding a family does not change the others' draws."""
        present = self._present
        device = generator.device
        full = (*shape, self.num_variables)
        t, a, b, c = self._params(device, dtype)

        def rand():
            return torch.rand(full, generator=generator, dtype=dtype, device=device)

        u = rand()
        z = torch.randn(full, generator=generator, dtype=dtype, device=device)
        tiny = torch.finfo(dtype).tiny

        out = torch.zeros(full, dtype=dtype, device=device)
        out = torch.where(t == UNIFORM, uv.quantile_uniform(u, a, b), out)
        out = torch.where(t == NORMAL, a + b * z, out)
        out = torch.where(
            t == EXPONENTIAL, uv.quantile_exponential(u, torch.clamp(a, min=tiny)), out
        )
        out = torch.where(t == HALF_CAUCHY, uv.quantile_half_cauchy(u, a), out)
        if EXPONENTIAL_MIX in present:
            mix_u = rand()
            u2 = rand()
            lam = torch.where(mix_u < c, a, b)
            out = torch.where(
                t == EXPONENTIAL_MIX,
                uv.quantile_exponential(u2, torch.clamp(lam, min=tiny)),
                out,
            )

        def gamma(shape_param):
            return uv.sample_standard_gamma(shape_param.expand(full), generator)

        if GAMMA in present:
            out = torch.where(t == GAMMA, gamma(torch.where(t == GAMMA, a, 1.0)) * b, out)
        if BETA in present or BETA_PRIME in present:
            # Beta(a, b) = Ga / (Ga + Gb); Beta'(a, b) * scale = scale * Ga / Gb
            member = (t == BETA) | (t == BETA_PRIME)
            ga = gamma(torch.where(member, a, 1.0))
            gb = gamma(torch.where(member, b, 1.0))
            out = torch.where(t == BETA, ga / (ga + gb), out)
            out = torch.where(t == BETA_PRIME, c * ga / gb, out)
        for blk in self.dirichlet_blocks:
            alphas = torch.as_tensor(blk.alphas, dtype=dtype, device=device)
            gs = uv.sample_standard_gamma(alphas.expand(*shape, blk.size), generator)
            out[..., blk.start : blk.start + blk.size] = gs / gs.sum(dim=-1, keepdim=True)
        return out

    # ------------------------------------------------------------------
    # Host-side summaries (for proposal fallbacks)

    def marginal_mean(self) -> np.ndarray:
        """reference: UnivariateMarginal.cpp EvaluateMean (undefined -> scale)."""
        t, a, b, c = self.dist_type, self.p1, self.p2, self.p3
        m = np.zeros(self.num_variables)
        m = np.where(t == UNIFORM, 0.5 * (a + b), m)
        m = np.where(t == NORMAL, a, m)
        with np.errstate(divide="ignore", invalid="ignore"):
            m = np.where(t == EXPONENTIAL, 1.0 / np.where(a > 0, a, 1.0), m)
            m = np.where(t == GAMMA, a * b, m)
            m = np.where(t == BETA, a / np.where(a + b > 0, a + b, 1.0), m)
            m = np.where(t == HALF_CAUCHY, a, m)
            bp_mean = np.where(b > 1.0, c * a / np.where(b > 1.0, b - 1.0, 1.0), c)
            m = np.where(t == BETA_PRIME, bp_mean, m)
            em = c / np.where(a > 0, a, 1.0) + (1.0 - c) / np.where(b > 0, b, 1.0)
            m = np.where(t == EXPONENTIAL_MIX, em, m)
        for blk in self.dirichlet_blocks:
            s = blk.alphas.sum()
            m[blk.start : blk.start + blk.size] = blk.alphas / s
        return m

    def marginal_variance(self) -> np.ndarray:
        """reference: UnivariateMarginal.cpp EvaluateVariance (undefined -> scale^2)."""
        t, a, b, c = self.dist_type, self.p1, self.p2, self.p3
        v = np.ones(self.num_variables)
        v = np.where(t == UNIFORM, (b - a) ** 2 / 12.0, v)
        v = np.where(t == NORMAL, b * b, v)
        with np.errstate(divide="ignore", invalid="ignore"):
            v = np.where(t == EXPONENTIAL, 1.0 / np.where(a > 0, a * a, 1.0), v)
            v = np.where(t == GAMMA, a * b * b, v)
            apb = np.where(a + b > 0, a + b, 1.0)
            v = np.where(t == BETA, a * b / (apb * apb * (apb + 1.0)), v)
            v = np.where(t == HALF_CAUCHY, a * a, v)
            bm1 = np.where(b > 2.0, b - 1.0, 1.0)
            bm2 = np.where(b > 2.0, b - 2.0, 1.0)
            bp_var = np.where(b > 2.0, c * c * a * (a + b - 1.0) / (bm2 * bm1 * bm1), c * c)
            v = np.where(t == BETA_PRIME, bp_var, v)
            em = c**2 / np.where(a > 0, a * a, 1.0) + (1.0 - c) ** 2 / np.where(
                b > 0, b * b, 1.0
            )
            v = np.where(t == EXPONENTIAL_MIX, em, v)
        for blk in self.dirichlet_blocks:
            al = blk.alphas
            a0 = al.sum()
            v[blk.start : blk.start + blk.size] = (
                al * (a0 - al) / (a0 * a0 * (a0 + 1.0))
            )
        return v
