"""Cell-to-cell variability descriptions driven by a Sobol sequence.

Counterpart of bcm3_tpu/cellpop/variability.py (reference:
src/cellpop/VariabilityDescription.cpp, VariabilityDescriptionVariable.cpp,
VariabilityPseudoRandomIterator.cpp). The unit pseudorandom quantiles are
computed once on the host (`sobol_unit_normals`, a copy: unscrambled
scipy Sobol points through the normal quantile); the sampled scales
multiply them on the device, a batch of rows at a time.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List

import numpy as np
import torch

APPLY_ADDITIVE = "additive"
APPLY_ADDITIVE_LOG = "additive_log"
APPLY_ADDITIVE_LOG2 = "additive_log2"
APPLY_MULTIPLICATIVE = "multiplicative"
APPLY_MULTIPLICATIVE_LOG = "multiplicative_log"
APPLY_MULTIPLICATIVE_LOG2 = "multiplicative_log2"
APPLY_REPLACE = "replace"


@dataclass
class ValueRef:
    """A value that is either a sampled variable, a non-sampled parameter
    or a fixed number (reference: src/cellpop/ValueReference.cpp)."""

    string: str
    var_ix: int = -1
    non_sampled_ix: int = -1
    fixed_value: float = np.nan

    def resolve(self, varset, non_sampled_names):
        if self.string in varset.names:
            self.var_ix = varset.index_of(self.string)
            return True
        if self.string in non_sampled_names:
            self.non_sampled_ix = list(non_sampled_names).index(self.string)
            return True
        try:
            self.fixed_value = float(self.string)
            return True
        except ValueError:
            return False

    def value(self, tv: torch.Tensor, nsp: torch.Tensor) -> torch.Tensor:
        """The value of each row of the transformed values tv (B, D), (B,);
        nsp is (n_ns,) shared or (B, n_ns)."""
        if self.var_ix >= 0:
            return tv[:, self.var_ix]
        if self.non_sampled_ix >= 0:
            return nsp[..., self.non_sampled_ix].to(tv).expand(tv.shape[0])
        return tv.new_full((tv.shape[0],), self.fixed_value)


@dataclass
class VariabilityVariable:
    """One <variable> inside a <cell_variability>
    (reference: VariabilityDescriptionVariable.cpp Load:99-147)."""

    apply_type: str
    scale: ValueRef
    parameter_name: str = ""
    species_name: str = ""
    entry_time: bool = False
    negate: bool = False
    only_initial_cells: bool = False

    @classmethod
    def from_xml(cls, node) -> "VariabilityVariable":
        species = node.get("initial_condition_species", "")
        param = node.get("model_parameter", "")
        entry = node.get("entry_time", "") != ""
        count = sum([bool(species), bool(param), entry])
        if count != 1:
            raise ValueError(
                "cell variability variable must specify exactly one of "
                "initial_condition_species / model_parameter / entry_time"
            )
        apply_str = node.get("apply")
        if apply_str not in (
            APPLY_ADDITIVE,
            APPLY_ADDITIVE_LOG,
            APPLY_ADDITIVE_LOG2,
            APPLY_MULTIPLICATIVE,
            APPLY_MULTIPLICATIVE_LOG,
            APPLY_MULTIPLICATIVE_LOG2,
            APPLY_REPLACE,
        ):
            raise ValueError(f"Unknown variability application type '{apply_str}'")
        default_only_initial = "true" if entry else "false"
        return cls(
            apply_type=apply_str,
            scale=ValueRef(node.get("scale")),
            parameter_name=param,
            species_name=species,
            entry_time=entry,
            negate=node.get("negate", "false").lower() in ("1", "true"),
            only_initial_cells=node.get("only_initial_cells", default_only_initial).lower()
            in ("1", "true"),
        )

    def apply(self, x, v):
        """reference: VariabilityDescriptionVariable.cpp Apply:155-185."""
        if self.apply_type == APPLY_ADDITIVE:
            return x + v
        if self.apply_type == APPLY_ADDITIVE_LOG:
            return x + torch.exp(v)
        if self.apply_type == APPLY_ADDITIVE_LOG2:
            return x + torch.pow(2.0, v)
        if self.apply_type == APPLY_MULTIPLICATIVE:
            return x * v
        if self.apply_type == APPLY_MULTIPLICATIVE_LOG:
            return x * torch.exp(v)
        if self.apply_type == APPLY_MULTIPLICATIVE_LOG2:
            return x * torch.pow(2.0, v)
        return v  # replace


@dataclass
class VariabilityDescription:
    """One <cell_variability> block: a set of variables with a diagonal or
    full (spherically parametrized) Gaussian over their pseudorandom
    values (reference: VariabilityDescription.cpp:40-120)."""

    variables: List[VariabilityVariable]
    distribution: str  # "diagonal_gaussian" | "full_gaussian"
    covar_refs: List[ValueRef] = field(default_factory=list)

    @classmethod
    def from_xml(cls, node) -> "VariabilityDescription":
        variables = [VariabilityVariable.from_xml(v) for v in node if v.tag == "variable"]
        dist = node.get("distribution")
        if dist not in ("diagonal_gaussian", "full_gaussian"):
            raise ValueError(f"Unknown distribution '{dist}' in variability")
        covar_refs = []
        if dist == "full_gaussian":
            base = node.get("covar_base_name")
            for i in range(len(variables)):
                for j in range(i):
                    covar_refs.append(ValueRef(f"{base}{j + 1}_{i + 1}"))
        return cls(variables=variables, distribution=dist, covar_refs=covar_refs)

    @property
    def num_dimensions(self) -> int:
        return len(self.variables)

    def resolve(self, varset, non_sampled_names):
        for v in self.variables:
            if not v.scale.resolve(varset, non_sampled_names):
                raise ValueError(f"Cannot resolve scale '{v.scale.string}'")
        for c in self.covar_refs:
            if not c.resolve(varset, non_sampled_names):
                raise ValueError(f"Cannot resolve covariance '{c.string}'")

    def pseudorandom_vector(self, unit_normals, tv, nsp):
        """unit_normals: (B, K, D) quantile-normal Sobol values of this
        block (K per row); tv (B, D_var). Returns the scaled (B, K, D)
        variability vectors (reference: GetPseudorandomVector:40-118)."""
        D = self.num_dimensions
        scales = torch.stack([torch.exp(v.scale.value(tv, nsp)) for v in self.variables], dim=-1)
        if self.distribution == "diagonal_gaussian":
            return unit_normals * scales[:, None, :]
        # spherical log-Cholesky parametrization (Pinheiro & Bates 1996;
        # reference: VariabilityDescription.cpp:83-110)
        cov_vals = [c.value(tv, nsp) * math.pi for c in self.covar_refs]
        zero = torch.zeros_like(scales[:, 0])
        rows = []
        for i in range(D):
            row = []
            for j in range(D):
                if j > i:
                    row.append(zero)
                    continue
                entry = scales[:, i]
                for k in range(i):
                    if k <= j:
                        cv = cov_vals[(i - 1) * i // 2 + k]
                        entry = entry * (torch.cos(cv) if k == j else torch.sin(cv))
                row.append(entry)
            rows.append(torch.stack(row, dim=-1))
        Lc = torch.stack(rows, dim=-2)  # (B, D, D)
        return (Lc[:, None, :, :] * unit_normals[:, :, None, :]).sum(dim=-1)


def sobol_unit_normals(total_dims: int, initial_cells: int) -> np.ndarray:
    """Host-precomputed quantile-normal Sobol matrix
    (reference: VariabilityPseudoRandomIterator.cpp Initialize:10-22 —
    100*initial_cells points of a ``dimensions``-dim Sobol sequence)."""
    # imported here: scipy.stats starts a process at its import (numpy's
    # CPU feature probe), and importing the port starts none
    from scipy.stats import norm, qmc

    n = initial_cells * 100
    if total_dims == 0:
        return np.zeros((n, 0))
    eng = qmc.Sobol(d=total_dims, scramble=False)
    n_pow2 = 1 << max(0, int(np.ceil(np.log2(max(n, 1)))))
    u = eng.random(n_pow2)[:n]
    # guard against the degenerate first point (all zeros)
    u = np.clip(u, 1e-12, 1.0 - 1e-12)
    return norm.ppf(u)
