"""Likelihood registry: string type -> batched torch log-density.

Counterpart of bcm3_tpu/likelihoods/__init__.py (reference:
src/likelihoods/LikelihoodFactory.cpp:31-101), configured from the same
``likelihood.xml`` schema. A likelihood here is batched by nature: its
one evaluation entry is ``log_prob_batched(xs (B, D)) -> (B,)``. Only
``pop_pk_trajectory`` is ported; every other type is listed in ROADMAP A10.
`fixed_parameter_likelihood` builds the likelihood of `--bcmopt`.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Sequence

import numpy as np
import torch

from bcm3_tpu_torch.model.variables import VariableSet


@dataclass
class Likelihood:
    """A likelihood: ``log_prob_batched(xs (B, D)) -> (B,)`` on xs's device
    and dtype. ``learning_rate`` tempers it like the reference's
    Likelihood::SetLearningRate."""

    name: str
    log_prob_batched: Callable[[torch.Tensor], torch.Tensor]
    learning_rate: float = 1.0
    attrs: Dict[str, Any] = field(default_factory=dict)
    model: Any = None  # backing model object (e.g. PopPKLikelihood)


def _pop_pk(varset: VariableSet, attrs) -> Likelihood:
    from bcm3_tpu_torch.likelihoods.poppk import create_poppk_likelihood

    pk = create_poppk_likelihood(varset, attrs)
    return Likelihood("pop_pk_trajectory", pk.log_prob_batched, attrs=attrs, model=pk)


_REGISTRY: Dict[str, Callable[..., Likelihood]] = {"pop_pk_trajectory": _pop_pk}


def fixed_parameter_likelihood(
    full: Likelihood, fixed_values, sampled_positions: Sequence[int]
) -> Likelihood:
    """The likelihood of `--bcmopt` (bcm3_tpu/cli.py:250-258): `full` over
    the stored variable layout, with every variable held at
    `fixed_values` (a full stored sample) except those at
    `sampled_positions`, which take the sampled values in order. Batched:
    the full vector is copied over the batch and the sampled columns
    written in."""
    fixed = torch.as_tensor(np.asarray(fixed_values, dtype=np.float64))
    pos = torch.as_tensor(np.asarray(sampled_positions, dtype=np.int64))

    def log_prob_batched(xs: torch.Tensor) -> torch.Tensor:
        batch = fixed.to(xs.device, xs.dtype).expand(xs.shape[0], -1).clone()
        batch[:, pos.to(xs.device)] = xs
        return full.log_prob_batched(batch)

    return Likelihood("bcmopt", log_prob_batched)


def create_likelihood(filename: str, varset: VariableSet) -> Likelihood:
    """Create a likelihood from a likelihood.xml file (reference:
    src/likelihoods/LikelihoodFactory.cpp:31-101, src/bcminf/main.cpp:43-50)."""
    root = ET.parse(filename).getroot()
    if root.tag != "bcm_likelihood":
        raise ValueError(f"likelihood file root must be bcm_likelihood, got {root.tag}")
    ltype = root.get("type")
    attrs: Dict[str, Any] = dict(root.attrib)
    attrs["_xml_path"] = filename
    attrs["_xml_root"] = root
    if ltype not in _REGISTRY:
        raise NotImplementedError(
            f"likelihood type '{ltype}' is not ported yet (ROADMAP A10); "
            f"ported: {sorted(_REGISTRY)}"
        )
    return _REGISTRY[ltype](varset, attrs)
