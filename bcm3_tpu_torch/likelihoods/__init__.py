"""Likelihood registry: string type -> batched torch log-density.

Counterpart of bcm3_tpu/likelihoods/__init__.py (reference:
src/likelihoods/LikelihoodFactory.cpp:31-101), configured from the same
``likelihood.xml`` schema. A likelihood here is batched by nature: its
one evaluation entry is ``log_prob_batched(xs (B, D)) -> (B,)``. Ported:
the analytic targets (``banana``, ``circular``, ``multimodal_gaussians``,
``truncated_t``, ``dummy``), ``pop_pk_trajectory``, the pharmacometric
types (``pharmaco_single``, ``pharmaco_population``,
``pharmacokinetic_trajectory``), the generic ``ODE`` and ``dll``, and
the cell likelihoods ``cell_cycle_marker``, ``mitosis_time_estimation``,
``incucyte_population`` and ``cell_population``, and ``fISA``: every type
of the JAX package. `register_likelihood` adds a type, `available_likelihoods`
lists them, and `fixed_parameter_likelihood` builds the likelihood of
`--bcmopt`.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Sequence

import numpy as np
import torch

from bcm3_tpu_torch.likelihoods import analytic
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


def parse_vector(s: str) -> np.ndarray:
    """Parse 'a;b;c' vectors (reference: src/utils/VectorUtils.cpp:255)."""
    return np.array([float(v) for v in s.split(";") if v.strip() != ""])


def parse_matrix(s: str) -> np.ndarray:
    """Parse 'a,b;c,d' row-major matrices (reference: src/utils/VectorUtils.cpp)."""
    rows = [r for r in s.split(";") if r.strip() != ""]
    return np.array([[float(v) for v in r.split(",")] for r in rows])


_REGISTRY: Dict[str, Callable[..., Likelihood]] = {}


def register_likelihood(name: str):
    """Decorator: register `fn(varset, attrs) -> Likelihood` as the factory
    of likelihood type `name` (bcm3_tpu/likelihoods/__init__.py:54-59), which
    `create_likelihood` then builds from a likelihood.xml whose type names
    it or from the bare type name."""

    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def available_likelihoods():
    """The registered likelihood types, sorted."""
    return sorted(_REGISTRY)


# attribute parsing and errors as bcm3_tpu/likelihoods/__init__.py:104-156


@register_likelihood("banana")
def _banana(varset: VariableSet, attrs) -> Likelihood:
    dim = int(attrs.get("dimension", varset.num_variables))
    if dim != varset.num_variables:
        raise ValueError("Banana dimension does not match prior variable count")
    sd1 = float(attrs["sd1"])
    sd2 = float(attrs["sd2"])
    if sd1 <= 0 or sd2 <= 0:
        raise ValueError("Standard deviations must be positive")
    return Likelihood("banana", analytic.make_banana(dim, sd1, sd2), attrs=attrs)


@register_likelihood("circular")
def _circular(varset: VariableSet, attrs) -> Likelihood:
    dim = int(attrs.get("dimension", varset.num_variables))
    if dim != varset.num_variables:
        raise ValueError("Circular dimension does not match prior variable count")
    radius = float(attrs.get("radius", 2.0))
    offset = float(attrs.get("offset", 3.5))
    # the reference example file contains width="=0.1"; boost's lexical cast
    # fails silently into the default there, so strip stray '=' prefixes
    width = float(str(attrs.get("width", 0.1)).lstrip("="))
    return Likelihood(
        "circular", analytic.make_circular(dim, radius, offset, width), attrs=attrs
    )


@register_likelihood("multimodal_gaussians")
def _multimodal(varset: VariableSet, attrs) -> Likelihood:
    if varset.num_variables != 2:
        raise ValueError("multimodal_gaussians requires exactly 2 variables")
    return Likelihood(
        "multimodal_gaussians", analytic.make_multimodal_gaussians(), attrs=attrs
    )


@register_likelihood("truncated_t")
def _truncated_t(varset: VariableSet, attrs) -> Likelihood:
    dim = int(attrs["dimensions"])
    if dim != varset.num_variables:
        raise ValueError("truncated_t dimensions do not match prior variable count")
    k = int(attrs["num_clusters"])
    mus = [parse_vector(attrs[f"mu{i+1}"]) for i in range(k)]
    sigmas = [parse_matrix(attrs[f"sigma{i+1}"]) for i in range(k)]
    nus = parse_vector(attrs["nus"])
    weights = parse_vector(attrs["weights"])
    if len(nus) != k or len(weights) != k:
        raise ValueError("Inconsistent number of nus/weights")
    return Likelihood(
        "truncated_t", analytic.make_truncated_t(mus, sigmas, nus, weights), attrs=attrs
    )


@register_likelihood("dummy")
def _dummy(varset: VariableSet, attrs) -> Likelihood:
    return Likelihood("dummy", analytic.make_dummy(), attrs=attrs)


@register_likelihood("pop_pk_trajectory")
def _pop_pk(varset: VariableSet, attrs) -> Likelihood:
    from bcm3_tpu_torch.likelihoods.poppk import create_poppk_likelihood

    pk = create_poppk_likelihood(varset, attrs)
    return Likelihood("pop_pk_trajectory", pk.log_prob_batched, attrs=attrs, model=pk)


@register_likelihood("pharmaco_single")
def _pharmaco_single(varset: VariableSet, attrs) -> Likelihood:
    from bcm3_tpu_torch.likelihoods.pharmaco import create_pharmaco_single

    model = create_pharmaco_single(varset, attrs)
    return Likelihood("pharmaco_single", model.log_prob_batched, attrs=attrs, model=model)


@register_likelihood("pharmaco_population")
def _pharmaco_population(varset: VariableSet, attrs) -> Likelihood:
    from bcm3_tpu_torch.likelihoods.pharmaco import create_pharmaco_population

    model = create_pharmaco_population(varset, attrs)
    return Likelihood("pharmaco_population", model.log_prob_batched, attrs=attrs, model=model)


@register_likelihood("pharmacokinetic_trajectory")
def _pk_single(varset: VariableSet, attrs) -> Likelihood:
    from bcm3_tpu_torch.likelihoods.pk_single import create_pk_likelihood

    pk = create_pk_likelihood(varset, attrs)
    return Likelihood("pharmacokinetic_trajectory", pk.log_prob_batched, attrs=attrs, model=pk)


@register_likelihood("ODE")
def _ode_template(varset: VariableSet, attrs) -> Likelihood:
    from bcm3_tpu_torch.likelihoods.ode_template import ODETemplateLikelihood

    model = ODETemplateLikelihood(varset, derivative=attrs.get("_derivative"))
    return Likelihood("ODE", model.log_prob_batched, attrs=attrs, model=model)


@register_likelihood("dll")
def _dll(varset: VariableSet, attrs) -> Likelihood:
    from bcm3_tpu_torch.likelihoods.plugin import load_plugin_log_prob

    base = attrs.get("dll_filename_base") or attrs.get("plugin")
    if not base:
        raise ValueError("dll likelihood requires a dll_filename_base attribute")
    xml_path = attrs.get("_xml_path")
    base_dir = os.path.dirname(xml_path) if xml_path else "."
    return Likelihood("dll", load_plugin_log_prob(base, list(varset.names), base_dir),
                      attrs=attrs)


@register_likelihood("cell_cycle_marker")
def _cell_cycle_marker(varset: VariableSet, attrs) -> Likelihood:
    from bcm3_tpu_torch.likelihoods.cellmisc import create_cell_cycle_marker

    model = create_cell_cycle_marker(varset, attrs)
    return Likelihood("cell_cycle_marker", model.log_prob_batched, attrs=attrs, model=model)


@register_likelihood("mitosis_time_estimation")
def _mitosis(varset: VariableSet, attrs) -> Likelihood:
    from bcm3_tpu_torch.likelihoods.cellmisc import create_mitosis_time_estimation

    model = create_mitosis_time_estimation(varset, attrs)
    return Likelihood("mitosis_time_estimation", model.log_prob_batched, attrs=attrs,
                      model=model)


@register_likelihood("incucyte_population")
def _incucyte(varset: VariableSet, attrs) -> Likelihood:
    from bcm3_tpu_torch.likelihoods.cellmisc import create_incucyte_population

    model = create_incucyte_population(varset, attrs)
    return Likelihood("incucyte_population", model.log_prob_batched, attrs=attrs, model=model)


@register_likelihood("cell_population")
def _cell_population(varset: VariableSet, attrs) -> Likelihood:
    from bcm3_tpu_torch.cellpop.likelihood import create_cellpop_likelihood

    model = create_cellpop_likelihood(varset, attrs)
    return Likelihood("cell_population", model.log_prob_batched, attrs=attrs, model=model)


@register_likelihood("fISA")
def _fisa(varset: VariableSet, attrs) -> Likelihood:
    from bcm3_tpu_torch.fisa import create_fisa_likelihood

    model = create_fisa_likelihood(varset, attrs)
    return Likelihood("fISA", model.log_prob_batched, attrs=attrs, model=model)


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

    # the model goes along for its gradient mode (sampler/hmc.py `gradient_mode`)
    return Likelihood("bcmopt", log_prob_batched, model=full.model)


def create_likelihood(filename_or_type: str, varset: VariableSet, **kwargs) -> Likelihood:
    """Create a likelihood from a likelihood.xml file or a bare type name,
    whose attributes are then the keyword arguments (numbers as strings,
    as XML gives them; names starting with "_" as they are, such as the
    ODE type's `_derivative`); with a file, keyword arguments whose names
    start with "_" are passed along beside its attributes (reference:
    src/likelihoods/LikelihoodFactory.cpp:31-101, src/bcminf/main.cpp:43-50)."""
    if filename_or_type.endswith(".xml"):
        root = ET.parse(filename_or_type).getroot()
        if root.tag != "bcm_likelihood":
            raise ValueError(f"likelihood file root must be bcm_likelihood, got {root.tag}")
        ltype = root.get("type")
        attrs: Dict[str, Any] = dict(root.attrib)
        attrs["_xml_path"] = filename_or_type
        attrs["_xml_root"] = root
        # options that are no XML attribute, such as cell_population's and
        # fISA's `_data` (their data groups in memory)
        attrs.update({k: v for k, v in kwargs.items() if k.startswith("_")})
    else:
        ltype = filename_or_type
        attrs = {
            k: (v if k.startswith("_") or not isinstance(v, (int, float)) else str(v))
            for k, v in kwargs.items()
        }
    if ltype not in _REGISTRY:
        raise ValueError(f"Unknown likelihood type '{ltype}'; available: {available_likelihoods()}")
    return _REGISTRY[ltype](varset, attrs)
