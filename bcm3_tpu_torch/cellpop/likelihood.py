"""Top-level cell-population likelihood: sum over experiments.

Counterpart of bcm3_tpu/cellpop/likelihood.py (reference:
src/cellpop/CellPopulationLikelihood.cpp:15-95). `log_prob_batched(xs (B,
D)) -> (B,)` simulates every row on xs's device in one pass an experiment
and finishes the Hungarian-matched data likelihoods on the host, one
native call a batch and data likelihood.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import List, Optional

import numpy as np
import torch

from bcm3_tpu_torch.cellpop.experiment import Experiment
from bcm3_tpu_torch.model.variables import (
    TRANSFORM_LOG,
    TRANSFORM_LOG10,
    TRANSFORM_LOGIT,
    VariableSet,
)


class CellPopulationLikelihood:
    def __init__(self, experiments: List[Experiment], varset: VariableSet):
        self.experiments = experiments
        self.varset = varset
        self._transforms = np.asarray(varset.transforms)

    @classmethod
    def from_xml_node(
        cls,
        root: ET.Element,
        varset: VariableSet,
        base_dir: str = ".",
        non_sampled_names=None,
        sparse_stiff: bool = True,
        data=None,
    ) -> "CellPopulationLikelihood":
        """`data`, if given, maps an experiment's name to its data group (a
        mapping of name -> numpy array) in place of its data file."""
        experiments = [
            Experiment(node, varset, base_dir, non_sampled_names, sparse_stiff=sparse_stiff,
                       data=None if data is None else data.get(node.get("name")))
            for node in root.findall("experiment")
        ]
        if not experiments:
            raise ValueError("cell_population likelihood requires experiments")
        return cls(experiments, varset)

    def _transform(self, values):
        t = torch.as_tensor(self._transforms, device=values.device)
        x = values
        x = torch.where(t == TRANSFORM_LOG, torch.exp(values), x)
        x = torch.where(t == TRANSFORM_LOG10, torch.pow(10.0, values), x)
        x = torch.where(t == TRANSFORM_LOGIT, 1.0 / (1.0 + torch.exp(-values)), x)
        return x

    def log_prob_batched(self, values: torch.Tensor) -> torch.Tensor:
        """Log-likelihood of each row of untransformed values (B, D)."""
        tv = self._transform(values)
        logp = values.new_zeros(values.shape[0])
        for exp in self.experiments:
            logp = logp + exp.log_prob_batched(tv)
        return torch.where(torch.isnan(logp), -torch.inf, logp)

    def get_experiment(self, name: Optional[str] = None) -> Experiment:
        """Experiment by name (reference:
        CellPopulationLikelihood::GetExperiment); None -> first."""
        if name is None or name == "":
            return self.experiments[0]
        for exp in self.experiments:
            if exp.name == name:
                return exp
        raise KeyError(f"No experiment named '{name}'")

    # Posterior-predictive accessors on one row of UNTRANSFORMED values
    # (D,) — the Python side of the cellpop R bridge
    # (reference: src/bcmrbridge/interface_cellpop.cpp:45-418).

    def _row(self, values):
        return self._transform(torch.as_tensor(values)[None])[0]

    def simulated_trajectories(self, values, experiment=None, **kw):
        return self.get_experiment(experiment).simulated_trajectories(self._row(values), **kw)

    def simulated_data(self, values, data_ix: int, experiment=None):
        return self.get_experiment(experiment).simulated_data(self._row(values), data_ix)

    def matched_simulation(self, values, data_ix: int, experiment=None, **kw):
        return self.get_experiment(experiment).matched_simulation(self._row(values), data_ix,
                                                                  **kw)

    def close(self):
        for exp in self.experiments:
            exp.close()


def create_cellpop_likelihood(varset: VariableSet, attrs):
    """Factory entry (reference: LikelihoodFactory.cpp 'cell_population').
    Besides the XML, attrs may hold `_sparse_stiff` (bool, default True)
    and `_data` (experiment name -> data group mapping)."""
    root = attrs.get("_xml_root")
    if root is None:
        raise ValueError("cell_population likelihood requires an XML definition")
    xml_path = attrs.get("_xml_path")
    base_dir = os.path.dirname(xml_path) if xml_path else "."
    return CellPopulationLikelihood.from_xml_node(
        root, varset, base_dir, sparse_stiff=attrs.get("_sparse_stiff", True),
        data=attrs.get("_data"),
    )
