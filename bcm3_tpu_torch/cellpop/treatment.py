"""Treatment trajectories: time-varying drug inputs to constant species.

Counterpart of bcm3_tpu/cellpop/treatment.py (reference:
src/cellpop/TreatmentTrajectory.cpp, TreatmentTrajectoryFromData.cpp,
TreatmentTrajectoryPulses.cpp): a trajectory is a function of global time
that the right-hand side evaluates every step, over lanes
(``concentration(cell_time, creation_time)`` of any broadcastable
shapes); the adaptive step controller resolves the kinks.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from bcm3_tpu_torch.likelihoods.cellmisc import interp


def _on(obj, name: str, like: torch.Tensor) -> torch.Tensor:
    """obj's array `name` as a tensor in like's dtype and device, made once
    (a right-hand side reads it every step)."""
    cache = obj.__dict__.setdefault("_tensors", {})
    key = (name, like.dtype, str(like.device))
    if key not in cache:
        cache[key] = torch.as_tensor(getattr(obj, name), dtype=like.dtype, device=like.device)
    return cache[key]


@dataclass
class TreatmentTrajectoryFromData:
    """Piecewise-linear concentration from data
    (reference: TreatmentTrajectoryFromData.cpp GetConcentration:31-55;
    treatment_time is stored in hours and converted to seconds)."""

    timepoints: np.ndarray  # (T,) seconds
    concentrations: np.ndarray  # (T,)

    @classmethod
    def from_data_file(cls, h5_group, treatment_variable: str):
        times = np.asarray(h5_group["treatment_time"], dtype=np.float64) * 3600.0
        conc = np.asarray(h5_group[treatment_variable], dtype=np.float64)
        if conc.ndim == 2:
            conc = conc[0]
        return cls(timepoints=times, concentrations=conc)

    def concentration(self, cell_time, creation_time):
        t = cell_time + creation_time
        return interp(t, _on(self, "timepoints", t), _on(self, "concentrations", t))


@dataclass
class TreatmentTrajectoryPulses:
    """Trapezoidal pulses: 2h ramp up starting 2h after each pulse time,
    8h plateau at 1, 4h ramp down
    (reference: TreatmentTrajectoryPulses.cpp GetConcentration:18-40)."""

    timepoints: np.ndarray  # sorted pulse start times

    @classmethod
    def from_xml(cls, node):
        times = np.sort(np.array([float(v) for v in node.get("times").split(",")]))
        return cls(timepoints=times)

    def concentration(self, cell_time, creation_time):
        t = cell_time + creation_time
        t_in_pulse = t[..., None] - _on(self, "timepoints", t) - 2.0  # (..., P)
        ramp_up = torch.clamp(t_in_pulse * 0.5, 0.0, 1.0)
        ramp_down = torch.clamp(1.0 - (t_in_pulse - 10.0) * 0.25, 0.0, 1.0)
        val = torch.where(
            (t_in_pulse > 0.0) & (t_in_pulse < 14.0), torch.minimum(ramp_up, ramp_down), 0.0
        )
        return val.amax(dim=-1)


def create_treatment_trajectory(node, h5_group=None):
    """Factory (reference: TreatmentTrajectory.cpp Create: type
    'from_data' | 'pulses')."""
    ttype = node.get("type", "from_data")
    if ttype == "pulses":
        return TreatmentTrajectoryPulses.from_xml(node)
    if ttype == "from_data":
        if h5_group is None:
            raise ValueError("from_data treatment trajectory requires a data file")
        treatment_variable = node.get("treatment_variable", node.get("species_name"))
        return TreatmentTrajectoryFromData.from_data_file(h5_group, treatment_variable)
    raise ValueError(f"Unknown treatment trajectory type '{ttype}'")
