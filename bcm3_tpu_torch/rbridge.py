"""R-bridge backend: the Python side of the R analysis interface.

Counterpart of bcm3_tpu/rbridge.py (reference:
src/bcmrbridge/interface.cpp:27-89 `bcm3_rbridge_init`/`cleanup`, and the
per-likelihood accessors of interface_*.cpp), with the same function names
and signatures; `R/bcm3tpu_torch.r` exposes the reference's R function
names on top of this module through reticulate. Plain Python: numpy in,
float64 numpy out, in the JAX bridge's layouts, so the contract is
testable without an R runtime.

`init` takes one keyword more than the JAX bridge's, `device`: the models
run on the card (`None`, "cuda") unless the caller asks for "cpu"; with no
card and no `device="cpu"` it raises. Keyword options whose names start
with "_" go on to `create_likelihood`, such as `_data` (a likelihood's data
groups in memory, for a machine without h5py). The port's models take a
batch (B, D): each accessor evaluates its values as one row, in float64.
"""

from __future__ import annotations

import itertools
import os
from typing import Dict, Optional

import numpy as np
import torch

_handles: Dict[str, dict] = {}
_counter = itertools.count(1)


def init(
    base_folder: str,
    prior_file: str = "prior.xml",
    likelihood_file: str = "likelihood.xml",
    device: Optional[str] = None,
    **options,
) -> str:
    """Build varset, prior and likelihood from the XML files, as the
    reference bridge does (interface.cpp:27-89), on `device` (None: the
    card). Returns an opaque handle."""
    from bcm3_tpu_torch.likelihoods import create_likelihood
    from bcm3_tpu_torch.model.prior import Prior
    from bcm3_tpu_torch.model.variables import VariableSet

    unknown = [k for k in options if not k.startswith("_")]
    if unknown:
        raise TypeError(f"init() got unexpected keyword arguments {unknown}")
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("rbridge.init: no CUDA device; pass device='cpu' to run on the CPU")
    prior_path = os.path.join(base_folder, prior_file)
    lik_path = os.path.join(base_folder, likelihood_file)
    varset = VariableSet.from_xml(prior_path)
    prior = Prior.from_xml(prior_path, varset)
    lik = create_likelihood(lik_path, varset, **options)
    handle = f"bcm3tpu_torch_{next(_counter)}"
    _handles[handle] = {
        "varset": varset,
        "prior": prior,
        "likelihood": lik,
        "base_folder": base_folder,
        "device": device,
    }
    return handle


def cleanup(handle: str) -> None:
    _handles.pop(handle, None)


def _get(handle: str) -> dict:
    if handle not in _handles:
        raise KeyError(f"unknown bcm3 bridge handle '{handle}'")
    return _handles[handle]


def _values(handle: str, param_values) -> torch.Tensor:
    """The values as one float64 row (1, D) on the handle's device."""
    h = _get(handle)
    x = np.asarray(param_values, dtype=np.float64).reshape(1, -1)
    return torch.as_tensor(x, device=h.get("device", torch.device("cpu")))


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().numpy()
    return np.asarray(t, dtype=np.float64)


def _model(handle: str):
    """The handle's model object: a registry Likelihood's `model`, or the
    object registered itself."""
    from bcm3_tpu_torch.likelihoods import Likelihood

    lik = _get(handle)["likelihood"]
    return lik.model if isinstance(lik, Likelihood) else lik


def get_variable_names(handle: str):
    return list(_get(handle)["varset"].names)


def get_log_likelihood(handle: str, param_values) -> float:
    """One likelihood evaluation at the given (untransformed) values
    (reference: bcm3_rbridge_popPK_get_log_likelihood and friends)."""
    return float(_get(handle)["likelihood"].log_prob_batched(_values(handle, param_values))[0])


def get_log_prior(handle: str, param_values) -> float:
    return float(_get(handle)["prior"].log_pdf(_values(handle, param_values))[0])


# ---------------------------------------------------------------------------
# PopPK accessors (reference: interface_popPK.cpp:41-120; R usage in
# R/evaluate_popPK.r). Arrays are (timepoints, patients), the R side's
# array(c(nt, np)).


def popPK_get_observed_data(handle: str):
    m = _model(handle)
    time = np.asarray(m.trial.time, dtype=np.float64)
    data = np.asarray(m.trial.observed, dtype=np.float64).T  # (T, P)
    return {"time": time, "data": data}


def popPK_get_simulated_data(handle: str, param_values):
    m = _model(handle)
    conc = _np(m.simulate_trajectories(_values(handle, param_values))[0]).T
    return {"time": np.asarray(m.trial.time, dtype=np.float64), "data": conc}


# ---------------------------------------------------------------------------
# Single-patient PK / pharmaco accessors


def PK_get_simulated_trajectories(handle: str, param_values):
    m = _model(handle)
    sim = _np(m.simulate_trajectories(_values(handle, param_values))[0])
    return {"time": np.asarray(m.trial.time, dtype=np.float64), "data": sim.T}


def pharmaco_get_simulation(handle: str, param_values):
    conc, ok = _model(handle).simulate(_values(handle, param_values))
    return _np(conc[0]), bool(ok[0])


# ---------------------------------------------------------------------------
# fISA accessors (reference: interface_fISA.cpp:40-192)


def fISA_get_observed_data(handle: str, experiment_ix: int, data_ix: int):
    exp = _model(handle).experiments[experiment_ix]
    return np.asarray(exp.observed_data(data_ix), dtype=np.float64)


def fISA_get_modeled_activities(handle: str, experiment_ix: int, param_values):
    """Steady-state signaling activities (cell line, node) (reference:
    interface_fISA.cpp get_modeled_activities)."""
    lik = _model(handle)
    tv = lik._transform(_values(handle, param_values))[0]
    return _np(lik.experiments[experiment_ix].modeled_activities(tv))


def fISA_get_modeled_data(handle: str, experiment_ix: int, data_ix: int, param_values):
    """Model-predicted observables of one data part (reference:
    interface_fISA.cpp get_modeled_data)."""
    lik = _model(handle)
    tv = lik._transform(_values(handle, param_values))[0]
    return _np(lik.experiments[experiment_ix].modeled_data(tv, data_ix))


def fISA_get_num_experiments(handle: str) -> int:
    return len(_model(handle).experiments)


def fISA_get_num_data(handle: str, experiment_ix: int) -> int:
    return len(_model(handle).experiments[experiment_ix].data_parts)


def fISA_get_num_cell_lines(handle: str, experiment_ix: int) -> int:
    return len(_model(handle).experiments[experiment_ix].cell_lines)


def fISA_get_cell_line_names(handle: str, experiment_ix: int):
    return list(_model(handle).experiments[experiment_ix].cell_lines)


# ---------------------------------------------------------------------------
# popPK full-trajectory accessor (reference: interface_popPK.cpp:79-120)


def popPK_get_simulated_trajectories(handle: str, param_values):
    """{time (T,), concentrations (T, P) nM, trajectories (n, T, P) mg}, the
    reference's array layouts."""
    m = _model(handle)
    conc, states = m.simulate_states(_values(handle, param_values))
    return {
        "time": np.asarray(m.trial.time, dtype=np.float64),
        "concentrations": _np(conc[0]).T,  # (T, P)
        "trajectories": _np(states[0]).transpose(2, 1, 0),  # (n, T, P)
    }


# ---------------------------------------------------------------------------
# ODE template accessor (reference: interface_ODE.cpp:56-78)


def ODE_get_simulated_trajectories(handle: str, param_values):
    """(4, 100) trajectory matrix, the reference's fixed layout
    (interface_ODE.cpp:70-76 out_values[j*100+i] = simtraj(j, i))."""
    ys, _ok = _model(handle).simulate(_values(handle, param_values))
    return _np(ys[0]).T  # (4, 100)


# ---------------------------------------------------------------------------
# Pharmaco single-patient accessors
# (reference: interface_pharmaco_single.cpp:40-152)


def pharmacosingle_get_observed_data(handle: str):
    t, y = _model(handle).observed()
    return {"time": np.asarray(t, dtype=np.float64), "data": np.asarray(y, dtype=np.float64)}


def pharmacosingle_get_simulated_data(handle: str, param_values):
    m = _model(handle)
    conc, _ = m.simulate(_values(handle, param_values))
    t, _ = m.observed()
    return {"time": np.asarray(t, dtype=np.float64), "data": _np(conc[0])}


def pharmacosingle_get_simulated_trajectory(handle: str, param_values, timepoints):
    conc, traj, ok = _model(handle).simulate_trajectory(_values(handle, param_values),
                                                        np.asarray(timepoints, dtype=np.float64))
    return {
        "time": np.asarray(timepoints, dtype=np.float64),
        "concentrations": _np(conc[0]),
        "trajectories": _np(traj[0]).T,  # (n_comp, T)
        "ok": bool(ok[0]),
    }


# ---------------------------------------------------------------------------
# Pharmaco population accessors
# (reference: interface_pharmaco_population.cpp:40-190)


def pharmacopop_get_num_patients(handle: str) -> int:
    return int(_model(handle).num_patients)


def pharmacopop_get_observed_data(handle: str, patient_ix: int):
    t, y = _model(handle).observed(patient_ix)
    return {"time": np.asarray(t, dtype=np.float64), "data": np.asarray(y, dtype=np.float64)}


def pharmacopop_get_simulated_data(handle: str, param_values, patient_ix: int):
    m = _model(handle)
    t, _ = m.observed(patient_ix)
    conc, _, _ = m.simulate_patient_trajectory(_values(handle, param_values), patient_ix,
                                               np.asarray(t, dtype=np.float64))
    return {"time": np.asarray(t, dtype=np.float64), "data": _np(conc[0])}


def pharmacopop_get_simulated_trajectory(handle: str, param_values, patient_ix: int,
                                         timepoints):
    conc, traj, ok = _model(handle).simulate_patient_trajectory(
        _values(handle, param_values), patient_ix, np.asarray(timepoints, dtype=np.float64))
    return {
        "time": np.asarray(timepoints, dtype=np.float64),
        "concentrations": _np(conc[0]),
        "trajectories": _np(traj[0]).T,
        "ok": bool(ok[0]),
    }


# ---------------------------------------------------------------------------
# Incucyte accessors (reference: interface_incucyte.cpp:40-122)

_INCUCYTE_WELL_MATRICES = ("cell_count", "apoptotic_cell_count", "debris", "confluence",
                           "apoptosis_marker")


def incucyte_get_simulated_trajectories(handle: str, param_values, experiment_ix: int):
    """The five well matrices (n_wells, T) the reference exposes, keyed by
    name; wells are ordered [negative, positive, drug_0..]."""
    m = _model(handle)
    sim = m.simulate_experiment(_values(handle, param_values), m.experiments[experiment_ix])
    return {k: _np(sim[k][0]) for k in _INCUCYTE_WELL_MATRICES}


def incucyte_get_simulated_ctb(handle: str, param_values, experiment_ix: int):
    m = _model(handle)
    sim = m.simulate_experiment(_values(handle, param_values), m.experiments[experiment_ix])
    return _np(sim["ctb"][0])


# ---------------------------------------------------------------------------
# Cellpop accessors (reference: interface_cellpop.cpp:45-418); the model's
# accessors take one row of untransformed values (D,)


def cellpop_get_num_species(handle: str, experiment=None) -> int:
    return int(_model(handle).get_experiment(experiment).num_species)


def cellpop_get_species_names(handle: str, experiment=None):
    return list(_model(handle).get_experiment(experiment).species_names)


def cellpop_get_num_data(handle: str, experiment=None) -> int:
    return len(_model(handle).get_experiment(experiment).data_likelihoods)


def cellpop_get_simulated_trajectories(handle: str, param_values, experiment=None,
                                       n_timepoints: int = 500):
    """{time (T,), values (cells, T, species), parents (cells,)}."""
    t, v, parents = _model(handle).simulated_trajectories(
        _values(handle, param_values)[0], experiment, n_timepoints=n_timepoints)
    return {"time": t, "values": v, "parents": parents}


def cellpop_get_observed_data(handle: str, data_ix: int, experiment=None):
    """{time, values} of one data likelihood's observations."""
    dl = _model(handle).get_experiment(experiment).data_likelihoods[data_ix]
    tp = getattr(dl, "timepoints", None)
    return {
        "time": np.asarray(tp, dtype=np.float64) if tp is not None else np.zeros(1),
        "values": np.asarray(dl.observed, dtype=np.float64),
    }


def cellpop_get_simulated_data(handle: str, param_values, data_ix: int, experiment=None):
    t, v = _model(handle).simulated_data(_values(handle, param_values)[0], data_ix, experiment)
    return {"time": t, "values": v}


def cellpop_get_matched_simulation(handle: str, param_values, data_ix: int, experiment=None,
                                   n_timepoints: int = 500):
    t, v = _model(handle).matched_simulation(_values(handle, param_values)[0], data_ix,
                                             experiment, n_timepoints=n_timepoints)
    return {"time": t, "values": v}
