"""Single-patient pharmacokinetic trajectory likelihood on torch tensors.

Counterpart of bcm3_tpu/likelihoods/pk_single.py (reference:
src/likelihoods/LikelihoodPharmacokineticTrajectory.cpp). It is the
PopPK model restricted to one patient with the PK parameters sampled
directly (no population-level non-centered transform,
LikelihoodPharmacokineticTrajectory.cpp:255-290), so the whole simulation
is the port's PopPKLikelihood's at P = 1: kernel B1 for `one`, kernel B2
for `one_transit`, the closed form and the eager DP5 for the others.

Variable layout (reference: LikelihoodPharmacokineticTrajectory.cpp
:247-290): index 0 = absorption, 1 = excretion, 2 = elimination
(divided by the volume of distribution), 3 = volume of distribution,
4/5 = periphery forward/backward (two-compartment models),
6/7 = biphasic switch time / second absorption rate,
``n_transit``/``mean_transit_time`` by name (transit models),
``standard_deviation`` by name with the proportional term at the next
index. Residuals are Student-t(nu=4) with sd + sd2*max(x,0)
(:330-333).
"""

from __future__ import annotations

import numpy as np
import torch

from bcm3_tpu_torch.likelihoods.poppk import TRANSIT_TYPES, PopPKLikelihood, PopPKTrial
from bcm3_tpu_torch.model.variables import VariableSet


def select_patient(trial: PopPKTrial, patient_id: str) -> PopPKTrial:
    """Restrict a trial to one patient (reference loads only the requested
    patient row, LikelihoodPharmacokineticTrajectory.cpp:163-186)."""
    ids = [p.decode() if isinstance(p, bytes) else str(p) for p in trial.patient_ids]
    if patient_id not in ids:
        raise ValueError(f"Cannot find patient '{patient_id}' in data file")
    j = ids.index(patient_id)
    sel = slice(j, j + 1)
    return PopPKTrial(
        time=trial.time,
        patient_ids=trial.patient_ids[sel],
        observed=trial.observed[sel],
        dose=trial.dose[sel],
        dose_after_dose_change=trial.dose_after_dose_change[sel],
        dose_change_time=trial.dose_change_time[sel],
        dosing_interval=trial.dosing_interval[sel],
        intermittent=trial.intermittent[sel],
        interruptions=trial.interruptions[sel],
    )


class SinglePatientPKLikelihood(PopPKLikelihood):
    """Batched log-likelihood of one patient with directly sampled PK
    parameters."""

    # the biphasic rates sit at indices 6/7 here, not by name
    NAMED_PARAMS = {k: v for k, v in PopPKLikelihood.NAMED_PARAMS.items() if k in TRANSIT_TYPES}

    def __init__(
        self,
        varset: VariableSet,
        trial: PopPKTrial,
        pk_type: str,
        drug: str,
        fixed_vod: float = np.nan,
        fixed_periphery_fwd: float = np.nan,
        fixed_periphery_bwd: float = np.nan,
    ):
        if trial.num_patients != 1:
            raise ValueError(
                "SinglePatientPKLikelihood requires a single-patient trial (use select_patient)"
            )
        self._skip_varset_check = True
        super().__init__(
            varset,
            trial,
            pk_type,
            drug,
            fixed_vod=fixed_vod,
            fixed_periphery_fwd=fixed_periphery_fwd,
            fixed_periphery_bwd=fixed_periphery_bwd,
        )

    def _patient_params(self, xs):
        """Directly sampled parameters of every row of xs (B, D), with the
        (P = 1) patient axis where the population model has one
        (reference: LikelihoodPharmacokineticTrajectory.cpp:255-290)."""
        ka = self._transform(0, xs[:, 0])[:, None]
        ke = self._transform(1, xs[:, 1])
        if np.isfinite(self.fixed_vod):
            vod = torch.full_like(ke, float(self.fixed_vod))
        else:
            vod = self._transform(3, xs[:, 3])
        kel = (self._transform(2, xs[:, 2]) / vod)[:, None]
        params = {"ka": ka, "ke": ke, "vod": vod, "kel": kel}
        if self.n_states == 3:
            if not np.isfinite(self.fixed_periphery_fwd):
                params["kpf"] = self._transform(4, xs[:, 4])
                params["kpb"] = self._transform(5, xs[:, 5])
            else:
                params["kpf"] = torch.full_like(ke, float(self.fixed_periphery_fwd))
                params["kpb"] = torch.full_like(ke, float(self.fixed_periphery_bwd))
        if self.pk_type in TRANSIT_TYPES:
            nt_ix = self._named_ix["n_transit"]
            mt_ix = self._named_ix["mean_transit_time"]
            n_transit = self._transform(nt_ix, xs[:, nt_ix])
            params["n_transit"] = n_transit
            params["k_transit"] = (n_transit + 1.0) / self._transform(mt_ix, xs[:, mt_ix])
        if self.pk_type == "two_biphasic":
            # biphasic switch time / second absorption at fixed indices 6/7
            # (reference: LikelihoodPharmacokineticTrajectory.cpp:282-287),
            # the switch clamped to interval - 1e-2
            switch = self._transform(6, xs[:, 6])
            limit = float(self.trial.dosing_interval[0]) - 1e-2
            params["switch_time"] = torch.clamp(switch, max=limit)[:, None]
            params["ka2"] = self._transform(7, xs[:, 7])
        sd = self._transform(self.sd_ix, xs[:, self.sd_ix])
        sd2 = self._transform(self.sd_ix + 1, xs[:, self.sd_ix + 1])
        return params, sd, sd2


def create_pk_likelihood(varset: VariableSet, attrs) -> SinglePatientPKLikelihood:
    """Factory entry (reference: LikelihoodFactory.cpp
    'pharmacokinetic_trajectory'); the patient comes from the XML or the
    ``pk.patient`` option (LikelihoodPharmacokineticTrajectory.cpp:226-234)."""
    root = attrs.get("_xml_root")
    if root is None:
        raise ValueError("pharmacokinetic_trajectory likelihood requires an XML definition")
    node = root.find("pk_model")
    if node is None:
        raise ValueError("likelihood XML must contain a <pk_model> element")
    patient = attrs.get("pk.patient") or node.get("patient")
    if not patient:
        raise ValueError(
            "Patient ID has not been specified in either the likelihood or as an option"
        )
    drug = node.get("drug")
    trial = PopPKTrial.load(node.get("pkdata_file", "pkdata.nc"), node.get("trial"), drug)
    return SinglePatientPKLikelihood(
        varset,
        select_patient(trial, patient),
        node.get("type"),
        drug,
        fixed_vod=float(node.get("volume_of_distribution", "nan")),
        fixed_periphery_fwd=float(node.get("k_periphery_fwd", "nan")),
        fixed_periphery_bwd=float(node.get("k_periphery_bwd", "nan")),
    )
