"""fISA likelihood: steady-state signaling activities against observed data.

Counterpart of bcm3_tpu/fisa/likelihood.py (reference:
src/fISA/fISALikelihood.cpp, fISAExperiment.cpp,
fISAExperimentSingleCondition.cpp, fISAExperimentIncucyteSequential.cpp),
configured by the same XML schema. `FISALikelihood.log_prob_batched(xs
(B, D)) -> (B,)` evaluates a batch of rows on xs's device and dtype:

- a single-condition experiment solves every (row, cell line, Sobol start)
  as a lane (fisa/network.py), scores each solve against the data parts
  (normal, truncated normal, Student t with nu = 3, truncated t; NaN
  observations masked) and keeps the best root per (row, cell line), whose
  activities later relative experiments read;
- an incucyte-sequential experiment solves every (row, cell line, drug
  concentration) from the fixed 0.5 start and scores the (proliferation,
  apoptosis) pair with a 3-component bivariate t mixture read from a
  tab-separated table, optionally relative to an earlier single-condition
  experiment's proliferation.

The data file (`data_file`, HDF5) is opened with h5py when one is read;
`data` may instead give the experiment's group as a mapping of name ->
numpy array, for a machine without h5py (`create_likelihood(path, varset,
_data={experiment name: {dataset name: array}})`). The reference's
drug-range variant is dead code upstream and not reproduced, as in the JAX
package.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from dataclasses import dataclass
from typing import List, Mapping, Optional

import numpy as np
import torch

from bcm3_tpu_torch.distributions.univariate import (
    logpdf_normal,
    logpdf_t,
    logpdf_truncated_normal,
    logpdf_truncated_t,
)
from bcm3_tpu_torch.fisa.network import TYPE_DRUG, SignalingNetwork
from bcm3_tpu_torch.model.variables import (
    TRANSFORM_LOG,
    TRANSFORM_LOG10,
    TRANSFORM_LOGIT,
    VariableSet,
)


@dataclass
class DataPart:
    """One <data> element (reference: ParseDataPartBase:243-330)."""

    model_ix: int
    data: np.ndarray  # (n_replicates, n_cell_lines)
    likelihood_fn: str = "studentt"
    weight: float = 1.0
    use_base: bool = True
    use_scale: bool = True
    scale_var_with_mean: bool = True
    data_is_inactive_form: bool = False
    scale_per_cell_line: bool = False
    base_ix: Optional[int] = None
    fixed_base: float = 0.0
    scale_ix: Optional[int] = None
    sd_ix: Optional[int] = None
    fixed_sd: float = np.nan
    expression_ix: Optional[int] = None


@dataclass
class Condition:
    model_ix: int
    values: Optional[np.ndarray] = None  # (n_cell_lines,)
    parameter_ix: Optional[int] = None


@dataclass
class ExpressionLevel:
    model_ix: int
    values: np.ndarray  # (n_cell_lines,)
    base_ix: Optional[int] = None
    scale_ix: Optional[int] = None


def first_max_index(x: torch.Tensor) -> torch.Tensor:
    """`jnp.argmax` over the last axis, without a host read: the first NaN
    if there is one, else the first maximum."""
    M = x.shape[-1]
    ix = torch.arange(M, device=x.device)
    nan = torch.isnan(x)
    hit = torch.where(nan.any(dim=-1, keepdim=True), nan, x == x.amax(dim=-1, keepdim=True))
    return torch.where(hit, ix, M).amin(dim=-1)


class FISAExperiment:
    def __init__(self, node: ET.Element, varset: VariableSet, base_dir: str = ".",
                 data: Optional[Mapping[str, np.ndarray]] = None):
        self.name = node.get("name")
        self.varset = varset
        model_file = node.get("model_file")
        if not os.path.isabs(model_file):
            model_file = os.path.join(base_dir, model_file)
        self.network = SignalingNetwork.from_sbml(
            model_file,
            varset,
            activation_limit=node.get("activation_limit", "minmax"),
            # reference: fISALikelihood.cpp:31
            multiroot_solves=int(node.get("multiroot_solves", "10")),
        )
        self.base_dir = base_dir
        self.conditions: List[Condition] = []
        self.expression_levels: List[ExpressionLevel] = []
        self.data_parts: List[DataPart] = []
        self._tensors = {}
        if data is not None:
            self._parse(node, data)
            return
        import h5py

        data_file = node.get("data_file")
        if not os.path.isabs(data_file):
            data_file = os.path.join(base_dir, data_file)
        with h5py.File(data_file, "r") as f:
            self._parse(node, f[self.name])

    def _parse(self, node, g):
        varset = self.varset
        self.cell_lines = [c.decode() if isinstance(c, bytes) else str(c)
                           for c in g["cell_lines"]]
        P = len(self.cell_lines)
        self._parse_type_specific(node, g)
        for cnode in node:
            if cnode.tag in ("condition", "mutation"):
                mix = self.network.molecule_ix_by_name(cnode.get("species_name"))
                c = Condition(model_ix=mix)
                if cnode.get("data_name"):
                    c.values = self._read_2d(g, cnode.get("data_name"), P)
                elif cnode.get("variable_name"):
                    c.parameter_ix = varset.index_of(cnode.get("variable_name"))
                else:
                    c.values = np.full(P, float(cnode.get("value")))
                self.conditions.append(c)
            elif cnode.tag == "expression_level":
                name = cnode.get("species_name")
                mix = self.network.molecule_ix_by_name(name)
                if cnode.get("data_name"):
                    values = self._read_2d(g, cnode.get("data_name"), P)
                else:
                    values = np.full(P, float(cnode.get("value")))
                el = ExpressionLevel(model_ix=mix, values=values)
                base_name = cnode.get("base_parameter", f"base_expression[{name}]")
                scale_name = cnode.get("scale_parameter", f"scale_expression[{name}]")
                if base_name in varset.names:
                    el.base_ix = varset.index_of(base_name)
                if scale_name in varset.names:
                    el.scale_ix = varset.index_of(scale_name)
                self.expression_levels.append(el)
            elif cnode.tag == "data":
                self._parse_data_node(cnode, g, P)

    def _parse_type_specific(self, node, g):
        """Hook for experiment-type-specific XML nodes (reference:
        fISAExperiment::LoadTypeSpecificNodes)."""

    def _parse_data_node(self, cnode, g, P):
        self.data_parts.append(self._parse_data(cnode, g, P))

    @staticmethod
    def _read_2d(g, data_name: str, P: int) -> np.ndarray:
        """'name[i]' references row i of a 2-D [rows, cell_lines] dataset
        (reference: ParseDataFileReference)."""
        if "[" in data_name:
            base, rest = data_name.split("[", 1)
            ix = int(rest.rstrip("]"))
            return np.asarray(g[base][ix][:P], dtype=np.float64)
        arr = np.asarray(g[data_name], dtype=np.float64)
        return arr[:P] if arr.ndim == 1 else arr[0][:P]

    def _parse_data(self, node, g, P: int) -> DataPart:
        varset = self.varset
        mix = self.network.molecule_ix_by_name(node.get("species_name"))
        raw = np.asarray(g[node.get("data_name")], dtype=np.float64)
        if raw.ndim == 1:
            raw = raw[None, :]
        suffix = node.get("base_scale_sd_suffix", "")

        def flag(name, default):
            return node.get(name, default).lower() in ("1", "true")

        dp = DataPart(
            model_ix=mix,
            data=raw,
            likelihood_fn=node.get("likelihood_function", "studentt"),
            weight=float(node.get("weight", "1.0")),
            use_base=flag("use_base", "true"),
            use_scale=flag("use_scale", "true"),
            scale_var_with_mean=flag("scale_var_with_mean", "true"),
            data_is_inactive_form=flag("data_is_inactive_form", "false"),
        )
        if dp.likelihood_fn not in ("normal", "truncated_normal", "studentt", "truncated_t"):
            raise ValueError(f"Unsupported likelihood function '{dp.likelihood_fn}'")
        if dp.use_base:
            base_str = node.get("base", f"base_{suffix}")
            if base_str in varset.names:
                dp.base_ix = varset.index_of(base_str)
            else:
                dp.fixed_base = float(base_str)
        if dp.use_scale:
            dp.scale_ix = varset.index_of(f"scale_{suffix}")
        sd_str = node.get("sd", f"sd_{suffix}")
        if sd_str in varset.names:
            dp.sd_ix = varset.index_of(sd_str)
        else:
            dp.fixed_sd = float(sd_str)
        expr = node.get("expression", "")
        if expr:
            dp.expression_ix = self.network.molecule_ix_by_name(expr)
        return dp

    # ------------------------------------------------------------------

    def _const(self, key, array, like: torch.Tensor) -> torch.Tensor:
        """A host array on like's device and dtype, copied there once."""
        k = (key, like.dtype, like.device)
        if k not in self._tensors:
            self._tensors[k] = torch.as_tensor(np.asarray(array), dtype=like.dtype,
                                               device=like.device)
        return self._tensors[k]

    def _prepare(self, tv: torch.Tensor):
        """(preset, expression), each (B or 1, P, n), for the rows tv (B, V)
        (reference: fISAExperiment PrepareActivitiesCalculation): preset NaN
        where the molecule is computed, drugs at concentration 0 unless a
        condition sets them."""
        n = self.network.num_molecules
        P = len(self.cell_lines)
        rows = tv.shape[0] if any(c.parameter_ix is not None for c in self.conditions) else 1
        preset = tv.new_full((rows, P, n), float("nan"))
        for i, m in enumerate(self.network.molecules):
            if m.mtype == TYPE_DRUG:
                preset[..., i] = 0.0
        for k, c in enumerate(self.conditions):
            if c.parameter_ix is not None:
                preset[..., c.model_ix] = tv[:, c.parameter_ix, None]
            else:
                preset[..., c.model_ix] = self._const(("condition", k), c.values, tv)

        rows = tv.shape[0] if any(el.base_ix is not None for el in self.expression_levels) else 1
        expression = tv.new_ones((rows, P, n))
        for k, el in enumerate(self.expression_levels):
            v = self._const(("expression", k), el.values, tv)
            if el.base_ix is not None and el.scale_ix is not None:
                e = (v - tv[:, el.base_ix, None]) / tv[:, el.scale_ix, None]
            elif el.base_ix is not None:
                e = (v - tv[:, el.base_ix, None]) / (1.0 - tv[:, el.base_ix, None])
            else:
                e = v
            expression[..., el.model_ix] = torch.clamp(e, 0.0, 1.0)
        return preset, expression

    def log_prob(self, tv: torch.Tensor) -> torch.Tensor:
        """Experiment logp (B,) of transformed rows tv (B, V)."""
        logp, _ = self.log_prob_and_activities(tv, {})
        return logp

    def _data_logp(self, acts, expression, tv):
        """Data log-probability of each lane's activities (reference:
        fISAExperimentSingleCondition.cpp EvaluateCellLine, :195-409).
        Lanes (B, P, M): acts (..., n), expression (..., n) and tv (..., V)
        broadcast over them; the cell line is the lanes' second axis."""
        logp = None
        for k, d in enumerate(self.data_parts):
            z = acts[..., d.model_ix]
            if d.data_is_inactive_form:
                z = self.network.max_expression(d.model_ix, expression, tv) - z
            if d.expression_ix is not None:
                z = z * expression[..., d.expression_ix]
            if d.use_scale and d.scale_ix is not None:
                z = z * tv[..., d.scale_ix]
            if d.use_base:
                z = z + (tv[..., d.base_ix] if d.base_ix is not None else d.fixed_base)
            if d.sd_ix is not None:
                sd = tv[..., d.sd_ix]
            else:
                sd = self._const(("sd", k), d.fixed_sd, tv)
            if d.scale_var_with_mean:
                sd = sd * torch.abs(z)
            # (P, 1, R): each cell line's replicates against its lanes
            obs = self._const(("data", k), d.data.T[:, None, :], tv)
            z, sd = z[..., None], sd[..., None] if sd.dim() else sd
            if d.likelihood_fn == "normal":
                pw = logpdf_normal(obs, z, sd)
            elif d.likelihood_fn == "truncated_normal":
                pw = logpdf_truncated_normal(obs, z, sd, 0.0, 1.0)
            elif d.likelihood_fn == "truncated_t":
                pw = logpdf_truncated_t(obs, torch.clamp(z, max=1.0), sd,
                                        self._const("nu", 3.0, tv), 0.0, 1.0)
            else:  # studentt (nu = 3, reference LogPdfTnu3)
                pw = logpdf_t(obs, z, sd, self._const("nu", 3.0, tv))
            part = d.weight * torch.sum(torch.where(torch.isnan(obs), 0.0, pw), dim=-1)
            logp = part if logp is None else logp + part
        if logp is None:
            return acts.new_zeros(acts.shape[:-1])
        return logp

    def log_prob_and_activities(self, tv: torch.Tensor, stored):
        """(logp (B,), best-root activities (B, P, n)) of rows tv (B, V).

        Every (row, cell line, Sobol start) is a lane; each solve is scored
        and the best root per (row, cell line) is kept, its logp the cell
        line's and its activities this experiment's stored ones (reference:
        fISAExperimentSingleCondition.cpp:184-230,412-425)."""
        preset, expression = self._prepare(tv)
        values = tv[:, None, :]
        acts_m = self.network.calculate_multiroot(values, expression, preset)  # (B, P, M, n)
        logps_m = self._data_logp(acts_m, expression[:, :, None, :], tv[:, None, None, :])
        logps_m = logps_m.expand(acts_m.shape[:-1])
        best = first_max_index(logps_m)  # (B, P)
        lp = torch.gather(logps_m, -1, best[..., None])[..., 0]
        n = acts_m.shape[-1]
        acts = torch.gather(acts_m, -2, best[..., None, None].expand(*best.shape, 1, n))[..., 0, :]
        return lp.sum(dim=-1), acts

    def newton_residual(self, tv: torch.Tensor) -> torch.Tensor:
        """(B,) the largest Newton residual of the rows' kept solves
        (`SignalingNetwork.newton_residual`)."""
        _, expression = self._prepare(tv)
        _, acts = self.log_prob_and_activities(tv, {})
        return self.network.newton_residual(tv[:, None, :], expression, acts).amax(dim=-1)

    # -- model accessors (reference: bcmrbridge interface_fISA.cpp:40-192) --
    # tv: one row (V,) or a batch (B, V) of transformed values

    def observed_data(self, data_ix: int) -> np.ndarray:
        """(n_replicates, n_cell_lines) observed matrix of one data part."""
        return np.asarray(self.data_parts[data_ix].data)

    def modeled_activities(self, tv) -> torch.Tensor:
        """(P, n) steady-state activities of one row, (B, P, n) of a batch."""
        tv = torch.as_tensor(tv)
        _, acts = self.log_prob_and_activities(tv.reshape(-1, tv.shape[-1]), {})
        return acts if tv.dim() > 1 else acts[0]

    def modeled_data(self, tv, data_ix: int) -> torch.Tensor:
        """(P,) modeled values of one data part after the base, scale and
        inactive-form adjustments, (B, P) for a batch."""
        tv = torch.as_tensor(tv)
        rows = tv.reshape(-1, tv.shape[-1])
        _, acts = self.log_prob_and_activities(rows, {})
        d = self.data_parts[data_ix]
        z = acts[..., d.model_ix]
        _, expression = self._prepare(rows)
        cols = rows[:, None, :]
        if d.data_is_inactive_form:
            z = self.network.max_expression(d.model_ix, expression, cols) - z
        if d.expression_ix is not None:
            z = z * expression[..., d.expression_ix]
        if d.use_scale and d.scale_ix is not None:
            z = z * cols[..., d.scale_ix]
        if d.use_base:
            z = z + (cols[..., d.base_ix] if d.base_ix is not None else d.fixed_base)
        return z if tv.dim() > 1 else z[0]


class FISAExperimentIncucyteSequential(FISAExperiment):
    """Drug-response experiment over a concentration range (reference:
    fISAExperimentIncucyteSequential.cpp:24-341): every (row, cell line,
    concentration) a lane, solved from the fixed 0.5 start with the drug
    preset to the concentration, each (cell line, concentration) pair
    scored by a 3-component bivariate t mixture; pairs whose second
    component mean is NaN are skipped (:312); `type="relative"` takes the
    proliferation relative to an earlier single-condition experiment's
    stored one (:279-282)."""

    def _parse_type_specific(self, node, g):
        dr = node.find("drug_range")
        if dr is None:
            raise ValueError("incucyte_sequential experiment requires a <drug_range> node")
        self.drug_species_name = dr.get("species_name")
        self.drug_model_ix = self.network.molecule_ix_by_name(self.drug_species_name)
        conc = dr.get("concentrations", "")
        if conc:
            self.drug_concentrations = np.asarray(
                [float(x) for x in conc.replace(",", ";").split(";") if x], dtype=np.float64)
        else:
            self.drug_concentrations = np.asarray(g[dr.get("concentrations_data_name")],
                                                  dtype=np.float64)
        self.prolif_ix = self.network.molecule_ix_by_name("proliferation")
        self.apop_ix = self.network.molecule_ix_by_name("apoptosis")
        self.relative_reference: Optional[str] = None
        self._relative_exp: Optional[FISAExperiment] = None

    def _parse_data_node(self, cnode, g, P):
        """The per-(cell line, concentration) bivariate t mixture table
        (reference ParseDataNode:204-228; its 9 rows a cell line generalized
        to the number of concentrations, as in the JAX package)."""
        path = cnode.get("data_file_base")
        if not os.path.isabs(path):
            path = os.path.join(self.base_dir, path)
        table = np.genfromtxt(path, delimiter="\t", dtype=np.float64)
        if table.ndim == 1:
            table = table[None, :]
        C = len(self.drug_concentrations)
        K = 3
        self.mup = np.full((P, C, K), np.nan)
        self.mua = np.full((P, C, K), np.nan)
        self.invcov = np.zeros((P, C, K, 2, 2))
        self.logncweight = np.full((P, C, K), -np.inf)
        for i in range(P):
            for ci in range(C):
                row = table[i * C + ci]
                for ki in range(K):
                    self.mup[i, ci, ki] = row[ki * 5 + 0]
                    self.mua[i, ci, ki] = row[ki * 5 + 1]
                    cov = np.array([[row[ki * 5 + 2], row[ki * 5 + 3]],
                                    [row[ki * 5 + 3], row[ki * 5 + 4]]])
                    w = row[5 * K + ki]
                    det = cov[0, 0] * cov[1, 1] - cov[0, 1] * cov[1, 0]
                    if w > 0 and np.isfinite(det) and det > 0:
                        self.invcov[i, ci, ki] = np.linalg.inv(cov)
                        self.logncweight[i, ci, ki] = np.log(w) - np.log(2 * np.pi * np.sqrt(det))
        self.pair_valid = ~(np.isnan(self.mup[:, :, 1]) | np.isnan(self.mua[:, :, 1]))
        # NaN means and weight-0 components never enter the computation
        self.comp_valid = (np.isfinite(self.mup) & np.isfinite(self.mua)
                           & np.isfinite(self.logncweight))
        self.mup_safe = np.where(self.comp_valid, self.mup, 0.0)
        self.mua_safe = np.where(self.comp_valid, self.mua, 0.0)
        if cnode.get("type", "") == "relative":
            self.relative_reference = cnode.get("relative_reference")

    def _solve(self, tv, concs):
        """Activities (B, P, C, n) of rows tv (B, V) with the drug preset to
        each of concs (C,)."""
        preset, expression = self._prepare(tv)
        C = concs.shape[0]
        preset = preset[:, :, None, :].repeat(1, 1, C, 1)
        preset[..., self.drug_model_ix] = concs
        return self.network.calculate(tv[:, None, None, :], expression[:, :, None, :], preset)

    def log_prob_and_activities(self, tv: torch.Tensor, stored):
        ref_prolif = None
        if self.relative_reference is not None:
            if self.relative_reference in stored:
                ref_acts = stored[self.relative_reference]
            else:
                # a standalone call: the reference experiment's activities anew
                if self._relative_exp is None:
                    raise ValueError(
                        f"Relative experiment '{self.relative_reference}' has not been "
                        "resolved; it must be defined before this one and be single-condition")
                _, ref_acts = self._relative_exp.log_prob_and_activities(tv, {})
            ref_prolif = ref_acts[..., self.prolif_ix]

        acts = self._solve(tv, self._const("concentrations", self.drug_concentrations, tv))
        prolif = acts[..., self.prolif_ix]  # (B, P, C)
        apop = acts[..., self.apop_ix]
        if ref_prolif is not None:
            prolif = prolif - ref_prolif[..., None]

        valid = self._const("comp_valid", self.comp_valid, tv).bool()
        tx = prolif[..., None] - self._const("mup_safe", self.mup_safe, tv)  # (B, P, C, K)
        ta = apop[..., None] - self._const("mua_safe", self.mua_safe, tv)
        iv = self._const("invcov", self.invcov, tv)
        q = (iv[..., 0, 0] * tx * tx + iv[..., 1, 1] * ta * ta
             + (iv[..., 0, 1] + iv[..., 1, 0]) * tx * ta)
        # bivariate t (nu = 3): lognc_k - (nu + 2) / 2 log1p(q / nu)
        lognc = torch.where(valid, self._const("logncweight", self.logncweight, tv), 0.0)
        kp = torch.where(valid, lognc - 2.5 * torch.log1p(q / 3.0), -torch.inf)
        pair_lp = torch.logsumexp(kp, dim=-1)  # (B, P, C)
        pair_valid = self._const("pair_valid", self.pair_valid, tv).bool()
        logp = torch.where(pair_valid, pair_lp, 0.0).sum(dim=(-2, -1))
        # stored activities: the lowest concentration's solve (reference
        # GetModeledActivities:87-93)
        return logp, acts[:, :, 0, :]

    def newton_residual(self, tv: torch.Tensor) -> torch.Tensor:
        _, expression = self._prepare(tv)
        acts = self._solve(tv, self._const("concentrations", self.drug_concentrations, tv))
        return self.network.newton_residual(tv[:, None, None, :], expression[:, :, None, :],
                                            acts).amax(dim=(-2, -1))

    # -- model accessors (reference interface & GetObserved/ModeledData) --

    def observed_data(self, data_ix: int) -> np.ndarray:
        """(n_cell_lines, 1): the first component's mean of proliferation
        (even data_ix) or apoptosis (odd) at concentration data_ix // 2
        (reference GetObservedData:61-72)."""
        src = self.mup if data_ix % 2 == 0 else self.mua
        return src[:, data_ix // 2, 0][:, None]

    def modeled_data(self, tv, data_ix: int) -> torch.Tensor:
        tv = torch.as_tensor(tv)
        rows = tv.reshape(-1, tv.shape[-1])
        dci = data_ix // 2
        mix = self.prolif_ix if data_ix % 2 == 0 else self.apop_ix
        concs = self._const("concentrations", self.drug_concentrations, rows)[dci:dci + 1]
        z = self._solve(rows, concs)[:, :, 0, mix]
        return z if tv.dim() > 1 else z[0]


class FISALikelihood:
    """Sum over experiments (reference: fISALikelihood.cpp:87-106)."""

    def __init__(self, experiments: List[FISAExperiment], varset: VariableSet):
        self.experiments = experiments
        self.varset = varset
        self._transforms = np.asarray(varset.transforms)
        self._transform_codes = {}

    def _transform(self, values: torch.Tensor) -> torch.Tensor:
        # the codes are copied to a device once: an evaluation reads nothing
        # from the host
        t = self._transform_codes.get(values.device)
        if t is None:
            t = self._transform_codes[values.device] = torch.as_tensor(self._transforms,
                                                                       device=values.device)
        x = values
        x = torch.where(t == TRANSFORM_LOG, torch.exp(values), x)
        x = torch.where(t == TRANSFORM_LOG10, torch.pow(10.0, values), x)
        x = torch.where(t == TRANSFORM_LOGIT, 1.0 / (1.0 + torch.exp(-values)), x)
        return x

    def log_prob_batched(self, values: torch.Tensor) -> torch.Tensor:
        """Log-likelihood (B,) of rows of untransformed values (B, D)."""
        tv = self._transform(values)
        logp = None
        stored = {}
        for exp in self.experiments:
            lp, acts = exp.log_prob_and_activities(tv, stored)
            stored[exp.name] = acts
            logp = lp if logp is None else logp + lp
        return torch.where(torch.isnan(logp), -torch.inf, logp)


    def newton_residual(self, values: torch.Tensor) -> torch.Tensor:
        """(B,) the largest Newton residual of the solves each row's
        log-density kept, over the experiments: above ~1e-12 where a
        solve stopped short of its root after the fixed 20 steps."""
        tv = self._transform(values)
        return torch.stack([exp.newton_residual(tv) for exp in self.experiments]).amax(dim=0)


def create_fisa_likelihood(varset: VariableSet, attrs) -> FISALikelihood:
    """Factory entry (reference: LikelihoodFactory.cpp 'fISA'). Besides the
    XML, attrs may hold `_data` (experiment name -> data group mapping)."""
    root = attrs.get("_xml_root")
    if root is None:
        raise ValueError("fISA likelihood requires an XML definition")
    xml_path = attrs.get("_xml_path")
    base_dir = os.path.dirname(xml_path) if xml_path else "."
    data = attrs.get("_data")
    experiment_types = {
        "single_condition": FISAExperiment,
        "incucyte_sequential": FISAExperimentIncucyteSequential,
    }
    experiments = []
    for node in root.findall("experiment"):
        etype = node.get("type", "single_condition")
        if etype not in experiment_types:
            # drug_range is dead code upstream (#if TODO)
            raise ValueError(f"Unknown experiment type '{etype}'")
        group = None if data is None else data[node.get("name")]
        experiments.append(experiment_types[etype](node, varset, base_dir, group))
    # relative references resolve to an earlier single-condition experiment
    # (reference: fISAExperimentIncucyteSequential::ParseDataNode:231-254)
    by_name: dict = {}
    for exp in experiments:
        ref = getattr(exp, "relative_reference", None)
        if ref is not None:
            target = by_name.get(ref)
            if target is None or isinstance(target, FISAExperimentIncucyteSequential):
                raise ValueError(
                    f"Experiment '{exp.name}' is relative to '{ref}', which must be an "
                    "earlier-defined single-condition experiment")
            exp._relative_exp = target
        by_name[exp.name] = exp
    if not experiments:
        raise ValueError("fISA likelihood requires at least one experiment")
    return FISALikelihood(experiments, varset)
