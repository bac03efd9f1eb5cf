"""Carry sampler state across from the JAX package.

The JAX package's `PTState` and `BlockProposal` are pytrees of arrays; given
as mappings of field name -> numpy array (e.g.
``{f: np.asarray(getattr(state, f)) for f in STATE_FIELDS}``), these
functions build the port's objects on a chosen device and dtype. One
mutate/exchange step can then start from identical state in both packages.
A JAX `ClusterAssigner` carries across the same way, so that both packages
assign clusters with the same fit. The port keeps no PRNG key in its state (its randomness is the sampler's
`torch.Generator`), so the JAX state's `key` is not read. The port's own
checkpoints (io/checkpoint.py) rebuild their objects with the same
functions. The Incucyte likelihood's experiments carry across the same
way (`incucyte_experiment_from_arrays`), so that both packages score the
same data, and so does a cell-population simulator's configuration
(`population_config_from_arrays`), so that both simulate the same
population, and a fISA signaling network (`fisa_network_from_fields`), so
that both solve the same structure from the same starts.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Mapping

import numpy as np
import torch

from bcm3_tpu_torch.sampler.proposal import BlockProposal
from bcm3_tpu_torch.sampler.pt import PTState
from bcm3_tpu_torch.sampler.spectral import ARRAY_FIELDS as ASSIGNER_FIELDS
from bcm3_tpu_torch.sampler.spectral import ClusterAssigner

if TYPE_CHECKING:
    from bcm3_tpu_torch.cellpop.simulate import PopulationConfig
    from bcm3_tpu_torch.fisa.network import SignalingNetwork
    from bcm3_tpu_torch.likelihoods.cellmisc import IncucyteExperiment

STATE_FIELDS = (
    "x", "lprior", "llh", "att_mut", "acc_mut", "att_exc", "acc_exc",
    "history", "hist_adds", "swap_parity",
)
PROPOSAL_FIELDS = (
    "means", "chols", "inv_chols", "log_weights", "log_c", "scales",
    "acc_ema", "selected",
)
PROPOSAL_META = ("t_dof", "target_accept", "update_rule", "symmetric", "clustered")
ASSIGNER_META = ("nn", "nn2")


def _tensor(a, dtype, device):
    """A copy of a (possibly read-only) array as a tensor."""
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def pt_state_from_arrays(
    arrays: Mapping[str, np.ndarray], device, dtype: torch.dtype
) -> PTState:
    """A PTState from the JAX package's state fields as numpy arrays."""

    def real(name):
        return _tensor(arrays[name], dtype, device)

    def count(name):
        return _tensor(arrays[name], torch.int32, device)

    return PTState(
        x=real("x"),
        lprior=real("lprior"),
        llh=real("llh"),
        att_mut=count("att_mut"),
        acc_mut=count("acc_mut"),
        att_exc=count("att_exc"),
        acc_exc=count("acc_exc"),
        history=_tensor(arrays["history"], torch.float32, device),
        hist_adds=int(arrays["hist_adds"]),
        swap_parity=int(arrays["swap_parity"]),
    )


def block_proposal_from_arrays(
    arrays: Mapping[str, np.ndarray],
    meta: Mapping[str, object],
    device,
    dtype: torch.dtype,
) -> BlockProposal:
    """A BlockProposal from the JAX package's proposal fields as numpy
    arrays, in its shared (L, K, ...) mixture layout, plus its static
    fields (`PROPOSAL_META`)."""
    return BlockProposal(
        **{f: _tensor(arrays[f], dtype, device) for f in PROPOSAL_FIELDS[:-1]},
        selected=_tensor(arrays["selected"], torch.long, device),
        t_dof=float(meta["t_dof"]),
        target_accept=float(meta["target_accept"]),
        update_rule=int(meta["update_rule"]),
        symmetric=bool(meta["symmetric"]),
        clustered=bool(meta.get("clustered", False)),
    )


def cluster_assigner_from_arrays(
    arrays: Mapping[str, np.ndarray], meta: Mapping[str, int], device
) -> ClusterAssigner:
    """The port's ClusterAssigner (float64 tensors on `device`) from a JAX
    package ClusterAssigner's fields (`ASSIGNER_FIELDS`) as numpy arrays
    and its `ASSIGNER_META` (nn, nn2)."""
    return ClusterAssigner(
        **{f: _tensor(arrays[f], torch.float64, device) for f in ASSIGNER_FIELDS},
        nn=int(meta["nn"]),
        nn2=int(meta["nn2"]),
    )


def incucyte_experiment_from_arrays(arrays: Mapping[str, object]) -> IncucyteExperiment:
    """An IncucyteExperiment from the JAX package's experiment fields (e.g.
    ``dataclasses.asdict(e)``): arrays as float64 numpy, the treatment
    time and seeding density as floats, the index as an int. The cell
    likelihoods are imported here, not with this module, which the
    checkpoint loader imports."""
    from bcm3_tpu_torch.likelihoods.cellmisc import IncucyteExperiment

    scalars = {"treatment_time": float, "seeding_density": float, "experiment_ix": int}
    return IncucyteExperiment(**{
        f.name: scalars[f.name](arrays[f.name]) if f.name in scalars
        else np.array(arrays[f.name], dtype=np.float64)
        for f in dataclasses.fields(IncucyteExperiment)
    })


def population_config_from_arrays(fields: Mapping[str, object]) -> PopulationConfig:
    """The port's PopulationConfig from a JAX package PopulationConfig's
    fields (e.g. ``{f.name: getattr(cfg, f) for f in dataclasses.fields(cfg)}``):
    numbers and strings as they are, the event species and division
    resets as plain ints and floats, and its SparseStageSolver rebuilt
    from the solver's `jac_pattern` (an (n, n) bool array). The cell
    simulator is imported here, as above."""
    from bcm3_tpu_torch.cellpop.simulate import PopulationConfig
    from bcm3_tpu_torch.ode.sparse_lu import SparseStageSolver

    kw = {}
    for f in dataclasses.fields(PopulationConfig):
        v = fields[f.name]
        if f.name == "event_species":
            v = {str(k): int(i) for k, i in dict(v).items()}
        elif f.name == "division_reset_idx":
            v = tuple((int(i), float(x)) for i, x in v)
        elif f.name == "sparse" and v is not None:
            v = SparseStageSolver(np.asarray(getattr(v, "jac_pattern", v), dtype=bool))
        kw[f.name] = v
    return PopulationConfig(**kw)


def fisa_network_from_fields(fields: Mapping[str, object]) -> SignalingNetwork:
    """The port's SignalingNetwork from a JAX package network's fields as
    plain Python and numpy: `molecules` (one mapping of Molecule fields
    each, e.g. ``dataclasses.asdict(m)``, with the resolved parameter
    indices), `_order` (the SCC order, lists of molecule indices),
    `_multiroot_starts` (an (M, d) array a feedback component, None a
    singleton), `activation_limit` and `multiroot_solves`. The network is
    imported here, as above."""
    from bcm3_tpu_torch.fisa.network import Molecule, SignalingNetwork

    def plain(v):
        if isinstance(v, (list, tuple)):
            return [plain(x) for x in v]
        if v is None or isinstance(v, (bool, str)):
            return v
        return int(v)

    molecules = [
        Molecule(**{f.name: (str(m[f.name]) if f.type == "str" else plain(m[f.name]))
                    for f in dataclasses.fields(Molecule)})
        for m in fields["molecules"]
    ]
    net = SignalingNetwork(molecules, str(fields["activation_limit"]),
                           int(fields["multiroot_solves"]))
    net._order = [[int(i) for i in comp] for comp in fields["_order"]]
    net.has_feedback = any(len(c) > 1 for c in net._order)
    net._multiroot_starts = [None if s is None else np.array(s, dtype=np.float64)
                             for s in fields["_multiroot_starts"]]
    return net
