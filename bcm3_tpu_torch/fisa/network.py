"""fISA steady-state signaling network, solved lanes first.

Counterpart of bcm3_tpu/fisa/network.py (reference:
src/fISA/SignalingNetwork.cpp). A CellDesigner SBML influence graph
(POSITIVE/NEGATIVE_INFLUENCE reactions, one reactant -> one product) is
compiled on the host into a fixed structure whose strongly connected
components are ordered topologically (scipy); singleton components are
closed form and feedback components run 20 damped Newton steps from
Sobol starts (`multiroot_solves` of them, constants made at load time).

Here an evaluation is lanes first: `values (..., V)`, `expression (...,
n)` and `preset (..., n)` broadcast against each other, and every
operation acts on all lanes at once (a lane is one row x cell line x
start, or row x cell line x concentration). The molecules and components
are looped over in Python, as the JAX package loops over them at trace
time. The Newton Jacobian is forward mode by hand: the component's d
activities carry d tangent directions through the activation input, the
signal inhibition, the drug signal and the activation limit (all
elementwise), in place of `jax.jacfwd`. The small solve is the JAX
package's no-pivot LU of `J + 1e-10 I` (`torch.linalg.solve` above 16),
so both packages round alike and pick the same roots. The trip count is
fixed and nothing is read to the host inside a solve.

Semantics preserved (the JAX module's docstring lists them with the
reference's lines): linear and logistic activation inputs with drug
inhibition factors, the minmax and fixed-k logistic activation limits,
expression and expression mixing, the four drug effects with optional
dose-response, and the parameter naming.
"""

from __future__ import annotations

import math
import warnings
import xml.etree.ElementTree as ET
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

FIXED_K = 9.19024  # reference: SignalingNetwork.cpp:17-24
NEWTON_STEPS = 20  # reference: SolveSystem MAX_NEWTON_ITERATIONS
NEWTON_RIDGE = 1e-10
DAMPING_LIMIT = 0.4  # steps with any |delta| above it are halved
_LN10 = math.log(10.0)

TYPE_PROTEIN = "Protein"
TYPE_MRNA = "mRNA"
TYPE_SMALL_MOLECULE = "SmallMolecule"
TYPE_MUTATION = "Mutation"
TYPE_COMPLETE_LOSS = "CompleteLossMutation"
TYPE_DRUG = "Drug"
TYPE_PHENOTYPE = "Phenotype"
TYPE_UNKNOWN = "Unknown"
TYPE_TRANSPORTER = "DrugTransporter"

_CLASS_MAP = {
    "PROTEIN": TYPE_PROTEIN,
    "RNA": TYPE_MRNA,
    "SIMPLE_MOLECULE": TYPE_SMALL_MOLECULE,
    "GENE": TYPE_MUTATION,
    "DRUG": TYPE_DRUG,
    "PHENOTYPE": TYPE_PHENOTYPE,
    "UNKNOWN": TYPE_UNKNOWN,
}

DRUG_INHIBIT_ACTIVITY = "inhibit activity"
DRUG_INHIBIT_ACTIVITY_ALTER = "inhibit activity,alter susceptibility"
DRUG_ALTER_SUSCEPTIBILITY = "alter susceptibility"
DRUG_INHIBIT_ACTIVATION = "inhibit activation"
DRUG_ACTIVATE = "activate"


def _local(tag):
    return tag.rsplit("}", 1)[-1]


@dataclass
class Molecule:
    id: str
    name: str
    mtype: str
    drug_type: str = ""
    parents: List[int] = field(default_factory=list)
    activating: List[bool] = field(default_factory=list)
    # resolved parameter indices (None -> absent)
    base_ix: Optional[int] = None
    strength_ix: List[Optional[int]] = field(default_factory=list)
    inflection_ix: List[Optional[int]] = field(default_factory=list)
    steepness_ix: List[Optional[int]] = field(default_factory=list)
    susceptibility_ix: List[Optional[int]] = field(default_factory=list)
    expression_mixing_ix: Optional[int] = None


# ---------------------------------------------------------------------------
# Forward-mode numbers: a value over the lanes and its tangents in the d
# directions of a feedback component (None: no dependence on it). Each
# value operation is the JAX package's, so the values round alike.


class Dual:
    __slots__ = ("v", "t")

    def __init__(self, v, t=None):
        self.v = v
        self.t = t

    def __add__(self, o):
        o = _lift(o)
        return Dual(self.v + o.v, _tadd(self.t, o.t))

    __radd__ = __add__

    def __sub__(self, o):
        o = _lift(o)
        return Dual(self.v - o.v, _tadd(self.t, None if o.t is None else -o.t))

    def __rsub__(self, o):
        return _lift(o) - self

    def __neg__(self):
        return Dual(-self.v, None if self.t is None else -self.t)

    def __mul__(self, o):
        o = _lift(o)
        return Dual(self.v * o.v, _tadd(_tscale(self.t, o.v), _tscale(o.t, self.v)))

    __rmul__ = __mul__

    def __truediv__(self, o):
        # the tangent as JAX's div rule forms it: g / y - (g' x) / (y y);
        # 1 / y as a reciprocal, which rounds as the division does
        o = _lift(o)
        one = isinstance(self.v, float) and self.v == 1.0
        t = None if self.t is None else self.t / _col(o.v)
        if o.t is not None:
            minus = -o.t if one else -o.t * _col(self.v)
            t = _tadd(t, minus * _col(torch.reciprocal(o.v * o.v)))
        return Dual(torch.reciprocal(o.v) if one else self.v / o.v, t)

    def __rtruediv__(self, o):
        return _lift(o) / self


def _lift(x):
    return x if isinstance(x, Dual) else Dual(x)


def _col(v):
    """A lane value as a column against tangents (..., d)."""
    return v[..., None] if isinstance(v, torch.Tensor) else v


def _tscale(t, v):
    return None if t is None else t * _col(v)


def _tadd(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return a + b


def _exp(x: Dual) -> Dual:
    v = torch.exp(x.v)
    return Dual(v, _tscale(x.t, v))


def _pow10(x: Dual) -> Dual:
    v = torch.pow(10.0, x.v)
    return Dual(v, _tscale(x.t, _LN10 * v))


# small constants on a device, made once: torch.where with a Python number
# would make (and fill) a device scalar at every call. The tensors are never
# written to, so one cache serves every network.
_CONSTANTS: Dict[tuple, torch.Tensor] = {}


def _constant(value, like: torch.Tensor) -> torch.Tensor:
    """A 0-d tensor of `value` (a number) or torch.eye(value[1]) (for
    value = ("eye", d)) on like's device and dtype."""
    key = (value, like.dtype, like.device)
    t = _CONSTANTS.get(key)
    if t is None:
        if isinstance(value, tuple):
            t = torch.eye(value[1], dtype=like.dtype, device=like.device)
        else:
            t = torch.full((), value, dtype=like.dtype, device=like.device)
        t = _CONSTANTS[key] = t
    return t


def _where(cond, a, b) -> Dual:
    """torch.where over duals; cond a lane tensor."""
    a, b = _lift(a), _lift(b)
    like = b.v if isinstance(b.v, torch.Tensor) else a.v
    av = a.v if isinstance(a.v, torch.Tensor) else _constant(a.v, like)
    bv = b.v if isinstance(b.v, torch.Tensor) else _constant(b.v, like)
    v = torch.where(cond, av, bv)
    if a.t is None and b.t is None:
        return Dual(v)
    zero = _constant(0.0, like)
    ta = a.t if a.t is not None else zero
    tb = b.t if b.t is not None else zero
    return Dual(v, torch.where(cond[..., None], ta, tb))


def logistic_activation_fixed(x: Dual) -> Dual:
    """1 above 3.5, else the fixed-k logistic around 0.5."""
    y = 1.0 / (1.0 + _exp(-FIXED_K * (x - 0.5)))
    return _where(x.v > 3.5, 1.0, y)


def logistic_activation(x: Dual, steepness, inflection) -> Dual:
    return 1.0 / (1.0 + _exp(-_lift(steepness) * (x - inflection)))


def _clip01(x: Dual) -> Dual:
    """The minmax limit; it never sees a tangent (feedback needs the
    logistic limit)."""
    return Dual(torch.clamp(x.v, 0.0, 1.0))


def _log10_floor(act: Dual) -> Dual:
    """log10(max(act, 1e-300)) as jnp.log10 forms it, log(x) / log(10); in
    float32 the floor rounds to 0 and the callers' act == 0 masks keep the
    result finite, as in the JAX package."""
    floored = torch.clamp(act.v, min=1e-300)
    v = torch.log(floored) / _LN10
    if act.t is None:
        return Dual(v)
    above = act.v > 1e-300
    return Dual(v, torch.where(above[..., None], act.t / _col(floored) / _LN10,
                               _constant(0.0, v)))


def _unrolled_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x of A x = b over lanes, A (..., d, d), b (..., d): the JAX package's
    unrolled no-pivot LU (its `_unrolled_solve`), entry by entry as it
    writes it, every operation over all lanes; `torch.linalg.solve` above
    16."""
    n = b.shape[-1]
    if n > 16:
        return torch.linalg.solve(A, b)
    a = [[A[..., i, j] for j in range(n)] for i in range(n)]
    x = [b[..., i] for i in range(n)]
    for k in range(n):
        inv = torch.reciprocal(a[k][k])
        for j in range(k + 1, n):
            a[k][j] = a[k][j] * inv
        x[k] = x[k] * inv
        for i in range(k + 1, n):
            f = a[i][k]
            for j in range(k + 1, n):
                a[i][j] = a[i][j] - f * a[k][j]
            x[i] = x[i] - f * x[k]
    for k in range(n - 1, -1, -1):
        for i in range(k):
            x[i] = x[i] - a[i][k] * x[k]
    return torch.stack(x, dim=-1)


class SignalingNetwork:
    def __init__(
        self,
        molecules: List[Molecule],
        activation_limit: str,
        multiroot_solves: int = 10,
    ):
        if activation_limit not in ("minmax", "logistic"):
            raise ValueError(
                f"Invalid activation limit '{activation_limit}' (supported: minmax, logistic)"
            )
        self.molecules = molecules
        self.activation_limit = activation_limit
        self.multiroot_solves = int(multiroot_solves)
        self.name_to_ix = {m.name: i for i, m in enumerate(molecules)}
        self.id_to_ix = {m.id: i for i, m in enumerate(molecules)}
        self._order = self._scc_order()
        self.has_feedback = any(len(c) > 1 for c in self._order)
        if self.has_feedback and activation_limit != "logistic":
            # reference: SignalingNetwork.cpp:524-527
            raise ValueError(
                "System contains feedback loop, but the activation limit is not logistic"
            )
        # the reference seeds one d-dimensional Sobol sequence per feedback
        # component on every Calculate (SignalingNetwork.cpp:599-625), so the
        # starts are constants
        self._multiroot_starts: List[Optional[np.ndarray]] = []
        for comp in self._order:
            if len(comp) > 1:
                from scipy.stats import qmc

                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    starts = qmc.Sobol(d=len(comp), scramble=False).random(
                        self.multiroot_solves)
                self._multiroot_starts.append(np.asarray(starts, dtype=np.float64))
            else:
                self._multiroot_starts.append(None)
        self._tensors: Dict[tuple, tuple] = {}

    # ------------------------------------------------------------------
    # Loading (copied from the JAX package)

    @classmethod
    def from_sbml(cls, filename: str, varset, activation_limit="minmax",
                  multiroot_solves: int = 10):
        root = ET.parse(filename).getroot()
        model = next(c for c in root if _local(c.tag) == "model")

        def first(node, name):
            for c in node:
                if _local(c.tag) == name:
                    return c
            return None

        molecules: List[Molecule] = []
        id_map: Dict[str, int] = {}
        los = first(model, "listOfSpecies")
        for sp in los if los is not None else []:
            m = Molecule(id=sp.get("id"), name=sp.get("name", sp.get("id")), mtype=TYPE_UNKNOWN)
            for el in sp.iter():
                if _local(el.tag) == "class" and el.text:
                    cname = el.text.strip()
                    if cname not in _CLASS_MAP:
                        raise ValueError(f"Unrecognized species type {cname} for {m.id}")
                    m.mtype = _CLASS_MAP[cname]
            notes = ""
            nnode = first(sp, "notes")
            if nnode is not None:
                notes = " ".join(t.strip() for t in nnode.itertext()).strip()
            if m.mtype == TYPE_DRUG:
                if notes not in (DRUG_INHIBIT_ACTIVITY, DRUG_INHIBIT_ACTIVITY_ALTER,
                                 DRUG_ALTER_SUSCEPTIBILITY, DRUG_INHIBIT_ACTIVATION,
                                 DRUG_ACTIVATE):
                    raise ValueError(
                        f"Drug '{m.name}' needs a note specifying its inhibition type")
                m.drug_type = notes
            elif m.mtype == TYPE_PROTEIN and notes == "drug_transporter":
                m.mtype = TYPE_TRANSPORTER
            elif m.mtype == TYPE_MUTATION and notes == "complete_loss":
                m.mtype = TYPE_COMPLETE_LOSS
            id_map[m.id] = len(molecules)
            molecules.append(m)

        lor = first(model, "listOfReactions")
        for re_el in lor if lor is not None else []:
            activating = True
            for el in re_el.iter():
                if _local(el.tag) == "reactionType" and el.text:
                    rt = el.text.strip()
                    if rt == "POSITIVE_INFLUENCE":
                        activating = True
                    elif rt == "NEGATIVE_INFLUENCE":
                        activating = False
                    else:
                        raise ValueError(f"Unrecognized reaction type {rt}")
            reactants = [r.get("species") for lst in re_el
                         if _local(lst.tag) == "listOfReactants"
                         for r in lst if _local(r.tag) == "speciesReference"]
            products = [r.get("species") for lst in re_el
                        if _local(lst.tag) == "listOfProducts"
                        for r in lst if _local(r.tag) == "speciesReference"]
            if len(reactants) != 1 or len(products) != 1:
                raise ValueError("fISA reactions must have exactly 1 reactant and 1 product")
            parent = id_map[reactants[0]]
            child = id_map[products[0]]
            molecules[child].parents.append(parent)
            molecules[child].activating.append(activating)

        net = cls(molecules, activation_limit, multiroot_solves)
        net._resolve_parameters(varset)
        return net

    def _resolve_parameters(self, varset):
        def ix(name):
            return varset.index_of(name) if name in varset.names else None

        for m in self.molecules:
            m.base_ix = ix(f"base_{m.name}")
            m.expression_mixing_ix = ix(f"expression_mixing[{m.name}]")
            for p in m.parents:
                pname = self.molecules[p].name
                if self.molecules[p].mtype == TYPE_DRUG:
                    m.strength_ix.append(ix(f"maxinhib_{pname}_{m.name}"))
                    m.inflection_ix.append(ix(f"ic50_{pname}_{m.name}"))
                    m.steepness_ix.append(ix(f"logsteepness_{pname}_{m.name}"))
                else:
                    s = ix(f"strength_{pname}_{m.name}")
                    if s is None and self.molecules[p].mtype != TYPE_TRANSPORTER:
                        raise ValueError(f"Missing variable strength_{pname}_{m.name}")
                    m.strength_ix.append(s)
                    m.inflection_ix.append(ix(f"inflection_{pname}_{m.name}"))
                    m.steepness_ix.append(ix(f"steepness_{pname}_{m.name}"))
                m.susceptibility_ix.append(ix(f"{pname}_{m.name}_susceptibility"))

    # ------------------------------------------------------------------
    # Structure

    def _scc_order(self):
        """Topologically ordered strongly connected components (reference:
        ConstructGraph + boost::strong_components)."""
        from scipy.sparse import csr_matrix
        from scipy.sparse.csgraph import connected_components

        n = len(self.molecules)
        rows, cols = [], []
        for i, m in enumerate(self.molecules):
            for p in m.parents:
                rows.append(p)
                cols.append(i)
        graph = csr_matrix((np.ones(len(rows)), (rows, cols)), shape=(n, n))
        n_comp, labels = connected_components(graph, directed=True, connection="strong")
        comp_members = [[] for _ in range(n_comp)]
        for i, lab in enumerate(labels):
            comp_members[lab].append(i)
        comp_edges = set()
        for i, m in enumerate(self.molecules):
            for p in m.parents:
                if labels[p] != labels[i]:
                    comp_edges.add((labels[p], labels[i]))
        indeg = {c: 0 for c in range(n_comp)}
        for a, b in comp_edges:
            indeg[b] += 1
        q = deque(c for c in range(n_comp) if indeg[c] == 0)
        order = []
        while q:
            c = q.popleft()
            order.append(c)
            for a, b in comp_edges:
                if a == c:
                    indeg[b] -= 1
                    if indeg[b] == 0:
                        q.append(b)
        return [comp_members[c] for c in order]

    @property
    def num_molecules(self):
        return len(self.molecules)

    def molecule_ix_by_name(self, name):
        return self.name_to_ix[name]

    # ------------------------------------------------------------------
    # Evaluation: activities and values are lists of lane columns (Duals
    # for the activities)

    def _drug_signal(self, m: Molecule, j: int, acts, values) -> Dual:
        """Dose-response signal of drug parent j of molecule m (reference:
        Precalculate:738-780)."""
        act = acts[m.parents[j]]
        maxinhib = values[m.strength_ix[j]] if m.strength_ix[j] is not None else 1.0
        if m.inflection_ix[j] is None:
            resp = act * maxinhib
            sig = resp if m.activating[j] else 1.0 - resp
        else:
            ic50 = values[m.inflection_ix[j]]
            steep = torch.pow(10.0, values[m.steepness_ix[j]])
            logc = _log10_floor(act)
            resp = maxinhib - maxinhib / (_pow10(steep * (logc - ic50)) + 1.0)
            sig = resp if m.activating[j] else 1.0 - resp
        return _where(act.v == 0.0, 0.0 if m.activating[j] else 1.0, sig)

    def _signal_inhibition(self, i: int, j: int, acts, values):
        """u_a: drug attenuation of the signal from parent j to i (reference:
        CalculateSignalInhibition:787-822); None when nothing attenuates it."""
        m = self.molecules[i]
        parent = self.molecules[m.parents[j]]
        inhibition = None
        for k, pp in enumerate(parent.parents):
            ppm = self.molecules[pp]
            if (ppm.mtype == TYPE_DRUG
                    and ppm.drug_type in (DRUG_INHIBIT_ACTIVITY, DRUG_INHIBIT_ACTIVITY_ALTER)
                    and not parent.activating[k]):
                sig = self._drug_signal(parent, k, acts, values)
                f = _where(acts[pp].v > 0, sig, 1.0)
                inhibition = f if inhibition is None else inhibition * f
        for k, pp in enumerate(m.parents):
            ppm = self.molecules[pp]
            if (ppm.mtype == TYPE_DRUG
                    and ppm.drug_type in (DRUG_ALTER_SUSCEPTIBILITY, DRUG_INHIBIT_ACTIVITY_ALTER)
                    and m.susceptibility_ix[k] is not None):
                f = _where(acts[pp].v > 0, values[m.susceptibility_ix[k]], 1.0)
                inhibition = f if inhibition is None else inhibition * f
        return inhibition

    def _activation_input(self, i: int, acts, values, like):
        """(total, inhibition or None) (reference:
        CalculateActivationInput:839-905); `like` is a lane tensor whose
        dtype and device a constant total takes."""
        m = self.molecules[i]
        if m.base_ix is not None:
            total = Dual(values[m.base_ix])
        else:
            # 0 + x is x: a total without base starts at its first signal
            total = Dual(torch.full_like(like, 1.0)) if not m.parents else None
        inhibition = None
        loss = None
        for j, p in enumerate(m.parents):
            pm = self.molecules[p]
            if pm.mtype == TYPE_DRUG:
                sig = self._drug_signal(m, j, acts, values)
                if m.activating[j]:
                    total = sig if total is None else total + sig
                elif pm.drug_type == DRUG_INHIBIT_ACTIVATION or m.name == "proliferation":
                    inhibition = sig if inhibition is None else inhibition * sig
                # inhibit-activity drugs act on downstream signals only
            elif pm.mtype == TYPE_COMPLETE_LOSS:
                lost = acts[p].v > 0
                loss = lost if loss is None else loss | lost
            elif pm.mtype == TYPE_TRANSPORTER:
                continue
            else:
                strength = values[m.strength_ix[j]]
                sig = Dual(strength if m.activating[j] else -strength)
                u = self._signal_inhibition(i, j, acts, values)
                if u is not None:
                    sig = sig * u
                if m.inflection_ix[j] is not None:
                    sig = sig * logistic_activation(acts[p], values[m.steepness_ix[j]],
                                                    values[m.inflection_ix[j]])
                else:
                    sig = sig * acts[p]
                total = sig if total is None else total + sig
        if total is None:
            total = Dual(torch.zeros_like(like))
        if loss is not None:
            total = _where(loss, 0.0, total)
        return total, inhibition

    def _molecule_activity(self, i: int, acts, expression, values) -> Dual:
        m = self.molecules[i]
        total, inhibition = self._activation_input(i, acts, values, expression[i])
        if self.activation_limit == "minmax":
            act = _clip01(total)
        else:
            act = logistic_activation_fixed(total)
        if inhibition is not None:
            act = act * inhibition
        e = expression[i]
        if m.expression_mixing_ix is not None:
            em = values[m.expression_mixing_ix]
            return (em * e + (1.0 - em)) * act
        return e * act

    def _component_outputs(self, comp, acts, expression, values):
        """(out (..., d), dout/dsub (..., d, d)) of a feedback component at
        the activities `acts`, whose members carry the unit tangents."""
        outs = [self._molecule_activity(i, acts, expression, values) for i in comp]
        d = len(comp)
        shape = torch.broadcast_shapes(*(o.v.shape for o in outs))
        out = torch.stack([o.v.expand(shape) for o in outs], dim=-1)
        zero = _constant(0.0, out).expand(shape + (d,))
        T = torch.stack([zero if o.t is None else o.t.expand(shape + (d,)) for o in outs],
                        dim=-2)
        return out, T

    def newton_system(self, ci, sub, acts, expression, values):
        """(residual (..., d), Jacobian (..., d, d)) of feedback component
        ci at `sub`: sub - out and I - dout/dsub (the JAX package's
        `residual` and `jax.jacfwd(residual)`)."""
        comp = self._order[ci]
        eye = _constant(("eye", len(comp)), sub)
        acts = list(acts)
        for k, i in enumerate(comp):
            acts[i] = Dual(sub[..., k], eye[k])
        out, T = self._component_outputs(comp, acts, expression, values)
        return sub - out, eye - T

    def _calculate_impl(self, values, expression, preset, starts):
        """SCC-ordered solve; `starts` aligned with self._order: None for a
        singleton, a (..., d) start for a feedback component (reference:
        Calculate:541-597 and its multiroot overload :599-697)."""
        vals = [values[..., k] for k in range(values.shape[-1])]
        expr = [expression[..., k] for k in range(expression.shape[-1])]
        acts = [Dual(preset[..., k]) for k in range(preset.shape[-1])]
        for ci, comp in enumerate(self._order):
            if len(comp) == 1:
                i = comp[0]
                m = self.molecules[i]
                if m.mtype == TYPE_TRANSPORTER:
                    new = expr[i]
                else:
                    new = self._molecule_activity(i, acts, expr, vals).v
                acts[i] = Dual(torch.where(torch.isnan(acts[i].v), new, acts[i].v))
                continue
            # feedback component: damped Newton with a fixed trip count
            # (reference: SolveSystem:913-1048; steps with any |delta| > 0.4
            # are halved, :1000-1006)
            ridge = NEWTON_RIDGE * _constant(("eye", len(comp)), values)
            sub = starts[ci]
            for _ in range(NEWTON_STEPS):
                r, J = self.newton_system(ci, sub, acts, expr, vals)
                delta = _unrolled_solve(J + ridge, r)
                big = delta.abs().amax(dim=-1, keepdim=True) > DAMPING_LIMIT
                delta = torch.where(big, 0.5 * delta, delta)
                sub = torch.clamp(sub - delta, 0.0, 1.0)
            for k, i in enumerate(comp):
                acts[i] = Dual(sub[..., k])
        shape = torch.broadcast_shapes(*(a.v.shape for a in acts))
        return torch.stack([a.v.expand(shape) for a in acts], dim=-1)

    def newton_residual(self, values, expression, activities):
        """max |sub - out| over the feedback components at `activities`
        (..., n): about 1e-16 where the 20 Newton steps converged; larger on
        lanes near a fold, where the fixed trip count stops short and one
        ulp of an input moves the iterate (lanes without feedback: 0)."""
        vals = [values[..., k] for k in range(values.shape[-1])]
        expr = [expression[..., k] for k in range(expression.shape[-1])]
        acts = [Dual(activities[..., k]) for k in range(activities.shape[-1])]
        worst = torch.zeros_like(activities[..., 0])
        for ci, comp in enumerate(self._order):
            if len(comp) > 1:
                r, _ = self.newton_system(ci, activities[..., comp], acts, expr, vals)
                worst = torch.maximum(worst, r.abs().amax(dim=-1))
        return worst

    def _starts(self, dtype, device):
        """The Sobol starts of each feedback component as (M, d) tensors."""
        key = (dtype, device)
        if key not in self._tensors:
            self._tensors[key] = tuple(
                None if s is None else torch.as_tensor(s, dtype=dtype, device=device)
                for s in self._multiroot_starts)
        return self._tensors[key]

    def calculate(self, values, expression, preset):
        """Steady-state activities (..., n), one solve from the fixed 0.5
        start (the reference's single-vector Calculate,
        SignalingNetwork.cpp:541-597; the incucyte-sequential experiment's).
        values (..., V), expression (..., n), preset (..., n) with NaN for
        the molecules to compute; they broadcast against each other."""
        lane = torch.broadcast_shapes(values.shape[:-1], expression.shape[:-1],
                                      preset.shape[:-1])
        starts = [None if len(c) == 1 else values.new_full(lane + (len(c),), 0.5)
                  for c in self._order]
        return self._calculate_impl(values, expression, preset, starts)

    def calculate_multiroot(self, values, expression, preset):
        """All multiroot solves (..., M, n): each feedback component solved
        from `multiroot_solves` Sobol starts, a lane each (reference:
        SignalingNetwork.cpp:599-697). Without feedback all solves
        coincide, and one is returned: (..., 1, n)."""
        values, expression, preset = (t[..., None, :] for t in (values, expression, preset))
        if not self.has_feedback:
            return self.calculate(values, expression, preset)
        lane = torch.broadcast_shapes(values.shape[:-1], expression.shape[:-1],
                                      preset.shape[:-1])
        M = self.multiroot_solves
        starts = [None if s is None else s.expand(lane[:-1] + (M, s.shape[-1]))
                  for s in self._starts(values.dtype, values.device)]
        return self._calculate_impl(values, expression, preset, starts)

    def max_expression(self, i, expression, values):
        """reference: max_expression_function:36-40 (lane columns)."""
        m = self.molecules[i]
        e = expression[..., i]
        if m.expression_mixing_ix is not None:
            em = values[..., m.expression_mixing_ix]
            return em * e + (1.0 - em)
        return e
