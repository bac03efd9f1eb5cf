"""SBML model: species classification and the lanes-first right-hand side.

Counterpart of bcm3_tpu/sbml/model.py (reference: src/sbml/SBMLModel.cpp):

- species split into ODE-integrated vs constant: a species that is
  neither a reactant nor a product in any reaction is constant
  (SBMLModel.cpp:93-126); CellDesigner "DEGRADED" (sink) species are
  excluded entirely (:95-96);
- dy/dt = stoichiometry-weighted sum of reaction rate laws
  (SBMLModel.cpp GenerateCode:282-345), as the JAX package's unrolled
  multiply-adds, lanes first;
- assignment rules computed on top of the integrated state
  (SBMLModel.cpp CalculateAssignments:726-733);
- the structural Jacobian pattern (host numpy, a copy).

The Jacobian the reference generates symbolically (GenerateJacobianCode)
and the JAX package takes with `jax.jacfwd` comes with the right-hand side
from `make_rhs_jacobian`: forward-mode tangents compiled into the rate
laws.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from bcm3_tpu_torch.sbml.parser import SBMLDocument, parse_sbml_file, parse_sbml_string
from bcm3_tpu_torch.sbml.ratelaws import RatelawCompiler, _dual


def _lanes(v, like: torch.Tensor, width=None) -> torch.Tensor:
    """A rate law's value as a tensor of like's lanes (and `width` columns),
    dtype and device."""
    shape = like.shape[:-1] + (() if width is None else (width,))
    if isinstance(v, torch.Tensor):
        return v.to(like.dtype).expand(shape)
    return like.new_full(shape, float(v))


class SBMLModel:
    """Parsed model with derived index structure and RHS factory."""

    def __init__(self, doc: SBMLDocument):
        self.doc = doc

        # simulated species = everything except sinks (reference: :93-97)
        self.simulated_species: List[str] = [
            sid for sid in doc.species_order if doc.species[sid].sbml_type != "Sink"
        ]
        in_reaction = set()
        for rid in doc.reaction_order:
            r = doc.reactions[rid]
            for sid, _ in r.reactants:
                in_reaction.add(sid)
            for sid, _ in r.products:
                in_reaction.add(sid)
        self.ode_species: List[str] = [s for s in self.simulated_species if s in in_reaction]
        self.constant_species: List[str] = [
            s for s in self.simulated_species if s not in in_reaction
        ]
        self.species_index = {s: i for i, s in enumerate(self.ode_species)}
        self.constant_species_index = {s: i for i, s in enumerate(self.constant_species)}
        self.sim_index = {s: i for i, s in enumerate(self.simulated_species)}
        self.ode_to_sim = np.array([self.sim_index[s] for s in self.ode_species], dtype=np.int64)
        self.constant_to_sim = np.array(
            [self.sim_index[s] for s in self.constant_species], dtype=np.int64
        )

    # ------------------------------------------------------------------
    # Introspection mirroring the reference accessors

    @property
    def num_ode_species(self) -> int:
        return len(self.ode_species)

    @property
    def num_constant_species(self) -> int:
        return len(self.constant_species)

    @property
    def num_simulated_species(self) -> int:
        return len(self.simulated_species)

    def species_full_name(self, sid: str) -> str:
        return self.doc.species[sid].full_name

    def simulated_species_full_names(self) -> List[str]:
        return [self.species_full_name(s) for s in self.simulated_species]

    def ode_species_by_full_name(self, full_name: str) -> int:
        for i, s in enumerate(self.ode_species):
            if self.species_full_name(s) == full_name:
                return i
        raise KeyError(f"No ODE species with full name '{full_name}'")

    def constant_species_by_full_name(self, full_name: str) -> int:
        for i, s in enumerate(self.constant_species):
            if self.species_full_name(s) == full_name:
                return i
        raise KeyError(f"No constant species with full name '{full_name}'")

    def get_parameter_names(self) -> List[str]:
        """All parameter names referenced anywhere in the rate laws
        (reference: SBMLModel::GetParameters)."""
        names = set()

        def walk(ast):
            if ast[0] == "name":
                names.add(ast[1])
            elif ast[0] == "call":
                for a in ast[2]:
                    walk(a)
            elif ast[0] not in ("const",):
                for a in ast[1]:
                    walk(a)

        for rid in self.doc.reaction_order:
            ast = self.doc.reactions[rid].rate_ast
            if ast is not None:
                walk(ast)
        for rule in self.doc.assignment_rules:
            walk(rule.ast)
        species_ids = set(self.doc.species_order)
        return sorted(n for n in names if n not in species_ids and n != "__time__")

    def initial_ode_values(self) -> np.ndarray:
        return np.array([self.doc.species[s].initial_value for s in self.ode_species])

    def initial_constant_values(self) -> np.ndarray:
        return np.array([self.doc.species[s].initial_value for s in self.constant_species])

    # ------------------------------------------------------------------
    # RHS construction

    def _compiler(self, parameter_names, non_sampled_names, fixed_values) -> RatelawCompiler:
        return RatelawCompiler(
            self.doc,
            self.species_index,
            {n: i for i, n in enumerate(parameter_names)},
            self.constant_species_index,
            {n: i for i, n in enumerate(non_sampled_names)},
            fixed_values,
        )

    def make_rhs(
        self,
        parameter_names: Sequence[str],
        non_sampled_names: Sequence[str] = (),
        fixed_values: Optional[Dict[str, float]] = None,
    ) -> Callable:
        """Build ``f(t (L,), y (L, n), constant_y (L, nc), params (L, P),
        nsp) -> dy/dt (L, n)``.

        ``parameter_names[i]`` maps to ``params[..., i]``; likewise for
        non-sampled parameters. Fixed values take priority
        (reference: SBMLRatelaws.cpp:158-165)."""
        rhs_jac = self.make_rhs_jacobian(parameter_names, non_sampled_names, fixed_values)
        return lambda t, y, constant_y, params, nsp: rhs_jac(t, y, constant_y, params, nsp,
                                                            derivatives=False)

    def make_rhs_jacobian(
        self,
        parameter_names: Sequence[str],
        non_sampled_names: Sequence[str] = (),
        fixed_values: Optional[Dict[str, float]] = None,
    ) -> Callable:
        """Build ``g(t, y, constant_y, params, nsp) -> (dy/dt (L, n), its
        derivative in t (L, n), its Jacobian in y (L, n, n))``, the
        derivatives by forward mode through the rate laws (what the JAX
        package's stiff solver takes with `jax.jacfwd`; reference:
        SBMLModel.cpp GenerateJacobianCode). With ``derivatives=False`` it
        returns dy/dt alone.

        The reactions whose laws differ only in their leaves (parameters,
        species, numbers) are evaluated together, one column a reaction
        (`RatelawCompiler.template`), each column in the law's own order of
        operations; each species' derivative then adds its reactions'
        rates one by one with their stoichiometry, the JAX package's
        unrolled form, as a few gathers over all species at once (a first
        term taken as it is where the JAX package adds it to a zero; a
        species with fewer terms adds exact zeros)."""
        compiler = self._compiler(parameter_names, non_sampled_names, fixed_values)
        n = len(self.ode_species)
        R = len(self.doc.reaction_order)
        groups: Dict = {}
        for j, rid in enumerate(self.doc.reaction_order):
            ast = self.doc.reactions[rid].rate_ast
            key, tmpl, leaves = compiler.template(ast if ast is not None else ("const", 0.0))
            groups.setdefault(key, (tmpl, []))[1].append((j, leaves))
        order, fns = [], []
        for tmpl, members in groups.values():
            order.extend(j for j, _ in members)
            fns.append((compiler.compile_group(tmpl, [lv for _, lv in members]), len(members)))
        position = {j: k for k, j in enumerate(order)}  # the rate's column; R: a zero

        # stoichiometry: each species' (reaction, coefficient) terms
        S = np.zeros((n, R))
        for j, rid in enumerate(self.doc.reaction_order):
            r = self.doc.reactions[rid]
            for sid, st in r.products:
                if sid in self.species_index:
                    S[self.species_index[sid], j] += st
            for sid, st in r.reactants:
                if sid in self.species_index:
                    S[self.species_index[sid], j] -= st
        terms = [[(position[j], float(S[i, j])) for j in range(R) if S[i, j] != 0.0]
                 for i in range(n)]
        slots = []  # the k-th term of every species: (columns, coefficients or None)
        for k in range(max(1, max(len(t) for t in terms))):
            cols = [t[k][0] if k < len(t) else R for t in terms]
            coefs = [t[k][1] if k < len(t) else 1.0 for t in terms]
            slots.append((cols, None if all(c == 1.0 for c in coefs) else coefs))
        cache: Dict = {}

        def on(like, key, make):
            k = (key, like.dtype, str(like.device))
            if k not in cache:
                cache[k] = make()
            return cache[k]

        def rhs_jac(t, y, constant_y, params, nsp, derivatives=True):
            L, K = y.shape[:-1], n + 1
            E = on(y, "eye", lambda: torch.eye(K, dtype=y.dtype, device=y.device)) \
                if derivatives else None
            values, tangents = [], []
            for fn, width in fns:
                r = _dual(fn(t, y, constant_y, params, nsp, E))
                values.append(_lanes(r.v, y, width))
                if derivatives:
                    tangents.append(y.new_zeros(L + (width, K)) if r.d is None
                                    else r.d.expand(L + (width, K)))
            rates = torch.cat(values + [y.new_zeros(L + (1,))], dim=-1)
            if derivatives:
                drates = torch.cat(tangents + [y.new_zeros(L + (1, K))], dim=-2)
            f = D = None
            for k, (cols, coefs) in enumerate(slots):
                ix = on(y, ("cols", k), lambda: torch.tensor(cols, device=y.device))
                term = rates.index_select(-1, ix)
                if coefs is not None:
                    c = on(y, ("coefs", k), lambda: torch.tensor(coefs, dtype=y.dtype,
                                                                 device=y.device))
                    term = term * c
                f = term if f is None else f + term
                if derivatives:
                    dterm = drates.index_select(-2, ix)
                    if coefs is not None:
                        dterm = dterm * c[:, None]
                    D = dterm if D is None else D + dterm
            if not derivatives:
                return f
            return f, D[..., 0], D[..., 1:]

        return rhs_jac

    def jacobian_sparsity(self) -> np.ndarray:
        """Structural Jacobian pattern (n_ode, n_ode) bool: J[i, j] can
        be nonzero iff some reaction changing species i has species j in
        its rate law (a superset of the numerical pattern for every
        parameter value; reference: src/sbml/SBMLModel.h:28-30). User
        function bodies are walked conservatively."""
        n = len(self.ode_species)
        P = np.zeros((n, n), dtype=bool)

        def species_deps(ast, out, seen_fns):
            kind = ast[0]
            if kind == "const":
                return
            if kind == "name":
                if ast[1] in self.species_index:
                    out.add(self.species_index[ast[1]])
                return
            if kind == "call":
                for a in ast[2]:
                    species_deps(a, out, seen_fns)
                fdef = self.doc.functions.get(ast[1])
                if fdef is not None and ast[1] not in seen_fns:
                    species_deps(fdef.body, out, seen_fns | {ast[1]})
                return
            for a in ast[1]:
                species_deps(a, out, seen_fns)

        for rid in self.doc.reaction_order:
            r = self.doc.reactions[rid]
            if r.rate_ast is None:
                continue
            deps: set = set()
            species_deps(r.rate_ast, deps, frozenset())
            rows = {
                self.species_index[sid]
                for sid, _ in list(r.products) + list(r.reactants)
                if sid in self.species_index
            }
            for i in rows:
                for j in deps:
                    P[i, j] = True
        return P

    def make_assignments(
        self,
        parameter_names: Sequence[str],
        non_sampled_names: Sequence[str] = (),
        fixed_values: Optional[Dict[str, float]] = None,
    ) -> Callable:
        """Build ``g(t, y (L, n), constant_y (L, nc), params, nsp) -> (L,
        n_simulated)``: the full simulated-species vector with assignment
        rules applied (reference: SBMLModel.cpp CalculateAssignments:726-733)."""
        compiler = self._compiler(parameter_names, non_sampled_names, fixed_values)
        rules = [
            (self.sim_index[r.target], compiler.compile(r.ast))
            for r in self.doc.assignment_rules
            if r.target in self.sim_index
        ]
        ode_to_sim, constant_to_sim = list(self.ode_to_sim), list(self.constant_to_sim)
        n_sim = self.num_simulated_species

        def assignments(t, y, constant_y, params, nsp):
            cols = [torch.zeros_like(y[..., 0])] * n_sim
            for k, s in enumerate(ode_to_sim):
                cols[s] = y[..., k]
            if constant_y is not None and self.num_constant_species:
                for k, s in enumerate(constant_to_sim):
                    cols[s] = constant_y[..., k].to(y.dtype).expand(y.shape[:-1])
            for tgt, f in rules:
                cols[tgt] = _lanes(f(t, y, constant_y, params, nsp), y)
            return torch.stack(cols, dim=-1)

        return assignments

    @classmethod
    def from_file(cls, filename: str) -> "SBMLModel":
        return cls(parse_sbml_file(filename))

    @classmethod
    def from_string(cls, text: str) -> "SBMLModel":
        return cls(parse_sbml_string(text))
