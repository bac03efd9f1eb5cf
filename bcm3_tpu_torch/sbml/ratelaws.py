"""Rate-law AST -> torch function compiler, lanes first, with forward-mode tangents.

Counterpart of bcm3_tpu/sbml/ratelaws.py (reference: src/sbml/SBMLRatelaws.cpp:
the Evaluate virtuals interpret the AST per CVODE step; GenerateEquation
emits C++ source). Here the AST is compiled once into closures over torch
tensors: a compiled rate law is ``f(t (L,), y (L, n), constant_y (L, nc),
params (L, P), nsp) -> (L,)``, one value per lane, evaluated in the JAX
package's order of arithmetic. A constant subexpression stays a Python
float, as it stays a weakly typed scalar there.

Given the unit rows E (K, K) of K directions (time, then the n species),
the same closures carry beside each value its derivatives (a `Dual`):
forward-mode differentiation by the chain rule at every node, the
derivatives the JAX package takes with `jax.jacfwd`, without an autodiff
transform at run time (a dual node is a few tensor operations more than
its value, where `torch.func` would dispatch each through its
transforms). A derivative that is structurally zero is not computed
(None). `template` and `compile_group` evaluate the laws that differ only
in their leaves together, one column a law.

Special functions, matching the reference exactly (SBMLRatelaws.cpp:6-77):
- hill(x, k, n) = x^n / (k^n + x^n)
- mm(kcat, KM, e, s): 0 if e <= 0; kcat*e*s/KM if s < 0;
  kcat*e*s/(KM+s) otherwise
- synthcap(x) = 0 if x < 0 else 1 - x^8
- tQSSA(k, km, e, s) = 0.5*k*(E - sqrt(E^2 - 4*e*s)), E = e+km+s
- pow is "safepow": 0 for negative base (SBMLRatelaws.cpp:40-47)
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch

from bcm3_tpu_torch.sbml.parser import SBMLDocument


def _tensors(*xs):
    """xs with the Python numbers made tensors: in the dtype and device of
    the first tensor among them, or float64 on the CPU where none is."""
    ref = next((x for x in xs if isinstance(x, torch.Tensor)), None)
    kw = dict(dtype=torch.float64) if ref is None else dict(dtype=ref.dtype, device=ref.device)
    return tuple(x if isinstance(x, torch.Tensor) else torch.tensor(float(x), **kw) for x in xs)


def _lanewise(s):
    """s as a factor of a tangent (..., K): a lane's value on its own row."""
    return s[..., None] if isinstance(s, torch.Tensor) and s.dim() > 0 else s


def _plus(a, b):
    return a if b is None else b if a is None else a + b


def _times(d, s):
    return None if d is None else d * _lanewise(s)


class Dual:
    """A value (a float, or a tensor of lanes) and its derivatives d along
    K directions: None (zero), or a tensor (K,) or (lanes, K)."""

    __slots__ = ("v", "d")

    def __init__(self, v, d=None):
        self.v, self.d = v, d

    def __add__(self, o):
        o = _dual(o)
        return Dual(self.v + o.v, _plus(self.d, o.d))

    def __radd__(self, o):
        return _dual(o) + self

    def __sub__(self, o):
        o = _dual(o)
        return Dual(self.v - o.v, _plus(self.d, None if o.d is None else -o.d))

    def __rsub__(self, o):
        return _dual(o) - self

    def __mul__(self, o):
        o = _dual(o)
        return Dual(self.v * o.v, _plus(_times(self.d, o.v), _times(o.d, self.v)))

    def __rmul__(self, o):
        return _dual(o) * self

    def __truediv__(self, o):
        o = _dual(o)
        v = self.v / o.v
        if o.d is None:
            return Dual(v, None if self.d is None else self.d / _lanewise(o.v))
        # (a / b)' = (a' - (a / b) b') / b
        num = _plus(self.d, -_times(o.d, v))
        return Dual(v, num / _lanewise(o.v))

    def __rtruediv__(self, o):
        return _dual(o) / self

    def __neg__(self):
        return Dual(-self.v, None if self.d is None else -self.d)


def _dual(x):
    return x if isinstance(x, Dual) else Dual(x)


def _values(*xs):
    """The arguments of a special function as tensors (plain) or as Duals
    with tensor values, whichever they came as."""
    if not any(isinstance(x, Dual) for x in xs):
        return _tensors(*xs), False
    vals = _tensors(*(_dual(x).v for x in xs))
    return tuple(Dual(v, _dual(x).d) for v, x in zip(vals, xs)), True


def _where(cond, a, b):
    if not isinstance(a, Dual) and not isinstance(b, Dual):
        return torch.where(cond, a, b)
    a, b = _dual(a), _dual(b)
    v = torch.where(cond, a.v, b.v)
    if a.d is None and b.d is None:
        return Dual(v)
    like = v[..., None] * 0.0 if a.d is None or b.d is None else 0.0
    da = like if a.d is None else a.d
    db = like if b.d is None else b.d
    return Dual(v, torch.where(cond[..., None], da, db))


def _pow(x, n):
    """x ** n with its derivative n x^(n-1) x' + log(x) x^n n'."""
    if not isinstance(x, Dual):
        return torch.pow(x, n)
    v = torch.pow(x.v, n.v)
    d = None
    if x.d is not None:
        d = _times(x.d, n.v * torch.pow(x.v, n.v - 1.0))
    if n.d is not None:
        d = _plus(d, _times(n.d, v * torch.log(x.v)))
    return Dual(v, d)


def _unary(fn, deriv):
    """fn of a value or a Dual; deriv(x, fn(x)) is fn's derivative."""

    def apply(a):
        (a,), dual = _values(a)
        if not dual:
            return fn(a)
        v = fn(a.v)
        return Dual(v, _times(a.d, deriv(a.v, v)))

    return apply


_UNARY = {
    "exp": _unary(torch.exp, lambda x, v: v),
    "ln": _unary(torch.log, lambda x, v: 1.0 / x),
    "log10": _unary(torch.log10, lambda x, v: 1.0 / (x * math.log(10.0))),
    "sqrt": _unary(torch.sqrt, lambda x, v: 0.5 / v),
}
_sqrt = _UNARY["sqrt"]


def _value(x):
    return x.v if isinstance(x, Dual) else x


def hill(x, k, n):
    (x, k, n), _ = _values(x, k, n)
    xn = _pow(x, n)
    kn = _pow(k, n)
    return xn / (kn + xn)


def michaelis_menten(kcat, km, e, s):
    (kcat, km, e, s), _ = _values(kcat, km, e, s)
    pos = kcat * e * s / (km + s)
    neg = kcat * e * s / km
    val = _where(_value(s) < 0, neg, pos)
    return _where(_value(e) <= 0, 0.0, val)


def synthcap(x):
    (x,), _ = _values(x)
    x2 = x * x
    x8 = (x2 * x2) * (x2 * x2)
    return _where(_value(x) < 0, 0.0, 1.0 - x8)


def tqssa(k, km, e, s):
    (k, km, e, s), _ = _values(k, km, e, s)
    ekms = e + km + s
    return 0.5 * k * (ekms - _sqrt(ekms * ekms - 4.0 * e * s))


def safepow(x, n):
    # reference zeroes negative bases to avoid NaNs from fractional powers
    (x, n), dual = _values(x, n)
    neg = _value(x) < 0
    if not dual:
        return torch.where(neg, 0.0, torch.pow(torch.clamp(x, min=0.0), n))
    base = Dual(torch.clamp(x.v, min=0.0), x.d)
    return _where(neg, 0.0, _pow(base, n))


class RatelawCompiler:
    """Compile ASTs with the reference's name-resolution priority
    (reference: SBMLRatelaws.cpp AST_NAME:152-221): fixed parameter
    values > inference parameters > ODE species > constant species >
    non-sampled parameters > SBML document parameter values. A name
    reads column ix of its lanes-first tensor (``y[..., ix]``)."""

    def __init__(
        self,
        doc: SBMLDocument,
        species_index: Dict[str, int],
        parameter_index: Dict[str, int],
        constant_species_index: Dict[str, int],
        non_sampled_index: Dict[str, int],
        fixed_values: Optional[Dict[str, float]] = None,
    ):
        self.doc = doc
        self.species_index = species_index
        self.parameter_index = parameter_index
        self.constant_species_index = constant_species_index
        self.non_sampled_index = non_sampled_index
        self.fixed_values = fixed_values or {}

    def compile(self, ast) -> Callable:
        """AST -> f(t, y, constant_y, params, nsp) returning one value a
        lane (or a Python float for a constant law)."""
        g = self._build(ast, {})
        return lambda t, y, c, p, n: _value(g(t, y, c, p, n, None))

    _SPECIAL = ("hill", "mm", "synthcap", "tQSSA", "pow")

    def template(self, ast):
        """The law with its user functions inlined and every leaf (a number,
        the time, a parameter, a species, a constant species, a non-sampled
        parameter) a slot: (key, template, leaves). Laws with the same key
        differ only in their leaves, so `compile_group` evaluates them
        together. The template is an AST whose leaf slots are the names
        "__leaf{i}"; leaves[i] is (kind, index or value), kind one of "t",
        "k" (a number), "p", "y", "c", "n"."""
        leaves = []

        def leaf(kind, value):
            leaves.append((kind, value))
            return ("name", f"__leaf{len(leaves) - 1}"), ("leaf", kind)

        def walk(a, bound):
            kind = a[0]
            if kind == "const":
                return leaf("k", float(a[1]))
            if kind == "name":
                name = a[1]
                if name in bound:
                    return walk(*bound[name])
                if name == "__time__":
                    return leaf("t", 0)
                for k, table in (("k", self.fixed_values), ("p", self.parameter_index),
                                 ("y", self.species_index), ("c", self.constant_species_index),
                                 ("n", self.non_sampled_index), ("k", self.doc.parameters)):
                    if name in table:
                        return leaf(k, float(table[name]) if k == "k" else table[name])
                raise ValueError(f"Name '{name}' does not map to a species or parameter")
            if kind == "call":
                fname, args = a[1], a[2]
                if fname not in self._SPECIAL and fname in self.doc.functions:
                    fdef = self.doc.functions[fname]
                    if len(args) != len(fdef.arg_names):
                        raise ValueError(f"Function {fname} expects {len(fdef.arg_names)} args")
                    inner = dict(bound)
                    inner.update({nm: (x, bound) for nm, x in zip(fdef.arg_names, args)})
                    return walk(fdef.body, inner)
                parts = [walk(x, bound) for x in args]
                return (("call", fname, tuple(t for t, _ in parts)),
                        ("call", fname, tuple(k for _, k in parts)))
            parts = [walk(x, bound) for x in a[1]]
            return (kind, tuple(t for t, _ in parts)), (kind, tuple(k for _, k in parts))

        tmpl, key = walk(ast, {})
        return key, tmpl, leaves

    def compile_group(self, tmpl, leaves_of) -> Callable:
        """`template`'s template of several laws (leaves_of: each law's
        leaves) -> g(t, y, constant_y, params, nsp, E) giving every law's
        value at once, one column a law ((lanes, laws), or a shape that
        broadcasts to it; a Dual with E). Each column takes its law's
        operations in `compile`'s order."""
        bound = {}
        for i, column in enumerate(zip(*leaves_of)):
            kind, values = column[0][0], [v for _, v in column]
            bound[f"__leaf{i}"] = _leaf_reader(kind, values)
        return self._build(tmpl, bound)

    def _build(self, ast, bound: Dict[str, Callable]):
        kind = ast[0]
        if kind == "const":
            v = ast[1]
            return lambda t, y, c, p, n, E: v
        if kind == "name":
            return self._resolve_name(ast[1], bound)
        if kind == "call":
            return self._build_call(ast[1], ast[2], bound)
        args = [self._build(a, bound) for a in ast[1]]
        if kind == "+":
            return lambda t, y, c, p, n, E: sum(
                (a(t, y, c, p, n, E) for a in args[1:]), args[0](t, y, c, p, n, E)
            )
        if kind == "*":
            def times(t, y, c, p, n, E):
                out = args[0](t, y, c, p, n, E)
                for a in args[1:]:
                    out = out * a(t, y, c, p, n, E)
                return out

            return times
        if kind == "-":
            a, b = args
            return lambda t, y, c, p, n, E: a(t, y, c, p, n, E) - b(t, y, c, p, n, E)
        if kind == "neg":
            (a,) = args
            return lambda t, y, c, p, n, E: -a(t, y, c, p, n, E)
        if kind == "/":
            a, b = args
            return lambda t, y, c, p, n, E: a(t, y, c, p, n, E) / b(t, y, c, p, n, E)
        if kind == "pow":
            a, b = args
            return lambda t, y, c, p, n, E: safepow(a(t, y, c, p, n, E), b(t, y, c, p, n, E))
        if kind in _UNARY:
            (a,) = args
            fn = _UNARY[kind]
            return lambda t, y, c, p, n, E: fn(a(t, y, c, p, n, E))
        raise ValueError(f"Unsupported AST node '{kind}'")

    def _resolve_name(self, name: str, bound: Dict[str, Callable]):
        if name in bound:
            return bound[name]
        if name == "__time__":
            return lambda t, y, c, p, n, E: t if E is None else Dual(t, E[0])
        if name in self.fixed_values:
            v = float(self.fixed_values[name])
            return lambda t, y, c, p, n, E: v
        if name in self.parameter_index:
            ix = self.parameter_index[name]
            return lambda t, y, c, p, n, E: p[..., ix]
        if name in self.species_index:
            ix = self.species_index[name]
            return lambda t, y, c, p, n, E: y[..., ix] if E is None else Dual(y[..., ix], E[1 + ix])
        if name in self.constant_species_index:
            ix = self.constant_species_index[name]
            return lambda t, y, c, p, n, E: c[..., ix]
        if name in self.non_sampled_index:
            ix = self.non_sampled_index[name]
            return lambda t, y, c, p, n, E: n[..., ix]
        if name in self.doc.parameters:
            v = float(self.doc.parameters[name])
            return lambda t, y, c, p, n, E: v
        raise ValueError(f"Name '{name}' does not map to a species or parameter")

    def _build_call(self, fname: str, arg_asts, bound: Dict[str, Callable]):
        args = [self._build(a, bound) for a in arg_asts]
        special = {"hill": (hill, 3, "three"), "mm": (michaelis_menten, 4, "four"),
                   "synthcap": (synthcap, 1, "one"), "tQSSA": (tqssa, 4, "four")}
        if fname in special:
            fn, count, word = special[fname]
            if len(args) != count:
                noun = "parameter" if count == 1 else "parameters"
                raise ValueError(f"{fname} function should have {word} {noun}")
            return lambda t, y, c, p, n, E: fn(*(a(t, y, c, p, n, E) for a in args))
        if fname == "pow":
            a, b = args
            return lambda t, y, c, p, n, E: safepow(a(t, y, c, p, n, E), b(t, y, c, p, n, E))
        # user function definition: inline the body with bound arguments
        if fname in self.doc.functions:
            fdef = self.doc.functions[fname]
            if len(args) != len(fdef.arg_names):
                raise ValueError(f"Function {fname} expects {len(fdef.arg_names)} args")
            inner_bound = dict(bound)
            inner_bound.update(dict(zip(fdef.arg_names, args)))
            return self._build(fdef.body, inner_bound)
        raise ValueError(f"Unknown function '{fname}' in rate law")


def _selector(indices):
    """A slice for an arithmetic run of indices (a view when read), else
    the index list (a gather, its tensor made once a device)."""
    if len(set(indices)) == 1:
        return slice(indices[0], indices[0] + 1)
    step = indices[1] - indices[0]
    if step > 0 and all(b - a == step for a, b in zip(indices, indices[1:])):
        return slice(indices[0], indices[-1] + 1, step)
    return list(indices)


def _leaf_reader(kind, values):
    """The closure that reads one leaf slot of a group of laws: the time
    (lanes, 1), a number (a float if the laws share it, else (laws,)), or
    the laws' columns of a lanes-first table (lanes, laws); species with
    their unit tangents (laws, K) under a Dual."""
    if kind == "t":
        return lambda t, y, c, p, n, E: t[..., None] if E is None else Dual(t[..., None], E[0])
    cache: Dict = {}

    def on(like, key, make):
        k = (key, like.dtype, str(like.device))
        if k not in cache:
            cache[k] = make()
        return cache[k]

    if kind == "k":
        if len(set(values)) == 1:
            v = values[0]
            return lambda t, y, c, p, n, E: v
        return lambda t, y, c, p, n, E: on(y, "k", lambda: torch.tensor(values, dtype=y.dtype,
                                                                         device=y.device))
    sel = _selector(values)

    def cols(table):
        if isinstance(sel, slice):
            return table[..., sel]
        index = on(table, "ix", lambda: torch.tensor(sel, dtype=torch.long, device=table.device))
        return table.index_select(-1, index)

    if kind == "y":
        def species(t, y, c, p, n, E):
            if E is None:
                return cols(y)
            return Dual(cols(y), cols(E[1:].T).T)

        return species
    table = {"p": lambda t, y, c, p, n: p, "c": lambda t, y, c, p, n: c,
             "n": lambda t, y, c, p, n: n}[kind]
    return lambda t, y, c, p, n, E: cols(table(t, y, c, p, n))
