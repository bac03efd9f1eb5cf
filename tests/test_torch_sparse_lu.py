"""The port's sparse stage solver (bcm3_tpu_torch/ode/sparse_lu.py) against
the JAX package's (bcm3_tpu/ode/sparse_lu.py), float64.

Mirrors tests/test_sparse_lu.py:31-169 and :223: the symbolic LU, the
colouring and the ordering equal the JAX package's (the port's are
copies); the factor and solve over lanes against numpy's dense solve and
the JAX package's; the coloured Jacobian against jax.jacfwd and the
compiled tangents; the structural pattern covers the numerical one; the
stiff solve through the sparse solver against the dense one and the JAX
package's sparse solve (lanes whose step count differs are held to the
solver's tolerance, see tests/test_torch_rosenbrock.py); a singular stage
matrix fails soft.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from bcm3_tpu.ode import sparse_lu as jsl
from bcm3_tpu.ode.rosenbrock import solve_at_times_stiff as jsolve
from bcm3_tpu.sbml import SBMLModel as JModel
from bcm3_tpu_torch.ode import rosenbrock as R
from bcm3_tpu_torch.ode.sparse_lu import (
    SparseStageSolver,
    color_columns,
    detect_sparsity,
    symbolic_lu,
)
from bcm3_tpu_torch.sbml import SBMLModel
from test_torch_rosenbrock import _lanes

F64 = torch.float64


def _random_pattern(n, density, seed):
    rng = np.random.default_rng(seed)
    P = rng.random((n, n)) < density
    np.fill_diagonal(P, True)
    return P


def test_symbolic_structures_match_jax():
    for n, density, seed in ((4, 0.3, 0), (12, 0.25, 0), (25, 0.12, 3)):
        P = _random_pattern(n, density, seed)
        np.testing.assert_array_equal(symbolic_lu(P), jsl.symbolic_lu(P))
        c, g = color_columns(P)
        jc, jg = jsl.color_columns(P)
        np.testing.assert_array_equal(c, jc)
        assert g == jg
        s, js = SparseStageSolver(P), jsl.SparseStageSolver(P)
        np.testing.assert_array_equal(s.perm, js.perm)
        np.testing.assert_array_equal(s.lu_pattern, js.lu_pattern)
        assert (s.fill_nnz, s.jac_nnz, s.num_colors) == (js.fill_nnz, js.jac_nnz, js.num_colors)
    # fill-in: eliminating column 0 with rows {1,2} below and cols {1,2} right
    P = np.zeros((3, 3), dtype=bool)
    P[1, 0] = P[2, 0] = P[0, 1] = P[0, 2] = True
    F = symbolic_lu(P)
    assert F[1, 2] and F[2, 1]


@pytest.mark.parametrize("n,density,seed", [(5, 0.4, 1), (12, 0.2, 2), (25, 0.12, 3)])
def test_sparse_factor_solve_matches_dense_and_jax(n, density, seed):
    """Six lanes of G = I inv_hg - J on the pattern: the port against
    numpy's dense solve and the JAX package's vmapped sparse solve."""
    P = _random_pattern(n, density, seed)
    solver, jsolver = SparseStageSolver(P), jsl.SparseStageSolver(P)
    rng = np.random.default_rng(seed + 100)
    B = 6
    Js = np.where(P[None], rng.normal(size=(B, n, n)), 0.0)
    bs = rng.normal(size=(B, n))
    inv_hg = rng.uniform(3.0, 8.0, size=B)
    nz = np.asarray(solver.jac_nz)
    entries = torch.as_tensor(Js[:, nz[:, 0], nz[:, 1]])
    A = solver.factor_G(entries, torch.as_tensor(inv_hg))
    x = solver.solve(A, torch.as_tensor(bs)).numpy()

    def solve_one(Jflat, b, ih):
        jac = {(int(i), int(j)): Jflat[k] for k, (i, j) in enumerate(nz)}
        return jsolver.solve(jsolver.factor_G(jac, ih), b)

    ref = np.asarray(jax.vmap(solve_one)(jnp.asarray(entries.numpy()), jnp.asarray(bs),
                                         jnp.asarray(inv_hg)))
    for b in range(B):
        expected = np.linalg.solve(inv_hg[b] * np.eye(n) - Js[b], bs[b])
        np.testing.assert_allclose(x[b], expected, rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(x, ref, rtol=1e-11, atol=1e-13)


def _cascade(extra_modules):
    """The cascade model's right-hand side f(y) (L, n) at bench's values
    in both packages."""
    text = chip_smoke.cascade_model(extra_modules)
    m, jm = SBMLModel.from_string(text), JModel.from_string(text)
    names = ["k_growth", "k_div"]
    rhs, jrhs = m.make_rhs(names), jm.make_rhs(names)
    const = m.initial_constant_values()
    params = np.asarray([0.1, 0.25])

    def fn(y):
        L = y.shape[0]
        return rhs(torch.zeros(L, dtype=y.dtype), y, torch.as_tensor(const).expand(L, -1),
                   torch.as_tensor(params).expand(L, -1), torch.zeros(0, dtype=y.dtype))

    def jfn(y):
        return jrhs(0.0, y, jnp.asarray(const), jnp.asarray(params), jnp.zeros(0))

    rhs_jac = m.make_rhs_jacobian(names)

    def jac(t, y, args):
        L = y.shape[0]
        return rhs_jac(t, y, torch.as_tensor(const).expand(L, -1),
                       torch.as_tensor(params).expand(L, -1), torch.zeros(0, dtype=y.dtype))

    fn.jac = jac
    return m, fn, jfn


def test_structural_pattern_superset_of_numeric():
    m, fn, jfn = _cascade(3)
    P = m.jacobian_sparsity()
    ys = np.abs(np.random.default_rng(0).normal(0.5, 0.3, size=(5, m.num_ode_species)))
    numeric = detect_sparsity(fn, ys)
    np.testing.assert_array_equal(numeric, jsl.detect_sparsity(jfn, ys))
    assert not (numeric & ~P).any(), "numeric pattern outside structural"


def test_colored_jacobian_matches_jacfwd():
    m, fn, jfn = _cascade(4)
    solver = SparseStageSolver(m.jacobian_sparsity())
    assert solver.num_colors <= 6
    y = np.abs(np.random.default_rng(1).normal(0.6, 0.2, (3, m.num_ode_species)))
    f0, entries = solver.jac_entries(fn, torch.as_tensor(y))
    nz = np.asarray(solver.jac_nz)
    for lane in range(3):
        J = np.asarray(jax.jacfwd(jfn)(jnp.asarray(y[lane])))
        np.testing.assert_allclose(f0[lane].numpy(), np.asarray(jfn(jnp.asarray(y[lane]))),
                                   rtol=1e-12)
        np.testing.assert_allclose(entries[lane].numpy(), J[nz[:, 0], nz[:, 1]], rtol=1e-12,
                                   atol=1e-300)
    # the compiled tangents give the same entries
    L = y.shape[0]
    rhs_jac = m.make_rhs_jacobian(["k_growth", "k_div"])
    _, _, Jc = rhs_jac(torch.zeros(L, dtype=F64), torch.as_tensor(y),
                       torch.as_tensor(m.initial_constant_values()).expand(L, -1),
                       torch.tensor([[0.1, 0.25]], dtype=F64).expand(L, -1),
                       torch.zeros(0, dtype=F64))
    np.testing.assert_allclose(solver.entries_from_jacobian(Jc).numpy(), entries.numpy(),
                               rtol=1e-14, atol=1e-300)


@pytest.mark.parametrize("modules", [0, 8])
def test_stiff_solver_sparse_matches_dense_and_jax(modules):
    """The cascade (4 and 20 ODE species) over three lanes of initial
    states: sparse against dense (the port) within the controller's
    tolerance, and the sparse solve against the JAX package's; the
    derivatives from the model's compiled tangents (the generic JVPs at 20
    species take ~40 ms a step here)."""
    m, fn, jfn = _cascade(modules)
    solver = SparseStageSolver(m.jacobian_sparsity())
    jsolver = jsl.SparseStageSolver(m.jacobian_sparsity())
    y0 = m.initial_ode_values()[None] * np.asarray([[1.0], [0.9], [1.1]])
    times = np.linspace(0.0, 2.0, 9)
    f = lambda t, y, a: fn(y)  # noqa: E731
    # at 20 species the controller's rtol 1e-6 (1e-8 takes ~1,900 steps a lane)
    tol = 1e-8 if modules == 0 else 1e-6
    kw = dict(rtol=tol, atol=tol * 1e-2)
    dense = R.solve_at_times_stiff(f, torch.as_tensor(y0), torch.as_tensor(times), jac=fn.jac,
                                   **kw)
    sparse = R.solve_at_times_stiff(f, torch.as_tensor(y0), torch.as_tensor(times),
                                    sparse=solver, jac=fn.jac, **kw)
    assert dense.ok.all() and sparse.ok.all()
    np.testing.assert_allclose(sparse.ys.numpy(), dense.ys.numpy(), rtol=200 * tol,
                               atol=0.1 * tol)
    ref = jax.jit(jax.vmap(lambda y: jsolve(lambda t, yy, a: jfn(yy), y, jnp.asarray(times),
                                            sparse=jsolver, **kw)))(jnp.asarray(y0))
    _lanes(f"sparse cascade {modules}", sparse.ys, sparse.n_steps, sparse.ok, ref.ys,
           ref.n_steps, ref.ok, 100 * tol, max_flips=1)


def test_singular_stage_matrix_fails_soft():
    """A structurally singular G yields non-finite solve output (-> step
    rejection), never silently wrong values (test_sparse_lu.py:223)."""
    P = np.zeros((3, 3), dtype=bool)
    P[0, 1] = P[1, 0] = True
    solver = SparseStageSolver(P)
    J = {(0, 0): 0.0, (0, 1): 2.0, (1, 0): 2.0, (1, 1): -3.0, (2, 2): 0.0}
    entries = torch.tensor([[J[ij] for ij in solver.jac_nz]], dtype=F64)
    A = solver.factor_G(entries, torch.ones(1, dtype=F64))
    x = solver.solve(A, torch.ones(1, 3, dtype=F64))
    assert not torch.isfinite(x).all()
