"""Static-sparsity-pattern stage solver for the batched stiff integrator.

Counterpart of bcm3_tpu/ode/sparse_lu.py (reference:
src/utils/EigenPartialPivLUSomewhatSparse.h:1-108 and the CVODE sparse
backend toggle, src/odecommon/LinearAlgebraSelector.h:1-33). The pattern
is static (fixed by the SBML reaction structure), so everything symbolic
happens once on the host, as in the JAX package (these functions are
copies): a reverse Cuthill-McKee ordering, the symbolic no-pivot LU with
its fill-in, and a greedy column colouring so the Jacobian comes from
#colours JVPs instead of n.

Over lanes the factorization is one column of the elimination at a time
on a dense (L, n, n) buffer in the permuted order: column k's multipliers
and its rank-one update cover the box of rows and columns that the fill
pattern reaches from k (a banded box after the ordering), in a few
launches, where the JAX package emits one scalar operation an entry. Each
entry of the pattern gets the JAX package's arithmetic in its order
(multipliers are the entry times 1/U_kk, updates subtracted for k
ascending); entries in the box outside the pattern stay exactly zero. The
stage solves sweep the factor's columns the same way where that launches
fewer operations than one batched triangular solve (unit L, then U) on
the factor, which larger patterns take (the JAX package multiplies by
1/U_kk in its own loops; the solve divides: the same values to rounding).
No pivoting: a zero pivot gives non-finite stages and the step is
rejected, the soft failure of a singular G.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import numpy as np
import torch


def _rcm_order(pattern: np.ndarray) -> np.ndarray:
    """Reverse Cuthill-McKee ordering of the symmetrised pattern."""
    try:
        import scipy.sparse as sp
        from scipy.sparse.csgraph import reverse_cuthill_mckee

        sym = sp.csr_matrix((pattern | pattern.T).astype(np.int8))
        return np.asarray(reverse_cuthill_mckee(sym, symmetric_mode=True), dtype=np.int64)
    except Exception:  # pragma: no cover - scipy always present
        return np.arange(pattern.shape[0], dtype=np.int64)


def symbolic_lu(pattern: np.ndarray) -> np.ndarray:
    """Boolean LU fill pattern of a no-pivot factorization (diagonal
    forced nonzero). Standard symbolic Gaussian elimination."""
    F = np.asarray(pattern, dtype=bool).copy()
    n = F.shape[0]
    np.fill_diagonal(F, True)
    for k in range(n):
        below = np.where(F[k + 1 :, k])[0] + k + 1
        right = np.where(F[k, k + 1 :])[0] + k + 1
        if len(below) and len(right):
            F[np.ix_(below, right)] = True
    return F


def color_columns(pattern: np.ndarray) -> Tuple[np.ndarray, List[List[int]]]:
    """Greedy distance-2 colouring: columns sharing a nonzero row get
    different colours, so one JVP per colour recovers exact entries
    (Curtis-Powell-Reid compressed Jacobian estimation)."""
    P = np.asarray(pattern, dtype=bool)
    n = P.shape[1]
    rows_of = [set(np.where(P[:, j])[0].tolist()) for j in range(n)]
    order = np.argsort([-len(r) for r in rows_of])
    color_of = -np.ones(n, dtype=np.int64)
    group_rows: List[set] = []
    groups: List[List[int]] = []
    for j in order:
        placed = False
        for c in range(len(groups)):
            if not (group_rows[c] & rows_of[j]):
                groups[c].append(int(j))
                group_rows[c] |= rows_of[j]
                color_of[j] = c
                placed = True
                break
        if not placed:
            groups.append([int(j)])
            group_rows.append(set(rows_of[j]))
            color_of[j] = len(groups) - 1
    return color_of, groups


class SparseStageSolver:
    """Precompiled factor/solve for one fixed Jacobian pattern, over lanes.

    Usage per Rosenbrock step (ode/rosenbrock.py):
        f0, ft, jv = linearize(f, t, y, args, solver.seeds_like(y))
        A = solver.factor_G(solver.entries_from_jvps(jv), inv_hg)
        x = solver.solve(A, rhs)                 # (L, n) -> (L, n)
    or, from a right-hand side's own Jacobian J (L, n, n),
    ``solver.entries_from_jacobian(J)`` in place of the coloured JVPs.
    """

    def __init__(self, jac_pattern: np.ndarray):
        P = np.asarray(jac_pattern, dtype=bool).copy()
        n = P.shape[0]
        np.fill_diagonal(P, True)  # G's diagonal is structurally nonzero
        self.n = n
        self.jac_pattern = P
        self.perm = _rcm_order(P)
        self.inv_perm = np.argsort(self.perm)
        Pp = P[np.ix_(self.perm, self.perm)]
        self.lu_pattern = symbolic_lu(Pp)
        self.fill_nnz = int(self.lu_pattern.sum())
        self.jac_nnz = int(P.sum())
        # Jacobian nonzeros in ORIGINAL index space (incl. diagonal)
        self.jac_nz = [tuple(int(v) for v in ij) for ij in np.argwhere(P)]
        self.color_of, self.groups = color_columns(P)
        self.num_colors = len(self.groups)
        F = self.lu_pattern
        self._below = [(np.where(F[k + 1 :, k])[0] + k + 1).tolist() for k in range(n)]
        self._right = [(np.where(F[k, k + 1 :])[0] + k + 1).tolist() for k in range(n)]
        # column k's box: rows k+1..row_end[k]-1, columns k+1..col_end[k]-1
        self._boxes = [
            (k, max(self._below[k]) + 1, max(self._right[k]) + 1 if self._right[k] else k + 1)
            for k in range(n) if self._below[k]
        ]
        # U's column j above the diagonal: rows above_start[j]..j-1
        above = [np.where(F[:j, j])[0] for j in range(n)]
        self._above = [(j, int(a.min())) for j, a in enumerate(above) if len(a)]
        # the stage solves as column sweeps over the boxes (two gathers, two
        # operations a column of L or U above its diagonal, one a scaling)
        # where that launches fewer operations than a batched triangular
        # solve's ~22
        self.sweep_solves = 2 + 2 * len(self._boxes) + n + 2 * len(self._above) < 22
        seeds = np.zeros((self.num_colors, n))
        for c, cols in enumerate(self.groups):
            seeds[c, cols] = 1.0
        self.seeds = seeds
        nz = np.array(self.jac_nz, dtype=np.int64).reshape(-1, 2)
        self._nz_color = self.color_of[nz[:, 1]]  # the JVP that carries entry (i, j)
        self._nz_row, self._nz_col = nz[:, 0], nz[:, 1]
        self._nz_perm = (self.inv_perm[nz[:, 0]], self.inv_perm[nz[:, 1]])
        self._index = {}

    def _indices(self, device):
        """The host index arrays as tensors on device (made once each)."""
        key = str(device)
        if key not in self._index:
            t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.long, device=device)  # noqa: E731
            self._index[key] = dict(
                color=t(self._nz_color), row=t(self._nz_row), col=t(self._nz_col),
                pi=t(self._nz_perm[0]),
                pj=t(self._nz_perm[1]), perm=t(self.perm), inv_perm=t(self.inv_perm),
                pivots=torch.arange(1, self.n + 1, dtype=torch.int32, device=device),
            )
        return self._index[key]

    def seeds_like(self, y: torch.Tensor) -> torch.Tensor:
        """The colour seeds (num_colors, n) in y's dtype and device."""
        return torch.as_tensor(self.seeds, dtype=y.dtype, device=y.device)

    # ------------------------------------------------------------------
    # Jacobian extraction (coloured JVPs)

    def entries_from_jvps(self, jv: torch.Tensor) -> torch.Tensor:
        """The Jacobian's entries (L, nnz) in `jac_nz` order from the JVPs
        along the colour seeds (num_colors, L, n): entry (i, j) is row i
        of the JVP of j's colour."""
        ix = self._indices(jv.device)
        return jv[ix["color"], :, ix["row"]].T

    def entries_from_jacobian(self, J: torch.Tensor) -> torch.Tensor:
        """The entries (L, nnz) in `jac_nz` order of a dense Jacobian (L, n, n)."""
        ix = self._indices(J.device)
        return J[:, ix["row"], ix["col"]]

    def jac_entries(self, fn: Callable, y: torch.Tensor):
        """``fn: y (L, n) -> dy/dt (L, n)``. Returns (fn(y), entries (L,
        nnz)) from one linearization and ``num_colors`` JVPs."""
        seeds = self.seeds_like(y)
        f0, jv = torch.func.vmap(
            lambda v: torch.func.jvp(fn, (y,), (v,)), out_dims=(None, 0)
        )(seeds[:, None, :].expand(self.num_colors, *y.shape))
        return f0, self.entries_from_jvps(jv)

    # ------------------------------------------------------------------
    # Factorization / solve

    def factor_G(self, entries: torch.Tensor, inv_hg: torch.Tensor):
        """The no-pivot LU of G = I inv_hg - J over lanes, in the permuted
        order: entries (L, nnz) of J in `jac_nz` order, inv_hg (L,).
        Returns (A (L, n, n): unit-lower multipliers below the diagonal, U
        on and above it; 1/U's diagonal (L, n), which the column sweeps
        multiply by, as the JAX package's solve does)."""
        ix = self._indices(entries.device)
        L, n = entries.shape[0], self.n
        A = entries.new_zeros(L, n, n)
        A[:, ix["pi"], ix["pj"]] = -entries
        A.diagonal(dim1=1, dim2=2).add_(inv_hg[:, None])
        for k, r_end, c_end in self._boxes:
            inv = 1.0 / A[:, k, k]
            fmul = A[:, k + 1 : r_end, k] * inv[:, None]
            A[:, k + 1 : r_end, k] = fmul
            if c_end > k + 1:
                A[:, k + 1 : r_end, k + 1 : c_end] -= fmul[:, :, None] * A[:, k : k + 1, k + 1 : c_end]
        return A, (1.0 / A.diagonal(dim1=1, dim2=2) if self.sweep_solves else None)

    def solve(self, factors, b: torch.Tensor) -> torch.Tensor:
        """Solve G x = b with the factors from :meth:`factor_G`; b (L, n)
        and the result in the original index order. Small patterns sweep
        the columns (L's ascending, U's descending, each row's terms
        subtracted in its column order); others take one batched
        triangular solve."""
        A, inv = factors
        ix = self._indices(b.device)
        x = b[:, ix["perm"]]
        if inv is None:
            pivots = ix["pivots"].expand(A.shape[0], self.n)
            x = torch.linalg.lu_solve(A, pivots, x[..., None])[..., 0]
        else:
            for k, r_end, _ in self._boxes:
                x[:, k + 1 : r_end] -= A[:, k + 1 : r_end, k] * x[:, k : k + 1]
            done = self.n
            for j, top in reversed(self._above):
                x[:, j:done] *= inv[:, j:done]
                x[:, top:j] -= A[:, top:j, j] * x[:, j : j + 1]
                done = j
            x[:, :done] *= inv[:, :done]
        return x[:, ix["inv_perm"]]


def detect_sparsity(fn: Callable, y_samples: np.ndarray) -> np.ndarray:
    """Numerical Jacobian-pattern probe: union of |J| > 0 over sample
    points (used by tests to cross-check the structural pattern). fn is
    lanes first, the samples (S, n) its lanes; the Jacobian from n JVPs."""
    y = torch.as_tensor(np.asarray(y_samples, dtype=np.float64))
    n = y.shape[1]
    eye = torch.eye(n, dtype=y.dtype)
    jv = torch.func.vmap(lambda v: torch.func.jvp(fn, (y,), (v,))[1])(
        eye[:, None, :].expand(n, *y.shape)
    )  # (n, S, n): jv[j, s, i] = d f_i / d y_j at sample s
    return (jv.abs() > 0).any(dim=1).T.numpy()
