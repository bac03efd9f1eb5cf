"""Exact closed-form propagators for linear compartment PK models.

Counterpart of bcm3_tpu/ode/linear_pk.py. Between dosing events these
models are linear time-invariant, so a segment of length dt has a closed
form (state y = [gut, central, peripheral]):

    gut'        = -(ka + ke) * gut
    central'    = ka * gut - kel * central            (one-compartment)
    central'    = ka * gut - (kel + kpf) * central + kpb * peripheral
    peripheral' = kpf * central - kpb * peripheral    (two-compartment)

The gut decays as exp(-a t); the central/peripheral block is a 2x2 linear
system with exponential forcing, solved by the Lagrange-Sylvester 2x2
matrix exponential plus a particular solution u exp(-a t) with
(A22 + a I) u = -b0. `small_expm` is the general small-matrix exponential
(Pade-6 scaling and squaring). Every function broadcasts over leading
axes; the arithmetic is the JAX package's, in the same order.
"""

from __future__ import annotations

import torch

_EPS = 1e-12


def _expm_ratio(a, kel, dt):
    """(exp(-kel dt) - exp(-a dt)) / (a - kel) with a -> kel guard."""
    d = a - kel
    degenerate = d.abs() < _EPS
    safe_d = torch.where(degenerate, _EPS, d)
    general = (torch.exp(-kel * dt) - torch.exp(-a * dt)) / safe_d
    # limit a -> kel: dt * exp(-kel dt)
    limit = dt * torch.exp(-kel * dt)
    return torch.where(degenerate, limit, general)


def propagate_one_compartment(y, dt, ka, ke, kel):
    """Exact solution of the one-compartment model over dt.

    y: (..., 2) [gut, central]. Broadcasts over leading axes.
    """
    a = ka + ke
    gut = y[..., 0] * torch.exp(-a * dt)
    central = y[..., 1] * torch.exp(-kel * dt) + ka * y[..., 0] * _expm_ratio(
        a, kel, dt
    )
    return torch.stack([gut, central], dim=-1)


def _expm_2x2(m00, m01, m10, m11, dt):
    """exp(dt * [[m00, m01], [m10, m11]]) for real-eigenvalue 2x2 systems
    via Lagrange-Sylvester interpolation. Returns the 4 entries."""
    tr = m00 + m11
    det = m00 * m11 - m01 * m10
    disc = tr * tr - 4.0 * det
    # compartment systems have real spectra; clamp tiny negatives from rounding
    sq = torch.sqrt(torch.clamp(disc, min=_EPS * _EPS))
    l1 = 0.5 * (tr + sq)
    l2 = 0.5 * (tr - sq)
    e1 = torch.exp(l1 * dt)
    e2 = torch.exp(l2 * dt)
    denom = torch.where((l1 - l2).abs() < _EPS, _EPS, l1 - l2)
    # exp(A dt) = (e1 (A - l2 I) - e2 (A - l1 I)) / (l1 - l2)
    c1 = (e1 - e2) / denom
    c0 = (l1 * e2 - l2 * e1) / denom
    return (
        c0 + c1 * m00,
        c1 * m01,
        c1 * m10,
        c0 + c1 * m11,
    )


def propagate_two_compartment(y, dt, ka, ke, kel, kpf, kpb):
    """Exact solution of the two-compartment model over dt.

    y: (..., 3) [gut, central, peripheral].
    """
    a = ka + ke
    gut0 = y[..., 0]
    gut = gut0 * torch.exp(-a * dt)

    # central/peripheral block: z' = A z + b0 exp(-a t), b0 = ka*gut0*e1
    m00, m01 = -(kel + kpf), kpb
    m10, m11 = kpf, -kpb

    # particular solution u: (A + a I) u = -b0
    p00, p11 = m00 + a, m11 + a
    det_p = p00 * p11 - m01 * m10
    det_p = torch.where(det_p.abs() < _EPS, _EPS, det_p)
    b0 = ka * gut0
    # u = -(A + aI)^{-1} [b0, 0]^T
    u1 = -(p11 * b0) / det_p
    u2 = -(-m10 * b0) / det_p

    e00, e01, e10, e11 = _expm_2x2(m00, m01, m10, m11, dt)
    h1 = y[..., 1] - u1
    h2 = y[..., 2] - u2
    decay = torch.exp(-a * dt)
    central = e00 * h1 + e01 * h2 + u1 * decay
    peripheral = e10 * h1 + e11 * h2 + u2 * decay
    return torch.stack([gut, central, peripheral], dim=-1)


def _mm(A, B):
    """(..., n, n) @ (..., n, n) summed over k in order, as the JAX
    package's unrolled multiply-add does (a BLAS product may sum in
    another order)."""
    n = A.shape[-1]
    acc = A[..., :, 0:1] * B[..., 0:1, :]
    for k in range(1, n):
        acc = acc + A[..., :, k : k + 1] * B[..., k : k + 1, :]
    return acc


def small_expm(A, max_squarings: int = 12):
    """exp(A) for a batch of small matrices A (..., n, n) by Pade-6 scaling
    and squaring (reference algorithm choice: PharmacokineticModel.cpp:146
    uses Eigen MatrixFunctions exp()). Each matrix takes its own number of
    squarings s = ceil(log2(||A||_inf / 0.5)), clipped to [0,
    max_squarings]: the loop runs max_squarings times and a matrix keeps
    its square only while the trip is below its s. The Pade denominator
    q = V - U has ||A_scaled|| <= 0.5, so q is strictly diagonally dominant
    and the no-pivot LU solve is safe."""
    n = A.shape[-1]
    norm = A.abs().sum(dim=-1).amax(dim=-1)
    s = torch.ceil(torch.log2(torch.clamp(norm, min=1e-30) / 0.5))
    s = torch.clamp(s, 0, max_squarings).to(torch.int32)
    As = A * torch.exp2(-s.to(A.dtype))[..., None, None]

    c = (1.0, 0.5, 3.0 / 26.0, 5.0 / 312.0, 5.0 / 3432.0, 1.0 / 11440.0,
         1.0 / 308880.0)
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    A2 = _mm(As, As)
    A4 = _mm(A2, A2)
    A6 = _mm(A4, A2)
    W = c[1] * eye + c[3] * A2 + c[5] * A4
    V = c[0] * eye + c[2] * A2 + c[4] * A4 + c[6] * A6
    U = _mm(As, W)
    p = V + U
    q = V - U
    # unrolled no-pivot LU solve: E = q^-1 p (q diagonally dominant)
    q = [[q[..., i, j] for j in range(n)] for i in range(n)]
    p = [[p[..., i, j] for j in range(n)] for i in range(n)]
    for k in range(n):
        inv = 1.0 / q[k][k]
        for j in range(k + 1, n):
            q[k][j] = q[k][j] * inv
        for j in range(n):
            p[k][j] = p[k][j] * inv
        for i in range(k + 1, n):
            f = q[i][k]
            for j in range(k + 1, n):
                q[i][j] = q[i][j] - f * q[k][j]
            for j in range(n):
                p[i][j] = p[i][j] - f * p[k][j]
    for k in range(n - 1, -1, -1):
        for i in range(k):
            f = q[i][k]
            for j in range(n):
                p[i][j] = p[i][j] - f * p[k][j]
    E = torch.stack([torch.stack(row, dim=-1) for row in p], dim=-2)

    # masked fixed-count squaring: s differs between matrices
    for i in range(max_squarings):
        E = torch.where((i < s)[..., None, None], _mm(E, E), E)
    return E


def propagate(y, dt, ka, ke, kel, kpf=None, kpb=None):
    """Dispatch on state size (2 -> one-compartment, 3 -> two-compartment)."""
    if y.shape[-1] == 2:
        return propagate_one_compartment(y, dt, ka, ke, kel)
    return propagate_two_compartment(y, dt, ka, ke, kel, kpf, kpb)


def propagate_biphasic(y, dt, switch_offset, ka1, ka2, ke, kel, kpf=None, kpb=None):
    """Propagate over a window [0, dt] whose absorption rate switches from
    ka1 to ka2 at ``switch_offset`` (clamped into [0, dt]).

    Implements the biphasic-uptake models
    (reference: LikelihoodPopPKTrajectory.cpp:496-575, TreatmentCallbackBiphasic).
    """
    s = torch.minimum(torch.clamp(switch_offset, min=0.0), torch.as_tensor(dt).to(switch_offset))
    if y.shape[-1] == 2:
        y_mid = propagate_one_compartment(y, s, ka1, ke, kel)
        return propagate_one_compartment(y_mid, dt - s, ka2, ke, kel)
    y_mid = propagate_two_compartment(y, s, ka1, ke, kel, kpf, kpb)
    return propagate_two_compartment(y_mid, dt - s, ka2, ke, kel, kpf, kpb)
