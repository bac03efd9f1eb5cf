"""Exact closed-form propagator for the one-compartment PK model.

Counterpart of `_expm_ratio` and `propagate_one_compartment` in
bcm3_tpu/ode/linear_pk.py:35-55. Between dosing events the model is
linear time-invariant, so a segment of length dt has a closed form
(state y = [gut, central]):

    gut'     = -(ka + ke) * gut
    central' = ka * gut - kel * central

The two- and three-state propagators of that module are not ported yet
(ROADMAP A8).
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
