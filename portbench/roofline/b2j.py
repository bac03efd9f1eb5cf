"""Kernel B2J (csrc/transit_dp5_tangent.cu), the gradient path's budgeted
DP5 transit solve with its Jacobian in the K = 5 lane rates: its float
operations and bytes for the window's gradient-mode calls.

Counts copied from the port's note (bcm3_tpu_torch/ops/
transit_tangent_kernels.py OPS_PER_TRIP, OPS_LANE_SETUP, and chip_smoke.py
`b2j_bound`, as of commit d9dda7d00f62b25b3647d9a412570757ad8fc7e2): a
lane that is active m trips does SETUP + m x TRIP[n states] operations.
The trips are what the inputs need: the reference's frozen gradient-path
solve (in the sampler's dtype) counts the active trips on the rows the
boundary kept of every 16th call, their mean standing for every lane.
Bytes: the K rates read, the grid, dose, initial-dose and observation
tables read, the (lanes, T) central amounts and (lanes, T, K) Jacobian
and the lanes' ok written.
"""

import torch

from portbench.reference import poppk as ref

KERNEL = r"\btransit_dp5_tangent_kernel\b"
OPS_PER_TRIP = {2: 2430, 3: 4446}
OPS_LANE_SETUP = 25


def work(ctx):
    rows = [r for r, grad in zip(ctx.boundary.call_rows, ctx.boundary.call_grad) if grad]
    samples = [x for i, x in ctx.boundary.samples if ctx.boundary.call_grad[i]]
    if not rows or not samples:
        return None
    dtype = getattr(torch, ctx.traffic["dtype"])
    item = torch.finfo(dtype).bits // 8
    tb = ref.device_tables(ctx.tables, ctx.device, dtype)
    x = torch.cat(samples).to(dtype)
    with torch.no_grad():
        p, _, _ = ref.patient_params(x, ctx.prior, ctx.config["pk_type"])
        B, P = p["ka"].shape
        _, _, m = ref.transit_gradient_path(ref.lanes(p, B, P), tb, ctx.config["solver_trips"])
    K, n_states = 5, 2
    S = ctx.tables["grid"].shape[1]
    T = ctx.tables["obs_pos"].shape[1]
    lanes = sum(rows) * P
    ops = lanes * (OPS_LANE_SETUP + OPS_PER_TRIP[n_states] * float(m.double().mean()))
    tables = (2 * P * S + P) * item + P * T * 8
    nbytes = K * lanes * item + len(rows) * tables + lanes * T * (1 + K) * item + lanes
    return {"ops": ops, "bytes": nbytes, "dtype": ctx.traffic["dtype"]}
