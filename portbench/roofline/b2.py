"""Kernel B2 (csrc/transit_dp5.cu), the population path's budgeted DP5
transit solve: its float operations and bytes for the window's calls.

Counts copied from the port's note (bcm3_tpu_torch/ops/transit_kernels.py
OPS_PER_TRIP, OPS_FIRST_STAGE, OPS_LANE_SETUP, as of commit
d9dda7d00f62b25b3647d9a412570757ad8fc7e2): a lane that runs n >= 1 trips
does SETUP + FIRST_STAGE + n x TRIP operations. The trips are what the
inputs need: the reference's frozen solve (float32, as B2 computes)
counts them on the rows the boundary kept of every 16th call, and their
mean a lane stands for every lane of the window's calls. Bytes: five
lane rates read, the per-patient initial doses and (P, S) stop and dose
tables read, the (lanes, S) central amounts and the lanes' ok written.
"""

import torch

from portbench.reference import poppk as ref

KERNEL = r"\btransit_dp5_kernel\b"
OPS_PER_TRIP = 273
OPS_FIRST_STAGE = 18
OPS_LANE_SETUP = 10


def work(ctx):
    rows = [r for r, grad in zip(ctx.boundary.call_rows, ctx.boundary.call_grad) if not grad]
    samples = [x for i, x in ctx.boundary.samples if not ctx.boundary.call_grad[i]]
    if not rows or not samples:
        return None
    f32 = torch.float32
    tb = ref.device_tables(ctx.tables, ctx.device, f32)
    x = torch.cat(samples).to(f32)
    with torch.no_grad():
        p, _, _ = ref.patient_params(x, ctx.prior, ctx.config["pk_type"])
        B, P = p["ka"].shape
        _, _, n = ref.transit_population(ref.lanes(p, B, P), tb, ctx.config["solver_trips"])
    n = n.double()
    per_lane = OPS_LANE_SETUP + OPS_FIRST_STAGE * (n > 0).double().mean() + OPS_PER_TRIP * n.mean()
    S = ctx.tables["grid"].shape[1]
    lanes = sum(rows) * P
    ops = float(per_lane) * lanes
    nbytes = 5 * lanes * 4 + len(rows) * (2 * P * S + P) * 4 + lanes * S * 4 + lanes
    return {"ops": ops, "bytes": nbytes, "dtype": "float32"}
