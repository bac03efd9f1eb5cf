"""Kernel B1 (csrc/poppk_propagate.cu), the one-compartment dosing
recurrence: its float operations and bytes for the window's calls.

The operation count is copied from the port's note
(bcm3_tpu_torch/csrc/poppk_propagate.cu and chip_smoke.py's B1 bound, as
of commit d9dda7d00f62b25b3647d9a412570757ad8fc7e2): per lane 12
operations of set-up and 5 an interval. A lane is a (row, patient) pair.
Bytes: the rates ka, ke, kel (a lane each), the per-patient initial
doses, intervals and (P, K) dose amounts read once, the (K, lanes) gut
and central states written once. The work does not depend on the inputs,
so every call of the window counts by its rows.
"""

KERNEL = r"\bpoppk_propagate_kernel\b"
OPS_LANE_SETUP = 12
OPS_PER_INTERVAL = 5


def work(ctx):
    rows = list(ctx.boundary.call_rows)
    if not rows:
        return None
    P, K = ctx.tables["dose_amount"].shape
    item = 4 if ctx.traffic["dtype"] == "float32" else 8
    lanes = sum(rows) * P
    calls = len(rows)
    ops = lanes * (OPS_LANE_SETUP + OPS_PER_INTERVAL * K)
    nbytes = (3 * lanes + calls * (2 * P + P * K) + 2 * K * lanes) * item
    return {"ops": ops, "bytes": nbytes, "dtype": ctx.traffic["dtype"]}
