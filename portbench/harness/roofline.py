"""A kernel's share of its roofline, from `roofline/<kernel>.py`.

The least time for the work of the traced window's calls of the kernel
is the larger of its float operations at the card's published peak for
the dtype and its bytes at the published memory rate (each input byte
read once, each output byte written once); the share is that time over
the kernel's device seconds in the trace. A roofline file gives
`KERNEL`, a regular expression of the kernel's name in the trace, and
`work(ctx)`, its operations, bytes and dtype for the window, or None.
"""

from __future__ import annotations

import sys

from portbench.harness import registry

# published dense peaks, NVIDIA's data sheet of the SXM part (700 W):
# float32 and float64 outside the tensor cores, HBM3 bandwidth
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"float32": 67e12, "float64": 34e12, "bytes": 3.35e12},
}


def share(ctx, kernel: str):
    """Percent of the roofline the kernel reached in the traced window, or
    None where the trace holds no launch of it or the card is not in PEAKS."""
    if ctx.trace is None:
        return None
    mod = registry.load_module("roofline", kernel)
    seconds, launches = ctx.trace.kernel_seconds(mod.KERNEL)
    peak = PEAKS.get(ctx.device_name)
    if seconds <= 0 or peak is None:
        return None
    work = mod.work(ctx)
    if not work:
        return None
    t_ops = work["ops"] / peak[work["dtype"]]
    t_bytes = work["bytes"] / peak["bytes"]
    bound = max(t_ops, t_bytes)
    print(f"roofline {kernel}: {launches} launches, {seconds:.6f} s on the device; "
          f"{work['ops']:.6e} operations, {work['bytes']:.6e} bytes; bound {bound:.6f} s by "
          f"{'operations' if t_ops > t_bytes else 'bytes'}; nvidia-smi: {ctx.power_limit}",
          file=sys.stderr)
    return 100.0 * bound / seconds
