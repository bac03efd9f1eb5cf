"""Kernel B1: the one-compartment dosing-interval recurrence.

Counterpart of bcm3_tpu/ops/poppk_pallas.py. `propagate_intervals_one_compartment`
runs the CUDA kernel in csrc/poppk_propagate.cu for tensors on a CUDA
device and the plain PyTorch version `propagate_intervals_plain` for
tensors on the CPU. On a CUDA tensor it launches the kernel or raises;
it never falls back to the plain version.
"""

from __future__ import annotations

import torch

from bcm3_tpu_torch.ops import build

_EPS = 1e-12


def propagate_intervals_plain(ka, ke, kel, initial_dose, interval, dose_amount):
    """Plain PyTorch version: a loop over the K intervals on (B, P) tensors.

    Same semantics as bcm3_tpu/ops/poppk_pallas.py:134-151
    (`propagate_intervals_reference`). Returns (gut, central), each
    (K, B, P): the state at the START of every interval."""
    K = dose_amount.shape[1]
    a = ka + ke
    dt = interval[None, :]
    eg = torch.exp(-a * dt)
    ec = torch.exp(-kel * dt)
    d = a - kel
    degenerate = d.abs() < _EPS
    ratio = torch.where(
        degenerate, dt * ec, (ec - eg) / torch.where(degenerate, _EPS, d)
    )
    ka_ratio = ka * ratio
    gut = initial_dose[None, :].expand_as(ka)
    cen = torch.zeros_like(ka)
    out_gut = torch.empty((K,) + ka.shape, dtype=ka.dtype, device=ka.device)
    out_cen = torch.empty_like(out_gut)
    for k in range(K):
        out_gut[k] = gut
        out_cen[k] = cen
        cen = cen * ec + gut * ka_ratio
        gut = gut * eg + dose_amount[None, :, k]
    return out_gut, out_cen


def propagate_intervals_one_compartment(
    ka, ke, kel, initial_dose, interval, dose_amount
):
    """Interval-start states of the one-compartment model.

    ka/ke/kel: (B, P); initial_dose/interval: (P,); dose_amount: (P, K),
    all of one dtype (float32 or float64) on one device. Returns
    (gut, central), each (K, B, P)."""
    if ka.device.type == "cpu":
        return propagate_intervals_plain(
            ka, ke, kel, initial_dose, interval, dose_amount
        )
    B, P = ka.shape
    K = dose_amount.shape[1]
    args = (ka, ke, kel, initial_dose, interval, dose_amount)
    shapes = ((B, P), (B, P), (B, P), (P,), (P,), (P, K))
    for name, x, shape in zip(
        ("ka", "ke", "kel", "initial_dose", "interval", "dose_amount"), args, shapes
    ):
        if x.device != ka.device or x.device.type != "cuda":
            raise ValueError(f"{name} must be on {ka.device} (CUDA), got {x.device}")
        if x.dtype != ka.dtype or x.dtype not in (torch.float32, torch.float64):
            raise ValueError(f"{name}: dtype {x.dtype}, expected {ka.dtype} (f32/f64)")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(x.shape)}, expected {shape}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    fn = (
        build.library().bcm3_poppk_propagate_f32
        if ka.dtype == torch.float32
        else build.library().bcm3_poppk_propagate_f64
    )
    out_gut = torch.empty((K, B, P), dtype=ka.dtype, device=ka.device)
    out_cen = torch.empty_like(out_gut)
    with torch.cuda.device(ka.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(
            *(x.data_ptr() for x in args),
            out_gut.data_ptr(), out_cen.data_ptr(),
            B * P, P, K, stream,
        )
    build.check_launch("poppk_propagate", code)
    propagate_intervals_one_compartment.launches += 1
    return out_gut, out_cen


# kernel launches since the count was last set to 0
propagate_intervals_one_compartment.launches = 0
