"""Kernel B1: the one-compartment dosing-interval recurrence, and B1T, its
reverse mode.

Counterpart of bcm3_tpu/ops/poppk_pallas.py. `propagate_intervals_one_compartment`
runs the CUDA kernel in csrc/poppk_propagate.cu for tensors on a CUDA
device and the plain PyTorch version `propagate_intervals_plain` for
tensors on the CPU. On a CUDA tensor it launches the kernel or raises;
it never falls back to the plain version. The kernel writes its outputs
through raw pointers, so they carry no autograd history: on a CUDA
tensor that requires grad it raises, and a caller that needs gradients
goes through `PropagateOneCompartment`, whose backward is B1T,
`propagate_intervals_adjoint` (the CUDA kernel in the same source, or its
plain version `propagate_intervals_adjoint_plain` on the CPU). When no
input requires grad the Function runs B1 alone, as the wrapper does.
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


def _check_cuda_inputs(named, like):
    for name, x, shape in named:
        if x.device != like.device or x.device.type != "cuda":
            raise ValueError(f"{name} must be on {like.device} (CUDA), got {x.device}")
        if x.dtype != like.dtype or x.dtype not in (torch.float32, torch.float64):
            raise ValueError(f"{name}: dtype {x.dtype}, expected {like.dtype} (f32/f64)")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(x.shape)}, expected {shape}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def propagate_intervals_one_compartment(
    ka, ke, kel, initial_dose, interval, dose_amount
):
    """Interval-start states of the one-compartment model.

    ka/ke/kel: (B, P); initial_dose/interval: (P,); dose_amount: (P, K),
    all of one dtype (float32 or float64) on one device. Returns
    (gut, central), each (K, B, P). On a CUDA tensor that requires grad it
    raises: differentiate through `PropagateOneCompartment`."""
    if ka.device.type == "cpu":
        return propagate_intervals_plain(
            ka, ke, kel, initial_dose, interval, dose_amount
        )
    B, P = ka.shape
    K = dose_amount.shape[1]
    args = (ka, ke, kel, initial_dose, interval, dose_amount)
    build.refuse_grad("propagate_intervals_one_compartment (use PropagateOneCompartment)", args)
    shapes = ((B, P), (B, P), (B, P), (P,), (P,), (P, K))
    _check_cuda_inputs(
        zip(("ka", "ke", "kel", "initial_dose", "interval", "dose_amount"), args, shapes),
        ka,
    )
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


def propagate_intervals_adjoint_plain(ka, ke, kel, interval, gut, cen, grad_gut, grad_cen):
    """Plain PyTorch version of B1T: the adjoint recurrence of
    `propagate_intervals_plain` as a loop of torch ops over the K
    intervals, from K-1 down to 0, in the kernel's order of operations
    (csrc/poppk_propagate.cu, the note of B1T).

    ka/ke/kel: (B, P); interval: (P,); gut/cen: the forward's outputs and
    grad_gut/grad_cen the gradients of a loss in them, each (K, B, P).
    Returns (d/dka, d/dke, d/dkel), each (B, P)."""
    K = gut.shape[0]
    a = ka + ke
    dt = interval[None, :]
    eg = torch.exp(-a * dt)
    ec = torch.exp(-kel * dt)
    d = a - kel
    degenerate = d.abs() < _EPS
    safe_d = torch.where(degenerate, _EPS, d)
    ratio = torch.where(degenerate, dt * ec, (ec - eg) / safe_d)
    ka_ratio = ka * ratio
    zero = torch.zeros_like(ka)
    if K == 0:
        return zero, zero.clone(), zero.clone()
    acc_eg, acc_ec, acc_kr = zero, zero, zero
    lam_g, lam_c = grad_gut[K - 1], grad_cen[K - 1]
    for k in range(K - 2, -1, -1):
        g, c = gut[k], cen[k]
        acc_ec = acc_ec + lam_c * c
        acc_kr = acc_kr + lam_c * g
        acc_eg = acc_eg + lam_g * g
        next_g = grad_gut[k] + (lam_g * eg + lam_c * ka_ratio)
        lam_c = grad_cen[k] + lam_c * ec
        lam_g = next_g
    g_ratio = acc_kr * ka
    q = g_ratio / safe_d
    g_ec = torch.where(degenerate, acc_ec + g_ratio * dt, acc_ec + q)
    g_eg = torch.where(degenerate, acc_eg, acc_eg - q)
    g_d = torch.where(degenerate, 0.0, -(q * ratio))
    g_a = -((g_eg * eg) * dt) + g_d
    return g_a + acc_kr * ratio, g_a, -((g_ec * ec) * dt) - g_d


def propagate_intervals_adjoint(ka, ke, kel, interval, gut, cen, grad_gut, grad_cen):
    """B1T: d/dka, d/dke, d/dkel (each (B, P)) of a loss whose gradients
    in B1's outputs are grad_gut/grad_cen (K, B, P), given those outputs
    gut/cen. The CUDA kernel on a CUDA device, the plain version on the
    CPU; on a CUDA tensor it launches the kernel or raises."""
    if ka.device.type == "cpu":
        return propagate_intervals_adjoint_plain(
            ka, ke, kel, interval, gut, cen, grad_gut, grad_cen
        )
    B, P = ka.shape
    K = gut.shape[0]
    args = (ka, ke, kel, interval, gut, cen, grad_gut, grad_cen)
    build.refuse_grad("propagate_intervals_adjoint", args)
    shapes = ((B, P),) * 3 + ((P,),) + ((K, B, P),) * 4
    _check_cuda_inputs(
        zip(("ka", "ke", "kel", "interval", "gut", "cen", "grad_gut", "grad_cen"),
            args, shapes),
        ka,
    )
    fn = (
        build.library().bcm3_poppk_propagate_adjoint_f32
        if ka.dtype == torch.float32
        else build.library().bcm3_poppk_propagate_adjoint_f64
    )
    outs = [torch.empty_like(ka) for _ in range(3)]
    with torch.cuda.device(ka.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(
            *(x.data_ptr() for x in args), *(o.data_ptr() for o in outs),
            B * P, P, K, stream,
        )
    build.check_launch("poppk_propagate_adjoint", code)
    propagate_intervals_adjoint.launches += 1
    return tuple(outs)


# kernel launches since the count was last set to 0
propagate_intervals_adjoint.launches = 0


class PropagateOneCompartment(torch.autograd.Function):
    """B1 with its reverse mode: forward = `propagate_intervals_one_compartment`
    (kernel B1 on the card), backward = `propagate_intervals_adjoint`
    (kernel B1T on the card). Differentiable in ka, ke and kel; the doses
    and the dosing interval are data and get no gradient."""

    @staticmethod
    def forward(ctx, ka, ke, kel, initial_dose, interval, dose_amount):
        gut, cen = propagate_intervals_one_compartment(
            ka, ke, kel, initial_dose, interval, dose_amount
        )
        ctx.save_for_backward(ka, ke, kel, interval, gut, cen)
        return gut, cen

    @staticmethod
    def backward(ctx, grad_gut, grad_cen):
        ka, ke, kel, interval, gut, cen = ctx.saved_tensors
        grad_gut = torch.zeros_like(gut) if grad_gut is None else grad_gut.contiguous()
        grad_cen = torch.zeros_like(cen) if grad_cen is None else grad_cen.contiguous()
        d_ka, d_ke, d_kel = propagate_intervals_adjoint(
            ka, ke, kel, interval, gut, cen, grad_gut, grad_cen
        )
        return d_ka, d_ke, d_kel, None, None, None

