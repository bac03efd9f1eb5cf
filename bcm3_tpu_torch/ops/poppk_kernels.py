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
    device, dtype = like.device, like.dtype
    if device.type != "cuda" or dtype not in (torch.float32, torch.float64):
        raise ValueError(f"inputs must be float32/float64 on a CUDA device, got {dtype} "
                         f"on {device}")
    for name, x, shape in named:
        if x.device != device:
            raise ValueError(f"{name} must be on {device} (CUDA), got {x.device}")
        if x.dtype != dtype:
            raise ValueError(f"{name}: dtype {x.dtype}, expected {dtype} (f32/f64)")
        if x.shape != shape:
            raise ValueError(f"{name}: shape {tuple(x.shape)}, expected {shape}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


_B1_INPUTS = ("ka", "ke", "kel", "initial_dose", "interval", "dose_amount")


def _b1_shapes(B, P, K):
    return ((B, P),) * 3 + ((P,), (P,), (P, K))


def _launch(name, fn, device, *args):
    """fn(*args, stream) on the current stream of `device`, which the
    kernel needs to be the current device; enters `torch.cuda.device` only
    when it is not."""
    if device.index == torch.cuda.current_device():
        code = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    else:
        with torch.cuda.device(device):
            code = fn(*args, torch.cuda.current_stream().cuda_stream)
    build.check_launch(name, code)


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
    _check_cuda_inputs(zip(_B1_INPUTS, args, _b1_shapes(B, P, K)), ka)
    lib = build.library()
    fn = lib.bcm3_poppk_propagate_f32 if ka.dtype == torch.float32 else lib.bcm3_poppk_propagate_f64
    out_gut = torch.empty((K, B, P), dtype=ka.dtype, device=ka.device)
    out_cen = torch.empty_like(out_gut)
    _launch("poppk_propagate", fn, ka.device, *(x.data_ptr() for x in args),
            out_gut.data_ptr(), out_cen.data_ptr(), B * P, P, K)
    propagate_intervals_one_compartment.launches += 1
    return out_gut, out_cen


# kernel launches since the count was last set to 0
propagate_intervals_one_compartment.launches = 0

def propagate_intervals_adjoint_plain(
    ka, ke, kel, initial_dose, interval, dose_amount, grad_gut, grad_cen
):
    """Plain PyTorch version of B1T: B1's states recomputed by
    `propagate_intervals_plain`, then the forward-mode tangents of the
    state carried through the K intervals as a loop of torch ops, in the
    kernel's order of operations (csrc/poppk_propagate.cu, the note of
    B1T).

    ka/ke/kel: (B, P); initial_dose/interval: (P,); dose_amount: (P, K);
    grad_gut/grad_cen: the gradients of a loss in B1's outputs, each
    (K, B, P). Returns (d/dka, d/dke, d/dkel), each (B, P)."""
    gut, cen = propagate_intervals_plain(ka, ke, kel, initial_dose, interval, dose_amount)
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
    tg = tce = tcc = tck = zero
    acc_eg = acc_ec = acc_kr = zero
    for k in range(dose_amount.shape[1]):
        G, C, g, c = grad_gut[k], grad_cen[k], gut[k], cen[k]
        acc_eg = acc_eg + (G * tg + C * tce)
        acc_ec = acc_ec + C * tcc
        acc_kr = acc_kr + C * tck
        tce = tce * ec + tg * ka_ratio
        tcc = tcc * ec + c
        tck = tck * ec + g
        tg = tg * eg + g
    g_ratio = acc_kr * ka
    q = g_ratio / safe_d
    g_ec = torch.where(degenerate, acc_ec + g_ratio * dt, acc_ec + q)
    g_eg = torch.where(degenerate, acc_eg, acc_eg - q)
    g_d = torch.where(degenerate, 0.0, -(q * ratio))
    g_a = -((g_eg * eg) * dt) + g_d
    return g_a + acc_kr * ratio, g_a, -((g_ec * ec) * dt) - g_d


def propagate_intervals_adjoint(
    ka, ke, kel, initial_dose, interval, dose_amount, grad_gut, grad_cen
):
    """B1T: d/dka, d/dke, d/dkel (each (B, P)) of a loss whose gradients
    in B1's outputs are grad_gut/grad_cen (K, B, P), given B1's inputs.
    The CUDA kernel on a CUDA device, the plain version on the CPU; on a
    CUDA tensor it launches the kernel or raises."""
    if ka.device.type == "cpu":
        return propagate_intervals_adjoint_plain(
            ka, ke, kel, initial_dose, interval, dose_amount, grad_gut, grad_cen
        )
    B, P = ka.shape
    K = dose_amount.shape[1]
    args = (ka, ke, kel, initial_dose, interval, dose_amount, grad_gut, grad_cen)
    build.refuse_grad("propagate_intervals_adjoint", args)
    _check_cuda_inputs(
        zip(_B1_INPUTS + ("grad_gut", "grad_cen"), args, _b1_shapes(B, P, K) + ((K, B, P),) * 2),
        ka,
    )
    lib = build.library()
    fn = (lib.bcm3_poppk_propagate_adjoint_f32 if ka.dtype == torch.float32
          else lib.bcm3_poppk_propagate_adjoint_f64)
    out = torch.empty((3, B, P), dtype=ka.dtype, device=ka.device)
    _launch("poppk_propagate_adjoint", fn, ka.device, *(x.data_ptr() for x in args),
            out.data_ptr(), B * P, P, K)
    propagate_intervals_adjoint.launches += 1
    return out[0], out[1], out[2]


# kernel launches since the count was last set to 0
propagate_intervals_adjoint.launches = 0


class PropagateOneCompartment(torch.autograd.Function):
    """B1 with its reverse mode: forward = `propagate_intervals_one_compartment`
    (kernel B1 on the card), backward = `propagate_intervals_adjoint`
    (kernel B1T on the card), which recomputes the forward from the
    inputs: only the inputs are saved, not the (K, B, P) states.
    Differentiable in ka, ke and kel; the doses and the dosing interval
    are data and get no gradient."""

    @staticmethod
    def forward(ctx, ka, ke, kel, initial_dose, interval, dose_amount):
        ctx.save_for_backward(ka, ke, kel, initial_dose, interval, dose_amount)
        return propagate_intervals_one_compartment(
            ka, ke, kel, initial_dose, interval, dose_amount
        )

    @staticmethod
    def backward(ctx, grad_gut, grad_cen):
        inputs = ctx.saved_tensors
        ka, dose_amount = inputs[0], inputs[5]
        shape = (dose_amount.shape[1],) + tuple(ka.shape)
        grad_gut = ka.new_zeros(shape) if grad_gut is None else grad_gut.contiguous()
        grad_cen = ka.new_zeros(shape) if grad_cen is None else grad_cen.contiguous()
        d_ka, d_ke, d_kel = propagate_intervals_adjoint(*inputs, grad_gut, grad_cen)
        return d_ka, d_ke, d_kel, None, None, None
