"""The port's CUDA kernels and CUDA path, on the card.

Every test here needs a CUDA device and nvcc, and skips without them.
This file imports neither JAX nor the JAX package, so that it runs on a
machine that has only torch; there, skip tests/conftest.py (which sets up
JAX for the other tests):

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

The batched GMM EM of the adaptation boundary runs on the card in float64
and is held to the same code on the CPU; a short adapted run crosses its
boundaries on the card. The spectral clustering's two assignments run on
the card against the CPU, and a short clustered_autoblock run re-blocks
and assigns clusters on the card. A run interrupted at a boundary and
resumed from its checkpoint equals the uninterrupted run bit for bit on
the card, and the CLI's predict core on the card agrees with the CPU's.
The analytic targets and the PopPK models two, one_biphasic_uptake and
two_transit evaluate on the card as on the CPU, and so do the general-PK
likelihood (pharmaco_population), the single-patient PK likelihood
(through B1 and B2 at P = 1), the ODE template and the cell likelihoods
(incucyte_population with each of its four DDE solvers, whose solve makes
no host read; mitosis_time_estimation with the native matching against
scipy; cell_cycle_marker), and so do fISA (whose evaluation makes no host
read) and the R bridge, which runs on the card unless asked for the CPU.

Each kernel is held to its plain PyTorch version on the same inputs:
- B1: rtol 1e-5 in float32, 1e-12 in float64;
- B1T, B1's reverse mode: bit for bit in float32 and float64 on the lanes
  where both are finite, and the same finite set, with a degenerate lane,
  at 32,768 lanes, at K = 37 and at B*P not a multiple of 4; both
  wrappers refuse inputs that require grad outside
  the autograd Function, and the posterior's gradient on the card (through
  B1 and B1T) equals the CPU's; a short NUTS run launches both;
- B2 (float32): the kernel is built without FMA contraction and with the
  accurate exp/log/pow, and rounds like its plain version, so the two
  take the same step sequence: `ok` and the trip counts are equal on
  every lane, and central is bit-identical on the lanes that finish;
- B1 and B2 at one patient (P = 1, the single-patient likelihood's
  shape): bit for bit;
- B2J, the transit solve with its Jacobian (float32 and float64, one and
  two transit compartments): `ok` on every lane, the trip counts, the
  central amounts and the Jacobian within chip_smoke.py's B2J limits; at
  the edges of its launch plan (1 to 8,000 lanes, every number of lanes a
  producer warp, and a lane refill mid-launch at 100,000 lanes) bit for
  bit on the lanes that finish alike, float64 included (libdevice's
  float64 pow rounds as torch's only when built with contraction on,
  which is why build.py builds B2J so); the transit models' posterior
  gradient on the card (the gradient mode) equals the CPU's, and a short
  NUTS run launches B2J.

The sharded sampler in a one-rank NCCL group equals the unsharded run on
the card bit for bit. The sampler's overlapped emission gives the same
samples for every emit_chunk_size, dp5's fixed-trip form reads the host
never and equals the while form, and one HMC step and one VI step on the
transit models run through B2J to finite values.
"""

import numpy as np
import pytest
import torch

from bcm3_tpu_torch.ops.poppk_kernels import (
    PropagateOneCompartment,
    propagate_intervals_adjoint,
    propagate_intervals_adjoint_plain,
    propagate_intervals_one_compartment,
    propagate_intervals_plain,
)
from bcm3_tpu_torch.ops.transit_kernels import (
    PARAM_NAMES,
    transit_solve,
    transit_solve_plain,
)
from bcm3_tpu_torch.ops.transit_tangent_kernels import (
    LANES_PER_WARP,
    RATES,
    transit_jacobian,
    transit_jacobian_plain,
)

pytestmark = pytest.mark.gpu

_B2_KW = dict(trips=768, rtol=1e-6, atol=100.0 * 1e-6, min_dt=1e-5, first_dt=1e-2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are CUDA C++ built by nvcc)")
    return torch.device("cuda")


def _b1_inputs(B, P, K, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    ka = rng.uniform(0.05, 3.0, (B, P))
    ke = rng.uniform(1e-4, 0.1, (B, P))
    kel = rng.uniform(0.01, 0.5, (B, P))
    j = min(1, P - 1)
    kel[0, j] = ka[0, j] + ke[0, j]  # degenerate lane: ka + ke == kel
    dose = rng.uniform(50, 150, (P, K))
    dose[:, min(3, K - 1)] = 0.0  # a skipped dose
    args = (ka, ke, kel, rng.uniform(100, 200, P), rng.uniform(12, 24, P), dose)
    return [torch.as_tensor(a, dtype=dtype, device=device) for a in args]


def _b2_inputs(L, device, seed=0):
    """L lanes over 4 patients: a merged grid of 10 observations and 14
    daily doses (patient 1 skips one), parameters spread like the prior's.
    Every 50th lane is stiff (kel = 1e6 per hour): the explicit solver can
    follow it only with steps below min_dt, so it fails within a few trips.
    Returns the (L,) parameters, (P,) initial doses and (P, S) tables."""
    rng = np.random.default_rng(seed)
    P = 4
    obs = np.array([0.5, 1.0, 2.0, 4.0, 8.0, 12.0, 24.0, 96.0, 200.0, 300.0])
    doses = 24.0 * np.arange(1, 15)
    times = np.concatenate([obs, doses])
    order = np.argsort(times, kind="stable")
    amts = np.concatenate([np.zeros((P, len(obs))), np.full((P, len(doses)), 100.0)], 1)
    amts[1, len(obs) + 4] = 0.0
    n_transit = 10 ** rng.uniform(0.0, 1.0, L)
    params = {
        "ka": 10 ** rng.uniform(-1.0, 0.5, L),
        "ke": 10 ** rng.uniform(-4.0, -1.0, L),
        "kel": 10 ** rng.uniform(-2.0, -0.5, L),
        "k_transit": (n_transit + 1.0) / 10 ** rng.uniform(-1.0, 1.5, L),
        "n_transit": n_transit,
        "dose0": np.full(P, 100.0),
    }
    params["kel"][::50] = 1e6

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32, device=device)

    grid = np.tile(times[order], (P, 1))
    return {k: dev(params[k]) for k in PARAM_NAMES}, dev(grid), dev(amts[:, order])


def _b2_against_plain(params, grid, amt, **kw):
    """Kernel and plain version on the same inputs: one launch, the same
    `ok` and trip count on every lane, bit-identical central where a lane
    finishes, all NaN where it fails. Returns the plain (ok, trips) and
    the warp slots the kernel issued."""
    before = transit_solve.launches
    slots = torch.zeros(1, dtype=torch.int64, device=grid.device)
    c, ok, n = transit_solve(params, grid, amt, trip_counts=True, warp_slots=slots, **kw)
    torch.cuda.synchronize()
    assert transit_solve.launches == before + 1
    assert c.shape == (len(ok), grid.shape[1]) and c.is_cuda and n.dtype == torch.int32
    c_ref, ok_ref, n_ref = transit_solve_plain(params, grid, amt, trip_counts=True, **kw)
    assert torch.equal(ok, ok_ref)
    assert torch.equal(n, n_ref)
    assert torch.equal(c[ok], c_ref[ok])
    assert torch.isnan(c[~ok]).all()
    # every trip of every lane ran in some warp's trip slot
    assert 32 * int(slots) >= int(n.sum()) > 0
    return ok_ref, n_ref, int(slots)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_b1_kernel_matches_plain(cuda, dtype):
    args = _b1_inputs(B=1001, P=10, K=14, dtype=dtype, device=cuda)
    before = propagate_intervals_one_compartment.launches
    g, c = propagate_intervals_one_compartment(*args)
    torch.cuda.synchronize()
    assert propagate_intervals_one_compartment.launches == before + 1
    assert g.shape == (14, 1001, 10) and g.dtype == dtype and g.is_cuda
    g_ref, c_ref = propagate_intervals_plain(*args)
    rtol = 1e-5 if dtype == torch.float32 else 1e-12
    torch.testing.assert_close(g, g_ref, rtol=rtol, atol=rtol * 1e-3)
    torch.testing.assert_close(c, c_ref, rtol=rtol, atol=rtol * 1e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize(
    "B, P, K",
    [
        (1001, 10, 14),  # B*P = 10,010: rows of the (K, B*P) gradients not 16-byte aligned
        (2048, 16, 14),  # the NUTS and HMC paths' width: 32,768 lanes
        (257, 5, 37),  # K beyond two double-buffered chunks; a ragged last block
        (333, 3, 1),  # one interval: the gradients are 0
    ],
)
def test_b1t_kernel_matches_plain(cuda, dtype, B, P, K):
    """Bit for bit on the lanes where both are finite, and the same finite
    set: the kernel recomputes B1's states and carries the tangents in the
    plain version's order of operations, without FMA contraction."""
    args = _b1_inputs(B=B, P=P, K=K, dtype=dtype, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    grads = [torch.randn((K, B, P), generator=gen, dtype=dtype, device=cuda) for _ in range(2)]
    ins = (*args, *grads)
    before = propagate_intervals_adjoint.launches
    got = propagate_intervals_adjoint(*ins)
    torch.cuda.synchronize()
    assert propagate_intervals_adjoint.launches == before + 1
    ref = propagate_intervals_adjoint_plain(*ins)
    for g, r in zip(got, ref):
        assert g.shape == (B, P) and g.dtype == dtype and g.is_cuda
        fin = torch.isfinite(r)
        assert torch.equal(torch.isfinite(g), fin)
        assert fin.double().mean().item() > 0.99
        assert torch.equal(g[fin], r[fin])


def test_kernels_refuse_inputs_that_require_grad(cuda):
    """The kernels write their outputs through raw pointers: on an input
    that requires grad they raise instead of returning outputs autograd
    would take for constants. Through the autograd Function B1 is
    differentiable, and its gradient is B1T's."""
    args = _b1_inputs(B=8, P=3, K=5, dtype=torch.float64, device=cuda)
    ka = args[0].clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="requires grad"):
        propagate_intervals_one_compartment(ka, *args[1:])
    params, grid, amt = _b2_inputs(64, cuda)
    params["ka"].requires_grad_(True)
    with pytest.raises(RuntimeError, match="requires grad"):
        transit_solve(params, grid, amt, **_B2_KW)
    gut, cen = PropagateOneCompartment.apply(ka, *args[1:])
    (d_ka,) = torch.autograd.grad((gut.sum() + cen.sum()), [ka])
    ka_cpu = args[0].cpu().requires_grad_(True)
    g_cpu, c_cpu = propagate_intervals_plain(ka_cpu, *(a.cpu() for a in args[1:]))
    (ref,) = torch.autograd.grad(g_cpu.sum() + c_cpu.sum(), [ka_cpu])
    torch.testing.assert_close(d_ka.cpu(), ref, rtol=1e-12, atol=1e-12)


def test_gradient_samplers_on_the_card(cuda, tmp_path):
    """PopPK `one` on the card: the posterior's value and gradient in z
    (float64, through B1 and B1T) equal the CPU's (plain versions), and a
    short NUTS run launches B1 and B1T and emits finite rows."""
    from bcm3_tpu_torch import Prior, VariableSet
    from bcm3_tpu_torch.likelihoods import Likelihood
    from bcm3_tpu_torch.likelihoods.poppk import PopPKLikelihood
    from bcm3_tpu_torch.likelihoods.poppk_synth import synthesize_trial, write_poppk_prior_xml
    from bcm3_tpu_torch.sampler import NUTSConfig, SamplerNUTS
    from bcm3_tpu_torch.sampler.hmc import LogPosterior

    P = 6
    path = str(tmp_path / "prior.xml")
    write_poppk_prior_xml(path, P, "one")
    vs = VariableSet.from_xml(path)
    prior = Prior.from_xml(path, vs)
    trial, _ = synthesize_trial(num_patients=P, num_timepoints=12, seed=3)
    pk = PopPKLikelihood(vs, trial, "one", "lapatinib")
    lik = Likelihood("pop_pk_trajectory", pk.log_prob_batched, model=pk)
    target = LogPosterior(prior, lik)
    z = target.reparam.from_x(prior.sample(torch.Generator().manual_seed(1), (64,)))
    v_cpu, g_cpu = target.value_and_grad(z)
    before = propagate_intervals_adjoint.launches
    v, g = target.value_and_grad(z.to(cuda))
    assert propagate_intervals_adjoint.launches == before + 1
    fin = torch.isfinite(v_cpu)
    assert fin.sum().item() >= 16
    torch.testing.assert_close(v.cpu(), v_cpu, rtol=1e-10, atol=0)
    torch.testing.assert_close(g.cpu()[fin], g_cpu[fin], rtol=1e-8, atol=1e-8)

    b1, b1t = propagate_intervals_one_compartment.launches, propagate_intervals_adjoint.launches
    cfg = NUTSConfig(num_samples=3, num_warmup=4, num_chains=32, max_tree_depth=4, seed=2,
                     device="cuda", dtype=torch.float32)
    res = SamplerNUTS(prior, lik, cfg).run()
    assert propagate_intervals_one_compartment.launches > b1
    assert propagate_intervals_adjoint.launches > b1t
    assert res["samples"].shape == (3 * 32, 1, vs.num_variables)
    assert np.isfinite(res["samples"]).all()


def test_b2_kernel_matches_plain(cuda):
    """4,000 lanes (not a multiple of 32 or of the block) that end every
    way a lane can: finished, failed for dt <= min_dt, failed for the
    budget; with dose events and a skipped dose."""
    params, grid, amt = _b2_inputs(4000, cuda, seed=5)
    ok, n, _ = _b2_against_plain(params, grid, amt, **_B2_KW)
    S, trips = grid.shape[1], _B2_KW["trips"]
    # the early exit ends a budget failure at most S - 2 trips early
    budget = ~ok & (n >= trips - (S - 2))
    early = ~ok & (n < trips - (S - 2))
    assert ok.sum().item() > 3000
    assert early[::50].all()  # the stiff lanes
    assert budget.sum().item() >= 10


def _b2j_inputs(L, n_states, dtype, device, seed=0):
    """B2's lanes and tables (`_b2_inputs`) in dtype, the stops of its ten
    observations, and for n_states = 3 periphery rates spread like the
    prior's."""
    params, grid, amt = _b2_inputs(L, device, seed)
    rng = np.random.default_rng(seed + 1)
    rates = {k: params[k].to(dtype) for k in RATES[:5]}
    if n_states == 3:
        for k in ("kpf", "kpb"):
            rates[k] = torch.as_tensor(10 ** rng.uniform(-3.0, 0.0, L), dtype=dtype, device=device)
    obs = np.array([0.5, 1.0, 2.0, 4.0, 8.0, 12.0, 24.0, 96.0, 200.0, 300.0])
    g = grid.cpu().numpy().astype(np.float64)
    # an observation comes before a dose at the same time (the stable sort)
    pos = np.stack([np.searchsorted(row, obs, side="left") for row in g])
    tables = dict(grid=grid.to(dtype), amt=amt.to(dtype), dose0=params["dose0"].to(dtype),
                  obs_pos=torch.as_tensor(pos, dtype=torch.int64, device=device))
    return rates, tables


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n_states", [2, 3])
def test_b2j_kernel_matches_plain(cuda, n_states, dtype):
    """B2J against its plain version on 4,000 lanes that end every way a
    lane can (B2's inputs): one launch, `ok` on every lane, the trip counts
    on the lanes that finish (at most 1% may differ: the kernel sums the
    mean square of the errors in torch's order on the card, and a last
    bit can still move a step), and on the others the central amounts
    within 1e-4 (float32) or 1e-10 (float64) of the lane's largest and the
    Jacobian within 1e-3 or 1e-8 of the largest entry of its lane and rate,
    with the same non-finite entries; failed lanes NaN, with a zero
    Jacobian (chip_smoke.py's B2J limits)."""
    rates, tables = _b2j_inputs(4000, n_states, dtype, cuda, seed=5)
    before = transit_jacobian.launches
    c, jac, ok, n = transit_jacobian(rates, **tables, **_B2_KW, trip_counts=True)
    torch.cuda.synchronize()
    assert transit_jacobian.launches == before + 1
    assert jac.shape == (4000, 10, 5 if n_states == 2 else 7) and jac.is_cuda
    cp, jp, okp, n_p = transit_jacobian_plain(rates, **tables, **_B2_KW, trip_counts=True)
    assert torch.equal(ok, okp) and ok.sum().item() > 3000
    assert torch.isnan(c[~ok]).all() and (jac[~ok] == 0).all()
    same = ok & (n == n_p)
    assert (ok & ~same).sum().item() <= 0.01 * ok.sum().item()
    vtol, jtol = (1e-4, 1e-3) if dtype == torch.float32 else (1e-10, 1e-8)
    peak = cp[same].abs().amax(dim=1, keepdim=True)
    assert ((c[same] - cp[same]).abs() <= vtol * peak).all()
    fin = torch.isfinite(jp[same])
    assert torch.equal(fin, torch.isfinite(jac[same]))
    scale = torch.where(fin, jp[same].abs(), 0.0).amax(dim=1, keepdim=True)
    err = torch.where(fin, (jac[same] - jp[same]).abs(), 0.0)
    assert (err <= jtol * scale).all()


def _b2j_lanes(L, n_states, dtype, device, seed):
    """`_b2j_inputs` at any L: B2's four patients where they divide L, else
    the first patient's tables for every lane."""
    rates, tables = _b2j_inputs(L + 1, n_states, dtype, device, seed)
    # from lane 1 on: lane 0 is one of the stiff lanes
    rates = {k: v[1:].contiguous() for k, v in rates.items()}
    if L % 4:
        tables = {k: v[:1].contiguous() for k, v in tables.items()}
    return rates, tables


def _b2j_bit_for_bit(rates, tables, **extra):
    """B2J against its plain version: one launch, `ok` on every lane, failed
    lanes NaN with a zero Jacobian, at most 1% of the finishing lanes with
    another trip count (test_b2j_kernel_matches_plain's limits), and on
    the lanes that finish alike the central amounts and the Jacobian bit
    for bit, with the same non-finite entries. Returns the trip counts."""
    before = transit_jacobian.launches
    c, jac, ok, n = transit_jacobian(rates, **tables, **_B2_KW, trip_counts=True, **extra)
    torch.cuda.synchronize()
    assert transit_jacobian.launches == before + 1
    cp, jp, okp, n_p = transit_jacobian_plain(rates, **tables, **_B2_KW, trip_counts=True)
    assert torch.equal(ok, okp)
    assert torch.isnan(c[~ok]).all() and (jac[~ok] == 0).all()
    same = ok & (n == n_p)
    assert (ok & ~same).sum().item() <= 0.01 * ok.sum().item()
    fin = torch.isfinite(jp[same])
    assert torch.equal(fin, torch.isfinite(jac[same]))
    assert torch.equal(c[same], cp[same])
    assert torch.equal(jac[same][fin], jp[same][fin])
    return n


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n_states", [2, 3])
def test_b2j_launch_plans_match_plain(cuda, n_states, dtype):
    """B2J's warp-specialised kernel at the edges of its launch plan: 1,
    31, 33, 1,000, 1,024, 4,000 and 8,000 lanes, which give every number
    of lanes a producer warp the plan chooses (8 up to 2,112 lanes on 132
    SMs, 16, 32), producer warps with idle threads and lanes that are not
    a multiple of the warp; each against the plain version, bit for bit on
    the lanes that finish alike."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    widths = {}
    for L in (1, 31, 33, 1000, 1024, 4000, 8000):
        rates, tables = _b2j_lanes(L, n_states, dtype, cuda, seed=L)
        _b2j_bit_for_bit(rates, tables)
        plan = transit_jacobian.last_plan
        if L <= 1024:
            assert plan["blocks"] >= min(sms, -(-L // 8))
        widths.setdefault(plan["lanes_per_warp"], L)
    if sms == 132:
        assert sorted(widths) == sorted(LANES_PER_WARP)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n_states", [2, 3])
def test_b2j_kernel_refills_lanes(cuda, n_states, dtype):
    """More lanes than the resident blocks' producer threads (100,000
    lanes): a producer thread whose lane ends takes the next, and its
    consumer threads follow, mid-launch; bit for bit with the plain
    version, every trip in a producer warp's record, and fewer records
    than warps of 32 fixed lanes would write."""
    rates, tables = _b2j_lanes(100_000, n_states, dtype, cuda, seed=11)
    slots = torch.zeros(1, dtype=torch.int64, device=cuda)
    n = _b2j_bit_for_bit(rates, tables, warp_slots=slots)
    plan = transit_jacobian.last_plan
    assert plan["blocks"] * plan["lanes_per_warp"] < 100_000
    assert plan["lanes_per_warp"] * int(slots) >= int(n.long().sum()) > 0
    static = n.reshape(-1, 32).amax(dim=1).long().sum().item()
    assert int(slots) < static


def test_float64_pow_rounds_as_torch_with_contraction(cuda, tmp_path):
    """Why build.py compiles B2J with contraction on (CONTRACTED): libdevice's
    float64 pow, which B2J's step-size controller calls, agrees with
    torch's pow on the card bit for bit only when compiled as torch's
    kernels are, with --fmad=true (under --fmad=false a few inputs in a
    million round otherwise). Prints the mismatches of both builds on 2^22
    inputs spread over 30 decades."""
    import ctypes
    import subprocess

    from bcm3_tpu_torch.ops import build

    src = tmp_path / "pow.cu"
    src.write_text(
        "__global__ void k(const double* x, double* o, int n) {\n"
        "  int i = blockIdx.x * blockDim.x + threadIdx.x;\n"
        "  if (i < n) { o[2 * i] = pow(x[i], -0.2); o[2 * i + 1] = pow(x[i], -1.2); }\n"
        "}\n"
        'extern "C" void run(const void* x, void* o, int n) {\n'
        "  k<<<(n + 255) / 256, 256>>>((const double*)x, (double*)o, n);\n"
        "}\n")
    n = 1 << 22
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.exp(torch.empty(n, dtype=torch.float64, device=cuda).uniform_(-60, 10, generator=g))
    ref = torch.stack([x**-0.2, x**-1.2], dim=1)
    mismatches = {}
    for fmad in ("false", "true"):
        lib = tmp_path / f"pow_{fmad}.so"
        subprocess.run([build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                        f"--fmad={fmad}", "-Xcompiler", "-fPIC", "-shared", "-o", str(lib),
                        str(src)], check=True, timeout=300)
        run = ctypes.CDLL(str(lib)).run
        run.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
        out = torch.empty_like(ref)
        run(x.data_ptr(), out.data_ptr(), n)
        torch.cuda.synchronize()
        mismatches[fmad] = (out != ref).sum(dim=0).tolist()
    print(f"float64 pow(x, -0.2), pow(x, -1.2): values of {n} that differ from torch's, by "
          f"--fmad: {mismatches}")
    assert mismatches["true"] == [0, 0]


def test_transit_gradient_on_the_card(cuda, tmp_path):
    """Both transit models on the card in the gradient mode (B2J): the
    posterior's value and gradient in z in float64 equal the CPU's (its
    plain version), and a short NUTS run in float32 launches B2J and emits
    finite rows."""
    from bcm3_tpu_torch import Prior, VariableSet
    from bcm3_tpu_torch.likelihoods import Likelihood
    from bcm3_tpu_torch.likelihoods.poppk import PopPKLikelihood
    from bcm3_tpu_torch.likelihoods.poppk_synth import synthesize_trial, write_poppk_prior_xml
    from bcm3_tpu_torch.sampler import NUTSConfig, SamplerNUTS
    from bcm3_tpu_torch.sampler.hmc import LogPosterior

    P = 4
    for pk_type in ("one_transit", "two_transit"):
        path = str(tmp_path / f"prior_{pk_type}.xml")
        write_poppk_prior_xml(path, P, pk_type)
        vs = VariableSet.from_xml(path)
        prior = Prior.from_xml(path, vs)
        trial, _ = synthesize_trial(num_patients=P, num_timepoints=8, seed=3)
        pk = PopPKLikelihood(vs, trial, pk_type, "lapatinib")
        lik = Likelihood("pop_pk_trajectory", pk.log_prob_batched, model=pk)
        target = LogPosterior(prior, lik)
        z = target.reparam.from_x(prior.sample(torch.Generator().manual_seed(1), (16,)))
        v_cpu, g_cpu = target.value_and_grad(z)
        before = transit_jacobian.launches
        v, g = target.value_and_grad(z.to(cuda))
        assert transit_jacobian.launches == before + 1
        fin = torch.isfinite(v_cpu)
        assert fin.sum().item() >= 4 and torch.equal(torch.isfinite(v.cpu()), fin)
        torch.testing.assert_close(v.cpu()[fin], v_cpu[fin], rtol=1e-10, atol=0)
        scale = g_cpu[fin].abs().amax(dim=1, keepdim=True)
        torch.testing.assert_close(g.cpu()[fin] / scale, g_cpu[fin] / scale, rtol=1e-6,
                                   atol=1e-6)
        before = transit_jacobian.launches
        cfg = NUTSConfig(num_samples=2, num_warmup=2, num_chains=32, max_tree_depth=3, seed=2,
                         device="cuda", dtype=torch.float32)
        res = SamplerNUTS(prior, lik, cfg).run()
        assert transit_jacobian.launches > before
        assert res["samples"].shape == (2 * 32, 1, vs.num_variables)
        assert np.isfinite(res["samples"]).all()


@pytest.mark.parametrize("L", [4, 100])
def test_b2_kernel_with_fewer_lanes_than_threads(cuda, L):
    """Fewer lanes than one block's threads: most threads never get a lane."""
    _b2_against_plain(*_b2_inputs(L, cuda, seed=L), **_B2_KW)


def test_b2_kernel_refills_lanes(cuda):
    """More lanes than an H100 holds threads at once (132 SMs x 2,048), so
    threads take new lanes as theirs end; which thread runs a lane changes
    nothing in it."""
    params, grid, amt = _b2_inputs(300_000, cuda, seed=9)
    ok, n, slots = _b2_against_plain(params, grid, amt, **_B2_KW)
    assert ok.sum().item() > 200_000
    # refill: the warps issued fewer slots than the lanes' own trips would
    # take in static warps of 32 lanes
    static = n.reshape(-1, 32).amax(dim=1).sum().item()
    assert slots < static


def test_wrappers_check_their_inputs(cuda):
    params, grid, amt = _b2_inputs(64, cuda)
    with pytest.raises(ValueError, match="float32"):
        transit_solve(params, grid.double(), amt, **_B2_KW)
    with pytest.raises(ValueError, match="contiguous"):
        transit_solve(params, grid.t().contiguous().t(), amt, **_B2_KW)
    odd = {k: (v if k == "dose0" else v[:63]) for k, v in params.items()}
    with pytest.raises(ValueError, match="split evenly"):
        transit_solve(odd, grid, amt, **_B2_KW)
    with pytest.raises(ValueError, match="warp_slots"):
        transit_solve(params, grid, amt, warp_slots=torch.zeros(1, device=cuda), **_B2_KW)
    # (P, S) tables beyond a block's shared memory: the launcher refuses
    # them, and the next launch is unaffected
    wide = torch.zeros((grid.shape[0], 40_000), dtype=torch.float32, device=cuda)
    with pytest.raises(RuntimeError, match="transit_dp5"):
        transit_solve(params, wide, wide, **_B2_KW)
    _b2_against_plain(params, grid, amt, **_B2_KW)
    args = _b1_inputs(B=4, P=3, K=5, dtype=torch.float32, device=cuda)
    with pytest.raises(ValueError, match="shape"):
        propagate_intervals_one_compartment(*args[:5], args[5][:, :2].T.contiguous())
    with pytest.raises(ValueError, match="CUDA"):
        propagate_intervals_one_compartment(*args[:3], args[3].cpu(), *args[4:])
    grad = torch.zeros((5, 4, 3), device=cuda)
    with pytest.raises(ValueError, match="grad_cen"):
        propagate_intervals_adjoint(*args, grad, grad[:, :3].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        propagate_intervals_adjoint(*args, grad, grad.transpose(1, 2).contiguous().transpose(1, 2))


@pytest.mark.parametrize("pk_type", ["one", "one_transit"])
def test_sampler_runs_through_the_kernels(cuda, tmp_path, pk_type):
    """A short SamplerPT run on the card launches the model's kernel and
    emits finite samples; the card's log-likelihoods agree with the CPU's."""
    from bcm3_tpu_torch import Prior, VariableSet
    from bcm3_tpu_torch.likelihoods import Likelihood
    from bcm3_tpu_torch.likelihoods.poppk import PopPKLikelihood
    from bcm3_tpu_torch.likelihoods.poppk_synth import synthesize_trial, write_poppk_prior_xml
    from bcm3_tpu_torch.sampler import PTConfig, SamplerPT

    P = 6
    path = str(tmp_path / "prior.xml")
    write_poppk_prior_xml(path, P, pk_type)
    vs = VariableSet.from_xml(path)
    prior = Prior.from_xml(path, vs)
    trial, _ = synthesize_trial(num_patients=P, num_timepoints=12, seed=3)
    pk = PopPKLikelihood(vs, trial, pk_type, "lapatinib")
    lik = Likelihood("pop_pk_trajectory", pk.log_prob_batched, model=pk)
    counter = (
        propagate_intervals_one_compartment if pk_type == "one" else transit_solve
    )
    before = counter.launches
    cfg = PTConfig(
        num_samples=3, use_every_nth=2, num_chains=4, num_ensembles=32,
        adapt_proposal_samples=0, adapt_proposal_times=0, emit_fixed_only=True,
        seed=2, device="cuda", dtype=torch.float32,
    )
    res = SamplerPT(prior, lik, cfg).run()
    assert counter.launches > before
    assert res["samples"].shape == (3 * 32, 1, vs.num_variables)
    assert np.isfinite(res["log_prior"] + res["log_likelihood"]).all()

    xs = prior.sample(torch.Generator().manual_seed(1), (64,), torch.float64)
    cpu = lik.log_prob_batched(xs)
    card = lik.log_prob_batched(xs.to(cuda, torch.float32)).double().cpu()
    fin = torch.isfinite(cpu) & torch.isfinite(card)
    assert fin.sum().item() >= 8
    rel = (card[fin] - cpu[fin]).abs() / cpu[fin].abs()
    # rows whose rates overflow float32 (ka = 10^(mu + sigma * ndtri(u))
    # with a heavy-tailed sigma) are -inf on the card and may be finite in
    # float64: compare finite sets on the others
    params, _, _ = pk._patient_params(xs)
    fits = torch.ones(64, dtype=torch.bool)
    for v in params.values():
        fits &= (v.reshape(64, -1).abs() < torch.finfo(torch.float32).max).all(dim=1)
    flips = (torch.isfinite(cpu) != torch.isfinite(card))[fits].sum().item()
    if pk_type == "one":  # float32 on the card against float64
        assert flips == 0 and rel.max().item() <= 1e-3
    else:
        # both float32 solves, with the card's and the CPU's exp/log: a
        # small share of lanes takes another adaptive step sequence
        assert flips <= 3 and (rel <= 5e-3).double().mean().item() >= 0.95


def _clusters(seed, n=800, D=12):
    """Three Gaussian clusters with a shared full covariance shape."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(0.0, 3.0, (3, D))
    shape = np.eye(D) + 0.3 * rng.normal(size=(D, D))
    return centers[rng.integers(0, 3, n)] + rng.normal(size=(n, D)) @ shape


def test_device_em_matches_cpu(cuda):
    """The batched EM on the card against the same code on the CPU, both
    float64 from the same k-means++ starts. A fit may take another course
    (stop step, flags) only where it met the singular test's edge, where
    eigh's rounding decides the test; every fit of the same course agrees
    within rtol 1e-6 (atol 1e-6 of each array's largest entry), and every
    history none of whose fits took another course selects the same
    component count."""
    from bcm3_tpu_torch.stats import gmm_device as gd

    hs = [_clusters(s) for s in (1, 2, 3)]
    metas, candidates, fits, fit_meta = gd._prepare_fits(hs, np.random.default_rng(4))
    assert fits
    card = gd._run_fits(metas, fits, fit_meta, cuda)
    cpu = gd._run_fits(metas, fits, fit_meta, "cpu")
    differs = np.zeros(len(fits), dtype=bool)
    for f in ("converged", "singular", "steps"):
        differs |= card[f] != cpu[f]
    assert not (differs & (np.minimum(card["edge"], cpu["edge"]) >= 1e3)).any()
    for f in ("means", "covs", "weights", "logl"):
        x, y = card[f][~differs], cpu[f][~differs]
        np.testing.assert_allclose(x, y, rtol=1e-6, atol=1e-6 * np.abs(y).max(), err_msg=f)
    sel = [gd._select_fits(metas, candidates, fit_meta, r, False) for r in (card, cpu)]
    pos = np.asarray([p for p, _ in fit_meta])
    for p in range(len(hs)):
        if not differs[pos == p].any():
            assert sel[0][p].num_components == sel[1][p].num_components


def test_adapted_run_on_the_card(cuda, tmp_path):
    """A short PopPK `one` run with two adaptations, the batched EM on the
    card: both boundaries in the first run(), none in the second, finite
    samples and adapted proposals, and B1 launched."""
    from bcm3_tpu_torch import Prior, VariableSet
    from bcm3_tpu_torch.likelihoods import Likelihood
    from bcm3_tpu_torch.likelihoods.poppk import PopPKLikelihood
    from bcm3_tpu_torch.likelihoods.poppk_synth import synthesize_trial, write_poppk_prior_xml
    from bcm3_tpu_torch.sampler import PTConfig, SamplerPT

    P = 6
    path = str(tmp_path / "prior.xml")
    write_poppk_prior_xml(path, P, "one")
    vs = VariableSet.from_xml(path)
    prior = Prior.from_xml(path, vs)
    trial, _ = synthesize_trial(num_patients=P, num_timepoints=12, seed=3)
    pk = PopPKLikelihood(vs, trial, "one", "lapatinib")
    lik = Likelihood("pop_pk_trajectory", pk.log_prob_batched, model=pk)
    before = propagate_intervals_one_compartment.launches
    cfg = PTConfig(
        num_samples=12, use_every_nth=2, num_chains=4, num_ensembles=64,
        adapt_proposal_samples=4, adapt_proposal_times=2, emit_fixed_only=True,
        gmm_fit_backend="device", seed=5, device="cuda", dtype=torch.float32,
    )
    sampler = SamplerPT(prior, lik, cfg)
    res = sampler.run()
    assert res["adaptation_boundaries"] == 2
    assert propagate_intervals_one_compartment.launches > before
    for p in sampler.proposals:
        assert p.means.is_cuda and torch.isfinite(p.means).all() and torch.isfinite(p.chols).all()
    assert max(p.max_components for p in sampler.proposals) > 1
    again = sampler.run()
    assert again["adaptation_boundaries"] == 0
    for r in (res, again):
        assert r["samples"].shape == (12 * 64, 1, vs.num_variables)
        assert np.isfinite(r["log_prior"] + r["log_likelihood"]).all()


def test_assignments_on_the_card_match_cpu(cuda):
    """A spectral clustering fitted on the host, its assignments on the
    card against the same assigner on the CPU, float64: labels apart only
    where the CPU's two best centroid scores are within 1e-9 (relative)."""
    from bcm3_tpu_torch.sampler import spectral

    hist = _clusters(6, n=3000)
    card = spectral.fit_spectral_clustering(hist, 3, 7, 3, 1000, np.random.default_rng(1), cuda)
    cpu = card.to("cpu")
    assert card.scaled_samples.is_cuda and card.num_clusters == 3
    queries = torch.as_tensor(_clusters(7, n=20_000))
    for scores in (spectral.batch_scores, spectral.history_scores):
        got = scores(card, queries.to(cuda)).cpu()
        ref = scores(cpu, queries)
        apart = got.argmax(-1) != ref.argmax(-1)
        top2 = torch.topk(ref, 2, dim=-1).values
        margin = (top2[:, 0] - top2[:, 1]) / top2[:, 0].abs()
        assert (margin[apart] < 1e-9).all(), scores.__name__
        torch.testing.assert_close(got, ref, rtol=1e-9, atol=1e-12)
    # chunks of rows change no label
    torch.testing.assert_close(
        spectral.assign_batch(card, queries.to(cuda), max_bytes=1 << 24),
        spectral.assign_batch(card, queries.to(cuda)),
    )


def test_clustered_autoblock_run_on_the_card(cuda, tmp_path):
    """A short PopPK `one` run with clustered proposals and
    clustered_autoblock: it starts with one block per variable, each
    boundary clusters the pooled T=1 history on the card and re-blocks;
    finite samples, clustered proposals, B1 launched."""
    from bcm3_tpu_torch import Prior, VariableSet
    from bcm3_tpu_torch.likelihoods import Likelihood
    from bcm3_tpu_torch.likelihoods.poppk import PopPKLikelihood
    from bcm3_tpu_torch.likelihoods.poppk_synth import synthesize_trial, write_poppk_prior_xml
    from bcm3_tpu_torch.sampler import PTConfig, SamplerPT

    P = 4
    path = str(tmp_path / "prior.xml")
    write_poppk_prior_xml(path, P, "one")
    vs = VariableSet.from_xml(path)
    prior = Prior.from_xml(path, vs)
    trial, _ = synthesize_trial(num_patients=P, num_timepoints=12, seed=3)
    pk = PopPKLikelihood(vs, trial, "one", "lapatinib")
    lik = Likelihood("pop_pk_trajectory", pk.log_prob_batched, model=pk)
    before = propagate_intervals_one_compartment.launches
    cfg = PTConfig(
        num_samples=15, use_every_nth=2, num_chains=4, num_ensembles=256,
        adapt_proposal_samples=5, adapt_proposal_times=2, emit_fixed_only=True,
        proposal_type="clustered_covariance", blocking_strategy="clustered_autoblock",
        seed=5, device="cuda", dtype=torch.float32,
    )
    sampler = SamplerPT(prior, lik, cfg)
    assert len(sampler.blocks) == vs.num_variables
    res = sampler.run()
    assert res["adaptation_boundaries"] == 2
    assert propagate_intervals_one_compartment.launches > before
    for b in res["adaptation_breakdown"]:
        assert sum(b["block_sizes"]) == vs.num_variables and min(b["cluster_sizes"]) >= 0
    assert sampler._assigner is not None and sampler._assigner.centroids.is_cuda
    assert all(p.clustered and p.means.is_cuda for p in sampler.proposals)
    assert np.isfinite(res["log_prior"] + res["log_likelihood"]).all()
    assert res["samples"].shape == (15 * 256, 1, vs.num_variables)


def _card_model(tmp_path, pk_type, P=4):
    """A prior from its XML and the likelihood over an in-memory trial."""
    from bcm3_tpu_torch import Prior, VariableSet
    from bcm3_tpu_torch.likelihoods import Likelihood
    from bcm3_tpu_torch.likelihoods.poppk import PopPKLikelihood
    from bcm3_tpu_torch.likelihoods.poppk_synth import synthesize_trial, write_poppk_prior_xml

    path = str(tmp_path / f"prior_{pk_type}.xml")
    write_poppk_prior_xml(path, P, pk_type)
    vs = VariableSet.from_xml(path)
    trial, _ = synthesize_trial(num_patients=P, num_timepoints=12, seed=3)
    pk = PopPKLikelihood(vs, trial, pk_type, "lapatinib")
    return Prior.from_xml(path, vs), Likelihood("pop_pk_trajectory", pk.log_prob_batched, model=pk)


@pytest.mark.parametrize("proposal_type", ["global_covariance", "clustered_covariance"])
def test_resume_is_identical_on_the_card(cuda, tmp_path, proposal_type):
    """A run interrupted at its first boundary and resumed from the
    checkpoint equals the uninterrupted run bit for bit on the card: the
    device generator's Philox state, the CPU choice generator and the host
    RNG come back with the state."""
    from bcm3_tpu_torch.sampler import PTConfig, SamplerPT

    model = _card_model(tmp_path, "one")
    common = dict(
        num_samples=12, use_every_nth=2, num_chains=4, num_ensembles=64,
        adapt_proposal_samples=4, adapt_proposal_times=2, emit_fixed_only=True,
        proposal_type=proposal_type, seed=5, device="cuda", dtype=torch.float32,
    )
    ck = str(tmp_path / "state.ckpt")
    full = SamplerPT(*model, PTConfig(**common)).run()
    part1 = SamplerPT(*model, PTConfig(**dict(common, num_samples=4, checkpoint_file=ck))).run()
    part2 = SamplerPT(*model, PTConfig(**dict(common, checkpoint_file=ck))).run()
    assert part2["adaptation_boundaries"] == 2
    for k in ("samples", "log_prior", "log_likelihood"):
        np.testing.assert_array_equal(np.concatenate([part1[k], part2[k]]), full[k], err_msg=k)
    for k, v in full["acceptance"].items():
        np.testing.assert_array_equal(part2["acceptance"][k], v, err_msg=k)


@pytest.mark.parametrize("pk_type", ["one", "one_transit"])
def test_predict_core_on_the_card_matches_cpu(cuda, tmp_path, pk_type):
    """The CLI's predict core over stored samples: on the card (float32,
    the kernel) against the CPU (float64, the plain version), on the
    second half's rows only, to the card-vs-CPU tolerances of
    test_sampler_runs_through_the_kernels."""
    from bcm3_tpu_torch import cli
    from bcm3_tpu_torch.io.config import load_options
    from bcm3_tpu_torch.io.output import NC_FILL_DOUBLE

    prior, lik = _card_model(tmp_path, pk_type)
    S, C = 40, 2
    xs = prior.sample(torch.Generator().manual_seed(7), (S * C,), torch.float64)
    samples = xs.reshape(S, C, -1).numpy()
    counter = propagate_intervals_one_compartment if pk_type == "one" else transit_solve
    before = counter.launches
    card, n_card, _ = cli.predict_core(load_options(None, {}), lik, samples)
    assert counter.launches > before and n_card == S // 2 * C
    cpu, _, _ = cli.predict_core(load_options(None, {"device": "cpu", "dtype": "float64"}),
                                 lik, samples)
    assert (card[: S // 2] == NC_FILL_DOUBLE).all() and (cpu[: S // 2] == NC_FILL_DOUBLE).all()
    card, cpu = card[S // 2:].reshape(-1), cpu[S // 2:].reshape(-1)
    fin = np.isfinite(card) & np.isfinite(cpu)
    assert fin.sum() >= 8
    rel = np.abs(card[fin] - cpu[fin]) / np.abs(cpu[fin])
    if pk_type == "one":
        assert rel.max() <= 1e-3
    else:
        assert (rel <= 5e-3).mean() >= 0.95


@pytest.mark.parametrize(
    "example", ["banana", "multimodal_circular_ridge", "multimodal_gaussians", "truncated_t"]
)
def test_analytic_likelihoods_on_the_card_match_cpu(cuda, example):
    """The analytic fixtures' likelihoods on the card against the CPU on the
    same prior draws: float64 to rtol 1e-12, float32 to rtol 1e-5 (atol
    1e-4 for values near 0)."""
    import os

    from bcm3_tpu_torch import Prior, VariableSet, create_likelihood

    d = os.path.join(os.path.dirname(__file__), "fixtures", "examples", example)
    vs = VariableSet.from_xml(os.path.join(d, "prior.xml"))
    prior = Prior.from_xml(os.path.join(d, "prior.xml"), vs)
    lik = create_likelihood(os.path.join(d, "likelihood.xml"), vs)
    xs = prior.sample(torch.Generator().manual_seed(3), (4096,), torch.float64)
    cpu = lik.log_prob_batched(xs)
    card64 = lik.log_prob_batched(xs.to(cuda)).cpu()
    card32 = lik.log_prob_batched(xs.to(cuda, torch.float32)).cpu().double()
    assert torch.isfinite(cpu).all()
    torch.testing.assert_close(card64, cpu, rtol=1e-12, atol=0.0)
    torch.testing.assert_close(card32, cpu, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("pk_type", ["two", "one_biphasic_uptake", "two_transit"])
def test_other_pk_models_on_the_card_match_cpu(cuda, tmp_path, pk_type):
    """`two`, the biphasic model and `two_transit` on the card: float64
    against the CPU's float64 (closed form to rtol 1e-10, the DP5 solve to
    1e-8 with the same finite rows), and the closed-form models in float32
    against float64 to rtol 1e-3 on the rows finite in both."""
    prior, lik = _card_model(tmp_path, pk_type)
    xs = prior.sample(torch.Generator().manual_seed(9), (64,), torch.float64)
    cpu = lik.log_prob_batched(xs)
    card = lik.log_prob_batched(xs.to(cuda)).cpu()
    assert torch.equal(torch.isfinite(card), torch.isfinite(cpu))
    assert torch.isfinite(cpu).sum() >= 16
    fin = torch.isfinite(cpu)
    rtol = 1e-8 if pk_type == "two_transit" else 1e-10
    torch.testing.assert_close(card[fin], cpu[fin], rtol=rtol, atol=0.0)
    if pk_type != "two_transit":
        card32 = lik.log_prob_batched(xs.to(cuda, torch.float32)).cpu().double()
        both = fin & torch.isfinite(card32)
        assert both.sum() >= 16
        torch.testing.assert_close(card32[both], cpu[both], rtol=1e-3, atol=0.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernels_at_one_patient_match_plain_bit_for_bit(cuda, dtype):
    """B1 and B2 with P = 1 (every lane the same patient): bit for bit
    against their plain versions, with the same finite set."""
    args = _b1_inputs(B=4001, P=1, K=14, dtype=dtype, device=cuda)
    g, c = propagate_intervals_one_compartment(*args)
    g_ref, c_ref = propagate_intervals_plain(*args)
    for got, ref in ((g, g_ref), (c, c_ref)):
        assert got.shape == (14, 4001, 1)
        fin = torch.isfinite(ref)
        assert torch.equal(torch.isfinite(got), fin) and fin.all()
        assert torch.equal(got, ref)
    if dtype == torch.float32:  # B2 solves in float32 only
        params, grid, amt = _b2_inputs(3000, cuda, seed=3)
        params["dose0"] = params["dose0"][:1].contiguous()
        ok, _, _ = _b2_against_plain(params, grid[:1].contiguous(), amt[:1].contiguous(),
                                     **_B2_KW)
        assert ok.sum().item() > 2000


def _pharmaco_case(cfg_kw):
    """bench.py bench_pharmaco's likelihood over 6 patients, with the rates
    of cfg_kw's options, and 256 rows of its values with jitter 0.03."""
    from bcm3_tpu_torch import VariableSet
    from bcm3_tpu_torch.likelihoods.pharmaco import (
        PharmacoLikelihoodPopulation,
        PharmacoModelConfig,
    )
    from bcm3_tpu_torch.likelihoods.poppk_synth import synthesize_trial

    P = 6
    spec = [("mean_absorption", -0.3), ("sigma_absorption", 0.2),
            ("mean_clearance", np.log10(18.0)), ("mean_volume_of_distribution", np.log10(120.0))]
    spec += [(f"p{j + 1}_absorption", 0.3 + 0.02 * j) for j in range(P)]
    spec += [("additive_error_standard_deviation", 25.0)]
    rates = []  # log10-space
    if cfg_kw.get("use_peripheral"):
        rates += [("peripheral_forward_rate", -1.1), ("peripheral_backward_rate", -1.3)]
    if cfg_kw.get("use_metabolite"):
        rates += [("metabolite_conversion_rate", -1.0)]
    if cfg_kw.get("num_transit"):
        rates += [("mean_transit_time", 0.3)]
    vs = VariableSet()
    for name, _ in spec:
        vs.add_variable(name)
    for name, _ in rates:
        vs.add_variable(name, logspace=True)
    spec += rates
    trial, _ = synthesize_trial(num_patients=P, num_timepoints=12, seed=31)
    lik = PharmacoLikelihoodPopulation(vs, trial, "lapatinib", PharmacoModelConfig(**cfg_kw))
    vals = np.array([v for _, v in spec])
    xs = vals + 0.03 * np.random.default_rng(0).normal(size=(256, len(vals)))
    return lik, torch.as_tensor(xs)


@pytest.mark.parametrize(
    "cfg_kw", [{}, dict(use_peripheral=True, use_metabolite=True, num_transit=3),
               dict(num_transit=7)], ids=["n2", "n7", "n9"])
def test_pharmaco_population_on_the_card_matches_cpu(cuda, cfg_kw):
    """float64 on the card against the CPU to rtol 1e-10, float32 to rtol
    1e-3, with equal finite sets (n = 2 closed form, n = 7 small_expm,
    n = 9 matrix_exp)."""
    lik, xs = _pharmaco_case(cfg_kw)
    cpu = lik.log_prob_batched(xs)
    fin = torch.isfinite(cpu)
    assert fin.all()
    card = lik.log_prob_batched(xs.to(cuda))
    assert card.device.type == cuda.type and card.dtype == torch.float64
    torch.testing.assert_close(card.cpu(), cpu, rtol=1e-10, atol=0.0)
    card32 = lik.log_prob_batched(xs.to(cuda, torch.float32)).cpu().double()
    assert torch.isfinite(card32).all()
    torch.testing.assert_close(card32, cpu, rtol=1e-3, atol=0.0)


@pytest.mark.parametrize("pk_type", ["one", "one_transit"])
def test_pk_single_on_the_card_matches_cpu(cuda, tmp_path, pk_type):
    """The single-patient PK likelihood on the card launches B1 (`one`) or
    B2 (`one_transit`) at P = 1. `one`: float32 against the CPU's float64
    to rtol 1e-3; `one_transit`: both float32 (B2 and its plain version),
    the central compartment within B2's float32 stack tolerance (rtol
    3e-4, atol 3e-6 x dose) with equal finite sets."""
    from bcm3_tpu_torch.likelihoods.pk_single import SinglePatientPKLikelihood, select_patient
    from bcm3_tpu_torch.likelihoods.poppk_synth import synthesize_trial
    from bcm3_tpu_torch import VariableSet

    names = ["absorption", "excretion", "elimination", "volume_of_distribution"]
    vals = [np.log10(0.5), np.log10(0.03), np.log10(2.0), np.log10(120.0)]
    if pk_type == "one_transit":
        names += ["n_transit", "mean_transit_time"]
        vals += [np.log10(3.0), np.log10(2.0)]
    names += ["standard_deviation", "standard_deviation2"]
    vals += [np.log10(20.0), np.log10(0.08)]
    vs = VariableSet()
    for name in names:
        vs.add_variable(name, logspace=True)
    trial, _ = synthesize_trial(num_patients=4, num_timepoints=12, seed=3)
    m = SinglePatientPKLikelihood(vs, select_patient(trial, "2"), pk_type, "lapatinib")
    jitter = 0.1 * np.random.default_rng(1).normal(size=(64, len(vals)))
    xs = torch.as_tensor(np.array(vals) + jitter)
    counter = propagate_intervals_one_compartment if pk_type == "one" else transit_solve
    before = counter.launches
    card = m.log_prob_batched(xs.to(cuda, torch.float32)).cpu().double()
    assert counter.launches == before + 1
    if pk_type == "one":
        cpu = m.log_prob_batched(xs)
        assert torch.isfinite(cpu).all() and torch.isfinite(card).all()
        torch.testing.assert_close(card, cpu, rtol=1e-3, atol=0.0)
        return

    def central(rows):
        p, _, _ = m._patient_params(rows)
        return m._central_transit(p, m._tables(rows.device, rows.dtype), rows.dtype)[:, 0]

    c_card = central(xs.to(cuda, torch.float32)).cpu()
    c_cpu = central(xs.float())
    fin = torch.isfinite(c_cpu).all(dim=1)
    assert torch.equal(torch.isfinite(c_card).all(dim=1), fin) and fin.sum() >= 48
    atol = 3e-6 * float(m.trial.dose.min())
    torch.testing.assert_close(c_card[fin], c_cpu[fin], rtol=3e-4, atol=atol)


def test_ode_template_on_the_card_matches_cpu(cuda):
    """The ODE template with a harmonic derivative (lanes first), float64
    on the card against the CPU to rtol 1e-8."""
    from bcm3_tpu_torch import VariableSet, create_likelihood

    def harmonic(t, y, params):
        w = 1.0 / 2300.0
        z = torch.zeros_like(y[:, 0])
        return torch.stack([y[:, 1], -w * w * y[:, 0], z, z], dim=-1)

    vs = VariableSet()
    for i in range(13):
        vs.add_variable(f"p{i}")
    lik = create_likelihood("ODE", vs, _derivative=harmonic)
    rng = np.random.default_rng(4)
    rows = rng.uniform(0.1, 1.3, (256, 13))
    rows[:, 9] = 100.0 + 20.0 * rng.normal(size=256)
    xs = torch.as_tensor(rows)
    cpu = lik.log_prob_batched(xs)
    card = lik.log_prob_batched(xs.to(cuda)).cpu()
    assert torch.isfinite(cpu).all()
    torch.testing.assert_close(card, cpu, rtol=1e-8, atol=0.0)


def _chip_smoke():
    """chip_smoke.py, whose models are made in memory (the card's machine
    may lack h5py)."""
    import os
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke

    return chip_smoke


def _card_and_cpu(lik, xs, cuda, rtol64, rtol32):
    """lik on the card against the CPU: float64 within rtol64, float32
    within rtol32, equal finite sets."""
    cpu = lik.log_prob_batched(xs)
    card = lik.log_prob_batched(xs.to(cuda))
    assert card.device.type == cuda.type and card.dtype == torch.float64
    torch.testing.assert_close(card.cpu(), cpu, rtol=rtol64, atol=0.0, equal_nan=True)
    card32 = lik.log_prob_batched(xs.to(cuda, torch.float32)).cpu().double()
    assert torch.equal(torch.isfinite(card32), torch.isfinite(cpu))
    fin = torch.isfinite(cpu)
    torch.testing.assert_close(card32[fin], cpu[fin], rtol=rtol32, atol=0.0)
    return cpu


@pytest.mark.parametrize("solver", ["ring", "fixed", "budget", "adaptive"])
def test_incucyte_on_the_card_matches_cpu(cuda, tmp_path, solver):
    """incucyte_population, bench_incucyte's experiment at G = 256 with
    each solver, 64 rows of its values with jitter 0.002 and a NaN row:
    float64 at rtol 1e-10 (1e-8 for budget and adaptive), float32 within
    chip_smoke.INCUCYTE_RTOL; the solve makes no host read (sync debug
    mode "error")."""
    cs = _chip_smoke()
    _, lik, values = cs.incucyte_model(str(tmp_path), grid_points=256, solver=solver)
    xs = torch.as_tensor(cs.bench_rows(values, 64, jitter=cs.INCUCYTE_JITTER))
    xs[7] = float("nan")
    cpu = _card_and_cpu(lik, xs, cuda, cs.SOLVER_RTOL[solver], cs.INCUCYTE_RTOL)
    assert torch.isfinite(cpu).sum() == 63 and torch.isneginf(cpu[7])
    model = lik.model
    problem = model.well_problem(xs[:8].to(cuda), model.experiments[0])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        res = model._solve(*problem)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert res.ok.cpu().tolist() == [True] * 35 + [False] * 5


def test_mitosis_on_the_card_matches_cpu(cuda, tmp_path):
    """mitosis_time_estimation (32 cells x 30 timepoints) on 256 rows:
    float64 at rtol 1e-10, float32 within chip_smoke.MITOSIS_RTOL; the
    native matching of the card's costs equals scipy's to 1e-12."""
    from bcm3_tpu_torch import native

    cs = _chip_smoke()
    _, lik, truth = cs.mitosis_model(str(tmp_path))
    xs = torch.as_tensor(truth + 0.1 * np.random.default_rng(0).normal(size=(256, 3)))
    _card_and_cpu(lik, xs, cuda, 1e-10, cs.MITOSIS_RTOL)
    cost = lik.model.cost(xs.to(cuda, torch.float32)).double().cpu().numpy()
    ones = np.ones(cost.shape[1], dtype=bool)
    np.testing.assert_allclose(native.lap_match_logp_batch(cost, ones, ones),
                               native.lap_match_logp_batch_plain(cost, ones, ones), rtol=1e-12)


def test_cell_cycle_marker_on_the_card_matches_cpu(cuda):
    """cell_cycle_marker over the 220-point track on 256 rows: float64 at
    rtol 1e-10, float32 within chip_smoke.CCM_RTOL."""
    from bcm3_tpu_torch import VariableSet
    from bcm3_tpu_torch.likelihoods.cellmisc import CellCycleMarkerLikelihood

    cs = _chip_smoke()
    vs = VariableSet()
    for k in range(10):
        vs.add_variable(f"v{k}")
    model = CellCycleMarkerLikelihood(vs, cs.ccm_track())
    xs = np.array(cs.CCM_TRUTH) * (1.0 + 0.1 * np.random.default_rng(0).normal(size=(256, 10)))
    _card_and_cpu(model, torch.as_tensor(xs), cuda, 1e-10, cs.CCM_RTOL)


# ---------------------------------------------------------------------------
# the cell-population likelihood (RODAS3, the sparse stage solver)


def _cellpop_lanes(cs, tmp_path, config, L, device, dtype=torch.float64):
    """The first round's lanes of a bench cellpop configuration: (the
    experiment, rhs, jac, y0 (L, n), args, grid), on device."""
    _, lik = cs.cellpop_model(str(tmp_path), config, 8, 2)
    exp = lik.model.experiments[0]
    tv = torch.as_tensor(cs.cellpop_rows(L // 2), dtype=dtype, device=device)
    nsp = exp._nsp(tv)
    n = exp.model.num_ode_species
    y0 = exp._initial_conditions_with_variability(exp._initial_state(tv), tv, nsp, True)
    params = exp._cell_params(tv, nsp, True)[:, :2].reshape(L, -1)
    consts = exp._const("const_y", exp.model.initial_constant_values(), tv).expand(L, -1)
    creation = exp._entry_times(tv, nsp)[:, :2].reshape(-1)
    return exp, y0[:, :2].reshape(L, n), (params, consts, creation), exp._const("grid", exp.grid, tv)


@pytest.mark.parametrize("form", ["adaptive", "budget"])
def test_rodas3_on_the_card_matches_cpu(cuda, tmp_path, form):
    """64 lanes of the cellpop model's first round, float64, through the
    sparse stage solver: the card's trajectories equal the CPU's within
    1e-10 on every lane that took the CPU's step count (the adaptive form),
    and within the solver's rtol on the others, at most half of them (a
    clipped landing one ulp short of its stop turns on the last bit of t,
    tests/test_torch_rosenbrock.py: 24 of these 64 lanes on an H100 against
    the CPU); the budget form makes no host read."""
    from bcm3_tpu_torch.ode import rosenbrock as R

    cs = _chip_smoke()
    out = {}
    for dev in ("cpu", cuda):
        exp, y0, args, grid = _cellpop_lanes(cs, tmp_path, "cellpop", 64, dev)
        kw = dict(args=args, rtol=exp.rtol, atol=exp.atol, sparse=exp.sparse_solver, jac=exp._jac)
        if form == "adaptive":
            out[str(dev)] = R.solve_at_times_stiff(exp._rhs, y0, grid, **kw)
        else:
            if dev != "cpu":
                # the solver's index tables go to the card at their first use
                R.solve_at_times_stiff_budget(exp._rhs, y0, grid, total_trips=1, **kw)
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
            try:
                out[str(dev)] = R.solve_at_times_stiff_budget(exp._rhs, y0, grid,
                                                              total_trips=300, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
    cpu, card = out["cpu"], out[str(cuda)]
    assert torch.equal(cpu.ok, card.ok.cpu()) and cpu.ok.all()
    same = (cpu.n_steps == card.n_steps.cpu()).numpy()
    scale = cpu.ys.abs().amax(dim=1, keepdim=True).clamp(min=1e-300)
    err = ((card.ys.cpu() - cpu.ys).abs() / scale).amax(dim=(1, 2)).numpy()
    assert err[same].max(initial=0.0) <= 1e-10
    assert err[~same].max(initial=0.0) <= 1e-5 and (~same).sum() <= 64 // 2


def test_sparse_stage_solver_on_the_card(cuda):
    """The sparse factor and solve on the card against lu_factor_ex and
    lu_solve of the dense G and against the CPU, float64, 1,000 lanes of
    the 20-species cascade's pattern; a singular G fails soft on the card."""
    from bcm3_tpu_torch.ode.sparse_lu import SparseStageSolver
    from bcm3_tpu_torch.sbml import SBMLModel

    cs = _chip_smoke()
    P = SBMLModel.from_string(cs.cascade_model(8)).jacobian_sparsity()
    solver = SparseStageSolver(P)
    n, L = P.shape[0], 1000
    rng = np.random.default_rng(0)
    nz = np.asarray(solver.jac_nz)
    entries = torch.as_tensor(rng.normal(size=(L, len(nz))))
    inv_hg = torch.as_tensor(rng.uniform(5.0, 10.0, L))
    b = torch.as_tensor(rng.normal(size=(L, n)))
    x_cpu = solver.solve(solver.factor_G(entries, inv_hg), b)
    A = solver.factor_G(entries.to(cuda), inv_hg.to(cuda))
    x = solver.solve(A, b.to(cuda))
    G = torch.eye(n, dtype=torch.float64, device=cuda) * inv_hg.to(cuda)[:, None, None]
    G[:, nz[:, 0], nz[:, 1]] -= entries.to(cuda)
    LU, piv, info = torch.linalg.lu_factor_ex(G)
    x_dense = torch.linalg.lu_solve(LU, piv, b.to(cuda)[..., None])[..., 0]
    torch.testing.assert_close(x, x_dense, rtol=1e-9, atol=1e-12)
    torch.testing.assert_close(x.cpu(), x_cpu, rtol=1e-12, atol=1e-14)

    P = np.zeros((3, 3), dtype=bool)
    P[0, 1] = P[1, 0] = True
    solver = SparseStageSolver(P)
    J = {(0, 0): 0.0, (0, 1): 2.0, (1, 0): 2.0, (1, 1): -3.0, (2, 2): 0.0}
    e = torch.tensor([[J[ij] for ij in solver.jac_nz]], dtype=torch.float64, device=cuda)
    x = solver.solve(solver.factor_G(e, torch.ones(1, dtype=torch.float64, device=cuda)),
                     torch.ones(1, 3, dtype=torch.float64, device=cuda))
    assert not torch.isfinite(x).all()


@pytest.mark.parametrize("config", ["cellpop", "cellpop_matched"])
def test_cell_population_on_the_card_matches_cpu(cuda, tmp_path, config):
    """cell_population (bench's model, 8 cells, 2 initial) on 6 rows: the
    card's float64 against the CPU's within the solver's rtol and equal
    -inf sets, float32 within 1e-4."""
    cs = _chip_smoke()
    _, lik = cs.cellpop_model(str(tmp_path), config, 8, 2)
    xs = torch.as_tensor(cs.cellpop_rows(6))
    xs[5, 0] = float("nan")  # a failed integration: -inf
    cpu = _card_and_cpu(lik, xs, cuda, cs.CELLPOP_SOLVER_RTOL, 1e-4)
    assert torch.isneginf(cpu[5]) and torch.isfinite(cpu[:5]).all()


@pytest.mark.parametrize("config", ["bistable", "network", "incucyte"])
def test_fisa_on_the_card_matches_cpu(cuda, tmp_path, config):
    """fISA (bench_fisa's bistable network, the feedback network with every
    drug effect, the incucyte-sequential experiment relative to a
    single-condition one) on 64 rows of its values with jitter 0.01: the
    card's float64 against the CPU's within 1e-10 and equal -inf sets; the
    solves make no host read, nor does a whole evaluation but where a
    truncated-t data part is scored (the network's: the incomplete beta
    function checks its convergence on the host)."""
    cs = _chip_smoke()
    lik, values = cs.fisa_model(str(tmp_path), config)
    xs = torch.as_tensor(cs.bench_rows(values, 64, jitter=cs.FISA_JITTER))
    cpu = lik.log_prob_batched(xs)
    card = lik.log_prob_batched(xs.to(cuda))
    assert card.device.type == "cuda" and card.dtype == torch.float64
    torch.testing.assert_close(card.cpu(), cpu, rtol=1e-10, atol=0.0, equal_nan=True)
    assert torch.isfinite(cpu).all()
    x = xs.to(cuda, torch.float32)
    model = lik.model
    exp = model.experiments[0]
    tv = model._transform(x)
    preset, expression = exp._prepare(tv)
    truncated_t = any(d.likelihood_fn == "truncated_t" for e in model.experiments
                      for d in e.data_parts)
    lik.log_prob_batched(x)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        exp.network.calculate_multiroot(tv[:, None, :], expression, preset)
        exp.network.calculate(tv[:, None, :], expression, preset)
        if not truncated_t:
            lik.log_prob_batched(x)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert truncated_t == (config == "network")


def test_rbridge_on_the_card(cuda, tmp_path):
    """rbridge.init runs on the card by default; its likelihood, prior and
    fISA accessors equal a CPU handle's on bench_fisa's network (data
    through `_data`) and on the banana fixture."""
    import os

    from bcm3_tpu_torch import rbridge

    cs = _chip_smoke()
    folder, data, values = cs.fisa_bridge_folder(str(tmp_path))
    for path, opts, vals in ((folder, {"_data": data}, values),
                             (os.path.join(cs.FIXTURES, "banana"), {}, np.array([0.3, 1.2]))):
        h, hc = rbridge.init(path, **opts), rbridge.init(path, device="cpu", **opts)
        try:
            assert rbridge._get(h)["device"].type == "cuda"
            assert rbridge.get_variable_names(h) == rbridge.get_variable_names(hc)
            for fn in (rbridge.get_log_likelihood, rbridge.get_log_prior):
                np.testing.assert_allclose(fn(h, vals), fn(hc, vals), rtol=1e-10)
            if opts:
                np.testing.assert_allclose(rbridge.fISA_get_modeled_activities(h, 0, vals),
                                           rbridge.fISA_get_modeled_activities(hc, 0, vals),
                                           rtol=1e-10)
                np.testing.assert_allclose(rbridge.fISA_get_modeled_data(h, 0, 0, vals),
                                           rbridge.fISA_get_modeled_data(hc, 0, 0, vals),
                                           rtol=1e-10)
        finally:
            rbridge.cleanup(h)
            rbridge.cleanup(hc)


def test_sharded_one_rank_nccl_matches_unsharded(cuda):
    """shard_over_devices in a one-rank NCCL group takes the sharded path
    (the start search's all-reduce, the boundary's gathers and digest
    check, the gathered statistics) and equals the unsharded run on the
    card bit for bit, on the banana fixture with one GMM boundary."""
    from bcm3_tpu_torch import entry
    from bcm3_tpu_torch.parallel import distributed, launch

    cfg = dict(num_samples=20, use_every_nth=2, num_chains=4, num_ensembles=64,
               adapt_proposal_samples=10, adapt_proposal_times=1, seed=5, dtype=torch.float32)
    plain = entry._sampler("cuda", **cfg).run()
    distributed.initialize(f"tcp://localhost:{launch.free_port()}", 1, 0, device="cuda")
    try:
        s = entry._sampler("cuda", shard_over_devices=True, **cfg)
        assert s._block is not None and s._block.whole
        sharded = s.run()
    finally:
        distributed.destroy()
    assert sharded["adaptation_boundaries"] == 1 and sharded["ensemble_shard"] == (0, 64)
    for k in ("samples", "log_prior", "log_likelihood"):
        np.testing.assert_array_equal(sharded[k], plain[k], err_msg=k)
    for k, v in plain["acceptance"].items():
        np.testing.assert_array_equal(sharded["acceptance"][k], v, err_msg=k)


def test_chunked_emission_is_bit_identical_on_the_card(cuda):
    """SamplerPT's overlapped emission on the card (pinned buffers, a copy
    stream): emit_chunk_size 0, 1 and None give the same samples,
    log-densities and acceptance counts bit for bit, every temperature
    emitted."""
    from bcm3_tpu_torch import entry

    cfg = dict(num_samples=12, use_every_nth=2, num_chains=4, num_ensembles=256,
               adapt_proposal_samples=6, adapt_proposal_times=1, seed=5, dtype=torch.float32)
    runs = {c: entry._sampler("cuda", emit_chunk_size=c, **cfg).run() for c in (0, 1, None)}
    for c in (1, None):
        for k in ("samples", "log_prior", "log_likelihood"):
            np.testing.assert_array_equal(runs[c][k], runs[0][k], err_msg=f"{c} {k}")
        for k, v in runs[0]["acceptance"].items():
            np.testing.assert_array_equal(runs[c]["acceptance"][k], v, err_msg=f"{c} {k}")


def test_fixed_trips_reads_the_host_never(cuda):
    """dp5's fixed-trip form makes no synchronizing call (sync debug mode
    "error" raises on one) and, with trips that cover every segment, equals
    the while form on the card bit for bit."""
    from bcm3_tpu_torch.ode import dp5

    rng = np.random.default_rng(3)
    L = 512
    w = torch.as_tensor(10 ** rng.uniform(-0.5, 0.8, L), device=cuda)
    y0 = torch.as_tensor(rng.uniform(-1.0, 1.0, (L, 2)), device=cuda)
    ts = torch.as_tensor([0.0, 0.7, 1.5, 3.0, 6.0], dtype=torch.float64, device=cuda)

    def f(t, y, w):
        return torch.stack([y[:, 1], -w * w * y[:, 0] - 0.3 * y[:, 1]], dim=-1)

    ref = dp5.solve_at_times(f, y0, ts, args=w)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fixed = dp5.solve_at_times(f, y0, ts, args=w, fixed_trips=400)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(ref.ok.all())
    assert torch.equal(fixed.ok, ref.ok) and torch.equal(fixed.n_steps, ref.n_steps)
    assert torch.equal(fixed.ys, ref.ys)


def test_hmc_and_vi_steps_on_a_transit_model(cuda, tmp_path):
    """One HMC step (float32) and one VI Adam step (float64) on the transit
    models on the card, through B2J: finite outputs, B2J launched."""
    from bcm3_tpu_torch import Prior, VariableSet
    from bcm3_tpu_torch.likelihoods import Likelihood
    from bcm3_tpu_torch.likelihoods.poppk import PopPKLikelihood
    from bcm3_tpu_torch.likelihoods.poppk_synth import synthesize_trial, write_poppk_prior_xml
    from bcm3_tpu_torch.sampler import HMCConfig, SamplerHMC, SamplerVI, VIConfig

    P = 4
    models = {}
    for pk_type in ("one_transit", "two_transit"):
        path = str(tmp_path / f"prior_{pk_type}.xml")
        write_poppk_prior_xml(path, P, pk_type)
        vs = VariableSet.from_xml(path)
        trial, _ = synthesize_trial(num_patients=P, num_timepoints=8, seed=3)
        pk = PopPKLikelihood(vs, trial, pk_type, "lapatinib")
        models[pk_type] = (Prior.from_xml(path, vs),
                           Likelihood("pop_pk_trajectory", pk.log_prob_batched, model=pk))

    prior, lik = models["one_transit"]
    s = SamplerHMC(prior, lik, HMCConfig(num_chains=64, num_leapfrog_steps=4, seed=2,
                                         device="cuda", dtype=torch.float32))
    z = s.target.reparam.from_x(prior.sample(s.generator, (64,), torch.float32))
    lp, g = s.target.value_and_grad(z)
    keep = torch.isfinite(lp) & torch.isfinite(g).all(dim=1)
    assert int(keep.sum()) >= 8
    z, lp, g = z[keep], lp[keep], g[keep]
    before = transit_jacobian.launches
    eps = torch.tensor(0.01, device=cuda)
    out = s.step(z, lp, g, eps, torch.ones(z.shape[1], device=cuda),
                 *s.draws(z.shape[0], z.shape[1], torch.float32))
    assert transit_jacobian.launches == before + 4
    z1, lp1, g1, alpha, accept = out
    assert torch.isfinite(z1).all() and torch.isfinite(lp1).all() and torch.isfinite(g1).all()
    assert ((alpha >= 0) & (alpha <= 1)).all()

    prior, lik = models["two_transit"]
    vi = SamplerVI(prior, lik, VIConfig(num_mc_samples=8, seed=2, device="cuda",
                                        dtype=torch.float64))
    mu, log_sigma = vi.initial_parameters()
    before = transit_jacobian.launches
    eps = torch.randn((8, mu.shape[0]), generator=vi.generator, dtype=torch.float64,
                      device=cuda)
    mu1, log_sigma1, elbo = vi.fit(mu, log_sigma, [eps])
    assert transit_jacobian.launches == before + 1
    assert torch.isfinite(mu1).all() and torch.isfinite(log_sigma1).all()
    assert np.isfinite(elbo)
