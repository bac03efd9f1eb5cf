#!/usr/bin/env python3
"""Smoke run of bcm3_tpu_torch on one NVIDIA card (H100, sm_90a).

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each printing its lines before the last:

1. environment: the card (nvidia-smi name and power limit), torch, CUDA, nvcc;
2. build: both CUDA kernels compiled by nvcc from bcm3_tpu_torch/csrc;
3. each kernel against its plain PyTorch version at the slice's shapes, on
   inputs made by the slice's own likelihood from prior draws, with
   CUDA-event timings of both and each kernel's bound (the least time the
   card could take for the same work); for B2 also the per-lane trip
   counts of kernel and plain version (asserted equal), their
   distribution, the warp efficiency and the trips the early exit saves;
4. the slice, `one`: SamplerPT, 8 chains x 8192 ensembles, PopPK
   one-compartment over the bench trial (16 patients x 24 timepoints);
5. the slice, `one_transit`: 8 chains x 4096 ensembles;
   each slice runs once cold (its outputs checked), then twice more warm:
   the wall per iteration of the iterations alone, and under
   torch.profiler the device's busy time per iteration and its largest
   kernels;
6. the port on the card (float32, kernels) against the port on the CPU
   (float64 tables, plain versions) for 256 prior draws of each model.

The kernels' launch counters are set to 0 just before phase 4 and read
just after phase 5, so the counts show that the main path itself went
through the kernels. Any failed check raises, and the script exits
non-zero without printing a result. The last line is
{"ok": true, "device": {...}}; the line before it lists the kernels.
JAX is neither needed nor imported.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

NUM_PATIENTS = 16
NUM_TIMEPOINTS = 24
NUM_CHAINS = 8
ENSEMBLES = {"one": 8192, "one_transit": 4096}
NUM_SAMPLES = {"one": 20, "one_transit": 4}
USE_EVERY_NTH = 5
ORACLE_DRAWS = 256

# published peaks of one H100 SXM (NVIDIA's data sheet): float32 outside
# the tensor cores, and HBM3 bandwidth
PEAK_F32_OPS = 67e12
PEAK_BYTES = 3.35e12


def bound_ms(ops, nbytes):
    """The least time for the work: operations at the float32 peak or bytes
    at the memory rate, whichever is longer; and which of the two it is."""
    t_ops, t_bytes = ops / PEAK_F32_OPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, reps):
    """Mean milliseconds of fn() over reps runs, timed with CUDA events
    after one warm-up run."""
    import torch

    fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def build_model(pk_type, workdir):
    """Prior from its XML (as a user reads it) and the likelihood over the
    bench trial, built in memory: this machine may lack h5py, which the
    pkdata file needs."""
    from bcm3_tpu_torch import Prior, VariableSet
    from bcm3_tpu_torch.likelihoods import Likelihood
    from bcm3_tpu_torch.likelihoods.poppk import PopPKLikelihood
    from bcm3_tpu_torch.likelihoods.poppk_synth import (
        synthesize_trial,
        write_poppk_prior_xml,
    )

    prior_xml = os.path.join(workdir, f"prior_{pk_type}.xml")
    write_poppk_prior_xml(prior_xml, NUM_PATIENTS, pk_type)
    varset = VariableSet.from_xml(prior_xml)
    prior = Prior.from_xml(prior_xml, varset)
    trial, _ = synthesize_trial(
        num_patients=NUM_PATIENTS, num_timepoints=NUM_TIMEPOINTS, seed=42
    )
    pk = PopPKLikelihood(varset, trial, pk_type, "lapatinib")
    return prior, Likelihood("pop_pk_trajectory", pk.log_prob_batched, model=pk)


def phase_environment():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; no result")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log(smi)
    from bcm3_tpu_torch.ops import build

    nvcc = subprocess.run(
        [build._nvcc(), "--version"], capture_output=True, text=True, check=True,
        timeout=60,
    ).stdout.strip().splitlines()[-1]
    log(f"torch {torch.__version__} cuda {torch.version.cuda} | nvcc: {nvcc}")
    log(f"device: {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    return smi


def phase_build():
    from bcm3_tpu_torch.ops import build

    t0 = time.perf_counter()
    path = build.build()
    build.library()
    seconds = time.perf_counter() - t0
    log(f"build: {path.name} in {seconds:.2f} s (nvcc {build.last_build_seconds})")
    for line in path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")


def b2_inputs(models, gen):
    """B2's inputs as the `one_transit` likelihood makes them from prior
    draws: L = 4096 x 8 chains x 16 patients = 524,288 lanes, S = 38 stops,
    per-patient (P, S) tables."""
    import torch

    from bcm3_tpu_torch.ops.transit_kernels import LANE_PARAMS

    f32 = torch.float32
    prior, lik = models["one_transit"]
    pk = lik.model
    xs = prior.sample(gen, (ENSEMBLES["one_transit"] * NUM_CHAINS,), f32)
    tb = pk._tables(xs.device, f32)
    p, _, _ = pk._patient_params(xs)
    B, P = p["ka"].shape

    def flat(x):
        return (x if x.dim() == 2 else x[:, None]).expand(B, P).reshape(-1).contiguous()

    params = {k: flat(p[k]) for k in LANE_PARAMS}
    params["dose0"] = tb["tr_dose0"]
    kw = dict(
        trips=pk.solver_trips, rtol=1e-6, atol=float(pk.trial.dose.min()) * 1e-6,
        min_dt=1e-5,
    )
    return params, tb["tr_grid"], tb["tr_amt"], kw


def b2_trip_statistics(n, n_no_exit, slots, trips):
    """What the trip counts say: n, the trips each lane ran; n_no_exit, the
    trips it would run at this budget without the early exit; slots, the
    trip slots the kernel's warps issued."""
    total = int(n.sum())
    groups = n_no_exit.reshape(-1, 32).amax(dim=1).sum().item()  # L % 32 == 0
    nf = n.double()
    return {
        "mean_trips": nf.mean().item(),
        "median_trips": nf.median().item(),
        "share_at_budget_without_early_exit": (n_no_exit == trips).double().mean().item(),
        "trips_saved_by_early_exit": 1.0 - total / int(n_no_exit.sum()),
        # sum of lane trips over 32 x the slots the warps issued, under the
        # lane-refilling schedule; and the same over static warps of 32
        # consecutive lanes without the early exit (the earlier schedule)
        "warp_efficiency": total / (32 * slots),
        "warp_efficiency_static": int(n_no_exit.sum()) / (32 * groups),
    }


def phase_kernels(models, gen):
    """Each kernel against its plain version on the card, at the shapes and
    on the inputs the slice gives it."""
    import torch

    from bcm3_tpu_torch.ops.poppk_kernels import (
        propagate_intervals_one_compartment as b1,
        propagate_intervals_plain as b1_plain,
    )
    from bcm3_tpu_torch.ops.transit_kernels import (
        OPS_FIRST_STAGE,
        OPS_LANE_SETUP,
        OPS_PER_TRIP,
        transit_solve as b2,
        transit_solve_plain as b2_plain,
    )

    f32 = torch.float32
    results = {}

    # B1: B = 65,536 chains x P = 16 patients, K = 14 intervals
    prior, lik = models["one"]
    pk = lik.model
    xs = prior.sample(gen, (ENSEMBLES["one"] * NUM_CHAINS,), f32)
    tb = pk._tables(xs.device, f32)
    p, _, _ = pk._patient_params(xs)
    B, P = p["ka"].shape
    args = (
        p["ka"].contiguous(), p["ke"][:, None].expand(B, P).contiguous(),
        p["kel"].contiguous(), tb["initial_dose"], tb["interval"], tb["dose_amount"],
    )
    g, c = b1(*args)
    gp, cp = b1_plain(*args)
    torch.cuda.synchronize()
    assert g.shape == (pk.K, B, P) and torch.isfinite(gp).any()
    fin = torch.isfinite(gp) & torch.isfinite(cp)
    assert torch.equal(fin, torch.isfinite(g) & torch.isfinite(c)), "B1 finite sets differ"
    err = torch.maximum((g - gp).abs()[fin].max(), (c - cp).abs()[fin].max()).item()
    # float32; the kernel rounds like its plain version (no FMA contraction)
    scale = torch.maximum(gp.abs(), cp.abs())
    rel = torch.maximum((g - gp).abs(), (c - cp).abs())[fin] / (scale[fin] + 1e-6)
    max_rel = rel.max().item()
    assert max_rel <= 1e-5, f"B1 disagrees with its plain version: max rel {max_rel}"
    ms = cuda_ms(lambda: b1(*args), 50)
    plain_ms = cuda_ms(lambda: b1_plain(*args), 50)
    # each input read once, each output written once; per lane 12 float
    # operations of set-up and 5 per interval (csrc/poppk_propagate.cu)
    K = pk.K
    b1_bytes = sum(x.numel() * x.element_size() for x in args) + (g.numel() + c.numel()) * 4
    b1_bound, b1_by = bound_ms(B * P * (12 + 5 * K), b1_bytes)
    log(f"B1 poppk_propagate B={B} P={P} K={K}: max abs err {err:.3e}, "
        f"max rel err {max_rel:.3e} (limit 1e-5); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; "
        f"bound {b1_bound:.4f} ms by {b1_by} ({b1_bytes} bytes), "
        f"roofline share {b1_bound / ms:.3f}")
    results["poppk_propagate"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b1_bound, bound_by=b1_by
    )

    # B2: 524,288 lanes, S = 38 stops, on per-patient tables
    params, grid, amt, kw = b2_inputs(models, gen)
    trips = kw["trips"]
    slots = torch.zeros(1, dtype=torch.int64, device="cuda")
    c, ok, n = b2(params, grid, amt, trip_counts=True, warp_slots=slots, **kw)
    cp, okp, n_p = b2_plain(params, grid, amt, trip_counts=True, **kw)
    torch.cuda.synchronize()
    L, S = c.shape
    P = grid.shape[0]
    mismatched = int((ok != okp).sum())
    trip_mismatches = int((n != n_p).sum())
    both = ok & okp
    n_ok = int(both.sum())
    assert n_ok > L // 10, f"B2: only {n_ok} of {L} lanes finished"
    diff = (c[both] - cp[both]).abs()
    err = diff.max().item()
    # Built without FMA contraction and with the accurate exp/log/pow, the
    # kernel rounds like its plain version and takes the same step
    # sequence: the trip counts must be equal on every lane. Limits on the
    # outputs: ok differs on <= 0.01% of lanes, and central within 1e-3 of
    # each lane's peak.
    peak = cp[both].abs().amax(dim=1, keepdim=True).clamp(min=1e-30)
    worst = (diff / peak).max().item()
    assert trip_mismatches == 0, f"B2: {trip_mismatches} lanes ran another number of trips"
    assert mismatched <= L // 10000, f"B2: {mismatched} lanes differ in ok"
    assert worst <= 1e-3, f"B2 disagrees with its plain version: {worst}"

    # The same lanes with S more trips of budget: there the early exit
    # fires only past `trips`, so min(count, trips) is what each lane runs
    # at this budget without the early exit.
    _, _, n_long = b2(params, grid, amt, trip_counts=True, **dict(kw, trips=trips + S))
    n_no_exit = n_long.clamp(max=trips)
    stats = b2_trip_statistics(n, n_no_exit, int(slots), trips)
    stats["share_failed"] = 1.0 - int(ok.sum()) / L
    # least work for these inputs: every trip after a lane's first reuses
    # its first stage (csrc/transit_dp5.cu, the note); each input read once
    # and each output written once
    ops = L * OPS_LANE_SETUP + int((n > 0).sum()) * OPS_FIRST_STAGE + int(n.sum()) * OPS_PER_TRIP
    b2_bytes = (len(params) - 1) * L * 4 + (2 * P * S + P) * 4 + L * S * 4 + L
    b2_bound, b2_by = bound_ms(ops, b2_bytes)

    ms = cuda_ms(lambda: b2(params, grid, amt, **kw), 5)
    plain_ms = cuda_ms(lambda: b2_plain(params, grid, amt, **kw), 2)
    log(f"B2 transit_dp5 L={L} S={S} trips={trips}: ok {int(ok.sum())}/{L}, "
        f"ok mismatches {mismatched} (limit {L // 10000}), trip-count mismatches "
        f"{trip_mismatches} (limit 0), max abs err {err:.3e}, "
        f"worst err / lane peak {worst:.3e} (limit 1e-3); kernel {ms:.3f} ms, "
        f"plain {plain_ms:.3f} ms")
    log("B2 trips: " + json.dumps(stats))
    log(f"B2 bound: {ops:.4e} float operations, {b2_bytes} bytes -> {b2_bound:.4f} ms "
        f"by {b2_by}; roofline share {b2_bound / ms:.4f}")
    results["transit_dp5"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, ok_mismatches=mismatched,
        bound_ms=b2_bound, bound_by=b2_by,
    )
    return results


def phase_slice(pk_type, models):
    import numpy as np
    import torch

    from bcm3_tpu_torch.sampler import PTConfig, SamplerPT

    prior, lik = models[pk_type]
    E = ENSEMBLES[pk_type]
    cfg = PTConfig(
        num_samples=NUM_SAMPLES[pk_type],
        use_every_nth=USE_EVERY_NTH,
        num_chains=NUM_CHAINS,
        num_ensembles=E,
        adapt_proposal_samples=0,
        adapt_proposal_times=0,
        swapping_scheme="deterministic_even_odd",
        seed=7,
        emit_dtype=torch.float32,
        emit_fixed_only=True,
        device="cuda",
        dtype=torch.float32,
    )
    sampler = SamplerPT(prior, lik, cfg)
    res = sampler.run()
    torch.cuda.synchronize()
    S, D = cfg.num_samples, prior.num_variables
    assert res["samples"].shape == (S * E, 1, D), res["samples"].shape
    lpost = res["log_prior"] + res["log_likelihood"]
    assert np.isfinite(lpost).all(), "non-finite emitted log-posterior"
    assert np.isfinite(res["samples"]).all()
    mut, exc = sampler.acceptance_rates(sampler.state)
    assert 0.0 < mut[-1] < 1.0, f"T=1 mutate acceptance {mut[-1]}"
    log(f"slice {pk_type}: {NUM_CHAINS} x {E} chains, {res['evaluations']} evaluations "
        f"in {res['elapsed_seconds']:.3f} s = {res['evals_per_second']:.1f} evals/s; "
        f"mutate acceptance by temperature {np.round(mut, 4).tolist()}, "
        f"exchange {np.round(exc, 4).tolist()}")

    # steady state: the same sampler runs again (kernels built, allocations
    # cached), once for the wall of its iterations and once under the profiler
    iterations = cfg.num_samples * cfg.use_every_nth
    warm = sampler.run()
    wall_ms = warm["sampling_seconds"] * 1e3 / iterations
    busy_ms, top = profile_sampling(sampler, iterations)
    idle = "not measured" if busy_ms is None else f"{1.0 - busy_ms / wall_ms:.4f}"
    log(f"slice {pk_type} steady state: {iterations} iterations, wall "
        f"{wall_ms:.4f} ms per iteration = {E * NUM_CHAINS / wall_ms * 1e3:.1f} evals/s; "
        f"device busy {busy_ms if busy_ms is not None else 'not measured'} ms per "
        f"iteration (under the profiler), idle share {idle}")
    for name, ms in top:
        log(f"  device ms per iteration {ms:.4f}  {name[:120]}")
    return res


def profile_sampling(sampler, iterations):
    """One run() under torch.profiler. Returns the device's busy time per
    iteration (kernels, copies and sets that ran within the sampler's
    "SamplerPT.sampling" span, so without the start-position search; one
    stream, so they do not overlap) and the 8 largest entries of it by
    kernel; (None, []) where the profiler saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    # run() ends with copies to the host, so its device work is done
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sampler.run()
    events = prof.events()
    spans = [e for e in events
             if e.name == "SamplerPT.sampling" and e.device_type == DeviceType.CPU]
    if len(spans) != 1:
        return None, []
    start, end = spans[0].time_range.start, spans[0].time_range.end
    by_kernel = {}
    for e in events:
        # the span's own device-side record is a range, not work
        if e.device_type != DeviceType.CUDA or e.name == "SamplerPT.sampling":
            continue
        if start <= e.time_range.start <= end:
            by_kernel[e.name] = by_kernel.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy = sum(by_kernel.values()) / 1e3 / iterations
    top = sorted(((k, v / 1e3 / iterations) for k, v in by_kernel.items()),
                 key=lambda kv: -kv[1])[:8]
    return (busy, top) if busy > 0 else (None, [])


def phase_oracle(pk_type, workdir):
    """The port on the card against the port on the CPU (plain versions)."""
    import numpy as np
    import torch

    prior, lik = build_model(pk_type, workdir)
    xs = prior.sample(torch.Generator().manual_seed(5), (ORACLE_DRAWS,), torch.float64)
    cpu = lik.log_prob_batched(xs).numpy()
    card = lik.log_prob_batched(xs.to("cuda", torch.float32)).double().cpu().numpy()
    # prior draws can put a rate such as ka = 10^(mu + sigma * ndtri(u))
    # beyond float32's range (sigma is half-Cauchy); such a row is -inf in
    # float32 and may be finite in float64, so the finite sets are compared
    # on the rows whose rates fit in float32
    params, _, _ = lik.model._patient_params(xs)
    fits = np.ones(ORACLE_DRAWS, dtype=bool)
    for v in params.values():
        v = v.reshape(ORACLE_DRAWS, -1).abs().numpy()
        fits &= (v < np.finfo(np.float32).max).all(axis=1)
    fin_cpu, fin_card = np.isfinite(cpu), np.isfinite(card)
    mismatched = int((fin_cpu != fin_card)[fits].sum())
    both = fin_cpu & fin_card
    rel = np.abs(card[both] - cpu[both]) / np.abs(cpu[both])
    if pk_type == "one":
        # float32 on the card against float64 on the CPU: every row
        rtol, share, limit = 1e-3, 1.0, 0
    else:
        # both solve in float32 (the CPU with the plain version and the
        # CPU's exp/log): a float32 adaptive solve at rtol 1e-6 takes another
        # step sequence on a small share of lanes when the last bits differ,
        # so >= 95% of the rows within rtol 5e-3 (as
        # tests/test_poppk_pallas.py:115-134), <= 5% finite-set flips
        rtol, share, limit = 5e-3, 0.95, ORACLE_DRAWS // 20
    within = float((rel <= rtol).mean())
    log(f"card vs CPU {pk_type}: {int(both.sum())}/{ORACLE_DRAWS} finite on both, "
        f"{int((~fits).sum())} rows with rates beyond float32, {mismatched} "
        f"finite-set mismatches among the others (limit {limit}), {within:.4f} of "
        f"rows within rtol {rtol} (limit {share}), max rel err {rel.max():.3e}, "
        f"median {np.median(rel):.3e}")
    assert both.sum() >= ORACLE_DRAWS // 10
    assert mismatched <= limit
    assert within >= share


def main(workdir):
    phase_times = {}
    t = time.perf_counter()
    smi = phase_environment()
    import torch

    from bcm3_tpu_torch.ops import poppk_kernels, transit_kernels

    phase_times["environment"] = time.perf_counter() - t

    t = time.perf_counter()
    phase_build()
    phase_times["build"] = time.perf_counter() - t

    models = {k: build_model(k, workdir) for k in ("one", "one_transit")}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    t = time.perf_counter()
    kernels = phase_kernels(models, gen)
    phase_times["kernels"] = time.perf_counter() - t

    b1 = poppk_kernels.propagate_intervals_one_compartment
    b2 = transit_kernels.transit_solve
    b1.launches = 0
    b2.launches = 0
    slices = {}
    for pk_type in ("one", "one_transit"):
        t = time.perf_counter()
        slices[pk_type] = phase_slice(pk_type, models)
        phase_times[f"slice_{pk_type}"] = time.perf_counter() - t
    launches = {"poppk_propagate": b1.launches, "transit_dp5": b2.launches}
    assert launches["poppk_propagate"] > 0, "the `one` slice never launched B1"
    assert launches["transit_dp5"] > 0, "the `one_transit` slice never launched B2"
    log(f"main-path launches: {launches}")

    t = time.perf_counter()
    for pk_type in ("one", "one_transit"):
        phase_oracle(pk_type, workdir)
    phase_times["card_vs_cpu"] = time.perf_counter() - t
    log("phase seconds: " + json.dumps({k: round(v, 3) for k, v in phase_times.items()}))
    log("slice evals/s: " + json.dumps(
        {k: v["evals_per_second"] for k, v in slices.items()}
    ) + f" on {smi}")

    meta = {
        "poppk_propagate": ("bcm3_tpu_torch/csrc/poppk_propagate.cu",
                            "bcm3_tpu/ops/poppk_pallas.py:82"),
        "transit_dp5": ("bcm3_tpu_torch/csrc/transit_dp5.cu",
                        "bcm3_tpu/ops/transit_pallas.py:213"),
    }
    log(json.dumps({"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": meta[name][0],
            "replaces": meta[name][1],
            "launches": launches[name],
            "max_abs_err": kernels[name]["max_abs_err"],
            "ms": kernels[name]["ms"],
            "plain_ms": kernels[name]["plain_ms"],
            "bound_ms": kernels[name]["bound_ms"],
            "bound_by": kernels[name]["bound_by"],
            # no single PyTorch call computes either function
            "library_ms": None,
        }
        for name in ("poppk_propagate", "transit_dp5")
    ]}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)


if __name__ == "__main__":
    # the prior XML files of the run live in a directory removed at exit
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        sys.exit(main(tmp))
