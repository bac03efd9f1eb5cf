"""One run of one cell: load, warm up, measure, check, print one JSON line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's configuration and traffic mix come from BENCHMARK.json and the
files it names (harness/registry.py). The mix's driver builds the
program's sampler over inputs made from the seed and runs it once
(set-up); the window then calls the sampler's public run() back to back
until --seconds have passed, the last call ending after that. With
--trace 1 the window's first runs go under torch.profiler (harness/trace.py)
and the line carries the cell's per-layer metrics: those of the device
trace read over the traced runs, the others over the untraced runs after
them (the window goes on until there is one); else the line carries its
end-to-end metrics. The set-up time leaves out what the driver spent on
the reference (`reference_s`: NUTS's start selection). After the window
the program's state is freed and the reference checks a seeded sample of
what the window produced (harness/check.py); every number compared is
printed beside its limit, on standard error and under "checks".
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from portbench.harness import check, registry
from portbench.harness import roofline as roofline_mod
from portbench.harness.trace import Trace
from portbench.reference import prior as ref_prior
from portbench.reference import trial as ref_trial

# top-level module names that may not be loaded once the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "bcm3_tpu")


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # the check's control: the reference in this lower dtype in the program's place
    p.add_argument("--control", choices=("bfloat16",), default=None)
    return p.parse_args(argv)


def seeds(seed: int) -> dict:
    """Independent streams of the seed: the trial, the sampler, the
    gradient samplers' starts, the check's sample."""
    state = np.random.SeedSequence(seed % 2**128).generate_state(4, dtype=np.uint64)
    names = ("trial", "sampler", "starts", "check")
    return {k: int(v) % 2**62 + 1 for k, v in zip(names, state)}


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def power_limit():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not read"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "not read"


class Context:
    """What the drivers, metric readers and rooflines read."""

    def __init__(self, workload, cell, seed_streams, device):
        self.workload = workload
        self.config = cell["config"]
        self.traffic = cell["traffic"]
        self.seeds = seed_streams
        self.device = device
        self.runs = []
        self.setup_s = None
        self.trace = None
        self.device_name = torch.cuda.get_device_name(0) if device == "cuda" else "cpu"
        self.power_limit = "not read"
        self.prior = ref_prior.ReferencePrior(self.config)
        self.trial = ref_trial.synthesize_trial(self.config, self.seeds["trial"])
        self.tables = ref_trial.tables(self.trial, self.config["drug"])
        self.tmpdir = tempfile.mkdtemp(prefix="portbench_")
        self.boundary = None

    def roofline(self, kernel):
        return roofline_mod.share(self, kernel)


def read_metrics(ctx, metrics, traced_runs=None):
    """The metrics' readers, each over the runs it describes (ctx.runs while
    it reads): with `traced_runs` (a traced window), the first that many runs
    for a metric of the device trace and the rest for any other; else all."""
    out, every = {}, ctx.runs
    for m in metrics:
        if traced_runs is not None:
            traced = m["source"] == "device_trace"
            ctx.runs = every[:traced_runs] if traced else every[traced_runs:]
        value = registry.load_module("metrics", m["name"]).read(ctx)
        ctx.runs = every
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def main(argv=None, device="cuda", overrides=None, t0=None, out=None):
    """Run the cell; print its line to `out` (stdout). Returns the exit
    code. `device` and `overrides` ({"config": {...}, "traffic": {...}})
    exist for the CPU tests, which run a cell at a tiny size."""
    t0 = time.perf_counter() if t0 is None else t0
    out = out or sys.stdout
    args = parse(argv)
    bench = registry.benchmark()
    cell = registry.cell(bench, args.workload)
    chips = cell["entry"]["chips"]
    if device == "cuda" and (not torch.cuda.is_available() or torch.cuda.device_count() < chips):
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
              f"device_count() = {torch.cuda.device_count()}; no result", file=sys.stderr)
        return 2
    for kind, extra in (overrides or {}).items():
        cell[kind] = dict(cell[kind], **extra)
    limits = registry.limits(args.workload)
    ctx = Context(args.workload, cell, seeds(args.seed), device)
    if args.trace:
        ctx.power_limit = power_limit() if device == "cuda" else "not read"
    driver = registry.load_module("drivers", ctx.traffic["kind"]).Driver(ctx)

    driver.setup()
    if device == "cuda":
        torch.cuda.synchronize()
    reference_s = getattr(driver, "reference_s", 0.0)
    ctx.setup_s = time.perf_counter() - t0 - reference_s

    traced = bool(args.trace)
    with ctx.boundary.tracing(traced), Trace(traced, device, args.seconds) as trace:
        start = time.perf_counter()
        while (not ctx.runs or time.perf_counter() - start < args.seconds
               or (traced and trace.runs == len(ctx.runs))):
            with torch.profiler.record_function("portbench.run"):
                ctx.runs.append(driver.run_once())
            trace.after_run()
            ctx.boundary.traced = trace.tracing
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    ctx.trace = trace.summary()
    if traced:
        metrics = read_metrics(ctx, cell["per_layer"], trace.runs)
    else:
        metrics = read_metrics(ctx, cell["end_to_end"])

    data = driver.check_data()
    driver.release()
    reference = check.Reference(ctx.config, ctx.prior, ctx.tables, device)
    numbers, attempted, failed = check.run(reference, data, limits, args.control)
    over = [k for k, v in numbers.items() if not v <= limits[k]]
    failed += int("stuck_share" in over)

    result = {
        "correct": not over,
        "attempted": attempted,
        "failed": failed,
        "metrics": metrics,
        "device": {"platform": "gpu" if device == "cuda" else device,
                   "kind": ctx.device_name,
                   "count": 1 if device == "cuda" else 0,
                   "memory_peak_bytes": int(peak)},
    }
    if ctx.trace is not None:
        result["device"]["busy_s"] = ctx.trace.busy_s()
        result["device"]["window_s"] = ctx.trace.window_s
        result["breakdown"] = ctx.trace.breakdown()
    result["checks"] = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    runs = ctx.runs
    print(f"portbench {args.workload} seed {args.seed}: setup {ctx.setup_s:.3f} s "
          f"(and {reference_s:.3f} s of the reference's), {len(runs)} runs "
          f"({trace.runs} traced) in {sum(r['wall_s'] for r in runs):.3f} s; per run: "
          + "; ".join(driver.describe(r) for r in runs), file=sys.stderr)
    for k, v in numbers.items():
        print(f"check {k} = {v!r} (limit {limits[k]!r})"
              f"{'' if v <= limits[k] else ' OVER'}", file=sys.stderr)
    shutil.rmtree(ctx.tmpdir, ignore_errors=True)
    found = forbidden_modules()
    if found:
        print(f"portbench: loaded once the window had closed: {', '.join(found)}; no result",
              file=sys.stderr)
        return 3
    print(json.dumps(result, allow_nan=False), file=out, flush=True)
    return 0
