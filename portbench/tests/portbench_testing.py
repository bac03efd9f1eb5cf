"""Shared pieces of the benchmark's CPU tests: tiny sizes and a way to run
a cell in a copy of the benchmark."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "portbench"

# a cell at a size the CPU runs in seconds: 2 patients x 8 timepoints
TINY_CONFIG = {"num_patients": 2, "num_timepoints": 8, "solver_trips": 192}
TINY_TRAFFIC = {
    "pt": {"num_ensembles": 4, "num_samples": 6, "use_every_nth": 2,
           "check": {"rows_per_run": 4}},
    "nuts": {"num_chains": 8, "num_warmup": 20, "num_samples": 4, "max_tree_depth": 3,
             "start_draws": 64, "check": {"rows_per_run": 4, "chains_per_run": 4}},
}
RESULT_KEYS = {"correct", "attempted", "failed", "metrics", "device"}


def load(kind, name):
    with open(BENCH / kind / f"{name}.json") as f:
        return json.load(f)


def tiny(workload, config=None):
    """Overrides that cut a cell to the tiny size (and optionally swap its
    configuration for another configuration file's contents)."""
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    w = next(w for w in bench["workloads"] if w["name"] == workload)
    kind = load("traffic", w["traffic"])["kind"]
    cfg = dict(load("configs", config), **TINY_CONFIG) if config else dict(TINY_CONFIG)
    return {"config": cfg, "traffic": TINY_TRAFFIC[kind]}


def copy_benchmark(tmp: Path) -> Path:
    """BENCHMARK.json and portbench/ copied into tmp (the checkout's layout
    without the program, which the run imports from the repository)."""
    shutil.copy(REPO / "BENCHMARK.json", tmp / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return tmp


def run_in_copy(tmp: Path, argv, overrides, timeout=600):
    """main(argv) of the copy's harness on the CPU in a fresh process; the
    program comes from the repository. Returns (exit code, stdout, stderr)."""
    code = ("import json, sys; from portbench.harness.main import main; "
            f"sys.exit(main({argv!r}, device='cpu', "
            f"overrides=json.loads({json.dumps(overrides)!r})))")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp, env=env, capture_output=True,
                       text=True, timeout=timeout)
    return p.returncode, p.stdout, p.stderr


def last_json(stdout: str) -> dict:
    return json.loads(stdout.strip().splitlines()[-1])
