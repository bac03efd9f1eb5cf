"""Finds the benchmark's files by the names in BENCHMARK.json.

A configuration is `configs/<name>.json`, a traffic mix
`traffic/<name>.json` whose `kind` names its driver `drivers/<kind>.py`,
a metric `metrics/<name>.py`, a kernel's operations and bytes
`roofline/<kernel>.py`, and a cell's limits of the correctness check
`limits/<cell>.json`, all under the folder that holds this package. A
later change adds a cell, a mix, a metric or a roofline by adding such
files and BENCHMARK.json entries; nothing here lists them.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]  # the benchmark's folder
REPO = ROOT.parent  # the checkout: BENCHMARK.json and the program


def _path(kind: str, name: str, suffix: str) -> Path:
    path = ROOT / kind / f"{name}{suffix}"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1] if kind.endswith('s') else kind} named "
                                f"{name!r}: {path} is missing")
    return path


def load_json(kind: str, name: str) -> dict:
    with open(_path(kind, name, ".json")) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """The Python file `<kind>/<name>.py` as a module (names may hold dots)."""
    path = _path(kind, name, ".py")
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def benchmark() -> dict:
    with open(REPO / "BENCHMARK.json") as f:
        return json.load(f)


def cell(bench: dict, workload: str) -> dict:
    """The cell's entry, its configuration and traffic files, and the
    metrics it reports: end-to-end (with --trace 0) and per-layer (with
    --trace 1), each metric that lists the cell or lists no cells."""
    entries = [w for w in bench["workloads"] if w["name"] == workload]
    if not entries:
        raise KeyError(f"no workload named {workload!r} in BENCHMARK.json")
    w = entries[0]
    config = load_json("configs", w["config"])
    traffic = load_json("traffic", w["traffic"])

    def mine(metrics):
        return [m for m in metrics if workload in m.get("workloads", [workload])]

    return dict(entry=w, config=config, traffic=traffic,
                end_to_end=mine(bench["end_to_end"]), per_layer=mine(bench["per_layer"]))


def limits(workload: str) -> dict:
    """The cell's limits: {number: limit} of the correctness check."""
    return load_json("limits", workload)
