"""BENCHMARK.json and every file it names: found by name, well formed, and
held to the benchmark contract's limits on names, units and keys."""

from __future__ import annotations

import ast
import json
import re
import subprocess
import sys

import pytest

from portbench_testing import BENCH, REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def bench():
    return json.loads((REPO / "BENCHMARK.json").read_text())


def test_top_level():
    b = bench()
    assert set(b) == TOP_KEYS
    assert b["command"] == ["python3", "portbench/run.py"]
    assert b["paths"] == ["portbench"]
    assert 1 <= b["run_seconds"] <= 51
    cells = len(b["workloads"])
    # the contract's budget: 2 + 14 runs a cell of run_seconds + 60 s, 180 s a cell, 1200 spare
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert 1 <= cells <= 24 and all(w["chips"] == 1 for w in b["workloads"])
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_keys():
    b = bench()
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    names += [w["name"] for w in b["workloads"]] + [c["name"] for c in b["configs"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and (REPO / c["file"]).is_file()
        for key in ("source", "why"):
            assert 1 <= len(c[key]) <= 200 and "\n" not in c[key] and "\t" not in c[key]
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"] and "\t" not in w["why"]
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(pairs) == len(set(pairs))
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in b["end_to_end"])
    e2e = {m["name"]: m for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and m["source"] in SOURCES
        cells = e2e[m["moves"]].get("workloads", [w["name"] for w in b["workloads"]])
        assert set(m["workloads"]) <= set(cells), m["name"]
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


def test_every_cell_reports_enough():
    b = bench()
    for w in b["workloads"]:
        mine = [m for m in b["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert {"setup_s"} < {m["name"] for m in mine}
        assert any(w["name"] in m["workloads"] for m in b["per_layer"])


@pytest.mark.parametrize("kind", ["configs", "traffic", "limits"])
def test_data_files_are_found_by_name(kind):
    from portbench.harness import registry

    b = bench()
    names = {"configs": [c["name"] for c in b["configs"]],
             "traffic": [w["traffic"] for w in b["workloads"]],
             "limits": [w["name"] for w in b["workloads"]]}[kind]
    for name in names:
        data = registry.load_json(kind, name)
        assert data, name
        if kind == "traffic":
            assert (BENCH / "drivers" / f"{data['kind']}.py").is_file()
        if kind == "configs":
            assert data["name"] == name and data["reduced"] == []
            assert next(c for c in b["configs"] if c["name"] == name)["source"] == data["source"]


def test_metric_and_roofline_files_are_found_by_name():
    from portbench.harness import registry

    b = bench()
    for m in b["end_to_end"] + b["per_layer"]:
        assert callable(registry.load_module("metrics", m["name"]).read)
        if m["name"].endswith("_roofline"):
            mod = registry.load_module("roofline", m["name"][: -len("_roofline")])
            assert callable(mod.work) and re.compile(mod.KERNEL)


def _imports(path):
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_reference_imports_no_program_and_no_jax():
    for path in (BENCH / "reference").glob("*.py"):
        assert not _imports(path) & {"jax", "jaxlib", "flax", "bcm3_tpu", "bcm3_tpu_torch"}, path


def test_what_run_loads_has_no_jax():
    """Everything the run imports (the harness, every driver, metric and
    roofline, and the program's modules they reach) loads no module whose
    top-level name is jax, jaxlib, flax or bcm3_tpu; bcm3_tpu_torch is
    the program and allowed."""
    code = """
import sys
from portbench.harness import registry, main
for kind in ("drivers", "metrics", "roofline"):
    for p in sorted((registry.ROOT / kind).glob("*.py")):
        registry.load_module(kind, p.stem)
import bcm3_tpu_torch.sampler, bcm3_tpu_torch.likelihoods.poppk
print(",".join(main.forbidden_modules()))
print("bcm3_tpu_torch" in sys.modules)
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300, check=True).stdout.splitlines()
    assert out == ["", "True"]


def test_the_check_of_forbidden_names_is_by_whole_top_level_name(monkeypatch):
    from portbench.harness import main

    monkeypatch.setitem(sys.modules, "bcm3_tpu_torch_fake.sub", object())
    assert main.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert main.forbidden_modules() == ["jax"]
