"""The harness finds every piece by name: in a copy of the benchmark, a new
configuration, traffic mix, per-layer metric, kernel roofline and cell
(entries in BENCHMARK.json and files of their own, no other edit) are
picked up and run."""

from __future__ import annotations

import json

from portbench_testing import TINY_CONFIG, TINY_TRAFFIC, copy_benchmark, last_json, run_in_copy

DUMMY_METRIC = '''"""dummy_work (ops): the dummy roofline's operation count."""

from portbench.harness import registry


def read(ctx):
    return registry.load_module("roofline", "dummy").work(ctx)["ops"]
'''
DUMMY_ROOFLINE = '''KERNEL = r"never_launched"


def work(ctx):
    return {"ops": 1234.0 * len(ctx.boundary.call_rows), "bytes": 1.0, "dtype": "float32"}
'''


def test_new_files_alone_add_a_cell(tmp_path):
    root = copy_benchmark(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "portbench/configs/one.json").read_text())
    cfg.update(name="dummy_model", **TINY_CONFIG)
    (root / "portbench/configs/dummy_model.json").write_text(json.dumps(cfg))
    traffic = json.loads((root / "portbench/traffic/pt.e32768.json").read_text())
    traffic.update(TINY_TRAFFIC["pt"], num_ensembles=3)
    (root / "portbench/traffic/pt.dummy.json").write_text(json.dumps(traffic))
    (root / "portbench/metrics/dummy_work.py").write_text(DUMMY_METRIC)
    (root / "portbench/roofline/dummy.py").write_text(DUMMY_ROOFLINE)
    (root / "portbench/limits/pt.dummy_model.json").write_text(
        (root / "portbench/limits/pt.one.json").read_text())
    bench["configs"].append({"name": "dummy_model", "source": "https://example.org/dummy",
                             "file": "portbench/configs/dummy_model.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "pt.dummy_model", "config": "dummy_model",
                               "traffic": "pt.dummy", "chips": 1, "why": "a test"})
    bench["end_to_end"][0]["workloads"].append("pt.dummy_model")
    bench["per_layer"].append({"name": "dummy_work", "unit": "ops", "better": "higher",
                               "source": "program_counter", "layer": "test", "moves":
                               "evals_per_s", "workloads": ["pt.dummy_model"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    argv = ["--workload", "pt.dummy_model", "--seed", "2200000001", "--seconds", "0.05"]
    rc, out, err = run_in_copy(root, argv + ["--trace", "1"], {})
    assert rc == 0, err[-3000:]
    r = last_json(out)
    assert r["correct"] is True, r["checks"]
    assert r["metrics"]["dummy_work"]["value"] > 0 and r["metrics"]["dummy_work"]["unit"] == "ops"
    rc, out, err = run_in_copy(root, argv + ["--trace", "0"], {})
    assert rc == 0, err[-3000:]
    assert set(last_json(out)["metrics"]) == {"evals_per_s", "setup_s"}
    # 3 ensembles x 8 chains, every emitted sample use_every_nth iterations
    t = TINY_TRAFFIC["pt"]
    assert f"{3 * 8 * t['num_samples'] * t['use_every_nth']} evaluations counted" in err


def test_a_copy_without_the_program_gives_no_result(tmp_path):
    """In a directory with only BENCHMARK.json and portbench/, the run
    exits with an error and prints no result line."""
    import os
    import subprocess
    import sys

    root = copy_benchmark(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", "pt.one", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=root, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
