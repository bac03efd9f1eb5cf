"""Each driver end to end on the CPU at a tiny size, through main()'s
test-only size override: the result's keys, its metrics, its checks."""

from __future__ import annotations

import io
import json
import re

import pytest

from portbench.harness import main as harness
from portbench_testing import RESULT_KEYS, tiny


def run(workload, trace=0, config=None, control=None, seed=3000000001, seconds="0.05"):
    out = io.StringIO()
    argv = ["--workload", workload, "--seed", str(seed), "--seconds", seconds,
            "--trace", str(trace)] + (["--control", control] if control else [])
    rc = harness.main(argv, device="cpu", overrides=tiny(workload, config), out=out)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("workload,trace,config", [
    ("pt.one", 0, None), ("pt.one", 1, None), ("pt.one_transit", 0, None),
    ("nuts.one_transit", 1, "one"),
])
def test_a_cell_runs_and_is_correct(workload, trace, config):
    r = run(workload, trace, config)
    assert set(r) - {"breakdown", "checks"} == RESULT_KEYS
    assert list(r)[-1] == "checks"
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert set(r["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(r["device"])
    else:
        e2e = "evals_per_s" if workload.startswith("pt") else "nuts_draws_per_s"
        assert set(r["metrics"]) == {e2e, "setup_s"}
        assert all(m["value"] > 0 for m in r["metrics"].values())
    for name, c in r["checks"].items():
        assert c["value"] <= c["limit"], name


def test_the_traced_line_holds_the_host_side_per_layer_metrics():
    """The CPU has no device trace: the readers of device numbers return
    nothing and their metrics are left out; the program's own are there."""
    r = run("pt.one", trace=1)
    assert set(r["metrics"]) == {"pt.iter_ms", "pt.outside_share"}
    r = run("nuts.one_transit", trace=1, config="one")
    assert set(r["metrics"]) == {"nuts.syncs_per_leaf"}


def test_a_large_seed_is_taken():
    a = harness.seeds(2**31 + 12345)
    b = harness.seeds(2**63 + 7)
    assert a != b and all(0 < v < 2**62 + 2 for v in list(a.values()) + list(b.values()))


def test_no_card_no_result(capsys, monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    rc = harness.main(["--workload", "pt.one", "--seed", "1", "--seconds", "1", "--trace", "0"])
    out, err = capsys.readouterr()
    assert rc != 0 and out == "" and "no result" in err


def test_jax_loaded_by_the_end_gives_no_result(monkeypatch, capsys):
    import sys

    monkeypatch.setitem(sys.modules, "jax", object())
    out = io.StringIO()
    argv = ["--workload", "pt.one", "--seed", "5", "--seconds", "0.05", "--trace", "0"]
    rc = harness.main(argv, device="cpu", overrides=tiny("pt.one"), out=out)
    assert rc != 0 and out.getvalue() == "" and "jax" in capsys.readouterr().err


def test_a_traced_run_reads_the_programs_numbers_over_its_untraced_runs(capsys):
    """The device trace's metrics read the traced runs; the program's spans
    and counters the untraced runs after them, of which there is one at
    least."""
    from types import SimpleNamespace

    runs = [{"iterations": 10, "sampling_seconds": s, "elapsed_seconds": s, "wall_s": s}
            for s in (2.0, 1.0)]
    ctx = SimpleNamespace(runs=runs, trace=None)
    metrics = [{"name": "pt.iter_ms", "unit": "ms", "source": "program_span"}]
    assert harness.read_metrics(ctx, metrics, traced_runs=1)["pt.iter_ms"]["value"] == 100.0
    assert harness.read_metrics(ctx, metrics)["pt.iter_ms"]["value"] == 150.0
    assert ctx.runs is runs
    run("pt.one", trace=1)
    n, traced = map(int, re.search(r"(\d+) runs \((\d+) traced\)",
                                   capsys.readouterr().err).groups())
    assert 1 <= traced < n


def test_the_reference_start_selection_is_not_set_up(monkeypatch, capsys):
    import time

    from portbench.harness import registry

    real_load = registry.load_module

    def load_module(kind, name):
        module = real_load(kind, name)
        if kind == "drivers":
            real = module.Driver.starts

            def slow(self):
                time.sleep(1.5)
                return real(self)

            module.Driver.starts = slow
        return module

    monkeypatch.setattr(registry, "load_module", load_module)
    t0 = time.perf_counter()
    r = run("nuts.one_transit", config="one")
    total = time.perf_counter() - t0
    err = capsys.readouterr().err
    reference_s = float(err.split("(and ")[1].split(" s of the reference")[0])
    assert reference_s >= 1.5
    assert r["metrics"]["setup_s"]["value"] < total - 1.5


def test_nuts_counts_stuck_chains_at_a_finite_density_only():
    """A chain that starts a run at a density of -inf is counted apart; one
    at a finite density that never moves is stuck."""
    from types import SimpleNamespace

    import numpy as np
    import torch

    from portbench.drivers.nuts import Driver

    S, C, D = 3, 4, 2
    per_chain = np.arange(S * C * D, dtype=np.float32).reshape(S, C, D)
    per_chain[:, :2] = per_chain[0, :2]  # chains 0 and 1 never move
    lp = np.zeros((S * C, 1), np.float32)
    lp[0::C] = -np.inf  # chain 0 is at -inf in every emitted row
    res = {"samples_per_chain": per_chain, "samples": per_chain.reshape(S * C, 1, D),
           "log_prior": lp, "log_likelihood": np.zeros_like(lp), "elapsed_seconds": 1.0,
           "sampling_seconds": 1.0, "gradient_evaluations_per_transition": 1.0,
           "host_syncs_per_transition": 1.0, "mean_tree_depth": 1.0, "step_size": 0.1}
    state = (torch.zeros(C, D), torch.zeros(C), torch.zeros(C, D))
    traffic = {"num_warmup": 2, "num_samples": 1, "use_every_nth": 1,
               "check": {"rows_per_run": 2, "chains_per_run": 2}}
    d = Driver(SimpleNamespace(traffic=traffic, seeds={"check": 1}))
    d.sampler = SimpleNamespace(run=lambda x0: res, state=state)
    d.x0 = None
    r = d.run_once()
    assert r["nonfinite_chains"] == 1 and d.stuck == [1 / 3]
