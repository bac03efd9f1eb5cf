"""On a card: each cell runs briefly from run.py as the benchmark's
command runs it, its line well formed and correct, and the bfloat16
control at the cell's own size comes out not correct. Skips, inside the
test, where there is no card.

    python -m pytest portbench/tests/test_portbench_card.py -m gpu -q
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from portbench_testing import REPO, RESULT_KEYS

CELLS = ("pt.one_transit", "pt.one", "nuts.one_transit")


def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")


def run(workload, seed, trace, *extra, seconds="3"):
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", workload, "--seed",
                        str(seed), "--seconds", seconds, "--trace", str(trace), *extra],
                       cwd=REPO, capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-4000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_a_cell_runs_on_the_card(workload):
    card()
    r = run(workload, 2**31 + 101, 1)
    assert set(r) - {"breakdown", "checks"} == RESULT_KEYS
    assert r["correct"] is True, r["checks"]
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1
    assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
    for name, m in r["metrics"].items():
        if name.endswith("_roofline"):
            assert 0 < m["value"] <= 105, name


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_the_control_fails_on_the_card(workload):
    card()
    r = run(workload, 2**31 + 202, 0, "--control", "bfloat16", seconds="1")
    assert r["correct"] is False
