"""The benchmark on the card: a short traced run of each cell comes out
correct and reads every per-layer metric, and the control fails the
cell's limits at its full size.  Skips without a CUDA device; run on the
card with

    python -m pytest -m gpu regbench/tests/test_regbench_card.py -q -p no:cacheprovider
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from regbench import cells, harness
from regbench.tests._tiny import REPO

WORKLOADS = [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_short_traced_run_is_correct(workload):
    _card()
    proc = subprocess.run([sys.executable, "regbench/run.py", "--workload", workload,
                           "--seed", "2147483990", "--seconds", "3", "--trace", "1"],
                          cwd=REPO, capture_output=True, text=True, timeout=360)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    want = {m["name"] for m in cells.load_cell(workload).per_layer}
    assert set(line["metrics"]) == want
    assert line["device"]["platform"] == "gpu" and line["device"]["busy_s"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_control_fails_the_limits_at_full_size(workload, tmp_path):
    _card()
    out = tmp_path / "readings.json"
    subprocess.run([sys.executable, "regbench/readings.py", "--workload", workload,
                    "--seeds", "2147483991", "--control-seeds", "2147483992",
                    "--out", str(out)], cwd=REPO, capture_output=True, text=True,
                   timeout=360, check=True)
    limits = cells.load_cell(workload).config["limits"]
    rows = json.loads(out.read_text())["rows"]
    program = next(r for r in rows if r["kind"] == "program")
    control = next(r for r in rows if r["kind"] == "control")
    assert all(program[name] <= limit for name, limit in limits.items())
    assert any(control[name] > limit for name, limit in limits.items())
