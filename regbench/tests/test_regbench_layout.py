"""The benchmark's files: ``BENCHMARK.json`` to its contract, and every
configuration, mix and per-layer metric found by its name, so a cell, a
mix or a metric is added as files and entries alone."""

from __future__ import annotations

import importlib
import json
import re

import pytest

from regbench import cells, harness
from regbench.tests._tiny import CELL, REPO, last_line, run_cpu, tiny_checkout

BENCHMARK = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
WORKLOADS = [w["name"] for w in BENCHMARK["workloads"]]


def test_benchmark_has_the_contract_keys():
    assert set(BENCHMARK) == {"command", "paths", "run_seconds", "configs", "workloads",
                              "end_to_end", "per_layer"}
    assert BENCHMARK["command"] == ["python3", "regbench/run.py"]
    assert BENCHMARK["paths"] == ["regbench"]
    assert 1 <= BENCHMARK["run_seconds"] <= 51
    for c in BENCHMARK["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("regbench/")
        assert (REPO / c["file"]).is_file()
    for w in BENCHMARK["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] == 1 and len(w["why"]) <= 200
    names = [m["name"] for m in BENCHMARK["end_to_end"]]
    assert names == ["pairs_per_s", "pair_p90_s", "setup_s"]
    for m in BENCHMARK["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] == "host_clock" and 0.01 <= m["bound"] <= 0.25
    for m in BENCHMARK["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["moves"] == "pairs_per_s"
        assert set(m["workloads"]) == set(WORKLOADS)
    assert len(json.dumps(BENCHMARK)) < 64 * 1024


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_finds_its_files_by_name(workload):
    cell = cells.load_cell(workload)
    assert cell.chips == 1
    assert {"descriptor", "icp", "ransac", "limits", "threads"} <= set(cell.config)
    assert cell.traffic["points"] == 1_000_000
    importlib.import_module(f"regbench.reference.{cell.config['reference']}").descriptors
    assert [m["name"] for m in cell.end_to_end] == [
        m["name"] for m in BENCHMARK["end_to_end"] if workload in m.get("workloads", [workload])]
    assert {"pairs_per_s", "setup_s"} <= {m["name"] for m in cell.end_to_end}
    assert len(cell.per_layer) == len(BENCHMARK["per_layer"])


@pytest.mark.parametrize("name", [m["name"] for m in BENCHMARK["per_layer"]])
def test_each_metric_has_a_reader_that_reads_nothing_from_nothing(name):
    reader = importlib.import_module(f"regbench.metrics.{name}")
    assert reader.read(harness.RunData(pairs=[], config={}, traffic={})) is None


def test_a_cell_a_mix_and_a_metric_added_as_files(tmp_path):
    """A new mix, configuration, cell and per-layer metric in a copy, each a
    file and an entry: the copy's harness runs the cell and reports the new
    metric beside the others."""
    root = tiny_checkout(tmp_path)
    (root / "regbench" / "metrics" / "pairs_seen.py").write_text(
        "def read(run):\n    return float(len(run.pairs)) if run.pairs else None\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "pairs_seen", "unit": "count", "better": "higher",
                               "source": "program_counter", "layer": "host issue",
                               "moves": "pairs_per_s", "workloads": [CELL]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    proc = run_cpu(root, "--workload", CELL, "--seed", "2147483701", "--seconds", "1",
                   "--trace", "1")
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = last_line(proc)
    assert line["correct"] is True, proc.stderr[-3000:]
    assert line["metrics"]["pairs_seen"]["value"] == line["attempted"]
    assert {"normals_ms", "icp_ms", "icp_iters"} <= set(line["metrics"])
    assert {"busy_s", "window_s"} <= set(line["device"])
