"""The cells of ``BENCHMARK.json``, read without NumPy or PyTorch: ``run.py``
reads a cell's CPU threads before either loads."""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """A workload of ``BENCHMARK.json`` with its configuration and mix."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list[dict]
    per_layer: list[dict]


def load_cell(workload: str) -> Cell:
    """The cell ``workload`` of ``BENCHMARK.json``: its configuration is the
    file its config entry names, its mix ``traffic/<traffic>.json`` in this
    folder, its metrics those that list it (or list no cells)."""
    bench = load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]

    def mine(metric):
        return workload in metric.get("workloads", [workload])

    return Cell(name=workload, chips=int(w["chips"]),
                config=load_json(ROOT / conf["file"]),
                traffic=load_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json"),
                end_to_end=[m for m in bench["end_to_end"] if mine(m)],
                per_layer=[m for m in bench["per_layer"] if mine(m)])
