"""A copy of the benchmark at a size the CPU runs in seconds: the folder
and ``BENCHMARK.json`` copied to a temporary root, the port linked in, and
a tiny mix, configuration and cell added as files and entries alone (as a
later change adds a cell)."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "regbench"
CELL = "shot.tiny"

# a 12,000-point patch of the terrain: below the port's grid threshold, so
# every stage takes its brute route on the CPU
TINY_TRAFFIC = {"points": 12000, "extent": 3.0, "pool": 2,
                "keypoint_selection": {"selection_algorithm": "subsampling_with_density",
                                       "neighborhood_size": 0.15, "min_n_neighbors": 5}}
# limits for the tiny cell, from readings of seeds 1 and 2 on the CPU (the
# truth errors at most 2.8e-4 rad and 7.4e-4, every other number at most
# 1.5e-5, 0.0017 for the match gap) and of the control on seed 3 (truth
# errors 4.7e-3 rad and 0.017, every other number at least 2.5e-4, 0.030 for
# the match gap)
TINY_LIMITS = {"truth_rot_err_rad": 1.5e-3, "truth_t_err": 4e-3, "normals_p90_rad": 1e-4, "keypoint_mismatch": 1e-4,
               "descriptor_err_p90": 1e-4, "match_gap_max": 0.015,
               "ransac_rot_gap_rad": 1e-4, "ransac_t_gap": 1e-4,
               "icp_rot_gap_rad": 1e-4, "icp_t_gap": 1e-4,
               "overlap_gap": 1e-4, "inlier_gap": 1e-4}
TINY_CHECK = {"normals_sample": 256, "descriptor_sample": 64, "match_sample": 256}


def tiny_checkout(root: Path) -> Path:
    """The benchmark copied under ``root`` with the tiny cell added."""
    shutil.copytree(BENCH, root / "regbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    (root / "shot_fpfh_tpu_torch").symlink_to(REPO / "shot_fpfh_tpu_torch")
    (root / "pyproject.toml").symlink_to(REPO / "pyproject.toml")

    traffic = json.loads((BENCH / "traffic" / "dense.json").read_text())
    traffic.update(TINY_TRAFFIC)
    (root / "regbench" / "traffic" / "tiny.json").write_text(json.dumps(traffic))
    config = json.loads((BENCH / "configs" / "shot-1m.json").read_text())
    config.update(check=TINY_CHECK, limits=TINY_LIMITS)
    (root / "regbench" / "configs" / "shot-tiny.json").write_text(json.dumps(config))

    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "shot-tiny", "source": "a test's copy",
                             "file": "regbench/configs/shot-tiny.json", "reduced": [],
                             "why": "CPU-sized SHOT"})
    bench["workloads"].append({"name": CELL, "config": "shot-tiny", "traffic": "tiny",
                               "chips": 1, "why": "CPU-sized SHOT pairs"})
    for metric in bench["per_layer"] + bench["end_to_end"]:
        metric.get("workloads", []).append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


DRIVE = """
import sys
sys.path.insert(0, ".")
import torch
torch.set_num_threads(2)
from regbench.harness import main
raise SystemExit(main(sys.argv[1:], require_cuda=False))
"""


def run_cpu(root: Path, *args: str, timeout: int = 600) -> subprocess.CompletedProcess:
    """A run of the copy's harness on the CPU (its look for a card skipped)."""
    return subprocess.run([sys.executable, "-c", DRIVE, *args], cwd=root, capture_output=True,
                          text=True, timeout=timeout)


def last_line(proc: subprocess.CompletedProcess) -> dict:
    return json.loads(proc.stdout.strip().splitlines()[-1])
