"""Whole runs of the harness on the CPU at the tiny size (its look for a
card skipped): the result line, ``correct`` on a sound run and under each
fault the cell can have, the control, and what a run may not load."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import textwrap

import pytest
import torch

from regbench import compare, generator, harness
from regbench.tests._tiny import (
    BENCH,
    CELL,
    DRIVE,
    REPO,
    TINY_LIMITS,
    TINY_TRAFFIC,
    last_line,
    run_cpu,
    tiny_checkout,
)

SEED = "2147483702"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_checkout(tmp_path_factory.mktemp("checkout"))


def test_sound_run_prints_the_contract_line(root):
    proc = run_cpu(root, "--workload", CELL, "--seed", SEED, "--seconds", "1", "--trace", "0")
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = last_line(proc)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True, line["checks"]
    assert set(line["metrics"]) == {"pairs_per_s", "pair_p90_s", "setup_s"}
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    assert set(line["checks"]) == set(TINY_LIMITS)
    tail = proc.stderr.strip().splitlines()[-len(TINY_LIMITS):]
    assert all(t.startswith("regbench check ") and " limit " in t for t in tail)


# faults planted in the timed path, each where its answer is produced
FAULTS = {
    "final transform altered": """
        orig = P.run_icp
        def run_icp(self, *a, **k):
            tf, rms, conv = orig(self, *a, **k)
            turn = torch.as_tensor([[1.0, -0.01, 0.0], [0.01, 1.0, 0.0], [0.0, 0.0, 1.0]])
            return RigidTransform(turn @ tf.rotation, tf.translation), rms, conv
        P.run_icp = run_icp""",
    "ICP returns its state unchanged": """
        orig = P.run_icp
        def run_icp(self, icp_type, transformation_init, **k):
            tf, rms, conv = orig(self, icp_type, transformation_init, **k)
            return transformation_init, rms, conv
        P.run_icp = run_icp""",
    "half of the keypoints left out": """
        orig = P.select_keypoints
        def select_keypoints(self, *a, **k):
            orig(self, *a, **k)
            self.scan_keypoints = self.scan_keypoints[::2]
        P.select_keypoints = select_keypoints""",
    "descriptors altered": """
        orig = P.compute_descriptors
        def compute_descriptors(self, *a, **k):
            orig(self, *a, **k)
            self.scan_descriptors = self.scan_descriptors.roll(1, dims=1)
        P.compute_descriptors = compute_descriptors""",
    "matches altered": """
        orig = P.find_descriptors_matches
        def find_descriptors_matches(self, *a, **k):
            orig(self, *a, **k)
            scan, ref = self.matches
            self.matches = (scan, np.roll(ref, 1))
        P.find_descriptors_matches = find_descriptors_matches""",
    "RANSAC transform altered": """
        orig = P.run_ransac
        def run_ransac(self, *a, **k):
            tf, ratio = orig(self, *a, **k)
            return RigidTransform(tf.rotation, tf.translation + 0.01), ratio
        P.run_ransac = run_ransac""",
    "normals altered": """
        orig = N.compute_normals
        def compute_normals(*a, **k):
            n = orig(*a, **k)
            return torch.where(torch.arange(n.shape[0])[:, None] % 3 == 0, n.roll(1, dims=1), n)
        N.compute_normals = compute_normals""",
}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_a_fault_in_the_timed_path_is_not_correct(root, fault):
    plant = textwrap.dedent("""
        import numpy as np, torch
        from shot_fpfh_tpu_torch.pipeline import RegistrationPipeline as P
        from shot_fpfh_tpu_torch.models import normals as N
        from shot_fpfh_tpu_torch.core.transform import RigidTransform
    """) + textwrap.dedent(FAULTS[fault])
    code = DRIVE.replace("from regbench.harness import main", plant + "\nfrom regbench.harness import main")
    proc = subprocess.run([sys.executable, "-c", code, "--workload", CELL, "--seed", SEED,
                           "--seconds", "1", "--trace", "0"], cwd=root, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = last_line(proc)
    assert line["correct"] is False, line["checks"]


def test_a_forbidden_module_loaded_by_the_check_leaves_no_result(root):
    """The look for JAX comes after the comparison and the metric readers:
    a module that the check loads late still stops the run."""
    plant = textwrap.dedent("""
        import types
        from regbench import compare
        orig = compare.program_readings
        def program_readings(*a, **k):
            sys.modules["jax"] = types.ModuleType("jax")
            return orig(*a, **k)
        compare.program_readings = program_readings
    """)
    code = DRIVE.replace("from regbench.harness import main", plant + "\nfrom regbench.harness import main")
    proc = subprocess.run([sys.executable, "-c", code, "--workload", CELL, "--seed", SEED,
                           "--seconds", "1", "--trace", "0"], cwd=root, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode != 0 and not proc.stdout.strip()
    assert "jax" in proc.stderr.strip().splitlines()[-1]


def test_the_control_is_not_correct():
    """The reference one precision lower in the program's place fails the
    tiny cell's limits, and the program on the same pair passes them."""
    torch.set_num_threads(2)
    bench = json.loads((BENCH / "configs" / "shot-1m.json").read_text())
    cfg = dict(bench, limits=TINY_LIMITS,
               check={"normals_sample": 256, "descriptor_sample": 64, "match_sample": 256})
    traffic = json.loads((BENCH / "traffic" / "dense.json").read_text())
    traffic.update(TINY_TRAFFIC)
    pair = generator.make_pair(traffic, 2147483703, 0, "cpu")
    _, out = harness.register_pair(pair, cfg, traffic, torch.device("cpu"))
    truth = [(out.icp[0], out.icp[1], pair.rotation, pair.translation)]
    ok, _ = compare.verdict(compare.program_readings({0: out}, truth, cfg, traffic, 5, "cpu"),
                            TINY_LIMITS)
    assert ok
    control = compare.control_readings(out, cfg, traffic, 5, "cpu")
    ok, rows = compare.verdict(control, TINY_LIMITS)
    assert not ok
    failing = {name for name, value, limit in rows if value > limit}
    assert {"truth_rot_err_rad", "normals_p90_rad", "keypoint_mismatch",
            "descriptor_err_p90", "icp_rot_gap_rad"} <= failing


def test_no_module_of_the_run_is_jax_or_the_jax_package():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        sys.path.insert(0, ".")
        import regbench, regbench.harness, regbench.readings
        from shot_fpfh_tpu_torch import pipeline, cli
        for sub in ("reference", "metrics"):
            pkg = importlib.import_module("regbench." + sub)
            for m in pkgutil.iter_modules(pkg.__path__):
                importlib.import_module(f"regbench.{sub}.{m.name}")
        print(sorted({m.split(".")[0] for m in sys.modules}))
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300, check=True)
    top = set(json.loads(proc.stdout.strip().replace("'", '"')))
    assert not top & {"jax", "jaxlib", "flax", "shot_fpfh_tpu"}
    assert "shot_fpfh_tpu_torch" in top


def test_the_reference_imports_nothing_of_the_program():
    code = textwrap.dedent("""
        import sys
        sys.path.insert(0, ".")
        import regbench.cells, regbench.compare, regbench.generator
        from regbench.reference import common, fpfh, shot_single_scale
        print(sorted({m.split(".")[0] for m in sys.modules}))
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300, check=True)
    top = set(json.loads(proc.stdout.strip().replace("'", '"')))
    assert not top & {"shot_fpfh_tpu_torch", "shot_fpfh_tpu", "jax"}


def _run_py(cwd):
    return subprocess.run([sys.executable, "regbench/run.py", "--workload", "shot1m.dense",
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_without_a_card_a_run_exits_with_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = _run_py(REPO)
    assert proc.returncode != 0 and not proc.stdout.strip()


def test_with_only_the_benchmark_a_run_exits_with_no_result(tmp_path):
    shutil.copytree(BENCH, tmp_path / "regbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    proc = _run_py(tmp_path)
    assert proc.returncode != 0 and not proc.stdout.strip()
