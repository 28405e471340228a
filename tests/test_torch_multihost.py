"""The port's multi-process entry point and helpers
(``shot_fpfh_tpu_torch.parallel.multihost``), mirroring JAX's
``tests/test_multihost.py`` and ``tests/test_sharded.py``'s multi-host
tests on the CPU.

A module-scoped fixture writes a ``make_pair`` of 1,500 points to ``.ply``
files and launches two processes (``sys.executable -c WORKER``) that join
through ``initialize_distributed("127.0.0.1:<free port>", 2, pid,
device="cpu")`` (a ``tcp://`` store on rank 0, gloo, collectives under a
120 s timeout; the group ended at exit by ``shutdown_distributed``).  Each
runs ``run_multihost`` on the pair, then the helpers over the launch
(``host_local_keypoint_shard`` and
``global_keypoint_array`` on 15 and on 1 rows: uneven and empty blocks)
and ``scaling_report`` for each stage with counts (1, 0).  Held: both
processes' results equal within 1e-6, within 1e-3 of a single-process run
and within 0.02 rad of the ground truth; single-process FPFH with
oriented normals in the ``.ply`` within 0.03 rad; the helpers give back
the whole array; ``scaling_report`` reports every count and, over two
ranks, an efficiency.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
from shot_fpfh_tpu_torch.core.transform import rotation_angle  # noqa: E402
from shot_fpfh_tpu_torch.io.ply import write_ply  # noqa: E402
from shot_fpfh_tpu_torch.parallel import (  # noqa: E402
    global_keypoint_array,
    host_local_keypoint_shard,
    initialize_distributed,
    make_mesh,
    scaling_report,
)
from shot_fpfh_tpu_torch.parallel.mesh import shutdown_distributed  # noqa: E402
from shot_fpfh_tpu_torch.parallel.multihost import run_multihost  # noqa: E402
from tests.test_pipeline import make_pair  # noqa: E402

# The suite runs several pytest workers side by side on the CPU: one torch
# thread per worker keeps torch's OpenMP pool from oversubscribing the cores
# (it slowed every worker, JAX tests included, by up to 2x).
torch.set_num_threads(1)

PROCESSES = 2
RUN = dict(n_draws=800, max_iter=30)
# scaling_report at a size the CPU runs in seconds
SCALING = dict(n_keypoints=64, n_support=2000, radius=1.0, k_max=32, reps=1)
STAGES = ("shot", "fpfh", "matching")
HELPER_ROWS = (15, 1)

WORKER = r'''
import json
import sys
import numpy as np
import torch

torch.set_num_threads(1)
coord, pid, scan, ref, out, repo, spec = (sys.argv[1], int(sys.argv[2]), sys.argv[3],
                                          sys.argv[4], sys.argv[5], sys.argv[6],
                                          json.loads(sys.argv[7]))
sys.path.insert(0, repo)
from shot_fpfh_tpu_torch.parallel import (global_keypoint_array, host_local_keypoint_shard,
                                          make_mesh, scaling_report)
from shot_fpfh_tpu_torch.parallel.multihost import run_multihost

res = {"run": run_multihost(scan, ref, coordinator_address=coord, num_processes=2,
                            process_id=pid, device="cpu", timeout=120, **spec["run"])}
mesh = make_mesh(device="cpu")
for n in spec["helper_rows"]:
    kp = np.arange(3 * n, dtype=np.float32).reshape(n, 3)
    local = host_local_keypoint_shard(kp)
    res[f"helpers/{n}"] = {"local": local.tolist(),
                           "global": global_keypoint_array(local, mesh).tolist()}
for stage in spec["stages"]:
    report = scaling_report(device_counts=(1, 0), stage=stage, device="cpu", **spec["scaling"])
    res[f"scaling/{stage}"] = {str(k): v for k, v in report.items()}
with open(out, "w") as f:
    json.dump(res, f)
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _write_pair(tmp: Path, oriented: bool = False):
    rng = np.random.default_rng(13)
    scan, ref, exact = make_pair(rng, n=1500)
    paths = []
    for name, pts in (("scan", scan), ("ref", ref)):
        pts = pts.astype(np.float32)
        cols, names = [pts], ["x", "y", "z"]
        if oriented:
            # FPFH's Darboux angles flip with the normal's sign: normals
            # pointing up on both clouds (JAX test_multihost.py:90-98)
            from shot_fpfh_tpu_torch.models.normals import compute_normals

            n = compute_normals(pts, pts, k=20, device="cpu").numpy()
            cols.append(np.where(n[:, 2:3] < 0, -n, n).astype(np.float32))
            names += ["nx", "ny", "nz"]
        paths.append(str(tmp / f"{name}.ply"))
        write_ply(paths[-1], cols, names)
    return paths[0], paths[1], exact


@pytest.fixture(scope="module")
def launch(tmp_path_factory):
    """The two processes' results and the pair they were given."""
    tmp = tmp_path_factory.mktemp("multihost")
    scan_path, ref_path, exact = _write_pair(tmp)
    coord = f"127.0.0.1:{_free_port()}"
    spec = json.dumps({"run": RUN, "helper_rows": HELPER_ROWS, "stages": STAGES,
                       "scaling": SCALING})
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    outs = [tmp / f"result_{pid}.json" for pid in range(PROCESSES)]
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, coord, str(pid), scan_path,
                               ref_path, str(outs[pid]), str(REPO), spec], cwd=tmp, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for pid in range(PROCESSES)]
    logs = [p.communicate(timeout=600)[0] for p in procs]
    for pid, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"process {pid}:\n{log[-4000:]}"
    return [json.loads(o.read_text()) for o in outs], scan_path, ref_path, exact


@pytest.fixture(scope="module")
def single(launch):
    _, scan_path, ref_path, _ = launch
    return run_multihost(scan_path, ref_path, device="cpu", **RUN)


def _angle(rot, want) -> float:
    return float(rotation_angle(torch.tensor(rot, dtype=torch.float32),
                                torch.tensor(np.array(want), dtype=torch.float32)))


def test_two_processes_agree(launch):
    results = [r["run"] for r in launch[0]]
    for pid, res in enumerate(results):
        assert res["process_id"] == pid and res["process_count"] == PROCESSES
        assert res["n_devices"] == PROCESSES and res["icp_converged"]
    np.testing.assert_allclose(results[0]["rotation"], results[1]["rotation"], atol=1e-6)
    np.testing.assert_allclose(results[0]["translation"], results[1]["translation"],
                               atol=1e-6)
    assert results[0]["n_matches"] == results[1]["n_matches"] > 20


def test_two_processes_match_one_process(launch, single):
    res = launch[0][0]["run"]
    assert single["process_count"] == single["n_devices"] == 1
    assert single["n_matches"] == res["n_matches"]
    np.testing.assert_allclose(res["rotation"], single["rotation"], atol=1e-3)
    np.testing.assert_allclose(res["translation"], single["translation"], atol=1e-3)


def test_two_processes_recover_ground_truth(launch):
    res, exact = launch[0][0]["run"], launch[3]
    assert _angle(res["rotation"], exact.rotation) < 0.02
    assert np.linalg.norm(np.asarray(res["translation"]) - np.asarray(exact.translation)) < 0.05


def test_run_multihost_single_process_fpfh(tmp_path):
    """The FPFH leg of ``run_multihost`` in one process, with consistently oriented
    normals stored in the ``.ply`` (``get_data``'s normal-ingest path):
    PCA normals carry random signs, which FPFH's angles do not forgive."""
    scan_path, ref_path, exact = _write_pair(tmp_path, oriented=True)
    res = run_multihost(scan_path, ref_path, descriptor_choice="fpfh", radius=0.4,
                        reject_threshold=0.95, n_draws=2000, max_iter=40, device="cpu")
    assert res["process_count"] == 1
    assert _angle(res["rotation"], exact.rotation) < 0.03


def test_multihost_helpers_single_process():
    initialize_distributed()    # one process: nothing to start
    kp = np.arange(48, dtype=np.float32).reshape(16, 3)
    local = host_local_keypoint_shard(kp)
    np.testing.assert_array_equal(local, kp)
    full = global_keypoint_array(local, make_mesh(device="cpu"))
    assert isinstance(full, torch.Tensor) and full.shape == (16, 3)
    np.testing.assert_array_equal(full.numpy(), kp)


@pytest.mark.parametrize("n", HELPER_ROWS)
def test_multihost_helpers_two_processes(launch, n):
    """Ceil-div blocks (15 rows: 8 and 7; 1 row: 1 and none) gathered back
    to the whole array on every rank."""
    kp = np.arange(3 * n, dtype=np.float32).reshape(n, 3)
    per = -(-n // PROCESSES)
    for pid, res in enumerate(launch[0]):
        helpers = res[f"helpers/{n}"]
        np.testing.assert_array_equal(np.asarray(helpers["local"]).reshape(-1, 3),
                                      kp[pid * per:(pid + 1) * per])
        np.testing.assert_array_equal(np.asarray(helpers["global"]), kp)


@pytest.mark.parametrize("stage", STAGES)
def test_scaling_report_runs(stage):
    """One process: counts 1 and 0 are both the one device."""
    res = scaling_report(device_counts=(1, 0), stage=stage, device="cpu", **SCALING)
    assert set(res) == {1} and res[1] > 0


@pytest.mark.parametrize("stage", STAGES)
def test_scaling_report_two_processes(launch, stage):
    """Two processes: the one device and the 2-rank mesh, and their
    efficiency (a number, not a bound: CPU ranks share the cores)."""
    for res in launch[0]:
        report = res[f"scaling/{stage}"]
        assert set(report) == {"1", "2", "efficiency"}
        assert report["1"] > 0 and report["2"] > 0 and report["efficiency"] > 0


def test_shutdown_distributed_without_a_group_does_nothing():
    assert not torch.distributed.is_initialized()
    shutdown_distributed()
    assert not torch.distributed.is_initialized()


def test_scaling_report_rejects_an_unknown_stage():
    with pytest.raises(ValueError, match="unknown stage 'bogus'"):
        scaling_report(stage="bogus", device="cpu")


@pytest.mark.parametrize("entry", ["run_multihost", "scaling_report"])
def test_entry_points_default_to_cuda(entry):
    """No device given: the rank's device is ``cuda``, so without a card
    each raises instead of running quietly on the CPU."""
    call = {"run_multihost": lambda: run_multihost("scan.ply", "ref.ply"),
            "scaling_report": lambda: scaling_report(n_keypoints=8, n_support=64)}[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
