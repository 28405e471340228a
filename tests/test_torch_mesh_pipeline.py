"""The mesh wired into the port's product: ``RegistrationPipeline(mesh=)``
and ``cli.main --n_devices 2`` on a 2-rank gloo group on the CPU give what
one rank gives.

A module-scoped fixture writes a small pair (``.ply`` and ``.npz``) and
launches two ranks (``sys.executable -c WORKER``, a ``file://`` store in
``tmp_path``, collectives under a 120 s timeout).  Each rank runs the
pipeline over the mesh (SHOT and FPFH, ratio matching, RANSAC, ICP) and the
CLI with ``--n_devices 2``, with ``--n_procs 2`` and with ``--fused`` over
the launch's two ranks (the single program sharded:
``registration.fused.fused_registration_mesh``), each rank told its own
output paths, so the test sees that only rank 0 wrote.  Held to one rank:
the same matches, ICP within 1e-3 rad / 1e-3 (JAX
``tests/test_mesh_pipeline.py``), and the CLI's moved scan within 1e-3 of
``--n_devices 1``'s, and with ``--fused`` of one device's ``--fused`` (JAX
``test_cli_n_devices_same_transform``,
``test_cli_fused_n_devices_same_transform``).  Each rank also runs the CLI
with ``--n_devices 1``, which a launch of two ranks refuses before any
stage.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
from bench import make_terrain  # noqa: E402
from shot_fpfh_tpu_torch.core.transform import rotation_angle  # noqa: E402
from shot_fpfh_tpu_torch.io.ply import read_ply, write_ply  # noqa: E402

# The suite runs several pytest workers side by side on the CPU: one torch
# thread per worker keeps torch's OpenMP pool from oversubscribing the cores
# (it slowed every worker, JAX tests included, by up to 2x).
torch.set_num_threads(1)

PIPELINE = dict(keypoint_voxel=0.25, radius=0.5, n_draws=1200, d_max=0.3)
# the CLI's runs on two ranks: each mesh flag, and --fused over the launch
# (default --n_devices 0) with the keypoints the fused program covers
FUSED_ARGS = ["--fused", "--selection_algorithm", "subsampling"]
CLI_RUNS = {"n_devices": ["--n_devices", "2"], "n_procs": ["--n_procs", "2"],
            "fused": FUSED_ARGS}

WORKER = r'''
import json
import sys
import numpy as np
import torch

torch.set_num_threads(1)
rank, store, tmp, repo = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
sys.path.insert(0, repo)
from shot_fpfh_tpu_torch import cli
from shot_fpfh_tpu_torch.parallel import make_mesh
from shot_fpfh_tpu_torch.pipeline import RegistrationPipeline
sys.path.insert(0, repo + "/tests")
from test_torch_mesh_pipeline import run_pipeline

mesh = make_mesh(device="cpu", init_method="file://" + store, rank=rank, world_size=2,
                 timeout=120)
pair = dict(np.load(tmp + "/pair.npz"))
out = {}
for choice in ("shot_single_scale", "fpfh"):
    p, rot, t = run_pipeline(pair, mesh, choice)
    out[choice + "/matches"] = np.stack(p.matches)
    out[choice + "/transform"] = np.concatenate([rot.ravel(), t])
codes = []
for run, extra in json.loads(open(tmp + "/cli_runs.json").read()).items():
    tag = f"{run}_rank{rank}"
    argv = json.loads(open(tmp + "/cli_args.json").read()) + extra + [
        "--output_dir", f"{tmp}/{tag}", "--metrics_json", f"{tmp}/{tag}.json"]
    codes.append(cli.main(argv))
out["codes"] = np.asarray(codes)
# in a launch of two ranks, --n_devices 1 is refused before any stage runs
try:
    cli.main(json.loads(open(tmp + "/cli_args.json").read())
             + ["--n_devices", "1", "--output_dir", f"{tmp}/one_device_rank{rank}"])
    out["refusal/one_device"] = np.asarray("no error")
except ValueError as exc:
    out["refusal/one_device"] = np.asarray(f"{type(exc).__name__}: {exc}")
np.savez(f"{tmp}/rank{rank}.npz", **out)
'''


def run_pipeline(pair, mesh, descriptor):
    """The pipeline on ``pair`` (arrays ``scan``, ``ref`` and their normals)
    over ``mesh`` (None: one device): ``(pipeline, ICP rotation, ICP
    translation)``."""
    from shot_fpfh_tpu_torch.pipeline import RegistrationPipeline

    p = RegistrationPipeline(scan=pair["scan"], scan_normals=pair["scan_n"], ref=pair["ref"],
                             ref_normals=pair["ref_n"], k_max_descriptor=256, k_max_fpfh=96,
                             device="cpu", mesh=mesh)
    p.select_keypoints("subsampling", neighborhood_size=PIPELINE["keypoint_voxel"])
    p.compute_descriptors(radius=PIPELINE["radius"], descriptor_choice=descriptor,
                          subsample_support=False, min_neighborhood_size=10)
    p.find_descriptors_matches("ratio", reject_threshold=0.9)
    tf, _ = p.run_ransac(n_draws=PIPELINE["n_draws"], draw_size=4, max_inliers_distance=0.1)
    tf, _, _ = p.run_icp("point_to_plane", tf, d_max=PIPELINE["d_max"], voxel_size=0.1,
                         max_iter=40, rms_threshold=1e-5)
    return p, tf.rotation.numpy(), tf.translation.numpy()


def _bumpy(n, rng, scale=2.0, n_bumps=12):
    xy = rng.uniform(-scale, scale, size=(n, 2))
    z = np.zeros(n)
    for c, h, w in zip(rng.uniform(-scale, scale, size=(n_bumps, 2)),
                       rng.uniform(-0.6, 0.6, size=n_bumps), rng.uniform(0.2, 0.7, size=n_bumps)):
        z += h * np.exp(-np.sum((xy - c) ** 2, axis=1) / (2 * w ** 2))
    return (np.column_stack([xy, z]) + rng.normal(scale=0.003, size=(n, 3))).astype(np.float32)


def _rotation(angle, axis):
    axis = np.asarray(axis, float) / np.linalg.norm(axis)
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * k @ k


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The two ranks' results, with the inputs they were given."""
    from shot_fpfh_tpu_torch.models.normals import compute_normals

    tmp = tmp_path_factory.mktemp("mesh")
    rng = np.random.default_rng(7)
    ref = _bumpy(1800, rng)
    scan = (ref @ _rotation(0.35, [0.2, 0.4, 1.0]).T + [0.3, -0.2, 0.1]).astype(np.float32)
    pair = {"scan": scan, "ref": ref,
            "scan_n": compute_normals(scan, scan, k=20, device="cpu").numpy(),
            "ref_n": compute_normals(ref, ref, k=20, device="cpu").numpy()}
    np.savez(tmp / "pair.npz", **pair)
    # the CLI's pair: a terrain of a few thousand points and a moved copy
    cli_ref = make_terrain(4000, rng, scale=3.0, n_bumps=12)
    rot = _rotation(np.deg2rad(12.0), [0.3, -0.2, 1.0])
    cli_scan = (cli_ref @ rot.T + [0.3, -0.2, 0.1]
                + rng.normal(scale=0.003, size=cli_ref.shape)).astype(np.float32)
    write_ply(str(tmp / "scan.ply"), [cli_scan], ["x", "y", "z"])
    write_ply(str(tmp / "ref.ply"), [cli_ref], ["x", "y", "z"])
    argv = ["--device", "cpu", "--scan_file_path", str(tmp / "scan.ply"),
            "--ref_file_path", str(tmp / "ref.ply"), "--conf_file_path", "",
            "--neighborhood_size", "0.2", "--min_n_neighbors", "2", "--radius", "0.6",
            "--rho", "20", "--n_draws", "300", "--max_iter", "10", "--normals_k", "20"]
    (tmp / "cli_args.json").write_text(json.dumps(argv))
    (tmp / "cli_runs.json").write_text(json.dumps(CLI_RUNS))
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), str(tmp / "store"),
                               str(tmp), str(REPO)], cwd=tmp, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    logs = [p.communicate(timeout=600)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return tmp, pair, argv, [dict(np.load(tmp / f"rank{r}.npz")) for r in range(2)], logs


@pytest.mark.parametrize("descriptor", ["shot_single_scale", "fpfh"])
def test_pipeline_mesh_matches_one_rank(ranks, descriptor):
    _, pair, _, results, _ = ranks
    p1, rot1, t1 = run_pipeline(pair, None, descriptor)
    for res in results:
        np.testing.assert_array_equal(res[descriptor + "/matches"], np.stack(p1.matches))
        rot, t = res[descriptor + "/transform"][:9].reshape(3, 3), res[descriptor + "/transform"][9:]
        assert float(rotation_angle(torch.tensor(rot), torch.tensor(rot1))) < 1e-3
        assert np.linalg.norm(t - t1) < 1e-3


def _moved_scan(path):
    data = read_ply(str(path))
    is_scan = data["is_scan"] > 0
    return np.stack([data[c][is_scan] for c in "xyz"], axis=1)


@pytest.mark.parametrize("flag", ["n_devices", "n_procs"])
def test_cli_two_ranks_match_one_rank(ranks, flag, tmp_path):
    from shot_fpfh_tpu_torch.cli import main

    tmp, _, argv, results, logs = ranks
    code = main(argv + ["--n_devices", "1", "--output_dir", str(tmp_path)])
    column = list(CLI_RUNS).index(flag)
    assert code == 0 and [int(r["codes"][column]) for r in results] == [0, 0]
    for log in logs:   # every rank logs the result, every run over the mesh
        assert log.count("Sharding pipeline stages over a 2-rank mesh") == len(CLI_RUNS)
        assert log.count("registration ACCEPTED") == len(CLI_RUNS)
    # rank 0 alone wrote its outputs
    assert not (tmp / f"{flag}_rank1").exists() and not (tmp / f"{flag}_rank1.json").exists()
    assert json.loads((tmp / f"{flag}_rank0.json").read_text())["stages"]
    for stage in ("post_ransac", "post_icp"):
        got = _moved_scan(tmp / f"{flag}_rank0" / f"scan_on_ref_{stage}.ply")
        want = _moved_scan(tmp_path / f"scan_on_ref_{stage}.ply")
        assert np.abs(got - want).max() < 1e-3


def test_cli_fused_two_ranks_match_one_device(ranks, tmp_path):
    """``--fused`` in a 2-rank launch runs the single program over the mesh
    (one ``fused`` stage, no staging warning), rank 0 alone writes, and its
    moved scans are within 1e-3 of one device's ``--fused`` (JAX
    ``test_cli_fused_n_devices_same_transform``)."""
    from shot_fpfh_tpu_torch.cli import main

    tmp, _, argv, results, logs = ranks
    code = main(argv + FUSED_ARGS + ["--n_devices", "1", "--output_dir", str(tmp_path)])
    assert code == 0 and [int(r["codes"][list(CLI_RUNS).index("fused")]) for r in results] \
        == [0, 0]
    for log in logs:
        assert log.count("Fused single-program registration") == 1
        assert "staging instead" not in log
    assert not (tmp / "fused_rank1").exists() and not (tmp / "fused_rank1.json").exists()
    stages = json.loads((tmp / "fused_rank0.json").read_text())["stages"]
    assert [s["stage"] for s in stages] == ["fused"] and stages[0]["matches"] > 20
    for stage in ("post_ransac", "post_icp"):
        got = _moved_scan(tmp / "fused_rank0" / f"scan_on_ref_{stage}.ply")
        want = _moved_scan(tmp_path / f"scan_on_ref_{stage}.ply")
        assert np.abs(got - want).max() < 1e-3


@pytest.mark.parametrize("case,error,words", [
    ("one_device", "ValueError", "--n_devices 1 in a launch of 2 ranks")])
def test_cli_refuses_in_a_two_rank_launch(ranks, case, error, words):
    """Every rank of a 2-rank launch refuses ``--n_devices 1`` (each would
    register alone and write the same outputs) before any stage runs."""
    tmp, _, _, results, _ = ranks
    for res in results:
        msg = str(res["refusal/" + case])
        assert msg.startswith(error + ":") and words in msg, msg
    assert not any((tmp / f"{case}_rank{r}").exists() for r in range(2))


@pytest.mark.parametrize("devices,own", [
    (["h/cuda:0", "h/cuda:1"], True), (["h/cuda:0", "g/cuda:0"], True),
    (["h/cuda:0", "h/cuda:0"], False), (["h/cpu", "h/cpu"], False),
    (["h/cuda:0", "h/cpu"], False), (["h/cuda:0"], True)])
def test_backend_needs_a_card_a_rank(devices, own):
    """NCCL only when every rank has a card of its own: two ranks given
    one indexed card (``--device cuda:0`` on every rank) take gloo."""
    from shot_fpfh_tpu_torch.parallel.mesh import own_cards

    assert own_cards(devices) is own


def test_cli_rejects_another_mesh_axis():
    from shot_fpfh_tpu_torch.cli import main

    with pytest.raises(ValueError, match="mesh axis must be 'points'"):
        main(["--device", "cpu", "--mesh_axis", "other"])
