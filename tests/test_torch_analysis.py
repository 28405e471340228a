"""Port parity: the ground-truth match analysis (``analysis.py``).

On the same numpy inputs, the port's functions against JAX's: the incorrect
match flags exactly; the Lowe ratios of correct and incorrect matches
within 1e-5 (descriptors of quarter steps in [-2, 2]: every bf16 operand and
f32 sum is exact, so both packages see the same distances); the 1-NN
distance histogram of ``check_transform`` (counts exact, edges 1e-5); the
plot helpers' data, drawn headless; ``RegistrationPipeline.analyze_matches``
on the same state; and the CLI's "incorrect matches" line, which must give
JAX's count when both CLIs are handed the same keypoints, descriptors and
matches.
"""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shot_fpfh_tpu import analysis as j_an
from shot_fpfh_tpu import cli as j_cli
from shot_fpfh_tpu import pipeline as j_pl
from shot_fpfh_tpu.core.transform import RigidTransform as JTransform
from shot_fpfh_tpu.core.transform import matrix_to_quaternion as j_matrix_to_quaternion
from shot_fpfh_tpu.models import normals as j_nm
from shot_fpfh_tpu_torch import analysis as t_an
from shot_fpfh_tpu_torch import cli as t_cli
from shot_fpfh_tpu_torch import pipeline as t_pl
from shot_fpfh_tpu_torch.core.transform import RigidTransform as TTransform
from shot_fpfh_tpu_torch.io.ply import write_ply
from shot_fpfh_tpu_torch.models import normals as t_nm

# The suite runs several pytest workers side by side on the CPU: one torch
# thread per worker keeps torch's OpenMP pool from oversubscribing the cores.
torch.set_num_threads(1)

LINE = "incorrect matches out of"


def _rotation(rng):
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    x, y, z, w = q
    return np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                     [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                     [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


@pytest.fixture
def case(rng):
    """A scan, its exactly moved copy as the ref (row i of each pairs up),
    and the exact scan→ref transform in both packages."""
    rot, t = _rotation(rng), rng.normal(size=3)
    scan = rng.uniform(-2, 2, size=(400, 3)).astype(np.float32)
    ref = (scan.astype(np.float64) @ rot.T + t).astype(np.float32)
    j_tf = JTransform(jnp.asarray(rot, jnp.float32), jnp.asarray(t, jnp.float32))
    return scan, ref, j_tf, TTransform.from_numpy(rot, t)


def _descriptors(rng, ref_n, scan_n):
    """Quarter-step descriptors: the scan's are the ref's of a random
    partner plus a sparse ±1/4 perturbation, so most nearest descriptors are
    the partner and every distance is exact in bf16 and f32."""
    ref = rng.integers(-8, 9, size=(ref_n, 352)).astype(np.float32) / 4
    partner = rng.integers(0, ref_n, size=scan_n)
    scan = ref[partner] + (rng.uniform(size=(scan_n, 352)) < 0.02) * 0.25
    return scan.astype(np.float32), ref


def test_get_incorrect_matches_equals_jax(rng, case):
    scan, ref, j_tf, t_tf = case
    # half the pairs moved well past 1e-2, the rest well inside it
    shift = np.where(rng.uniform(size=(len(ref), 1)) < 0.5, 0.05, 1e-4)
    noisy = (ref + shift * rng.choice([-1.0, 1.0], size=ref.shape)).astype(np.float32)
    want = j_an.get_incorrect_matches(scan, noisy, j_tf)
    got = t_an.get_incorrect_matches(scan, noisy, t_tf, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < len(got)


def test_lowe_ratio_split_matches_jax(rng, case):
    scan, ref, j_tf, t_tf = case
    scan_d, ref_d = _descriptors(rng, len(ref), len(scan))
    # every third scan descriptor is its own point's ref descriptor: correct
    own = np.arange(0, len(scan), 3)
    scan_d[own] = ref_d[own]
    want = j_an.lowe_ratio_split(scan, ref, j_tf, scan_d, ref_d)
    got = t_an.lowe_ratio_split(scan, ref, t_tf, scan_d, ref_d, device="cpu")
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)
    assert len(got[0]) >= len(own) and len(got[1]) > 0


def test_check_transform_histogram_matches_jax(rng, case, tmp_path, monkeypatch):
    scan, ref, j_tf, t_tf = case
    monkeypatch.chdir(tmp_path)
    noisy = (ref + rng.normal(scale=0.02, size=ref.shape)).astype(np.float32)
    want = j_an.check_transform(scan, noisy, j_tf, bins=20)
    got = t_an.check_transform(scan, noisy, t_tf, bins=20, output_path="port.png",
                               device="cpu")
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], atol=1e-5, rtol=0)
    assert (tmp_path / "port.png").is_file()


def test_plot_helpers_draw_headless_and_return_jax_data(rng, case, tmp_path, monkeypatch,
                                                        caplog):
    scan, ref, j_tf, t_tf = case
    monkeypatch.chdir(tmp_path)
    sizes = rng.integers(5, 60, size=300)
    with caplog.at_level(logging.INFO):
        want = j_an.plot_neighborhood_sizes(sizes, output_path="jax.png")
        got = t_an.plot_neighborhood_sizes(torch.tensor(sizes), output_path="port.png")
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    stats = [r.getMessage() for r in caplog.records
             if r.getMessage().startswith("Average size of neighborhoods")]
    assert len(stats) == 2 and stats[0] == stats[1]

    scan_d, ref_d = _descriptors(rng, len(ref), len(scan))
    got = t_an.plot_distance_hists(scan, ref, t_tf, scan_d, ref_d, device="cpu")
    split = t_an.lowe_ratio_split(scan, ref, t_tf, scan_d, ref_d, device="cpu")
    for g, w in zip(got, split):
        np.testing.assert_array_equal(g, w)
    assert (tmp_path / "port.png").is_file() and (tmp_path / "distance_hists.png").is_file()


def test_pca_features_verbose_logs_jax_statistics(rng, caplog, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    pts = rng.normal(size=(200, 3)).astype(np.float32)
    with caplog.at_level(logging.INFO):
        j_nm.compute_pca_based_features(pts[:40], pts, 0.8, verbose=True)
        feats = t_nm.compute_pca_based_features(pts[:40], pts, 0.8, verbose=True,
                                                device="cpu")
    stats = [r.getMessage() for r in caplog.records
             if r.getMessage().startswith("Average size of neighborhoods")]
    assert len(stats) == 2 and stats[0] == stats[1]
    assert feats.shape == (40, 21) and (tmp_path / "neighborhood_sizes.png").is_file()


def _state(rng, scan, ref):
    """Keypoints, descriptors and matches for both pipelines: every fifth
    point of each cloud, and each scan keypoint matched to its own ref
    keypoint except a deranged quarter."""
    kp = np.arange(0, len(scan), 5)
    m_ref = np.arange(len(kp))
    wrong = rng.choice(len(kp), size=len(kp) // 4, replace=False)
    m_ref[wrong] = np.roll(m_ref[wrong], 1)
    scan_d, ref_d = _descriptors(rng, len(kp), len(kp))
    return dict(scan_keypoints=kp, ref_keypoints=kp.copy(), scan_descriptors=scan_d,
                ref_descriptors=ref_d, matches=(np.arange(len(kp)), m_ref)), len(wrong)


@pytest.mark.parametrize("algorithm", ["simple", "ratio"])
def test_analyze_matches_equals_jax(rng, case, caplog, algorithm):
    scan, ref, j_tf, t_tf = case
    state, n_wrong = _state(rng, scan, ref)
    clouds = dict(scan=scan, scan_normals=scan, ref=ref, ref_normals=ref)
    j_pipe, t_pipe = j_pl.RegistrationPipeline(**clouds), t_pl.RegistrationPipeline(
        **clouds, device="cpu")
    for pipe in (j_pipe, t_pipe):
        for name, value in state.items():
            setattr(pipe, name, value)
    with caplog.at_level(logging.INFO):
        want = j_pipe.analyze_matches(algorithm, j_tf)
        got = t_pipe.analyze_matches(algorithm, t_tf)
    lines = [r.getMessage() for r in caplog.records if LINE in r.getMessage()]
    assert lines == [f"{n_wrong} incorrect matches out of {len(scan) // 5} matches and "
                     f"{len(scan) // 5} descriptors."] * 2
    if algorithm == "simple":
        np.testing.assert_array_equal(got, want)
    else:
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)


def test_cli_logs_incorrect_matches_like_jax(rng, tmp_path, monkeypatch, caplog):
    """Both CLIs on the same pair and .conf ground truth, handed the same
    keypoints, descriptors and matches, log the same incorrect-match line."""
    rot, t = _rotation(rng), rng.normal(size=3) * 0.3
    xy = rng.uniform(-2, 2, size=(1500, 2))
    ref = np.column_stack([xy, 0.3 * np.sin(2 * xy[:, 0])]).astype(np.float32)
    # the scan is the ref moved by T⁻¹, so T maps the scan onto the ref
    scan = ((ref.astype(np.float64) - t) @ rot).astype(np.float32)
    for name, cloud in (("scan", scan), ("ref", ref)):
        write_ply(str(tmp_path / f"{name}.ply"), [cloud], ["x", "y", "z"])
    q = np.asarray(j_matrix_to_quaternion(jnp.asarray(rot, jnp.float64)))
    (tmp_path / "pair.conf").write_text(
        f"bmesh scan.ply {t[0]} {t[1]} {t[2]} {q[3]} {q[0]} {q[1]} {q[2]}\n"
        "bmesh ref.ply 0 0 0 1 0 0 0\n")
    state, n_wrong = _state(rng, scan, ref)

    def select_keypoints(self, *args, **kwargs):
        self.scan_keypoints, self.ref_keypoints = state["scan_keypoints"], state["ref_keypoints"]

    def compute_descriptors(self, *args, **kwargs):
        self.scan_descriptors = state["scan_descriptors"]
        self.ref_descriptors = state["ref_descriptors"]

    def find_descriptors_matches(self, *args, **kwargs):
        self.matches = state["matches"]

    for module in (j_pl, t_pl):
        for fn in (select_keypoints, compute_descriptors, find_descriptors_matches):
            monkeypatch.setattr(module.RegistrationPipeline, fn.__name__, fn)
    argv = ["--scan_file_path", str(tmp_path / "scan.ply"),
            "--ref_file_path", str(tmp_path / "ref.ply"),
            "--conf_file_path", str(tmp_path / "pair.conf"), "--disable_ply_writing",
            "--radius", "0.3", "--neighborhood_size", "0.2", "--normals_k", "10",
            "--n_draws", "100", "--max_iter", "3"]
    with caplog.at_level(logging.INFO):
        j_cli.main(argv)
        t_cli.main(argv + ["--device", "cpu"])
    lines = [r.getMessage() for r in caplog.records if LINE in r.getMessage()]
    assert lines == [f"{n_wrong} incorrect matches out of {len(state['matches'][0])} matches "
                     f"and {len(state['scan_keypoints'])} descriptors."] * 2
