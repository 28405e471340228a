"""Multiscale SHOT at ``shot-multiscale-1m``'s widths on the card: one
10^6-point pair of the benchmark's dense mix through
``RegistrationPipeline`` as the benchmark drives it.  Both scales take the
grid (SG twice a cloud: own frames at 3.0 on the 0.3 support, then the
given-frames mode at 9.0 on the 0.9 support, which holds ~3.6k points),
and the descriptor stage launches no K1, K7 or K8 and runs neither the
brute, ``k_max``-capped search nor the PyTorch binning.  The rows equal the
plain reference (``regbench/reference/shot_multiscale.py``) within the
configuration's descriptor limit, as the benchmark's check reads them.

Marked ``gpu``: each test skips without a CUDA device (decided inside the
fixture).  Run on a GPU machine from the repository's root with
``python -m pytest --noconftest -m gpu tests/test_torch_multiscale_gpu.py
-q -p no:cacheprovider`` (the suite's ``conftest.py`` imports JAX; this file
needs only torch).
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
from regbench import generator  # noqa: E402
from regbench.cells import load_cell  # noqa: E402
from regbench.reference import shot_multiscale  # noqa: E402
from shot_fpfh_tpu_torch import _kernels  # noqa: E402
from shot_fpfh_tpu_torch.models import shot as t_shot  # noqa: E402

pytestmark = pytest.mark.gpu

SEED = 2147483993
SAMPLE = 128        # keypoints of each cloud held to the reference


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU or interpret mode")
    return torch.device("cuda", 0)


def test_multiscale_pair_takes_sg_at_both_scales(cuda, monkeypatch):
    from shot_fpfh_tpu_torch.models.normals import compute_normals
    from shot_fpfh_tpu_torch.pipeline import RegistrationPipeline

    cell = load_cell("shot1m.multiscale")
    cfg, traffic = cell.config, cell.traffic
    pair = generator.make_pair(traffic, SEED, 0, cuda)
    k = int(cfg["normals"]["k"])
    normals = {side: compute_normals(getattr(pair, side), getattr(pair, side), k=k,
                                     device=cuda).cpu().numpy() for side in ("scan", "ref")}
    pipe = RegistrationPipeline(scan=pair.scan, scan_normals=normals["scan"], ref=pair.ref,
                                ref_normals=normals["ref"],
                                k_max_descriptor=cfg["compute"]["k_max_descriptor"],
                                k_max_fpfh=cfg["compute"]["k_max_fpfh"], device=cuda)
    kp = traffic["keypoint_selection"]
    pipe.select_keypoints(kp["selection_algorithm"], neighborhood_size=kp["neighborhood_size"],
                          min_n_neighbors=kp["min_n_neighbors"])
    plain = []
    for name in ("radius_search", "soft_histogram"):
        real = getattr(t_shot, name)
        monkeypatch.setattr(t_shot, name,
                            lambda *a, _n=name, _f=real, **kw: plain.append(_n) or _f(*a, **kw))
    _kernels.reset_launch_counts()
    pipe.compute_descriptors(**cfg["descriptor"])
    torch.cuda.synchronize()
    counts = dict(_kernels.launch_counts)
    stage = pipe.metrics.stages[-1]
    assert stage["stage"] == "descriptors[shot_multiscale]"
    assert counts["shot_grid"] == 4 and stage["grid_passes"] == 4 and stage["chunks"] == 0
    for name in ("shot_binning_histogram", "radius_dist", "fetch_windows", "shot_runs"):
        assert counts[name] == 0, name
    assert plain == []
    assert stage["scales"] == 4 and stage["spans"]["shot.scale"]["count"] == 4
    assert 60_000 < stage["support_points"] < 80_000
    assert pipe.scan_descriptors.shape == (len(pipe.scan_keypoints), 704)

    rng = np.random.default_rng(SEED)
    errs = []
    for side in ("scan", "ref"):
        keypoints = np.asarray(getattr(pipe, f"{side}_keypoints"))
        rows = np.sort(rng.choice(len(keypoints), SAMPLE, replace=False))
        want = shot_multiscale.descriptors(
            torch.as_tensor(getattr(pair, side), device=cuda),
            torch.as_tensor(normals[side], dtype=torch.float64, device=cuda),
            torch.as_tensor(keypoints[rows], device=cuda), cfg, torch.float64)
        got = getattr(pipe, f"{side}_descriptors")[torch.as_tensor(rows, device=cuda)]
        errs.append((got.double() - want).norm(dim=1)
                    / want.norm(dim=1).clamp(min=1e-12))
        # the second scale bins: the 9.0 neighbourhoods hold ~465 support points
        assert float((want[:, 352:].norm(dim=1) > 0).double().mean()) > 0.9
    p90 = float(torch.quantile(torch.cat(errs).cpu(), 0.9))
    print(json.dumps({"descriptor_err_p90": p90, "support_points": stage["support_points"]}))
    assert p90 <= cfg["limits"]["descriptor_err_p90"]
