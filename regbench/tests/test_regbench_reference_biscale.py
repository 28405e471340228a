"""The plain bi-scale reference against the program's staged path on the
tiny terrain pair at ``shot-biscale-1m``'s own descriptor settings (frames
at 3.0, bins at 9.0, support at 0.3): the descriptors
``RegistrationPipeline.compute_descriptors`` gives the ref cloud's
keypoints, as the harness drives it, within the configuration's rule.
The tiny patch's support (724 points) takes the brute route, whose
``k_max_descriptor`` cap is raised past it: at the benchmark's size the
grid route has no cap."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from regbench import generator
from regbench.reference import shot_bi_scale
from regbench.tests._tiny import BENCH, TINY_TRAFFIC
from shot_fpfh_tpu_torch.models.normals import compute_normals
from shot_fpfh_tpu_torch.pipeline import RegistrationPipeline

CFG = json.loads((BENCH / "configs" / "shot-biscale-1m.json").read_text())


@pytest.fixture(scope="module")
def pair():
    torch.set_num_threads(2)
    traffic = json.loads((BENCH / "traffic" / "dense.json").read_text())
    traffic.update(TINY_TRAFFIC)
    return generator.make_pair(traffic, 2147483701, 0, "cpu")


def test_bi_scale_equals_the_staged_path(pair):
    normals = {side: compute_normals(getattr(pair, side), getattr(pair, side), k=30,
                                     device="cpu").numpy() for side in ("scan", "ref")}
    pipe = RegistrationPipeline(scan=pair.scan, scan_normals=normals["scan"], ref=pair.ref,
                                ref_normals=normals["ref"], device="cpu",
                                k_max_descriptor=1024)
    kp = TINY_TRAFFIC["keypoint_selection"]
    pipe.select_keypoints(kp["selection_algorithm"], neighborhood_size=kp["neighborhood_size"],
                          min_n_neighbors=kp["min_n_neighbors"])
    pipe.compute_descriptors(**CFG["descriptor"])
    assert pipe.metrics.stages[-1]["stage"] == "descriptors[shot_bi_scale]"
    want = shot_bi_scale.descriptors(torch.as_tensor(pair.ref),
                                     torch.as_tensor(normals["ref"], dtype=torch.float64),
                                     torch.as_tensor(np.asarray(pipe.ref_keypoints)), CFG,
                                     torch.float64)
    got = pipe.ref_descriptors.double()
    err = (got - want).norm(dim=1) / want.norm(dim=1).clamp(min=1e-12)
    assert float(torch.quantile(err, 0.9)) < 1e-5
    assert int((got.norm(dim=1) == 0).sum()) == int((want.norm(dim=1) == 0).sum())
