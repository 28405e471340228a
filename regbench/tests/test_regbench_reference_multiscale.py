"""The plain multiscale reference against the program's staged path on the
tiny terrain pair: the 704-D rows ``RegistrationPipeline.
compute_descriptors`` gives the ref cloud's keypoints, as the harness
drives it, at ``shot-multiscale-1m``'s own descriptor settings and at a
tenth of its radius.  On CPU tensors the tiny supports take the brute
route, whose ``k_max_descriptor`` cap is raised past them: on the card
every scale takes the grid, which has no cap.

At the configuration's radii the tiny patch's second support (voxel 0.9)
holds fewer than ``min_neighborhood_size`` points, so every second-scale
row is zero and the first scale's rows stand as they are; at a tenth of
the radii both scales bin, the second under the first scale's frames."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from regbench import generator
from regbench.reference import shot_multiscale
from regbench.tests._tiny import BENCH, TINY_TRAFFIC
from shot_fpfh_tpu_torch.models.normals import compute_normals
from shot_fpfh_tpu_torch.pipeline import RegistrationPipeline

CFG = json.loads((BENCH / "configs" / "shot-multiscale-1m.json").read_text())
DIM = 352


@pytest.fixture(scope="module")
def pipe():
    torch.set_num_threads(2)
    traffic = json.loads((BENCH / "traffic" / "dense.json").read_text())
    traffic.update(TINY_TRAFFIC)
    pair = generator.make_pair(traffic, 2147483701, 0, "cpu")
    normals = {side: compute_normals(getattr(pair, side), getattr(pair, side), k=30,
                                     device="cpu").numpy() for side in ("scan", "ref")}
    p = RegistrationPipeline(scan=pair.scan, scan_normals=normals["scan"], ref=pair.ref,
                             ref_normals=normals["ref"], device="cpu", k_max_descriptor=2048)
    kp = TINY_TRAFFIC["keypoint_selection"]
    p.select_keypoints(kp["selection_algorithm"], neighborhood_size=kp["neighborhood_size"],
                       min_n_neighbors=kp["min_n_neighbors"])
    return p


def _rows(pipe, desc: dict):
    pipe.compute_descriptors(**desc, force_recompute=True)
    assert pipe.metrics.stages[-1]["stage"] == "descriptors[shot_multiscale]"
    want = shot_multiscale.descriptors(torch.as_tensor(pipe.ref),
                                       torch.as_tensor(pipe.ref_normals, dtype=torch.float64),
                                       torch.as_tensor(np.asarray(pipe.ref_keypoints)),
                                       {"descriptor": desc}, torch.float64)
    return pipe.ref_descriptors.double(), want


def _p90_err(got, want):
    err = (got - want).norm(dim=1) / want.norm(dim=1).clamp(min=1e-12)
    return float(torch.quantile(err, 0.9))


def test_multiscale_at_the_configuration_equals_the_staged_path(pipe):
    got, want = _rows(pipe, CFG["descriptor"])
    assert got.shape == want.shape == (len(pipe.ref_keypoints), 2 * DIM)
    assert _p90_err(got[:, :DIM], want[:, :DIM]) < 1e-5
    assert bool((want[:, :DIM].norm(dim=1) > 0).float().mean() > 0.5)
    # a zero row at the second scale leaves the first as it is
    assert not bool(want[:, DIM:].any()) and not bool(got[:, DIM:].any())


def test_multiscale_at_a_tenth_of_the_radius_equals_the_staged_path(pipe):
    desc = dict(CFG["descriptor"], radius=0.3, min_neighborhood_size=60)
    got, want = _rows(pipe, desc)
    for s in range(2):
        g, w = got[:, s * DIM:(s + 1) * DIM], want[:, s * DIM:(s + 1) * DIM]
        assert _p90_err(g, w) < 1e-5, s
        assert torch.equal(g.norm(dim=1) == 0, w.norm(dim=1) == 0), s
    assert bool((want[:, DIM:].norm(dim=1) > 0).float().mean() > 0.5)
    # scale 1 under its own frames is another descriptor
    own = shot_multiscale.descriptors(torch.as_tensor(pipe.ref),
                                      torch.as_tensor(pipe.ref_normals, dtype=torch.float64),
                                      torch.as_tensor(np.asarray(pipe.ref_keypoints)),
                                      {"descriptor": dict(desc, share_local_rfs=False)},
                                      torch.float64)
    assert _p90_err(got[:, DIM:], own[:, DIM:]) > 1e-2
