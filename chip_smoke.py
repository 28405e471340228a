#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``shot_fpfh_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero with no result line:

1. device: torch / CUDA versions, card name and power limit;
2. build: compile ``shot_fpfh_tpu_torch/csrc/*.cu`` for sm_90a, one
   ``nvcc`` per source, all in parallel;
3. kernel parity at each path's shapes, each kernel against its plain
   PyTorch version on the same card inputs, with CUDA-event timings:
   K1 SHOT frames + histogram (4096 keypoints on a 50k-point terrain; own
   and given frames at radius 0.9, and the bi-scale mode: frames at 0.9,
   bins at 2.7, on the bi-scale grid of cell 1.35),
   K5 SHOT over xy-row runs (the same keypoints and grids, all three modes;
   then held to the K1 window route on the keypoints whose neighbor counts
   agree under the two routes' radius rules),
   SG, SHOT's grid kernel (``shot_grid``: the same keypoints and grids, all
   three modes, equal to the K8 + K1 route it replaced and held to its twin
   by phase 17's frame rule and the flip rule, timed beside both; phase 16
   holds it so at the SHOT cells' 10^6-point shapes),
   K2 top-2 matching (4096 x 4096 x 352, f32 and bf16; 4096 x 4096 x 704,
   the two-scale width, and 8192 x 8192 x 125, the FPFH width, bf16; the
   main path's 6531 x 6634 x 352, bf16; whole-number descriptors with
   repeated refs, where i1, d1 and d2 must equal the twin's in both modes;
   the random path's 50k x 50k, timed only), each beside one library call,
   K3 radius covariance (100k queries, scalar and per-query radius; its
   cell order and tile unions equal to their plain twin ``tile_plan``'s;
   the call, its cell order and the kernel alone timed),
   K4 SPFH window histogram (one 8192-point chunk of a 100k-point terrain,
   radius 0.9, k=30 normals, joint and decorrelated),
   K6 SPFH over xy-row runs (all 100k points of that terrain, joint and
   decorrelated, equal to its twin; then held to the window route on the
   rows whose radius rules agree), FPFH's SPFH pass kernel (``spfh_grid``:
   every point of that terrain, equal to the K8 + K4 route it replaced and
   held to its twin by K4's rule, timed beside both), the voxel
   sums of ``grid_subsample`` on a skewed cloud (20,000 points in one
   voxel), bit-identical to the CPU's, and K8 window fetch (K1's keypoints
   on its own and on the bi-scale grid; the FPFH chunk; phase 10's queries
   on the PCA features' three-column grid) and K7 masked radius distances
   (all 100k points of the smoke pair's ref on the iterative path's halo-2
   grid; the ICP's subsampled scan against the ref's 1-NN grid), each
   bit-identical to its plain version (``torch.equal`` on every output);
   K7's 1-NN mode (``nearest``: the ICP's scan against the ref's 1-NN grid,
   and every ref point on the iterative grid), both outputs equal to its
   twin and to the route it replaced (K7 in chunks, the row minimum, the
   gathers), timed beside that route and at each lanes-a-query variant;
   IS (``icp_step``: one point-to-plane ICP iteration in one launch, the
   1-NN walk, the normal equations, the 6x6 solve and the composition)
   against its plain twin (``registration/icp.py::_step``) at the ICP's
   shape by ``icp_rule``, alone and in its loop beside the twin's; the
   CUDA kernels one ICP iteration launches (``torch.profiler``); K7's
   aggregation mode (``fpfh_aggregate``: the smoke scan's density keypoints
   on its halo-2 grid of cell 0.45 over the SPFH of every point, D = 125
   and 15) against its twin by ``aggregate_rule`` with the keypoints in
   sorted-row and in the caller's order, timed beside the twin, the chunked
   route it replaced and one cuSPARSE product; both clouds' kernel-fed FPFH
   matched by K2 against the twin-fed (AGG_MATCH_AGREE);
4. SHOT path: the port's ``cli.main`` on a ~100k-point terrain pair (scan =
   known rigid motion of ref + noise) with ``config/default.yaml``, run
   cold once and then measured; the registration must be accepted, within
   1e-2 rad / 1e-2 of the ground truth, and the measured run must have
   launched SG, K2 and K3, IS once an ICP iteration (50) and K7's 1-NN
   mode once, for the evaluation, K7's window, K8 and K1 never.  ``--profile DIR``
   adds a third run under ``torch.profiler`` (op table, chrome trace,
   device-busy share);
5. FPFH path: the same pair with ``--descriptor_choice fpfh``, cold and
   measured on the window route (launches K2, K3, the SPFH pass kernel and
   the aggregation kernel once a cloud each, no K8, K4 or K7 window), then
   once on the run route (launches K6 and not the pass kernel), then the
   window route
   with the aggregation's twin in the kernel's place (the same rotation
   error within 1e-5 rad); each run accepted within the same bounds;
6. bi-scale SHOT (``--phi 3``: frames at 0.9, bins at 2.7) on the window
   route (SG, K2, K3) and on the run route (K5, K2, K3, no SG);
7. multiscale SHOT (``--n_scales 2``: radii 0.9 and 2.7, 704 columns) on the
   window route (SG, and K2 at D = 704); scale 2's support, subsampled at
   2.7/10, is under 20k points and takes the brute route;
8. single-scale SHOT on the run route (K5, no SG);
9. iterative keypoints (``--selection_algorithm iterative
   --neighborhood_size 0.3``: greedy coverage over the K7 radius search),
   single-scale SHOT; the measured run launches K7, SG, K2 and K3, and
   both clouds' keypoints equal the port's keypoints for them on the CPU;
10. PCA features of 20,000 points of the 100k ref at radius 0.3 (radius
   normals, sphericity, the basic and the 21-column features: K3 and K8),
   held to the port's plain CPU run within 1e-6 (the angle columns 1e-4);
11. single-scale SHOT with ``--matching_algorithm threshold`` and with
   ``--selection_algorithm random``, one measured run each;
12. the single-program path (``--fused`` with ``--selection_algorithm
   subsampling --neighborhood_size 0.15``): single-scale SHOT on the window
   route (SG) and on the run route (K5), and FPFH (the SPFH pass and
   the aggregation kernel once a cloud each), each
   cold, then measured, accepted within the same bounds, with one K2 (f32)
   launch, K3 (normals) and IS (ICP); beside each, the staged
   path on the same keypoints, and the host syncs of one
   ``fused_registration`` call by leg
   (``torch.cuda.set_sync_debug_mode("warn")``).  Phase 3 also holds K8,
   K1 and K5 on the fused SHOT grid (cell 0.9, halo 1, the full 100k scan)
   and K2 in f32 at the fused path's keypoint count;
13. the library's single-device remainder: ``multiscale_top1`` on phase
   7's two-scale descriptors, card against CPU in both reciprocal modes,
   timed beside its bound, and one ``match_descriptors`` on the stacks;
   ``--debug_shot`` (SG counts the checks in the kernel; 0 violations) and
   ``--debug_nans`` (every op and kernel launch checked) through
   ``cli.main``; the sampled ICP and the stats solvers against the CPU;
   ``trace_annotation`` in a profiler trace.  Phase 3 also holds K1's and
   K5's debug counters against their twins' (K1's also with unsound
   weights: a radius an eighth of its window's), and under given frames
   with a planted NaN (whole frames, one z-axis component): the same
   counts, NaN in the same histogram entries, the rest by the flip rule;
14. the mesh (``shot_fpfh_tpu_torch.parallel``): a 1-rank NCCL group in
   this process runs every sharded stage at the smoke pair's shapes
   (normals k=30 on the 100k ref; SHOT own, bi-scale and shared frames on
   the window and run routes; FPFH on both routes; ``ring_match`` of the
   6,531 x 6,634 x 352 descriptors; multiscale matching in both modes;
   RANSAC with given draws; ICP on the ref's grid), each equal to the
   single-device port (``torch.equal`` per row; RANSAC's and ICP's
   reductions within 1e-5), timed with CUDA events, its launches counted;
   then two processes sharing the one card over gloo run ``cli.main
   --n_devices 2`` (SHOT, then FPFH), each accepted, its moved scan within
   1e-3 of one device's, rank 0 alone writing, each rank launching K1 (or
   the SPFH pass kernel or K6, and the aggregation kernel, once a cloud, no
   K7), K2, K3 and K7's
   1-NN mode;
15. the fused program and the multi-process entry point over a mesh: a second
   1-rank NCCL group runs ``fused_registration_mesh`` on the inputs phase
   12's runs gave ``fused_registration`` (SHOT on the window and run
   routes, FPFH), each equal to the one-device call through matching
   (``torch.equal``), RANSAC and ICP within 1e-5, the same launches (one
   device's IS launches as the mesh's 1-NN ones), with
   its CUDA-event ms beside the one device's and its host syncs by leg;
   then phase 14's two processes also run ``cli.main --fused --n_devices
   2`` (SHOT, FPFH; accepted, the moved scan within 1e-3 of one device's
   ``--fused``, rank 0 alone writing, each rank launching K8 with K1, or
   the SPFH pass and the aggregation kernel, K2, K3 and K7's 1-NN mode)
   and, their
   group destroyed,
   ``run_multihost`` on the pair's ``.ply`` files through
   ``initialize_distributed`` (the ranks within 1e-6 of each other and
   1e-3 of one process's run, accepted against the ground truth) and one
   ``scaling_report`` of SHOT (two ranks on one card: not a scaling
   number);
16. at scale: ``benchmarks/bench_1m.py``'s 10^6-point pair (its formulas
   copied), written as ``.ply`` to a temporary directory: ``cli.main`` for
   SHOT and for FPFH on the window route (radius 0.6, keypoint voxel
   0.15), cold then measured, accepted within 1e-2 rad / 1e-2, launching
   K3, SG once a cloud and no K8 or K1 (or the SPFH pass and the
   aggregation kernel once a cloud each, no K8, K4 or K7), K2,
   IS once an ICP iteration and K7's 1-NN mode twice for the
   evaluation; ``bench.py``'s at-scale legs through the
   library on the ref (k=30 normals, with the sampled k-th bound equal to
   its one-piece form; the descriptor grid, beside the host hash that keys
   JAX's grid cache; SHOT and FPFH of the voxel-0.9 keypoints; ICP of a
   small motion, back within 1e-3; Lowe matching at 100k x 100k x 352),
   each cold then measured; each leg's wall, stage timers, launches and
   peak device memory; every kernel at these shapes against its twin
   (phase 3's rules; K2 on 4096 sampled rows; the aggregation on the CLI
   legs' ~78k ref keypoints; IS at leg 3's ICP shape; the SPFH pass also at the FPFH cell's radius
   3.0, cell 1.5; SG on those keypoints over the ref's 0.3 support, the
   SHOT cells' shapes, at 3.0 and bi-scale at 9.0 / 3.0); the voxel sums with a voxel
   of 10^5 and of 10^6 points bit-identical to the CPU's;
17. the surface the port gained last: ``radius_search_auto`` on a random
   5k of the smoke ref (brute) and on all of it (the grid through K7), for
   4096 queries, its in-radius sets equal to the CPU's (and, on the grid,
   to the brute search's on the card) but for the neighbors a brute
   search's float32 rounding may put on either side of the radius
   (counted; none on the grid against the CPU); ``compute_shot_descriptor(local_rf_neighborhoods=)``
   for 4096 keypoints of the ref at radius 0.9, the frames' neighborhoods
   from ``radius_search`` on the card: K7 and K1 in its given-frames mode
   launched, the frames within 5e-4 of the CPU's (up to the signs of an
   axis whose sign vote is near tied: counted and bounded) and the
   histograms, the CPU given the card's frames, by the flip rule;
   ``RigidTransform.identity((4,))`` on ``cuda``.
The run route is no route of the port: for a run on it the smoke calls K5
and K6 in the place of SG and the SPFH pass kernel
(``run_kernels_in_place``), and holds them to the same bounds.
Phases 4–9 and 12 run cold, then measured, each accepted within the same
bounds; every SHOT window route launches SG once a cloud (no K8, no K1),
FPFH's window route the SPFH pass kernel once a cloud, and every
one-device point-to-plane ICP on a grid IS (the mesh's sharded ICP keeps
K7's 1-NN mode).
``--bits-against LIB`` also holds K1's and K5's phase-3 outputs equal, bit
for bit, to those of another build's library and times each alone under
both builds in turns.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"

# tolerances (bench.py:277-280, 309-341, 377; tests/test_pallas_shot_dma.py)
K3_COV_ATOL = 1e-4
K1_FRAME_ATOL = 5e-4
K1_FLIP_ABS, K1_FLIP_REL, K1_FLIP_FRAC, K1_MAX_DIFF = 5e-3, 1e-2, 3e-3, 0.1
K2_D1_RTOL = {False: 1e-4, True: 2e-3}
K2_MIN_AGREE = {False: 1.0, True: 0.97}
# SPFH counts are whole numbers: a difference is a neighbor moved to another
# bin by a last-bit change of an angle
K4_FLIP_FRAC, K4_MAX_COUNTS = 1e-3, 2.0
# two SPFH routes: at most 1e-3 of elements off by more than 1e-4, row sums
# within 1e-3
SPFH_ELEM_TOL, SPFH_ELEM_FRAC, SPFH_ROW_TOL = 1e-4, 1e-3, 1e-3
MAIN_ROT_TOL, MAIN_T_TOL = 1e-2, 1e-2

# FPFH on the smoke pair: the SHOT radius; at this cloud's density (250
# points per unit area) radius 0.9 keeps ~600 neighbors per point
FPFH_RADIUS = 0.9

# the card's published peaks (NVIDIA H100 SXM data sheet, dense, at 700 W):
# the least time for a kernel's work is the larger of its bytes over the
# memory rate and its operations over the rate for their type
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12          # CUDA cores
BF16_TENSOR_FLOPS = 989e12
# operation counts per element, from the kernels' source: one candidate
# distance test (3 sub, 3 mul/fma pairs, compare) and one SPFH neighbor
# (2 cross products, 3 dots, a division, atan2f ~20, sqrt, three bin indices)
OPS_DIST_TEST = 11
OPS_SPFH_NEIGHBOR = 75
# a SHOT neighbor in K1: covariance 13, sign votes 8, projections, atan2f,
# acosf, soft-bin weights and five shared-memory adds ~130
OPS_SHOT_NEIGHBOR = 150
# K5, from its source: a frame-plane neighbor (covariance 13, sign votes 8)
# and a binned neighbor (projections, atan2f, acosf, soft bins, five adds),
# beside one distance test (OPS_DIST_TEST) for every row of the runs
OPS_SHOT_FRAME = 21
OPS_SHOT_BIN = 130
# a K3 in-radius point: 10 sums of moments
OPS_PCA_POINT = 20

# bi-scale and multiscale SHOT on the smoke pair: the reference defaults
# phi 3 (bins, or scale 2, at 2.7) and two scales
PHI, N_SCALES = 3.0, 2
# the two SHOT routes' radius rules part on a keypoint when one of its
# squared distances rounds onto r²: expected well under one keypoint in a
# thousand at these widths (the SPFH routes part on 4–10 of 100k rows of
# ~600 neighbors each); the parted keypoints are counted and bounded
SHOT_ROUTE_PARTED_FRAC = 1e-2

# the smoke pair's density keypoints (scan, ref): K2's shape on the main path
MAIN_KEYPOINTS = (6531, 6634)

# the smoke pair's keypoint voxel (--neighborhood_size), and the points of
# the one dense voxel in the skewed cloud of the voxel-sum check
KEYPOINT_VOXEL = 0.15
VOXEL_CLUSTER = 20_000

# phase 9's greedy radius (--neighborhood_size): balls of ~62 points, at
# most ~105 on the smoke terrain, under the 128-neighbor cap; phase 10's
# feature radius and query count; the ICP's voxel and d_max
# (config/default.yaml), whose 1-NN grid K7's 1-NN mode searches
ITERATIVE_RADIUS = 0.3
FEATURE_RADIUS, FEATURE_QUERIES = 0.3, 20_000
ICP_VOXEL, ICP_D_MAX = 0.2, 0.5
# phase 10 against the CPU: eigenvalues, moments, sphericity and every
# column of the basic and the 21 features but the angles, within
# FEATURE_ATOL (the smallest moments are ~1e-4, λ_min ~1e-4: the JAX test's
# 1e-4 / 1e-3 (tests/test_normals.py:124-131) would pass a wrong kernel);
# the angle columns 2·arcsin|x|/π, whose slope 1/sqrt(1 - x²) is steep at
# |x| = 1, within FEATURE_ANGLE_ATOL
FEATURE_ATOL, FEATURE_ANGLE_ATOL = 1e-6, 1e-4
# the angle columns of compute_pca_based_basic_features (stacked) and of
# compute_pca_based_features
BASIC_ANGLE_COLS, FEATURE_ANGLE_COLS = (0,), (8, 9, 10, 11)

# the CUDA kernels of K1, K4, K5, K6, K7 (its window and its 1-NN mode) and
# K8 as csrc/ names them (their device time alone is read from the profiler)
K1_KERNEL, K4_KERNEL, K5_KERNEL = "shot_hist_kernel", "spfh_hist_kernel", "shot_runs_kernel"
K6_KERNEL = "spfh_runs_kernel"
# FPFH's SPFH pass on the window route (csrc/spfh_grid.cu): its C entry
# point (the launch counter) and its kernel; its twin's query chunk on the
# card (its (chunk, F + 2, W) windows stay under ~1 GB at W ~36k)
SPFH_PASS, SPFH_PASS_KERNEL = "spfh_grid", "spfh_grid_kernel"
SPFH_PLAIN_CHUNK = 1024
K7_KERNEL, K8_KERNEL = "radius_dist_kernel", "fetch_windows_kernel"
# SHOT's grid kernel on the window route (csrc/shot_grid.cu): its C entry
# point (the launch counter) and its kernel; its twin's keypoint chunk on
# the card (K8's and K1's twins: (chunk, F, W) windows of ~10k slots)
SG, SG_KERNEL = "shot_grid", "shot_grid_kernel"
SG_PLAIN_CHUNK = 1024
# SG at the SHOT cells' shapes (regbench's shot-1m and shot-biscale-1m), in
# phase 16: the 10^6-point ref's support at voxel 0.3, the CLI's density
# keypoints of the ref (voxel 0.15, more than 5 points), padded to 1024;
# single scale at radius 3.0 (cell 1.5), bi-scale frames at 3.0 and bins at
# 9.0 (cell 4.5); the twin on the first SG_SCALE_PLAIN_ROWS keypoints
SG_SCALE_SUPPORT, SG_SCALE_KP_MIN = 0.3, 5
SG_SCALE_RADIUS, SG_SCALE_BI_RADIUS, SG_SCALE_PLAIN_ROWS = 3.0, 9.0, 4096
NN_KERNEL, AGG_KERNEL = "nearest_kernel", "fpfh_aggregate_kernel"
# ICP's iteration kernel (csrc/icp_step.cu): its C entry point and kernel;
# its work a point besides the walk (the move 18, the cross product and h
# 17, the 29 sums 84)
IS, IS_KERNEL = "icp_step", "icp_step_kernel"
OPS_ICP_POINT = 120
# IS against its plain twin (the same inputs, float32 sums in another
# order): the RMS after each of the first ICP_RULE_ITERS iterations within
# ICP_RMS_RTOL relative, the transform after them within ICP_ROT_TOL rad and
# ICP_T_TOL
ICP_RULE_ITERS, ICP_RMS_RTOL, ICP_ROT_TOL, ICP_T_TOL = 4, 1e-5, 1e-6, 1e-5
# K7's FPFH aggregation mode against its twin, whose einsum sums in no
# defined order: every row within AGG_ROW_RTOL of its largest entry (at
# least 1), the counts and every row with no neighbor (the keypoint's own
# SPFH row) exact
AGG_ROW_RTOL = 1e-5
# FPFH's downstream check on the smoke pair: K2's matches of the
# kernel-fed descriptors equal the twin-fed ones on at least this share of
# rows
AGG_MATCH_AGREE = 0.99

# each path and the kernels its measured run must launch (and must not):
# SHOT's window route runs SG once a cloud (no K8, no K1), every ICP IS and
# the evaluation's grid 1-NN K7's 1-NN mode; FPFH's SPFH pass runs its kernel once a cloud on the window
# route (no K8, no K4) and K6 on the run route; its aggregation runs K7's
# aggregation mode (one launch a cloud) and no K7 window; the iterative
# keypoints run K7's window
WINDOW, K7, NN, AGG = "fetch_windows", "radius_dist", "nearest", "fpfh_aggregate"
SHOT_PATH = (SG, "top2_match", "radius_pca", IS, NN)
# SHOT's window route on a grid with a cell table: SG alone, no K8 + K1
SHOT_WINDOW_NOT = ("shot_binning_histogram", WINDOW)
FPFH_WINDOW_PATH = ("top2_match", "radius_pca", SPFH_PASS, AGG, IS, NN)
FPFH_WINDOW_NOT = ("spfh_runs", "spfh_histogram", WINDOW, K7)
FPFH_RUN_PATH = ("top2_match", "radius_pca", "spfh_runs", AGG, IS, NN)
# the FPFH paths' aggregation launches: one a cloud
FPFH_AGG_LAUNCHES = 2
SHOT_RUN_PATH = ("shot_runs", "top2_match", "radius_pca", IS, NN)
MULTISCALE_PATH = (SG, "top2_match", IS, NN)
ITERATIVE_PATH = (K7, NN, IS, SG, "top2_match", "radius_pca")
# the SHOT path's IS launches, one an ICP iteration (50: the threshold 1e-3
# lies under the pair's RMS floor), and 1-NN launches, one for the
# evaluation's overlap (its keypoint inlier ratio takes the brute route)
SHOT_IS_LAUNCHES, SHOT_NN_LAUNCHES = 50, 1

# phase 12: the fused program's keypoints (the CLI's fused set-up) and the
# kernels each of its runs must launch: its SHOT grid (cell = radius, halo
# 1) takes SG or K5, its FPFH grid the SPFH pass kernel and K7's
# aggregation mode; K2 once, in f32;
# K3 in the CLI's normals; IS in ICP
FUSED_FLAGS = ["--selection_algorithm", "subsampling", "--neighborhood_size",
               str(KEYPOINT_VOXEL)]
FUSED_SHOT_CELL = 0.9

# phase 13: multiscale_top1 on the card against the CPU: indices equal on
# every row whose two best combined distances (CPU) are more than
# MS_TIE_GAP apart (the matmuls sum in other orders, so a near tie may go
# either way); on every row the card's match within MS_TIE_GAP of the
# CPU's best; distances within MS_DIST_ATOL.  Near-tied rows are bounded
# at MS_NEAR_TIE_FRAC of all, about twice the most read: 31 of the smoke
# pair's 6,531 scan rows (0.47%) without the reciprocal filter, 7 with it,
# in each of four H100 runs.  match_descriptors' card and CPU match sets
# may part only on near-tied rows (they agreed fully in those runs).  The
# sampled ICP's
# iterations and draws, and its limits against the CPU on the same draws;
# the stats solvers' limit
MS_TIE_GAP, MS_NEAR_TIE_FRAC, MS_DIST_ATOL = 1e-4, 1e-2, 1e-4
SAMPLED_ICP_ITERS, SAMPLED_ICP_LIMIT = 20, 100
SAMPLED_ICP_PTS_ATOL, SAMPLED_ICP_RMS_ATOL = 1e-4, 1e-5
SOLVER_ATOL = 1e-5

# phase 17: radius_search_auto on both sides of AUTO_GRID_MIN_POINTS (a
# random 5k of the smoke ref at radius 0.9, ~28 neighbors; the whole 100k
# ref at 0.3, ~70) for SURFACE_QUERIES queries, capped at SURFACE_K_MAX,
# above every row's count so the sets are whole.  The brute search's first
# cut takes d² = |q|² + |p|² − 2q·p in float32, off by up to a few units of
# roundoff of |q|² + |p|² (~1e-5 on this terrain, against r² = 0.09), so a
# neighbor whose exact d² lies within SURFACE_EDGE_ULPS such units of r²
# may fall on either side of the radius there: such edge neighbors are
# counted and left out where a brute search is compared.  SHOT with given
# frame neighborhoods (radius_search on the card, SURFACE_RF_K nearest) for
# SURFACE_KEYPOINTS keypoints of the ref at the SHOT radius
SURFACE_CASES = ((5_000, 0.9), (100_000, 0.3))
SURFACE_QUERIES, SURFACE_K_MAX, SURFACE_EDGE_ULPS = 4096, 256, 16
SURFACE_KEYPOINTS, SURFACE_RF_K = 4096, 512
# SHOT's frames on two devices: a keypoint whose x or z sign vote (on the
# CPU) is within VOTE_TIE_MARGIN of a tie flips that axis, and y with it,
# when one projection of ~0 takes the other sign on the other device (a
# vote of 256 to 256 becomes 257 to 255); such a keypoint's frame is held
# up to those signs, and the keypoints whose axis flipped are bounded at
# VOTE_FLIP_FRAC of all
VOTE_TIE_MARGIN, VOTE_FLIP_FRAC = 2, 1e-2


def make_terrain(n: int, rng: np.random.Generator, scale: float = 10.0,
                 n_bumps: int = 40) -> np.ndarray:
    """Synthetic terrain: Gaussian bumps on a plane (the repo's bench cloud)."""
    xy = rng.uniform(-scale, scale, size=(n, 2))
    z = np.zeros(n)
    centers = rng.uniform(-scale, scale, size=(n_bumps, 2))
    heights = rng.uniform(-2.0, 2.0, size=n_bumps)
    widths = rng.uniform(0.5, 2.5, size=n_bumps) * (scale / 10.0) * (40 / n_bumps) ** 0.5
    for c, h, w in zip(centers, heights, widths):
        z += h * np.exp(-np.sum((xy - c) ** 2, axis=1) / (2 * w ** 2))
    pts = np.column_stack([xy, z]) + rng.normal(scale=0.01, size=(n, 3))
    return pts.astype(np.float32)


def rotation_about(axis, angle: float) -> np.ndarray:
    axis = np.asarray(axis, float) / np.linalg.norm(axis)
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * k @ k


def cuda_ms(fn, reps: int = 10) -> float:
    """Median CUDA-event milliseconds of ``fn`` after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def kernel_ms(fn, kernel: str, reps: int = 10) -> float:
    """Mean device milliseconds of a launch of the port's CUDA kernel
    ``kernel`` (its name in csrc/, launched once a call of ``fn``), from
    ``torch.profiler`` over ``reps`` calls after a warm-up: the kernel alone,
    without its wrapper's host work; the mean is over the launches the
    profiler recorded.  A trace that recorded none of them (it happens, now
    and then) is taken again, up to three times; nan after that."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        times = [e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA
                 and (m := _LOCAL_KERNEL.match(e.name)) and m.group(1) == kernel]
        if times:
            return sum(times) / len(times) / 1e3
    return float("nan")


def check(cond: bool, message: str) -> None:
    if not cond:
        raise AssertionError(message)


def xyrow_grid(grid) -> tuple[bool, int]:
    """``(in xy-row mode, longest xy-row run)`` of a grid, as K5's and K6's
    wrappers work them out from its cell table."""
    from shot_fpfh_tpu_torch.ops.shot_dma import _xyrow_mode

    return _xyrow_mode(grid)


@contextlib.contextmanager
def run_kernels_in_place(on: bool = True):
    """K5 and K6 (``ops.shot_dma``) called in the place of SG and the SPFH
    pass kernel wherever SHOT and FPFH take a grid (the staged models, the
    fused legs, the sharded stages), so a run holds the run kernels on the
    main path's inputs: no route of the port selects them.  Nothing is
    replaced unless ``on``."""
    if not on:
        yield
        return
    from shot_fpfh_tpu_torch.models import fpfh as m_fpfh
    from shot_fpfh_tpu_torch.models import shot as m_shot
    from shot_fpfh_tpu_torch.ops.shot_dma import shot_descriptor_dma, spfh_block_dma
    from shot_fpfh_tpu_torch.registration import fused

    def k5(grid, kp, local_rfs, radius, normalize, min_neighborhood_size, rf_radius=None):
        counter = m_shot._debug_counter(kp.device)
        out = shot_descriptor_dma(grid, kp, radius, rfs=local_rfs, rf_radius=rf_radius,
                                  normalize=normalize,
                                  min_neighborhood_size=min_neighborhood_size,
                                  violations=counter)
        m_shot._debug_read(counter)
        return out

    saved = m_shot._shot_on_grid, fused._shot_on_grid, m_fpfh.spfh_grid
    m_shot._shot_on_grid = fused._shot_on_grid = k5
    m_fpfh.spfh_grid = spfh_block_dma
    try:
        yield
    finally:
        m_shot._shot_on_grid, fused._shot_on_grid, m_fpfh.spfh_grid = saved


def bound(n_bytes: float, n_ops: float, peak_flops: float = F32_FLOPS) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over the peak for their type, whichever is larger."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / peak_flops * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def route_rule(got, want, label: str) -> float:
    """Hold two SPFH routes to each other; returns the max abs difference."""
    diff = (got - want).abs()
    frac = float((diff > SPFH_ELEM_TOL).float().mean())
    row = float((got.sum(1) - want.sum(1)).abs().max())
    check(frac <= SPFH_ELEM_FRAC and row <= SPFH_ROW_TOL,
          f"{label}: {frac} of elements off by > {SPFH_ELEM_TOL}, row sums off by {row}")
    return float(diff.max())


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"phase 1 device: torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} | nvidia-smi: {smi}", flush=True)
    return smi


def phase_build():
    from shot_fpfh_tpu_torch import _kernels

    t0 = time.perf_counter()
    _kernels.library()
    regs = [ln.split(":", 1)[1].strip() for ln in _kernels.build_info.get("ptxas", [])
            if "registers" in ln]
    nvcc = ("library already built" if _kernels.build_info.get("cached")
            else f"nvcc {_kernels.build_info['seconds']:.2f} s")
    print(f"phase 2 build: {time.perf_counter() - t0:.2f} s ({nvcc}); ptxas: {regs}",
          flush=True)


def parity_k3(dev, rng):
    import torch

    return k3_check(torch.tensor(make_terrain(100_000, rng), device=dev), "phase 3")


def k3_check(cloud, prefix: str, reps: int = 10) -> dict:
    """K3 on every point of ``cloud`` at the k=30 normals' per-query radii
    and at the grid's cell, against its twin (counts exact, covariances
    within K3_COV_ATOL), its cell order and tile unions equal to
    ``tile_plan``'s; the call, its cell order and the kernel timed
    (``reps`` runs after a warm-up)."""
    import torch

    from shot_fpfh_tpu_torch.models.normals import _knn_target_radii
    from shot_fpfh_tpu_torch.ops.grid_hash import (
        _zcolumn_runs,
        build_grid,
        kth_distance_bound,
        quantized_kth_radius,
    )
    from shot_fpfh_tpu_torch.ops.grid_hash import radius_sq
    from shot_fpfh_tpu_torch.ops.radius_pca import (
        TILE,
        cell_moments,
        cell_order,
        radius_pca,
        radius_pca_plain,
        tile_plan,
    )

    dev = cloud.device
    sample = cloud[::cloud.shape[0] // 512][:512]
    kth = kth_distance_bound(sample, cloud, 30)
    grid = build_grid(cloud, quantized_kth_radius(kth.cpu().numpy()))
    r_q = _knn_target_radii(grid, cloud, 30, sample, kth)
    out = {}
    for mode, radius in (("per-query", r_q), ("scalar", grid.cell_size)):
        cov_k, bary_k, cnt_k = radius_pca(grid, cloud, radius)
        cov_p, bary_p, cnt_p = radius_pca_plain(grid, cloud, radius)
        torch.cuda.synchronize()
        err = float((cov_k - cov_p).abs().max())
        check(bool((cnt_k == cnt_p).all()), f"K3 {mode}: counts differ")
        check(err <= K3_COV_ATOL, f"K3 {mode}: covariance error {err}")
        out[mode] = err
    # the kernel's own bookkeeping (the cell order, each tile's union of
    # runs) equals its plain twin's
    plan = tile_plan(grid, cloud)
    order = cell_order(grid, cloud)
    r2 = radius_sq(r_q, cloud.shape[0], dev)
    unions = (torch.empty_like(plan.lo), torch.empty_like(plan.hi))
    cell_moments(grid, cloud, r2, order, unions)
    check(torch.equal(order, plan.order), "K3: the cell order differs from tile_plan's")
    check(torch.equal(unions[0], plan.lo) and torch.equal(unions[1], plan.hi),
          "K3: the kernel's tile unions differ from tile_plan's")
    ms = cuda_ms(lambda: radius_pca(grid, cloud, r_q), reps)
    plain_ms = cuda_ms(lambda: radius_pca_plain(grid, cloud, r_q), reps)
    # the call's parts: the cell order (keys kernel and sort) and the
    # kernel alone
    order_ms = cuda_ms(lambda: cell_order(grid, cloud), reps)
    kernel_ms = cuda_ms(lambda: cell_moments(grid, cloud, r2, order), reps)
    staged = (plan.hi - plan.lo).sum(1).float()
    # the timed call: every query reads its 9 runs (lanes) and sums its
    # in-radius points
    start, end = _zcolumn_runs(grid, cloud)
    lanes = float((end - start).sum())
    _, _, cnt = radius_pca(grid, cloud, r_q)
    q = cloud.shape[0]
    b = bound(grid.packed_sorted.numel() * 4 + q * (12 + 4 + 40) + start.numel() * 16,
              lanes * OPS_DIST_TEST + float(cnt.sum()) * OPS_PCA_POINT)
    print(f"{prefix} K3 radius_pca: {q} queries, window cap {grid.window_cap}, "
          f"{lanes / q:.0f} run rows a query; {plan.lo.shape[0]} blocks of {TILE} queries staging "
          f"{float(staged.mean()):.0f} rows each (most {int(staged.max())}), order and unions "
          f"equal to tile_plan's: counts exact, cov max err {out}; call {ms:.3f} ms (its cell "
          f"order {order_ms:.3f} ms, the kernel alone {kernel_ms:.4f} ms), plain "
          f"{plain_ms:.3f} ms, bound {b['bound_ms']:.4f} ms "
          f"({b['bound_by']})", flush=True)
    return dict(max_abs_err=max(out.values()), ms=ms, plain_ms=plain_ms, library_ms=None, **b)


def _k2_library(a, b, valid, bf16):
    """The yardstick, timed only: one cuBLAS product of the rounded operands
    and ``torch.topk`` of the masked squared distances."""
    import torch

    cdt = torch.bfloat16 if bf16 else torch.float32
    ac, bc = a.to(cdt), b.to(cdt)
    an, bn = (ac.float() ** 2).sum(-1), (bc.float() ** 2).sum(-1)

    def run():
        d2 = an[:, None] + bn[None, :] - 2.0 * (ac @ bc.T).float()
        return torch.topk(d2.masked_fill(~valid[None, :], float("inf")), 2, dim=1,
                          largest=False)
    return run


def _k2_bound(n: int, m: int, dim: int, bf16: bool) -> dict:
    """Both operands read once, the refs' validity, the (i1, d1, d2) rows
    written; 2·n·m·D operations on the tensor cores (bf16) or CUDA cores."""
    return bound((n + m) * dim * (2 if bf16 else 4) + m + n * 16, 2.0 * n * m * dim,
                 BF16_TENSOR_FLOPS if bf16 else F32_FLOPS)


def parity_k2(dev, rng, n: int, dim: int, modes=(False, True), m: int | None = None):
    import torch

    from shot_fpfh_tpu_torch.ops.match import top2_match, top2_match_plain

    m = n if m is None else m
    a = torch.tensor(rng.normal(size=(n, dim)).astype(np.float32), device=dev)
    b = torch.tensor(rng.normal(size=(m, dim)).astype(np.float32), device=dev)
    valid = torch.ones(m, dtype=torch.bool, device=dev)
    valid[::97] = False
    res = {}
    for bf16 in modes:
        i_k, d1_k, d2_k = top2_match(a, b, valid, bf16)
        i_p, d1_p, d2_p = top2_match_plain(a, b, valid, bf16)
        torch.cuda.synchronize()
        # counted, not averaged: a float32 mean over a row count that is no
        # power of two is not exactly 1 when every index agrees
        agree = int((i_k == i_p).sum()) / n
        rel = float(((d1_k - d1_p).abs() / d1_p.abs()).max())
        check(agree >= K2_MIN_AGREE[bf16], f"K2 {dim} bf16={bf16}: index agreement {agree}")
        check(rel <= K2_D1_RTOL[bf16], f"K2 {dim} bf16={bf16}: d1 relative error {rel}")
        check(not bool(valid.logical_not()[i_k].any()), "K2 picked an invalid ref")
        res[bf16] = dict(agree=agree, rel=rel,
                         max_abs_err=float((d1_k - d1_p).abs().max()),
                         ms=cuda_ms(lambda: top2_match(a, b, valid, bf16)),
                         plain_ms=cuda_ms(lambda: top2_match_plain(a, b, valid, bf16)),
                         library_ms=cuda_ms(_k2_library(a, b, valid, bf16)),
                         **_k2_bound(n, m, dim, bf16))
    print(f"phase 3 K2 top2_match: {n}x{m}x{dim}: " + "; ".join(
        f"{'bf16' if k else 'f32'} agree {v['agree']:.4f} d1 rel err {v['rel']:.2e} "
        f"kernel {v['ms']:.3f} ms plain {v['plain_ms']:.3f} ms library {v['library_ms']:.3f} "
        f"ms (kernel faster: {v['ms'] < v['library_ms']}) bound {v['bound_ms']:.4f} ms "
        f"({v['bound_by']})" for k, v in res.items()),
        flush=True)
    return res[modes[-1]]


def parity_k2_ties(dev, rng, n: int = 4096, dim: int = 352) -> None:
    """K2 on whole-number descriptors in [-2, 2] (every product and sum
    exact in f32, so the kernel and the twin see equal distances) with
    repeated ref rows and scan rows copied into the refs: ties everywhere,
    and the lower index must win on every row, in both modes."""
    import torch

    from shot_fpfh_tpu_torch.ops.match import top2_match, top2_match_plain

    a = rng.integers(-2, 3, size=(n, dim)).astype(np.float32)
    b = rng.integers(-2, 3, size=(n, dim)).astype(np.float32)
    b[n // 3: 2 * (n // 3)] = b[: n // 3]
    b[n - n // 4:] = a[: n // 4]
    a, b = torch.tensor(a, device=dev), torch.tensor(b, device=dev)
    valid = torch.tensor(rng.uniform(size=n) > 0.05, device=dev)
    ties = {}
    for bf16 in (False, True):
        got, want = top2_match(a, b, valid, bf16), top2_match_plain(a, b, valid, bf16)
        for name, g, w in zip(("i1", "d1", "d2"), got, want):
            check(torch.equal(g, w), f"K2 duplicate refs bf16={bf16}: {name} differs")
        ties[bf16] = int((want[2] == want[1]).sum())
    print(f"phase 3 K2 duplicate refs: {n}x{n}x{dim} whole numbers, i1, d1 and d2 equal to "
          f"the twin in f32 and bf16 (rows whose first place is tied: {ties[True]})", flush=True)


def time_k2_random_path(dev, rng, n: int = 50_000, dim: int = 352) -> None:
    """K2 at the random keypoints path's 50k x 50k (phase 11), timed only:
    the twin and the library call would write a 10 GB distance matrix."""
    import torch

    from shot_fpfh_tpu_torch.ops.match import top2_match

    a = torch.tensor(rng.normal(size=(n, dim)).astype(np.float32), device=dev)
    b = torch.tensor(rng.normal(size=(n, dim)).astype(np.float32), device=dev)
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    i1, d1, _ = top2_match(a, b, valid, True)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(d1).all()) and int(i1.min()) >= 0 and int(i1.max()) < n,
          "K2 at 50k: indices or distances out of range")
    ms = cuda_ms(lambda: top2_match(a, b, valid, True), reps=3)
    b_ = _k2_bound(n, n, dim, True)
    print(f"phase 3 K2 top2_match: {n}x{n}x{dim} bf16 (the random path's shape): kernel "
          f"{ms:.3f} ms, bound {b_['bound_ms']:.4f} ms ({b_['bound_by']})", flush=True)


def flip_rule(got, want, label: str) -> tuple[float, float]:
    """Hold two SHOT histograms under the same frames: at most K1_FLIP_FRAC
    of elements off by more than K1_FLIP_ABS + K1_FLIP_REL·|want|, none by
    more than K1_MAX_DIFF.  Returns (flip fraction, max difference)."""
    diff = (got - want).abs()
    flip = float((diff > K1_FLIP_ABS + K1_FLIP_REL * want.abs()).float().mean())
    top = float(diff.max())
    check(flip <= K1_FLIP_FRAC and top <= K1_MAX_DIFF,
          f"{label}: flip fraction {flip}, max diff {top}")
    return flip, top


class ShotTerrain:
    """Phase 3's SHOT inputs: a 50k-point terrain with the main path's k=30
    normals (through K3, so the cosine bins carry the skew of real SHOT
    inputs), 4096 keypoints, and the halo-2 grids of single-scale SHOT
    (cell 0.45, radius 0.9) and of bi-scale SHOT (cell 1.35: frames at 0.9,
    bins at 2.7)."""

    radius, rf_radius, bi_radius = 0.9, 0.9, 0.9 * PHI

    def __init__(self, dev, rng):
        import torch

        from shot_fpfh_tpu_torch.models.normals import compute_normals
        from shot_fpfh_tpu_torch.ops.grid_hash import build_grid

        cloud = torch.tensor(make_terrain(50_000, rng), device=dev)
        normals = compute_normals(cloud, cloud, k=30, device=dev)
        self.kp = cloud[torch.tensor(rng.choice(cloud.shape[0], 4096, replace=False),
                                     device=dev)]
        self.grid = build_grid(cloud, self.radius / 2, extras=normals, halo=2)
        self.bi_grid = build_grid(cloud, self.bi_radius / 2, extras=normals, halo=2)
        for g in (self.grid, self.bi_grid):
            check(all(xyrow_grid(g)),
                  f"the 50k terrain's cell-{g.cell_size} grid is not an xy-row grid")

    def window(self, bi_scale: bool):
        """K1's inputs: ``(vals, dist_inf, rf_dist_inf or None)``."""
        import torch

        from shot_fpfh_tpu_torch.ops.grid_hash import window_distances

        grid = self.bi_grid if bi_scale else self.grid
        vals, d, valid, _ = window_distances(grid, self.kp)
        inf = torch.full_like(d, float("inf"))
        if not bi_scale:
            return vals, torch.where(valid & (d <= self.radius), d, inf), None
        return (vals, torch.where(valid & (d <= self.bi_radius), d, inf),
                torch.where(valid & (d <= self.rf_radius), d, inf))


def with_library(lib, fn):
    """``fn()`` with the kernel wrappers launching into ``lib`` (another
    build's library) instead of this checkout's."""
    from shot_fpfh_tpu_torch import _kernels

    saved, _kernels._lib = _kernels.library(), lib
    try:
        return fn()
    finally:
        _kernels._lib = saved


def bits_against(label: str, other, calls: dict, kernel: str) -> None:
    """Hold each call's outputs equal, bit for bit, to those of the same
    call launching into ``other``, the library of another build of the
    kernels; then time the CUDA kernel ``kernel`` alone in each mode under
    both builds in turns (other, this, this, other)."""
    import torch

    same = {mode: all(torch.equal(x, y) for x, y in zip(call(), with_library(other, call)))
            for mode, call in calls.items()}
    check(all(same.values()), f"{label} differs from the other build: {same}")
    alone = {mode: [round(with_library(lib, lambda: kernel_ms(call, kernel)), 4)
                    if lib is not None else round(kernel_ms(call, kernel), 4)
                    for lib in (other, None, None, other)]
             for mode, call in calls.items()}
    print(f"phase 3 {label} equal, bit for bit, to the other build: {same}; alone ms (other, "
          f"this, this, other): {alone}", flush=True)


def debug_counter_parity(label: str, call, plain, radius: float, frames, inject: bool) -> None:
    """The SHOT debug counter (``--debug_shot``) of a kernel,
    ``call(radius, counter, frames)`` returning its histograms, against its
    twin's, ``plain``: none at the real radius; with ``inject``, the kernel
    told a radius of an eighth of its window's, where a neighbor past ~2.6
    of it has a husk weight that drives its weight sum below 0: the same
    counts in both, some of them unsound weight sums.  Then under
    ``frames`` with a planted NaN (whole frames, and one z-axis component,
    which leaves the azimuth finite): the kernel keeps the NaN as the
    twin's clamps do, so the same counts, NaN in the same histogram entries
    and the rest by the flip rule."""
    import torch

    def counts(r, f):
        k, p = (torch.zeros(2, dtype=torch.int32, device="cuda") for _ in range(2))
        hists = call(r, k, f), plain(r, p, f)
        return k.tolist(), p.tolist(), hists

    real = counts(radius, frames)[:2]
    check(real == ([0, 0], [0, 0]), f"{label} debug counter at the real radius: "
          f"kernel {real[0]}, twin {real[1]}")
    line = f"phase 3 {label} debug counter (bad bins, bad weight sums): kernel {real[0]}, " \
           f"twin {real[1]}"
    if inject:
        k, p, _ = counts(radius / 8, frames)
        check(k == p and k[1] > 0, f"{label} debug counter at an eighth of the radius: "
              f"kernel {k}, twin {p}")
        line += f"; told an eighth of the radius: kernel {k}, twin {p}"
    planted = frames.clone()
    planted[::13] = float("nan")
    planted[6::13, 0, 2] = float("nan")
    k, p, (hist_k, hist_p) = counts(radius, planted)
    nan_k, nan_p = torch.isnan(hist_k), torch.isnan(hist_p)
    check(k == p and k[1] > 0 and torch.equal(nan_k, nan_p),
          f"{label} under planted-NaN frames: kernel {k}, twin {p}, NaN entries "
          f"{int(nan_k.sum())} and {int(nan_p.sum())}, in the same places: "
          f"{torch.equal(nan_k, nan_p)}")
    stats = flip_rule(hist_k.nan_to_num(), hist_p.nan_to_num(), f"{label} under NaN frames")
    line += (f"; planted-NaN frames ({int(torch.isnan(planted).flatten(1).any(1).sum())} of "
             f"{planted.shape[0]}): kernel {k}, twin {p}, NaN entries {int(nan_k.sum())} in "
             f"the twin's places, the rest (flip fraction, max diff) {stats}")
    print(line, flush=True)


def parity_k1(terrain: ShotTerrain, other=None):
    """K1 in its three modes against its twin, timed; with ``other`` (the
    library of another build of the kernels), its outputs also held equal,
    bit for bit, to that build's on the same inputs."""
    import torch

    from shot_fpfh_tpu_torch.ops.shot_fused import (
        shot_binning_histogram,
        shot_binning_histogram_plain,
    )

    radius, kp = terrain.radius, terrain.kp
    vals, dist_inf, _ = terrain.window(bi_scale=False)
    hist_k, rfs_k = shot_binning_histogram(vals, dist_inf, kp, None, radius)
    hist_p, rfs_p = shot_binning_histogram_plain(vals, dist_inf, kp, None, radius)
    hist_g = shot_binning_histogram(vals, dist_inf, kp, rfs_p, radius)
    # SHOT's hard bins jump at their edges, so each histogram is held
    # against the plain binning under the same frames
    hist_pk = shot_binning_histogram_plain(vals, dist_inf, kp, rfs_k, radius)
    torch.cuda.synchronize()
    frame_err = float((rfs_k - rfs_p).abs().max())
    check(frame_err <= K1_FRAME_ATOL, f"K1 frames error {frame_err}")
    stats = {"own frames": flip_rule(hist_k, hist_pk, "K1 own frames"),
             "given frames": flip_rule(hist_g, hist_p, "K1 given frames")}
    debug_counter_parity(
        "K1", lambda r, c, f: shot_binning_histogram(vals, dist_inf, kp, f, r, violations=c),
        lambda r, c, f: shot_binning_histogram_plain(vals, dist_inf, kp, f, r, violations=c),
        radius, rfs_p, inject=True)
    ms = cuda_ms(lambda: shot_binning_histogram(vals, dist_inf, kp, None, radius))
    alone = kernel_ms(lambda: shot_binning_histogram(vals, dist_inf, kp, None, radius),
                      K1_KERNEL)
    plain_ms = cuda_ms(lambda: shot_binning_histogram_plain(vals, dist_inf, kp, None, radius))
    q, _, w = vals.shape
    # the bytes this run's data needs: every lane's distance, and the six
    # value planes (x y z nx ny nz) only at the lanes K1 reads them, the
    # finite ones
    n_lanes = float(torch.isfinite(dist_inf).sum())
    b = bound((6 * n_lanes + q * w + q * 3 + q * (352 + 9)) * 4, n_lanes * OPS_SHOT_NEIGHBOR)
    print(f"phase 3 K1 shot_binning_histogram: {q} keypoints x window {w}: "
          f"frames max err {frame_err:.2e}, (flip fraction, max diff) {stats}; "
          f"kernel {ms:.3f} ms (alone {alone:.4f} ms), plain {plain_ms:.3f} ms, bound "
          f"{b['bound_ms']:.4f} ms ({b['bound_by']})", flush=True)

    # bi-scale mode: frames from the rf plane, bins from the descriptor plane
    bi_vals, bi_dist, rf_dist = terrain.window(bi_scale=True)
    args = (bi_vals, bi_dist, kp, None, terrain.bi_radius)
    rf = dict(rf_dist_inf=rf_dist, rf_radius=terrain.rf_radius)
    bi_hist, bi_rfs = shot_binning_histogram(*args, **rf)
    _, bi_rfs_p = shot_binning_histogram_plain(*args, **rf)
    bi_hist_p = shot_binning_histogram_plain(bi_vals, bi_dist, kp, bi_rfs, terrain.bi_radius)
    torch.cuda.synchronize()
    bi_frame_err = float((bi_rfs - bi_rfs_p).abs().max())
    check(bi_frame_err <= K1_FRAME_ATOL, f"K1 bi-scale frames error {bi_frame_err}")
    stats["bi-scale"] = flip_rule(bi_hist, bi_hist_p, "K1 bi-scale")
    bi_ms = cuda_ms(lambda: shot_binning_histogram(*args, **rf))
    bi_alone = kernel_ms(lambda: shot_binning_histogram(*args, **rf), K1_KERNEL)
    bi_plain_ms = cuda_ms(lambda: shot_binning_histogram_plain(*args, **rf))
    w_bi = bi_vals.shape[2]
    # both planes at every lane; x y z at the lanes finite in either plane,
    # the normals at those the descriptor plane bins
    n_bin, n_frame = float(torch.isfinite(bi_dist).sum()), float(torch.isfinite(rf_dist).sum())
    n_either = float((torch.isfinite(bi_dist) | torch.isfinite(rf_dist)).sum())
    bi_b = bound((3 * n_either + 3 * n_bin + 2 * q * w_bi + q * 3 + q * (352 + 9)) * 4,
                 n_frame * OPS_SHOT_FRAME + n_bin * OPS_SHOT_BIN)
    print(f"phase 3 K1 bi-scale mode: {q} keypoints x window {w_bi}, frames at "
          f"{terrain.rf_radius}, bins at {terrain.bi_radius}: frames max err "
          f"{bi_frame_err:.2e}, (flip fraction, max diff) {stats['bi-scale']}; kernel "
          f"{bi_ms:.3f} ms (alone {bi_alone:.4f} ms), plain {bi_plain_ms:.3f} ms, bound "
          f"{bi_b['bound_ms']:.4f} ms ({bi_b['bound_by']})", flush=True)
    if other is not None:
        bits_against("K1", other, {
            "own frames": lambda: shot_binning_histogram(vals, dist_inf, kp, None, radius),
            "given frames": lambda: (shot_binning_histogram(vals, dist_inf, kp, rfs_p, radius),),
            "bi-scale": lambda: shot_binning_histogram(*args, **rf)}, K1_KERNEL)
    return dict(max_abs_err=max(st[1] for st in stats.values()), ms=ms, plain_ms=plain_ms,
                library_ms=None, **b)


def parity_shot_grid(grid, kp, radius: float, rf_radius: float | None = None,
                     label: str = "", prefix: str = "phase 3", reps: int = 10,
                     plain_rows: int | None = None) -> dict:
    """SHOT's grid kernel (SG, ``shot_grid``) on ``kp`` over ``grid`` in
    K1's modes: own frames and those frames given at ``radius``, or, with
    ``rf_radius``, bi-scale (frames at ``rf_radius``, bins at ``radius``).
    Each call launches SG once and neither K8 nor K1, and its rows, frames
    and counts equal the K8 + K1 route it replaced (``shot_window_chunked``;
    ``torch.equal``); on the first ``plain_rows`` keypoints (every one:
    None) it is held to its twin on the card (``shot_grid_plain``: K8's and
    K1's twins, which sum in another order): the counts equal, the frames
    by phase 17's rule (:func:`frame_rule`, the near-tied sign votes over
    the twin's frame plane), the histograms by the flip rule under SG's
    frames; the K8 + K1 route's frames are measured against the twin by the
    same rule.  The call, the kernel alone, the replaced route and the twin
    are timed.  The bound
    counts a distance test for every window slot of each walk (one with own
    or given frames, two in bi-scale mode) and K5's terms for every
    frame-plane and binned neighbour (operations); the table, its 16-byte
    copy, the cell starts, the keypoints and the outputs once (bytes)."""
    import torch

    from shot_fpfh_tpu_torch import _kernels
    from shot_fpfh_tpu_torch.ops.grid_hash import _zcolumn_runs
    from shot_fpfh_tpu_torch.ops.shot_fused import (
        shot_grid,
        shot_grid_plain,
        shot_window_chunked,
    )

    q, n = kp.shape[0], grid.packed_sorted.shape[0]
    m = q if plain_rows is None else min(plain_rows, q)
    start, end = _zcolumn_runs(grid, kp)
    slots = float(torch.clamp((end - start).sum(1), max=grid.window_cap).sum())
    del start, end
    if rf_radius is None:
        given = shot_grid(grid, kp, radius)[1]
        modes = {"own frames": (None, None), "given frames": (given, None)}
    else:
        modes = {"bi-scale": (None, rf_radius)}
    n_bytes = (n * (grid.packed_sorted.shape[1] * 4 + 16) + grid.cell_starts.numel() * 8
               + q * (3 + 352 + 9 + 1) * 4)
    res = {}
    for mode, (rfs, rfr) in modes.items():
        def call(rfs=rfs, rfr=rfr):
            return shot_grid(grid, kp, radius, rfs=rfs, rf_radius=rfr)

        before = dict(_kernels.launch_counts)
        got = call()
        torch.cuda.synchronize()
        ran = {k: _kernels.launch_counts[k] - before[k] for k in (SG, WINDOW,
                                                                   "shot_binning_histogram")}
        check(ran == {SG: 1, WINDOW: 0, "shot_binning_histogram": 0},
              f"SG on {label}, {mode}: launches {ran}")
        want = shot_window_chunked(grid, kp, radius, rfs=rfs, rf_radius=rfr)
        torch.cuda.synchronize()
        for name, g, w in zip(("rows", "frames", "counts"), got, want):
            check(torch.equal(g, w), f"SG on {label}, {mode}: {int((g != w).sum())} of its "
                  f"{name} differ from K8 + K1's")
        route_frames = want[1][:m]
        del want
        hist, frames, count = got
        check(float(hist.sum()) > 0, f"SG on {label}, {mode}: empty histograms")
        sub = None if rfs is None else rfs[:m]
        plain = shot_grid_plain(grid, kp[:m], radius, rfs=sub, rf_radius=rfr,
                                chunk=SG_PLAIN_CHUNK)
        check(torch.equal(count[:m], plain[2]), f"SG on {label}, {mode}: other counts than "
              "the twin's")
        tied = window_tied_votes(grid, kp[:m], radius if rfr is None else rfr, plain[1])
        rule = frame_rule(frames[:m], plain[1], tied)
        route_rule = frame_rule(route_frames, plain[1], tied)
        del route_frames
        check(rule["ok"], f"SG on {label}, {mode}: frames off the twin's by "
              f"{rule['frame_err']} ({rule['tied']} keypoints with a near-tied sign vote, off by "
              f"{rule['tied_err']} up to the signs; {rule['flipped']} flipped, largest "
              f"{rule['max_err']})")
        same = shot_grid_plain(grid, kp[:m], radius, rfs=frames[:m], chunk=SG_PLAIN_CHUNK)[0]
        flip = flip_rule(hist[:m], same, f"SG on {label}, {mode}")
        n_bin = float(count.sum())
        n_frame = (float(shot_grid(grid, kp, rfr)[2].sum()) if rfr is not None
                   else 0.0 if rfs is not None else n_bin)
        walks = 2 if rfr is not None else 1
        res[mode] = dict(
            max_abs_err=flip[1], frame_err=rule["frame_err"], rule=rule, route_rule=route_rule,
            flip=flip[0], library_ms=None,
            ms=cuda_ms(call, reps), alone=kernel_ms(call, SG_KERNEL, reps),
            chunked_ms=cuda_ms(lambda rfs=rfs, rfr=rfr: shot_window_chunked(
                grid, kp, radius, rfs=rfs, rf_radius=rfr), reps),
            plain_ms=cuda_ms(lambda sub=sub, rfr=rfr: shot_grid_plain(
                grid, kp[:m], radius, rfs=sub, rf_radius=rfr, chunk=SG_PLAIN_CHUNK), reps),
            neighbors=n_bin / q,
            **bound(n_bytes, slots * walks * OPS_DIST_TEST + n_frame * OPS_SHOT_FRAME
                    + n_bin * OPS_SHOT_BIN))
        del got, plain, same
    print(f"{prefix} SG shot_grid on {label}: {q} keypoints, window cap {grid.window_cap} "
          f"({slots / q:.0f} slots a keypoint), " + (f"bins at {radius}, frames at {rf_radius}"
                                                    if rf_radius is not None
                                                    else f"radius {radius}")
          + ": equal to K8 + K1 in every mode; " + "; ".join(
              f"{mode} ({r['neighbors']:.0f} neighbours a keypoint) call {r['ms']:.3f} ms "
              f"(alone {r['alone']:.4f} ms), K8 + K1 route {r['chunked_ms']:.3f} ms, twin "
              f"{r['plain_ms']:.3f} ms on {m} keypoints (frames: {_describe_rule(r['rule'])}; "
              f"the K8 + K1 route's: {_describe_rule(r['route_rule'])}; "
              f"flip fraction {r['flip']:.1e}, max diff {r['max_abs_err']:.2e}), bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']})"
              for mode, r in res.items()), flush=True)
    return res


def window_tied_votes(grid, kp, frame_radius: float, frames):
    """``(Q,)`` True where the x or the z axis of ``frames`` won its sign
    vote over the keypoint's frame plane (its window's slots with ``d <=
    frame_radius``, as K1 and SG count them) by at most VOTE_TIE_MARGIN."""
    import torch

    from shot_fpfh_tpu_torch.ops.grid_hash import _zcolumn_runs
    from shot_fpfh_tpu_torch.ops.radius_runs import fetch_windows_plain

    tied = []
    for s in range(0, kp.shape[0], SG_PLAIN_CHUNK):
        qc, fc = kp[s:s + SG_PLAIN_CHUNK], frames[s:s + SG_PLAIN_CHUNK]
        start, end = _zcolumn_runs(grid, qc)
        vals, d, valid, _ = fetch_windows_plain(grid.packed_sorted, qc, start, end,
                                                grid.window_cap)
        plane = valid & (d <= frame_radius)
        centered = vals[:, :3, :] - qc[:, :, None]
        t = torch.zeros(qc.shape[0], dtype=torch.bool, device=kp.device)
        for j in (0, 2):
            proj = torch.einsum("qiw,qi->qw", centered, fc[:, :, j])
            neg, nonneg = ((proj < 0) & plane).sum(-1), ((proj >= 0) & plane).sum(-1)
            t |= (neg - nonneg).abs() <= VOTE_TIE_MARGIN
        tied.append(t)
        del vals, d, valid, plane, centered
    return torch.cat(tied)


def frame_rule(got, want, tied) -> dict:
    """Phase 17's rule for two frame sets summed in different orders: the
    keypoints without a near-tied sign vote (``tied``, on ``want``'s side)
    within K1_FRAME_ATOL, those with one within it up to the signs, and at
    most VOTE_FLIP_FRAC of all off by more than it."""
    err = (got - want).abs().amax(dim=(1, 2))
    unsigned = (got.abs() - want.abs()).abs().amax(dim=(1, 2))
    frame_err = float(err[~tied].max()) if bool((~tied).any()) else 0.0
    tied_err = float(unsigned[tied].max()) if bool(tied.any()) else 0.0
    flipped = int((err > K1_FRAME_ATOL).sum())
    return dict(ok=(frame_err <= K1_FRAME_ATOL and tied_err <= K1_FRAME_ATOL
                    and flipped <= VOTE_FLIP_FRAC * got.shape[0]),
                frame_err=frame_err, tied_err=tied_err, tied=int(tied.sum()), flipped=flipped,
                turned=flipped / max(got.shape[0], 1), max_err=float(err.max()))


def _describe_rule(r: dict) -> str:
    return (f"within {r['frame_err']:.1e} where no sign vote is near-tied, {r['tied']} near-tied within "
            f"{r['tied_err']:.1e} up to the signs, {r['flipped']} flipped ({r['turned']:.1e}, "
            f"largest {r['max_err']:.2e})")


def sg_at_scale(ref, normals, kp_idx, prefix: str, reps: int) -> dict:
    """SG at the SHOT cells' shapes (:func:`parity_shot_grid`): the ref's
    support at SG_SCALE_SUPPORT, the keypoints ``kp_idx`` padded to
    SCALE_PAD with the far sentinel; single scale at SG_SCALE_RADIUS, then
    bi-scale (bins at SG_SCALE_BI_RADIUS, frames at SG_SCALE_RADIUS).
    Returns the single-scale own-frames result."""
    import torch

    from shot_fpfh_tpu_torch.core.subsampling import grid_subsample
    from shot_fpfh_tpu_torch.ops.grid_hash import build_grid

    dev = ref.device
    pad = -(-len(kp_idx) // SCALE_PAD) * SCALE_PAD
    kp = torch.cat([ref[kp_idx], torch.full((pad - len(kp_idx), 3), 1.0e6, device=dev)])
    sel = torch.as_tensor(grid_subsample(ref, SG_SCALE_SUPPORT), device=dev)
    sup, nrm = ref[sel], normals[sel]
    out = {}
    for radius, rf_radius in ((SG_SCALE_RADIUS, None), (SG_SCALE_BI_RADIUS, SG_SCALE_RADIUS)):
        grid = build_grid(sup, radius / 2, extras=nrm, halo=2)
        out[rf_radius] = parity_shot_grid(grid, kp, radius, rf_radius, label=(
            f"the SHOT cells' shapes ({ref.shape[0]}-point ref, {sup.shape[0]}-point support, "
            f"{len(kp_idx)} keypoints padded to {pad})"), prefix=prefix, reps=reps,
            plain_rows=SG_SCALE_PLAIN_ROWS)
        del grid
    return out[None]["own frames"]


def _route_counts(grid, queries, radius):
    """Per query, its neighbor count (self included) under each radius
    rule: ``rho² <= r·r`` (run routes, K5 and K6) and ``sqrt(rho²) <= r``
    (window routes, K1 and K4)."""
    import torch

    from shot_fpfh_tpu_torch._fp import sqnorm3
    from shot_fpfh_tpu_torch.ops.grid_hash import window_chunk, window_rows

    r = torch.tensor(radius, dtype=torch.float32, device=queries.device)
    runs, window = [], []
    step = window_chunk(grid, 4)
    for s in range(0, queries.shape[0], step):
        qc = queries[s:s + step]
        rows, valid = window_rows(grid, qc)
        cand = grid.points_sorted[rows]
        rho2 = sqnorm3(*(cand[..., i] - qc[:, i:i + 1] for i in range(3)))
        runs.append((valid & (rho2 <= r * r)).sum(1))
        window.append((valid & (torch.sqrt(rho2) <= r)).sum(1))
    return torch.cat(runs), torch.cat(window)


def parity_k5(terrain: ShotTerrain, other=None):
    """K5 in its three modes against its twin (frames atol K1_FRAME_ATOL,
    histograms by the flip rule under the same frames), then against the K1
    window route on the keypoints whose counts agree under both rules; with
    ``other``, its outputs held equal, bit for bit, to that build's."""
    import torch

    from shot_fpfh_tpu_torch.ops.shot_dma import (
        _xyrow_runs,
        shot_descriptor_dma,
        shot_descriptor_dma_plain,
    )
    from shot_fpfh_tpu_torch.ops.shot_fused import shot_binning_histogram

    kp = terrain.kp
    raw = dict(normalize=False, min_neighborhood_size=-1)   # histograms as they are
    modes = {"own": (terrain.grid, terrain.radius, None),
             "bi-scale": (terrain.bi_grid, terrain.bi_radius, terrain.rf_radius)}
    stats, frame_errs, results = {}, {}, {}
    for label, (grid, radius, rf_radius) in modes.items():
        hist, rfs = shot_descriptor_dma(grid, kp, radius, rf_radius=rf_radius, **raw)
        _, rfs_p = shot_descriptor_dma_plain(grid, kp, radius, rf_radius=rf_radius, **raw)
        hist_p, _ = shot_descriptor_dma_plain(grid, kp, radius, rfs=rfs, **raw)
        torch.cuda.synchronize()
        frame_errs[label] = float((rfs - rfs_p).abs().max())
        check(frame_errs[label] <= K1_FRAME_ATOL, f"K5 {label} frames error {frame_errs[label]}")
        stats[label] = flip_rule(hist, hist_p, f"K5 {label}")
        results[label] = (hist, rfs)
    grid, radius = terrain.grid, terrain.radius
    given = shot_descriptor_dma(grid, kp, radius, rfs=results["own"][1], **raw)[0]
    given_p = shot_descriptor_dma_plain(grid, kp, radius, rfs=results["own"][1], **raw)[0]
    stats["given"] = flip_rule(given, given_p, "K5 given frames")
    # K5 bins only the rows its radius holds, so every weight sum it bins
    # under real frames is sound: its counter is held at 0 against the
    # twin's there, and to the twin's under planted-NaN frames
    own_rfs = results["own"][1]
    debug_counter_parity(
        "K5", lambda r, c, f: shot_descriptor_dma(grid, kp, r, rfs=f, violations=c, **raw)[0],
        lambda r, c, f: shot_descriptor_dma_plain(grid, kp, r, rfs=f, violations=c, **raw)[0],
        radius, own_rfs, inject=False)

    # against the K1 window route, on the keypoints whose neighbor sets the
    # two radius rules agree on (both planes in bi-scale mode)
    route = {}
    for label, (grid, radius, rf_radius) in modes.items():
        vals, dist_inf, rf_dist = terrain.window(bi_scale=rf_radius is not None)
        same = torch.eq(*_route_counts(grid, kp, radius))
        if rf_radius is not None:
            same &= torch.eq(*_route_counts(grid, kp, rf_radius))
        parted = kp.shape[0] - int(same.sum())
        check(parted <= SHOT_ROUTE_PARTED_FRAC * kp.shape[0],
              f"K5 vs the K1 route ({label}): the radius rules part on {parted} keypoints")
        hist, rfs = results[label]
        _, rfs_k1 = shot_binning_histogram(vals, dist_inf, kp, None, radius,
                                           rf_dist_inf=rf_dist, rf_radius=rf_radius)
        err = float((rfs[same] - rfs_k1[same]).abs().max())
        check(err <= K1_FRAME_ATOL, f"K5 vs the K1 route ({label}): frames error {err}")
        hist_k1 = shot_binning_histogram(vals, dist_inf, kp, rfs, radius)
        route[label] = (parted, err, flip_rule(hist[same], hist_k1[same],
                                               f"K5 vs the K1 route ({label})"))

    if other is not None:
        own_rfs = results["own"][1]
        bits_against("K5", other, {
            "own frames": lambda: shot_descriptor_dma(terrain.grid, kp, terrain.radius, **raw),
            "given frames": lambda: shot_descriptor_dma(terrain.grid, kp, terrain.radius,
                                                        rfs=own_rfs, **raw),
            "bi-scale": lambda: shot_descriptor_dma(terrain.bi_grid, kp, terrain.bi_radius,
                                                    rf_radius=terrain.rf_radius, **raw)},
            K5_KERNEL)

    grid, radius = terrain.bi_grid, terrain.bi_radius
    rf = dict(rf_radius=terrain.rf_radius)
    ms = cuda_ms(lambda: shot_descriptor_dma(grid, kp, radius, **rf, **raw))
    plain_ms = cuda_ms(lambda: shot_descriptor_dma_plain(grid, kp, radius, **rf, **raw))
    own_ms = cuda_ms(lambda: shot_descriptor_dma(terrain.grid, kp, terrain.radius, **raw))
    alone = kernel_ms(lambda: shot_descriptor_dma(grid, kp, radius, **rf, **raw), K5_KERNEL)
    own_alone = kernel_ms(lambda: shot_descriptor_dma(terrain.grid, kp, terrain.radius, **raw),
                          K5_KERNEL)
    q = kp.shape[0]

    def work(grid, radius, rf_radius):
        """The timed call's work: every row of the keypoints' runs tested
        once, the frame plane's neighbors reduced, the descriptor plane's
        binned; ``(rows, frame and binned neighbors, runs, bound)``."""
        start, end = _xyrow_runs(grid, kp)
        lanes = float((end - start).sum())
        n_bin = float(_route_counts(grid, kp, radius)[0].sum()) - q   # the keypoint itself: d = 0
        n_frame = float(_route_counts(grid, kp, rf_radius)[0].sum())
        b = bound(grid.packed_sorted.numel() * 4 + q * 12 + start.numel() * 16
                  + q * (352 + 10) * 4,
                  lanes * OPS_DIST_TEST + n_frame * OPS_SHOT_FRAME + n_bin * OPS_SHOT_BIN)
        return lanes, n_frame, n_bin, start.shape[1], b

    lanes, n_frame, n_bin, n_runs, b = work(grid, radius, terrain.rf_radius)
    own_lanes, _, own_bin, _, own_b = work(terrain.grid, terrain.radius, terrain.radius)
    print(f"phase 3 K5 shot_runs: {q} keypoints x {n_runs} xy-row runs (bi-scale "
          f"grid: longest run {xyrow_grid(grid)[1]}, {lanes / q:.0f} rows, {n_frame / q:.0f} "
          f"frame and {n_bin / q:.0f} descriptor neighbors a keypoint): frames max err "
          f"{frame_errs}, (flip fraction, max diff) vs twin {stats}; vs the K1 route "
          f"(parted keypoints, frames err, (flip, max diff)) {route}; bi-scale kernel "
          f"{ms:.3f} ms (alone {alone:.4f} ms), plain {plain_ms:.3f} ms, bound "
          f"{b['bound_ms']:.4f} ms ({b['bound_by']}); own frames at {terrain.radius} "
          f"({own_lanes / q:.0f} rows, {own_bin / q:.0f} neighbors a keypoint) kernel "
          f"{own_ms:.3f} ms (alone {own_alone:.4f} ms), bound {own_b['bound_ms']:.4f} ms "
          f"({own_b['bound_by']})",
          flush=True)
    return dict(max_abs_err=max(st[1] for st in stats.values()), ms=ms, plain_ms=plain_ms,
                library_ms=None, **b)


def spfh_terrain(dev, rng):
    """The FPFH path's SPFH grid on a 100k-point smoke terrain: cell
    radius/2, halo 2, the main path's k=30 normals (through K3)."""
    import torch

    from shot_fpfh_tpu_torch.models.normals import compute_normals
    from shot_fpfh_tpu_torch.ops.grid_hash import build_grid

    cloud = torch.tensor(make_terrain(100_000, rng), device=dev)
    normals = compute_normals(cloud, cloud, k=30, device=dev)
    grid = build_grid(cloud, FPFH_RADIUS / 2, extras=normals, halo=2)
    check(all(xyrow_grid(grid)), "the smoke terrain's SPFH grid is not an xy-row grid")
    return grid


def parity_k4(grid, radius: float = FPFH_RADIUS, prefix: str = "phase 3", reps: int = 10):
    import torch

    from shot_fpfh_tpu_torch.ops.grid_hash import window_distances
    from shot_fpfh_tpu_torch.ops.spfh_fused import spfh_histogram, spfh_histogram_plain

    # the first chunk of models.fpfh._spfh_window_sorted
    qc, qn = (grid.packed_sorted[:8192, i:i + 3].contiguous() for i in (0, 3))
    vals, d, valid, _ = window_distances(grid, qc)
    ok = valid & (d <= radius)
    dist_inf = torch.where(ok, d, torch.full_like(d, float("inf")))
    c, nf, w = vals.shape
    neighbors = float((ok & (d > 0)).sum())
    n_finite = float(ok.sum())
    stats, times, bounds = {}, {}, {}
    for dec in (False, True):
        got = spfh_histogram(vals, dist_inf, qc, qn, 5, dec)
        want = spfh_histogram_plain(vals, dist_inf, qc, qn, 5, dec)
        torch.cuda.synchronize()
        diff = (got - want).abs()
        flip, top = float((diff > 0).float().mean()), float(diff.max())
        check(flip <= K4_FLIP_FRAC and top <= K4_MAX_COUNTS,
              f"K4 decorrelated={dec}: {flip} of elements differ, max {top} counts")
        check(float(want.sum()) > 0, "K4: empty histograms")
        stats[dec] = (flip, top)
        times[dec] = (cuda_ms(lambda: spfh_histogram(vals, dist_inf, qc, qn, 5, dec), reps),
                      kernel_ms(lambda: spfh_histogram(vals, dist_inf, qc, qn, 5, dec),
                                K4_KERNEL, reps),
                      cuda_ms(lambda: spfh_histogram_plain(vals, dist_inf, qc, qn, 5, dec), reps))
        # the bytes this run's data needs (K1's rule): every lane's distance,
        # and the six value planes only at the finite lanes, which K4 reads
        bounds[dec] = bound((c * w + 6 * n_finite + c * 6 + c * got.shape[1]) * 4,
                            c * w * 2 + neighbors * OPS_SPFH_NEIGHBOR)
    # the rule of the earlier PRs: every value plane at every lane
    all_planes = bound((c * nf * w + c * w + c * 6 + c * 125) * 4,
                       c * w * 2 + neighbors * OPS_SPFH_NEIGHBOR)
    ms, alone, plain_ms = times[False]
    dec_ms, dec_alone, dec_plain = times[True]
    b, dec_b = bounds[False], bounds[True]
    print(f"{prefix} K4 spfh_histogram: {c} queries x window {w}, radius {radius} "
          f"({n_finite / c:.0f} finite lanes a query): (fraction differing, max count diff) "
          f"joint {stats[False]}, decorrelated {stats[True]}; joint kernel {ms:.3f} ms "
          f"(alone {alone:.4f} ms) plain {plain_ms:.3f} ms, bound {b['bound_ms']:.4f} ms "
          f"({b['bound_by']}); decorrelated kernel {dec_ms:.3f} ms (alone {dec_alone:.4f} ms) "
          f"plain {dec_plain:.3f} ms, bound {dec_b['bound_ms']:.4f} ms ({dec_b['bound_by']}); "
          f"joint bound with every value plane read {all_planes['bound_ms']:.4f} ms",
          flush=True)
    return dict(max_abs_err=max(s[1] for s in stats.values()), ms=ms, plain_ms=plain_ms,
                library_ms=None, **b)


def parity_spfh_pass(grid, radius: float, label: str, prefix: str = "phase 3", reps: int = 10,
                     plain_rows: int | None = None, chunk_reps: int | None = None) -> dict:
    """FPFH's SPFH pass kernel (``spfh_grid``) over every row of ``grid``
    in both modes: equal to the chunked route it replaced (K8 + K4,
    ``spfh_window_chunked``; ``torch.equal``) and, on the first
    ``plain_rows`` rows (every row: None), held to its plain twin (K8's and
    K4's twins on the card) by K4's rule; the call, the kernel alone, the
    chunked route (``chunk_reps`` timed calls) and the twin timed.  The
    bound counts a distance test for every window slot and the binning of
    every neighbor in radius (operations), the table, the cell starts and
    the output once (bytes)."""
    import torch

    from shot_fpfh_tpu_torch.ops.grid_hash import _zcolumn_runs
    from shot_fpfh_tpu_torch.ops.radius_runs import fpfh_aggregate
    from shot_fpfh_tpu_torch.ops.spfh_fused import (
        spfh_grid,
        spfh_grid_plain,
        spfh_window_chunked,
    )

    table = grid.packed_sorted
    n, dev = table.shape[0], table.device
    qc, qn = table[:, :3], table[:, 3:6]
    m = n if plain_rows is None else min(plain_rows, n)
    chunk_reps = reps if chunk_reps is None else chunk_reps
    start, end = _zcolumn_runs(grid, qc)
    slots = float(torch.clamp((end - start).sum(1), max=grid.window_cap).sum())
    del start, end
    # the slots in radius by the same rule: the aggregation kernel's counts
    _, counts = fpfh_aggregate(grid, torch.zeros((n, 1), device=dev),
                               torch.arange(n, device=dev), radius, return_counts=True)
    neighbors = float(counts.sum()) - n
    res = {}
    for dec in (False, True):
        got = spfh_grid(grid, qc, qn, radius, 5, dec)
        want = spfh_window_chunked(grid, qc, qn, radius, 5, dec)
        torch.cuda.synchronize()
        check(torch.equal(got, want),
              f"SPFH pass on {label}, decorrelated={dec}: {int((got != want).sum())} elements "
              f"differ from K8 + K4, max {float((got - want).abs().max())}")
        check(float(got.sum()) > 0, f"SPFH pass on {label}: empty histograms")
        del want
        plain = spfh_grid_plain(grid, qc[:m], qn[:m], radius, 5, dec, chunk=SPFH_PLAIN_CHUNK)
        diff = (got[:m] - plain).abs()
        flip = float((diff > 0).float().mean())
        check(flip <= K4_FLIP_FRAC, f"SPFH pass on {label}, decorrelated={dec}: {flip} of the "
              f"twin's elements differ")
        res[dec] = dict(
            max_abs_err=float(diff.max()), flip=flip, library_ms=None,
            ms=cuda_ms(lambda: spfh_grid(grid, qc, qn, radius, 5, dec), reps),
            alone=kernel_ms(lambda: spfh_grid(grid, qc, qn, radius, 5, dec), SPFH_PASS_KERNEL,
                            reps),
            chunked_ms=cuda_ms(lambda: spfh_window_chunked(grid, qc, qn, radius, 5, dec),
                               chunk_reps),
            plain_ms=cuda_ms(lambda: spfh_grid_plain(grid, qc[:m], qn[:m], radius, 5, dec,
                                                     chunk=SPFH_PLAIN_CHUNK), chunk_reps),
            **bound(table.numel() * 4 + grid.cell_starts.numel() * 8 + n * got.shape[1] * 4,
                    slots * OPS_DIST_TEST + neighbors * OPS_SPFH_NEIGHBOR))
        del got, plain, diff
    print(f"{prefix} SPFH pass spfh_grid on {label}: {n} queries, radius {radius}, window cap "
          f"{grid.window_cap} ({slots / n:.0f} slots and {neighbors / n:.0f} neighbors a "
          f"query): equal to K8 + K4 in both modes; " + "; ".join(
              f"{'decorrelated' if dec else 'joint'} call {r['ms']:.3f} ms (alone "
              f"{r['alone']:.4f} ms), K8 + K4 route {r['chunked_ms']:.3f} ms, twin "
              f"{r['plain_ms']:.3f} ms on {m} rows ({r['flip']:.1e} of its elements differ, "
              f"max {r['max_abs_err']:.2e}), bound {r['bound_ms']:.4f} ms ({r['bound_by']})"
              for dec, r in res.items()), flush=True)
    return res[False]


def parity_k6(grid):
    """K6 in both modes equal to its twin (``torch.equal``: whole counts
    over the same angles), then the joint mode against the window route
    (the SPFH pass kernel) on the rows whose two radius rules agree; call,
    kernel alone and twin timed in both modes."""
    import torch

    from shot_fpfh_tpu_torch.models.fpfh import _spfh_window_sorted
    from shot_fpfh_tpu_torch.ops.shot_dma import (
        _xyrow_runs,
        spfh_sorted_dma,
        spfh_sorted_dma_plain,
    )

    n = grid.packed_sorted.shape[0]
    # this run's work: every row of the queries' runs is tested, every
    # in-radius neighbor but the query itself binned
    start, end = _xyrow_runs(grid, grid.packed_sorted[:, :3])
    lanes = float((end - start).sum())
    cnt_runs, cnt_window = _route_counts(grid, grid.packed_sorted[:, :3], FPFH_RADIUS)
    neighbors = float(cnt_runs.sum()) - n
    times, bounds, hists, errs = {}, {}, {}, []
    for dec in (False, True):
        got = spfh_sorted_dma(grid, FPFH_RADIUS, 5, dec)
        want = spfh_sorted_dma_plain(grid, FPFH_RADIUS, 5, dec)
        torch.cuda.synchronize()
        errs.append(float((got - want).abs().max()))
        check(torch.equal(got, want),
              f"K6 decorrelated={dec}: {int((got != want).sum())} elements differ from the "
              f"twin, max {float((got - want).abs().max())}")
        check(float(want.sum()) > 0, "K6: empty histograms")
        hists[dec] = got
        times[dec] = (cuda_ms(lambda: spfh_sorted_dma(grid, FPFH_RADIUS, 5, dec)),
                      kernel_ms(lambda: spfh_sorted_dma(grid, FPFH_RADIUS, 5, dec), K6_KERNEL),
                      cuda_ms(lambda: spfh_sorted_dma_plain(grid, FPFH_RADIUS, 5, dec)))
        bounds[dec] = bound(grid.packed_sorted.numel() * 4 + grid.cell_starts.numel() * 8
                            + n * got.shape[1] * 4,
                            lanes * OPS_DIST_TEST + neighbors * OPS_SPFH_NEIGHBOR)
    # the two routes' radius rules part on a neighbor whose sqrt rounds onto
    # the radius: that row's count, and with it every bin, moves by one
    # neighbor (row sum ~1/count); the other rows are held to the rule
    window = _spfh_window_sorted(grid, FPFH_RADIUS, 5, False)
    same = cnt_runs == cnt_window
    parted = n - int(same.sum())
    check(parted <= SPFH_ELEM_FRAC * n,
          f"K6 vs the window route: the radius rules part on {parted} of {n} rows")
    route_err = route_rule(hists[False][same], window[same], "K6 vs the window route")
    (ms, alone, plain_ms), (dec_ms, dec_alone, dec_plain) = times[False], times[True]
    b, dec_b = bounds[False], bounds[True]
    print(f"phase 3 K6 spfh_runs: {n} queries x {start.shape[1]} xy-row runs (longest "
          f"{xyrow_grid(grid)[1]}, {lanes / n:.0f} rows and {neighbors / n:.0f} neighbors a "
          f"query): equal to the twin in both modes; window route held on the {n - parted} rows "
          f"whose radius rules agree ({parted} part, max diff {route_err:.2e}); joint kernel "
          f"{ms:.3f} ms (alone {alone:.4f} ms) plain {plain_ms:.3f} ms, bound "
          f"{b['bound_ms']:.4f} ms ({b['bound_by']}); decorrelated kernel {dec_ms:.3f} ms "
          f"(alone {dec_alone:.4f} ms) plain {dec_plain:.3f} ms, bound "
          f"{dec_b['bound_ms']:.4f} ms ({dec_b['bound_by']})", flush=True)
    return dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, library_ms=None, **b)


def voxel_sums(dev, rng, cluster: int = VOXEL_CLUSTER, terrain: int = 100_000,
               prefix: str = "phase 3", reps: int = 10) -> None:
    """The voxel sums of ``core/subsampling.py`` (no TPU kernel's port) on a
    skewed cloud: a ``terrain``-point terrain plus a cluster of ``cluster``
    points in one keypoint voxel (with no terrain, the whole cloud is that
    voxel).  The card's sums must be bit-identical to the CPU's
    ``index_add_``; timed beside the card's ``index_add_`` (atomic order)
    and inside the whole ``grid_subsample``."""
    import torch

    from shot_fpfh_tpu_torch.core.subsampling import (
        _segment_sums,
        _voxel_segments,
        grid_subsample,
    )

    base = make_terrain(terrain, rng) if terrain else np.zeros((0, 3), np.float32)
    corner = base[0] if terrain else np.zeros(3, np.float32)
    dense = corner + rng.uniform(0.0, 1e-3, size=(cluster, 3)).astype(np.float32)
    cloud = torch.tensor(np.concatenate([base, dense]), device=dev)
    order, seg, counts, _ = _voxel_segments(cloud, KEYPOINT_VOXEL)
    n_seg = int(seg[-1]) + 1
    lengths, pts = counts[:n_seg].to(torch.int64), cloud[order]
    want = torch.zeros(n_seg, 3).index_add_(0, seg.cpu(), pts.cpu())
    check(torch.equal(_segment_sums(pts, lengths).cpu(), want),
          "voxel sums on the card differ from the CPU's index_add_")
    longest = int(lengths.max())
    check(longest >= cluster, f"the dense voxel holds {longest} points")
    ms = cuda_ms(lambda: _segment_sums(pts, lengths), reps)
    index_add_ms = cuda_ms(lambda: torch.zeros((n_seg, 3), device=dev).index_add_(0, seg, pts),
                           reps)
    skewed_ms = cuda_ms(lambda: grid_subsample(cloud, KEYPOINT_VOXEL), reps)
    uniform = (f" (without the cluster "
               f"{cuda_ms(lambda: grid_subsample(cloud[:terrain], KEYPOINT_VOXEL), reps):.3f} ms)"
               if terrain else "")
    print(f"{prefix} voxel sums: {cloud.shape[0]} points in {n_seg} voxels of "
          f"{KEYPOINT_VOXEL}, longest {longest}: bit-identical to the CPU; segment sums "
          f"{ms:.3f} ms, index_add_ {index_add_ms:.3f} ms; grid_subsample {skewed_ms:.3f} ms"
          f"{uniform}", flush=True)


def _runs_case(grid, queries):
    """The K7 / K8 inputs of ``queries`` on ``grid``: its table, the runs and
    the window width; the count of window slots inside the runs; and the
    count of distinct table rows those slots read (the union of the runs,
    each cut where its query's window is full), which a bound reads once."""
    import torch

    from shot_fpfh_tpu_torch.ops.grid_hash import _zcolumn_runs

    start, end = _zcolumn_runs(grid, queries)
    w, n = grid.window_cap, grid.packed_sorted.shape[0]
    length = torch.clamp(end - start, min=0)
    kept = torch.minimum(length, torch.clamp(w - (torch.cumsum(length, 1) - length), min=0))
    lanes = float(kept.sum())
    edges = torch.zeros(n + 1, dtype=torch.int64, device=start.device)
    edges.index_add_(0, start.reshape(-1), torch.ones_like(start.reshape(-1)))
    edges.index_add_(0, (start + kept).reshape(-1), -torch.ones_like(start.reshape(-1)))
    rows = float((torch.cumsum(edges, 0)[:n] > 0).sum())
    return (grid.packed_sorted, queries, start, end, w), lanes, rows


def _max_abs_diff(got, want) -> float:
    """The largest |got - want| of two float tensors, equal entries
    (infinities included) counting 0."""
    import torch

    return float(torch.where(got == want, 0.0, (got - want).abs()).max())


def parity_k8(label: str, grid, queries, prefix: str = "phase 3", reps: int = 10) -> dict:
    """K8 against its twin on every output (``torch.equal``), with the rows
    plane and without it (the mode the window routes call); bound: the
    window written ((Q, W) slots of F + 1 floats, a bool and, with rows, an
    int64), the run rows read once, a distance per row.  The returned
    timings are those of the mode without rows."""
    import torch

    from shot_fpfh_tpu_torch.ops.radius_runs import fetch_windows, fetch_windows_plain

    args, lanes, rows = _runs_case(grid, queries)
    got, want = fetch_windows(*args), fetch_windows_plain(*args)
    no_rows = fetch_windows(*args, with_rows=False)
    torch.cuda.synchronize()
    for name, g, w in zip(("vals", "dist", "valid", "rows"), got, want):
        check(torch.equal(g, w), f"K8 {label}: {name} differs from the plain version")
    check(no_rows[3] is None, f"K8 {label}: rows returned without rows")
    for name, g, w in zip(("vals", "dist", "valid"), no_rows, want):
        check(torch.equal(g, w), f"K8 {label} without rows: {name} differs from the plain version")
    err = max(_max_abs_diff(got[0], want[0]), _max_abs_diff(got[1], want[1]))
    rows_ms = cuda_ms(lambda: fetch_windows(*args), reps)
    ms = cuda_ms(lambda: fetch_windows(*args, with_rows=False), reps)
    alone = kernel_ms(lambda: fetch_windows(*args, with_rows=False), K8_KERNEL, reps)
    rows_alone = kernel_ms(lambda: fetch_windows(*args), K8_KERNEL, reps)
    plain_ms = cuda_ms(lambda: fetch_windows_plain(*args), reps)
    q, f, w = got[0].shape
    read = rows * 4 * f + q * 12 + args[2].numel() * 16
    b_rows = bound(q * w * (4 * f + 4 + 1 + 8) + read, lanes * OPS_DIST_TEST)
    b = bound(q * w * (4 * f + 4 + 1) + read, lanes * OPS_DIST_TEST)
    print(f"{prefix} K8 fetch_windows ({label}): {q} queries x window {w}, {f} features, "
          f"halo {grid.halo}, {lanes / q:.0f} rows a query: vals, dist, valid and rows "
          f"bit-identical with and without the rows plane (max abs err {err}); with rows: "
          f"kernel {rows_ms:.3f} ms (alone {rows_alone:.4f} ms), bound "
          f"{b_rows['bound_ms']:.4f} ms; without: kernel {ms:.3f} ms (alone {alone:.4f} ms), "
          f"bound {b['bound_ms']:.4f} ms ({b['bound_by']}); plain {plain_ms:.3f} ms",
          flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None, **b)


def parity_k7(label: str, grid, queries, radius: float, prefix: str = "phase 3",
               reps: int = 10) -> dict:
    """K7 against its twin on both outputs (``torch.equal``); bound: the
    (Q, W) rows and distances written, the run rows' xyz read once, a
    distance per row."""
    import torch

    from shot_fpfh_tpu_torch.ops.radius_runs import radius_dist, radius_dist_plain

    args, lanes, rows = _runs_case(grid, queries)
    got, want = radius_dist(*args, radius), radius_dist_plain(*args, radius)
    torch.cuda.synchronize()
    for name, g, w in zip(("rows", "dist"), got, want):
        check(torch.equal(g, w), f"K7 {label}: {name} differs from the plain version")
    err = _max_abs_diff(got[1], want[1])
    ms = cuda_ms(lambda: radius_dist(*args, radius), reps)
    alone = kernel_ms(lambda: radius_dist(*args, radius), K7_KERNEL, reps)
    plain_ms = cuda_ms(lambda: radius_dist_plain(*args, radius), reps)
    q, w = got[0].shape
    inside = float(torch.isfinite(got[1]).sum())
    b = bound(q * w * (4 + 8) + rows * 12 + q * 12 + args[2].numel() * 16,
              lanes * OPS_DIST_TEST)
    print(f"{prefix} K7 radius_dist ({label}): {q} queries x window {w}, halo {grid.halo}, "
          f"radius {radius}, {lanes / q:.0f} rows and {inside / q:.1f} within the radius a "
          f"query: rows and distances bit-identical (max abs err {err}); kernel {ms:.3f} ms "
          f"(alone {alone:.4f} ms), plain {plain_ms:.3f} ms, bound {b['bound_ms']:.4f} ms "
          f"({b['bound_by']})",
          flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None, **b)


def k1_own_frames(grid, kp, radius: float, reps: int = 10) -> dict:
    """K1 in its own-frames mode on ``kp``'s windows of ``grid`` (one
    fetch, as a chunk of the window route) against its twin: frames within
    K1_FRAME_ATOL, the histograms by the flip rule under the kernel's
    frames; timed (``reps`` runs), its bound by ``parity_k1``'s rule."""
    import torch

    from shot_fpfh_tpu_torch.ops.grid_hash import window_distances
    from shot_fpfh_tpu_torch.ops.shot_fused import (
        shot_binning_histogram,
        shot_binning_histogram_plain,
    )

    vals, d, valid, _ = window_distances(grid, kp, with_rows=False)
    dist_inf = torch.where(valid & (d <= radius), d, torch.full_like(d, float("inf")))
    hist, rfs = shot_binning_histogram(vals, dist_inf, kp, None, radius)
    _, rfs_p = shot_binning_histogram_plain(vals, dist_inf, kp, None, radius)
    hist_p = shot_binning_histogram_plain(vals, dist_inf, kp, rfs, radius)
    torch.cuda.synchronize()
    err = float((rfs - rfs_p).abs().max())
    check(err <= K1_FRAME_ATOL, f"K1 own frames on {kp.shape[0]} keypoints: frames error {err}")
    flip = flip_rule(hist, hist_p, f"K1 own frames on {kp.shape[0]} keypoints")
    ms = cuda_ms(lambda: shot_binning_histogram(vals, dist_inf, kp, None, radius), reps)
    alone = kernel_ms(lambda: shot_binning_histogram(vals, dist_inf, kp, None, radius),
                      K1_KERNEL, reps)
    plain_ms = cuda_ms(lambda: shot_binning_histogram_plain(vals, dist_inf, kp, None, radius),
                       reps)
    q, _, w = vals.shape
    n_lanes = float(torch.isfinite(dist_inf).sum())     # parity_k1's rule
    b = bound((6 * n_lanes + q * w + q * 3 + q * (352 + 9)) * 4, n_lanes * OPS_SHOT_NEIGHBOR)
    text = (f"{q} keypoints frames max err {err:.2e}, (flip fraction, max diff) {flip}, "
            f"kernel {ms:.3f} ms (alone {alone:.4f} ms), bound {b['bound_ms']:.4f} ms "
            f"({b['bound_by']})")
    return dict(max_abs_err=flip[1], ms=ms, plain_ms=plain_ms, library_ms=None, text=text, **b)


def k5_own_frames(grid, kp, radius: float, reps: int = 10) -> dict:
    """K5 in its own-frames mode on ``kp`` over ``grid``'s xy-row runs
    against its twin, as :func:`k1_own_frames` holds K1; its bound by
    ``parity_k5``'s rule (one radius)."""
    import torch

    from shot_fpfh_tpu_torch.ops.shot_dma import (
        _xyrow_runs,
        shot_descriptor_dma,
        shot_descriptor_dma_plain,
    )

    raw = dict(normalize=False, min_neighborhood_size=-1)
    hist, rfs = shot_descriptor_dma(grid, kp, radius, **raw)
    _, rfs_p = shot_descriptor_dma_plain(grid, kp, radius, **raw)
    hist_p, _ = shot_descriptor_dma_plain(grid, kp, radius, rfs=rfs, **raw)
    torch.cuda.synchronize()
    err = float((rfs - rfs_p).abs().max())
    check(err <= K1_FRAME_ATOL, f"K5 own frames on {kp.shape[0]} keypoints: frames error {err}")
    flip = flip_rule(hist, hist_p, f"K5 own frames on {kp.shape[0]} keypoints")
    ms = cuda_ms(lambda: shot_descriptor_dma(grid, kp, radius, **raw), reps)
    alone = kernel_ms(lambda: shot_descriptor_dma(grid, kp, radius, **raw), K5_KERNEL, reps)
    plain_ms = cuda_ms(lambda: shot_descriptor_dma_plain(grid, kp, radius, **raw), reps)
    # parity_k5's rule: every row of the runs tested, the frame plane's
    # neighbors reduced and the descriptor plane's binned (one radius here)
    start, end = _xyrow_runs(grid, kp)
    n_in = float(_route_counts(grid, kp, radius)[0].sum())
    q = kp.shape[0]
    b = bound(grid.packed_sorted.numel() * 4 + q * 12 + start.numel() * 16 + q * (352 + 10) * 4,
              float((end - start).sum()) * OPS_DIST_TEST + n_in * OPS_SHOT_FRAME
              + (n_in - q) * OPS_SHOT_BIN)
    text = (f"{q} keypoints frames max err {err:.2e}, (flip fraction, max diff) {flip}, "
            f"kernel {ms:.3f} ms (alone {alone:.4f} ms), bound {b['bound_ms']:.4f} ms "
            f"({b['bound_by']})")
    return dict(max_abs_err=flip[1], ms=ms, plain_ms=plain_ms, library_ms=None, text=text, **b)


def parity_fused_shapes(pair, dev) -> None:
    """K8, K1 and K5 at the fused program's SHOT shapes (the scan's
    keypoints at voxel KEYPOINT_VOXEL on its full-cloud grid of cell
    FUSED_SHOT_CELL, halo 1, k=30 normals: K8 and K1 on the first keypoint
    chunk of the window route, K5 on 4096 keypoints), K2 in f32 at the
    fused path's padded keypoint count; each against its twin as above."""
    import torch

    from shot_fpfh_tpu_torch.core.subsampling import grid_subsample
    from shot_fpfh_tpu_torch.models.normals import compute_normals
    from shot_fpfh_tpu_torch.ops.grid_hash import build_grid, window_chunk

    scan = torch.tensor(pair.scan, device=dev)
    grid = build_grid(scan, FUSED_SHOT_CELL, extras=compute_normals(scan, scan, k=30,
                                                                     device=dev))
    check(all(xyrow_grid(grid)), "the fused SHOT grid is not an xy-row grid")
    kp = scan[torch.as_tensor(grid_subsample(scan, KEYPOINT_VOXEL), device=dev)]
    chunk = kp[:min(4096, window_chunk(grid, 8))]
    parity_k8("the fused SHOT grid", grid, chunk)
    k1 = k1_own_frames(grid, chunk, FUSED_SHOT_CELL)
    k5 = k5_own_frames(grid, kp[:4096], FUSED_SHOT_CELL)
    print(f"phase 3 K1 and K5 on the fused SHOT grid (cell {FUSED_SHOT_CELL}, halo 1, "
          f"window {grid.window_cap}, longest xy-row run {xyrow_grid(grid)[1]}): K1 "
          f"{k1['text']}; K5 {k5['text']}", flush=True)
    n_pad = -(-kp.shape[0] // 256) * 256
    parity_k2(dev, np.random.default_rng(2), n_pad, 352, modes=(False,))


def replaced_nearest(grid, queries):
    """The grid 1-NN as the port ran it before K7's 1-NN mode: K7 at radius
    +inf in ``window_chunk`` chunks, the row minimum, two gathers."""
    import torch

    from shot_fpfh_tpu_torch.ops.grid_hash import window_chunk, window_radius_dist

    dist_out, idx_out = [], []
    step = window_chunk(grid, 4)
    for s in range(0, queries.shape[0], step):
        rows, masked = window_radius_dist(grid, queries[s:s + step], float("inf"))
        best, pos = masked.min(dim=1)
        dist_out.append(best)
        idx_out.append(grid.orig_idx[torch.gather(rows, 1, pos[:, None])[:, 0]])
    return torch.cat(dist_out), torch.cat(idx_out)


def parity_nearest(label: str, grid, queries, prefix: str = "phase 3", reps: int = 10) -> dict:
    """K7's 1-NN mode against its twin and against the route it replaced,
    both outputs ``torch.equal``, at each lanes-a-query variant; timed
    beside that route (its K7 launches alone too); bound: the table's xyz,
    the cell-start table, ``orig_idx`` and the queries read once, 12 bytes
    a query written, a distance test for every row of the queries'
    windows."""
    import torch

    from shot_fpfh_tpu_torch.ops.grid_hash import window_chunk
    from shot_fpfh_tpu_torch.ops.radius_runs import nearest, nearest_lanes, nearest_plain

    got, want = nearest(grid, queries), nearest_plain(grid, queries)
    old = replaced_nearest(grid, queries)
    torch.cuda.synchronize()
    for name, g, w, o in zip(("dist", "idx"), got, want, old):
        check(torch.equal(g, w), f"1-NN {label}: {name} differs from the plain version")
        check(torch.equal(g, o), f"1-NN {label}: {name} differs from the replaced route")
    alone = {}
    for lanes in (32, 8):
        other = nearest(grid, queries, lanes=lanes)
        check(torch.equal(other[0], want[0]) and torch.equal(other[1], want[1]),
              f"1-NN {label}: {lanes} lanes a query differs from the plain version")
        alone[lanes] = kernel_ms(lambda: nearest(grid, queries, lanes=lanes), NN_KERNEL, reps)
    err = _max_abs_diff(got[0], want[0])
    ms = cuda_ms(lambda: nearest(grid, queries), reps)
    plain_ms = cuda_ms(lambda: nearest_plain(grid, queries), reps)
    old_ms = cuda_ms(lambda: replaced_nearest(grid, queries), reps)
    q = queries.shape[0]
    old_launches = -(-q // window_chunk(grid, 4))
    old_alone = kernel_ms(lambda: replaced_nearest(grid, queries), K7_KERNEL,
                          reps) * old_launches
    _, lanes_used, _ = _runs_case(grid, queries)
    n = grid.packed_sorted.shape[0]
    b = bound(n * 12 + grid.cell_starts.numel() * 8 + n * 8 + q * 12 + q * 12,
              lanes_used * OPS_DIST_TEST)
    print(f"{prefix} K7 1-NN mode nearest ({label}): {q} queries, window cap "
          f"{grid.window_cap}, halo {grid.halo}, {lanes_used / q:.0f} rows a query, "
          f"{int(torch.isinf(got[0]).sum())} empty: dist and idx equal to the plain version and "
          f"to the replaced route (max abs err {err}); kernel {ms:.3f} ms (alone "
          f"{alone[nearest_lanes(grid.window_cap)]:.4f} ms at "
          f"{nearest_lanes(grid.window_cap)} lanes a query; 32 / 8 alone "
          + " / ".join(f"{alone[k]:.4f}" for k in (32, 8))
          + f" ms), replaced route {old_ms:.3f} ms ({old_launches} K7 launches, alone "
          f"{old_alone:.4f} ms in all), plain {plain_ms:.3f} ms, bound {b['bound_ms']:.4f} ms "
          f"({b['bound_by']})", flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None, **b)


def aggregate_rule(got, want, counts, counts_p, spfh, kp, label: str) -> tuple[float, float]:
    """K7's aggregation mode held to its twin: the counts equal, every row
    the twin leaves at the keypoint's own SPFH row (no neighbor) equal,
    every row within AGG_ROW_RTOL of max(1, its largest twin entry); returns
    (max abs err, largest relative err)."""
    import torch

    check(got.shape == want.shape and got.dtype == want.dtype,
          f"aggregation {label}: {tuple(got.shape)} {got.dtype}, twin {tuple(want.shape)}")
    check(torch.equal(counts, counts_p),
          f"aggregation {label}: {int((counts != counts_p).sum())} counts differ from the twin's")
    alone = (want == spfh[kp]).all(1)
    check(torch.equal(got[alone], want[alone]),
          f"aggregation {label}: a row with no neighbor differs from its own SPFH row")
    if not got.shape[0]:
        return 0.0, 0.0
    diff = (got - want).abs().amax(1)
    rel = float((diff / torch.clamp(want.abs().amax(1), min=1.0)).max())
    check(rel <= AGG_ROW_RTOL, f"aggregation {label}: a row off by {rel} of its largest entry")
    return float(diff.max()), rel


def _aggregate_work(grid, kp_rows, radius, dim: int):
    """What the aggregation of ``kp_rows`` must do on these inputs, from the
    twin's windows: bytes (the table's xyz of the union of the windows'
    rows and the SPFH rows of the union of the in-radius rows, each read
    once; the keypoints' rows, their runs' two cell-start reads, the
    output), operations (OPS_DIST_TEST a window slot, 2·D an in-radius
    neighbor with d > 0), the slots and neighbors; and the library's
    operand: the (Q, N) sparse matrix of weights 1/(d·count) and 1 at each
    keypoint's own row, so that one sparse product computes the function."""
    import torch

    from shot_fpfh_tpu_torch.ops.grid_hash import _zcolumn_runs, window_chunk
    from shot_fpfh_tpu_torch.ops.radius_runs import radius_dist_plain, window_slots

    table = grid.packed_sorted
    n, q, w = table.shape[0], kp_rows.shape[0], grid.window_cap
    in_window = torch.zeros(n, dtype=torch.bool, device=table.device)
    in_radius = torch.zeros_like(in_window)
    slots = neighbors = 0
    idx, vals = [], []
    step = window_chunk(grid, 4)
    for s in range(0, q, step):
        kp_c = kp_rows[s:s + step]
        qc = table[kp_c, :3]
        start, end = _zcolumn_runs(grid, qc)
        rows, valid = window_slots(start, end, w, n)
        _, d = radius_dist_plain(table, qc, start, end, w, radius)
        ok = torch.isfinite(d)
        m = ok & (d > 0)
        in_window[rows[valid]] = True
        in_radius[rows[ok]] = True
        slots += int(valid.sum())
        neighbors += int(m.sum())
        count = torch.clamp(ok.sum(1), min=1).to(torch.float32)
        qi, slot = torch.nonzero(m, as_tuple=True)
        idx.append(torch.stack([qi + s, rows[qi, slot]]))
        vals.append(1.0 / d[qi, slot] / count[qi])
        own = torch.arange(s, s + kp_c.shape[0], device=table.device)
        idx.append(torch.stack([own, kp_c]))
        vals.append(torch.ones(kp_c.shape[0], device=table.device))
    n_bytes = (int(in_window.sum()) * 12 + int(in_radius.sum()) * dim * 4 + q * dim * 4
               + q * 8 + q * (2 * grid.halo + 1) ** 2 * 16)
    weights = torch.sparse_coo_tensor(torch.cat(idx, 1), torch.cat(vals), (q, n),
                                      check_invariants=False).coalesce()
    return (n_bytes, slots * OPS_DIST_TEST + 2 * dim * neighbors, slots, neighbors,
            weights.to_sparse_csr())


def parity_aggregate(label: str, grid, spfh, kp_rows, radius: float, prefix: str = "phase 3",
                     reps: int = 10) -> dict:
    """K7's aggregation mode against its twin (``aggregate_rule``) with
    the keypoints launched in sorted-row order and in the caller's order;
    timed with the wrapper (the main path's order) and alone in both
    orders, beside the twin, the chunked route it replaced (K7 + gather +
    einsum; its K7 launches alone too) and one library call (a cuSPARSE
    product with the weights as a sparse matrix); bound by
    ``_aggregate_work``."""
    import torch

    from shot_fpfh_tpu_torch.ops import radius_runs as rr

    want, counts_p = rr.fpfh_aggregate_plain(grid, spfh, kp_rows, radius, return_counts=True)
    errs, alone = {}, {}
    for sort in (True, False):
        got, counts = rr._aggregate_launch(grid, spfh, kp_rows, radius, True, sort)
        torch.cuda.synchronize()
        errs[sort] = aggregate_rule(got, want, counts, counts_p, spfh, kp_rows,
                                    f"{label}, {'sorted' if sort else 'caller'} order")
        alone[sort] = kernel_ms(lambda: rr._aggregate_launch(grid, spfh, kp_rows, radius, False,
                                                             sort), AGG_KERNEL, reps)
    ms = cuda_ms(lambda: rr.fpfh_aggregate(grid, spfh, kp_rows, radius), reps)
    plain_ms = cuda_ms(lambda: rr.fpfh_aggregate_plain(grid, spfh, kp_rows, radius), reps)
    old_ms = cuda_ms(lambda: rr.fpfh_aggregate_chunked(grid, spfh, kp_rows, radius), reps)
    q, dim = kp_rows.shape[0], spfh.shape[1]
    old_launches = -(-q // max(1, rr._AGG_ELEMS // (grid.window_cap * dim)))
    old_alone = kernel_ms(lambda: rr.fpfh_aggregate_chunked(grid, spfh, kp_rows, radius),
                          K7_KERNEL, reps) * old_launches
    n_bytes, n_ops, slots, neighbors, weights = _aggregate_work(grid, kp_rows, radius, dim)
    lib_ms = cuda_ms(lambda: torch.sparse.mm(weights, spfh), reps)
    lib_err = _max_abs_diff(torch.sparse.mm(weights, spfh), want)
    del weights
    b = bound(n_bytes, n_ops)
    print(f"{prefix} K7 aggregation mode fpfh_aggregate ({label}): {q} keypoints, D {dim}, "
          f"window cap {grid.window_cap}, halo {grid.halo}, radius {radius}, "
          f"{slots / max(q, 1):.0f} window rows and {neighbors / max(q, 1):.1f} neighbors a "
          f"keypoint, {int((counts_p == 0).sum())} empty windows: counts and no-neighbor rows "
          f"equal to the twin, rows within {AGG_ROW_RTOL} (max abs err, largest relative err: "
          f"sorted order {errs[True][0]:.3e}, {errs[True][1]:.3e}; caller's order "
          f"{errs[False][0]:.3e}, {errs[False][1]:.3e}); kernel {ms:.3f} ms (alone "
          f"{alone[True]:.4f} ms in the wrapper's sorted order; the caller's order "
          f"{alone[False]:.4f}), plain {plain_ms:.3f} ms, replaced route {old_ms:.3f} ms "
          f"({old_launches} K7 launches, alone {old_alone:.4f} ms in all), library "
          f"(torch.sparse.mm, cuSPARSE) {lib_ms:.3f} ms (max abs err {lib_err:.2e}), bound "
          f"{b['bound_ms']:.4f} ms ({b['bound_by']}: {n_bytes / 1e6:.1f} MB, "
          f"{n_ops / 1e9:.3f} GFLOP)", flush=True)
    return dict(max_abs_err=max(e[0] for e in errs.values()), rel_err=max(
        e[1] for e in errs.values()), ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
        replaced_ms=old_ms, **b)


def parity_pair_aggregate(pair, dev) -> dict:
    """K7's aggregation mode at the smoke pair's FPFH shape: each cloud's
    density keypoints (voxel KEYPOINT_VOXEL, 5 neighbors) on its halo-2
    grid of cell FPFH_RADIUS/2 carrying k=30 normals, over the SPFH of
    every point (K8 + K4): the scan at D = 125 and 15 against the twin
    (``parity_aggregate``), then both clouds' D = 125 descriptors, kernel-
    and twin-fed, matched by K2 (bf16): the nearest refs agree on at least
    AGG_MATCH_AGREE of the rows.  Returns the scan's D = 125 record."""
    import torch

    from shot_fpfh_tpu_torch.keypoints import select_keypoints_with_density_threshold
    from shot_fpfh_tpu_torch.models.fpfh import _sorted_rows, _spfh_window_sorted
    from shot_fpfh_tpu_torch.models.normals import compute_normals
    from shot_fpfh_tpu_torch.ops.grid_hash import build_grid
    from shot_fpfh_tpu_torch.ops.match import top2_match
    from shot_fpfh_tpu_torch.ops.radius_runs import fpfh_aggregate, fpfh_aggregate_plain

    desc = {}
    for side, cloud in (("scan", pair.scan), ("ref", pair.ref)):
        pts = torch.tensor(cloud, device=dev)
        grid = build_grid(pts, FPFH_RADIUS / 2, extras=compute_normals(pts, pts, k=30,
                                                                        device=dev), halo=2)
        kp = torch.as_tensor(select_keypoints_with_density_threshold(pts, KEYPOINT_VOXEL, 5,
                                                                     device=dev), device=dev)
        kp_rows = _sorted_rows(grid, kp)
        spfh = _spfh_window_sorted(grid, FPFH_RADIUS, 5, False)
        desc[side] = (fpfh_aggregate(grid, spfh, kp_rows, FPFH_RADIUS),
                      fpfh_aggregate_plain(grid, spfh, kp_rows, FPFH_RADIUS))
        if side == "scan":
            res = parity_aggregate("the smoke scan's keypoints", grid, spfh, kp_rows,
                                   FPFH_RADIUS)
            parity_aggregate("the smoke scan's keypoints, decorrelated", grid,
                             _spfh_window_sorted(grid, FPFH_RADIUS, 5, True), kp_rows,
                             FPFH_RADIUS)
    valid = torch.ones(desc["ref"][0].shape[0], dtype=torch.bool, device=dev)
    got = top2_match(desc["scan"][0], desc["ref"][0], valid, True)[0]
    want = top2_match(desc["scan"][1], desc["ref"][1], valid, True)[0]
    agree = float((got == want).float().mean())
    check(agree >= AGG_MATCH_AGREE, f"aggregation: K2's matches of kernel-fed FPFH agree with "
          f"the twin-fed ones on {agree} of the rows")
    print(f"phase 3 K2 (bf16) on the smoke pair's FPFH descriptors ({got.shape[0]} x "
          f"{valid.shape[0]} x 125): the kernel-fed matches equal the twin-fed ones on {agree:.4f} "
          "of the rows", flush=True)
    return res


def _kernel_label(name: str) -> str:
    """A profiler kernel name without its return type, namespace prefix and
    template arguments."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    return re.split(r"[<(]", name, maxsplit=1)[0]


def icp_iteration_kernels(grid, scan_sub, ref, ref_n, init) -> None:
    """The CUDA kernels one point-to-plane ICP iteration launches on the
    ref's 1-NN grid (``icp_loop`` with ``max_iter`` 1, its state set up
    included), by name, from ``torch.profiler``: one IS, no 1-NN kernel and
    no K7 window."""
    from collections import Counter

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from shot_fpfh_tpu_torch.registration import icp

    def one():
        return icp.icp_loop(scan_sub, ref, ref_n, init, ICP_D_MAX, 1, 1e-3, grid=grid)

    one()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        one()
        torch.cuda.synchronize()
    names = Counter(_kernel_label(e.name) for e in prof.events()
                    if e.device_type == DeviceType.CUDA)
    check(names.get(IS_KERNEL, 0) == 1,
          f"one ICP iteration launched {names.get(IS_KERNEL, 0)} IS kernels: {dict(names)}")
    check(names.get(NN_KERNEL, 0) == 0 and names.get(K7_KERNEL, 0) == 0,
          f"one ICP iteration launched a 1-NN kernel or K7's window: {dict(names)}")
    print(f"phase 3 one ICP iteration (point-to-plane, {scan_sub.shape[0]} points, "
          f"icp_loop max_iter 1): {sum(names.values())} operations on the card: "
          + ", ".join(f"{k} {v}" for k, v in names.most_common()), flush=True)


def twin_icp(grid, scan_sub, ref, ref_n, init, d_max: float, iters: int,
             rms_threshold: float = 0.0):
    """ICP's plain twin on the card: ``registration/icp.py::_step`` (K7's
    1-NN mode and PyTorch operations) from ``init``, ``iters`` times or,
    with a threshold, until ``done`` (read after every iteration);
    ``(i, rotation, translation, rms, done)``."""
    import torch

    from shot_fpfh_tpu_torch.registration import icp

    dev = scan_sub.device
    state = (torch.zeros((), dtype=torch.int32, device=dev), init.rotation, init.translation,
             torch.full((), float("inf"), device=dev),
             torch.zeros((), dtype=torch.bool, device=dev))
    for _ in range(iters):
        state = icp._step(state, scan_sub, ref, ref_n, d_max, rms_threshold, grid, None, None)
        if rms_threshold > 0 and bool(state[4]):
            break
    return state


def rotation_gap(a, b) -> float:
    """The angle between two rotations from their difference, in float64:
    ``2·asin(‖a − b‖_F / 2√2)`` (a float32 trace would blur it to ~1e-4)."""
    import torch

    diff = float(torch.linalg.norm((a.double() - b.double()).cpu()))
    return 2.0 * float(np.arcsin(min(1.0, diff / (2.0 * np.sqrt(2.0)))))


def icp_rule(label: str, grid, scan_sub, ref, ref_n, init, d_max: float) -> tuple[float, float]:
    """IS's loop held to its twin's on the same inputs: after each of the
    first ICP_RULE_ITERS iterations the RMS within ICP_RMS_RTOL relative,
    after the last the rotation within ICP_ROT_TOL rad and the translation
    within ICP_T_TOL; returns the largest relative RMS gap and rotation
    gap."""
    from shot_fpfh_tpu_torch.registration import icp

    rms_gap = rot_gap = t_gap = 0.0
    for k in range(1, ICP_RULE_ITERS + 1):
        got = icp.icp_loop(scan_sub, ref, ref_n, init, d_max, k, 0.0, grid=grid)
        want = twin_icp(grid, scan_sub, ref, ref_n, init, d_max, k)
        check(int(got.n_iters) == int(want[0]) == k, f"IS ({label}): {int(got.n_iters)} "
              f"iterations, the twin {int(want[0])}, not {k}")
        rms_gap = max(rms_gap, abs(float(got.rms) - float(want[3])) / float(want[3]))
        rot_gap = rotation_gap(got.transform.rotation, want[1])
        t_gap = float((got.transform.translation - want[2]).abs().max())
    check(rms_gap <= ICP_RMS_RTOL and rot_gap <= ICP_ROT_TOL and t_gap <= ICP_T_TOL,
          f"IS ({label}) against its twin: RMS {rms_gap:.3e} relative, rotation {rot_gap:.3e} "
          f"rad, translation {t_gap:.3e}")
    return rms_gap, rot_gap


def parity_icp_step(label: str, grid, scan_sub, ref, ref_n, init, d_max: float,
                    prefix: str = "phase 3", reps: int = 10) -> dict:
    """IS at an ICP shape: held to its twin by :func:`icp_rule`; timed alone
    (the kernel, from the profiler) and in its loop (50 iterations, no
    threshold, ``done`` read once a block, over 50), beside the twin's
    iteration (``_step`` 50 times with no read, over 50) and the 1-NN
    kernel alone at the first iteration's queries; bound: K7's 1-NN mode's
    (the table's xyz, the cell-start table, ``orig_idx`` and the scan read
    once, a distance test for every row of the windows), the ref's points
    and normals read once and OPS_ICP_POINT operations a point."""
    from shot_fpfh_tpu_torch.ops.radius_runs import nearest
    from shot_fpfh_tpu_torch.registration import icp

    rms_gap, rot_gap = icp_rule(label, grid, scan_sub, ref, ref_n, init, d_max)
    n_iters = 50
    loop = lambda: icp.icp_loop(scan_sub, ref, ref_n, init, d_max, n_iters, 0.0, grid=grid)
    twin = lambda: twin_icp(grid, scan_sub, ref, ref_n, init, d_max, n_iters)
    ms = cuda_ms(loop, reps) / n_iters
    alone = kernel_ms(loop, IS_KERNEL, 1)
    plain_ms = cuda_ms(twin, reps) / n_iters
    moved = init.apply(scan_sub)
    nn_alone = kernel_ms(lambda: nearest(grid, moved), NN_KERNEL, reps)
    _, rows, _ = _runs_case(grid, moved)
    q, n = scan_sub.shape[0], grid.packed_sorted.shape[0]
    b = bound(n * 12 + grid.cell_starts.numel() * 8 + n * 8 + n * 24 + q * 12,
              rows * OPS_DIST_TEST + q * OPS_ICP_POINT)
    print(f"{prefix} IS icp_step ({label}): {q} points, window cap {grid.window_cap}, halo "
          f"{grid.halo}, {rows / q:.0f} rows a point: against its twin over "
          f"{ICP_RULE_ITERS} iterations RMS within {rms_gap:.3e} relative, rotation "
          f"{rot_gap:.3e} rad; an iteration in its loop {ms:.4f} ms (alone {alone:.4f} ms; "
          f"the 1-NN kernel alone at the same queries {nn_alone:.4f} ms), the twin's "
          f"iteration {plain_ms:.4f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']})",
          flush=True)
    return dict(max_abs_err=rot_gap, ms=ms, plain_ms=plain_ms, library_ms=None, **b)


def feature_queries(pair) -> np.ndarray:
    """Phase 10's FEATURE_QUERIES query points: every k-th point of the ref."""
    return pair.ref[::pair.ref.shape[0] // FEATURE_QUERIES][:FEATURE_QUERIES]


def parity_pair_paths(pair, dev) -> tuple[dict, dict, dict, dict]:
    """K7 at its two paths' shapes on the smoke pair: the iterative path's
    search (every ref point on the halo-2 grid of cell 0.15, radius 0.3) and
    the ICP's 1-NN (the scan subsampled at voxel 0.2, moved onto the ref,
    against the ref's grid of cell d_max, radius +inf); K7's 1-NN mode at
    the ICP's shape and on the iterative grid, IS at the ICP's shape (from
    the exact motion) and the kernels of one ICP iteration; and K8 at the
    PCA features' (phase 10's queries on the ref's halo-2 grid of cell
    0.15, three columns: no normals).  Returns K7's, K8's, the 1-NN mode's
    and IS's records (the latter two at the ICP's shape)."""
    import torch

    from shot_fpfh_tpu_torch.core.subsampling import grid_subsample
    from shot_fpfh_tpu_torch.core.transform import RigidTransform
    from shot_fpfh_tpu_torch.models.normals import compute_normals
    from shot_fpfh_tpu_torch.ops.grid_hash import build_grid

    ref = torch.tensor(pair.ref, device=dev)
    grid = build_grid(ref, ITERATIVE_RADIUS / 2, halo=2)
    k7 = parity_k7("iterative search", grid, ref, ITERATIVE_RADIUS)
    parity_nearest("every ref point on the iterative grid", grid, ref)
    scan = torch.tensor(pair.scan, device=dev)
    sub = scan[torch.as_tensor(grid_subsample(scan, ICP_VOXEL), device=dev)]
    rot = torch.tensor(pair.rot, dtype=torch.float32, device=dev)
    trans = torch.tensor(pair.trans, dtype=torch.float32, device=dev)
    moved = (sub - trans) @ rot
    icp_grid = build_grid(ref, ICP_D_MAX)
    parity_k7("ICP 1-NN", icp_grid, moved, float("inf"))
    nn = parity_nearest("ICP", icp_grid, moved)
    ref_n = compute_normals(ref, ref, k=30, device=dev)
    exact = RigidTransform(rot.T.contiguous(), -(trans @ rot))
    is_rec = parity_icp_step("ICP", icp_grid, sub, ref, ref_n, exact, ICP_D_MAX)
    icp_iteration_kernels(icp_grid, sub, ref, ref_n, exact)
    k8 = parity_k8("the PCA features", build_grid(ref, FEATURE_RADIUS / 2, halo=2),
                   torch.tensor(feature_queries(pair), device=dev))
    return k7, k8, nn, is_rec


class _LogLines(logging.Handler):
    """Collects the messages of one logger while attached."""

    def __init__(self, name: str):
        super().__init__()
        self.logger, self.lines = logging.getLogger(name), []

    def emit(self, record):
        self.lines.append(record.getMessage())

    def __enter__(self):
        self.logger.addHandler(self)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self)


# a kernel as the profiler names a file-local one (a template's arguments
# kept, so two instances of one template are two entries), and the kernels
# that csrc/ defines
_LOCAL_KERNEL = re.compile(r"^(?:void )?\(anonymous namespace\)::(\w+)(<[^>(]*>)?")
_DEFINED_KERNEL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(")


def _port_kernels() -> set[str]:
    return {name for src in (ROOT / "shot_fpfh_tpu_torch" / "csrc").glob("*.cu")
            for name in _DEFINED_KERNEL.findall(src.read_text())}


def _profiled(fn, out_dir: Path):
    """Run ``fn`` under ``torch.profiler``; write the op table and a chrome
    trace to ``out_dir``; return (result, profiled wall seconds, device-busy
    seconds: the summed time of the kernels and copies run on the card,
    {port kernel: (launches, device ms)}).  The stage timers' annotations
    appear on the card's timeline too, as ranges over those kernels: they
    are not counted."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out_dir.mkdir(parents=True, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    (out_dir / "main_path_ops.txt").write_text(
        prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=120))
    prof.export_chrome_trace(str(out_dir / "main_path_trace.json"))
    on_card = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    ours = _port_kernels()
    kernels: dict[str, tuple[int, float]] = {}
    for e in on_card:
        match = _LOCAL_KERNEL.match(e.name)
        if match and match.group(1) in ours:
            name = match.group(1) + (match.group(2) or "")
            n, ms = kernels.get(name, (0, 0.0))
            kernels[name] = (n + 1, ms + e.time_range.elapsed_us() / 1e3)
    busy_us = sum(e.time_range.elapsed_us() for e in on_card)
    return result, wall, busy_us / 1e6, kernels


def moved_scan(path: Path) -> np.ndarray:
    """The scan's points of an aligned ``.ply`` the CLI wrote."""
    from shot_fpfh_tpu_torch.io.ply import read_ply

    data = read_ply(str(path))
    is_scan = data["is_scan"] > 0
    return np.stack([data[c][is_scan] for c in "xyz"], axis=1)


class SmokePair:
    """The 100k-point terrain pair (scan = known rigid motion of ref +
    noise) on disk, and the CLI runs over it."""

    def __init__(self):
        shutil.rmtree(WORK, ignore_errors=True)
        WORK.mkdir(parents=True)
        rng = np.random.default_rng(72)
        ref = make_terrain(100_000, rng, scale=10, n_bumps=40)
        rot = rotation_about([0.3, -0.2, 1.0], np.deg2rad(15.0))
        trans = np.array([0.4, -0.25, 0.15])
        scan = (ref @ rot.T + trans + rng.normal(scale=0.005, size=ref.shape)).astype(np.float32)
        self._write(WORK, ref, scan, rot, trans, KEYPOINT_VOXEL, 0.9)

    def _write(self, work: Path, ref, scan, rot, trans, voxel: float, radius: float) -> None:
        """Write the pair (scan = ref @ rot.T + trans, plus noise) to
        ``work`` and set up the CLI's arguments over it."""
        from shot_fpfh_tpu_torch.io.ply import write_ply

        self.ref, self.scan, self.rot, self.trans = ref, scan, rot, trans
        write_ply(str(work / "scan.ply"), [scan], ["x", "y", "z"])
        write_ply(str(work / "ref.ply"), [ref], ["x", "y", "z"])
        self.metrics, self.out = work / "metrics.json", work / "out"
        self.argv = [
            "--scan_file_path", str(work / "scan.ply"), "--ref_file_path", str(work / "ref.ply"),
            "--conf_file_path", "", "--output_dir", str(self.out),
            "--metrics_json", str(self.metrics), "--device", "cuda",
            # config/default.yaml leaves these null (unusable) or sized for
            # the bunny: keypoint voxel + density threshold, descriptor radius
            "--neighborhood_size", str(voxel), "--min_n_neighbors", "5",
            "--radius", str(radius)]

    def errors(self, out: Path | None = None) -> tuple[float, float]:
        """(rotation, translation) error of the post-ICP alignment written
        to ``out`` (default: the pair's output directory) against the
        ground truth (scan -> ref: the inverse motion)."""
        import torch

        from shot_fpfh_tpu_torch.core.solvers import solve_point_to_point
        from shot_fpfh_tpu_torch.core.transform import rotation_angle

        moved = moved_scan((out or self.out) / "scan_on_ref_post_icp.ply")
        got = solve_point_to_point(torch.tensor(self.scan, dtype=torch.float64),
                                   torch.tensor(moved, dtype=torch.float64))
        rot_err = float(rotation_angle(got.rotation, torch.tensor(self.rot.T)))
        t_err = float(np.linalg.norm(got.translation.numpy() - (-self.rot.T @ self.trans)))
        return rot_err, t_err

    def run(self, label: str, extra: list[str], must: tuple[str, ...],
            must_not: tuple[str, ...] = (), cold: bool = True,
            cold_extra: tuple[str, ...] = (), must_accept: bool = True) -> dict:
        """One measured ``cli.main`` run (after a cold one, with
        ``cold_extra`` arguments too, when ``cold``) with the launch counts
        set to 0 just before it and read just after; fails unless the
        alignment lies within the bounds of the ground truth, every kernel
        of ``must`` (and none of ``must_not``) was launched and, when
        ``must_accept``, the evaluation accepted it (its exit code and line
        are recorded either way)."""
        import torch

        from shot_fpfh_tpu_torch import _kernels, cli

        argv = self.argv + extra
        cold_wall = None
        if cold:
            # a first, cold run pays one-time library set-up (cuSOLVER
            # handles for RANSAC's SVDs and ICP's solves, allocator growth)
            t0 = time.perf_counter()
            check(cli.main(argv + list(cold_extra)) == 0 or not must_accept,
                  f"{label} (cold run): registration rejected")
            torch.cuda.synchronize()
            cold_wall = time.perf_counter() - t0
        # the CLI's stage timer lines (utils.perf.checkpoint)
        with (_LogLines("shot_fpfh_tpu_torch.utils.perf") as stage_log,
              _LogLines("shot_fpfh_tpu_torch.cli") as cli_log):
            torch.cuda.reset_peak_memory_stats()
            _kernels.reset_launch_counts()
            t0 = time.perf_counter()
            rc = cli.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(_kernels.launch_counts)
            peak = torch.cuda.max_memory_allocated()
        check(rc == 0 or not must_accept, f"{label}: registration rejected (exit code {rc})")
        for name in must:
            check(launches[name] > 0, f"{label} never launched kernel {name}")
        for name in must_not:
            check(launches[name] == 0, f"{label} launched kernel {name}")
        rot_err, t_err = self.errors()
        check(rot_err < MAIN_ROT_TOL and t_err < MAIN_T_TOL,
              f"{label}: rotation error {rot_err}, translation error {t_err}")
        return dict(launches=launches, rot_err=rot_err, t_err=t_err, wall=wall,
                    cold_wall=cold_wall, points=self.ref.shape[0], peak=peak, rc=rc,
                    evaluation=next(ln for ln in cli_log.lines if ln.startswith("Overlap")),
                    stages=json.loads(self.metrics.read_text())["stages"],
                    timers=[ln for ln in stage_log.lines if ln.endswith(" seconds")])


def _peak_memory(peak: int) -> str:
    import torch

    total = torch.cuda.get_device_properties(0).total_memory
    return f"peak device memory {peak / 2**30:.2f} GiB of {total / 2**30:.2f} GiB"


def _describe(phase: str, r: dict) -> str:
    cold = "" if r["cold_wall"] is None else f" (cold run {r['cold_wall']:.3f} s)"
    verdict = "accepted" if r["rc"] == 0 else f"rejected by the evaluation (exit code {r['rc']})"
    return (f"{phase}: {r['points']}-point pair {verdict}, rotation error {r['rot_err']:.2e} "
            f"rad, translation error {r['t_err']:.2e}, wall {r['wall']:.3f} s{cold}, "
            f"{_peak_memory(r['peak'])}, launches {r['launches']}, stages "
            + ", ".join(f"{s['stage']} {s['seconds']:.3f} s" for s in r["stages"])
            + f"; CLI timers: {r['timers']}; evaluation: {r['evaluation']}")


def phase_shot_path(pair: SmokePair, profile_dir: Path | None = None) -> dict:
    """Phase 4: the SHOT path, measured (and profiled with ``profile_dir``);
    returns the measured run's record."""
    from shot_fpfh_tpu_torch import cli

    r = pair.run("SHOT path", [], SHOT_PATH, (K7, *SHOT_WINDOW_NOT))
    check(r["launches"][IS] == SHOT_IS_LAUNCHES and r["launches"][NN] == SHOT_NN_LAUNCHES,
          f"SHOT path: {r['launches'][IS]} IS and {r['launches'][NN]} 1-NN launches, not "
          f"{SHOT_IS_LAUNCHES} (one an ICP iteration) and {SHOT_NN_LAUNCHES} (the "
          "evaluation)")
    profiled = ""
    if profile_dir is not None:
        # a third run under the profiler, so its overhead stays out of the
        # measured run above
        rc, prof_wall, busy, kernels = _profiled(lambda: cli.main(pair.argv), profile_dir)
        check(rc == 0, f"SHOT path (profiled run): registration rejected (exit code {rc})")
        profiled = (f"; profiled run {prof_wall:.3f} s, device busy {busy:.3f} s "
                    f"(idle share {1.0 - busy / prof_wall:.3f}); the port's kernels on the "
                    "card (launches, device ms): "
                    + ", ".join(f"{k} ({n}, {ms:.4f})" for k, (n, ms) in sorted(kernels.items())))
    print(_describe("phase 4 SHOT path", r) + profiled, flush=True)
    return r


def agg_launches(label: str, launches: dict, expected: int = FPFH_AGG_LAUNCHES) -> None:
    """An FPFH run's aggregation: ``expected`` kernel launches (one a
    cloud), no K7 window."""
    check(launches[AGG] == expected and launches[K7] == 0,
          f"{label}: {launches[AGG]} aggregation launches (not {expected}), {launches[K7]} K7")


def spfh_pass_launches(label: str, launches: dict, expected: int = FPFH_AGG_LAUNCHES) -> None:
    """FPFH's SPFH pass on the window route: one kernel launch a cloud, no
    K8 window and no K4."""
    check(launches[SPFH_PASS] == expected and launches[WINDOW] == 0
          and launches["spfh_histogram"] == 0,
          f"{label}: {launches[SPFH_PASS]} SPFH pass launches (not {expected}), "
          f"{launches[WINDOW]} K8, {launches['spfh_histogram']} K4")


def phase_fpfh_path(pair: SmokePair) -> tuple[dict, dict]:
    fpfh = ["--descriptor_choice", "fpfh", "--radius", str(FPFH_RADIUS)]
    window = pair.run("FPFH window route", fpfh, FPFH_WINDOW_PATH, FPFH_WINDOW_NOT)
    agg_launches("FPFH window route", window["launches"])
    spfh_pass_launches("FPFH window route", window["launches"])
    print(_describe("phase 5 FPFH window route", window), flush=True)
    with run_kernels_in_place():
        runs = pair.run("FPFH run route", fpfh, FPFH_RUN_PATH, ("spfh_histogram", SPFH_PASS, K7),
                        cold=False)
    agg_launches("FPFH run route", runs["launches"])
    print(_describe("phase 5 FPFH run route", runs), flush=True)
    # the same run with the aggregation's twin on the card in the kernel's
    # place: accepted at the same errors
    from shot_fpfh_tpu_torch.models import fpfh as m_fpfh
    from shot_fpfh_tpu_torch.ops.radius_runs import fpfh_aggregate_plain

    kernel_fed = m_fpfh._fpfh_window_aggregate
    m_fpfh._fpfh_window_aggregate = fpfh_aggregate_plain
    try:
        twin = pair.run("FPFH window route, twin-fed aggregation", fpfh,
                        ("top2_match", SPFH_PASS), (AGG, K7), cold=False)
    finally:
        m_fpfh._fpfh_window_aggregate = kernel_fed
    gap = abs(twin["rot_err"] - window["rot_err"])
    check(gap <= 1e-5, f"FPFH window route: rotation error {window['rot_err']} with the kernel, "
          f"{twin['rot_err']} with the twin")
    print(f"phase 5 FPFH window route, twin-fed aggregation (the twin on the card in the "
          f"kernel's place): accepted, rotation error {twin['rot_err']:.2e} rad ({gap:.1e} from the kernel-fed "
          f"run), translation error {twin['t_err']:.2e}, wall {twin['wall']:.3f} s, stages "
          + ", ".join(f"{st['stage']} {st['seconds']:.3f} s" for st in twin["stages"]),
          flush=True)
    return window["launches"], runs["launches"]


def phase_multiscale_paths(pair: SmokePair) -> dict:
    """Phases 6–8: bi-scale SHOT on both routes, multiscale SHOT (704
    columns) on the window route, single-scale SHOT on the run route."""
    from shot_fpfh_tpu_torch.core.subsampling import grid_subsample
    from shot_fpfh_tpu_torch.ops import grid_hash

    bi = ["--descriptor_choice", "shot_bi_scale", "--phi", str(PHI)]
    ms = ["--descriptor_choice", "shot_multiscale", "--phi", str(PHI),
          "--n_scales", str(N_SCALES)]
    launches = {}
    r = pair.run("bi-scale window route", bi, SHOT_PATH, ("shot_runs", *SHOT_WINDOW_NOT))
    print(_describe("phase 6 bi-scale SHOT, window route", r), flush=True)
    launches["bi-scale window"] = r["launches"]
    with run_kernels_in_place():
        r = pair.run("bi-scale run route", bi, SHOT_RUN_PATH, ("shot_binning_histogram", SG))
        print(_describe("phase 6 bi-scale SHOT, run route", r), flush=True)
        launches["bi-scale runs"] = r["launches"]
        r = pair.run("single-scale run route", [], SHOT_RUN_PATH,
                     ("shot_binning_histogram", SG))
        print(_describe("phase 8 single-scale SHOT, run route", r), flush=True)
        launches["single-scale runs"] = r["launches"]

    # the cold run saves its state: the descriptors K2 matched are 704 wide
    state = WORK / "multiscale_state.npz"
    r = pair.run("multiscale window route", ms, MULTISCALE_PATH, ("shot_runs", *SHOT_WINDOW_NOT),
                 cold_extra=("--state_cache", str(state)))
    widths = {k: np.load(state)[k].shape[1] for k in ("scan_descriptors", "ref_descriptors")}
    check(set(widths.values()) == {352 * N_SCALES}, f"multiscale descriptor widths {widths}")
    scale2 = [len(grid_subsample(cloud, 0.9 * PHI / 10, device="cuda"))
              for cloud in (pair.scan, pair.ref)]
    routes = ("scale 2's supports (voxel 2.7/10) hold "
              f"{scale2} points: " + ("brute route (k_max-capped, no kernel); phase 3 alone "
                                      "holds K1's and K5's given-frames modes"
                                      if max(scale2) < grid_hash.AUTO_GRID_MIN_POINTS
                                      else "grid route with the first scale's frames"))
    print(_describe("phase 7 multiscale SHOT, window route", r)
          + f"; descriptor widths {widths}; {routes}", flush=True)
    launches["multiscale window"] = r["launches"]
    return launches


def phase_iterative_path(pair: SmokePair) -> dict:
    """Phase 9: greedy-coverage keypoints at ITERATIVE_RADIUS, single-scale
    SHOT; the cold run's saved keypoints equal the port's CPU keypoints."""
    from shot_fpfh_tpu_torch.keypoints import select_keypoints_iteratively

    state = WORK / "iterative_state.npz"
    args = ["--selection_algorithm", "iterative", "--neighborhood_size", str(ITERATIVE_RADIUS)]
    with _LogLines("shot_fpfh_tpu_torch.keypoints") as log:
        r = pair.run("iterative keypoints", args, ITERATIVE_PATH,
                     cold_extra=("--state_cache", str(state)))
    rounds = sorted({ln for ln in log.lines if " rounds " in ln})
    check(bool(rounds) and all("(neighbor cap 128)" in ln for ln in rounds),
          f"iterative keypoints: a radius ball reached the neighbor cap: {rounds}")
    saved = np.load(state)
    counts = {}
    for side, cloud in (("scan", pair.scan), ("ref", pair.ref)):
        on_cpu = select_keypoints_iteratively(cloud, ITERATIVE_RADIUS, device="cpu")
        check(np.array_equal(saved[f"{side}_keypoints"], on_cpu),
              f"iterative keypoints: the card's {side} keypoints differ from the CPU's")
        counts[side] = len(on_cpu)
    print(_describe("phase 9 iterative keypoints", r)
          + f"; keypoints {counts}, equal to the CPU's on both clouds; {rounds}", flush=True)
    return r["launches"]


def _features(cloud, queries, device: str) -> dict:
    """Phase 10's five calls on ``device``."""
    import torch

    from shot_fpfh_tpu_torch.models import normals as nm

    args = (queries, cloud, FEATURE_RADIUS)
    w, _, moments, sizes = nm.local_pca_with_moments(*args, device=device)
    return dict(normals=nm.compute_normals(queries, cloud, radius=FEATURE_RADIUS, device=device),
                sphericity=nm.compute_sphericity(*args, device=device),
                basic=torch.stack(nm.compute_pca_based_basic_features(*args, device=device), 1),
                eigenvalues=w, moments=moments, sizes=sizes,
                features=nm.compute_pca_based_features(*args, device=device))


def phase_features(pair: SmokePair, dev) -> dict:
    """Phase 10: the PCA features of FEATURE_QUERIES ref points on the card
    (K3 for radius normals, sphericity and the basic features; K8 for the
    moments and the 21 columns) against the port's plain CPU run."""
    import torch

    from shot_fpfh_tpu_torch import _kernels

    queries = feature_queries(pair)
    _features(pair.ref, queries, dev)                          # warm-up
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    card = _features(pair.ref, queries, dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_kernels.launch_counts)
    for name in ("radius_pca", WINDOW):
        check(launches[name] > 0, f"PCA features never launched kernel {name}")
    t0 = time.perf_counter()
    cpu = _features(pair.ref, queries, "cpu")
    cpu_wall = time.perf_counter() - t0
    card = {k: v.cpu() for k, v in card.items()}
    for name, value in card.items():
        check(bool(torch.isfinite(value.float()).all()), f"PCA features: {name} not finite")
    check(torch.equal(card["sizes"], cpu["sizes"]), "PCA features: neighborhood sizes differ")
    # per column: the basic features' four, the 21 features'
    cols = {k: (card[k] - cpu[k]).abs().amax(0) for k in ("basic", "features")}
    angles = {"basic": BASIC_ANGLE_COLS, "features": FEATURE_ANGLE_COLS}
    errs = {k: float((card[k] - cpu[k]).abs().max())
            for k in ("eigenvalues", "moments", "sphericity")}
    for k, per_col in cols.items():
        is_angle = torch.zeros(per_col.shape[0], dtype=torch.bool)
        is_angle[list(angles[k])] = True
        errs[f"{k} angles"] = float(per_col[is_angle].max())
        errs[f"{k} other"] = float(per_col[~is_angle].max())
    over = {k: e for k, e in errs.items()
            if e > (FEATURE_ANGLE_ATOL if k.endswith("angles") else FEATURE_ATOL)}
    check(not over, f"PCA features: errors over the limits {over}; per column "
                    f"{ {k: v.tolist() for k, v in cols.items()} }")
    dots = (card["normals"] * cpu["normals"]).sum(1).abs()
    aligned = float((dots > 0.999).float().mean())
    check(aligned >= 0.999, f"PCA features: only {aligned} of the normals agree")
    print(f"phase 10 PCA features: {FEATURE_QUERIES} of {pair.ref.shape[0]} points, radius "
          f"{FEATURE_RADIUS}: sizes exact (mean {float(cpu['sizes'].float().mean()):.1f}, max "
          f"{int(cpu['sizes'].max())}), max errors vs the CPU {errs} (limits {FEATURE_ATOL}, "
          f"angles {FEATURE_ANGLE_ATOL}); per column {({k: v.tolist() for k, v in cols.items()})}"
          f", normals |n.n'| > 0.999 for {aligned:.5f}; card {wall:.3f} s (the five calls), "
          f"CPU {cpu_wall:.3f} s; launches {launches}", flush=True)
    return launches


def phase_options(pair: SmokePair) -> dict:
    """Phase 11: the smoke pair with ``--matching_algorithm threshold``
    (K2's nearest descriptors both ways, the reciprocal and threshold
    filters) and with ``--selection_algorithm random`` (half of each
    cloud's points, drawn from seeded CPU generators), one measured run
    each; then ``match_descriptors`` with the reciprocal filter (which no
    CLI flag reaches) and each distance filter on phase 9's saved
    descriptors, on the card (K2 both ways) and on the CPU: the two match
    sets agree as K2's bf16 indices do (K2_MIN_AGREE, of their union)."""
    from shot_fpfh_tpu_torch import _kernels
    from shot_fpfh_tpu_torch.registration.matching import (
        left_median_filter,
        match_descriptors,
        quantile_filter,
        threshold_filter,
    )

    launches = {}
    for label, extra in (("threshold matching", ["--matching_algorithm", "threshold"]),
                         ("random keypoints", ["--selection_algorithm", "random"])):
        r = pair.run(label, extra, SHOT_PATH, cold=False)
        print(_describe(f"phase 11 {label}", r), flush=True)
        launches[label] = r["launches"]

    saved = np.load(WORK / "iterative_state.npz")
    desc = (saved["scan_descriptors"], saved["ref_descriptors"])
    filters = {"threshold": (threshold_filter, dict(threshold_multiplier=10)),
               "quantile": (quantile_filter, dict(quantiles=(0.1, 0.9))),
               "left median": (left_median_filter, {})}
    kept = {}
    for name, (fn, kw) in filters.items():
        _kernels.reset_launch_counts()
        card = match_descriptors(*desc, fn, filter_nonreciprocal=True, device="cuda", **kw)
        k2 = _kernels.launch_counts["top2_match"]
        check(k2 == 2, f"reciprocal {name} matching launched K2 {k2} times, not 2")
        cpu = match_descriptors(*desc, fn, filter_nonreciprocal=True, device="cpu", **kw)
        on_card, on_cpu = set(zip(*card)), set(zip(*cpu))
        agree = len(on_card & on_cpu) / max(len(on_card | on_cpu), 1)
        check(bool(on_card) and agree >= K2_MIN_AGREE[True],
              f"reciprocal {name} matching: {len(on_card)} matches, {agree} agree with the CPU")
        kept[name] = (len(on_card), len(on_cpu), round(agree, 4))
    print(f"phase 11 reciprocal matching on {len(desc[0])} x {len(desc[1])} descriptors "
          f"(card matches, CPU matches, agreement): {kept}; K2 launched twice each", flush=True)
    return launches


# the legs of registration.fused.fused_registration, by the module
# attribute each is ("between legs": the call's own work outside them)
_FUSED_LEGS = {"descriptors": "_cloud_descriptors", "matching": "_ratio_match",
               "RANSAC": "_ransac", "ICP": "icp_loop", "between legs": "fused_registration"}


class _FusedLegs:
    """While entered, each leg of ``registration.fused`` is wrapped: its
    outputs are kept by leg (``outputs``), the last ``fused_registration``
    call's arguments too (``inputs``), and with ``syncs`` the host syncs
    each leg makes under ``torch.cuda.set_sync_debug_mode("warn")`` are
    counted by source line (``sync_counts()``)."""

    def __init__(self, syncs: bool = False):
        from collections import Counter

        self.syncs = syncs
        self.sites = {leg: Counter() for leg in _FUSED_LEGS}
        self.outputs = {leg: [] for leg in _FUSED_LEGS}
        self.inputs = None

    def __enter__(self):
        from shot_fpfh_tpu_torch.registration import fused

        self.saved = {attr: getattr(fused, attr) for attr in _FUSED_LEGS.values()}
        for leg, attr in _FUSED_LEGS.items():
            setattr(fused, attr, self._wrapped(leg, self.saved[attr]))
        return self

    def __exit__(self, *exc):
        from shot_fpfh_tpu_torch.registration import fused

        for attr, fn in self.saved.items():
            setattr(fused, attr, fn)

    def _wrapped(self, leg, fn):
        import warnings

        import torch

        def run(*args, **kwargs):
            if leg == "between legs":
                self.inputs = (args, kwargs)
            if not self.syncs:
                out = fn(*args, **kwargs)
            else:
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    before = torch.cuda.get_sync_debug_mode()
                    torch.cuda.set_sync_debug_mode("warn")
                    try:
                        out = fn(*args, **kwargs)
                    finally:
                        torch.cuda.set_sync_debug_mode(before)
                        self.sites[leg].update(f"{Path(w.filename).name}:{w.lineno}"
                                               for w in caught
                                               if "called a synchronizing" in str(w.message))
            self.outputs[leg].append(out)
            return out
        return run

    def sync_counts(self) -> dict:
        return {leg: dict(c) for leg, c in self.sites.items()}


def _leg_syncs(pair: SmokePair, argv_extra: list[str]) -> tuple[dict, tuple]:
    """One more ``cli.main`` run with each leg of ``fused_registration``
    wrapped: the host syncs it makes by leg, each as {source line: count},
    and the arguments ``register_pair`` gave ``fused_registration``."""
    from shot_fpfh_tpu_torch import cli

    with _FusedLegs(syncs=True) as legs:
        check(cli.main(pair.argv + argv_extra) == 0, "fused run with sync counting: rejected")
    return legs.sync_counts(), legs.inputs


def phase_fused_paths(pair: SmokePair) -> tuple[dict, dict]:
    """Phase 12: the fused program (``--fused``) for single-scale SHOT on
    the window route and on the run route and for FPFH, each beside the
    staged path on the same keypoints; the fused run launches K2 once.
    Returns each run's launches, and each case's run route and the
    arguments its ``fused_registration`` call was given (phase 15)."""
    fpfh = ["--descriptor_choice", "fpfh", "--radius", str(FPFH_RADIUS)]
    cases = (("SHOT, window route", [], False, SHOT_PATH, ("shot_runs", *SHOT_WINDOW_NOT)),
             ("SHOT, run route", [], True, SHOT_RUN_PATH, ("shot_binning_histogram", SG)),
             ("FPFH", fpfh, False, FPFH_WINDOW_PATH, FPFH_WINDOW_NOT))
    launches, inputs = {}, {}
    for label, extra, run_route, must, must_not in cases:
        with run_kernels_in_place(run_route):
            staged = pair.run(f"staged {label}, subsampling keypoints", FUSED_FLAGS + extra,
                              must, must_not, cold=False)
            r = pair.run(f"fused {label}", FUSED_FLAGS + extra + ["--fused"], must, must_not)
            syncs, inputs[label] = _leg_syncs(pair, FUSED_FLAGS + extra + ["--fused"])
        check(r["launches"]["top2_match"] == 1,
              f"fused {label}: K2 launched {r['launches']['top2_match']} times, not once")
        if AGG in must:
            agg_launches(f"fused {label}", r["launches"])
            agg_launches(f"staged {label}", staged["launches"])
        stages = [st["stage"] for st in r["stages"]]
        check(stages == ["normals[knn]", "normals[knn]", "fused"],
              f"fused {label}: stages {stages}")
        print(_describe(f"phase 12 fused {label}", r)
              + f"; staged on the same keypoints: wall {staged['wall']:.3f} s, stages "
              + ", ".join(f"{st['stage']} {st['seconds']:.3f} s" for st in staged["stages"])
              + f"; host syncs of one fused_registration call by leg: {syncs}", flush=True)
        launches[f"fused {label}"] = r["launches"]
        inputs[label] = (run_route, must, inputs[label])
    return launches, inputs


def phase_multiscale_top1(dev) -> str:
    """Phase 13a: ``multiscale_top1`` on phase 7's saved multiscale
    descriptors (two 352-column scales) on the card against the CPU, in
    both reciprocal modes, timed beside its bound; then one
    ``match_descriptors`` on the stacks with ``threshold_filter``."""
    import torch

    from shot_fpfh_tpu_torch import _kernels
    from shot_fpfh_tpu_torch.registration import matching as m
    from shot_fpfh_tpu_torch.registration.matching import (
        match_descriptors,
        multiscale_top1,
        threshold_filter,
    )

    saved = np.load(WORK / "multiscale_state.npz")
    scan_ms, ref_ms = (torch.tensor(saved[k].reshape(len(saved[k]), N_SCALES, 352)
                                    .transpose(1, 0, 2).copy())
                       for k in ("scan_descriptors", "ref_descriptors"))
    s, q, d = scan_ms.shape
    r = ref_ms.shape[1]
    scan_d, ref_d = scan_ms.to(dev), ref_ms.to(dev)
    parts, near = [], {}
    for recip in (False, True):
        _kernels.reset_launch_counts()
        idx, dist = (t.cpu() for t in multiscale_top1(scan_d, ref_d, filter_nonreciprocal=recip))
        launched = {k: n for k, n in _kernels.launch_counts.items() if n}
        check(not launched, f"multiscale_top1 launched kernels {launched}")
        # the CPU's result (multiscale_top1's own two steps) with each row's
        # second-best combined distance; a near tie at one scale can make a
        # row reciprocal on one device only: such rows count as near-tied
        row_ok, r_ok = m._ms_row_mask(scan_ms, ref_ms, recip)
        idx_c, dist_c, second = m._ms_combined_top1(scan_ms, ref_ms, row_ok, r_ok, second=True)
        same = (m._ms_row_mask(scan_d, ref_d, recip)[0].cpu() == row_ok).all(0)
        gap = torch.where(dist_c < m.MS_MAX_VAL, second - dist_c, float("inf"))
        clear = same & (gap > MS_TIE_GAP)
        near[recip] = ~clear
        n_near, n_other = int((~clear).sum()), int((idx != idx_c).sum())
        check(torch.equal(idx[clear], idx_c[clear]),
              f"multiscale_top1 (reciprocal {recip}): {int((idx != idx_c)[clear].sum())} "
              "indices differ from the CPU's on rows without a near tie")
        # the card's match against the CPU's best combined distance
        worst = float((dist - dist_c)[same].max())
        check(worst <= MS_TIE_GAP,
              f"multiscale_top1 (reciprocal {recip}): a card match is {worst} over the CPU's "
              "best combined distance")
        check(n_near <= MS_NEAR_TIE_FRAC * q,
              f"multiscale_top1 (reciprocal {recip}): {n_near} near-tied rows of {q} "
              f"({int((~same).sum())} reciprocal on one device only)")
        err = float((dist - dist_c)[same].abs().max())
        check(err <= MS_DIST_ATOL, f"multiscale_top1 (reciprocal {recip}): distances off by {err}")
        ms = cuda_ms(lambda: multiscale_top1(scan_d, ref_d, filter_nonreciprocal=recip))
        # the row pass of each scale, and in the reciprocal mode the
        # reciprocal pass of each scale before it
        flops = 2 * s * q * r * d * (2 if recip else 1)
        b = bound(4 * s * (q + r) * d + 12 * q, flops)
        parts.append(f"reciprocal {recip}: {ms:.3f} ms (bound {b['bound_ms']:.4f} ms, "
                     f"{b['bound_by']}), indices equal to the CPU's on {int(clear.sum())} rows, "
                     f"{n_near} near-tied rows (gap <= {MS_TIE_GAP}; {int((~same).sum())} "
                     f"reciprocal on one device only) of {q}, {n_other} matched another ref, "
                     f"each within {worst:.2e} of the CPU's best, max |dist - CPU| "
                     f"{err:.2e}, {int((dist < 1000.0).sum())} rows matched")
    card = match_descriptors(scan_d, ref_d, threshold_filter, threshold_multiplier=10,
                             verbose=False)
    cpu = match_descriptors(scan_ms, ref_ms, threshold_filter, threshold_multiplier=10,
                            verbose=False, device="cpu")
    on_card, on_cpu = set(zip(*card)), set(zip(*cpu))
    agree = len(on_card & on_cpu) / max(len(on_card | on_cpu), 1)
    # the two match sets may part only on the rows near-tied without the
    # reciprocal filter (match_descriptors' mode here)
    parted = {int(row) for row, _ in on_card ^ on_cpu}
    off_tie = sorted(row for row in parted if not near[False][row])
    check(bool(on_card) and not off_tie,
          f"multiscale match_descriptors: {len(on_card)} matches, {agree} agree with the CPU; "
          f"rows {off_tie[:10]} part without a near tie")
    return (f"phase 13 multiscale_top1: {s} scales x {q} x {r} x {d} (phase 7's descriptors); "
            + "; ".join(parts) + f"; match_descriptors with threshold_filter (x10): "
            f"{len(on_card)} matches on the card, {len(on_cpu)} on the CPU, {agree:.4f} agree")


def phase_debug_paths(pair: SmokePair, shot: dict) -> dict:
    """Phase 13b: the SHOT path with ``--debug_shot`` (K1 counts the checks
    in the kernel, every accumulation's counter read, 0 violations) and
    with ``--debug_nans`` (every op and every kernel's operands and outputs
    checked; no NaN), each beside phase 4's wall."""
    from shot_fpfh_tpu_torch import _kernels
    from shot_fpfh_tpu_torch.models import shot as shot_model

    reads, checked_kernels = [0], {}
    saved_read, saved_kernel = shot_model._debug_read, _kernels.check_kernel

    def count_read(counter):
        reads[0] += counter is not None
        return saved_read(counter)

    def count_kernel(name, tensors):
        from shot_fpfh_tpu_torch.utils import debug_nans

        if debug_nans._active:
            checked_kernels[name] = checked_kernels.get(name, 0) + 1
        return saved_kernel(name, tensors)

    shot_model._debug_read, _kernels.check_kernel = count_read, count_kernel
    try:
        with _LogLines("shot_fpfh_tpu_torch") as log:
            dbg = pair.run("--debug_shot", ["--debug_shot"], SHOT_PATH, ("shot_runs",),
                           cold=False)
        nans = pair.run("--debug_nans", ["--debug_nans"], SHOT_PATH, cold=False)
    finally:
        shot_model._debug_read, _kernels.check_kernel = saved_read, saved_kernel
    summary = [ln for ln in log.lines if ln.startswith("SHOT debug checks:")]
    check(summary == ["SHOT debug checks: 0 violations"],
          f"--debug_shot: the checks reported {summary}")
    sg = dbg["launches"][SG]
    check(reads[0] >= sg, f"--debug_shot: {reads[0]} counters read for {sg} SG launches")
    for name in SHOT_PATH:
        check(checked_kernels.get(name, 0) == nans["launches"][name],
              f"--debug_nans: {checked_kernels.get(name, 0)} of {nans['launches'][name]} "
              f"launches of {name} checked")
    print(_describe("phase 13 --debug_shot", dbg)
          + f"; {reads[0]} SHOT accumulations' counters read ({sg} in SG), 0 violations; "
          f"phase 4's wall {shot['wall']:.3f} s", flush=True)
    print(_describe("phase 13 --debug_nans", nans)
          + f"; kernel launches checked {checked_kernels}, no NaN; phase 4's wall "
          f"{shot['wall']:.3f} s, errors {shot['rot_err']:.2e} rad, {shot['t_err']:.2e}",
          flush=True)
    return {"--debug_shot": dbg["launches"], "--debug_nans": nans["launches"]}


def phase_library_rest(pair: SmokePair, dev) -> str:
    """Phase 13c: the sampled ICP, the stats solvers and the profiler
    helpers on the card, against the CPU where they compute."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from shot_fpfh_tpu_torch.core import solvers as sv
    from shot_fpfh_tpu_torch.registration.icp import icp_point_to_point_with_sampling
    from shot_fpfh_tpu_torch.utils.perf import (
        start_profiler_trace,
        stop_profiler_trace,
        trace_annotation,
    )

    rng = np.random.default_rng(13)
    # the scan moved back by the true motion, then 2 degrees off: ICP range
    back = ((pair.scan - pair.trans) @ pair.rot) @ rotation_about([1.0, 0.5, 0.2],
                                                                  np.deg2rad(2.0)).T
    subsets = [rng.choice(len(back), SAMPLED_ICP_LIMIT, replace=False)
               for _ in range(SAMPLED_ICP_ITERS)]
    runs = {device: icp_point_to_point_with_sampling(
        back, pair.ref, ICP_D_MAX, max_iter=SAMPLED_ICP_ITERS, rms_threshold=1e-3,
        sampling_limit=SAMPLED_ICP_LIMIT, subsets=subsets, device=device)
        for device in (dev, "cpu")}
    (pts, rms, _), (pts_c, rms_c, _) = runs[dev], runs["cpu"]
    pts_err, rms_err = float(np.abs(pts - pts_c).max()), abs(rms - rms_c)
    check(pts_err <= SAMPLED_ICP_PTS_ATOL and rms_err <= SAMPLED_ICP_RMS_ATOL,
          f"sampled ICP: points off the CPU's by {pts_err}, RMS by {rms_err}")

    batch = 64
    scan = torch.tensor(rng.normal(size=(batch, 500, 3)), dtype=torch.float32)
    angles = torch.tensor(rng.uniform(-0.2, 0.2, size=(batch, 3)), dtype=torch.float32)
    from shot_fpfh_tpu_torch.core.transform import euler_xyz_to_matrix

    ref = scan @ euler_xyz_to_matrix(angles).transpose(-1, -2) + torch.tensor(
        rng.normal(size=(batch, 1, 3)), dtype=torch.float32)
    ref = ref + 0.01 * torch.tensor(rng.normal(size=ref.shape), dtype=torch.float32)
    normals = torch.nn.functional.normalize(
        torch.tensor(rng.normal(size=ref.shape), dtype=torch.float32), dim=-1)
    w = torch.tensor(rng.uniform(0, 1, size=(batch, 500)) > 0.2, dtype=torch.float32)

    def solves(device):
        s, r, n, ww = (t.to(device) for t in (scan, ref, normals, w))
        return {"stats": sv.solve_point_to_point_from_stats(*sv.point_to_point_stats(s, r, ww)),
                "kabsch": sv.solve_point_to_point(s, r, ww),
                "normal eq": sv.solve_point_to_plane_from_normal_eq(
                    *sv.point_to_plane_normal_eq(s, r, n, ww)),
                "plane": sv.solve_point_to_plane(s, r, n, ww)}

    card, cpu = solves(dev), solves("cpu")
    errs = {}
    for key in card:
        errs[key] = max(float((card[key].rotation.cpu() - cpu[key].rotation).abs().max()),
                        float((card[key].translation.cpu() - cpu[key].translation).abs().max()))
    for a, b in (("stats", "kabsch"), ("normal eq", "plane")):
        errs[f"{a} vs {b}"] = max(
            float((card[a].rotation - card[b].rotation).abs().max()),
            float((card[a].translation - card[b].translation).abs().max()))
    check(max(errs.values()) <= SOLVER_ATOL, f"stats solvers: errors {errs}")

    label = "chip_smoke_phase13"
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with trace_annotation(label):
            (torch.ones(1024, device=dev) * 2).sum()
        torch.cuda.synchronize()
    check(any(e.name == label for e in prof.events()), "trace_annotation not in the profile")
    start_profiler_trace(str(WORK / "trace"))
    with trace_annotation(label):
        (torch.ones(1024, device=dev) * 2).sum()
    trace = Path(stop_profiler_trace())
    check(trace.is_file() and label in trace.read_text(), "profiler trace without the span")
    return (f"phase 13 sampled ICP: {len(back)} points, {SAMPLED_ICP_ITERS} iterations of "
            f"{SAMPLED_ICP_LIMIT} injected samples, d_max {ICP_D_MAX}: RMS {rms:.6f} (CPU "
            f"{rms_c:.6f}), max |points - CPU| {pts_err:.2e}; stats solvers on {batch} batches "
            f"of 500 points, max errors {errs} (limit {SOLVER_ATOL}); trace_annotation seen in "
            f"the profiler's events and in the chrome trace ({trace.stat().st_size} bytes)")


# phase 14, part 2, and phase 15, part 2: two processes sharing the one card
# (gloo; NCCL refuses two ranks on one device).  Over a file:// store they
# run the port's CLI with --n_devices 2: staged SHOT (a cold run first) and
# FPFH, then --fused SHOT and FPFH; then, the group destroyed, run_multihost
# over initialize_distributed's tcp:// coordinator and one scaling_report.
# Each rank writes its record to a JSON file
MESH_RANKS = 2
MESH_WORKER = r"""
import json, sys, time
import torch
import torch.distributed as dist
rank, store, root, spec = int(sys.argv[1]), sys.argv[2], sys.argv[3], json.loads(sys.argv[4])
sys.path.insert(0, root)
from shot_fpfh_tpu_torch import _kernels, cli
from shot_fpfh_tpu_torch.parallel import make_mesh, scaling_report
from shot_fpfh_tpu_torch.parallel.multihost import run_multihost
mesh = make_mesh(device="cuda", init_method="file://" + store, rank=rank, world_size=2,
                 timeout=600)
out = {"backend": mesh.backend, "device": str(mesh.device)}
for label, argv in spec["runs"]:
    tag = f"{spec['work']}/mesh2_{label}_rank{rank}"
    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    rc = cli.main(argv + ["--n_devices", "2", "--output_dir", tag, "--metrics_json", tag + ".json"])
    torch.cuda.synchronize()
    out[label] = {"rc": rc, "wall": time.perf_counter() - t0,
                  "launches": dict(_kernels.launch_counts)}
dist.destroy_process_group()
_kernels.reset_launch_counts()
t0 = time.perf_counter()
res = run_multihost(*spec["multihost"]["files"], coordinator_address=spec["multihost"]["coord"],
                    num_processes=2, process_id=rank, device="cuda", timeout=600,
                    **spec["multihost"]["kwargs"])
torch.cuda.synchronize()
out["multihost"] = {"result": res, "wall": time.perf_counter() - t0,
                    "launches": dict(_kernels.launch_counts)}
out["scaling"] = {str(k): v for k, v in scaling_report(stage="shot", device="cuda").items()}
with open(f"{spec['work']}/mesh2_rank{rank}.json", "w") as f:
    json.dump(out, f)
"""
# run_multihost on the smoke pair: the pair's SHOT radius, JAX's other
# defaults (keypoints at voxel 0.25, ratio 0.9, 2,000 draws, ICP at 0.1)
MULTIHOST_KW = {"radius": 0.9}
# two ranks against one process: equal to 1e-6 (JAX tests/test_multihost.py)
MULTIHOST_RANKS_ATOL = 1e-6
# the 1-rank stages against one device: reductions (RANSAC's transform, ICP)
# within MESH_SUM_ATOL, everything per row equal
MESH_SUM_ATOL = 1e-5
# two ranks against one: the moved scan within 1e-3 (JAX
# tests/test_mesh_pipeline.py::test_cli_n_devices_same_transform)
MESH_MOVED_ATOL = 1e-3


def _stage(fn):
    """``fn()``'s result, its CUDA-event milliseconds and the kernel
    launches it made (counts set to 0 just before, read just after)."""
    import torch

    from shot_fpfh_tpu_torch import _kernels

    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end), {k: v for k, v in _kernels.launch_counts.items() if v}


def _all_equal(got, want) -> bool:
    import torch

    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    return all(torch.equal(g, w) for g, w in zip(got, want))


def _all_close(got, want):
    """True when every pair is within MESH_SUM_ATOL, else the differences."""
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    diffs = [float((g - w).abs().max()) for g, w in zip(got, want)]
    return True if max(diffs) <= MESH_SUM_ATOL else diffs


def phase_mesh_one_rank(pair: SmokePair) -> dict:
    """Phase 14, part 1: a 1-rank NCCL group in this process; every sharded
    stage at the smoke pair's shapes held to the single-device port on the
    same inputs: equal (``torch.equal``) per row (normals, SHOT in its three
    modes on both routes, FPFH on both routes, the ring's top-2, multiscale
    matching; SHOT's scale 2 on the brute route, whose histogram sums in no
    fixed order, within MESH_SUM_ATOL), RANSAC's count equal and its
    transform and ICP's within MESH_SUM_ATOL.  Each stage's CUDA-event time and launches (and the
    single-device call's time) are printed; returns the launches summed
    over the sharded stages."""
    import torch
    import torch.distributed as dist

    from shot_fpfh_tpu_torch.core.subsampling import grid_subsample
    from shot_fpfh_tpu_torch.core.transform import rotation_angle
    from shot_fpfh_tpu_torch.keypoints import select_keypoints_with_density_threshold
    from shot_fpfh_tpu_torch.models.fpfh import compute_fpfh_descriptor
    from shot_fpfh_tpu_torch.models.normals import compute_normals
    from shot_fpfh_tpu_torch.models.shot import ShotComputer, compute_shot_descriptor
    from shot_fpfh_tpu_torch.ops.grid_hash import build_grid
    from shot_fpfh_tpu_torch.parallel import make_mesh, sharded
    from shot_fpfh_tpu_torch.parallel.mesh import all_reduce_sum
    from shot_fpfh_tpu_torch.registration import icp, matching, ransac

    store = WORK / "nccl_store"
    store.unlink(missing_ok=True)
    mesh = make_mesh(device="cuda", init_method=f"file://{store}", rank=0, world_size=1,
                     timeout=300)
    check(dist.get_backend() == "nccl" and mesh.backend == "nccl" and mesh.size == 1,
          f"phase 14: a 1-rank group on {dist.get_backend()}, mesh {mesh}")
    dev = mesh.device
    # NCCL sets its communicator up at the first collective: once, here
    _, setup_ms, _ = _stage(lambda: all_reduce_sum(torch.zeros(1, device=dev), mesh))
    total, lines = {}, []

    def stage(label, sharded_fn, single_fn, compare=_all_equal):
        got, ms, launches = _stage(sharded_fn)
        want, single_ms, _ = _stage(single_fn)
        ok = compare(got, want)
        check(ok is True, f"phase 14 {label}: the 1-rank mesh differs from one device ({ok})")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        lines.append(f"{label} {ms:.3f} ms (one device {single_ms:.3f}), launches {launches}")
        return got

    ref, scan = (torch.as_tensor(c, device=dev) for c in (pair.ref, pair.scan))
    ref_n = stage(f"normals k=30 ({ref.shape[0]} points)",
                  lambda: sharded.sharded_normals(ref, ref, mesh, k=30),
                  lambda: compute_normals(ref, ref, k=30, device=dev))
    scan_n = compute_normals(scan, scan, k=30, device=dev)
    kp, sup, shot = {}, {}, {}
    for side, cloud, nrm in (("scan", scan, scan_n), ("ref", ref, ref_n)):
        kp[side] = select_keypoints_with_density_threshold(cloud, KEYPOINT_VOXEL, 5, device=dev)
        sup[side] = [(cloud[i], nrm[i]) for i in (
            torch.as_tensor(grid_subsample(cloud, r / 10), device=dev) for r in (0.9, 0.9 * PHI))]
    kp_ref = ref[torch.as_tensor(kp["ref"], device=dev)]
    kp_scan = scan[torch.as_tensor(kp["scan"], device=dev)]
    shot_kw = dict(k_max=512, min_neighborhood_size=100)
    single = ShotComputer(pad_queries_to=1, device=dev, **shot_kw)
    for route in ("window", "runs"):
        with run_kernels_in_place(route == "runs"):
            (s_pts, s_nrm), (s2_pts, s2_nrm) = sup["ref"]
            own = stage(f"SHOT {route} route, own frames",
                        lambda: sharded.sharded_shot_descriptors(
                            kp_ref, s_pts, s_nrm, 0.9, mesh, return_rfs=True, **shot_kw),
                        lambda: compute_shot_descriptor(kp_ref, s_pts, s_nrm, 0.9, **shot_kw))
            stage(f"SHOT {route} route, bi-scale",
                  lambda: sharded.sharded_shot_descriptors(
                      kp_ref, s_pts, s_nrm, 0.9 * PHI, mesh, rf_radius=0.9, **shot_kw),
                  lambda: single.compute_descriptor_bi_scale(s_pts, s_nrm, kp_ref, 0.9,
                                                             0.9 * PHI))
            # scale 2's support (under 20k points) takes the brute route, whose
            # histogram is PyTorch's index_add_: float atomics on the card, in
            # no fixed order, so two runs of one device part in the last bits
            shared = stage(f"SHOT {route} route, shared frames (scale 2, brute route)",
                           lambda: sharded.sharded_shot_descriptors(
                               kp_ref, s2_pts, s2_nrm, 0.9 * PHI, mesh, shared_rfs=own[1],
                               **shot_kw),
                           lambda: compute_shot_descriptor(kp_ref, s2_pts, s2_nrm, 0.9 * PHI,
                                                           local_rfs=own[1], **shot_kw)[0],
                           _all_close)
            if route == "window":
                shot["ref"] = (own[0], shared)
    (s_pts, s_nrm), (s2_pts, s2_nrm) = sup["scan"]
    scan_desc, scan_rfs = compute_shot_descriptor(kp_scan, s_pts, s_nrm, 0.9, **shot_kw)
    shot["scan"] = (scan_desc, compute_shot_descriptor(kp_scan, s2_pts, s2_nrm, 0.9 * PHI,
                                                       local_rfs=scan_rfs, **shot_kw)[0])
    kp_idx = torch.as_tensor(kp["ref"], device=dev)
    for route in ("window", "runs"):
        with run_kernels_in_place(route == "runs"):
            before = dict(total)
            stage(f"FPFH {route} route",
                  lambda: sharded.sharded_fpfh(kp_idx, ref, ref_n, FPFH_RADIUS, mesh),
                  lambda: compute_fpfh_descriptor(kp_idx, ref, ref_n, FPFH_RADIUS, device=dev))
            agg_launches(f"phase 14 1-rank FPFH {route} route",
                         {k: total.get(k, 0) - before.get(k, 0) for k in (AGG, K7)}, 1)

    a_nz = torch.nonzero((shot["scan"][0] != 0).any(1))[:, 0]
    b_nz = torch.nonzero((shot["ref"][0] != 0).any(1))[:, 0]
    a, b = shot["scan"][0][a_nz], shot["ref"][0][b_nz]
    ring = stage(f"ring_match {a.shape[0]} x {b.shape[0]} x {a.shape[1]}",
                 lambda: tuple(sharded.ring_match(a, b, mesh)),
                 lambda: matching.top2_descriptor(
                     a, b, torch.ones(b.shape[0], dtype=torch.bool, device=dev)))
    scan_ms, ref_ms = (torch.stack(shot[side]) for side in ("scan", "ref"))
    for recip in (False, True):
        stage(f"multiscale match (2, {scan_ms.shape[1]} | {ref_ms.shape[1]}, 352), "
              f"reciprocal {recip}",
              lambda: sharded.sharded_multiscale_match(scan_ms, ref_ms, mesh,
                                                       filter_nonreciprocal=recip),
              lambda: matching.multiscale_top1(scan_ms, ref_ms, filter_nonreciprocal=recip))
    scan_m = kp_scan[a_nz]
    ref_m = kp_ref[b_nz[ring[0]]]
    draws = ransac.sample_draws(scan_m.shape[0], 10_000, 4, torch.Generator().manual_seed(72))

    def ransac_close(got, want):
        count = round(float(got[0]) * scan_m.shape[0]) == round(float(want[0]) * scan_m.shape[0])
        return count and _all_close((got[1].rotation, got[1].translation),
                                    (want[1].rotation, want[1].translation))

    ransac_out = stage(
        f"RANSAC {scan_m.shape[0]} matches x 10000 given draws",
        lambda: sharded.sharded_ransac(scan_m, ref_m, None, mesh, draws=draws,
                                       distance_threshold=1.0),
        lambda: ransac.ransac_on_matches(scan_m, ref_m, draws=draws, distance_threshold=1.0),
        ransac_close)
    scan_sub = scan[torch.as_tensor(grid_subsample(scan, ICP_VOXEL), device=dev)]
    init = ransac_out[1]

    def icp_close(got, want):
        return got[3] == int(want.n_iters) and _all_close(
            (got[0].rotation, got[0].translation, torch.tensor(got[1])),
            (want.transform.rotation, want.transform.translation, want.rms.cpu()))

    tf, rms, conv, n_iters = stage(
        f"ICP point-to-plane, {scan_sub.shape[0]} points, on the ref's grid (the mesh: _step "
        "with K7's 1-NN mode; one device: IS)",
        lambda: sharded.sharded_icp(scan_sub, ref, ref_n, init, mesh, d_max=ICP_D_MAX,
                                    max_iter=50, rms_threshold=1e-3),
        lambda: icp.icp_loop(scan_sub, ref, ref_n, init, ICP_D_MAX, 50, 1e-3,
                             grid=build_grid(ref, ICP_D_MAX)),
        icp_close)
    rot_err = float(rotation_angle(tf.rotation.double().cpu(), torch.tensor(pair.rot.T)))
    t_err = float(np.linalg.norm(tf.translation.double().cpu().numpy()
                                 - (-pair.rot.T @ pair.trans)))
    check(rot_err < MAIN_ROT_TOL and t_err < MAIN_T_TOL,
          f"phase 14 1-rank ICP: rotation error {rot_err}, translation error {t_err}")
    for name in (SG, "shot_runs", "top2_match", "radius_pca", SPFH_PASS, "spfh_runs", AGG, NN):
        check(total.get(name, 0) > 0, f"phase 14: the 1-rank stages never launched {name}")
    dist.destroy_process_group()
    print(f"phase 14 mesh, 1-rank NCCL group ({mesh.device}, first collective "
          f"{setup_ms:.1f} ms): every per-row stage equal to "
          f"one device (scale 2's brute-route SHOT, RANSAC and ICP within {MESH_SUM_ATOL}); "
          f"ICP {n_iters} iterations, "
          f"rotation error {rot_err:.2e} rad, translation error {t_err:.2e}; stages: "
          + "; ".join(lines), flush=True)
    return total


def phase_fused_mesh_one_rank(cases: dict) -> dict:
    """Phase 15, part 1: ``fused_registration_mesh`` over a 1-rank NCCL
    group in this process, on the inputs phase 12's ``--fused`` runs gave
    ``fused_registration`` (SHOT on the window and run routes, FPFH: the
    smoke pair's 24,772 / 24,428 keypoints), each held to the one-device
    call on the same inputs: equal (``torch.equal``) through matching (each
    cloud's descriptors, the nearest indices and the match mask), the match
    count and convergence equal, RANSAC and ICP within MESH_SUM_ATOL, the
    same launches.  Each call's CUDA-event ms beside the one device's, and
    the mesh call's host syncs by leg.  Returns each mesh run's launches."""
    import torch
    import torch.distributed as dist

    from shot_fpfh_tpu_torch.parallel import make_mesh
    from shot_fpfh_tpu_torch.parallel.mesh import all_reduce_sum
    from shot_fpfh_tpu_torch.registration import fused

    store = WORK / "nccl_store_fused"
    store.unlink(missing_ok=True)
    mesh = make_mesh(device="cuda", init_method=f"file://{store}", rank=0, world_size=1,
                     timeout=300)
    check(dist.get_backend() == "nccl" and mesh.size == 1,
          f"phase 15: a 1-rank group on {dist.get_backend()}, mesh {mesh}")
    _, setup_ms, _ = _stage(lambda: all_reduce_sum(torch.zeros(1, device=mesh.device), mesh))
    launches, lines = {}, []
    for label, (run_route, must, (args, kw)) in cases.items():
        with run_kernels_in_place(run_route):
            with _FusedLegs() as one:
                want, one_ms, one_launches = _stage(lambda: fused.fused_registration(*args, **kw))
            with _FusedLegs() as sharded:
                got, ms, mesh_launches = _stage(
                    lambda: fused.fused_registration_mesh(mesh, *args, **kw))
            with _FusedLegs(syncs=True) as counted:
                fused.fused_registration_mesh(mesh, *args, **kw)
        for leg in ("descriptors", "matching"):
            check(len(sharded.outputs[leg]) == len(one.outputs[leg]) and all(
                _all_equal(g, w) for g, w in zip(sharded.outputs[leg], one.outputs[leg])),
                f"phase 15 {label}: the 1-rank mesh's {leg} differ from one device's")
        check(int(got.n_matches) == int(want.n_matches)
              and bool(got.icp_converged) == bool(want.icp_converged),
              f"phase 15 {label}: matches {int(got.n_matches)} / {int(want.n_matches)}, "
              f"converged {bool(got.icp_converged)} / {bool(want.icp_converged)}")
        close = _all_close(
            (got.ransac_transform.rotation, got.ransac_transform.translation,
             got.ransac_inlier_ratio, got.icp_transform.rotation, got.icp_transform.translation,
             got.icp_rms),
            (want.ransac_transform.rotation, want.ransac_transform.translation,
             want.ransac_inlier_ratio, want.icp_transform.rotation,
             want.icp_transform.translation, want.icp_rms))
        check(close is True, f"phase 15 {label}: RANSAC / ICP differ from one device's {close}")
        # ICP: one device runs IS, the mesh its plain step (K7's 1-NN mode)
        # under the summed statistics, one launch an iteration each
        icp_ok = one_launches.get(IS, 0) == mesh_launches.get(NN, 0) > 0
        rest = {k: v for k, v in one_launches.items() if k not in (IS, NN)}
        check(icp_ok and rest == {k: v for k, v in mesh_launches.items() if k not in (IS, NN)},
              f"phase 15 {label}: launches {mesh_launches}, one device {one_launches}")
        for name in must:
            if name not in ("radius_pca", IS):    # K3: the CLI's normals; IS: one device's
                check(mesh_launches.get(name, 0) > 0, f"phase 15 {label}: never launched {name}")
        if AGG in must:
            agg_launches(f"phase 15 {label}", {k: mesh_launches.get(k, 0) for k in (AGG, K7)})
        launches[f"fused mesh 1-rank {label}"] = mesh_launches
        lines.append(f"{label}: {ms:.3f} ms (one device {one_ms:.3f}), {int(got.n_matches)} "
                     f"matches, launches {mesh_launches}, host syncs by leg "
                     f"{counted.sync_counts()}")
    dist.destroy_process_group()
    print(f"phase 15 fused program over a 1-rank NCCL group ({mesh.device}, first collective "
          f"{setup_ms:.1f} ms): equal to one device through matching, RANSAC and ICP within "
          f"{MESH_SUM_ATOL}, the same launches (IS's on one device as the 1-NN's under the "
          "mesh); " + "; ".join(lines), flush=True)
    return launches


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def phase_mesh_two_ranks(pair: SmokePair) -> dict:
    """Phase 14, part 2, and phase 15, part 2: two processes sharing the
    one card over gloo (``MESH_WORKER``), on the smoke pair with
    ``config/default.yaml``.  Phase 14: ``cli.main --n_devices 2`` staged
    (SHOT: a cold run, then a measured one; FPFH).  Phase 15: ``--fused``
    for SHOT and FPFH, then ``run_multihost`` on the pair's ``.ply`` files
    through ``initialize_distributed`` and one ``scaling_report`` of SHOT.
    Each CLI run accepted within the main path's bounds, its moved scan
    within MESH_MOVED_ATOL of one device's (``--fused`` against one
    device's ``--fused``), only rank 0 writing, and each rank launching SG
    (FPFH: the SPFH pass kernel or K6, and the aggregation kernel),
    K2, K3 and K7's 1-NN mode;
    ``run_multihost`` the same on both ranks (MULTIHOST_RANKS_ATOL), within
    MESH_MOVED_ATOL of one process's run and accepted against the ground
    truth.  Returns rank 0's
    launches of each measured run."""
    import os

    import torch

    from shot_fpfh_tpu_torch import cli
    from shot_fpfh_tpu_torch.core.transform import rotation_angle
    from shot_fpfh_tpu_torch.parallel.multihost import run_multihost

    fpfh = ["--descriptor_choice", "fpfh", "--radius", str(FPFH_RADIUS)]
    fused = FUSED_FLAGS + ["--fused"]
    runs = [("shot_cold", []), ("shot", []), ("fpfh", fpfh), ("fused_shot", fused),
            ("fused_fpfh", fused + fpfh)]
    base = [a for a in pair.argv]
    for flag in ("--output_dir", "--metrics_json"):     # each rank gets its own
        i = base.index(flag)
        del base[i:i + 2]
    singles = {}
    for label, extra in runs[1:]:
        out = WORK / f"mesh1_{label}"
        check(cli.main(base + extra + ["--n_devices", "1", "--output_dir", str(out)]) == 0,
              f"phase 14/15 one device, {label}: registration rejected")
        torch.cuda.synchronize()
        singles[label] = moved_scan(out / "scan_on_ref_post_icp.ply")
    files = [str(WORK / "scan.ply"), str(WORK / "ref.ply")]
    t0 = time.perf_counter()
    single_mh = run_multihost(*files, device="cuda", **MULTIHOST_KW)
    torch.cuda.synchronize()
    single_mh_wall = time.perf_counter() - t0
    store = WORK / "gloo_store"
    store.unlink(missing_ok=True)
    spec = json.dumps({"work": str(WORK), "runs": [(lbl, base + ex) for lbl, ex in runs],
                       "multihost": {"files": files, "coord": f"127.0.0.1:{_free_port()}",
                                     "kwargs": MULTIHOST_KW}})
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
                        "MASTER_PORT")}
    logs = [open(WORK / f"mesh2_rank{r}.log", "w") for r in range(MESH_RANKS)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c", MESH_WORKER, str(r), str(store), str(ROOT),
                               spec], env=env, stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(MESH_RANKS)]
    try:
        codes = [p.wait(timeout=900) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    elapsed = time.perf_counter() - t0
    for r, code in enumerate(codes):
        tail = (WORK / f"mesh2_rank{r}.log").read_text()[-3000:]
        check(code == 0, f"phase 14/15 two ranks: rank {r} exited {code}:\n{tail}")
    ranks = [json.loads((WORK / f"mesh2_rank{r}.json").read_text()) for r in range(MESH_RANKS)]
    check(all(r["backend"] == "gloo" for r in ranks),
          f"phase 14 two ranks: backends {[r['backend'] for r in ranks]}")
    shot_needs = (SG, "top2_match", "radius_pca", NN)
    needs = {"shot": shot_needs, "fpfh": ("top2_match", "radius_pca", AGG, NN),
             "fused_shot": shot_needs,
             "fused_fpfh": (SPFH_PASS, "top2_match", "radius_pca", AGG, NN)}
    parts, launches = {14: [], 15: []}, {}
    for label in ("shot", "fpfh", "fused_shot", "fused_fpfh"):
        phase = 15 if label.startswith("fused") else 14
        for r, rec in enumerate(ranks):
            run = rec[label]
            check(run["rc"] == 0, f"phase {phase} two ranks, {label}: rank {r} rejected")
            for name in needs[label]:
                check(run["launches"][name] > 0, f"phase {phase} two ranks, {label}: rank {r} "
                      f"never launched {name}")
            if label.endswith("fpfh"):
                check(run["launches"][SPFH_PASS] + run["launches"]["spfh_runs"] > 0,
                      f"phase {phase} two ranks, {label}: rank {r} launched neither the SPFH "
                      "pass kernel nor K6")
                agg_launches(f"phase {phase} two ranks, {label}, rank {r}", run["launches"])
        out = WORK / f"mesh2_{label}_rank0"
        check(not (WORK / f"mesh2_{label}_rank1").exists(),
              f"phase {phase} two ranks, {label}: rank 1 wrote outputs")
        rot_err, t_err = pair.errors(out)
        check(rot_err < MAIN_ROT_TOL and t_err < MAIN_T_TOL,
              f"phase {phase} two ranks, {label}: rotation error {rot_err}, translation {t_err}")
        moved_err = float(np.abs(moved_scan(out / "scan_on_ref_post_icp.ply")
                                 - singles[label]).max())
        check(moved_err < MESH_MOVED_ATOL,
              f"phase {phase} two ranks, {label}: moved scan {moved_err} from one device's")
        name = {"shot": "SHOT", "fpfh": "FPFH", "fused_shot": "fused SHOT",
                "fused_fpfh": "fused FPFH"}[label]
        launches[f"mesh 2-rank {name}"] = ranks[0][label]["launches"]
        stages = json.loads((WORK / f"mesh2_{label}_rank0.json").read_text())["stages"]
        if phase == 15:
            check([st["stage"] for st in stages] == ["fused"],
                  f"phase 15 two ranks, {label}: stages {[st['stage'] for st in stages]}")
        parts[phase].append(
            f"{label}: accepted, rotation error {rot_err:.2e} rad, translation error "
            f"{t_err:.2e}, moved scan within {moved_err:.2e} of one device's; wall (rank 0, "
            f"rank 1) {ranks[0][label]['wall']:.3f}, {ranks[1][label]['wall']:.3f} s; "
            "stages " + ", ".join(f"{s['stage']} {s['seconds']:.3f} s" for s in stages)
            + "; launches by rank "
            + str([{k: v for k, v in rec[label]['launches'].items() if v} for rec in ranks]))
    mh = [rec["multihost"]["result"] for rec in ranks]
    for r, res in enumerate(mh):
        check(res["process_id"] == r and res["process_count"] == res["n_devices"] == MESH_RANKS,
              f"phase 15 run_multihost: rank {r} reports {res['process_id']} of "
              f"{res['process_count']}, {res['n_devices']} devices")
    for key in ("rotation", "translation"):
        gap = float(np.abs(np.subtract(mh[0][key], mh[1][key])).max())
        check(gap <= MULTIHOST_RANKS_ATOL, f"phase 15 run_multihost: the ranks' {key} {gap} apart")
        gap = float(np.abs(np.subtract(mh[0][key], single_mh[key])).max())
        check(gap < MESH_MOVED_ATOL, f"phase 15 run_multihost: {key} {gap} from one process's")
    exact_rot = torch.tensor(pair.rot.T)
    mh_rot_err = float(rotation_angle(torch.tensor(mh[0]["rotation"], dtype=torch.float64),
                                      exact_rot))
    mh_t_err = float(np.linalg.norm(np.asarray(mh[0]["translation"])
                                    - (-pair.rot.T @ pair.trans)))
    check(mh_rot_err < MAIN_ROT_TOL and mh_t_err < MAIN_T_TOL,
          f"phase 15 run_multihost: rotation error {mh_rot_err}, translation {mh_t_err}")
    launches["multihost 2-rank"] = ranks[0]["multihost"]["launches"]
    for name in shot_needs:
        check(launches["multihost 2-rank"][name] > 0,
              f"phase 15 run_multihost: rank 0 never launched {name}")
    scaling = ranks[0]["scaling"]
    print(f"phase 14 mesh, two ranks sharing one card over gloo (not a scaling number; "
          f"cold SHOT run {ranks[0]['shot_cold']['wall']:.3f} s, processes "
          f"{elapsed:.1f} s in all with phase 15's runs): " + "; ".join(parts[14]), flush=True)
    print("phase 15 the fused program and run_multihost on two ranks sharing one card over "
          "gloo (not a scaling number): " + "; ".join(parts[15])
          + f"; run_multihost ({MULTIHOST_KW}, JAX's other defaults): {mh[0]['n_matches']} "
          f"matches, RANSAC inlier ratio {mh[0]['ransac_inlier_ratio']:.4f}, ICP RMS "
          f"{mh[0]['icp_rms']:.6f}, rotation error {mh_rot_err:.2e} rad, translation error "
          f"{mh_t_err:.2e}, the ranks equal within {MULTIHOST_RANKS_ATOL}, one process's run "
          f"within {MESH_MOVED_ATOL} (one process {single_mh_wall:.3f} s; ranks "
          f"{ranks[0]['multihost']['wall']:.3f}, {ranks[1]['multihost']['wall']:.3f} s, "
          "initialisation included), stages (rank 0) "
          + ", ".join(f"{st['stage']} {st['seconds']:.3f} s"
                      for st in mh[0]["stages"]["stages"])
          + f", launches by rank {[{k: v for k, v in rec['multihost']['launches'].items() if v} for rec in ranks]}"
          + f"; scaling_report(stage='shot') on rank 0, items/s by device count, not a "
          f"scaling number (the two ranks share one card): {scaling}", flush=True)
    return launches


# phase 16: the JAX package's own scale.  The pair is
# benchmarks/bench_1m.py:52-64's, copied, not imported: a 10^6-point ref
# (xy uniform in [-20, 20]², the three-octave sinusoid z, 0.005 noise: ~625
# points per unit area, 2.5x the smoke pair's) and the scan it moves by
# Euler xyz (0.2, -0.1, 0.4) and (0.8, -0.5, 0.3), scan = (ref - t) @ R,
# plus 0.005 noise of its own (the threshold filter's floor needs it);
# bench_1m.py's descriptor radius and keypoint voxel.  bench.py:409-501's
# at-scale legs on that ref: the descriptor grid (cell radius/2, halo 2),
# SHOT of the voxel-0.9 keypoints padded to a multiple of 1024 with the far
# sentinel (min_neighborhood_size 30), k=30 normals, FPFH of those
# keypoints, point-to-plane ICP of the small motion below (no noise: it
# must come back within SCALE_ICP_TOL), and Lowe matching of two seeded
# (100,000, 352) normal-random descriptor sets
SCALE_N, SCALE_SEED, SCALE_NOISE_SEED, SCALE_LOWE_SEED = 1_000_000, 7, 8, 9
SCALE_EULER, SCALE_T = (0.2, -0.1, 0.4), (0.8, -0.5, 0.3)
SCALE_RADIUS, SCALE_VOXEL, SCALE_PAD, SCALE_MIN_NEIGHBORS = 0.6, 0.9, 1024, 30
# the CLI legs' keypoint voxel: the evaluation accepts a registration when
# half the moved scan keypoints lie within 0.1 of a ref keypoint
# (config/default.yaml), which voxel representatives 0.9 apart, drawn on
# each cloud's own grid, never do (5-8% on a correct alignment of the pair
# cut to CPU size, where the JAX CLI rejects it too: tests/test_torch_scale.py),
# so the CLI legs take the smoke pair's voxel: ~78k keypoints a cloud
SCALE_CLI_VOXEL = KEYPOINT_VOXEL
SCALE_ICP_EULER, SCALE_ICP_T = (0.02, -0.01, 0.04), (0.08, -0.05, 0.03)
SCALE_ICP = dict(d_max=0.5, voxel_size=0.5, max_iter=30, rms_threshold=1e-6)
SCALE_ICP_TOL = 1e-3
# bench_1m.py's own staged run (BASELINE.json config #3) through cli.main:
# grid-subsampled keypoints at SCALE_VOXEL, SHOT at SCALE_RADIUS (k_max 384,
# at least 30 neighbors) over k=20 normals, RANSAC's inliers within
# SCALE_VOXEL, ICP at SCALE_ICP (bench.py's ICP leg takes bench_1m.py's);
# matching is the config's.  Held to the ground truth; the evaluation's
# verdict and keypoint-inlier share are recorded, not required
SCALE_BENCH_1M_ARGS = [
    "--selection_algorithm", "subsampling", "--neighborhood_size", str(SCALE_VOXEL),
    "--radius", str(SCALE_RADIUS), "--min_neighborhood_size", str(SCALE_MIN_NEIGHBORS),
    "--k_max_descriptor", "384", "--normals_k", "20",
    "--max_inliers_distance", str(SCALE_VOXEL),
    *(a for k, v in SCALE_ICP.items() for a in (f"--{k}", str(v)))]
# ICP's iteration cap in config/default.yaml (the other CLI legs)
SCALE_CLI_MAX_ITER = 50
SCALE_LOWE_ROWS, SCALE_DIM = 100_000, 352
# K2 at 100k x 100k is held to its twin on SCALE_K2_SAMPLE rows against all
# the refs (the whole twin's distance matrix would be 40 GB); K6 on the
# first SCALE_K6_ROWS rows of the ref's grid; the voxel sums with one voxel
# of 10^5 points in a 10^5-point terrain, then a 10^6-point cloud in one
# voxel: (points in the voxel, terrain points around it)
SCALE_K2_SAMPLE, SCALE_K6_ROWS = 4096, 100_000
# the SPFH pass at the benchmark's FPFH radius (config/default.yaml's 3.0),
# and its twin on the card timed on the first rows of the cloud only (its
# windows at radius 3.0 are ~36k slots a query)
SCALE_CELL_RADIUS, SCALE_SPFH_PLAIN_ROWS = 3.0, 4096
# the sampled k-th bound's chunked form is held to its one-piece form on the
# ref's first points of each of these counts too (chunks of 335 and 134
# rows; 67 at 10^6)
SCALE_KTH_SIZES = (200_000, 500_000)
SCALE_VOXEL_CASES = ((100_000, 100_000), (1_000_000, 0))
# timed runs a kernel after its warm-up at these shapes (phase 3: 10)
SCALE_REPS = 3


def euler_xyz(angles) -> np.ndarray:
    """Extrinsic x-y-z Euler angles as a float64 rotation matrix."""
    import torch

    from shot_fpfh_tpu_torch.core.transform import euler_xyz_to_matrix

    return euler_xyz_to_matrix(torch.tensor(angles, dtype=torch.float64)).numpy()


def scale_terrain(rng: np.random.Generator, n: int) -> np.ndarray:
    """benchmarks/bench_1m.py:52-59's ref: xy uniform in [-20, 20]², a
    three-octave sinusoid z, 0.005 Gaussian noise; float32 throughout."""
    xy = rng.uniform(-20, 20, size=(n, 2)).astype(np.float32)
    z = (0.8 * np.sin(0.9 * xy[:, 0]) * np.cos(0.7 * xy[:, 1])
         + 0.4 * np.sin(2.1 * xy[:, 0] + 1.0) * np.cos(1.7 * xy[:, 1] + 0.5)
         + 0.15 * np.sin(4.3 * xy[:, 0] + 2.0) * np.cos(3.9 * xy[:, 1] + 1.5))
    ref = np.column_stack([xy, z]).astype(np.float32)
    ref += rng.normal(scale=0.005, size=ref.shape).astype(np.float32)
    return ref


class ScalePair(SmokePair):
    """Phase 16's pair on disk in ``work``: the SCALE_N-point ref of
    :func:`scale_terrain` and its scan, with the CLI's arguments at
    bench_1m.py's radius and SCALE_CLI_VOXEL."""

    def __init__(self, work: Path):
        ref = scale_terrain(np.random.default_rng(SCALE_SEED), SCALE_N)
        r, t = euler_xyz(SCALE_EULER), np.asarray(SCALE_T)
        noise = np.random.default_rng(SCALE_NOISE_SEED).normal(scale=0.005, size=ref.shape)
        scan = ((ref - t) @ r + noise).astype(np.float32)
        # scan = ref @ rot.T + trans: rot = R^T, trans = -t R
        self._write(work, ref, scan, r.T, -(t @ r), SCALE_CLI_VOXEL, SCALE_RADIUS)


def _leg(fn):
    """``fn()`` cold once, then measured once with the launch counts set to
    0 just before it and read just after: ``(result, record)`` with the
    host wall (CUDA synchronised), the launches and the peak device
    memory of the measured run."""
    import torch

    from shot_fpfh_tpu_torch import _kernels

    fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in _kernels.launch_counts.items() if v}
    return out, dict(wall=wall, launches=launches, peak=torch.cuda.max_memory_allocated())


def _leg_line(label: str, rec: dict, extra: str = "") -> None:
    print(f"phase 16 {label}: wall {rec['wall']:.4f} s, {_peak_memory(rec['peak'])}, launches "
          f"{rec['launches']}{extra}", flush=True)


def _icp_nn_launches(label: str, r: dict, max_iter: int, keypoint_grid: bool) -> None:
    """A CLI run's IS launches, one an ICP iteration issued (the stage
    timer's count, rounded up to the loop's block of ICP_BLOCK and capped
    at ``max_iter``; the stage's ``icp_kernel_iters`` too), and its 1-NN
    launches: one for the evaluation's overlap (the 10^6-point ref), plus
    one for its keypoint inliers when the ref keypoints are at least
    AUTO_GRID_MIN_POINTS (``keypoint_grid``: ~78k at voxel 0.15, ~2k at
    0.9, which take the brute route)."""
    from shot_fpfh_tpu_torch.registration.icp import ICP_BLOCK

    stage = next(s for s in r["stages"] if s["stage"].startswith("icp"))
    iters = stage["iterations"]
    issued = min(max_iter, -(-iters // ICP_BLOCK) * ICP_BLOCK)
    check(r["launches"][IS] == stage["icp_kernel_iters"] == issued,
          f"{label}: {r['launches'][IS]} IS launches ({stage['icp_kernel_iters']} counted) for "
          f"{iters} ICP iterations")
    check(r["launches"][NN] == 1 + keypoint_grid,
          f"{label}: {r['launches'][NN]} 1-NN launches outside ICP")


def k6_rows(grid, rows: int, radius: float, reps: int) -> dict:
    """K6 in both modes on the first ``rows`` rows of ``grid`` as queries
    (non-unit stride, as ``models.fpfh`` passes them), equal to its twin
    (``torch.equal``); bound by ``parity_k6``'s rule."""
    import torch

    from shot_fpfh_tpu_torch.ops.shot_dma import (
        _xyrow_runs,
        spfh_block_dma,
        spfh_block_dma_plain,
    )

    qc, qn = grid.packed_sorted[:rows, :3], grid.packed_sorted[:rows, 3:6]
    start, end = _xyrow_runs(grid, qc)
    lanes = float((end - start).sum())
    neighbors = float(_route_counts(grid, qc, radius)[0].sum()) - rows
    res = {}
    for dec in (False, True):
        got = spfh_block_dma(grid, qc, qn, radius, 5, dec)
        want = spfh_block_dma_plain(grid, qc, qn, radius, 5, dec)
        torch.cuda.synchronize()
        check(torch.equal(got, want),
              f"K6 at scale decorrelated={dec}: {int((got != want).sum())} elements differ")
        check(float(want.sum()) > 0, "K6 at scale: empty histograms")
        res[dec] = dict(
            max_abs_err=float((got - want).abs().max()), library_ms=None,
            ms=cuda_ms(lambda: spfh_block_dma(grid, qc, qn, radius, 5, dec), reps),
            plain_ms=cuda_ms(lambda: spfh_block_dma_plain(grid, qc, qn, radius, 5, dec), reps),
            **bound(grid.packed_sorted.numel() * 4 + grid.cell_starts.numel() * 8
                    + rows * got.shape[1] * 4,
                    lanes * OPS_DIST_TEST + neighbors * OPS_SPFH_NEIGHBOR))
    print(f"phase 16 K6 spfh_runs: {rows} queries of the {grid.packed_sorted.shape[0]}-point "
          f"grid x {start.shape[1]} xy-row runs (longest {xyrow_grid(grid)[1]}, "
          f"{lanes / rows:.0f} rows and {neighbors / rows:.0f} neighbors a query): equal to the "
          f"twin in both modes; " + "; ".join(
              f"{'decorrelated' if dec else 'joint'} kernel {r['ms']:.3f} ms plain "
              f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})"
              for dec, r in res.items()), flush=True)
    return res[False]


def k2_sampled(a, b, rng, reps: int) -> dict:
    """K2 on all of ``a`` against all of ``b`` in bf16 and f32, held to its
    twin on SCALE_K2_SAMPLE sampled rows against every ref (phase 3's
    rules: index agreement, d1's relative error, no invalid ref picked);
    timed, the twin on the sampled rows alone.  No library time: one
    cuBLAS product would write the whole distance matrix."""
    import torch

    from shot_fpfh_tpu_torch.ops.match import top2_match, top2_match_plain

    n, m, dim = a.shape[0], b.shape[0], a.shape[1]
    valid = torch.ones(m, dtype=torch.bool, device=a.device)
    valid[::97] = False
    rows = torch.as_tensor(np.sort(rng.choice(n, SCALE_K2_SAMPLE, replace=False)),
                           device=a.device)
    res = {}
    for bf16 in (True, False):
        i_k, d1_k, _ = top2_match(a, b, valid, bf16)
        i_p, d1_p, _ = top2_match_plain(a[rows], b, valid, bf16)
        torch.cuda.synchronize()
        agree = int((i_k[rows] == i_p).sum()) / SCALE_K2_SAMPLE
        rel = float(((d1_k[rows] - d1_p).abs() / d1_p.abs()).max())
        check(agree >= K2_MIN_AGREE[bf16], f"K2 at scale bf16={bf16}: index agreement {agree}")
        check(rel <= K2_D1_RTOL[bf16], f"K2 at scale bf16={bf16}: d1 relative error {rel}")
        check(not bool(valid.logical_not()[i_k].any()), "K2 at scale picked an invalid ref")
        res[bf16] = dict(agree=agree, rel=rel, max_abs_err=float((d1_k[rows] - d1_p).abs().max()),
                         ms=cuda_ms(lambda: top2_match(a, b, valid, bf16), reps),
                         plain_ms=cuda_ms(lambda: top2_match_plain(a[rows], b, valid, bf16),
                                          reps),
                         library_ms=None, **_k2_bound(n, m, dim, bf16))
    print(f"phase 16 K2 top2_match: {n}x{m}x{dim}, {SCALE_K2_SAMPLE} sampled rows held to the "
          f"twin: " + "; ".join(
              f"{'bf16' if k else 'f32'} agree {v['agree']:.4f} d1 rel err {v['rel']:.2e} "
              f"kernel {v['ms']:.3f} ms, twin on the sampled rows {v['plain_ms']:.3f} ms, "
              f"bound {v['bound_ms']:.4f} ms ({v['bound_by']})" for k, v in res.items()),
          flush=True)
    return res[True]


def kth_bound_at_scale(ref) -> str:
    """The k=30 normals' sampled bound on ``ref`` (``kth_distance_bound``,
    in sample chunks) equal to the one-piece form it replaced, with each
    form's peak device memory above what was allocated before it, and
    equal too on the first SCALE_KTH_SIZES points of ``ref``; and the
    queries the streaming pass left under k neighbors (the miss net's
    exact re-solves)."""
    import torch

    from shot_fpfh_tpu_torch._fp import sqrt
    from shot_fpfh_tpu_torch.models.normals import _streaming_grid, _streaming_pass
    from shot_fpfh_tpu_torch.ops.grid_hash import kth_distance_bound
    from shot_fpfh_tpu_torch.ops.neighbors import _chunk, _sq_dists

    def peak(fn):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        return out, torch.cuda.max_memory_allocated() - base

    def one_piece(sample, points):
        return sqrt(torch.clamp(torch.topk(
            torch.clamp(_sq_dists(sample, points), min=0.0), 30, dim=1, largest=False,
            sorted=True).values[:, -1], min=0.0))

    for n in SCALE_KTH_SIZES:
        _, sample, kth = _streaming_grid(ref[:n], 30)
        check(torch.equal(kth, one_piece(sample, ref[:n])),
              f"kth_distance_bound on {n} points: the chunked form differs from the one-piece "
              "form")
    grid, sample, kth = _streaming_grid(ref, 30)
    whole, whole_peak = peak(lambda: one_piece(sample, ref))
    chunked, chunked_peak = peak(lambda: kth_distance_bound(sample, ref, 30))
    check(torch.equal(chunked, whole) and torch.equal(chunked, kth),
          "at-scale kth_distance_bound: the chunked form differs from the one-piece form")
    _, cnt = _streaming_pass(grid, sample, kth, ref, 30, None)
    return (f"sampled k-th neighbor bound in chunks of {_chunk(ref.shape[0])} of "
            f"{sample.shape[0]} sample rows: equal to the one-piece form, its temporaries "
            f"{chunked_peak / 2**30:.3f} GiB (one piece {whole_peak / 2**30:.3f} GiB); equal "
            "too on the first " + ", ".join(
                f"{n} points (chunks of {_chunk(n)})" for n in SCALE_KTH_SIZES) + "; grid "
            f"cell {grid.cell_size:.4g}, the miss net re-solves {int((cnt < 30).sum())} of "
            f"{ref.shape[0]} queries")


def phase_at_scale(dev) -> dict:
    """Phase 16: the port at the JAX package's own scale, on the 10^6-point
    pair.  Legs 1-2: ``cli.main`` for SHOT and FPFH (window route), cold
    then measured, accepted within MAIN_ROT_TOL / MAIN_T_TOL.  Leg 3:
    bench.py's at-scale legs through the library, each cold then measured
    (the grid build beside the host blake2b hash of the same bytes, the
    content cache's key).  Leg 4: every kernel at these shapes against its
    plain twin, phase 3's rules.  Then the voxel sums with a voxel of each
    SCALE_VOXEL_CASES.  Returns each leg's launches by path."""
    import hashlib
    import tempfile

    import torch

    from shot_fpfh_tpu_torch.core.subsampling import grid_subsample
    from shot_fpfh_tpu_torch.core.transform import RigidTransform, rotation_angle
    from shot_fpfh_tpu_torch.models import (
        compute_fpfh_descriptor,
        compute_normals,
        compute_shot_descriptor,
    )
    from shot_fpfh_tpu_torch.keypoints import select_keypoints_with_density_threshold
    from shot_fpfh_tpu_torch.models.fpfh import _sorted_rows, _spfh_window_sorted
    from shot_fpfh_tpu_torch.ops.grid_hash import build_grid
    from shot_fpfh_tpu_torch.registration.icp import icp_point_to_plane, nn_grid
    from shot_fpfh_tpu_torch.registration.matching import lowe_matching

    torch.cuda.empty_cache()
    paths, reps = {}, SCALE_REPS
    with tempfile.TemporaryDirectory(prefix="chip_smoke_scale_") as tmp:
        t0 = time.perf_counter()
        pair = ScalePair(Path(tmp))
        print(f"phase 16 at scale: two {SCALE_N}-point clouds made and written in "
              f"{time.perf_counter() - t0:.2f} s (radius {SCALE_RADIUS}, the CLI's keypoint "
              f"voxel {SCALE_CLI_VOXEL}, the library's {SCALE_VOXEL})", flush=True)
        shot = pair.run("at-scale SHOT", [], SHOT_PATH, (K7, *SHOT_WINDOW_NOT))
        _icp_nn_launches("at-scale SHOT", shot, SCALE_CLI_MAX_ITER, True)
        print(_describe("phase 16 leg 1 SHOT (cli.main)", shot), flush=True)
        staged = pair.run("at-scale SHOT at bench_1m.py's settings", SCALE_BENCH_1M_ARGS,
                          SHOT_PATH, (K7,), must_accept=False)
        _icp_nn_launches("at-scale SHOT at bench_1m.py's settings", staged,
                         SCALE_ICP["max_iter"], False)
        print(_describe("phase 16 leg 1 SHOT at bench_1m.py's settings (cli.main)", staged),
              flush=True)
        fpfh = pair.run("at-scale FPFH", ["--descriptor_choice", "fpfh"], FPFH_WINDOW_PATH,
                        FPFH_WINDOW_NOT)
        agg_launches("at-scale FPFH", fpfh["launches"])
        spfh_pass_launches("at-scale FPFH", fpfh["launches"])
        _icp_nn_launches("at-scale FPFH", fpfh, SCALE_CLI_MAX_ITER, True)
        print(_describe("phase 16 leg 2 FPFH, window route (cli.main)", fpfh), flush=True)
        paths["at scale SHOT"], paths["at scale FPFH"] = shot["launches"], fpfh["launches"]
        paths["at scale bench_1m.py"] = staged["launches"]
        ref_np = pair.ref
    del pair

    ref = torch.tensor(ref_np, device=dev)
    normals, rec = _leg(lambda: compute_normals(ref, ref, k=30))
    check(bool(torch.isfinite(normals).all()), "at-scale normals: not finite")
    _leg_line("leg 3 normals k=30 (compute_normals)", rec, "; " + kth_bound_at_scale(ref))
    paths["at scale normals"] = rec["launches"]
    nrm_np = normals.cpu().numpy()

    def content_key():
        """The key of JAX's grid cache (ops/grid_hash.py:325-334): blake2b
        of the host bytes of the points and the extras."""
        digest = hashlib.blake2b(ref_np.tobytes(), digest_size=16)
        digest.update(nrm_np.tobytes())
        return digest.digest()

    _, hash_rec = _leg(content_key)
    # bench.py:451-456's call: host arrays, no device (the card's)
    host_grid, host_rec = _leg(lambda: build_grid(ref_np, SCALE_RADIUS / 2, extras=nrm_np,
                                                  halo=2))
    check(host_grid.device.type == "cuda", "build_grid of host arrays ran off the card")
    grid, rec = _leg(lambda: build_grid(ref, SCALE_RADIUS / 2, extras=normals, halo=2))
    pays = host_rec["wall"] > hash_rec["wall"]
    _leg_line("leg 3 grid build (build_grid, cell 0.3, halo 2, normals)", rec,
              f"; from the host arrays {host_rec['wall'] * 1e3:.3f} ms, the host blake2b of "
              f"the same bytes (the JAX grid cache's key) {hash_rec['wall'] * 1e3:.3f} ms: a "
              f"cache hit would {'save' if pays else 'cost'} "
              f"{abs(host_rec['wall'] - hash_rec['wall']) * 1e3:.3f} ms a build; window cap "
              f"{grid.window_cap}, (xy-row mode, longest run) {xyrow_grid(grid)}")
    kp_idx = grid_subsample(ref, SCALE_VOXEL)
    pad = -(-len(kp_idx) // SCALE_PAD) * SCALE_PAD - len(kp_idx)
    kp = torch.cat([ref[torch.as_tensor(kp_idx, device=dev)],
                    torch.full((pad, 3), 1.0e6, device=dev)])
    kp_idx_pad = np.concatenate([kp_idx, np.zeros(pad, kp_idx.dtype)])
    (desc, _), rec = _leg(lambda: compute_shot_descriptor(
        kp, ref, normals, SCALE_RADIUS, min_neighborhood_size=SCALE_MIN_NEIGHBORS))
    live = float((desc[:len(kp_idx)].abs().sum(1) > 0).float().mean())
    check(bool(torch.isfinite(desc).all()) and live > 0.99,
          f"at-scale SHOT: {live} of the keypoints have a descriptor")
    _leg_line(f"leg 3 SHOT of {len(kp_idx)} keypoints padded to {kp.shape[0]} "
              "(compute_shot_descriptor)", rec,
              f"; {len(kp_idx) / rec['wall']:.0f} descriptors/s, {live:.4f} non-empty")
    paths["at scale SHOT library"] = rec["launches"]
    fp, rec = _leg(lambda: compute_fpfh_descriptor(kp_idx_pad, ref, normals, SCALE_RADIUS))
    check(fp.shape == (kp.shape[0], 125) and bool(torch.isfinite(fp).all()),
          f"at-scale FPFH: shape {tuple(fp.shape)} or not finite")
    agg_launches("at-scale library FPFH", {k: rec["launches"].get(k, 0) for k in (AGG, K7)}, 1)
    spfh_pass_launches("at-scale library FPFH", {k: rec["launches"].get(k, 0) for k in (
        SPFH_PASS, WINDOW, "spfh_histogram")}, 1)
    _leg_line("leg 3 FPFH (compute_fpfh_descriptor)", rec)
    paths["at scale FPFH library"] = rec["launches"]
    r_s, t_s = euler_xyz(SCALE_ICP_EULER), np.asarray(SCALE_ICP_T)
    scan_s = torch.tensor(((ref_np - t_s) @ r_s).astype(np.float32), device=dev)
    ident = RigidTransform.identity(device=dev)
    res, rec = _leg(lambda: icp_point_to_plane(scan_s, ref, normals, ident, **SCALE_ICP))
    rot_err = float(rotation_angle(res.transform.rotation.double().cpu(), torch.tensor(r_s)))
    t_err = float(np.linalg.norm(res.transform.translation.double().cpu().numpy() - t_s))
    check(rot_err < SCALE_ICP_TOL and t_err < SCALE_ICP_TOL,
          f"at-scale ICP: rotation error {rot_err}, translation error {t_err}")
    _leg_line("leg 3 ICP point-to-plane (icp_point_to_plane)", rec,
              f"; {res.n_iters} iterations, rms {res.rms:.2e}, rotation error {rot_err:.2e} "
              f"rad, translation error {t_err:.2e}")
    paths["at scale ICP"] = rec["launches"]
    lrng = np.random.default_rng(SCALE_LOWE_SEED)
    a, b = (torch.tensor(lrng.normal(size=(SCALE_LOWE_ROWS, SCALE_DIM)).astype(np.float32),
                         device=dev) for _ in range(2))
    (m_scan, _), rec = _leg(lambda: lowe_matching(a, b, verbose=False))
    _leg_line(f"leg 3 Lowe matching {SCALE_LOWE_ROWS}x{SCALE_LOWE_ROWS}x{SCALE_DIM} "
              "(lowe_matching)", rec, f"; {len(m_scan)} matches kept")
    paths["at scale Lowe"] = rec["launches"]

    prefix = "phase 16"
    kernels = {"radius_pca": k3_check(ref, prefix, reps)}
    chunk = grid.packed_sorted[:8192, :3]
    kernels["fetch_windows"] = parity_k8("one FPFH chunk of the ref", grid, chunk, prefix, reps)
    kernels["spfh_histogram"] = parity_k4(grid, SCALE_RADIUS, prefix, reps)
    kernels[SPFH_PASS] = parity_spfh_pass(grid, SCALE_RADIUS, "the ref's grid", prefix, reps,
                                          plain_rows=SCALE_SPFH_PLAIN_ROWS)
    # the benchmark's FPFH pass: radius 3.0, cell 1.5 (~17k neighbors a point)
    cell_grid = build_grid(ref, SCALE_CELL_RADIUS / 2, extras=normals, halo=2)
    parity_spfh_pass(cell_grid, SCALE_CELL_RADIUS, "the ref at the FPFH cell's radius", prefix,
                     1, plain_rows=SCALE_SPFH_PLAIN_ROWS, chunk_reps=1)
    del cell_grid
    # the CLI legs' keypoints: the ref's density keypoints at SCALE_CLI_VOXEL
    # (~78k), as the SHOT cells select them
    cli_kp = torch.as_tensor(select_keypoints_with_density_threshold(
        ref, SCALE_CLI_VOXEL, SG_SCALE_KP_MIN, device=dev), device=dev)
    kernels[SG] = sg_at_scale(ref, normals, cli_kp, prefix, reps)
    check(all(xyrow_grid(grid)), "the at-scale grid is not an xy-row grid")
    k1 = kernels["shot_binning_histogram"] = k1_own_frames(grid, kp, SCALE_RADIUS, reps)
    k5 = kernels["shot_runs"] = k5_own_frames(grid, kp, SCALE_RADIUS, reps)
    print(f"{prefix} K1 and K5 on leg 3's keypoints (cell {grid.cell_size}, halo 2, window "
          f"{grid.window_cap}, longest xy-row run {xyrow_grid(grid)[1]}): K1 {k1['text']}; K5 "
          f"{k5['text']}", flush=True)
    kernels["spfh_runs"] = k6_rows(grid, SCALE_K6_ROWS, SCALE_RADIUS, reps)
    kp_rows = _sorted_rows(grid, torch.as_tensor(kp_idx_pad, device=dev))
    kernels["radius_dist"] = parity_k7("leg 3's FPFH keypoints", grid,
                                       grid.packed_sorted[kp_rows, :3], SCALE_RADIUS, prefix,
                                       reps)
    # the aggregation at the CLI legs' keypoints, over the SPFH of every
    # point of the grid
    kernels[AGG] = parity_aggregate(
        f"the CLI's keypoints of the ref, voxel {SCALE_CLI_VOXEL}", grid,
        _spfh_window_sorted(grid, SCALE_RADIUS, 5, False), _sorted_rows(grid, cli_kp),
        SCALE_RADIUS, prefix, reps)
    sub = scan_s[torch.as_tensor(grid_subsample(scan_s, SCALE_ICP["voxel_size"]), device=dev)]
    moved = sub @ torch.tensor(r_s.T, dtype=torch.float32, device=dev) + torch.tensor(
        t_s, dtype=torch.float32, device=dev)
    icp_grid = nn_grid(ref, SCALE_ICP["d_max"])
    kernels["nearest"] = parity_nearest("leg 3's ICP", icp_grid, moved, prefix, reps)
    kernels[IS] = parity_icp_step("leg 3's ICP, from the identity", icp_grid, sub, ref, normals,
                                  ident, SCALE_ICP["d_max"], prefix, reps)
    kernels["top2_match"] = k2_sampled(a, b, np.random.default_rng(SCALE_LOWE_SEED + 1), reps)
    for name, r in kernels.items():
        print(f"{prefix} kernel {name}: ms {r['ms']:.4f}, plain {r['plain_ms']:.4f}, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), launches at scale "
              + str({p: c.get(name, 0) for p, c in paths.items()}), flush=True)
    del a, b, grid, ref, normals, scan_s
    torch.cuda.empty_cache()
    vrng = np.random.default_rng(SCALE_SEED + 2)
    for cluster, terrain in SCALE_VOXEL_CASES:
        voxel_sums(dev, vrng, cluster, terrain, prefix, reps)
    return paths


def _radius_sets(nbr, points: np.ndarray, queries: np.ndarray, radius: float):
    """``(each row's in-radius indices, sorted, -1 elsewhere; the same with
    the edge neighbors left out; their number)``: see SURFACE_EDGE_ULPS."""
    idx, mask = nbr.idx.cpu().numpy(), nbr.mask.cpu().numpy()
    p, q = points[idx].astype(np.float64), queries[:, None].astype(np.float64)
    d2 = ((p - q) ** 2).sum(-1)
    unit = SURFACE_EDGE_ULPS * 2.0 ** -24 * ((p ** 2).sum(-1) + (q ** 2).sum(-1))
    edge = mask & (np.abs(d2 - radius * radius) <= unit)
    return (np.sort(np.where(mask, idx, -1), axis=1),
            np.sort(np.where(mask & ~edge, idx, -1), axis=1), int(edge.sum()))


def _parted(a: np.ndarray, b: np.ndarray) -> int:
    """Entries in one row set of ``a`` or ``b`` but not the other."""
    return sum(len(np.setxor1d(x[x >= 0], y[y >= 0])) for x, y in zip(a, b))


def radius_auto_check(points: np.ndarray, queries: np.ndarray, radius: float, dev,
                      label: str) -> dict:
    """``ops.grid_hash.radius_search_auto`` on the card against the same
    call on CPU tensors: on the grid (from AUTO_GRID_MIN_POINTS points) the
    masks and in-radius sets equal (K7 and its twin agree bit for bit), on
    the brute side the sets equal but for edge neighbors; on the grid also
    against the brute ``radius_search`` on the card, the sets equal but for
    edge neighbors.  Returns the card call's launches, wall and counts."""
    import torch

    from shot_fpfh_tpu_torch import _kernels
    from shot_fpfh_tpu_torch.ops import grid_hash
    from shot_fpfh_tpu_torch.ops.neighbors import radius_search

    pts, q = torch.tensor(points, device=dev), torch.tensor(queries, device=dev)
    grid_hash.radius_search_auto(q, pts, radius, SURFACE_K_MAX)     # cold
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    card = grid_hash.radius_search_auto(q, pts, radius, SURFACE_K_MAX)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in _kernels.launch_counts.items() if v}
    on_grid = len(points) >= grid_hash.AUTO_GRID_MIN_POINTS
    check((launches.get(K7, 0) >= 1) == on_grid,
          f"{label}: radius_dist launches {launches.get(K7, 0)} on the "
          f"{'grid' if on_grid else 'brute'} side")
    top = int(card.count.max())
    check(top < SURFACE_K_MAX, f"{label}: a row of {top} neighbors reached the cap")
    sets, inner, edges = _radius_sets(card, points, queries, radius)
    cpu = grid_hash.radius_search_auto(torch.tensor(queries), torch.tensor(points), radius,
                                       SURFACE_K_MAX)
    cpu_sets, cpu_inner, _ = _radius_sets(cpu, points, queries, radius)
    masks_equal = torch.equal(card.mask.cpu(), cpu.mask)
    check(np.array_equal(inner, cpu_inner), f"{label}: in-radius sets differ from the CPU's")
    if on_grid:
        check(masks_equal and np.array_equal(sets, cpu_sets),
              f"{label}: the grid's masks or sets differ from the CPU's")
    out = dict(launches=launches, wall=wall, on_grid=on_grid, top=top, edges=edges,
               mean=float(card.count.float().mean()), masks_equal=masks_equal,
               parted_cpu=_parted(sets, cpu_sets))
    if on_grid:
        brute_sets, brute_inner, _ = _radius_sets(radius_search(q, pts, radius, SURFACE_K_MAX),
                                                  points, queries, radius)
        check(np.array_equal(inner, brute_inner),
              f"{label}: the grid's in-radius sets differ from the brute search's")
        out["parted_brute"] = _parted(sets, brute_sets)
    return out


def near_tied_votes(kp, ref, nbr, frames):
    """``(Q,)`` True where the x or the z axis of ``frames`` won its sign
    vote over the neighborhoods ``nbr`` by at most VOTE_TIE_MARGIN."""
    import torch

    centered = torch.where(nbr.mask[..., None], ref[nbr.idx] - kp[:, None, :], 0.0)
    tied = torch.zeros(kp.shape[0], dtype=torch.bool)
    for j in (0, 2):
        proj = torch.einsum("qki,qi->qk", centered, frames[:, :, j])
        neg, nonneg = ((proj < 0) & nbr.mask).sum(-1), ((proj >= 0) & nbr.mask).sum(-1)
        tied |= (neg - nonneg).abs() <= VOTE_TIE_MARGIN
    return tied


def given_frames_check(ref, normals, kp, radius: float, label: str) -> dict:
    """``compute_shot_descriptor(local_rf_neighborhoods=)`` on the card
    (the frames' neighborhoods from ``radius_search`` on the card): a cold
    call, then one with the launch counts set to 0 just before it and read
    just after; against the same call on CPU tensors, the frames within
    K1_FRAME_ATOL, and the histograms, the CPU given the card's frames
    (which win over the neighborhoods), by the flip rule.  Returns the
    launches, the wall and the errors."""
    import torch

    from shot_fpfh_tpu_torch import _kernels
    from shot_fpfh_tpu_torch.models.shot import compute_shot_descriptor
    from shot_fpfh_tpu_torch.ops.neighbors import Neighborhoods, radius_search

    rf_nbr = radius_search(kp, ref, radius, SURFACE_RF_K)
    compute_shot_descriptor(kp, ref, normals, radius, local_rf_neighborhoods=rf_nbr)   # cold
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    desc, rfs = compute_shot_descriptor(kp, ref, normals, radius, local_rf_neighborhoods=rf_nbr)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in _kernels.launch_counts.items() if v}
    for name in ("shot_binning_histogram", K7):
        check(launches.get(name, 0) >= 1, f"{label} never launched kernel {name}")
    check(desc.shape == (kp.shape[0], 352) and bool(torch.isfinite(desc).all()),
          f"{label}: descriptors {tuple(desc.shape)} or not finite")
    on_cpu = [t.cpu() for t in (kp, ref, normals)]
    rf_cpu = Neighborhoods(*(t.cpu() for t in (rf_nbr.idx, rf_nbr.dist, rf_nbr.mask)))
    _, rfs_c = compute_shot_descriptor(*on_cpu, radius, local_rf_neighborhoods=rf_cpu)
    tied = near_tied_votes(on_cpu[0], on_cpu[1], rf_cpu, rfs_c)
    err = (rfs.cpu() - rfs_c).abs().amax(dim=(1, 2))
    unsigned = (rfs.cpu().abs() - rfs_c.abs()).abs().amax(dim=(1, 2))
    frame_err = float(err[~tied].max())
    tied_err = float(unsigned[tied].max()) if bool(tied.any()) else 0.0
    flipped = int((err > K1_FRAME_ATOL).sum())
    check(frame_err <= K1_FRAME_ATOL and tied_err <= K1_FRAME_ATOL
          and flipped <= VOTE_FLIP_FRAC * kp.shape[0],
          f"{label}: frames off the CPU's by {frame_err} ({int(tied.sum())} keypoints with a "
          f"near-tied sign vote, off by {tied_err} up to the signs; {flipped} flipped)")
    desc_c, kept = compute_shot_descriptor(*on_cpu, radius, local_rfs=rfs.cpu(),
                                           local_rf_neighborhoods=rf_cpu)
    check(torch.equal(kept, rfs.cpu()), f"{label}: given frames did not win on the CPU")
    flip, top = flip_rule(desc.cpu(), desc_c, label)
    live = float((desc.abs().sum(1) > 0).float().mean())
    return dict(launches=launches, wall=wall, frame_err=frame_err, flip=flip, top=top,
                live=live, tied=int(tied.sum()), tied_err=tied_err, flipped=flipped)


def phase_surface(pair: SmokePair, dev) -> dict:
    """Phase 17: the surface the port gained last, on the card against the
    CPU: ``radius_search_auto`` on both sides of AUTO_GRID_MIN_POINTS,
    ``compute_shot_descriptor(local_rf_neighborhoods=)`` on the smoke ref
    (the halo-2 grid through K7, K1 in its given-frames mode) and
    ``RigidTransform.identity`` on ``cuda``.  Returns the SHOT call's
    launches by path."""
    import torch

    from shot_fpfh_tpu_torch.core.transform import RigidTransform
    from shot_fpfh_tpu_torch.models.normals import compute_normals

    t0 = time.perf_counter()
    rng = np.random.default_rng(17)
    for n, radius in SURFACE_CASES:
        points = pair.ref if n == len(pair.ref) else pair.ref[rng.choice(len(pair.ref), n,
                                                                         replace=False)]
        queries = points[rng.choice(n, SURFACE_QUERIES, replace=False)]
        r = radius_auto_check(points, queries, radius, dev, f"phase 17 radius_search_auto {n}")
        print(f"phase 17 radius_search_auto: {n} points ({'grid' if r['on_grid'] else 'brute'}"
              f"), {SURFACE_QUERIES} queries, radius {radius}, k_max {SURFACE_K_MAX}: "
              f"{r['mean']:.1f} neighbors a query (max {r['top']}), {r['edges']} edge "
              f"neighbors; against the CPU masks equal {r['masks_equal']}, entries parted "
              f"{r['parted_cpu']}" + (f"; against the brute search on the card entries parted "
                                      f"{r['parted_brute']}" if r["on_grid"] else "")
              + f" (all edge neighbors); wall {r['wall']:.4f} s, launches {r['launches']}",
              flush=True)
    ref = torch.tensor(pair.ref, device=dev)
    normals = compute_normals(ref, ref, k=30, device=dev)
    kp = ref[torch.tensor(rng.choice(len(pair.ref), SURFACE_KEYPOINTS, replace=False),
                          device=dev)]
    r = given_frames_check(ref, normals, kp, FPFH_RADIUS, "phase 17 given frame neighborhoods")
    ident = RigidTransform.identity(batch_shape=(4,))
    check(ident.rotation.device.type == "cuda" and ident.rotation.shape == (4, 3, 3)
          and torch.equal(ident.rotation.cpu(), torch.eye(3).expand(4, 3, 3))
          and torch.equal(ident.translation.cpu(), torch.zeros(4, 3)),
          "RigidTransform.identity((4,)) is not the identity on cuda")
    print(f"phase 17 compute_shot_descriptor(local_rf_neighborhoods=): {SURFACE_KEYPOINTS} "
          f"keypoints of the {len(pair.ref)}-point ref, radius {FPFH_RADIUS}, frames from "
          f"radius_search's {SURFACE_RF_K} nearest on the card: frames within "
          f"{r['frame_err']:.2e} of the CPU's on the keypoints without a near-tied sign "
          f"vote, {r['tied']} with one ({r['flipped']} with an axis flipped; within "
          f"{r['tied_err']:.2e} up to the signs), histograms under the card's frames flip "
          f"fraction {r['flip']:.2e}, max diff {r['top']:.2e}, {r['live']:.4f} non-empty; "
          f"wall {r['wall']:.4f} s, launches {r['launches']}; RigidTransform.identity((4,)) "
          f"on cuda; phase wall {time.perf_counter() - t0:.3f} s", flush=True)
    return {"given frame neighborhoods": r["launches"]}


def main(argv=None) -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", type=Path, default=None, metavar="DIR",
                        help="profile the main path with torch.profiler; write the "
                             "op table and a chrome trace to DIR")
    parser.add_argument("--bits-against", type=Path, default=None, metavar="LIB",
                        help="hold K1's and K5's phase-3 outputs equal, bit for bit, to those "
                             "of the kernel library LIB (another build of csrc/), and time "
                             "each alone under both builds in turns")
    args = parser.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU", file=sys.stderr)
        return 2
    if not (ROOT / "shot_fpfh_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import shot_fpfh_tpu_torch  # noqa: F401  (sets TF32 off)

    smi = phase_device()
    phase_build()
    from shot_fpfh_tpu_torch import _kernels

    other = None if args.bits_against is None else _kernels.load(args.bits_against)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    terrain = ShotTerrain(dev, rng)
    k1, k5 = parity_k1(terrain, other), parity_k5(terrain, other)
    sg = parity_shot_grid(terrain.grid, terrain.kp, terrain.radius,
                          label="K1's keypoints and grid")["own frames"]
    parity_shot_grid(terrain.bi_grid, terrain.kp, terrain.bi_radius, terrain.rf_radius,
                     label="the bi-scale grid")
    k8 = parity_k8("K1's keypoints and grid", terrain.grid, terrain.kp)
    k8_more = [parity_k8("the bi-scale grid", terrain.bi_grid, terrain.kp)]
    del terrain
    parity_k2(dev, rng, 4096, 352)
    parity_k2(dev, rng, 4096, 352 * N_SCALES, modes=(True,))
    parity_k2(dev, rng, 8192, 125, modes=(True,))
    # K2's later checks draw from a generator of their own, so every other
    # phase-3 input stays as earlier versions of this script made it
    k2_rng = np.random.default_rng(1)
    k2 = parity_k2(dev, k2_rng, MAIN_KEYPOINTS[0], 352, modes=(True,), m=MAIN_KEYPOINTS[1])
    parity_k2_ties(dev, k2_rng)
    time_k2_random_path(dev, k2_rng)
    k3 = parity_k3(dev, rng)
    grid = spfh_terrain(dev, rng)
    k4, k6 = parity_k4(grid), parity_k6(grid)
    spfh_pass = parity_spfh_pass(grid, FPFH_RADIUS, "the smoke terrain")
    k8_more.append(parity_k8("the FPFH chunk", grid, grid.packed_sorted[:8192, :3]))
    del grid
    voxel_sums(dev, rng)
    pair = SmokePair()
    k7, k8_features, nn, is_rec = parity_pair_paths(pair, dev)
    agg = parity_pair_aggregate(pair, dev)
    parity_fused_shapes(pair, dev)
    k8["max_abs_err"] = max(r["max_abs_err"] for r in (k8, k8_features, *k8_more))
    shot = phase_shot_path(pair, args.profile)
    paths = {"SHOT": shot["launches"]}
    paths["FPFH window"], paths["FPFH runs"] = phase_fpfh_path(pair)
    paths.update(phase_multiscale_paths(pair))
    paths["iterative"] = phase_iterative_path(pair)
    paths["PCA features"] = phase_features(pair, dev)
    paths.update(phase_options(pair))
    fused_launches, fused_inputs = phase_fused_paths(pair)
    paths.update(fused_launches)
    print(phase_multiscale_top1(dev), flush=True)
    paths.update(phase_debug_paths(pair, shot))
    print(phase_library_rest(pair, dev), flush=True)
    paths["mesh 1-rank"] = phase_mesh_one_rank(pair)
    paths.update(phase_fused_mesh_one_rank(fused_inputs))
    paths.update(phase_mesh_two_ranks(pair))
    del fused_inputs
    paths.update(phase_at_scale(dev))
    paths.update(phase_surface(pair, dev))
    del pair
    # kernel -> (source, TPU kernel it replaces, parity and timings, the
    # path whose launches the line reports)
    results = {
        "shot_binning_histogram": ("shot_fpfh_tpu_torch/csrc/shot_fused.cu",
                                   "shot_fpfh_tpu/ops/pallas_shot_fused.py:408", k1, "SHOT"),
        SG: ("shot_fpfh_tpu_torch/csrc/shot_grid.cu",
             "shot_fpfh_tpu/ops/pallas_radius.py:467 + pallas_shot_fused.py:408", sg, "SHOT"),
        "top2_match": ("shot_fpfh_tpu_torch/csrc/match.cu",
                       "shot_fpfh_tpu/ops/pallas_match.py:139", k2, "SHOT"),
        "radius_pca": ("shot_fpfh_tpu_torch/csrc/radius_pca.cu",
                       "shot_fpfh_tpu/ops/pallas_radius.py:247", k3, "SHOT"),
        "spfh_histogram": ("shot_fpfh_tpu_torch/csrc/spfh_fused.cu",
                           "shot_fpfh_tpu/ops/pallas_fpfh_fused.py:172", k4, "FPFH window"),
        SPFH_PASS: ("shot_fpfh_tpu_torch/csrc/spfh_grid.cu",
                    "shot_fpfh_tpu/ops/pallas_radius.py:467 + pallas_fpfh_fused.py:172",
                    spfh_pass, "FPFH window"),
        "shot_runs": ("shot_fpfh_tpu_torch/csrc/shot_runs.cu",
                      "shot_fpfh_tpu/ops/pallas_shot_dma.py:164", k5, "bi-scale runs"),
        "spfh_runs": ("shot_fpfh_tpu_torch/csrc/spfh_runs.cu",
                      "shot_fpfh_tpu/ops/pallas_shot_dma.py:337", k6, "FPFH runs"),
        "radius_dist": ("shot_fpfh_tpu_torch/csrc/radius_runs.cu",
                        "shot_fpfh_tpu/ops/pallas_radius.py:497", k7, "iterative"),
        "nearest": ("shot_fpfh_tpu_torch/csrc/nearest.cu",
                    "shot_fpfh_tpu/ops/pallas_radius.py:497", nn, "SHOT"),
        IS: ("shot_fpfh_tpu_torch/csrc/icp_step.cu",
             "none (shot_fpfh_tpu/registration/icp.py _icp_loop's body, XLA)", is_rec, "SHOT"),
        AGG: ("shot_fpfh_tpu_torch/csrc/fpfh_aggregate.cu",
              "shot_fpfh_tpu/ops/pallas_radius.py:497", agg, "FPFH window"),
        "fetch_windows": ("shot_fpfh_tpu_torch/csrc/radius_runs.cu",
                          "shot_fpfh_tpu/ops/pallas_radius.py:467", k8, "iterative"),
    }
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": paths[path][name], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
         "library_ms": r["library_ms"],
         "launches_by_path": {p: counts.get(name, 0) for p, counts in paths.items()}}
        for name, (src, rep, r, path) in results.items()]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
