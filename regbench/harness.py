"""The benchmark of ``shot_fpfh_tpu_torch`` on NVIDIA GPUs: one cell of
``BENCHMARK.json`` a run.

A run builds the cell's pool of scan/ref pairs from ``--seed`` (the
traffic mix, ``traffic/<name>.json``), registers one warm pair, then
registers pairs one after another for ``--seconds`` (a closed loop: one
client), each through a fresh ``RegistrationPipeline`` driven as the CLI's
staged path drives it (normals, keypoints, descriptors, matching, RANSAC,
ICP, the post-ICP evaluation; no ``.ply`` reads or writes).  A pair's time
runs from the handover of its clouds to its evaluation.  After the window
it checks the outputs (``compare``) and prints one JSON line: the registrations of every pair are held to the motions
that made them, and the last one of each pool pair to the reference.
``--trace 1`` adds a profiled stretch of one pool's worth
of pairs after the window and reports the per-layer metrics
(``metrics/<name>.py``) instead of the end-to-end ones.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import logging
import sys
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from . import compare, generator
from .cells import load_cell
from .trace import Trace

# whole top-level module names the run may not hold once its window closes
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "shot_fpfh_tpu")
TRACE_RANGE = "regbench.traced"


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return parser.parse_args(argv)


def forbidden_loaded() -> list[str]:
    """Loaded modules whose whole top-level name is forbidden."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN_MODULES})


@dataclass
class PairRecord:
    """One registered pair: its time, stage seconds and sizes."""

    pair_s: float
    normals_s: float
    stages: dict[str, float]
    icp_iters: int
    accepted: bool
    shapes: dict[str, int] = field(default_factory=dict)


@dataclass
class RunData:
    """What a metric reader reads: the window's pairs, the cell, and the
    profiled stretch (``trace`` and its ``traced`` pairs) of a --trace 1 run."""

    pairs: list[PairRecord]
    config: dict
    traffic: dict
    trace: object = None
    traced: list[PairRecord] = field(default_factory=list)


def stage_key(stage: str) -> str:
    """``descriptors[fpfh]`` → ``descriptors``."""
    return stage.split("[", 1)[0]


def register_pair(pair, cfg: dict, traffic: dict, device, shapes: bool = False):
    """Register one pair as the CLI's staged path does; returns the
    ``PairRecord`` (with the match's sizes when ``shapes``, read after the
    pair's time) and the ``PairOutputs``."""
    from shot_fpfh_tpu_torch.configuration import RegistrationEvaluationConfig
    from shot_fpfh_tpu_torch.models.normals import compute_normals
    from shot_fpfh_tpu_torch.pipeline import RegistrationPipeline

    kp_cfg, desc, match = traffic["keypoint_selection"], cfg["descriptor"], cfg["matching"]
    ransac, icp, comp = cfg["ransac"], cfg["icp"], cfg["compute"]
    k = int(cfg["normals"]["k"])
    t0 = time.perf_counter()
    with torch.profiler.record_function("normals"):
        scan_n = compute_normals(pair.scan, pair.scan, k=k, device=device).cpu().numpy()
        ref_n = compute_normals(pair.ref, pair.ref, k=k, device=device).cpu().numpy()
    normals_s = time.perf_counter() - t0
    pipe = RegistrationPipeline(scan=pair.scan, scan_normals=scan_n, ref=pair.ref,
                                ref_normals=ref_n, k_max_descriptor=comp["k_max_descriptor"],
                                k_max_fpfh=comp["k_max_fpfh"], device=device)
    pipe.select_keypoints(kp_cfg["selection_algorithm"],
                          neighborhood_size=kp_cfg["neighborhood_size"],
                          min_n_neighbors=kp_cfg["min_n_neighbors"])
    pipe.compute_descriptors(**desc)
    pipe.find_descriptors_matches(match["matching_algorithm"],
                                  reject_threshold=match["reject_threshold"],
                                  threshold_multiplier=match["threshold_multiplier"])
    tf_ransac, _ = pipe.run_ransac(n_draws=ransac["n_draws"], draw_size=ransac["draw_size"],
                                   max_inliers_distance=ransac["max_inliers_distance"],
                                   seed=ransac["seed"])
    tf_icp, rms, _ = pipe.run_icp(icp["icp_type"], transformation_init=tf_ransac,
                                  d_max=icp["d_max"], voxel_size=icp["voxel_size"],
                                  max_iter=icp["max_iter"], rms_threshold=icp["rms_threshold"])
    evaluation = RegistrationEvaluationConfig(**cfg["registration_evaluation"])
    overlap, inliers = pipe.compute_metrics_post_icp(
        tf_icp, evaluation.distance_to_map_threshold)
    accepted = evaluation.eval_registration(overlap=overlap, distance_to_map=rms,
                                            inliers=inliers)
    pair_s = time.perf_counter() - t0

    stages = {stage_key(s["stage"]): s["seconds"] for s in pipe.metrics.stages}
    icp_iters = next(int(s["iterations"]) for s in pipe.metrics.stages
                     if stage_key(s["stage"]) == "icp")
    record = PairRecord(pair_s=pair_s, normals_s=normals_s, stages=stages,
                        icp_iters=icp_iters, accepted=bool(accepted))
    if shapes:
        record.shapes = dict(
            scan_nz=int(((pipe.scan_descriptors != 0).any(dim=1)).sum()),
            ref_nz=int(((pipe.ref_descriptors != 0).any(dim=1)).sum()),
            dim=int(pipe.scan_descriptors.shape[1]))
    outputs = compare.PairOutputs(
        scan=pair.scan, ref=pair.ref, rotation=pair.rotation, translation=pair.translation,
        scan_normals=scan_n, ref_normals=ref_n,
        scan_keypoints=np.asarray(pipe.scan_keypoints),
        ref_keypoints=np.asarray(pipe.ref_keypoints),
        scan_descriptors=pipe.scan_descriptors, ref_descriptors=pipe.ref_descriptors,
        matches=pipe.matches, ransac=(tf_ransac.rotation, tf_ransac.translation),
        icp=(tf_icp.rotation, tf_icp.translation), overlap=overlap, inliers=inliers)
    return record, outputs


def end_to_end(pair_times: list[float], window_s: float, setup_s: float) -> dict[str, float]:
    """The end-to-end metrics: every pair completed in the window over all
    of the window's time, the 90th percentile of every pair's time (linear
    between order statistics), and the set-up time."""
    return {"pairs_per_s": len(pair_times) / window_s,
            "pair_p90_s": float(np.percentile(np.asarray(pair_times, np.float64), 90)),
            "setup_s": setup_s}


def read_metrics(specs: list[dict], data: RunData) -> dict[str, dict]:
    """Each per-layer metric from its reader ``metrics/<name>.py``; a
    reader that finds nothing returns None and the metric is left out."""
    out = {}
    for spec in specs:
        reader = importlib.import_module(f"{__package__}.metrics.{spec['name']}")
        value = reader.read(data)
        if value is not None:
            out[spec["name"]] = {"value": float(value), "unit": spec["unit"]}
    return out


def _fail(message: str, code: int = 2) -> int:
    print(f"regbench: {message}", file=sys.stderr, flush=True)
    return code


def main(argv=None, *, t_start: float | None = None, require_cuda: bool = True) -> int:
    """Run one cell; returns the exit code.  ``require_cuda=False`` lets a
    test drive a run on the CPU (no result is a device measurement then)."""
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse_args(argv)
    cell = load_cell(args.workload)
    cfg, traffic = cell.config, cell.traffic
    from shot_fpfh_tpu_torch import _kernels, pipeline  # noqa: F401

    t_import = time.perf_counter()
    logging.getLogger().setLevel(logging.WARNING)
    threads = cfg["threads"]
    torch.set_num_threads(int(threads["torch_intra_op"]))
    if torch.get_num_interop_threads() != int(threads["torch_inter_op"]):
        torch.set_num_interop_threads(int(threads["torch_inter_op"]))

    if require_cuda:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            return _fail(f"needs {cell.chips} CUDA device(s); "
                         f"torch.cuda.is_available()={torch.cuda.is_available()}")
        device = torch.device("cuda", 0)
        torch.cuda.init()
        torch.empty(1, device=device)
        torch.cuda.synchronize()
    else:
        device = torch.device("cpu")
    t_cuda = time.perf_counter()
    if device.type == "cuda":
        _kernels.library()
    t_lib = time.perf_counter()
    pool = generator.make_pool(traffic, args.seed, device)
    t_pool = time.perf_counter()
    register_pair(pool[0], cfg, traffic, device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    t_warm = time.perf_counter()

    gc.collect()
    gc.freeze()
    records, truths, last = [], [], {}
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    i = 0
    while time.perf_counter() - t0 < args.seconds:
        pair = pool[i % len(pool)]
        record, outputs = register_pair(pair, cfg, traffic, device)
        records.append(record)
        truths.append((outputs.icp[0], outputs.icp[1], pair.rotation, pair.translation))
        last[i % len(pool)] = outputs
        del outputs
        i += 1
    window_s = time.perf_counter() - t0
    gc.unfreeze()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    trace, traced = None, []
    if args.trace:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=activities) as prof:
            with torch.profiler.record_function(TRACE_RANGE):
                for pair in pool:
                    traced.append(register_pair(pair, cfg, traffic, device, shapes=True)[0])
        trace = Trace.from_profile(prof, TRACE_RANGE)

    del pool
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    readings = compare.program_readings(last, truths, cfg, traffic, args.seed, device)
    del last
    correct, rows = compare.verdict(readings, cfg["limits"])
    failed = compare.truth_failures(truths, cfg["limits"])
    check_s = time.perf_counter() - t_check

    pair_times = [r.pair_s for r in records]
    data = RunData(pairs=records, config=cfg, traffic=traffic, trace=trace, traced=traced)
    if args.trace:
        metrics = read_metrics(cell.per_layer, data)
    else:
        values = end_to_end(pair_times, window_s, setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct and failed == 0), "attempted": len(records),
              "failed": failed, "metrics": metrics, "device": dev}
    if trace is not None:
        dev.update(busy_s=trace.busy_s, window_s=trace.window_s)
        result["breakdown"] = {"device_ops": trace.top_device_ops(),
                               "idle_gaps": trace.idle_gaps()}
    result["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in rows}

    print("regbench setup: " + json.dumps({
        "import_s": t_import - t_start, "cuda_init_s": t_cuda - t_import,
        "kernel_library_s": t_lib - t_cuda, "pool_s": t_pool - t_lib,
        "warm_pair_s": t_warm - t_pool, "setup_s": setup_s, "window_s": window_s,
        "pairs": len(records), "check_s": check_s}), file=sys.stderr)
    print("regbench registrations: " + json.dumps({
        "rejected_by_the_evaluation": sum(not r.accepted for r in records),
        "off_the_truth_limits": failed}), file=sys.stderr)
    found = forbidden_loaded()
    if found:
        return _fail(f"the run loaded {', '.join(found)}", 3)
    for name, value, limit in rows:
        print(f"regbench check {name}: {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
