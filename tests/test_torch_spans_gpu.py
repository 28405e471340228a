"""The program's spans on the card: every statement of the staged path that
synchronises passes a counted ``blocking`` site, and a traced benchmark run
of each cell reads the metrics that read those spans.

Marked ``gpu``: each test skips without a CUDA device (decided inside the
fixture).  Run them on a GPU machine from the repository's root with
``python -m pytest --noconftest -m gpu tests/test_torch_spans_gpu.py -q -p
no:cacheprovider`` (the suite's ``conftest.py`` imports JAX; this file needs
only torch).
"""

import json
import subprocess
import sys
import warnings
from collections import Counter
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
from regbench import generator  # noqa: E402
from regbench.cells import load_cell  # noqa: E402
from shot_fpfh_tpu_torch.utils import perf  # noqa: E402

pytestmark = pytest.mark.gpu

WORKLOADS = ("shot1m.dense", "fpfh1m.dense", "shot1m.biscale", "shot1m.sparse")
# a tenth of a cell's points at its density: every route the cell takes
SMOKE = {"points": 100_000, "extent": 6.3}
SEED = 2147483990


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _register(pair, cfg, traffic, device, metrics):
    """The staged path as the benchmark drives it, every stage recorded
    into ``metrics`` (the post-ICP evaluation in a stage of its own)."""
    from shot_fpfh_tpu_torch.configuration import RegistrationEvaluationConfig
    from shot_fpfh_tpu_torch.models.normals import compute_normals
    from shot_fpfh_tpu_torch.pipeline import RegistrationPipeline

    kp_cfg, desc, match = traffic["keypoint_selection"], cfg["descriptor"], cfg["matching"]
    ransac, icp, comp = cfg["ransac"], cfg["icp"], cfg["compute"]
    k = int(cfg["normals"]["k"])
    scan_n = compute_normals(pair.scan, pair.scan, k=k, device=device, metrics=metrics)
    ref_n = compute_normals(pair.ref, pair.ref, k=k, device=device, metrics=metrics)
    scan_n, ref_n = scan_n.cpu().numpy(), ref_n.cpu().numpy()
    pipe = RegistrationPipeline(scan=pair.scan, scan_normals=scan_n, ref=pair.ref,
                                ref_normals=ref_n, k_max_descriptor=comp["k_max_descriptor"],
                                k_max_fpfh=comp["k_max_fpfh"], metrics=metrics, device=device)
    pipe.select_keypoints(kp_cfg["selection_algorithm"],
                          neighborhood_size=kp_cfg["neighborhood_size"],
                          min_n_neighbors=kp_cfg["min_n_neighbors"])
    pipe.compute_descriptors(**desc)
    pipe.find_descriptors_matches(match["matching_algorithm"])
    tf, _ = pipe.run_ransac(n_draws=ransac["n_draws"], draw_size=ransac["draw_size"],
                            max_inliers_distance=ransac["max_inliers_distance"],
                            seed=ransac["seed"])
    tf, _, _ = pipe.run_icp(icp["icp_type"], transformation_init=tf, d_max=icp["d_max"],
                            voxel_size=icp["voxel_size"], max_iter=icp["max_iter"],
                            rms_threshold=icp["rms_threshold"])
    evaluation = RegistrationEvaluationConfig(**cfg["registration_evaluation"])
    metrics.start("evaluation")
    pipe.compute_metrics_post_icp(tf, evaluation.distance_to_map_threshold)
    metrics.stop()


@pytest.mark.parametrize("workload", WORKLOADS)
def test_every_synchronising_statement_passes_a_counted_site(cuda, workload):
    """Under ``set_sync_debug_mode("warn")`` the warnings raised while a
    stage is open equal the stages' ``host_syncs`` less their own
    synchronizes (``torch.cuda.synchronize`` raises none)."""
    cell = load_cell(workload)
    traffic = dict(cell.traffic, **SMOKE)
    pair = generator.make_pair(traffic, SEED, 0, cuda)
    _register(pair, cell.config, traffic, cuda, perf.StageMetrics())      # warm-up
    torch.cuda.synchronize()
    metrics = perf.StageMetrics()
    inside, outside = Counter(), Counter()

    def show(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing" in str(message):
            staged = perf._OPEN_STAGE.get() is not None
            (inside if staged else outside)[f"{Path(filename).name}:{lineno}"] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            _register(pair, cell.config, traffic, cuda, metrics)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    waits = sum(s["host_syncs"] - s["spans"]["sync[stage]"]["count"] for s in metrics.stages)
    by_stage = {s["stage"]: s["host_syncs"] for s in metrics.stages}
    assert sum(inside.values()) == waits, (dict(inside), by_stage)
    # outside the stages: the copies of the normals to the host alone
    assert sum(outside.values()) == 2, dict(outside)
    icp = next(s for s in metrics.stages if s["stage"].startswith("icp["))
    assert icp["spans"]["sync[icp.done]"]["count"] == -(-icp["iterations"] // 8)
    # every issued ICP iteration is one launch of IS (csrc/icp_step.cu)
    issued = min(int(cell.config["icp"]["max_iter"]), -(-icp["iterations"] // 8) * 8)
    assert icp["icp_kernel_iters"] == issued


@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_traced_run_reads_the_span_metrics(cuda, workload):
    proc = subprocess.run([sys.executable, "regbench/run.py", "--workload", workload,
                           "--seed", str(SEED + 1), "--seconds", "3", "--trace", "1"],
                          cwd=REPO, capture_output=True, text=True, timeout=420)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    for name in ("normals_stage_ms", "host_syncs_per_pair", "sync_idle_ms",
                 "match_roofline_pct", "descriptors_idle_ms", "descriptor_launches_per_pair"):
        assert isinstance(line["metrics"][name]["value"], float), name
