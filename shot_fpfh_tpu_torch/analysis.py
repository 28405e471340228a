"""Ground-truth match analysis — port of ``shot_fpfh_tpu.analysis``.

Given the exact scan→ref transform (a Stanford ``.conf`` file), count the
matches that land away from their true partner and split the Lowe ratios
of the nearest descriptors into correct and incorrect matches.  The plot
helpers return their histogram data and draw the figure only where
matplotlib imports (headless: the ``Agg`` backend).  Each function runs on
``device`` (default: where a tensor input lies, else ``cuda``); the
results are host arrays.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ._device import resolve
from .core.transform import RigidTransform
from .io.ground_truth import nn_distance_histogram
from .ops.neighbors import as_f32, nearest_neighbor
from .registration.matching import top2_descriptor

logger = logging.getLogger(__name__)

# a match is correct when the exactly moved scan point lies within this
# distance of its matched ref point (reference matches_analysis.py:14-32)
CORRECT_MATCH_DISTANCE = 1e-2


def _moved(scan, exact_transformation: RigidTransform, device) -> torch.Tensor:
    dev = resolve(device, scan)
    return exact_transformation.to(dev).apply(as_f32(scan, dev))


def get_incorrect_matches(scan, ref, exact_transformation: RigidTransform,
                          device=None) -> np.ndarray:
    """Per matched pair (row i of ``scan`` matched to row i of ``ref``):
    True when the exactly moved scan point is farther than 1e-2 from its
    ref point."""
    moved = _moved(scan, exact_transformation, device)
    ref_t = as_f32(ref, moved.device)
    return (torch.linalg.norm(moved - ref_t, dim=1) > CORRECT_MATCH_DISTANCE).cpu().numpy()


def lowe_ratio_split(scan, ref, exact_transformation: RigidTransform, scan_descriptors,
                     ref_descriptors, device=None) -> tuple[np.ndarray, np.ndarray]:
    """``(correct_ratios, incorrect_ratios)``: the ratio d1/d2 of each scan
    descriptor's nearest and second-nearest ref descriptors (1 where d2 is
    0), split by whether the nearest is the true partner: the ref point
    nearest to the exactly moved scan point, within 1e-2 (reference
    matches_analysis.py:35-88)."""
    moved = _moved(scan, exact_transformation, device)
    dist_points, idx_points = nearest_neighbor(moved, as_f32(ref, moved.device))
    b = as_f32(ref_descriptors, moved.device)
    idx1, d1, d2 = top2_descriptor(as_f32(scan_descriptors, moved.device), b,
                                   torch.ones(b.shape[0], dtype=torch.bool, device=b.device))
    correct = (idx1 == idx_points) & (dist_points < CORRECT_MATCH_DISTANCE)
    ratios = torch.where(d2 > 0, d1 / torch.where(d2 > 0, d2, torch.ones_like(d2)),
                         torch.ones_like(d1))
    ratios, correct = ratios.cpu().numpy(), correct.cpu().numpy()
    return ratios[correct], ratios[~correct]


def _pyplot():
    """matplotlib's pyplot on the headless backend, or None without it."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        from matplotlib import pyplot as plt
    except ImportError:
        return None
    return plt


def check_transform(scan, ref, transformation: RigidTransform, bins: int = 100,
                    output_path: str = "check_transform.png", device=None):
    """Histogram of the scan's 1-NN distances to the ref under a candidate
    transform (reference ``check_transform``, ground_truth_retrieval.py:
    51-61): returns ``(counts, edges)`` and draws it to ``output_path``."""
    counts, edges = nn_distance_histogram(scan, ref, transformation, bins, device=device)
    plt = _pyplot()
    if plt is not None:
        plt.hist(edges[:-1], bins=edges, weights=counts)
        plt.savefig(output_path)
        plt.close()
    return counts, edges


def plot_distance_hists(scan, ref, exact_transformation: RigidTransform, scan_descriptors,
                        ref_descriptors, output_path: str = "distance_hists.png",
                        device=None):
    """The ratio histograms of :func:`lowe_ratio_split`, correct and
    incorrect matches side by side; returns the two ratio arrays."""
    correct, incorrect = lowe_ratio_split(scan, ref, exact_transformation, scan_descriptors,
                                          ref_descriptors, device=device)
    plt = _pyplot()
    if plt is None:
        return correct, incorrect
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(16, 8))
    ax1.hist(correct, bins=50, label="Correct matches")
    ax2.hist(incorrect, bins=50, label="Incorrect matches")
    for ax in (ax1, ax2):
        ax.legend()
        ax.set(title="Ratio between the nearest neighbor and the second nearest one")
    fig.savefig(output_path)
    plt.close(fig)
    return correct, incorrect


def plot_neighborhood_sizes(sizes, output_path: str = "neighborhood_sizes.png"):
    """Logs the mean, std, min and max neighborhood size and draws their
    histogram (reference ``compute_pca_based_features``' inline plot,
    pca_based_descriptors.py:105-119); returns ``(counts, edges)``."""
    sizes = (sizes.cpu().numpy() if isinstance(sizes, torch.Tensor)
             else np.asarray(sizes)).reshape(-1)
    logger.info("Average size of neighborhoods: %.4f (std %.4f, min %d, max %d)",
                float(np.mean(sizes)), float(np.std(sizes)), int(np.min(sizes)),
                int(np.max(sizes)))
    counts, edges = np.histogram(sizes, bins="auto")
    plt = _pyplot()
    if plt is None:
        return counts, edges
    plt.hist(edges[:-1], bins=edges, weights=counts)
    plt.title(f"Histogram of the neighborhood sizes for {len(counts)} bins")
    plt.xlabel("Neighborhood size")
    plt.ylabel("Number of neighborhoods")
    plt.savefig(output_path)
    plt.close()
    return counts, edges
