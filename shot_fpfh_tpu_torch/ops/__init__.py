from .eigh3 import eigh3x3, pca_eigh
from .grid_hash import AUTO_GRID_MIN_POINTS, HashGrid, build_grid, window_distances
from .match import top2_match, top2_match_plain
from .neighbors import Neighborhoods, knn, nearest_neighbor, radius_count, radius_search
from .radius_pca import radius_pca, radius_pca_plain
from .shot_dma import (
    shot_descriptor_dma,
    shot_descriptor_dma_plain,
    spfh_block_dma,
    spfh_block_dma_plain,
    spfh_sorted_dma,
)
from .shot_fused import shot_binning_histogram, shot_binning_histogram_plain
from .spfh_fused import spfh_histogram, spfh_histogram_plain

__all__ = [
    "eigh3x3",
    "pca_eigh",
    "AUTO_GRID_MIN_POINTS",
    "HashGrid",
    "build_grid",
    "window_distances",
    "top2_match",
    "top2_match_plain",
    "Neighborhoods",
    "knn",
    "nearest_neighbor",
    "radius_count",
    "radius_search",
    "radius_pca",
    "radius_pca_plain",
    "shot_binning_histogram",
    "shot_binning_histogram_plain",
    "shot_descriptor_dma",
    "shot_descriptor_dma_plain",
    "spfh_block_dma",
    "spfh_block_dma_plain",
    "spfh_sorted_dma",
    "spfh_histogram",
    "spfh_histogram_plain",
]
