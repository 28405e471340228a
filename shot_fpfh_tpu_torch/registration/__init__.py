from .icp import (
    IcpHostResult,
    IcpResult,
    icp_point_to_plane,
    icp_point_to_point,
    icp_point_to_point_with_sampling,
)
from .matching import (
    basic_matching,
    descriptor_sq_dists,
    double_matching_with_rejects,
    left_median_filter,
    lowe_matching,
    match_descriptors,
    multiscale_top1,
    nearest_descriptor,
    quantile_filter,
    threshold_filter,
    top2_descriptor,
)
from .ransac import ransac_on_matches

__all__ = [
    "IcpHostResult",
    "IcpResult",
    "icp_point_to_plane",
    "icp_point_to_point",
    "icp_point_to_point_with_sampling",
    "basic_matching",
    "descriptor_sq_dists",
    "double_matching_with_rejects",
    "left_median_filter",
    "lowe_matching",
    "match_descriptors",
    "multiscale_top1",
    "nearest_descriptor",
    "quantile_filter",
    "threshold_filter",
    "top2_descriptor",
    "ransac_on_matches",
]
