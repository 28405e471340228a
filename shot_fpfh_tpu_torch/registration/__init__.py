from .icp import IcpHostResult, IcpResult, icp_point_to_plane, icp_point_to_point
from .matching import basic_matching, lowe_matching, nearest_descriptor, top2_descriptor
from .ransac import ransac_on_matches

__all__ = [
    "IcpHostResult",
    "IcpResult",
    "icp_point_to_plane",
    "icp_point_to_point",
    "basic_matching",
    "lowe_matching",
    "nearest_descriptor",
    "top2_descriptor",
    "ransac_on_matches",
]
