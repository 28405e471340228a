"""Multi-device registration over a ``torch.distributed`` mesh — port of
``shot_fpfh_tpu.parallel``: the mesh (``mesh.py``), the sharded stages
(``sharded.py``) and the multi-process entry point and its helpers
(``multihost.py``)."""

from .mesh import POINTS_AXIS, make_mesh, pad_to_multiple, replicate, shard_rows
from .multihost import (
    global_keypoint_array,
    host_local_keypoint_shard,
    initialize_distributed,
    scaling_report,
)
from .sharded import (
    RingMatchResult,
    ring_match,
    sharded_fpfh,
    sharded_icp,
    sharded_normals,
    sharded_ransac,
    sharded_shot_descriptors,
)

__all__ = [
    "global_keypoint_array",
    "host_local_keypoint_shard",
    "initialize_distributed",
    "scaling_report",
    "POINTS_AXIS",
    "make_mesh",
    "pad_to_multiple",
    "replicate",
    "shard_rows",
    "RingMatchResult",
    "ring_match",
    "sharded_fpfh",
    "sharded_icp",
    "sharded_normals",
    "sharded_ransac",
    "sharded_shot_descriptors",
]
