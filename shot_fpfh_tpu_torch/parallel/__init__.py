"""Multi-device registration over a ``torch.distributed`` mesh — port of
``shot_fpfh_tpu.parallel``: the mesh (``mesh.py``) and the sharded stages
(``sharded.py``).  JAX's multi-host helpers (``multihost.py``) are not
ported yet (ROADMAP.md, Queue 1, item 14, step 5)."""

from .mesh import POINTS_AXIS, make_mesh, pad_to_multiple, replicate, shard_rows
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
