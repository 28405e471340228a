from .fpfh import compute_fpfh_descriptor, compute_spfh
from .normals import compute_normals
from .shot import ShotComputer, compute_shot_descriptor

__all__ = ["compute_fpfh_descriptor", "compute_spfh", "compute_normals", "ShotComputer",
           "compute_shot_descriptor"]
