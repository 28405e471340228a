from .normals import compute_normals
from .shot import ShotComputer, compute_shot_descriptor

__all__ = ["compute_normals", "ShotComputer", "compute_shot_descriptor"]
