"""The plain reference the benchmark holds the program to: plain PyTorch
(no kernel, no grid, nothing imported from the program), computed from the
same generated clouds.  ``common`` holds what every configuration shares;
each descriptor has a module named after the configuration's
``reference`` key (``shot_single_scale``, ``fpfh``) with a
``descriptors(cloud, normals, keypoint_idx, cfg, dtype)`` function."""

from __future__ import annotations

import importlib


def descriptor_module(name: str):
    """The reference module of the configuration's ``reference`` key."""
    return importlib.import_module(f"{__name__}.{name}")
