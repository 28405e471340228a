"""Where a public entry point runs.

The port is written for the GPU: an entry point given host arrays (numpy,
lists) and no ``device`` runs on ``cuda``; a tensor input stays on its own
device; an explicit ``device`` wins.  The CPU is used only when the caller
asks for it (``device="cpu"`` or CPU tensors), so a machine without a card
raises instead of running quietly on the CPU.
"""

from __future__ import annotations

import torch


def resolve(device=None, like=None) -> torch.device:
    """The device of a call: ``device`` when given, else the device of the
    tensor ``like``, else ``cuda``.  Raises when that is a CUDA device and
    no card is present."""
    if device is not None:
        dev = torch.device(device)
    elif isinstance(like, torch.Tensor):
        dev = like.device
    else:
        dev = torch.device("cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU by default; pass "
            "device='cpu' (or CPU tensors) to run on the CPU")
    return dev
