"""NaN checks of debug runs: the counterpart of ``jax_debug_nans`` (the
CLI's ``--debug_nans``).

While a :class:`NanCheck` mode is active, every torch call whose floating
tensor output holds a NaN raises ``FloatingPointError("invalid value (nan)
encountered in <op>")`` at that call.  This is stricter than JAX, which
checks each jitted program's outputs and localizes the op only when an
output holds a NaN: here every op is checked, so a NaN that a later op
would have masked away still raises.  Each check reads a flag back from
the device, so a checked run is slow.

Not checked:

- the allocation ops (``torch.empty``, ``empty_like``, ``new_empty``,
  ``empty_strided``), whose outputs are uninitialized and may hold NaN bit
  patterns on the card;
- an output that is one of the call's own tensor arguments, unless the op
  works in place (``x.to(x.dtype)`` and ``x.contiguous()`` return ``x``
  itself and compute nothing).

The CUDA kernels launch through ``ctypes``, which no mode sees, so each
kernel wrapper hands its operands and outputs to :func:`check_kernel`,
which names the kernel.
"""

from __future__ import annotations

import torch
from torch.overrides import TorchFunctionMode

_ALLOCATIONS = frozenset({"empty", "empty_like", "new_empty", "empty_strided"})

# NanCheck modes entered and not yet left
_active: list["NanCheck"] = []


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (tuple, list)):
        for item in x:
            yield from _tensors(item)


def _has_nan(t: torch.Tensor) -> bool:
    return t.is_floating_point() and t.numel() > 0 and bool(torch.isnan(t).any())


class NanCheck(TorchFunctionMode):
    """Context manager: raise ``FloatingPointError`` at the first torch call
    that returns a NaN (see the module docstring)."""

    def __enter__(self):
        _active.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _active.remove(self)
        return super().__exit__(*exc)

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = getattr(func, "__name__", str(func))
        if name not in _ALLOCATIONS:
            own = [] if name.endswith("_") else [id(a) for a in _tensors(args)]
            for t in _tensors(out):
                if id(t) not in own and _has_nan(t):
                    raise FloatingPointError(f"invalid value (nan) encountered in {name}")
        return out


def check_kernel(name: str, tensors) -> None:
    """Under a :class:`NanCheck` mode, raise if a floating tensor among a
    kernel's operands and outputs holds a NaN."""
    if _active and any(_has_nan(t) for t in _tensors(tensors)):
        raise FloatingPointError(f"invalid value (nan) encountered in CUDA kernel {name}")
