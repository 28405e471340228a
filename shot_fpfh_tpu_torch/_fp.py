"""Fused multiply-add in float32, for exact agreement on distance tests.

XLA:CPU contracts ``x*x + y*y + z*z`` (and ``jnp.linalg.norm`` over 3
components) into the chain ``fma(z, z, fma(y, y, x*x))``, rounding once per
add.  Eager PyTorch rounds every multiply and add on its own, so a squared
distance can differ from the reference's by one ulp, which flips a point on
a radius boundary or a distance tie in voxel subsampling.  :func:`sqnorm3`
evaluates the same chain, correctly rounded like the hardware ``fmaf`` of
the CUDA kernels, so a kernel and its plain twin agree bit for bit.
:func:`div` keeps cell and bin indices exact the same way, and :func:`sqrt`
the distances taken from those squares.

On the CPU, PyTorch evaluates a float32 ``atan2``, ``acos``, ``cos``,
``sin`` or ``pow`` with a vectorized approximation in the body of a tensor
and with the C library in its last few elements, which can part by one ulp:
a row's result then depends on where the row sits in its batch, and a shard
of the rows would not equal the whole.  :func:`atan2`, :func:`acos`,
:func:`cos`, :func:`sin` and :func:`pow` take them in float64 on the CPU and
round once to float32, which gives both code paths the same float32 result;
on the card the float32 functions are used as they are.
"""

from __future__ import annotations

import torch


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` with one float32 rounding.  The product of two float32
    values is exact in float64; the float64 sum is taken rounded to odd
    (its inexact results moved to the odd neighbour), which a float32
    rounding then turns into the correctly rounded result: a plain float64
    sum could land on a float32 midpoint the exact sum misses."""
    p, c = a.double() * b.double(), c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)          # s + err == p + c exactly (TwoSum)
    even = (s.view(torch.int64) & 1) == 0
    away = torch.where(err > 0, torch.full_like(s, float("inf")),
                       torch.full_like(s, float("-inf")))
    return torch.where((err != 0) & even, torch.nextafter(s, away), s).float()


def sqnorm3(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """``x² + y² + z²`` as ``fma(z, z, fma(y, y, x*x))``."""
    return fma(z, z, fma(y, y, x * x))


def div(x: torch.Tensor, scalar: float) -> torch.Tensor:
    """``x / scalar`` as one float32 division on every device.  PyTorch's
    CUDA kernel divides by a Python scalar as a multiply by its reciprocal,
    which can move a value on a cell or bin edge by one ulp; a 0-d tensor
    divisor takes the true division, as on the CPU and in the reference.
    The divisor is filled on the device (``torch.tensor`` would copy it from
    the host and wait for the copy)."""
    return x / torch.full((), scalar, dtype=torch.float32, device=x.device)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Square root of a float32 tensor, correctly rounded on every device.
    PyTorch's vectorized CPU kernel is not (it parts by one ulp from the
    correctly rounded root on ~0.6% of float32 inputs), so on the CPU the
    root is taken in float64 and rounded once to float32, which is exact:
    float64 carries more than twice float32's precision plus two bits.  On
    the card ``torch.sqrt`` is correctly rounded, as the kernels' ``sqrtf``."""
    if x.device.type == "cpu":
        return torch.sqrt(x.double()).to(x.dtype)
    return torch.sqrt(x)


def _f64_on_cpu(fn, *args: torch.Tensor) -> torch.Tensor:
    if args[0].device.type == "cpu":
        return fn(*(a.double() if isinstance(a, torch.Tensor) else a
                    for a in args)).to(args[0].dtype)
    return fn(*args)


def atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``atan2(y, x)``, the same for a row wherever it sits in the tensor."""
    return _f64_on_cpu(torch.atan2, y, x)


def acos(x: torch.Tensor) -> torch.Tensor:
    """``acos(x)``, the same for a row wherever it sits in the tensor."""
    return _f64_on_cpu(torch.acos, x)


def cos(x: torch.Tensor) -> torch.Tensor:
    """``cos(x)``, the same for a row wherever it sits in the tensor."""
    return _f64_on_cpu(torch.cos, x)


def sin(x: torch.Tensor) -> torch.Tensor:
    """``sin(x)``, the same for a row wherever it sits in the tensor."""
    return _f64_on_cpu(torch.sin, x)


def pow(x: torch.Tensor, e) -> torch.Tensor:
    """``x ** e``, the same for a row wherever it sits in the tensor."""
    return _f64_on_cpu(torch.pow, x, e)
