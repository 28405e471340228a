"""CPU cost of the port's float64 transcendentals.

On the CPU, ``shot_fpfh_tpu_torch._fp.atan2``, ``acos``, ``cos``, ``sin``
and ``pow`` evaluate in float64 and round once to float32, so a row's
result does not depend on where the row sits in its batch (PyTorch's
vectorized float32 body and its scalar tail part by an ulp), and a shard of
the rows equals the whole.  This script times the CPU stages that call
them, as they are and with PyTorch's float32 functions swapped back in, on
one thread, and prints the medians in milliseconds.  On the card the
float32 functions run either way.

    python tools/cpu_fp_cost.py [--repeats 5] [--threads 1]
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from shot_fpfh_tpu_torch import _fp  # noqa: E402
from shot_fpfh_tpu_torch.models.fpfh import compute_fpfh_descriptor  # noqa: E402
from shot_fpfh_tpu_torch.models.normals import compute_normals  # noqa: E402
from shot_fpfh_tpu_torch.models.shot import compute_shot_descriptor  # noqa: E402
from shot_fpfh_tpu_torch.ops import descriptor_bins, eigh3, shot_fused  # noqa: E402

# (module, name) of every binding of a wrapper, and PyTorch's float32 function
_SWAPS = [(descriptor_bins, "atan2", torch.atan2), (eigh3, "atan2", torch.atan2),
          (eigh3, "cos", torch.cos), (eigh3, "sin", torch.sin),
          (shot_fused, "atan2", torch.atan2), (shot_fused, "acos", torch.acos),
          (_fp, "pow", torch.pow)]


def _terrain(n, rng, scale):
    xy = rng.uniform(-scale, scale, size=(n, 2))
    z = 0.4 * np.sin(xy[:, 0]) * np.cos(0.7 * xy[:, 1])
    return np.column_stack([xy, z]).astype(np.float32)


def _unit(rng, n):
    v = rng.normal(size=(n, 3)) * [0.3, 0.3, 1.0]
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def _stages(rng):
    sup, sup_n = _terrain(1500, rng, 2.0), _unit(rng, 1500)
    kp = sup[rng.choice(1500, 500, replace=False)]
    pts, pts_n = _terrain(3000, rng, 3.0), _unit(rng, 3000)
    big = _terrain(25_000, rng, 8.0)
    a = torch.as_tensor(rng.normal(size=(200_000, 3, 3)).astype(np.float32))
    cov = a @ a.transpose(1, 2)
    x = torch.as_tensor(rng.uniform(-1, 1, size=1_000_000).astype(np.float32))
    return {
        "atan2, 1M elements": lambda: descriptor_bins.atan2(x, x.flip(0)),
        "eigh3x3, 200k matrices": lambda: eigh3.eigh3x3(cov),
        "SHOT brute, 500 keypoints on 1,500 points": lambda: compute_shot_descriptor(
            kp, sup, sup_n, 0.5, k_max=128, min_neighborhood_size=5, device="cpu"),
        "FPFH brute, 300 keypoints on 3,000 points": lambda: compute_fpfh_descriptor(
            np.arange(0, 3000, 10), pts, pts_n, 0.4, k_max=64, device="cpu"),
        "k-NN normals (k 20), 25,000 points (streaming route)": lambda: compute_normals(
            big, big, k=20, device="cpu"),
    }


def _median_ms(fn, repeats):
    fn()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--repeats", type=int, default=5)
    parser.add_argument("--threads", type=int, default=1)
    args = parser.parse_args(argv)
    torch.set_num_threads(args.threads)
    stages = _stages(np.random.default_rng(0))
    saved = [getattr(mod, name) for mod, name, _ in _SWAPS]
    rows = []
    for label, fn in stages.items():
        f64 = _median_ms(fn, args.repeats)
        for mod, name, f32 in _SWAPS:
            setattr(mod, name, f32)
        try:
            f32_ms = _median_ms(fn, args.repeats)
        finally:
            for (mod, name, _), orig in zip(_SWAPS, saved):
                setattr(mod, name, orig)
        rows.append((label, f64, f32_ms))
    print(f"CPU, {args.threads} thread(s), median of {args.repeats}; torch {torch.__version__}")
    for label, f64, f32_ms in rows:
        print(f"{label}: float64 wrappers {f64:.1f} ms, float32 functions {f32_ms:.1f} ms "
              f"({f64 / f32_ms:.2f}x)")


if __name__ == "__main__":
    main()
