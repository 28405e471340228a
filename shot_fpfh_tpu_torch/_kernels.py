"""Build, load and count the hand-written CUDA kernels in ``csrc/``.

Each source is compiled by its own ``nvcc`` process, all started together,
and the objects are linked into one shared library with a plain C interface
(no PyTorch headers, so a build takes seconds) that is loaded with
``ctypes``.  In a checkout or an editable install the library lands in the
repository's ``build/kernels/<hash>/``; a regular install (sources shipped
as package data) builds into the user's cache directory instead
(``$XDG_CACHE_HOME`` or ``~/.cache``, then ``shot_fpfh_tpu_torch/kernels``),
never into ``site-packages``.  The hash covers every source and the
compiler flags, so an edited source rebuilds and an unchanged one loads the
existing file.

Every C entry point enqueues its kernel on the stream it is given, checks
``cudaGetLastError()`` right after the launch and returns that error code;
:func:`launch` raises when it is not 0 and counts the launch.  Under a NaN
check (``utils.debug_nans``), it then checks the operands and outputs the
wrapper passes as ``checked``.

Nothing here runs at import: the build happens at the first kernel call, so
a CPU-only machine (no ``nvcc``, no card) can import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from .utils.debug_nans import check_kernel

CSRC = Path(__file__).resolve().parent / "csrc"
LIB_NAME = "libshot_kernels.so"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-Xcompiler", "-fPIC",
    # no implicit multiply-add contraction: the kernels round each
    # elementwise step like the eager PyTorch twins they are held against
    # (counts and bin decisions at a radius or bin edge must agree)
    "-fmad=false",
    "-Xptxas", "-v",
]
LINK_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-shared"]

# C entry point -> argument types (every pointer and the stream as c_void_p,
# so ctypes never truncates a 64-bit address to a 32-bit int)
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# a grid as K3 takes it: table, stride, rows, cell starts, cell ids, origin,
# cell size, dims, halo
_GRID = [_P, _I, _L, _P, _P, _P, _F, _L, _L, _L, _I]
_SIGNATURES = {
    "shot_binning_histogram": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _P, _P],
    "top2_match": [_P] * 11 + [_I] * 6 + [_P],
    "radius_pca_keys": _GRID + [_P, _I, _P, _P],
    "radius_pca": _GRID + [_P, _P, _P, _I, _P, _P, _P, _P],
    "spfh_histogram": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "spfh_runs": [_P, _I, _P, _P, _F, _L, _L, _L, _I, _P, _P, _I, _I, _F, _I, _I, _P, _P],
    "spfh_grid": [_P, _I, _P, _P, _P, _F, _L, _L, _L, _I, _I, _P, _P, _I, _I, _F, _I, _I, _P,
                  _P],
    "shot_runs": [_P, _I, _P, _P, _F, _L, _L, _L, _I, _I, _P, _I, _P, _F, _F, _P, _P, _P, _P,
                  _P],
    "shot_grid": [_P, _I, _P, _P, _P, _F, _L, _L, _L, _I, _I, _P, _I, _P, _F, _F, _P, _P, _P,
                  _P, _P],
    "fetch_windows": [_P, _I, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P],
    "radius_dist": [_P, _I, _P, _P, _P, _I, _I, _I, _F, _P, _P, _P],
    "nearest": [_P, _I, _P, _P, _P, _F, _L, _L, _L, _I, _I, _P, _I, _I, _P, _P, _P],
    "icp_step": [_P, _I, _P, _P, _P, _F, _L, _L, _L, _I, _I, _P, _P, _P, _P, _I, _I, _F, _F, _P,
                 _P, _P, _I, _P],
    "fpfh_aggregate": [_P, _I, _P, _P, _F, _L, _L, _L, _I, _I, _P, _I, _P, _P, _I, _F, _P, _P,
                       _P],
}

# one launch counter per kernel: incremented by launch() and nowhere else
launch_counts: dict[str, int] = {name: 0 for name in _SIGNATURES}

_lib = None
_lock = threading.Lock()
build_info: dict[str, object] = {}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for path in _sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build_root() -> Path:
    """Where built libraries go: the checkout's ``build/kernels`` when the
    package sits in a source tree, else the user's cache directory."""
    repo = Path(__file__).resolve().parent.parent
    if (repo / "pyproject.toml").is_file():
        return repo / "build" / "kernels"
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "shot_fpfh_tpu_torch" / "kernels"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def build() -> Path:
    """Compile ``csrc/*.cu`` into the hashed library path (if not there yet)
    and return it: one ``nvcc -c`` per source, all in parallel, then one
    link.  Writes to temporary names and renames, so a process building
    concurrently never loads a half-written library."""
    out_dir = build_root() / _source_hash()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        build_info.setdefault("seconds", 0.0)
        build_info.setdefault("cached", True)
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc, pid = _nvcc(), os.getpid()
    sources = sorted(CSRC.glob("*.cu"))
    objects = [out_dir / f".{src.stem}.{pid}.o" for src in sources]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for src, obj in zip(sources, objects)]
    outputs = [proc.communicate() for proc in procs]
    results = [(proc.returncode, out, err) for proc, (out, err) in zip(procs, outputs)]
    tmp = out_dir / f".{LIB_NAME}.{pid}.tmp"
    if all(rc == 0 for rc, _, _ in results):
        link = subprocess.run([nvcc, *LINK_FLAGS, "-o", str(tmp), *map(str, objects)],
                              capture_output=True, text=True, check=False)
        results.append((link.returncode, link.stdout, link.stderr))
    elapsed = time.perf_counter() - t0
    log = "".join(out + err for _, out, err in results)
    (out_dir / "build.log").write_text(log)
    for obj in objects:
        obj.unlink(missing_ok=True)
    failed = [(rc, out, err) for rc, out, err in results if rc != 0]
    if failed:
        rc, out, err = failed[0]
        raise RuntimeError(f"nvcc failed ({rc}):\n{out}\n{err}")
    os.replace(tmp, lib_path)
    build_info.update(seconds=elapsed, cached=False,
                      ptxas=[ln for ln in log.splitlines()
                             if "registers" in ln or "Compiling entry" in ln])
    return lib_path


def load(path: Path) -> ctypes.CDLL:
    """The kernel library at ``path``, its C entry points typed."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.shot_error_string.argtypes = [ctypes.c_int]
    lib.shot_error_string.restype = ctypes.c_char_p
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = load(build())
    return _lib


def ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def require_cuda(*tensors: torch.Tensor) -> torch.device:
    """Device of a kernel call: every tensor on the same CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or dev.type != "cuda":
            raise ValueError(
                f"kernel inputs must share one CUDA device, got {t.device} "
                f"and {dev}")
    return dev


def launch(name: str, device: torch.device, *args, checked=()) -> None:
    """Call C entry point ``name`` on ``device``'s current stream; raise on
    a launch error; count the launch; under a NaN check, raise if a tensor
    of ``checked`` (the kernel's operands and outputs) holds a NaN."""
    fn = getattr(library(), name)
    stream = torch.cuda.current_stream(device).cuda_stream
    if device.index == torch.cuda.current_device():
        err = fn(*args, stream)
    else:
        with torch.cuda.device(device):
            err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError_t {err} "
                           f"({library().shot_error_string(err).decode()})")
    launch_counts[name] += 1
    check_kernel(name, checked)
