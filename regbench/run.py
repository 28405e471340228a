"""Run one cell of the port's benchmark:

    python3 regbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell's configuration fixes the process's
CPU threads, so the OpenMP and MKL ones are set here, before NumPy and
PyTorch load (the harness sets PyTorch's own); caches of the kernel
builders go under the checkout's ``build/``.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _set_environment(argv) -> None:
    """Thread counts of the cell's configuration, and the builders' cache
    directories inside the checkout.  A workload that is not in
    ``BENCHMARK.json`` sets no threads; the harness then refuses it."""
    from regbench.cells import load_cell

    workload = argv[argv.index("--workload") + 1] if "--workload" in argv else None
    try:
        threads = load_cell(workload).config["threads"]
    except (KeyError, FileNotFoundError):
        threads = {}
    for key in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        if key in threads:
            os.environ[key] = str(threads[key])
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    _set_environment(sys.argv[1:])
    from regbench.harness import main

    raise SystemExit(main(t_start=T_START))
