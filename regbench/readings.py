"""The readings that the limits of ``correct`` are set from, for one cell:

    python3 regbench/readings.py --workload <name> --seeds 1,2,... \\
        --control-seeds 7,8,9 [--out readings.json]

For each of ``--seeds`` it registers every pair of the pool a benchmark
run with that seed makes (at the cell's full size, through the timed path)
and prints the compared numbers as that run would read them
(``compare.program_readings``); for each of ``--control-seeds`` it prints
the same numbers of the control, the reference one precision lower in the
program's place, on the pool's first pair (``compare.control_readings``).
The last line gives, per number, the largest reading of the program (the
lower end of its limit) and the smallest of the control (the upper end).
The benchmark's runs never run this; it needs a CUDA device.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None, *, require_cuda: bool = True) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)

    import torch

    from regbench import compare, generator, harness
    from regbench.cells import load_cell

    cell = load_cell(args.workload)
    cfg, traffic = cell.config, cell.traffic
    torch.set_num_threads(int(cfg["threads"]["torch_intra_op"]))
    if require_cuda and not torch.cuda.is_available():
        print("readings: needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0) if require_cuda else torch.device("cpu")

    def seeds(text):
        return [int(s) for s in text.split(",") if s]

    rows = []
    for seed in seeds(args.seeds):
        outs, truths, records = {}, [], []
        for index, pair in enumerate(generator.make_pool(traffic, seed, device)):
            record, outs[index] = harness.register_pair(pair, cfg, traffic, device)
            records.append(record)
            truths.append((outs[index].icp[0], outs[index].icp[1], pair.rotation,
                           pair.translation))
        t0 = time.perf_counter()
        values = compare.program_readings(outs, truths, cfg, traffic, seed, device)
        del outs
        rows.append({"kind": "program", "seed": seed, "check_s": time.perf_counter() - t0,
                     "pair_s": [r.pair_s for r in records],
                     "accepted": [r.accepted for r in records],
                     "truth_errors": compare.truth_errors(truths), **values})
        print(json.dumps(rows[-1]), flush=True)
    for seed in seeds(args.control_seeds):
        pair = generator.make_pair(traffic, seed, 0, device)
        record, out = harness.register_pair(pair, cfg, traffic, device)
        t0 = time.perf_counter()
        values = compare.control_readings(out, cfg, traffic, seed, device)
        del out
        rows.append({"kind": "control", "seed": seed, "check_s": time.perf_counter() - t0,
                     "pair_s": [record.pair_s], "accepted": [record.accepted], **values})
        print(json.dumps(rows[-1]), flush=True)

    info = ("kind", "seed", "check_s", "pair_s", "accepted", "truth_errors")
    names = [k for k in rows[0] if k not in info]
    summary = {}
    for name in names:
        prog = [r[name] for r in rows if r["kind"] == "program"]
        ctrl = [r[name] for r in rows if r["kind"] == "control"]
        summary[name] = {"program_max": max(prog) if prog else None,
                         "control_min": min(ctrl) if ctrl else None}
    result = {"workload": args.workload, "device": (torch.cuda.get_device_name(device)
                                                    if device.type == "cuda" else "cpu"),
              "summary": summary, "rows": rows}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    from regbench.run import _set_environment

    _set_environment(sys.argv[1:])
    raise SystemExit(main())
