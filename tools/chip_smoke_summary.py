#!/usr/bin/env python3
"""Pool the end-to-end numbers of ``chip_smoke.py`` logs.

    python tools/chip_smoke_summary.py LOG [LOG ...]

For each log (the standard output of one ``python3 chip_smoke.py`` run):
the warm wall, the ICP stage timer and the descriptors stage timer of
every staged path run (phases 4–9 and 11) and the ``fused`` stage of phase
12, then the medians of the wall and ICP over those runs (phase 5's
twin-fed run, which earlier logs lack, left out); the walls of phase 16's
CLI legs on the 10^6-point pair apart; the card's name and power limit the
run printed.  Used to set a
tree's walls beside another's from one chip call that ran both in turns.
"""

from __future__ import annotations

import re
import statistics
import sys

_RUN = re.compile(r"^(phase (?:4|5|6|7|8|9|11|12|16) [^:]*):.*?wall ([0-9.]+) s.*?stages (.*?)"
                  r"(?:; CLI timers|; staged on|$)")
_STAGE = re.compile(r"(icp\[[^\]]*\]|fused) ([0-9.]+) s")
_DESC = re.compile(r"descriptors\[[^\]]*\] ([0-9.]+) s")


def summarize(path: str) -> dict:
    runs, card = [], None
    with open(path, errors="replace") as f:
        for line in f:
            if line.startswith("phase 1 device:"):
                card = line.split("nvidia-smi:", 1)[-1].strip()
            m = _RUN.match(line)
            if m:
                icp = [float(v) for _, v in _STAGE.findall(m.group(3))]
                desc = [float(v) for v in _DESC.findall(m.group(3))]
                runs.append((m.group(1), float(m.group(2)), icp[0] if icp else None,
                             desc[0] if desc else None))
    return dict(card=card, runs=runs)


def main(paths: list[str]) -> int:
    for path in paths:
        s = summarize(path)
        print(f"== {path} ({s['card']})")
        for label, wall, icp, desc in s["runs"]:
            print(f"  {label}: wall {wall:.3f} s, ICP (or fused) {icp:.3f} s"
                  + ("" if desc is None else f", descriptors {desc:.3f} s"))
        staged = [r for r in s["runs"] if not r[0].startswith(("phase 12", "phase 16"))
                  and "twin-fed" not in r[0]]
        if staged:
            print(f"  staged paths ({len(staged)} runs): median wall "
                  f"{statistics.median(r[1] for r in staged):.4f} s, median ICP "
                  f"{statistics.median(r[2] for r in staged):.4f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
