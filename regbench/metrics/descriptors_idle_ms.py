"""Milliseconds a pair that the card sits idle inside the program's
``descriptors[...]`` stage ranges of the profiled stretch, over its
pairs.  The stage synchronises the card at both ends, so this is the time
in which the host, not the card, paced the descriptor stage."""


def read(run):
    if run.trace is None or not run.traced:
        return None
    trace = run.trace
    ranges = [(lo, hi) for lo, hi in trace.ranges("descriptors[")
              if trace.start <= lo < trace.end]
    if not ranges:
        return None
    idle_us = sum((hi - lo) - 1e6 * trace.busy_in(lo, hi) for lo, hi in ranges)
    return idle_us / 1e3 / len(run.traced)
