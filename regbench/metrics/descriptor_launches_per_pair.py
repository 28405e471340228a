"""Device kernels a pair inside the program's ``descriptors[...]`` stage
ranges: the kernels of the profiled stretch that start inside one, over
its pairs.  The stage synchronises the card at both ends, so every kernel
it issued starts inside its range."""

import bisect


def read(run):
    if run.trace is None or not run.traced:
        return None
    trace = run.trace
    ranges = sorted((lo, hi) for lo, hi in trace.ranges("descriptors[")
                    if trace.start <= lo < trace.end)
    if not ranges:
        return None
    starts = [lo for lo, _ in ranges]
    n = 0
    for s, _, _, cat in trace.device:
        i = bisect.bisect_right(starts, s) - 1
        n += cat == "kernel" and i >= 0 and s <= ranges[i][1]
    return n / len(run.traced)
