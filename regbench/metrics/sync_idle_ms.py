"""Milliseconds a pair that the card sits idle after the host's blocking
reads: for each ``sync[...]`` range of the profiled stretch, the time from
its end to the start of the next device activity (none where the card is
busy at that end), summed over the stretch and divided by its pairs.
Reads that end in the same idle gap count it once, from the first end."""

import bisect

from ..trace import union


def read(run):
    if run.trace is None or not run.traced:
        return None
    trace = run.trace
    merged = trace.merged
    ends = [hi for lo, hi in trace.ranges("sync[") if trace.start <= lo < trace.end]
    if not merged or not ends:
        return None
    starts = [s for s, _ in merged]
    gaps = []
    for t in ends:
        i = bisect.bisect_right(starts, t)
        if i and merged[i - 1][1] > t:
            continue              # the card is busy when the read returns
        nxt = starts[i] if i < len(starts) else trace.end
        if nxt > t:
            gaps.append((t, nxt))
    return sum(hi - lo for lo, hi in union(gaps)) / 1e3 / len(run.traced)
