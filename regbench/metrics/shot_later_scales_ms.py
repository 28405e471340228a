"""Milliseconds a pair that the card works on multiscale SHOT's later
scales: for each ``shot.scale`` range that is not the first of its cloud
(a cloud's scales follow its ``shot.pad`` range) inside a
``descriptors[...]`` range of the profiled stretch, the card's kernel and
fill time from the end of the first ``sync[...]`` range inside it to the
end of the first ``sync[...]`` range that starts after it (the stage's own
closing synchronise for the last cloud), summed over the stretch and
divided by its pairs.  A blocking read drains the stream, so that window
holds the scale's work after its first read (its support's subsample,
grid and SG pass) and the concatenation of the rows; copies are left out,
since the read that closes it may be the next cloud's upload.  0 where
the cell's descriptor runs one scale (no SHOT scale follows a first) and
the stretch holds its descriptor stages; None where a multiscale cell's
stretch shows no second scale of a cloud (a program without the
``shot.scale`` ranges)."""

import bisect

from ..trace import covered, union

DEVICE_WORK = ("kernel", "gpu_memset")


def read(run):
    if run.trace is None or not run.traced:
        return None
    trace = run.trace

    def inside(prefix):
        return sorted((lo, hi) for lo, hi in trace.ranges(prefix)
                      if trace.start <= lo < trace.end)

    stages, pads, scales, syncs = (inside(p) for p in ("descriptors[", "shot.pad",
                                                         "shot.scale", "sync["))
    pad_starts, sync_starts = [lo for lo, _ in pads], [lo for lo, _ in syncs]
    work = union([(s, e) for s, e, _, cat in trace.device if cat in DEVICE_WORK])
    seen, windows = set(), []
    for lo, hi in scales:
        cloud = bisect.bisect_right(pad_starts, lo) - 1
        stage = next(((s, e) for s, e in stages if s <= lo and hi <= e), None)
        later = cloud in seen
        seen.add(cloud)
        if not later or cloud < 0 or stage is None:
            continue
        first = None
        for s, e in syncs[bisect.bisect_left(sync_starts, lo):]:
            if s >= hi:
                break
            if e <= hi:
                first = e
                break
        if first is None:
            continue
        j = bisect.bisect_left(sync_starts, hi)
        end = min(syncs[j][1], stage[1]) if j < len(syncs) else stage[1]
        windows.append((first, end))
    if not windows:
        desc = run.config.get("descriptor") or {}
        choice = desc.get("descriptor_choice")
        if choice is None or not stages:
            return None
        one_scale = "multiscale" not in choice or desc.get("n_scales", 1) < 2
        return 0.0 if one_scale else None
    return sum(covered(work, a, b) for a, b in windows) / 1e3 / len(run.traced)
