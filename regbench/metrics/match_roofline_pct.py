"""The match's least time as a share of the card's busy time inside the
``matching[...]`` ranges of the profiled stretch.  The least time is
counted from the shapes (``roofline.match_least_seconds``): the non-empty
descriptor rows of both clouds and their width, the same work whatever
implements it.  The stage synchronises the card at both ends, so every
device operation inside a range is the match's."""

from ..roofline import match_least_seconds


def read(run):
    if run.trace is None:
        return None
    ranges = run.trace.ranges("matching[")
    if len(ranges) != len(run.traced) or not ranges:
        return None
    busy = sum(run.trace.busy_in(lo, hi) for lo, hi in ranges)
    least = sum(match_least_seconds(p.shapes["scan_nz"], p.shapes["ref_nz"], p.shapes["dim"])
                for p in run.traced)
    return 100.0 * least / busy if busy > 0 else None
