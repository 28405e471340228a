"""Milliseconds a pair of the program's own normals stage: the summed
durations of its ``normals[...]`` ranges in the profiled stretch (one a
cloud, each synchronised at both ends), over the traced pairs.  Unlike
``normals_ms`` it leaves out the harness's copy of the normals to the host.
Nothing is read unless the stretch holds exactly two such ranges a pair."""


def read(run):
    if run.trace is None or not run.traced:
        return None
    trace = run.trace
    ranges = [(lo, hi) for lo, hi in trace.ranges("normals[") if trace.start <= lo < trace.end]
    if len(ranges) != 2 * len(run.traced):
        return None
    return sum(hi - lo for lo, hi in ranges) / 1e3 / len(run.traced)
