"""Blocking reads a pair: the program's ``sync[...]`` ranges (one a
statement that waits for the card: a read of a device value, a copy from
pageable host memory, an operation whose output size the host must learn,
and each stage's two synchronises) that start in the profiled stretch,
over its pairs."""


def read(run):
    if run.trace is None or not run.traced:
        return None
    trace = run.trace
    n = sum(1 for lo, _ in trace.ranges("sync[") if trace.start <= lo < trace.end)
    return n / len(run.traced) if n else None
