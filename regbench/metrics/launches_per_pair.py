"""Device kernels a pair: the kernels that started in the profiled
stretch, over its pairs."""


def read(run):
    if run.trace is None or not run.traced:
        return None
    return run.trace.kernel_count / len(run.traced)
