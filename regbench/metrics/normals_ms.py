"""Mean milliseconds of both clouds' k-NN normals a pair: the harness's
span around ``compute_normals`` and the copy of its result to the host,
which waits for the card."""


def read(run):
    if not run.pairs:
        return None
    return 1e3 * sum(p.normals_s for p in run.pairs) / len(run.pairs)
