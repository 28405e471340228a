"""Mean ICP iterations a pair (``IcpHostResult.n_iters``, as the ``icp``
stage's ``iterations`` counter records it)."""


def read(run):
    if not run.pairs:
        return None
    return sum(p.icp_iters for p in run.pairs) / len(run.pairs)
