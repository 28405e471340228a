"""Mean milliseconds of the pipeline's ``descriptors`` stage a pair (its
``StageMetrics`` record, which synchronises the card at both ends)."""

from . import stage_ms


def read(run):
    return stage_ms(run, "descriptors")
