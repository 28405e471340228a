from .perf import StageMetrics, checkpoint

__all__ = ["StageMetrics", "checkpoint"]
