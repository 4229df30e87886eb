"""The analytic cost model of parallel configurations
(:mod:`.parallel_cost`); the op-benchmark ``CostModel`` is not ported
(ROADMAP Queue 1 item 9)."""
from .parallel_cost import predict, predict_memory_bytes, predict_step_time

__all__ = ["predict", "predict_memory_bytes", "predict_step_time"]
