"""Batched PTA fitting (torch): PTABatch, PTAFleet and the shape planner."""

from .pta import (PTABatch, PTAFleet, fleet_aot_compile,
                  fleet_pipeline_metrics)

__all__ = ["PTABatch", "PTAFleet", "fleet_aot_compile",
           "fleet_pipeline_metrics"]
