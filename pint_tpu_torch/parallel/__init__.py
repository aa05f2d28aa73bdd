"""Batched PTA fitting (torch): PTABatch, PTAFleet, the shape planner,
device meshes, TOA-axis sharding, multi-process fleets and the fleet
mesh's device lanes."""

from .pta import (PTABatch, PTAFleet, fleet_aot_compile,
                  fleet_pipeline_metrics, stack_prepared)
from .shapeplan import (PlanBucket, PlanRow, Segment, ShapePlan,
                        plan_shapes, pow2_width)
from .mesh import make_mesh, make_mesh2d, shard_batch, lane_meshes
from .distributed import (initialize_distributed, process_pulsar_slice,
                          global_pulsar_mesh)
from .fleetmesh import (FleetMesh, DeviceLane, DeviceLost,
                        CollectiveTimeout, run_watched)

__all__ = ["PTABatch", "PTAFleet", "fleet_aot_compile",
           "fleet_pipeline_metrics", "stack_prepared", "PlanBucket",
           "PlanRow", "Segment", "ShapePlan", "plan_shapes", "pow2_width",
           "make_mesh", "make_mesh2d", "shard_batch", "lane_meshes",
           "initialize_distributed", "process_pulsar_slice",
           "global_pulsar_mesh", "FleetMesh", "DeviceLane", "DeviceLost",
           "CollectiveTimeout", "run_watched"]
