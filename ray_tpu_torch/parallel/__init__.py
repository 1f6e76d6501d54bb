"""ray_tpu_torch.parallel — parallelism strategies as named mesh axes
(counterpart: ``ray_tpu.parallel``).

Only the axis names and ``MeshConfig`` are here so far: the trainer's
``ScalingConfig`` carries a ``MeshConfig``.  ``make_mesh`` over a torch
``DeviceMesh``, the sharding rules and the pipeline come with ROADMAP.md
Queue 1 item 4.
"""

from ray_tpu_torch.parallel.mesh import (
    AXIS_DP,
    AXIS_EP,
    AXIS_FSDP,
    AXIS_PP,
    AXIS_SP,
    AXIS_TP,
    MESH_AXES,
    MeshConfig,
)

__all__ = ["AXIS_DP", "AXIS_FSDP", "AXIS_EP", "AXIS_PP", "AXIS_SP",
           "AXIS_TP", "MESH_AXES", "MeshConfig"]
