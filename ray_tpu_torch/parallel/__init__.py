"""ray_tpu_torch.parallel — parallelism strategies as named mesh axes
(counterpart: ``ray_tpu.parallel``).

- :mod:`mesh`     — the axes (dp, fsdp, ep, pp, sp, tp), ``MeshConfig``,
  ``make_mesh`` over a torch ``DeviceMesh`` and the ambient ``use_mesh``.
- :mod:`sharding` — logical-axis rules -> DTensor placements,
  ``shard_pytree``, ``with_logical_constraint`` and ``manual_shard_map``.

``mesh`` imports no torch (the trainer's ``ScalingConfig`` carries a
``MeshConfig`` into CPU workers); ``sharding`` imports DTensor, so its
names load on first use.  The pipeline comes with ROADMAP.md Queue 1.
"""

import importlib as _importlib

from ray_tpu_torch.parallel.mesh import (
    AXIS_DP,
    AXIS_EP,
    AXIS_FSDP,
    AXIS_PP,
    AXIS_SP,
    AXIS_TP,
    MESH_AXES,
    Mesh,
    MeshConfig,
    make_mesh,
    mesh_axis_size,
    use_mesh,
)

_SHARDING = ("LogicalAxisRules", "DEFAULT_RULES", "PartitionSpec",
             "logical_to_mesh_axes", "placements", "shard_pytree",
             "sharding_tree", "with_logical_constraint", "manual_shard_map")


def __getattr__(name):
    if name in _SHARDING:
        return getattr(_importlib.import_module(f"{__name__}.sharding"),
                       name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "AXIS_DP", "AXIS_FSDP", "AXIS_EP", "AXIS_PP", "AXIS_SP", "AXIS_TP",
    "MESH_AXES", "Mesh", "MeshConfig", "make_mesh", "mesh_axis_size",
    "use_mesh", *_SHARDING,
]
