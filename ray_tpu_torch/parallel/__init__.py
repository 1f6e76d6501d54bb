"""ray_tpu_torch.parallel — parallelism strategies as named mesh axes
(counterpart: ``ray_tpu.parallel``).

- :mod:`mesh`     — the axes (dp, fsdp, ep, pp, sp, tp), ``MeshConfig``,
  ``make_mesh`` over a torch ``DeviceMesh`` and the ambient ``use_mesh``.
- :mod:`sharding` — logical-axis rules -> DTensor placements,
  ``shard_pytree``, ``with_logical_constraint`` and ``manual_shard_map``.
- :mod:`collectives` — ``axis_index``, ``ppermute``, ``all_to_all`` and
  ``psum`` inside a manual region.
- :mod:`pipeline` — the GPipe schedule over 'pp' (``pipeline_apply``,
  ``split_stages``).

``mesh`` imports no torch (the trainer's ``ScalingConfig`` carries a
``MeshConfig`` into CPU workers); ``sharding`` and ``pipeline`` import
DTensor, so their names load on first use.
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
_PIPELINE = ("pipeline_apply", "split_stages")


def __getattr__(name):
    if name in _SHARDING:
        return getattr(_importlib.import_module(f"{__name__}.sharding"),
                       name)
    if name in _PIPELINE:
        return getattr(_importlib.import_module(f"{__name__}.pipeline"),
                       name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "AXIS_DP", "AXIS_FSDP", "AXIS_EP", "AXIS_PP", "AXIS_SP", "AXIS_TP",
    "MESH_AXES", "Mesh", "MeshConfig", "make_mesh", "mesh_axis_size",
    "use_mesh", *_SHARDING, *_PIPELINE,
]
