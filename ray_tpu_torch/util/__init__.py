from ray_tpu_torch.util.placement_group import (
    placement_group,
    remove_placement_group,
    placement_group_table,
    PlacementGroup,
)
from ray_tpu_torch.util.scheduling_strategies import (
    PlacementGroupSchedulingStrategy,
    NodeAffinitySchedulingStrategy,
)
from ray_tpu_torch.util.actor_pool import ActorPool
from ray_tpu_torch.util import accelerators, metrics, state


def __getattr__(name):
    # Lazy re-export (reference parity: ray.util.check_serializability)
    # keeps devtools entirely off the normal `import ray_tpu_torch` path — it
    # loads only on use or when RAY_TPU_LOCKCHECK opts in.
    if name == "check_serializability":
        from ray_tpu_torch.devtools.serializability import check_serializability

        return check_serializability
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "placement_group", "remove_placement_group", "placement_group_table",
    "PlacementGroup", "PlacementGroupSchedulingStrategy",
    "NodeAffinitySchedulingStrategy", "ActorPool", "accelerators",
    "metrics", "state", "check_serializability",
]
