"""Scheduling strategies (reference:
``python/ray/util/scheduling_strategies.py`` — PlacementGroupSchedulingStrategy,
NodeAffinitySchedulingStrategy, plus the "SPREAD"/"DEFAULT" strings)."""

from __future__ import annotations

from typing import Optional


class PlacementGroupSchedulingStrategy:
    def __init__(self, placement_group,
                 placement_group_bundle_index: int = -1,
                 placement_group_capture_child_tasks: bool = False):
        self.placement_group = placement_group
        self.placement_group_bundle_index = (
            None if placement_group_bundle_index < 0
            else placement_group_bundle_index)
        self.placement_group_capture_child_tasks = (
            placement_group_capture_child_tasks)


class NodeAffinitySchedulingStrategy:
    def __init__(self, node_id, soft: bool = False):
        # node_id: hex string or bytes
        self.node_id = (bytes.fromhex(node_id)
                        if isinstance(node_id, str) else node_id)
        self.soft = soft


DEFAULT = "DEFAULT"
SPREAD = "SPREAD"
