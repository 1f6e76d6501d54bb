"""Runtime context introspection.

Reference: ``python/ray/runtime_context.py`` (get_runtime_context with
node_id/task_id/actor_id/assigned resources).  TPU addition:
``tpu_chips`` — the chip indices this worker owns (the analog of
``get_gpu_ids``/CUDA_VISIBLE_DEVICES plumbing in the reference).
"""

from __future__ import annotations

from typing import List, Optional

from ray_tpu_torch._private.api_internal import require_runtime


class RuntimeContext:
    def __init__(self, rt):
        self._rt = rt

    @property
    def is_driver(self) -> bool:
        return not self._rt.is_worker()

    @property
    def node_id(self) -> Optional[str]:
        if self._rt.is_worker():
            return self._rt.node_id_hex
        return self._rt.head_node.node_id.hex()

    @property
    def job_id(self) -> str:
        if self._rt.is_worker():
            return self._rt.job_id_hex
        return self._rt.job_id.hex()

    @property
    def task_id(self) -> Optional[str]:
        if self._rt.is_worker() and self._rt.current_task_id is not None:
            return self._rt.current_task_id.hex()
        return None

    @property
    def actor_id(self) -> Optional[str]:
        if self._rt.is_worker() and self._rt.current_actor_id is not None:
            return self._rt.current_actor_id.hex()
        return None

    def get_assigned_resources(self) -> dict:
        if self._rt.is_worker():
            return dict(self._rt.assigned_resources)
        return {}

    @property
    def tpu_chips(self) -> List[str]:
        """Chip ids granted to this worker (empty on the driver)."""
        if self._rt.is_worker():
            return list(self._rt.tpu_chips)
        return []

    def get_tpu_ids(self) -> List[str]:
        return self.tpu_chips


def get_runtime_context() -> RuntimeContext:
    return RuntimeContext(require_runtime())
