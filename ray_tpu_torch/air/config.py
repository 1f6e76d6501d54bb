"""AIR config dataclasses (counterpart: ``ray_tpu/air/config.py``).

``ScalingConfig`` carries a :class:`ray_tpu_torch.parallel.MeshConfig`
plus chips per worker, as the reference's does.  A chip here is an
NVIDIA card: the runtime grants cards under the resource name ``"TPU"``
(``num_tpus``), and a granted worker sees them through
``CUDA_VISIBLE_DEVICES``.  The field names are the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from ray_tpu_torch.parallel.mesh import MeshConfig


@dataclasses.dataclass
class ScalingConfig:
    """How a trainer scales out.

    num_workers: processes (one per host in multi-host).
    tpu_chips_per_worker: cards each worker owns (0 = CPU worker).
    mesh: global mesh axis sizes laid over num_workers * chips_per_worker
          devices.
    resources_per_worker: extra scheduler resources, as in the reference.
    """

    num_workers: int = 1
    tpu_chips_per_worker: int = 0
    mesh: Optional[MeshConfig] = None
    resources_per_worker: Optional[Dict[str, float]] = None
    placement_strategy: str = "PACK"

    @property
    def total_chips(self) -> int:
        return self.num_workers * self.tpu_chips_per_worker

    def worker_resources(self) -> Dict[str, float]:
        res = dict(self.resources_per_worker or {"CPU": 1.0})
        if self.tpu_chips_per_worker:
            res["TPU"] = float(self.tpu_chips_per_worker)
        return res


@dataclasses.dataclass
class FailureConfig:
    """Reference: python/ray/air/config.py:508."""

    max_failures: int = 0  # 0 = no retries; -1 = infinite


@dataclasses.dataclass
class CheckpointConfig:
    """Reference: python/ray/air/config.py:567."""

    num_to_keep: Optional[int] = None
    checkpoint_score_attribute: Optional[str] = None
    checkpoint_score_order: str = "max"
    checkpoint_frequency: int = 0


@dataclasses.dataclass
class RunConfig:
    """Reference: python/ray/air/config.py:695."""

    name: Optional[str] = None
    storage_path: Optional[str] = None
    failure_config: Optional[FailureConfig] = None
    checkpoint_config: Optional[CheckpointConfig] = None
    stop: Optional[Dict[str, Any]] = None
    verbose: int = 1
