"""Result object returned by Trainer.fit (a copy of
``ray_tpu/air/result.py``; reference: python/ray/air/result.py)."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

from ray_tpu_torch.air.checkpoint import Checkpoint


@dataclasses.dataclass
class Result:
    metrics: Dict[str, Any]
    checkpoint: Optional[Checkpoint] = None
    error: Optional[BaseException] = None
    metrics_history: Optional[List[Dict[str, Any]]] = None

    @property
    def best_checkpoint(self) -> Optional[Checkpoint]:
        return self.checkpoint
