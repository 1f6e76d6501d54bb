"""ray_tpu_torch.air — shared trainer plumbing (counterpart:
``ray_tpu.air``): the config dataclasses, the checkpoint, the result and
the worker-side session."""

from ray_tpu_torch.air.config import (
    CheckpointConfig,
    FailureConfig,
    RunConfig,
    ScalingConfig,
)
from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.air.result import Result
from ray_tpu_torch.air import session

__all__ = ["ScalingConfig", "RunConfig", "FailureConfig", "CheckpointConfig",
           "Checkpoint", "Result", "session"]
