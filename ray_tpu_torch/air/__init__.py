"""ray_tpu_torch.air — the checkpoint the runtime and trainers share
(counterpart: ``ray_tpu.air``; its config dataclasses, results and
session come with the train backend, ROADMAP.md Queue 1)."""

from ray_tpu_torch.air.checkpoint import Checkpoint

__all__ = ["Checkpoint"]
