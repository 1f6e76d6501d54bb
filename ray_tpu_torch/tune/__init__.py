"""ray_tpu_torch.tune — the Trainable that rllib's algorithms extend
(counterpart: ``ray_tpu.tune``).  Only ``trainable.py`` is copied so
far; the trial runner, searchers and schedulers are still to copy
(ROADMAP.md Queue 1)."""

from ray_tpu_torch.tune.trainable import Trainable, wrap_function

__all__ = ["Trainable", "wrap_function"]
