"""ray_tpu_torch.train — the single-device train step (counterpart:
``ray_tpu.train.core``; the trainer, backends and pipeline actors are not
ported yet, ROADMAP.md Queue 1)."""

from ray_tpu_torch.train.core import (
    AdamW, TrainState, default_optimizer, init_train_state, loss_and_grads,
    make_train_step, train_state_from_params, warmup_cosine_decay_schedule)

__all__ = ["AdamW", "TrainState", "default_optimizer", "init_train_state",
           "loss_and_grads", "make_train_step", "train_state_from_params",
           "warmup_cosine_decay_schedule"]
