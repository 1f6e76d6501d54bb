"""ray_tpu_torch.train — distributed training orchestration (counterpart:
``ray_tpu.train``).

The trainer, backend executor and worker group are copies of the
reference's on the port's runtime, with ``TorchConfig`` (torch.distributed
over NCCL or gloo) in place of ``JaxConfig``.  The train step
(``core``) imports torch, so it loads on first use: importing the
trainer in a CPU worker imports no torch.  The 1F1B pipeline actors
(``train.pipeline_actors``: ``PipelineTrainer``, ``PipelineStage``)
import torch only inside their methods.
"""

import importlib as _importlib

from ray_tpu_torch.train.backend import Backend, TorchConfig
from ray_tpu_torch.train.backend_executor import (
    BackendExecutor, TrainingFailedError)
from ray_tpu_torch.train.trainer import (
    BaseTrainer, DataParallelTrainer, TorchTrainer)
from ray_tpu_torch.train.worker_group import WorkerGroup

_CORE = ("AdamW", "TrainState", "adam", "default_optimizer",
         "init_train_state", "loss_and_grads", "make_train_step", "sgd",
         "train_state_from_params", "warmup_cosine_decay_schedule")


def __getattr__(name):
    if name in _CORE:
        return getattr(_importlib.import_module(f"{__name__}.core"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [*_CORE, "Backend", "TorchConfig", "BackendExecutor",
           "TrainingFailedError", "BaseTrainer", "DataParallelTrainer",
           "TorchTrainer", "WorkerGroup"]
