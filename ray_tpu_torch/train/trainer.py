"""Trainers: the user-facing fit() entry points (counterpart:
``ray_tpu/train/trainer.py``).

Reference: ``python/ray/train/base_trainer.py:52`` (``fit`` :538) and
``data_parallel_trainer.py:56``.  fit() drives the BackendExecutor
directly.

``TorchTrainer`` is data-parallel training where each worker is one
process owning its cards, the collective backend is torch.distributed
(train/backend.py: NCCL on granted workers, gloo on CPU workers), and the
in-worker step averages the gradients over the default process group
(train/core.py).

Fault tolerance matches the reference (``FailureConfig(max_failures)``,
``backend_executor.py:522,583``): on worker failure the whole gang is torn
down and restarted from the latest reported checkpoint.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.air.config import FailureConfig, RunConfig, ScalingConfig
from ray_tpu_torch.air.result import Result
from ray_tpu_torch.train.backend import TorchConfig
from ray_tpu_torch.train.backend_executor import BackendExecutor, TrainingFailedError


class BaseTrainer:
    def __init__(self, *, scaling_config: Optional[ScalingConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 resume_from_checkpoint: Optional[Checkpoint] = None):
        self.scaling_config = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self.resume_from_checkpoint = resume_from_checkpoint

    def fit(self) -> Result:
        raise NotImplementedError

    def as_trainable(self):
        """Wrap into a Tune trainable (reference: base_trainer.py:663)."""
        trainer = self

        def train_func(config):
            t = trainer._with_config_overrides(config)
            result = t.fit()
            return result.metrics

        return train_func

    def _with_config_overrides(self, config: Dict[str, Any]):
        return self


class DataParallelTrainer(BaseTrainer):
    """Reference: python/ray/train/data_parallel_trainer.py:56."""

    def __init__(self, train_loop_per_worker: Callable[[Dict[str, Any]], None],
                 *, train_loop_config: Optional[Dict[str, Any]] = None,
                 backend_config: Optional[TorchConfig] = None,
                 scaling_config: Optional[ScalingConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 datasets: Optional[Dict[str, Any]] = None,
                 resume_from_checkpoint: Optional[Checkpoint] = None):
        super().__init__(scaling_config=scaling_config,
                         run_config=run_config,
                         resume_from_checkpoint=resume_from_checkpoint)
        self._train_fn = train_loop_per_worker
        self._train_config = train_loop_config or {}
        self._backend_config = backend_config or TorchConfig()
        self._datasets = datasets or {}

    def fit(self) -> Result:
        failure = self.run_config.failure_config or FailureConfig()
        retries = failure.max_failures
        checkpoint = self.resume_from_checkpoint
        last_error: Optional[BaseException] = None
        while True:
            executor = BackendExecutor(self._backend_config,
                                       self.scaling_config)
            try:
                executor.start()
                config = dict(self._train_config)
                if self._datasets:
                    config["__datasets__"] = {
                        k: _shard_dataset(d, self.scaling_config.num_workers)
                        for k, d in self._datasets.items()}
                payloads = executor.run_training(self._train_fn, config,
                                                 checkpoint)
                return _payloads_to_result(payloads)
            except TrainingFailedError as e:
                last_error = e
                # Group restart from the latest checkpoint streamed before
                # the death (reference: backend_executor.py:522
                # get_with_failure_handling + the session result queue).
                if executor.latest_checkpoint is not None:
                    checkpoint = executor.latest_checkpoint
                if retries == 0:
                    return Result(metrics={}, checkpoint=checkpoint,
                                  error=e)
                if retries > 0:
                    retries -= 1
            finally:
                executor.shutdown()


def _shard_dataset(dataset, num_shards: int):
    if hasattr(dataset, "split"):
        return dataset.split(num_shards)
    return [dataset] * num_shards


def _payloads_to_result(payloads) -> Result:
    rank0 = payloads[0]
    reports = rank0["reports"]
    ckpt = None
    if rank0["checkpoints"]:
        ckpt = Checkpoint.from_bytes(rank0["checkpoints"][-1])
    metrics = reports[-1] if reports else {}
    return Result(metrics=metrics, checkpoint=ckpt,
                  metrics_history=reports)


class TorchTrainer(DataParallelTrainer):
    """The counterpart of the reference's ``JaxTrainer`` (reference seam:
    python/ray/train/torch/torch_trainer.py + torch/config.py:29).

    Each worker is one process on its granted cards, joined to the gang's
    default process group by ``TorchConfig``; the in-worker step
    (``ray_tpu_torch.train.make_train_step``) averages its gradients over
    that group.
    """
