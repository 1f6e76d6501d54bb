"""WorkerGroup: a gang of training-worker actors (counterpart:
``ray_tpu/train/worker_group.py``).

Reference: ``python/ray/train/_internal/worker_group.py:92`` — N actors
created from one ``RayTrainWorker`` class, ``execute``/``execute_async``
running a function on every worker.  Each worker owns
``tpu_chips_per_worker`` cards, granted under the ``"TPU"`` resource: the
runtime pins ``CUDA_VISIBLE_DEVICES`` to them before the worker starts,
so a worker's first card is ``cuda:0``.  This module imports no torch.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch as ray
from ray_tpu_torch.remote_function import _bulk_submit
from ray_tpu_torch.util.placement_group import PlacementGroup


@ray.remote
class TrainWorker:
    """Reference: RayTrainWorker (worker_group.py:40)."""

    def __init__(self, metadata: Dict[str, Any]):
        self._metadata = metadata
        self._env: Dict[str, str] = {}

    def set_env(self, env: Dict[str, str]):
        import os
        self._env.update(env)
        os.environ.update(env)
        return True

    def get_metadata(self):
        import os
        import socket
        return {
            "hostname": socket.gethostname(),
            "pid": os.getpid(),
            # The runtime's grant: "" for a CPU worker.
            "cuda_visible_devices": os.environ.get(
                "CUDA_VISIBLE_DEVICES", ""),
        }

    def execute(self, fn: Callable, *args, **kwargs):
        return fn(*args, **kwargs)

    def run_train_fn(self, train_fn: Callable, config: Dict[str, Any],
                     session_kwargs: Dict[str, Any]):
        """Run the user loop under an active air session; return the
        session's reports + checkpoints (driver-side aggregation)."""
        from ray_tpu_torch.air.session import _TrainSession, _set_session
        sess = _TrainSession(**session_kwargs)
        _set_session(sess)
        try:
            train_fn(config)
        finally:
            _set_session(None)
        ckpt_blobs = [c.to_bytes() for c in sess.checkpoints]
        return {"reports": sess.reports, "checkpoints": ckpt_blobs}


class WorkerGroup:
    def __init__(self, num_workers: int,
                 resources_per_worker: Dict[str, float],
                 placement_group: Optional[PlacementGroup] = None):
        self.num_workers = num_workers
        self._workers = []
        res = dict(resources_per_worker)
        cpu = res.pop("CPU", 1.0)
        # Cards each worker is granted (the runtime's "TPU" resource).
        self.cards_per_worker = int(res.pop("TPU", 0.0))
        for i in range(num_workers):
            kw = {"num_cpus": cpu, "num_tpus": self.cards_per_worker,
                  "resources": dict(res) or None}
            if placement_group is not None:
                from ray_tpu_torch.util.scheduling_strategies import (
                    PlacementGroupSchedulingStrategy,
                )
                kw["scheduling_strategy"] = PlacementGroupSchedulingStrategy(
                    placement_group=placement_group,
                    placement_group_bundle_index=i)
            self._workers.append(
                TrainWorker.options(**kw).remote({"rank": i}))

    def execute(self, fn: Callable, *args, **kwargs) -> List[Any]:
        return ray.get(self.execute_async(fn, *args, **kwargs))

    def execute_async(self, fn: Callable, *args, **kwargs):
        # Bulk path: one runtime submission for the whole worker group.
        return _bulk_submit([(w.execute, (fn,) + args, kwargs)
                             for w in self._workers])

    def execute_single(self, index: int, fn: Callable, *args, **kwargs):
        return ray.get(self._workers[index].execute.remote(fn, *args,
                                                           **kwargs))

    @property
    def workers(self):
        return list(self._workers)

    def shutdown(self):
        for w in self._workers:
            try:
                ray.kill(w)
            except Exception:
                pass
        self._workers = []
