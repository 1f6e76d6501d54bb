"""BackendExecutor: placement group + worker gang + backend rendezvous
(counterpart: ``ray_tpu/train/backend_executor.py``).

Reference: ``python/ray/train/_internal/backend_executor.py:43`` —
``start`` (:94) creates the placement group (:147) and WorkerGroup, sets
rank/world env vars (:255), and runs the framework backend's ``on_start``;
``start_training`` (:325) launches the user loop on every worker.  Card
visibility is pinned by the scheduler at worker spawn
(``CUDA_VISIBLE_DEVICES``), not shared afterwards as the reference's
``_share_cuda_visible_devices`` (:205) does.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch as ray
from ray_tpu_torch._private import segment_stream
from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.air.config import ScalingConfig
from ray_tpu_torch.train.backend import Backend, TorchConfig
from ray_tpu_torch.train.worker_group import WorkerGroup
from ray_tpu_torch.util.placement_group import placement_group, remove_placement_group


class TrainingFailedError(RuntimeError):
    pass


class BackendExecutor:
    def __init__(self, backend_config: Optional[TorchConfig] = None,
                 scaling_config: Optional[ScalingConfig] = None):
        self._backend_config = backend_config or TorchConfig()
        self._scaling = scaling_config or ScalingConfig()
        self._backend: Backend = self._backend_config.backend_cls()
        self._worker_group: Optional[WorkerGroup] = None
        self._pg = None
        self.streamed_reports = []
        self.latest_checkpoint: Optional[Checkpoint] = None

    def start(self):
        sc = self._scaling
        bundles = [sc.worker_resources() for _ in range(sc.num_workers)]
        self._pg = placement_group(bundles, strategy=sc.placement_strategy)
        ray.get(self._pg.ready(), timeout=60)
        self._worker_group = WorkerGroup(
            sc.num_workers, sc.worker_resources(), placement_group=self._pg)
        # rank/world env (reference: backend_executor.py:255)
        futs = []
        for rank, w in enumerate(self._worker_group.workers):
            futs.append(w.set_env.remote({
                "RANK": str(rank),
                "WORLD_RANK": str(rank),
                "WORLD_SIZE": str(sc.num_workers),
                "LOCAL_RANK": "0",
            }))
        ray.get(futs)
        self._backend.on_start(self._worker_group, self._backend_config)

    @property
    def worker_group(self) -> WorkerGroup:
        if self._worker_group is None:
            raise RuntimeError("BackendExecutor not started")
        return self._worker_group

    def run_training(self, train_fn: Callable[[Dict[str, Any]], None],
                     config: Dict[str, Any],
                     checkpoint: Optional[Checkpoint] = None
                     ) -> List[Dict[str, Any]]:
        """Run the loop on every worker; block; return per-rank session
        payloads (reports + checkpoint bytes).  While blocked, drains the
        workers\' report stream so ``latest_checkpoint``/``streamed_reports``
        survive a mid-run worker death (reference: session result queue +
        get_next_results, backend_executor.py:426)."""
        import pickle
        import uuid

        wg = self.worker_group
        topic = f"train-{uuid.uuid4().hex[:12]}"
        self._topic = topic
        ckpt = checkpoint.to_bytes() if checkpoint is not None else None
        from ray_tpu_torch._private.api_internal import require_runtime
        rt = require_runtime()
        futs = []
        for rank, w in enumerate(wg.workers):
            session_kwargs = {
                "world_rank": rank,
                "world_size": wg.num_workers,
                "local_rank": 0,
                "checkpoint": Checkpoint.from_bytes(ckpt) if ckpt else None,
                "stream_topic": topic,
                "stream_store": rt.store_id,
            }
            futs.append(w.run_train_fn.remote(train_fn, config,
                                              session_kwargs))
        pending = list(futs)
        try:
            while pending:
                _, pending = ray.wait(pending, num_returns=len(pending),
                                      timeout=0.25)
                self._drain_stream(rt, topic, pickle)
            self._drain_stream(rt, topic, pickle)
            return ray.get(futs)
        except Exception as e:
            self._drain_stream(rt, topic, pickle)
            raise TrainingFailedError(str(e)) from e

    def _drain_stream(self, rt, topic: str, pickle):
        for raw in rt.poll_events(topic):
            try:
                ev = pickle.loads(raw)
            except Exception:
                continue
            seg = ev.get("checkpoint_segment")
            if seg is not None:
                # A streamed checkpoint's bytes, landed in this node's
                # store; taking them frees the segment.  numpy's copy
                # lets go of the GIL: ``tobytes()`` held it for over a
                # second on a 1.3 GB checkpoint, and with it every head
                # thread of this process, so a worker killed right
                # after its report was seen dead that much later.
                ev["checkpoint"] = segment_stream.take(
                    seg, lambda a: a.copy())
            self.streamed_reports.append(ev)
            if ev.get("checkpoint") is not None and ev.get("rank") == 0:
                self.latest_checkpoint = Checkpoint.from_bytes(
                    ev["checkpoint"])

    def shutdown(self):
        if self._worker_group is not None:
            try:
                self._backend.on_shutdown(self._worker_group,
                                          self._backend_config)
            finally:
                self._worker_group.shutdown()
                self._worker_group = None
        if self._pg is not None:
            try:
                remove_placement_group(self._pg)
            except Exception:
                pass
            self._pg = None
