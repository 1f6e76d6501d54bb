"""Worker-side training session API (a copy of ``ray_tpu/air/session.py``
re-pointed at the port's runtime; reference: python/ray/air/session.py:43
and python/ray/train/_internal/session.py:63).

Inside ``train_loop_per_worker`` user code calls::

    from ray_tpu_torch.air import session
    session.report({"loss": ...}, checkpoint=Checkpoint.from_dict(...))
    session.get_world_rank(); session.get_checkpoint()

Reports accumulate in the active session and are returned to the driver
by the worker actor when the loop finishes; each report is also streamed
to the driver as it is made, so a checkpoint reported before a worker
dies survives it.  A streamed checkpoint crosses the object plane into
the driver's node store (``_private.segment_stream``); the event that
announces it carries only its descriptor, so a checkpoint of hundreds of
MB never holds the worker's control channel.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

import numpy as np

from ray_tpu_torch._private import segment_stream
from ray_tpu_torch.air.checkpoint import Checkpoint

_local = threading.local()


class _TrainSession:
    def __init__(self, world_rank: int = 0, world_size: int = 1,
                 local_rank: int = 0,
                 checkpoint: Optional[Checkpoint] = None,
                 trial_info: Optional[Dict[str, Any]] = None,
                 stream_topic: Optional[str] = None,
                 stream_store: Optional[str] = None):
        self.world_rank = world_rank
        self.world_size = world_size
        self.local_rank = local_rank
        self.loaded_checkpoint = checkpoint
        self.trial_info = trial_info or {}
        self.stream_topic = stream_topic
        # The driver's node store, where streamed checkpoints land.
        self.stream_store = stream_store
        self.reports: List[Dict[str, Any]] = []
        self.checkpoints: List[Checkpoint] = []

    def report(self, metrics: Dict[str, Any],
               checkpoint: Optional[Checkpoint] = None):
        entry = dict(metrics)
        entry["_training_iteration"] = len(self.reports)
        self.reports.append(entry)
        if checkpoint is not None:
            self.checkpoints.append(checkpoint)
        if self.stream_topic is not None:
            # Live-stream to the driver so mid-training checkpoints survive
            # worker death (reference: the session result queue,
            # train/_internal/session.py:322).
            try:
                from ray_tpu_torch._private.worker_main import get_worker_runtime
                rt = get_worker_runtime()
                if rt is not None:
                    import pickle
                    # Only rank 0 ships checkpoint bytes — the driver
                    # keeps rank 0's anyway, other ranks' would be
                    # serialized and dropped.  They land in the
                    # driver's node store as a segment, which outlives
                    # this worker; only its descriptor rides the event
                    # (inline bytes when no put path reaches the store).
                    blob = seg = None
                    if checkpoint is not None and self.world_rank == 0:
                        blob = checkpoint.to_bytes()
                        seg = segment_stream.land(
                            np.frombuffer(blob, np.uint8),
                            self.stream_store)
                    payload = pickle.dumps({
                        "rank": self.world_rank,
                        "metrics": entry,
                        "checkpoint": None if seg else blob,
                        "checkpoint_segment": seg,
                    })
                    rt.publish_event(self.stream_topic, payload)
            except Exception:
                pass  # streaming is best-effort; end-of-run return is exact


def _set_session(s: Optional[_TrainSession]):
    _local.session = s


def _get_session() -> Optional[_TrainSession]:
    return getattr(_local, "session", None)


def report(metrics: Dict[str, Any],
           checkpoint: Optional[Checkpoint] = None) -> None:
    s = _get_session()
    if s is None:
        raise RuntimeError("session.report() outside a train session")
    s.report(metrics, checkpoint)


def get_checkpoint() -> Optional[Checkpoint]:
    s = _get_session()
    return s.loaded_checkpoint if s else None


def get_world_rank() -> int:
    s = _get_session()
    return s.world_rank if s else 0


def get_world_size() -> int:
    s = _get_session()
    return s.world_size if s else 1


def get_local_rank() -> int:
    s = _get_session()
    return s.local_rank if s else 0


def get_trial_name() -> Optional[str]:
    s = _get_session()
    return s.trial_info.get("name") if s else None
