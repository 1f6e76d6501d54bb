"""Runtime access shared by the public API, ObjectRef, and handles.

One accessor that answers "which runtime am I in?" — the driver's Runtime or
a worker's _WorkerRuntime (reference: the global_worker singleton,
``python/ray/_private/worker.py``)."""

from __future__ import annotations

from typing import Optional

from ray_tpu_torch._private import object_ref as _object_ref_mod

_global_runtime = None


def get_runtime():
    from ray_tpu_torch._private.worker_main import get_worker_runtime

    wr = get_worker_runtime()
    if wr is not None:
        return wr
    return _global_runtime


def set_global_runtime(rt):
    global _global_runtime
    _global_runtime = rt


def require_runtime():
    rt = get_runtime()
    if rt is None:
        raise RuntimeError(
            "ray_tpu_torch is not initialized; call ray_tpu_torch.init() first.")
    return rt


_object_ref_mod._set_runtime_accessor(get_runtime)
