"""Public API functions: init/shutdown/get/put/wait/kill/cancel/...

Reference: ``python/ray/_private/worker.py`` — ``init`` (:1045), ``get``
(:2305), ``put``, ``wait``, ``shutdown`` (:1602) — with the same semantics
on the TPU-native runtime.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Union

from ray_tpu_torch._private import api_internal
from ray_tpu_torch._private.config import Config
from ray_tpu_torch._private.object_ref import ObjectRef
from ray_tpu_torch._private.runtime import Runtime
from ray_tpu_torch import exceptions as exc


def init(num_cpus: Optional[int] = None, num_tpus: Optional[int] = None,
         resources: Optional[dict] = None, namespace: str = "default",
         ignore_reinit_error: bool = False, _system_config: dict | None = None,
         address: Optional[str] = None, _authkey: Optional[str] = None,
         **_compat_kwargs):
    """Start the runtime (reference: python/ray/_private/worker.py:1045),
    or — with ``address`` — ATTACH to a running cluster in client mode
    (reference: Ray Client, ray.init("ray://...")).

    ``num_tpus`` defaults to the number of this host's NVIDIA cards that
    ``CUDA_VISIBLE_DEVICES`` leaves visible; pass 0 to disable.
    """
    import os as _os
    import time as _time

    t_init = _time.time()
    if address is None:
        address = _os.environ.get("RAY_TPU_CLIENT_ADDRESS")
    if address:
        cur = api_internal.get_runtime()
        if cur is not None and getattr(cur, "is_client", False):
            # Honor the reinit contract in client mode too: never stack a
            # second connection under existing ObjectRefs.
            if ignore_reinit_error:
                return cur
            raise RuntimeError("ray_tpu_torch.init() called twice "
                               "(pass ignore_reinit_error=True to allow).")
        from ray_tpu_torch._private.client import client_connect

        key = _authkey or _os.environ.get("RAY_TPU_CLIENT_AUTHKEY")
        if not key:
            raise ValueError("client mode needs _authkey= or "
                             "RAY_TPU_CLIENT_AUTHKEY")
        rt = client_connect(address, bytes.fromhex(key))
        api_internal.set_global_runtime(rt)
        return rt
    rt = api_internal.get_runtime()
    if rt is not None:
        if isinstance(rt, Runtime) and not rt._stopped:
            if ignore_reinit_error:
                return rt
            raise RuntimeError("ray_tpu_torch.init() called twice "
                               "(pass ignore_reinit_error=True to allow).")
    if num_tpus is None:
        num_tpus = _detect_tpu_chips()
    config = Config.from_env(_system_config)
    rt = Runtime(config, num_cpus=num_cpus, num_tpus=num_tpus,
                 resources=resources, job_name=namespace)
    api_internal.set_global_runtime(rt)
    from ray_tpu_torch.util import tracing

    tracing.record_phase("runtime.init", t_init, _time.time())
    return rt


def _detect_tpu_chips() -> int:
    """Count this host's NVIDIA cards for the accelerator pool, without
    importing torch or creating a CUDA context in the driver (the cards
    belong to workers; reference analog: GPU autodetect in
    python/ray/_private/resource_spec.py).  ``RAY_TPU_FORCE_NUM_TPUS``
    overrides the count; otherwise the cards are NVML's (what
    ``nvidia-smi`` lists: a container may hold device files of cards it
    is denied), narrowed by ``CUDA_VISIBLE_DEVICES``."""
    import os

    if os.environ.get("RAY_TPU_FORCE_NUM_TPUS"):
        return int(os.environ["RAY_TPU_FORCE_NUM_TPUS"])
    return _visible_cards(_nvml_device_count(),
                          os.environ.get("CUDA_VISIBLE_DEVICES"))


def _nvml_device_count() -> int:
    """NVML's card count (0 without the driver's NVML library)."""
    import ctypes

    try:
        nvml = ctypes.CDLL("libnvidia-ml.so.1")
        if nvml.nvmlInit_v2() != 0:
            return 0
        count = ctypes.c_uint(0)
        ok = nvml.nvmlDeviceGetCount_v2(ctypes.byref(count)) == 0
        nvml.nvmlShutdown()
        return count.value if ok else 0
    except (OSError, AttributeError):
        return 0


def _visible_cards(n: int, visible: Optional[str]) -> int:
    """How many of ``n`` cards ``CUDA_VISIBLE_DEVICES=visible`` leaves: all
    when unset; else its entries up to the first that names no card (an
    index outside ``[0, n)`` or a repeat), as CUDA reads the list.  UUID
    entries (``GPU-...``, ``MIG-...``) count as one card each."""
    if visible is None:
        return n
    seen = set()
    for tok in (t.strip() for t in visible.split(",")):
        if tok.startswith(("GPU-", "MIG-")):
            key = tok
        elif tok.isdigit() and int(tok) < n:
            key = int(tok)
        else:
            break
        if key in seen:
            break
        seen.add(key)
    return min(len(seen), n)


def shutdown():
    rt = api_internal.get_runtime()
    if isinstance(rt, Runtime):
        rt.shutdown()
    elif rt is not None and getattr(rt, "is_client", False):
        rt.disconnect()
    api_internal.set_global_runtime(None)


def is_initialized() -> bool:
    rt = api_internal.get_runtime()
    return rt is not None and not getattr(rt, "_stopped", False)


def put(value: Any) -> ObjectRef:
    if isinstance(value, ObjectRef):
        raise TypeError("Calling put on an ObjectRef is not allowed "
                        "(reference parity: python/ray/_private/worker.py).")
    return api_internal.require_runtime().put_object(value)


def get(refs: Union[ObjectRef, Sequence[ObjectRef]],
        *, timeout: Optional[float] = None):
    rt = api_internal.require_runtime()
    if isinstance(refs, ObjectRef):
        return rt.get_objects([refs], timeout)[0]
    if isinstance(refs, (list, tuple)):
        for r in refs:
            if not isinstance(r, ObjectRef):
                raise TypeError(
                    f"ray_tpu_torch.get takes ObjectRefs, got {type(r).__name__}")
        return rt.get_objects(list(refs), timeout)
    raise TypeError(
        f"ray_tpu_torch.get takes an ObjectRef or list, got {type(refs).__name__}")


def wait(refs: Sequence[ObjectRef], *, num_returns: int = 1,
         timeout: Optional[float] = None, fetch_local: bool = True):
    rt = api_internal.require_runtime()
    if isinstance(refs, ObjectRef):
        raise TypeError("ray_tpu_torch.wait takes a list of ObjectRefs")
    refs = list(refs)
    if len(set(refs)) != len(refs):
        raise ValueError("ray_tpu_torch.wait got duplicate ObjectRefs")
    if num_returns > len(refs):
        raise ValueError("num_returns > number of refs")
    return rt.wait_objects(refs, num_returns, timeout, fetch_local)


def kill(actor_handle, *, no_restart: bool = True):
    from ray_tpu_torch.actor import ActorHandle

    if not isinstance(actor_handle, ActorHandle):
        raise TypeError("ray_tpu_torch.kill takes an ActorHandle")
    rt = api_internal.require_runtime()
    if rt.is_worker():
        rt._request(lambda rid: ("kill_actor_req", rid,
                                 actor_handle._actor_id, no_restart))
    else:
        rt.kill_actor(actor_handle._actor_id, no_restart)


def cancel(ref: ObjectRef, *, force: bool = False, recursive: bool = True):
    rt = api_internal.require_runtime()
    if rt.is_worker():
        raise NotImplementedError("cancel from inside tasks lands in v2")
    rt.cancel_task(ref.id(), force)


def cluster_resources() -> dict:
    return api_internal.require_runtime().cluster_resources()


def available_resources() -> dict:
    return api_internal.require_runtime().available_resources()


def nodes() -> List[dict]:
    return api_internal.require_runtime().list_nodes()
