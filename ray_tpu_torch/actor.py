"""Actors — stateful workers.

Reference: ``python/ray/actor.py`` (ActorClass :377, ``_remote`` :659,
ActorHandle :1022) + centralized actor management in the GCS
(``src/ray/gcs/gcs_server/gcs_actor_manager.h:281``) + ordered task
submission (``src/ray/core_worker/transport/direct_actor_task_submitter.h:67``).

Semantics kept from the reference: one process per actor, per-handle FIFO
method ordering, ``max_restarts`` restart-on-death, named actors with
namespaces, ``max_concurrency`` threaded actors, handles picklable into
tasks.  TPU-specific: an actor created with ``num_tpus=k`` owns k chips for
its lifetime — its process env pins the chips before any jax import, which
is the actor-model analog of one JAX process per TPU host.
"""

from __future__ import annotations

import hashlib
from typing import Any, Dict, Optional

from ray_tpu_torch._private import serialization
from ray_tpu_torch._private.api_internal import require_runtime
from ray_tpu_torch._private.ids import ActorID, new_task_id
from ray_tpu_torch._private.object_ref import ObjectRef
from ray_tpu_torch.remote_function import (
    _normalize_resources,
    _strategy_tuple,
    serialize_args,
)

_ACTOR_OPTIONS = {
    "num_cpus", "num_tpus", "num_gpus", "resources", "name", "namespace",
    "max_restarts", "max_concurrency", "lifetime", "runtime_env",
    "scheduling_strategy", "memory", "max_task_retries", "get_if_exists",
    "_metadata",
}


def method(**opts):
    """Per-method options decorator (reference: python/ray/actor.py
    ``@ray.method(num_returns=...)``)."""

    def wrap(fn):
        fn.__ray_method_options__ = opts
        return fn

    return wrap


class ActorMethod:
    def __init__(self, handle: "ActorHandle", name: str, num_returns: int):
        self._handle = handle
        self._name = name
        self._num_returns = num_returns

    def options(self, **overrides):
        m = ActorMethod(self._handle, self._name,
                        overrides.get("num_returns", self._num_returns))
        return m

    def _build_spec(self, rt, args, kwargs):
        """(spec, num_returns) for one call — the _bulk_submit hook."""
        spec = self._handle._build_method_spec(
            rt, self._name, args, kwargs, self._num_returns)
        return spec, self._num_returns

    def remote(self, *args, **kwargs):
        return self._handle._submit_method(
            self._name, args, kwargs, self._num_returns)


class ActorHandle:
    """Refcounted handle (reference: actor out-of-scope GC,
    gcs_actor_manager.h "RemoveActorNameFromRegistry on all handles out of
    scope").  Every live handle holds one count at the head; pickling a
    handle adds one IN-FLIGHT count that the deserialized copy takes
    ownership of (transfer-on-send).  When the count reaches zero the head
    terminates the actor after its queued work drains — unnamed,
    non-detached actors only (named actors here persist until killed or
    job end, a deliberate simplification)."""

    def __init__(self, actor_id: bytes, method_meta: Dict[str, int],
                 name: Optional[str] = None, *, _register: bool = True):
        self._actor_id = actor_id
        self._method_meta = method_meta
        self._name = name
        if _register:
            try:
                require_runtime().actor_handle_addref(actor_id)
            except Exception:
                pass  # runtime not up (e.g. handle built during shutdown)

    @property
    def _id_hex(self):
        return self._actor_id.hex()

    def __getattr__(self, item):
        meta = object.__getattribute__(self, "_method_meta")
        if item in meta:
            return ActorMethod(self, item, meta[item])
        raise AttributeError(
            f"Actor has no method {item!r}; remote methods: {sorted(meta)}")

    def _build_method_spec(self, rt, method_name, args, kwargs,
                           num_returns):
        """Spec for one method call (shared by .remote and the bulk
        submission helper, remote_function._bulk_submit)."""
        spec = {
            "task_id": new_task_id().binary(),
            "actor_id": self._actor_id,
            "method": method_name,
            "num_returns": num_returns,
            "name": f"actor.{method_name}",
            "func_id": None,
        }
        serialize_args(rt, args, kwargs, spec)
        return spec

    def _submit_method(self, method_name, args, kwargs, num_returns):
        rt = require_runtime()
        spec = self._build_method_spec(rt, method_name, args, kwargs,
                                       num_returns)
        refs = rt.submit_task(spec)
        if num_returns == 0:
            return None
        if num_returns == 1:
            return refs[0]
        return refs

    def __reduce__(self):
        # Transfer-on-send with a one-shot token: the serialized bytes
        # hold one count bound to ``token``; the FIRST deserialization
        # returns it (each copy registers its own count in __init__), so
        # a stored pickle materialized N times stays balanced.  A pickle
        # that is never deserialized holds its count until job end — the
        # documented slack vs the reference's full borrow protocol.
        import os as _os

        token = _os.urandom(8)
        try:
            require_runtime().actor_handle_serialized(self._actor_id,
                                                      token)
        except Exception:
            pass
        return (_rebuild_handle, (self._actor_id, self._method_meta,
                                  self._name, token))

    def __del__(self):
        try:
            require_runtime().actor_handle_decref(self._actor_id)
        except Exception:
            pass  # interpreter shutdown

    def __repr__(self):
        return f"ActorHandle({self._actor_id.hex()[:12]})"


def _rebuild_handle(actor_id, method_meta, name, token=None):
    h = ActorHandle(actor_id, method_meta, name)
    if token is not None:
        try:
            require_runtime().actor_handle_deserialized(actor_id, token)
        except Exception:
            pass
    return h


def _collect_methods(cls) -> Dict[str, int]:
    meta = {}
    for name in dir(cls):
        if name.startswith("__") and name != "__call__":
            continue
        fn = getattr(cls, name, None)
        if callable(fn):
            opts = getattr(fn, "__ray_method_options__", {})
            meta[name] = opts.get("num_returns", 1)
    return meta


class ActorClass:
    def __init__(self, cls, options: Optional[Dict[str, Any]] = None):
        for k in options or {}:
            if k not in _ACTOR_OPTIONS:
                raise ValueError(f"Invalid actor option {k!r}")
        self._cls = cls
        self._options = dict(options or {})
        self._payload: Optional[bytes] = None
        self._func_id: Optional[str] = None
        # dir()-walk of the class is invariant: computed once, shared by
        # clones (options() re-clones carry it over like _payload).
        self._method_meta: Optional[Dict[str, int]] = None
        self.__name__ = getattr(cls, "__name__", "Actor")

    def __call__(self, *a, **kw):
        raise TypeError(
            f"Actor class {self.__name__} cannot be instantiated directly; "
            f"use {self.__name__}.remote().")

    def options(self, **overrides) -> "ActorClass":
        merged = dict(self._options)
        merged.update(overrides)
        clone = ActorClass(self._cls, merged)
        clone._payload = self._payload
        clone._func_id = self._func_id
        clone._method_meta = self._method_meta
        return clone

    def bind(self, *args, **kwargs):
        """Lazy actor-construction DAG node (reference: python/ray/dag
        ClassNode); method .bind on the result adds ClassMethodNodes."""
        from ray_tpu_torch.dag.node import ClassNode

        return ClassNode(self, args, kwargs)

    def remote(self, *args, **kwargs) -> ActorHandle:
        rt = require_runtime()
        opts = self._options
        if opts.get("get_if_exists") and opts.get("name"):
            try:
                return get_actor(opts["name"],
                                 opts.get("namespace", "default"))
            except ValueError:
                pass
        if self._payload is None:
            try:
                self._payload = serialization.dumps_inline(self._cls)
            except Exception as err:  # noqa: BLE001 — diagnosed, re-raised
                from ray_tpu_torch.devtools.serializability import (
                    diagnose_pickle_error,
                )

                diagnose_pickle_error(self._cls, self.__name__, err)
            self._func_id = "actor-" + hashlib.sha1(
                self._payload).hexdigest()[:24]
        if self._method_meta is None:
            self._method_meta = _collect_methods(self._cls)
        method_meta = self._method_meta
        resources = _normalize_resources(opts)
        spec = {
            "task_id": new_task_id().binary(),
            "func_id": self._func_id,
            "num_returns": 1,
            "name": f"{self.__name__}.__init__",
            "resources": resources,
            "scheduling_strategy": _strategy_tuple(
                opts.get("scheduling_strategy")),
        }
        serialize_args(rt, args, kwargs, spec)
        creation_opts = {
            "max_restarts": opts.get("max_restarts", 0),
            # In-flight/queued method calls on a restarting actor are
            # replayed up to this many times each (0 = fail them with
            # ActorDiedError, the legacy behavior; -1 = unlimited).
            "max_task_retries": opts.get("max_task_retries", 0),
            "max_concurrency": opts.get("max_concurrency", 1),
            "name": opts.get("name"),
            "namespace": opts.get("namespace", "default"),
            "resources": resources,
            "scheduling_strategy": spec["scheduling_strategy"],
            "method_names": method_meta,
            "lifetime": opts.get("lifetime"),
        }
        spec["func_payload"] = self._payload
        if rt.is_worker():
            actor_id = rt._request(
                lambda rid: ("create_actor_req", rid, spec, creation_opts))
            if isinstance(actor_id, Exception):
                raise actor_id
        else:
            actor_id = rt.create_actor(spec, creation_opts)
        return ActorHandle(actor_id, method_meta, opts.get("name"))


def get_actor(name: str, namespace: str = "default") -> ActorHandle:
    rt = require_runtime()
    if rt.is_worker():
        reply = rt._request(lambda rid: ("get_actor_req", rid, name,
                                         namespace))
        ok, actor_id, method_meta = reply
        if not ok:
            raise ValueError(f"No actor named {name!r}")
        return ActorHandle(actor_id, method_meta, name)
    actor_id, actor = rt.get_named_actor(name, namespace)
    return ActorHandle(actor_id, actor.options.get("method_names", {}), name)
