"""@remote functions.

Reference: ``python/ray/remote_function.py:35`` (RemoteFunction, ``_remote``
:241) — a decorated function becomes a handle whose ``.remote(*args)``
serializes arguments, registers the function once (content-addressed, like
the reference's function table exported via GCS KV,
``python/ray/_private/function_manager.py``), and submits a task spec to the
runtime.  ``.options(**overrides)`` returns a shallow clone, same as the
reference's options protocol (``python/ray/_private/ray_option_utils.py``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from ray_tpu_torch._private import serialization
from ray_tpu_torch._private.api_internal import require_runtime
from ray_tpu_torch._private.ids import new_task_id
from ray_tpu_torch._private.object_ref import ObjectRef

_VALID_OPTIONS = {
    "num_cpus", "num_tpus", "num_gpus", "resources", "num_returns",
    "max_retries", "name", "runtime_env", "scheduling_strategy",
    "memory", "retry_exceptions", "_metadata",
}


def _normalize_resources(opts: Dict[str, Any]) -> Dict[str, float]:
    req: Dict[str, float] = {}
    num_cpus = opts.get("num_cpus")
    req["CPU"] = float(1 if num_cpus is None else num_cpus)
    if opts.get("num_tpus"):
        req["TPU"] = float(opts["num_tpus"])
    if opts.get("num_gpus"):
        # GPU requests map onto the TPU resource pool so reference code
        # written against num_gpus schedules unchanged on a TPU node.
        req["TPU"] = float(opts["num_gpus"])
    if opts.get("memory"):
        req["memory"] = float(opts["memory"])
    for k, v in (opts.get("resources") or {}).items():
        req[k] = float(v)
    req = {k: v for k, v in req.items() if v != 0}
    return req or {"CPU": 0.0}


def _strategy_tuple(strategy):
    if strategy is None:
        return None
    from ray_tpu_torch.util.scheduling_strategies import (
        NodeAffinitySchedulingStrategy,
        PlacementGroupSchedulingStrategy,
    )

    if isinstance(strategy, PlacementGroupSchedulingStrategy):
        return ("placement_group",
                strategy.placement_group.id.binary(),
                strategy.placement_group_bundle_index or 0)
    if isinstance(strategy, NodeAffinitySchedulingStrategy):
        return ("node_affinity", strategy.node_id, strategy.soft)
    if strategy == "SPREAD":
        return ("spread",)
    if strategy == "DEFAULT":
        return None
    raise ValueError(f"Unknown scheduling strategy: {strategy!r}")


def serialize_args(rt, args, kwargs, spec):
    """Top-level args: refs stay refs (dependencies); values become
    descriptors (reference: inline vs plasma promotion at submit,
    ``src/ray/core_worker/core_worker.cc`` SubmitTask arg handling)."""
    tmp_segments = []

    def one(a, where):
        if isinstance(a, ObjectRef):
            return ("ref", a.id().binary())
        from ray_tpu_torch._private.ids import ObjectID

        oid = ObjectID.for_put()
        try:
            descr = rt.serialize_value(a, oid)
        except Exception as err:  # noqa: BLE001 — diagnosed and re-raised
            # A raw "cannot pickle _thread.lock" from three frames deep is
            # useless for a 40-field config; walk the argument and name
            # the exact leaf (e.g. arg[0].fn.__closure__['model']).
            from ray_tpu_torch.devtools.serializability import diagnose_pickle_error

            diagnose_pickle_error(a, where, err)
        if descr[0] in ("shm", "spilled"):
            # Ephemeral arg storage (segment name, or spill-file path when
            # the store was full) — freed when the task / its lineage ends.
            tmp_segments.append((descr[1], descr[2]))
        return descr

    # Refs nested inside argument containers are collected during pickling
    # and pinned by the runtime until the task completes (simplified borrow
    # protocol; reference: reference_count.cc borrowed refs).
    rt.begin_ref_collection()
    try:
        try:
            spec["args"] = [one(a, f"arg[{i}]") for i, a in enumerate(args)]
            spec["kwargs"] = {k: one(v, f"kwargs[{k!r}]")
                              for k, v in (kwargs or {}).items()}
        except BaseException:
            # The spec is never submitted, so the runtime's task-end path
            # will never free segments already written for EARLIER args;
            # a retried failing call would otherwise leak one per attempt.
            import os as _os

            shm = getattr(rt, "shm", None)
            for name, size in tmp_segments:
                try:
                    if _os.path.isabs(name):
                        # Spill file (store-full fallback): plain unlink —
                        # routing it through ShmStore.unlink would debit
                        # shm accounting for bytes never charged to it
                        # (mirrors runtime._release_spec_resources).
                        _os.unlink(name)
                    elif shm is not None:
                        shm.unlink(name, size)
                except Exception:
                    pass
            raise
    finally:
        spec["nested_refs"] = rt.end_ref_collection()
    spec["tmp_segments"] = tmp_segments


class RemoteFunction:
    def __init__(self, fn, options: Optional[Dict[str, Any]] = None):
        for k in options or {}:
            if k not in _VALID_OPTIONS:
                raise ValueError(f"Invalid @remote option {k!r}")
        self._fn = fn
        self._options = dict(options or {})
        self._payload: Optional[bytes] = None
        self._func_id: Optional[str] = None
        self._registered_with: Optional[str] = None
        # Options never change after construction (.options() clones), so
        # the normalized resource dict and strategy tuple are computed
        # once — the per-call work on the fan-out hot path is then dict
        # copies only.
        self._req_cache: Optional[Dict[str, float]] = None
        self._strategy_cache = None
        self.__name__ = getattr(fn, "__name__", "remote_fn")
        self.__doc__ = getattr(fn, "__doc__", None)

    def __call__(self, *a, **kw):
        raise TypeError(
            f"Remote function {self.__name__} cannot be called directly; "
            f"use {self.__name__}.remote().")

    def options(self, **overrides) -> "RemoteFunction":
        merged = dict(self._options)
        merged.update(overrides)
        clone = RemoteFunction(self._fn, merged)
        clone._payload = self._payload
        clone._func_id = self._func_id
        return clone

    def _ensure_registered(self, rt):
        if self._payload is None:
            try:
                self._payload = serialization.dumps_inline(self._fn)
            except Exception as err:  # noqa: BLE001 — diagnosed, re-raised
                from ray_tpu_torch.devtools.serializability import (
                    diagnose_pickle_error,
                )

                diagnose_pickle_error(self._fn, self.__name__, err)
        if rt.is_worker():
            import hashlib

            if self._func_id is None:
                self._func_id = hashlib.sha1(self._payload).hexdigest()[:24]
            return self._func_id, self._payload
        # Register once per runtime SESSION (re-registering after
        # shutdown/init matters; re-hashing on every .remote() does not).
        # Keyed by session_id, not id(rt): a new Runtime can reuse the
        # freed old one's memory address.
        session = getattr(rt, "session_id", None)
        if self._func_id is None or self._registered_with != session:
            self._func_id = rt.register_function(self._payload)
            self._registered_with = session
        return self._func_id, None

    def bind(self, *args, **kwargs):
        """Lazy DAG node instead of immediate submission (reference:
        python/ray/dag — fn.bind builds a FunctionNode)."""
        from ray_tpu_torch.dag.node import FunctionNode

        return FunctionNode(self, args, kwargs)

    def _build_spec(self, rt, args, kwargs):
        """Spec for one call (shared by .remote and _bulk_submit)."""
        func_id, payload = self._ensure_registered(rt)
        opts = self._options
        if self._req_cache is None:
            self._req_cache = _normalize_resources(opts)
            self._strategy_cache = _strategy_tuple(
                opts.get("scheduling_strategy"))
        num_returns = opts.get("num_returns", 1)
        spec = {
            "task_id": new_task_id().binary(),
            "func_id": func_id,
            "num_returns": num_returns,
            "name": opts.get("name") or self.__name__,
            "resources": dict(self._req_cache),
            "max_retries": opts.get("max_retries", 3),
            "runtime_env": opts.get("runtime_env"),
            "scheduling_strategy": self._strategy_cache,
        }
        # max_retries budgets SYSTEM failures (worker/node death) only;
        # application exceptions retry solely under this opt-in (True =
        # any app error, or exception type(s) matched against the task
        # error's cause) — reference: retry_exceptions on @ray.remote.
        # Carried only when set so default specs stay lean; a bare
        # class (the natural shorthand) normalizes to a one-element
        # list, and anything else non-boolean must be iterable —
        # silently ignoring a malformed opt-in would fail the user's
        # task permanently with no hint the option never applied.
        rexc = opts.get("retry_exceptions")
        if rexc is not None:
            if isinstance(rexc, type) and issubclass(rexc, BaseException):
                rexc = [rexc]
            elif isinstance(rexc, (list, tuple)):
                bad = [t for t in rexc
                       if not (isinstance(t, type)
                               and issubclass(t, BaseException))]
                if bad:
                    raise TypeError(
                        "retry_exceptions entries must be exception "
                        f"types; got {bad!r}")
            elif not isinstance(rexc, bool):
                raise TypeError(
                    "retry_exceptions must be True/False, an exception "
                    f"type, or a list of exception types; got {rexc!r}")
            spec["retry_exceptions"] = rexc
        serialize_args(rt, args, kwargs, spec)
        if payload is not None and rt.is_worker():
            spec["func_payload"] = payload
        return spec, num_returns

    def remote(self, *args, **kwargs):
        rt = require_runtime()
        spec, num_returns = self._build_spec(rt, args, kwargs)
        refs = rt.submit_task(spec)
        if num_returns == 0:
            return None
        if num_returns == 1:
            return refs[0]
        return refs


def _bulk_submit(calls):
    """Internal fan-out helper: ``calls`` is a sequence of
    (handle, args, kwargs) triples where ``handle`` is a RemoteFunction
    or an ActorMethod.  Builds every spec up front, then submits the
    whole list through the runtime's bulk path — ONE lock acquisition
    and one dispatch pass instead of n (reference: the batched gRPC
    submissions of direct_task_transport.cc).  Returns exactly what the
    n individual ``handle.remote(*args, **kwargs)`` calls would have."""
    rt = require_runtime()
    specs = []
    counts = []
    for handle, args, kwargs in calls:
        spec, num_returns = handle._build_spec(rt, args, kwargs or {})
        specs.append(spec)
        counts.append(num_returns)
    out = []
    for num_returns, refs in zip(counts, rt.submit_tasks(specs)):
        if num_returns == 0:
            out.append(None)
        elif num_returns == 1:
            out.append(refs[0])
        else:
            out.append(refs)
    return out


def remote_decorator(options: Optional[Dict[str, Any]] = None):
    def wrap(fn_or_cls):
        import inspect

        if inspect.isclass(fn_or_cls):
            from ray_tpu_torch.actor import ActorClass

            return ActorClass(fn_or_cls, options)
        return RemoteFunction(fn_or_cls, options)

    return wrap
