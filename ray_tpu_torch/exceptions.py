"""User-facing exception hierarchy.

Parity with the reference's ``python/ray/exceptions.py`` (RayError,
RayTaskError, RayActorError, ObjectLostError, GetTimeoutError, ...).  The
semantics mirror the ownership model: a task failure is delivered to whoever
``get``s any of its return objects (reference:
``src/ray/core_worker/task_manager.h:90`` stores errors as objects).
"""

from __future__ import annotations

import traceback


class RayTpuError(Exception):
    """Base class for all framework errors."""


# Alias matching the reference spelling for drop-in familiarity.
RayError = RayTpuError


class TaskError(RayTpuError):
    """A remote task raised; re-raised at the caller's ``get``
    (reference: python/ray/exceptions.py RayTaskError)."""

    def __init__(self, function_name: str, cause_repr: str, tb_str: str,
                 cause: BaseException | None = None):
        self.function_name = function_name
        self.cause_repr = cause_repr
        self.tb_str = tb_str
        self.cause = cause
        super().__init__(self._format())

    def _format(self) -> str:
        return (
            f"Task {self.function_name} failed.\n"
            f"{self.tb_str}"
        )

    def __reduce__(self):
        return (TaskError, (self.function_name, self.cause_repr,
                            self.tb_str, self.cause))

    @classmethod
    def from_exception(cls, function_name: str, exc: BaseException) -> "TaskError":
        tb = "".join(traceback.format_exception(type(exc), exc, exc.__traceback__))
        # Keep the original exception when it pickles cleanly so callers can
        # except on its type; fall back to the repr otherwise.
        return cls(function_name, repr(exc), tb, cause=exc)


RayTaskError = TaskError


class ActorError(RayTpuError):
    """The actor died before or during this call
    (reference: python/ray/exceptions.py RayActorError)."""


RayActorError = ActorError


class ActorDiedError(ActorError):
    pass


class ActorUnavailableError(ActorError):
    pass


class WorkerCrashedError(RayTpuError):
    """Worker process died while executing a task
    (reference: WORKER_DIED error type in common.proto)."""


class OutOfMemoryError(WorkerCrashedError):
    """The memory monitor killed the task's worker under node memory
    pressure and its retries are exhausted (reference:
    src/ray/common/memory_monitor.h + OUT_OF_MEMORY error type —
    kill retriable tasks before the kernel OOM-killer takes the node)."""


class ObjectLostError(RayTpuError):
    """Object's value is unrecoverable (owner gone, store evicted and no
    lineage).

    One constructor for every raise site, carrying structured fields the
    recovery subsystem keys off (reference: the typed error-object
    payloads of ``common.proto`` — OBJECT_UNRECONSTRUCTABLE and friends
    carry the object/owner identity, not prose):

    - ``object_id``: hex of the lost object (when known),
    - ``owner``: who held its metadata ("driver", a worker id hex, ...),
    - ``home``: last-known home store id of the segment,
    - ``phase``: where the loss was observed ("get", "pull", "dispatch",
      "relay", "recover", ...).

    ``reconstructable`` is the class-level recovery gate: lineage MAY
    rebuild plain lost objects; subclasses for freed objects and dead
    owners opt out — recovery refuses those by type, not by message
    text."""

    reconstructable = True

    def __init__(self, message: str | None = None, *,
                 object_id: str | None = None, owner: str | None = None,
                 home: str | None = None, phase: str | None = None):
        self.object_id = object_id
        self.owner = owner
        self.home = home
        self.phase = phase
        super().__init__(message if message is not None else self._format())

    def _format(self) -> str:
        parts = [f"Object {self.object_id or '<unknown>'} is lost"]
        detail = [f"{k}={v}" for k, v in (("phase", self.phase),
                                          ("home", self.home),
                                          ("owner", self.owner)) if v]
        if detail:
            parts.append(f" ({', '.join(detail)})")
        parts.append("" if type(self) is not ObjectLostError
                     else "; no lineage survives to reconstruct it")
        return "".join(parts)

    def __reduce__(self):
        return (_rebuild_object_lost,
                (type(self), self.args[0] if self.args else None,
                 self.object_id, self.owner, self.home, self.phase))


def _rebuild_object_lost(cls, message, object_id, owner, home, phase):
    return cls(message, object_id=object_id, owner=owner, home=home,
               phase=phase)


class ObjectFreedError(ObjectLostError):
    """The object was explicitly freed / its last reference dropped —
    never reconstructable (reference: OBJECT_FREED error type)."""

    reconstructable = False


class OwnerDiedError(ObjectLostError):
    """The object's owner process died; its metadata (and lineage) died
    with it — never reconstructable (reference: OWNER_DIED)."""

    reconstructable = False


class GetTimeoutError(RayTpuError, TimeoutError):
    """``ray.get(timeout=...)`` expired."""


class TaskCancelledError(RayTpuError):
    """Task was cancelled with ``ray.cancel``."""


class RuntimeEnvSetupError(RayTpuError):
    pass


class PendingCallsLimitExceeded(RayTpuError):
    pass


class NodeDiedError(RayTpuError):
    pass
