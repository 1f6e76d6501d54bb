"""ObjectRef — a first-class future + distributed reference.

Reference analog: ``python/ray/includes/object_ref.pxi`` ObjectRef plus the
ownership model of ``src/ray/core_worker/reference_count.h:61`` (the caller
of a task owns its returns; refs are counted at the owner and freed when the
last handle drops).  Our refcounting protocol is deliberately simpler than
the reference's 1.6k-LoC borrowed-ref machinery: every ref increment/decrement
is routed to the owner's store (driver-resident in v1), and serializing a ref
into a task argument pins it until that task finishes.
"""

from __future__ import annotations

import weakref
from typing import Optional

from ray_tpu_torch._private.ids import ObjectID

# Set by the worker/driver context at init; lets __del__ and pickling find
# the live runtime without import cycles.
_runtime_accessor = None


def _set_runtime_accessor(fn):
    global _runtime_accessor
    _runtime_accessor = fn


class ObjectRef:
    __slots__ = ("_id", "_owner_hint", "__weakref__")

    def __init__(self, object_id: ObjectID, owner_hint: str = "", *,
                 _register: bool = True):
        self._id = object_id
        self._owner_hint = owner_hint
        if _register and _runtime_accessor is not None:
            rt = _runtime_accessor()
            if rt is not None:
                rt.add_local_reference(object_id)

    def id(self) -> ObjectID:
        return self._id

    def hex(self) -> str:
        return self._id.hex()

    def binary(self) -> bytes:
        return self._id.binary()

    def future(self):
        """concurrent.futures.Future resolving to the object's value."""
        rt = _runtime_accessor() if _runtime_accessor else None
        if rt is None:
            raise RuntimeError("ray_tpu_torch not initialized")
        return rt.object_future(self._id)

    def __await__(self):
        """asyncio integration (reference: ObjectRef.__await__ via
        asyncio.wrap_future)."""
        import asyncio

        return asyncio.wrap_future(self.future()).__await__()

    def __hash__(self):
        return hash(self._id)

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other._id == self._id

    def __repr__(self):
        return f"ObjectRef({self._id.hex()})"

    def __reduce__(self):
        # Serializing a ref (into task args or a put) notifies the runtime so
        # the object stays pinned while in flight (simplified borrowed-ref
        # protocol; reference: reference_count.cc borrower bookkeeping).
        rt = _runtime_accessor() if _runtime_accessor else None
        if rt is not None:
            rt.on_ref_serialized(self._id)
        return (_deserialize_ref, (self._id, self._owner_hint))

    def __del__(self):
        try:
            rt = _runtime_accessor() if _runtime_accessor else None
            if rt is not None:
                rt.remove_local_reference(self._id)
        except Exception:
            pass  # interpreter shutdown


def _deserialize_ref(object_id: ObjectID, owner_hint: str) -> ObjectRef:
    return ObjectRef(object_id, owner_hint)
