"""Binary IDs for tasks, objects, actors, and nodes.

TPU-native re-design of the reference's ID model (reference:
``src/ray/common/id.h:58,127,175,261,333`` — BaseID/TaskID/ObjectID/ActorID/
PlacementGroupID).  The reference packs lineage into the ID bytes (an ObjectID
embeds its generating TaskID plus a return index).  We keep that property —
it gives free owner routing and makes IDs self-describing — but use a smaller
16-byte layout since we do not need Ray's legacy 28-byte compatibility.
"""

from __future__ import annotations

import os
import threading
import binascii

_ID_SIZE = 16

# ObjectID = 12-byte task prefix + 4-byte little-endian index.
_TASK_PREFIX_SIZE = 12
_INDEX_SIZE = 4


class BaseID:
    """Immutable binary identifier (reference: src/ray/common/id.h:58)."""

    __slots__ = ("_bytes", "_hash")

    def __init__(self, id_bytes: bytes):
        if len(id_bytes) != _ID_SIZE:
            raise ValueError(
                f"{type(self).__name__} must be {_ID_SIZE} bytes, got {len(id_bytes)}"
            )
        self._bytes = bytes(id_bytes)
        self._hash = hash(self._bytes)

    @classmethod
    def from_random(cls):
        return cls(os.urandom(_ID_SIZE))

    @classmethod
    def from_hex(cls, hex_str: str):
        return cls(binascii.unhexlify(hex_str))

    @classmethod
    def nil(cls):
        return cls(b"\x00" * _ID_SIZE)

    def is_nil(self) -> bool:
        return self._bytes == b"\x00" * _ID_SIZE

    def binary(self) -> bytes:
        return self._bytes

    def hex(self) -> str:
        return self._bytes.hex()

    def __hash__(self):
        return self._hash

    def __eq__(self, other):
        return type(other) is type(self) and other._bytes == self._bytes

    def __ne__(self, other):
        return not self.__eq__(other)

    def __repr__(self):
        return f"{type(self).__name__}({self._bytes.hex()})"

    def __reduce__(self):
        return (type(self), (self._bytes,))


class UniqueID(BaseID):
    pass


class NodeID(BaseID):
    pass


class WorkerID(BaseID):
    pass


class JobID(BaseID):
    pass


class ActorID(BaseID):
    pass


class PlacementGroupID(BaseID):
    pass


class TaskID(BaseID):
    """Task identifier; its first 12 bytes prefix the ObjectIDs it returns
    (reference: src/ray/common/id.h:175 — ObjectID embeds owner TaskID)."""

    def object_id(self, index: int) -> "ObjectID":
        return ObjectID(
            self._bytes[:_TASK_PREFIX_SIZE] + index.to_bytes(_INDEX_SIZE, "little")
        )


class ObjectID(BaseID):
    """Object identifier = task prefix + return index
    (reference: src/ray/common/id.h:261)."""

    def task_prefix(self) -> bytes:
        return self._bytes[:_TASK_PREFIX_SIZE]

    def return_index(self) -> int:
        return int.from_bytes(self._bytes[_TASK_PREFIX_SIZE:], "little")

    @classmethod
    def for_put(cls) -> "ObjectID":
        # Puts share the seed+counter prefix space with index 0xFFFFFFFF
        # to distinguish from task returns (whose index is a small int).
        n = _task_counter.next()
        return cls(_PROC_SEED + (n & 0xFFFFFFFF).to_bytes(4, "little")
                   + b"\xff\xff\xff\xff")

    def is_put(self) -> bool:
        return self._bytes[_TASK_PREFIX_SIZE:] == b"\xff\xff\xff\xff"


class _Counter:
    def __init__(self):
        self._lock = threading.Lock()
        self._n = 0

    def next(self) -> int:
        with self._lock:
            self._n += 1
            return self._n


_task_counter = _Counter()

# One entropy draw per process; ids are seed + counter (reference: task
# ids are deterministic child ids, id.h:175 — and os.urandom per id was
# ~40us, a measurable slice of the per-task submit budget).
_PROC_SEED = os.urandom(_TASK_PREFIX_SIZE - 4)


def new_task_id() -> TaskID:
    """Process-unique task ID: 8-byte process seed + 4-byte counter
    prefix (collision across processes needs a seed collision)."""
    n = _task_counter.next()
    return TaskID(_PROC_SEED + (n & 0xFFFFFFFF).to_bytes(4, "little")
                  + b"\x00\x00\x00\x00")
