"""Serialization with zero-copy buffer support.

TPU-native equivalent of the reference's serialization stack
(``python/ray/_private/serialization.py`` + the cloudpickle fork +
pickle5 out-of-band buffers for zero-copy numpy).  We use stock
``cloudpickle`` (baked into the image) with pickle protocol 5: large
contiguous buffers (numpy arrays, jax host arrays, bytes) are split out
of the pickle stream so they can be placed directly into shared memory
and mapped zero-copy by consumers — same trick plasma + pickle5 play in
the reference (``python/ray/includes/serialization.pxi``).

Layout of a serialized object:
    meta:    pickle-5 stream with out-of-band buffer references
    buffers: list of contiguous memoryviews, 64-byte aligned when placed
             into a shm segment (TPU DMA + numpy both like alignment).
"""

from __future__ import annotations

import pickle
from typing import Any, List, Tuple

import cloudpickle

ALIGNMENT = 64


def loads(meta: bytes, buffers: List[memoryview]) -> Any:
    return pickle.loads(meta, buffers=buffers)


def dumps_adaptive(value: Any, max_inline: int):
    """One serialization pass deciding inline vs out-of-band placement.

    Returns ``("inline", data)`` for values whose serialized form fits
    ``max_inline`` (data is a self-contained in-band pickle stream), else
    ``("parts", meta, buffer_views, total_size)`` for the shm path where
    each buffer is memcpy'd exactly once into the segment.

    When no out-of-band buffers were captured, ``meta`` is already a
    complete loadable stream — no second pickle pass.
    """
    buffers: List[pickle.PickleBuffer] = []
    meta = cloudpickle.dumps(value, protocol=5, buffer_callback=buffers.append)
    if not buffers:
        if len(meta) <= max_inline:
            return ("inline", meta)
        return ("parts", meta, [], len(meta))
    views = []
    for b in buffers:
        raw = b.raw()
        if not raw.contiguous:
            raw = memoryview(bytes(raw))
        views.append(raw.cast("B"))
    total = len(meta) + sum(len(v) for v in views)
    if total <= max_inline:
        # Small-but-buffered (e.g. a tiny ndarray): re-pickle in-band.
        return ("inline", cloudpickle.dumps(value, protocol=5))
    return ("parts", meta, views, total)


def dumps_inline(value: Any) -> bytes:
    """Single-buffer serialization for small objects carried inside protocol
    messages (reference: inline objects below max_direct_call_object_size,
    src/ray/common/ray_config_def.h:212)."""
    return cloudpickle.dumps(value, protocol=5)


def loads_inline(data: bytes) -> Any:
    return pickle.loads(data)


def aligned_offsets(sizes: List[int], base: int = 0) -> Tuple[List[int], int]:
    """Compute ALIGNMENT-aligned offsets for buffers packed in one segment.

    Returns (offsets, total_size)."""
    offsets = []
    cur = base
    for s in sizes:
        cur = (cur + ALIGNMENT - 1) // ALIGNMENT * ALIGNMENT
        offsets.append(cur)
        cur += s
    return offsets, cur
