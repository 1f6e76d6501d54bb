"""Land one value as a committed segment in a node's object store, and
take it back once.

Two paths carry values too big for a control-plane message: the
disaggregated serving handoff (a prefill replica's chain of KV pages) and
the train session's streamed checkpoints.  A message of hundreds of MB
holds its sender's send lock until the head has read all of it, so the
sender's replies to the head's liveness probes wait behind it, and a
worker can be declared dead mid-transfer.  ``land`` writes the value into
the node store named by ``store`` instead (its own node's store
directly, a peer's over the put verbs) and returns a descriptor small
enough for any message; ``take`` maps the segment, copies out what the
caller needs and frees it, which returns the byte accounting the put
charged.  A committed segment outlives the process that wrote it.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Optional

from ray_tpu_torch._private import (api_internal, object_transfer,
                                    serialization, shm_store)
from ray_tpu_torch._private.config import GLOBAL_CONFIG
from ray_tpu_torch._private.ids import ObjectID


def land(value: Any, store: Optional[str]) -> Optional[tuple]:
    """``(kind, ident, total)`` of ``value`` committed in node store
    ``store`` (kind ``"shm"``, or ``"spilled"`` past the store's
    capacity), or None when no put path reaches it: no store named, no
    runtime in this process, a peer store that takes no puts, or a put
    that failed."""
    if not store:
        return None
    try:
        rt = api_internal.require_runtime()
    except RuntimeError:
        return None
    res = serialization.dumps_adaptive(value, 0)  # parts form
    meta, bufs = res[1], res[2]
    oid_bin = ObjectID.for_put().binary()
    try:
        if store != rt.store_id:
            ent = rt.resolve_store_addr(store)
            if ent is None or \
                    not object_transfer.peer_accepts_puts(ent[1]):
                return None
            return tuple(rt._pusher.push(
                store, ent[0], oid_bin, meta, bufs, caps=ent[1],
                stripe_threshold=GLOBAL_CONFIG.kv_stream_stripe_threshold))
        return tuple(shm_store.put_local(rt.shm, oid_bin, meta, bufs))
    except Exception:  # noqa: BLE001 -- any put failure: no segment
        if store != rt.store_id:
            rt.forget_store_addr(store)
        return None


def take(descr: tuple, copy_out: Callable[[Any], Any]) -> Any:
    """Map segment ``descr`` (from ``land``) in this node's store and
    return ``copy_out(value)``; ``copy_out`` must copy whatever aliases
    the mapping.  The segment is freed."""
    kind, ident, total = descr[0], descr[1], int(descr[2])
    rt = api_internal.require_runtime()
    seg = (rt.shm.attach_path(ident) if kind == "spilled"
           else rt.shm.attach(ident))
    try:
        out = copy_out(seg.deserialize())
    finally:
        seg.close()
    if kind == "spilled":
        try:
            os.unlink(ident)
        except OSError:
            pass
    else:
        rt.shm.unlink(ident, total)
    return out
