"""Placement groups — gang scheduling of resource bundles.

Reference: ``python/ray/util/placement_group.py`` +
``src/ray/gcs/gcs_server/gcs_placement_group_manager.h:223`` (creation FSM,
2-phase bundle reservation) + shadow bundle resources
(``src/ray/raylet/placement_group_resource_manager.cc``).

TPU note: a placement group is the natural unit for a TPU slice — e.g. a
v5p-32 host group is one STRICT_PACK group of per-host bundles, so a Train
job's workers land on the hosts that share ICI.  See
ray_tpu_torch.train for the slice-aware helper that builds these.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

from ray_tpu_torch._private.api_internal import require_runtime
from ray_tpu_torch._private.ids import PlacementGroupID


class PlacementGroup:
    def __init__(self, state):
        self._state = state

    @property
    def id(self) -> PlacementGroupID:
        return self._state.pg_id

    @property
    def bundle_specs(self) -> List[Dict[str, float]]:
        return list(self._state.bundles)

    @property
    def bundle_count(self) -> int:
        return len(self._state.bundles)

    def ready(self):
        """ObjectRef-style readiness: returns an ObjectRef that resolves when
        all bundles are reserved (reference: PlacementGroup.ready())."""
        rt = require_runtime()
        fut = self._state.created_future
        if fut.done():
            return rt.put_object(True)

        from ray_tpu_torch._private.ids import ObjectID
        from ray_tpu_torch._private.object_ref import ObjectRef
        from ray_tpu_torch._private import protocol, serialization
        from ray_tpu_torch._private.runtime import ObjectState

        oid = ObjectID.for_put()
        with rt.lock:
            st = rt.objects[oid] = ObjectState()
            # The caller's reference, counted before the completion callback
            # can possibly fire — otherwise a ready() racing the reservation
            # frees the object and the ref resolves never.
            st.local_refs += 1

        descr = (protocol.INLINE, serialization.dumps_inline(True))

        def _complete(_f):
            with rt.lock:
                rt._complete_object_locked(oid, descr, ok=True)

        fut.add_done_callback(_complete)
        return ObjectRef(oid, _register=False)

    def wait(self, timeout_seconds: float = 30) -> bool:
        import concurrent.futures

        try:
            self._state.created_future.result(timeout=timeout_seconds)
            return True
        except concurrent.futures.TimeoutError:
            return False

    def __reduce__(self):
        raise TypeError("PlacementGroup handles are driver-local in v1")


def placement_group(bundles: List[Dict[str, float]], strategy: str = "PACK",
                    name: str = "", lifetime: Optional[str] = None
                    ) -> PlacementGroup:
    if strategy not in ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD"):
        raise ValueError(f"Invalid placement strategy {strategy!r}")
    norm = []
    for b in bundles:
        nb = {k: float(v) for k, v in b.items() if v}
        if not nb:
            raise ValueError("Empty bundle in placement group")
        norm.append(nb)
    rt = require_runtime()
    if rt.is_worker():
        raise NotImplementedError(
            "placement_group creation from workers lands in v2")
    state = rt.create_placement_group(norm, strategy, name)
    return PlacementGroup(state)


def remove_placement_group(pg: PlacementGroup):
    rt = require_runtime()
    rt.remove_placement_group(pg.id.binary())


def placement_group_table(pg: Optional[PlacementGroup] = None) -> dict:
    rt = require_runtime()
    with rt.lock:
        states = ([pg._state] if pg is not None
                  else list(rt.placement_groups.values()))
        out = {}
        for s in states:
            out[s.pg_id.hex()] = {
                "placement_group_id": s.pg_id.hex(),
                "name": s.name,
                "strategy": s.strategy,
                "bundles": {i: b for i, b in enumerate(s.bundles)},
                "state": ("REMOVED" if s.removed else
                          "CREATED" if s.created_future.done()
                          else "PENDING"),
                "bundle_nodes": [
                    n.hex() if n is not None else None for n in s.reserved],
            }
        return out if pg is None else next(iter(out.values()))
