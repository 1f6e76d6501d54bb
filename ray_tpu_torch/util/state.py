"""State observability API: list/summarize cluster entities.

Reference: ``python/ray/experimental/state/api.py`` (``list_actors`` :738,
``list_tasks`` :961, ``list_objects`` :1005, ``summarize_tasks`` :1278) —
the same query surface over the runtime's authoritative tables instead of
a separate state aggregator service (the tables live driver-side here, so
aggregation is a read under the lock; workers reach them via one control
round trip).
"""

from __future__ import annotations

from collections import Counter as _Counter
from typing import Any, Dict, List, Optional

from ray_tpu_torch._private.api_internal import require_runtime


def _query(kind: str, **kwargs) -> List[Dict[str, Any]]:
    rt = require_runtime()
    if rt.is_worker():
        reply = rt._request(lambda rid: ("state_req", rid, kind, kwargs))
        if isinstance(reply, Exception):
            raise reply
        return reply
    return rt.state_query(kind, **kwargs)


def list_nodes(**kw) -> List[Dict[str, Any]]:
    return _query("nodes", **kw)


def list_actors(**kw) -> List[Dict[str, Any]]:
    return _query("actors", **kw)


def list_tasks(**kw) -> List[Dict[str, Any]]:
    return _query("tasks", **kw)


def list_objects(**kw) -> List[Dict[str, Any]]:
    return _query("objects", **kw)


def list_workers(**kw) -> List[Dict[str, Any]]:
    return _query("workers", **kw)


def list_placement_groups(**kw) -> List[Dict[str, Any]]:
    return _query("placement_groups", **kw)


def get_worker_log(worker_id: str = "", tail: int = 200
                   ) -> List[Dict[str, Any]]:
    """Captured stdout/stderr lines of workers (reference: the log
    files under the session dir + `ray logs`); ``worker_id`` may be a
    hex prefix."""
    return _query("worker_log", worker_id=worker_id, tail=tail)


def summarize_tasks() -> Dict[str, int]:
    """Task-name x state counts (reference: summarize_tasks, api.py:1278)."""
    counts: _Counter = _Counter()
    for t in list_tasks():
        counts[(t["name"], t["state"])] += 1
    return {f"{name}:{state}": n for (name, state), n in counts.items()}
