"""Task timeline: aggregate execution spans into a Chrome/Perfetto trace.

Reference: ``ray timeline`` (``python/ray/scripts/scripts.py:1840`` — dumps
profiling events as chrome://tracing JSON) + the task-event span pipeline of
``python/ray/util/tracing/tracing_helper.py:164``.  Here every worker
records (task_id, name, start, end) wall-clock spans around execution
(worker_main._execute) and ships them to the head in periodic batches; this
module renders them in the Chrome trace-event format so a 1k-task run opens
directly in Perfetto / chrome://tracing.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

from ray_tpu_torch._private.api_internal import require_runtime


def get_task_spans(limit: int = 200_000) -> List[Dict[str, Any]]:
    """Raw execution spans aggregated at the head."""
    rt = require_runtime()
    if rt.is_worker():
        reply = rt._request(
            lambda rid: ("state_req", rid, "spans", {"limit": limit}))
        if isinstance(reply, Exception):
            raise reply
        return reply
    return rt.state_query("spans", limit=limit)


def handler_stats() -> List[Dict[str, Any]]:
    """Per-message-handler latency counters on the head loop
    (reference: src/ray/common/event_stats.h)."""
    rt = require_runtime()
    if rt.is_worker():
        reply = rt._request(
            lambda rid: ("state_req", rid, "handler_stats", {}))
        if isinstance(reply, Exception):
            raise reply
        return reply
    return rt.state_query("handler_stats")


def chrome_trace(spans: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Spans -> Chrome trace-event list ("X" complete events; pid=node,
    tid=worker, so Perfetto lays tasks out per worker lane)."""
    events: List[Dict[str, Any]] = []
    # Stable short lane ids: Perfetto renders pid/tid as numbers-with-
    # names via metadata events; thread names bind per (pid, tid), so
    # lanes are tracked as (node, worker) pairs.
    node_ids: Dict[str, int] = {}
    lane_ids: Dict[tuple, int] = {}
    for s in spans:
        node = s.get("node_id") or "head"
        pid = node_ids.setdefault(node, len(node_ids) + 1)
        tid = lane_ids.setdefault((node, s["worker_id"]),
                                  len(lane_ids) + 1)
        events.append({
            "name": s["name"],
            "cat": s.get("kind", "task"),
            "ph": "X",
            "ts": round(s["start"] * 1e6, 1),
            "dur": round((s["end"] - s["start"]) * 1e6, 1),
            "pid": pid,
            "tid": tid,
            "args": {"task_id": s["task_id"]},
        })
    for nid, pid in node_ids.items():
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "args": {"name": f"node {nid[:12]}"}})
    for (node, wid), tid in lane_ids.items():
        events.append({"name": "thread_name", "ph": "M",
                       "pid": node_ids[node], "tid": tid,
                       "args": {"name": f"worker {wid[:12]}"}})
    return events


def timeline(filename: Optional[str] = None):
    """Dump the cluster's task timeline (reference: ``ray.timeline()`` /
    ``ray timeline``).  With ``filename``, writes Chrome trace JSON and
    returns the path; otherwise returns the event list."""
    events = chrome_trace(get_task_spans())
    if filename is None:
        return events
    with open(filename, "w", encoding="utf-8") as f:
        json.dump(events, f)
    return filename
