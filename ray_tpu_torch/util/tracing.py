"""Task timeline: aggregate execution spans into a Chrome/Perfetto trace.

Reference: ``ray timeline`` (``python/ray/scripts/scripts.py:1840`` — dumps
profiling events as chrome://tracing JSON) + the task-event span pipeline of
``python/ray/util/tracing/tracing_helper.py:164``.  Here every worker
records (task_id, name, start, end) wall-clock spans around execution
(worker_main._execute) and ships them to the head in periodic batches; this
module renders them in the Chrome trace-event format so a 1k-task run opens
directly in Perfetto / chrome://tracing.

The same module is the port's in-process tracer:

- ``span(name)`` times a phase of the program (the train step's
  ``train.*``, the MoE layer's ``moe.*``).  Off by default, when it costs
  one module-global check and returns a shared no-op; after ``enable()``
  in a process it records host start and end on ``time.time_ns()``, a
  ``torch.cuda.Event`` pair on the current stream once the process has
  put work on a card (resolved into device seconds without a sync as
  later spans close), and, while a ``torch.profiler`` records, a
  ``record_function`` range beside the kernels.
- ``count(name, value)`` adds to a counter; a 0-d device tensor is added
  on the device and read at ``snapshot()``.  Nothing counts inside the
  recompute of an activation-checkpointed region (``remat_kwargs``), so a
  counter counts each forward batch once.
- Lifecycle phases (``phase``, ``record_phase``; ``runtime.init``,
  ``worker.boot``, ``train.process_group``) are always recorded, a few
  per process: into this process's list, and to the head as spans of
  kind ``"phase"``, so ``timeline()`` lays them beside the task spans.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional

from ray_tpu_torch._private.api_internal import get_runtime, require_runtime


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


# --- the in-process tracer --------------------------------------------------

_on = False
_torch = None             # the torch module, once enable() has run
_lock = threading.Lock()  # spans close on autograd's threads too
# name -> [count, host ns, device s, first start ns, last end ns]
_stats: Dict[str, List] = {}
_pending: collections.deque = collections.deque()  # (name, start, end ev)
_free_events: List[Any] = []
_counts: Dict[str, Any] = {}
_recomputing = 0
_phases: List[Dict[str, Any]] = []


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


def _event():
    """A timing event from the pool, recorded on the current stream."""
    try:
        ev = _free_events.pop()
    except IndexError:
        ev = _torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _fold(block: bool) -> None:
    """Resolve pending event pairs into device seconds, oldest first:
    those already done, or (``block``) all of them.  Under ``_lock``."""
    while _pending:
        name, start, end = _pending[0]
        if not block and not end.query():
            return
        _pending.popleft()
        _stats[name][2] += start.elapsed_time(end) / 1e3
        _free_events.extend((start, end))


class _Span:
    __slots__ = ("name", "t0", "rf", "ev0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.rf = None
        if _torch.autograd._profiler_enabled():
            self.rf = _torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.ev0 = _event() if _torch.cuda.is_initialized() else None
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        ev1 = _event() if self.ev0 is not None else None
        if self.rf is not None:
            self.rf.__exit__(*exc)
        with _lock:
            st = _stats.get(self.name)
            if st is None:
                st = _stats[self.name] = [0, 0, 0.0, self.t0, t1]
            st[0] += 1
            st[1] += t1 - self.t0
            st[4] = t1
            if ev1 is not None:
                _pending.append((self.name, self.ev0, ev1))
                _fold(block=False)
        return False


def span(name: str):
    """A context manager that times one phase: the shared no-op unless
    ``enable()`` was called in this process.  It closes on an exception
    too (a checkpoint's recompute may stop early by raising)."""
    if not _on:
        return _NO_SPAN
    return _Span(name)


def counting() -> bool:
    """Whether ``count`` counts here: tracing is on, and this is not the
    recompute of a checkpointed region."""
    return _on and not _recomputing


def count(name: str, value) -> None:
    """Add ``value`` (a number, or a 0-d tensor, added where it lives
    with no sync) to counter ``name`` when ``counting()``."""
    if not (_on and not _recomputing):
        return
    if hasattr(value, "detach"):
        value = value.detach()
    with _lock:
        acc = _counts.get(name)
        _counts[name] = value if acc is None else acc + value


@contextlib.contextmanager
def _recompute():
    global _recomputing
    with _lock:
        _recomputing += 1
    try:
        yield
    finally:
        with _lock:
            _recomputing -= 1


def _remat_contexts():
    return contextlib.nullcontext(), _recompute()


def remat_kwargs() -> Dict[str, Any]:
    """Keyword arguments for ``torch.utils.checkpoint.checkpoint``
    (non-reentrant): when tracing is on, its recompute runs with counting
    paused; when off, none."""
    return {"context_fn": _remat_contexts} if _on else {}


def enable() -> None:
    """Turn spans and counters on in this process."""
    global _on, _torch
    import torch

    _torch = torch
    _on = True


def disable() -> None:
    global _on
    _on = False


def reset() -> None:
    """Drop the spans and counters recorded so far (not the lifecycle
    phases)."""
    with _lock:
        while _pending:
            _, start, end = _pending.popleft()
            _free_events.extend((start, end))
        _stats.clear()
        _counts.clear()


def snapshot() -> Dict[str, Any]:
    """``{"spans": {name: {"count", "host_s", "device_s", "first_start",
    "last_end"}}, "counters": {name: number}, "lifecycle": [{"name",
    "start", "end"}]}``; times in seconds, ``first_start`` and
    ``last_end`` on ``time.time()``'s clock.  Syncs the card once when a
    span timed on it is pending; ``device_s`` is None for a span never
    timed on a card."""
    with _lock:
        if _pending:
            _torch.cuda.synchronize()
            _fold(block=True)
        timed = _torch is not None and _torch.cuda.is_initialized()
        spans = {n: {"count": c, "host_s": ns / 1e9,
                     "device_s": d if timed else None,
                     "first_start": t0 / 1e9, "last_end": t1 / 1e9}
                 for n, (c, ns, d, t0, t1) in _stats.items()}
        counters = {n: (v.item() if hasattr(v, "item") else v)
                    for n, v in _counts.items()}
    return {"spans": spans, "counters": counters,
            "lifecycle": [dict(p) for p in _phases]}


def lifecycle() -> List[Dict[str, Any]]:
    """This process's lifecycle phases so far: ``{"name", "start",
    "end"}``, seconds on ``time.time()``'s clock."""
    return [dict(p) for p in _phases]


def process_start() -> float:
    """This process's start, as ``time.time()`` would have read it (the
    kernel's start time, ``/proc/self/stat``); now where unreadable."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        age = (time.clock_gettime(time.CLOCK_BOOTTIME)
               - ticks / os.sysconf("SC_CLK_TCK"))
        return time.time() - age
    except (OSError, ValueError, IndexError, AttributeError):
        return time.time()


def record_phase(name: str, start: float, end: float,
                 task_id: Optional[bytes] = None) -> None:
    """Record a lifecycle phase: in this process's list, and at the head
    (a worker's ride its span batches; the driver's go in directly)."""
    _phases.append({"name": name, "start": start, "end": end})
    wm = sys.modules.get("ray_tpu_torch._private.worker_main")
    rt = wm.get_worker_runtime() if wm is not None else None
    if rt is not None:
        if task_id is None:
            cur = rt.current_task_id
            task_id = cur.binary() if cur is not None else b""
        rt.record_span(task_id, name, start, end, "phase")
        return
    rt = get_runtime()
    spans = getattr(rt, "task_spans", None)
    if spans is not None:
        with rt.lock:
            spans.append({"task_id": (task_id or b"").hex(), "name": name,
                          "start": start, "end": end, "kind": "phase",
                          "worker_id": "driver", "node_id": ""})


@contextlib.contextmanager
def phase(name: str):
    """Record the enclosed block as lifecycle phase ``name``."""
    start = time.time()
    try:
        yield
    finally:
        record_phase(name, start, time.time())
