"""User-defined metrics: Counter / Gauge / Histogram.

Reference: ``python/ray/util/metrics.py`` (Counter :155, Histogram :220,
Gauge :295) — the same tagged-metric surface.  Transport re-designed for
this runtime: worker-side records ride the existing worker->driver pubsub
(fire-and-forget, batched with the connection's message flow) instead of
the reference's OpenCensus -> per-node metrics agent -> Prometheus chain;
the driver aggregates on demand.  ``snapshot()`` returns the merged view.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ray_tpu_torch._private import serialization
from ray_tpu_torch._private.api_internal import require_runtime

_TOPIC = "_metrics"

# Driver-side aggregate: {(kind, name, tags): state}
_agg: Dict[tuple, Any] = {}
_agg_lock = threading.Lock()


def _record(kind: str, name: str, tags: Tuple[tuple, ...], value: float,
            boundaries: Optional[Tuple[float, ...]] = None):
    rt = require_runtime()
    rec = (kind, name, tags, float(value), boundaries)
    if rt.is_worker():
        rt.publish_event(_TOPIC, serialization.dumps_inline(rec))
    else:
        _apply(rec)


def _apply(rec):
    kind, name, tags, value, boundaries = rec
    key = (kind, name, tags)
    with _agg_lock:
        if kind == "counter":
            _agg[key] = _agg.get(key, 0.0) + value
        elif kind == "gauge":
            _agg[key] = value
        elif kind == "histogram":
            st = _agg.get(key)
            if st is None:
                st = _agg[key] = {"count": 0, "sum": 0.0,
                                  "boundaries": boundaries or (),
                                  "buckets": [0] * (len(boundaries or ())
                                                    + 1)}
            st["count"] += 1
            st["sum"] += value
            i = 0
            for i, b in enumerate(st["boundaries"]):
                if value <= b:
                    break
            else:
                i = len(st["boundaries"])
            st["buckets"][i] += 1


def _drain_worker_records():
    """Driver: merge any worker-published records into the aggregate."""
    rt = require_runtime()
    if rt.is_worker():
        return
    for payload in rt.poll_events(_TOPIC):
        try:
            _apply(serialization.loads_inline(payload))
        except Exception:
            pass


def snapshot() -> Dict[str, Any]:
    """{name{tags}: value} merged across driver + all workers (driver
    only).  Counters sum, gauges keep last-written, histograms expose
    count/sum/buckets."""
    _drain_worker_records()
    out: Dict[str, Any] = {}
    with _agg_lock:
        for (kind, name, tags), v in _agg.items():
            tag_s = ",".join(f"{k}={val}" for k, val in tags)
            key = f"{name}{{{tag_s}}}" if tag_s else name
            out[key] = dict(v) if isinstance(v, dict) else v
    return out


def reset():
    with _agg_lock:
        _agg.clear()


class _Metric:
    kind = ""

    def __init__(self, name: str, description: str = "",
                 tag_keys: Sequence[str] = ()):
        if not name:
            raise ValueError("metric name required")
        self._name = name
        self._description = description
        self._tag_keys = tuple(tag_keys)
        self._default_tags: Dict[str, str] = {}

    def set_default_tags(self, tags: Dict[str, str]):
        self._default_tags = dict(tags)
        return self

    def _tags(self, tags: Optional[Dict[str, str]]) -> Tuple[tuple, ...]:
        merged = dict(self._default_tags)
        if tags:
            unknown = set(tags) - set(self._tag_keys)
            if unknown:
                raise ValueError(
                    f"tags {sorted(unknown)} not in tag_keys "
                    f"{self._tag_keys}")
            merged.update(tags)
        return tuple(sorted(merged.items()))


class Counter(_Metric):
    """Monotonically increasing (reference: util/metrics.py:155)."""

    kind = "counter"

    def inc(self, value: float = 1.0,
            tags: Optional[Dict[str, str]] = None):
        if value <= 0:
            raise ValueError("Counter.inc requires value > 0")
        _record("counter", self._name, self._tags(tags), value)


class Gauge(_Metric):
    """Last-value-wins (reference: util/metrics.py:295)."""

    kind = "gauge"

    def set(self, value: float, tags: Optional[Dict[str, str]] = None):
        _record("gauge", self._name, self._tags(tags), value)


class Histogram(_Metric):
    """Bucketed distribution (reference: util/metrics.py:220)."""

    kind = "histogram"

    def __init__(self, name: str, description: str = "",
                 boundaries: Sequence[float] = (),
                 tag_keys: Sequence[str] = ()):
        super().__init__(name, description, tag_keys)
        self._boundaries = tuple(sorted(float(b) for b in boundaries))

    def observe(self, value: float,
                tags: Optional[Dict[str, str]] = None):
        _record("histogram", self._name, self._tags(tags), value,
                self._boundaries)
