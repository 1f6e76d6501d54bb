"""ActorPool (reference: python/ray/util/actor_pool.py) — load-balance a
stream of work over a fixed set of actors.  ``map`` preserves input order
(as the reference does); ``map_unordered`` yields in completion order."""

from __future__ import annotations

from typing import Any, Callable, Iterable, Iterator, List

import ray_tpu_torch as ray


class ActorPool:
    def __init__(self, actors: List[Any]):
        if not actors:
            raise ValueError("ActorPool needs at least one actor")
        self._idle = list(actors)
        self._future_to_meta = {}   # future -> (actor, submission index)
        self._pending = []          # queued (fn, value, index)
        self._next_idx = 0
        self._next_return = 0       # next submission index get_next yields
        self._ready = {}            # completed results buffered by index
        self._consumed = set()      # indices taken out-of-order (unordered)

    def submit(self, fn: Callable[[Any, Any], Any], value: Any):
        """fn(actor, value) -> ObjectRef."""
        idx = self._next_idx
        self._next_idx += 1
        if self._idle:
            actor = self._idle.pop()
            self._future_to_meta[fn(actor, value)] = (actor, idx)
        else:
            self._pending.append((fn, value, idx))

    def has_next(self) -> bool:
        return (bool(self._future_to_meta) or bool(self._pending)
                or bool(self._ready))

    def _complete_one(self, timeout=None):
        """-> (idx, ok, result-or-exception).  Task errors are captured, not
        raised: raising after the future is popped but before its index is
        buffered would wedge ordered get_next forever (the index could never
        appear in _ready).  Reference: _next_return_index semantics in
        python/ray/util/actor_pool.py."""
        done, _ = ray.wait(list(self._future_to_meta), num_returns=1,
                           timeout=timeout)
        if not done:
            raise TimeoutError("get_next timed out")
        fut = done[0]
        actor, idx = self._future_to_meta.pop(fut)
        if self._pending:
            fn, value, pidx = self._pending.pop(0)
            self._future_to_meta[fn(actor, value)] = (actor, pidx)
        else:
            self._idle.append(actor)
        try:
            return idx, True, ray.get(fut)
        except Exception as e:  # noqa: BLE001 — surfaced at yield time
            return idx, False, e

    def get_next(self, timeout=None) -> Any:
        """Next result in SUBMISSION order (reference semantics:
        ``_index_to_future``/``_next_return_index`` in
        ``python/ray/util/actor_pool.py``) — interleaved submit()/get_next()
        pairs inputs with outputs."""
        if not self.has_next():
            raise StopIteration("no pending work")
        import time as _time
        deadline = None if timeout is None else _time.monotonic() + timeout
        while self._next_return in self._consumed:
            self._consumed.discard(self._next_return)
            self._next_return += 1
        want = self._next_return
        while want not in self._ready:
            remaining = (None if deadline is None
                         else max(0.0, deadline - _time.monotonic()))
            idx, ok, result = self._complete_one(remaining)
            self._ready[idx] = (ok, result)
        self._next_return += 1
        ok, result = self._ready.pop(want)
        if not ok:
            raise result
        return result

    def get_next_unordered(self, timeout=None) -> Any:
        """Next result in COMPLETION order."""
        if not self.has_next():
            raise StopIteration("no pending work")
        if self._ready:
            # Results already fetched while waiting in-order: drain first.
            idx = next(iter(self._ready))
            self._consumed.add(idx)
            ok, result = self._ready.pop(idx)
        else:
            idx, ok, result = self._complete_one(timeout)
            self._consumed.add(idx)
        if not ok:
            raise result
        return result

    def map(self, fn: Callable[[Any, Any], Any],
            values: Iterable[Any]) -> Iterator[Any]:
        """Results in input order (reference semantics)."""
        base = self._next_idx
        for v in values:
            self.submit(fn, v)
        buffered = {}
        want = base
        while self.has_next() or buffered:
            while want in buffered:
                yield buffered.pop(want)
                want += 1
            if not self.has_next():
                break
            idx, ok, result = self._complete_one()
            self._consumed.add(idx)
            if not ok:
                raise result
            buffered[idx] = result
        while want in buffered:
            yield buffered.pop(want)
            want += 1

    def map_unordered(self, fn, values) -> Iterator[Any]:
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next_unordered()
