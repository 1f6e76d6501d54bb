"""Opt-in runtime lock-order checker (the in-process TSAN-lite).

Enable with ``RAY_TPU_LOCKCHECK=1`` (log violations) or
``RAY_TPU_LOCKCHECK=raise`` (raise :class:`LockOrderError` at the
acquisition that closes a cycle) before importing ``ray_tpu_torch``, or call
:func:`install` directly from a test.

What it does, lockdep-style:

- wraps ``threading.Lock`` / ``threading.RLock`` so every lock created
  after :func:`install` is a recording proxy.  Locks are grouped into
  CLASSES by creation site (``file:line``) — all per-connection locks
  minted on one line form one class, exactly how kernel lockdep groups
  lock instances;
- records, per thread, the set of held lock classes, and adds a directed
  edge A -> B to a global graph whenever B is acquired while A is held;
- on each new edge, checks the graph for a cycle.  A cycle means two code
  paths acquire the same lock classes in opposite orders — a potential
  deadlock even if this run never interleaved badly (that is the whole
  point: the schedule-independent check catches what timing-dependent
  tests miss);
- watches asyncio event loops registered via :func:`watch_loop`
  (worker_main's async-actor loop registers itself when lockcheck is on)
  and records any callback/coroutine step that blocks the loop longer
  than 50 ms — the async-actor analog of holding a lock across I/O.

Zero overhead when not installed: the runtime never imports this module
unless the env flag is set or a test asks for it.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Dict, List, Optional, Set, Tuple

logger = logging.getLogger("ray_tpu_torch.lockcheck")

# Default threshold for the event-loop stall watch (seconds).
LOOP_STALL_THRESHOLD_S = 0.05

_real_Lock = threading.Lock
_real_RLock = threading.RLock


class LockOrderError(RuntimeError):
    """Two code paths acquire the same lock classes in opposite orders."""


class _State:
    """Global checker state; guarded by an UN-instrumented lock."""

    def __init__(self):
        self.mu = _real_Lock()
        self.edges: Dict[str, Set[str]] = {}       # site -> {site}
        self.violations: List[str] = []
        self.stalls: List[str] = []
        self.raise_on_cycle = False
        # thread-id -> [proxies currently held], keyed explicitly (not
        # thread-local) because a plain Lock may legitimately be RELEASED
        # on a different thread than acquired it (handoff patterns) and
        # the releasing thread must be able to clear the acquirer's entry.
        self.held_by: Dict[int, List["_LockProxy"]] = {}
        self.seen_cycles: Set[Tuple[str, ...]] = set()

    def held_snapshot(self, tid: int) -> list:
        with self.mu:
            return list(self.held_by.get(tid, ()))

    def push_held(self, tid: int, proxy: "_LockProxy"):
        with self.mu:
            self.held_by.setdefault(tid, []).append(proxy)

    def pop_held(self, tid: int, proxy: "_LockProxy"):
        with self.mu:
            held = self.held_by.get(tid)
            if held and proxy in held:
                held.remove(proxy)


_state: Optional[_State] = None
_installed = False


def _creation_site() -> str:
    """file:line of the frame that called Lock()/RLock(), skipping
    threading.py internals (Condition/Event allocate locks) and this
    module."""
    import sys

    frame = sys._getframe(2)
    skip = (os.sep + "threading.py", os.path.join("devtools", "lockcheck"))
    while frame is not None:
        filename = frame.f_code.co_filename
        if not any(s in filename for s in skip):
            return f"{filename}:{frame.f_lineno}"
        frame = frame.f_back
    return "<unknown>"


def _find_path(edges: Dict[str, Set[str]], src: str, dst: str
               ) -> Optional[List[str]]:
    """DFS path src -> dst in the acquisition graph, or None."""
    stack = [(src, [src])]
    seen = {src}
    while stack:
        node, path = stack.pop()
        if node == dst:
            return path
        for nxt in edges.get(node, ()):
            if nxt not in seen:
                seen.add(nxt)
                stack.append((nxt, path + [nxt]))
    return None


class _LockProxy:
    """Recording wrapper around a real lock primitive.

    Deliberately NOT exposing ``_release_save`` / ``_acquire_restore`` /
    ``_is_owned`` for plain Locks (Condition falls back to its portable
    implementations, which route through this proxy's acquire/release);
    the RLock proxy forwards them with bookkeeping (below).
    """

    _reentrant = False

    def __init__(self, real, site: str):
        self._real = real
        self._site = site
        # Thread currently holding this (plain) lock; cleared by release,
        # possibly from a DIFFERENT thread (lock-handoff patterns).
        self._held_tid = None

    # -- bookkeeping -------------------------------------------------------
    def _on_acquired(self):
        state = _state
        if state is None:
            return
        tid = threading.get_ident()
        for other in state.held_snapshot(tid):
            if other is not self:
                _record_edge(state, other._site, self._site)
        self._held_tid = tid
        state.push_held(tid, self)

    def _on_released(self):
        state = _state
        owner, self._held_tid = self._held_tid, None
        if state is None or owner is None:
            return
        state.pop_held(owner, self)

    # -- lock protocol -----------------------------------------------------
    def acquire(self, blocking=True, timeout=-1):
        got = self._real.acquire(blocking, timeout)
        if got:
            try:
                self._on_acquired()
            except LockOrderError:
                # raise_on_cycle mode: don't hand the caller a lock it
                # will never release (its `with` body is never entered).
                # _on_acquired raises BEFORE registering the hold, so the
                # real release is the only undo needed.
                self._real.release()
                raise
        return got

    def release(self):
        self._on_released()
        self._real.release()

    __enter__ = acquire

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.release()

    def locked(self):
        return self._real.locked()

    def _at_fork_reinit(self):
        # stdlib modules register this as an os fork handler
        # (concurrent.futures.thread does at import time).
        self._real._at_fork_reinit()
        self._held_tid = None

    def __repr__(self):
        return f"<lockcheck proxy for {self._real!r} @ {self._site}>"


class _RLockProxy(_LockProxy):
    _reentrant = True

    def __init__(self, real, site: str):
        super().__init__(real, site)
        # Per-thread reentry depth (dict ops are GIL-atomic; RLock
        # release is always same-thread, unlike plain Lock handoffs).
        # Edges are recorded only on the outermost acquisition — a
        # re-acquire adds no ordering information.
        self._depths: Dict[int, int] = {}

    def _on_acquired(self):
        tid = threading.get_ident()
        depth = self._depths.get(tid, 0)
        if depth:
            self._depths[tid] = depth + 1
            return
        state = _state
        if state is None:
            self._depths[tid] = 1
            return
        for other in state.held_snapshot(tid):
            if other is not self:
                _record_edge(state, other._site, self._site)
        self._depths[tid] = 1
        state.push_held(tid, self)

    def _on_released(self):
        tid = threading.get_ident()
        depth = self._depths.get(tid, 0)
        if depth == 0:
            return
        if depth > 1:
            self._depths[tid] = depth - 1
            return
        self._depths.pop(tid, None)
        state = _state
        if state is not None:
            state.pop_held(tid, self)

    def _at_fork_reinit(self):
        self._real._at_fork_reinit()
        self._depths = {}

    # threading.Condition probes these on its backing lock; forward with
    # held-set bookkeeping so wait() (full release) and the re-acquire are
    # reflected in the graph.
    def _is_owned(self):
        return self._real._is_owned()

    def _release_save(self):
        saved = self._real._release_save()
        tid = threading.get_ident()
        depth = self._depths.pop(tid, 0)
        if depth and _state is not None:
            _state.pop_held(tid, self)
        return (saved, depth)

    def _acquire_restore(self, saved):
        inner, depth = saved
        self._real._acquire_restore(inner)
        tid = threading.get_ident()
        self._depths[tid] = depth
        if depth and _state is not None:
            _state.push_held(tid, self)


def _record_edge(state: _State, frm: str, to: str):
    with state.mu:
        if to in state.edges.get(frm, ()):
            return  # known edge: any cycle it closes was reported then
        state.edges.setdefault(frm, set()).add(to)
        if frm == to:
            # Two distinct instances of one lock CLASS nested: their
            # relative order is schedule-dependent, so this is a
            # potential ABBA deadlock (lockdep flags the same).
            chain = [frm, to]
        else:
            path = _find_path(state.edges, to, frm)
            if path is None:
                return
            chain = path + [to]
        key = tuple(sorted(set(chain)))
        if key in state.seen_cycles:
            return
        state.seen_cycles.add(key)
        message = (
            "lock-order cycle (potential deadlock): "
            + " -> ".join(chain)
            + f" ; closing edge {frm} -> {to} acquired on thread "
            + threading.current_thread().name)
        state.violations.append(message)
        raise_it = state.raise_on_cycle
    logger.warning("%s", message)
    if raise_it:
        raise LockOrderError(message)


def _make_lock_factory(real_factory, proxy_cls):
    def factory():
        return proxy_cls(real_factory(), _creation_site())

    return factory


def install(raise_on_cycle: bool = False):
    """Start instrumenting newly created locks.  Idempotent; locks created
    before install stay un-instrumented (install early — the env-flag path
    runs at ``import ray_tpu_torch`` time, before the runtime builds its locks).
    """
    global _state, _installed
    if _installed:
        if _state is not None:
            _state.raise_on_cycle = raise_on_cycle
        return
    _state = _State()
    _state.raise_on_cycle = raise_on_cycle
    threading.Lock = _make_lock_factory(_real_Lock, _LockProxy)
    threading.RLock = _make_lock_factory(_real_RLock, _RLockProxy)
    _installed = True


def uninstall():
    """Restore the real lock factories, detach the stall watch, and drop
    recorded state.  Locks already minted as proxies keep working (they
    wrap real locks); loops handed to watch_loop keep their asyncio debug
    flag (the loop may be gone), but stalls are no longer captured."""
    global _state, _installed, _stall_handler
    threading.Lock = _real_Lock
    threading.RLock = _real_RLock
    if _stall_handler is not None:
        logging.getLogger("asyncio").removeHandler(_stall_handler)
        _stall_handler = None
    _state = None
    _installed = False


def install_from_env():
    value = os.environ.get("RAY_TPU_LOCKCHECK", "")
    if value and value != "0":
        install(raise_on_cycle=(value == "raise"))


def enabled() -> bool:
    return _installed


def edges() -> Dict[str, Set[str]]:
    """Copy of the acquisition graph: creation-site -> {creation-site}."""
    if _state is None:
        return {}
    with _state.mu:
        return {k: set(v) for k, v in _state.edges.items()}


def violations() -> List[str]:
    if _state is None:
        return []
    with _state.mu:
        return list(_state.violations)


_leaf_registry_cache: Optional[Dict[str, str]] = None


def leaf_registry(refresh: bool = False) -> Dict[str, str]:
    """``realpath:line -> lock name`` for every ``# lock-order: leaf``
    creation site, straight from the static analyzer (lockgraph is the
    one source of truth; this module keeps no leaf list of its own, so
    the static and dynamic checkers cannot disagree).  Cached: the
    static parse is ~seconds and this is debug tooling."""
    global _leaf_registry_cache
    if _leaf_registry_cache is None or refresh:
        from ray_tpu_torch.devtools import lockgraph

        _leaf_registry_cache = lockgraph.leaf_sites()
    return _leaf_registry_cache


def leaf_violations() -> List[str]:
    """Observed runtime edges that LEAVE an annotated leaf lock — the
    dynamic counterpart of lockgraph RTL602.  Computed on demand (not in
    the acquire path) so recording stays cheap."""
    registry = leaf_registry()
    out = []
    for frm, tos in edges().items():
        name = registry.get(frm)
        if name is None:
            continue
        for to in sorted(tos):
            if to != frm:
                out.append(f"leaf lock '{name}' ({frm}) acquired {to} "
                           "while held — an annotated leaf must nest "
                           "nothing")
    return out


def export_graph() -> dict:
    """JSON-serializable dump of everything a cross-checking test
    needs: the observed acquisition edges, cycle + leaf violations, and
    the (static) leaf registry this checker consumes.  The lockgraph
    superset test asserts every observed edge between statically-known
    creation sites appears in the static graph."""
    return {
        "edges": sorted([frm, to] for frm, tos in edges().items()
                        for to in tos),
        "violations": violations(),
        "leaf_violations": leaf_violations(),
        "leaf_registry": dict(leaf_registry()),
    }


def stalls() -> List[str]:
    if _state is None:
        return []
    with _state.mu:
        return list(_state.stalls)


def clear():
    """Drop recorded edges/violations/stalls (keeps instrumentation)."""
    if _state is None:
        return
    with _state.mu:
        _state.edges.clear()
        _state.violations.clear()
        _state.stalls.clear()
        _state.seen_cycles.clear()


def assert_acyclic():
    """Raise LockOrderError if any cycle was recorded (test helper)."""
    if _state is None:
        return
    with _state.mu:
        if _state.violations:
            raise LockOrderError("; ".join(_state.violations))


class _StallHandler(logging.Handler):
    """Captures asyncio-debug 'Executing ... took N seconds' records."""

    def emit(self, record):
        try:
            message = record.getMessage()
        except Exception:
            return
        if "took" not in message:
            return
        state = _state
        if state is not None:
            with state.mu:
                state.stalls.append(message)
        logger.warning("event-loop stall: %s", message)


_stall_handler: Optional[_StallHandler] = None


def watch_loop(loop, threshold_s: float = LOOP_STALL_THRESHOLD_S):
    """Record callbacks/coroutine steps that block ``loop`` longer than
    ``threshold_s`` (asyncio's debug slow-callback machinery does the
    timing; we capture its report).  Used by worker_main for the async
    actor loop when lockcheck is enabled."""
    global _stall_handler
    loop.set_debug(True)
    loop.slow_callback_duration = threshold_s
    if _stall_handler is None:
        _stall_handler = _StallHandler()
        logging.getLogger("asyncio").addHandler(_stall_handler)
