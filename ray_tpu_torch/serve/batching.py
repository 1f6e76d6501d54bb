"""Request batching inside replicas.

A copy of ``ray_tpu/serve/batching.py`` for the PyTorch port, wired to
the port's own config (``ray_tpu_torch._private.config``); the port
imports nothing of ``ray_tpu``.

Reference: ``python/ray/serve/batching.py`` — ``@serve.batch`` collects
concurrent calls into one invocation of the wrapped function, which
receives a LIST of the single-call arguments and returns a list of
results (positional).  The reference batches on the replica's asyncio
loop; our replicas are threaded (``max_concurrency``), so batching
rendezvouses caller threads: the first caller of a batch becomes the
leader, waits up to ``batch_wait_timeout_s`` for followers (or until
``max_batch_size``), runs the underlying function once, and distributes
results.

``mode="continuous"`` switches to the iteration-level engine
(continuous.py): the wrapped function becomes a per-step function over
live request slots, with queued requests admitted at step boundaries —
see the Orca-style scheduler there.  ``RAY_TPU_CONTINUOUS_BATCHING=0``
degrades continuous-mode decorators to one-shot driving of the same
step function (the measured A/B baseline); the default list-in/list-out
mode here is untouched by the switch.

LOCK ORDER: ``_Batcher._lock`` is a documented independent LEAF (the
reference's copy is pinned in tests/test_lockcheck.py): it guards only
the pending list and counters; the wrapped function runs with no lock
held and entry events are set outside it.
"""

from __future__ import annotations

import functools
import threading
import time
from typing import Any, Callable, Dict, List, Optional


class _Entry:
    __slots__ = ("item", "event", "result", "error", "leader")

    def __init__(self, item):
        self.item = item
        self.event = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None
        # The thread running this entry's batch, recorded at collection
        # time — the follower backstop's liveness probe.
        self.leader: Optional[threading.Thread] = None


class _Batcher:
    # Follower backstop cadence: a waiting follower re-checks this often
    # that its batch leader is still alive.  Liveness — not a bound on
    # the wrapped function's runtime (a live leader waits forever).
    _BACKSTOP_S = 1.0

    def __init__(self, fn: Callable, instance, max_batch_size: int,
                 batch_wait_timeout_s: float):
        self._fn = fn
        self._instance = instance
        self._max = max_batch_size
        self._timeout = batch_wait_timeout_s
        self._lock = threading.Lock()  # lock-order: leaf
        self._pending: List[_Entry] = []
        self._full = threading.Event()
        # Pre-collection leader (elected at first append; cleared when it
        # collects its batch).  Followers use it to detect a leader that
        # died before collecting — their entries would otherwise pend
        # forever.
        self._leader: Optional[threading.Thread] = None
        # Observability (serving_stats).
        self._batches = 0
        self._items = 0
        self._retired = 0        # items that got a RESULT
        self._error_batches = 0  # batches whose wrapped fn raised

    def submit(self, item):
        entry = _Entry(item)
        with self._lock:
            self._pending.append(entry)
            leader = len(self._pending) == 1
            if leader:
                self._leader = threading.current_thread()
            full = len(self._pending) >= self._max
        if full:
            self._full.set()  # outside the (leaf) lock
        if leader:
            self._lead(entry)
        else:
            self._follow(entry)
        if entry.error is not None:
            raise entry.error
        return entry.result

    def _lead(self, entry: _Entry):
        """Leader path.  Every exit — normal, wrapped-fn error, or an
        async exception landing in this thread mid-window — leaves NO
        entry without its event set: a batch collected but not yet run
        is failed wholesale, and one never collected is failed out of
        the pending list (a follower-turned-rescue-leader covers the
        remaining hard-kill window)."""
        batch: Optional[List[_Entry]] = None
        try:
            self._window_wait()
            with self._lock:
                batch, self._pending = self._pending, []
                self._leader = None
                for e in batch:
                    e.leader = threading.current_thread()
            self._run(batch)
        except BaseException as err:  # noqa: BLE001 — fail followers, re-raise
            if batch is None:
                with self._lock:
                    batch, self._pending = self._pending, []
                    if self._leader is threading.current_thread():
                        self._leader = None
            for e in batch:
                if not e.event.is_set():
                    e.error = RuntimeError(
                        f"batch leader failed before the batch ran: "
                        f"{err!r}")
                    e.event.set()
            raise

    def _window_wait(self):
        """Leader's batching window: wait until pending reaches
        max_batch_size or the window times out.  The full-event is only
        a WAKE hint — fullness is re-validated under the lock after
        every wake, so a stale set left over from a previous batch (the
        event fires outside the leaf lock; a preempted follower can set
        it after that batch was already collected) costs one spurious
        loop iteration, never a premature undersized batch."""
        deadline = time.monotonic() + self._timeout
        while True:
            with self._lock:
                if len(self._pending) >= self._max:
                    return
            left = deadline - time.monotonic()
            if left <= 0:
                return
            self._full.wait(left)
            self._full.clear()

    def _follow(self, entry: _Entry):
        """Follower path with a liveness backstop: if the leader thread
        died without firing our event (hard kill — the leader's own
        exception paths fail entries explicitly), a still-pending batch
        is rescued and run by this thread; an entry the dead leader had
        already collected is failed (its batch state died with the
        leader)."""
        while not entry.event.wait(self._BACKSTOP_S):
            rescue: Optional[List[_Entry]] = None
            orphaned = False
            with self._lock:
                if entry.event.is_set():
                    break
                t = entry.leader if entry.leader is not None \
                    else self._leader
                if t is not None and t.is_alive():
                    continue
                if entry in self._pending:
                    rescue, self._pending = self._pending, []
                    self._leader = None
                    for e in rescue:
                        e.leader = threading.current_thread()
                else:
                    entry.error = RuntimeError(
                        "batch leader died before distributing results")
                    orphaned = True
            # Event/rescue work runs OUTSIDE the (leaf) lock.
            if orphaned:
                entry.event.set()
                break
            if rescue is not None:
                self._run(rescue)

    def _run(self, batch: List[_Entry]):
        failed = False
        try:
            items = [e.item for e in batch]
            if self._instance is not None:
                results = self._fn(self._instance, items)
            else:
                results = self._fn(items)
            if len(results) != len(items):
                raise ValueError(
                    f"@serve.batch function returned {len(results)} "
                    f"results for {len(items)} inputs")
            for e, r in zip(batch, results):
                e.result = r
        except BaseException as err:  # noqa: BLE001 — fan the error out
            failed = True
            for e in batch:
                e.error = err
        finally:
            with self._lock:
                self._batches += 1
                self._items += len(batch)
                if failed:
                    self._error_batches += 1
                else:
                    self._retired += len(batch)
            for e in batch:
                e.event.set()

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            batches = self._batches
            occ = (self._items / batches) if batches else 0.0
            return {
                "mode": "oneshot",
                "steps": batches,
                "batch_occupancy": round(occ, 3),
                "max_batch_size": self._max,
                "admitted": self._items,
                "retired": self._retired,
                "queued": len(self._pending),
                "step_errors": self._error_batches,
            }


def batch(_func: Optional[Callable] = None, *, max_batch_size: int = 8,
          batch_wait_timeout_s: float = 0.01, mode: str = "oneshot"):
    """Decorator.  Default mode: the wrapped fn takes a LIST of requests
    and returns a list of results; callers pass a single request each
    (reference: serve/batching.py @serve.batch).  ``mode="continuous"``:
    the wrapped fn is a STEP function over live request slots (see
    continuous.py) — admission happens at step boundaries, finished
    requests retire and their slots refill the same step."""
    if mode not in ("oneshot", "continuous"):
        raise ValueError(f"unknown @serve.batch mode {mode!r}")

    def deco(fn):
        # No lock/batcher captured in the closure: the deployment class
        # (and this wrapper with it) crosses the wire via cloudpickle,
        # and thread locks don't pickle.  The batcher attaches to the
        # replica-side instance (or the wrapper itself for plain
        # functions) on first call.
        attr = f"__serve_batcher_{fn.__name__}"

        def make_batcher(instance):
            if mode == "continuous":
                from ray_tpu_torch._private.config import GLOBAL_CONFIG
                from ray_tpu_torch.serve.continuous import _ContinuousBatcher

                # The switches are read in the REPLICA process (they
                # ride _worker_config_env): continuous off = one-shot
                # driving of the same step function, the measured A/B
                # baseline.  paged_kv on + an instance-attached
                # PagedKVEngine (the ``serve_kv_engine`` attribute)
                # switches admission from max_batch_size slots to KV
                # blocks; with the knob off the engine is ignored and
                # the batcher is byte-identical to the dense one.
                kv = None
                if GLOBAL_CONFIG.paged_kv:
                    holder = instance if instance is not None else fn
                    kv = getattr(holder, "serve_kv_engine", None)
                return _ContinuousBatcher(
                    fn, instance, max_batch_size, batch_wait_timeout_s,
                    continuous=GLOBAL_CONFIG.continuous_batching, kv=kv)
            return _Batcher(fn, instance, max_batch_size,
                            batch_wait_timeout_s)

        @functools.wraps(fn)
        def wrapper(*args):
            if len(args) == 2:
                instance, item = args
            elif len(args) == 1:
                instance, item = None, args[0]
            else:
                raise TypeError(
                    "@serve.batch methods take exactly one request "
                    "argument")
            holder = instance if instance is not None else wrapper
            b = getattr(holder, attr, None)
            if b is None:
                # GIL-atomic setdefault: a racing thread's extra
                # batcher is discarded, the winner is shared.
                b = holder.__dict__.setdefault(attr, make_batcher(instance))
            return b.submit(item)

        wrapper.__wrapped__ = fn
        return wrapper

    if _func is not None:
        return deco(_func)
    return deco
