"""Continuous (iteration-level) batching for decode-style deployments.

A copy of ``ray_tpu/serve/continuous.py`` for the PyTorch port (the port
imports nothing of ``ray_tpu``).

Reference: Orca (OSDI'22) iteration-level scheduling — the serving
engine admits queued requests into the RUNNING batch at step
boundaries instead of waiting for the whole batch to finish, and
retires each request the step it completes, refilling its slot the
same step.  The legacy ``@serve.batch`` window (batching.py) is
all-or-nothing: a batch of requests enters together, the wrapped
function runs ONCE, and every caller waits for the full batch — fine
for single-shot inference, pathological for decode loops where
request lengths vary (the whole batch runs at the LONGEST request's
step count while finished slots sit empty and queued requests wait).

``@serve.batch(mode="continuous")`` turns the wrapped function into a
STEP function: it is called once per iteration with the list of live
:class:`Slot` objects (one per admitted request).  Each slot carries
``request`` (the caller's payload), ``state`` (arbitrary per-request
state the step function owns across iterations; ``None`` on the
joining step), and ``steps`` (iterations survived so far).  The step
function advances every live request by one iteration and calls
``slot.finish(result)`` on the ones that completed; the scheduler
retires finished slots, wakes their callers, and refills the freed
slots from the queue before the next step.

One scheduler thread per batcher drives the loop; caller threads just
queue and wait, so a replica's ``max_concurrency`` bounds concurrent
CALLERS, not batch occupancy.  With ``RAY_TPU_CONTINUOUS_BATCHING=0``
(config ``continuous_batching``) the same decorator degrades to
one-shot driving of the step function — a fixed batch is admitted,
stepped until EVERY slot finishes, and only then is the next batch
admitted — which is the measured A/B baseline for the bench row and
the byte-identical-behavior escape hatch.

PREFILL-ONLY SLOTS (disaggregated serving): a prefill-pool replica
rides this same scheduler — its requests carry ``_prefill_only`` and
the step function calls ``slot.finish(...)`` on the PROMPT step, the
same iteration the KV chain materializes, so the slot never survives
into a decode iteration.  The contract is ordinary ``finish``: the
batcher needs no mode flag, prefill requests retire like zero-decode
requests, and the finish VALUE (the exported chain) reaches the
parked caller (``prefill_export``) through the normal result path.

LOCK ORDER: ``_ContinuousBatcher._lock`` is a documented independent
LEAF (the reference's copy is pinned in tests/test_lockcheck.py): it
guards only the admission queue and counters; the step function runs
with NO lock held (user code may submit, log, or take its own locks),
and slot events are set outside it.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional


class SlotCancelled(RuntimeError):
    """Raised to a caller whose request died with the batcher (scheduler
    teardown, step-function crash)."""


class Slot:
    """One live request inside the running batch.

    The step function reads ``request``, owns ``state`` across
    iterations, and calls :meth:`finish` when the request completes.
    Everything else is scheduler-internal.
    """

    __slots__ = ("request", "state", "steps", "kv", "_done",
                 "_result", "_error", "_event", "_owner")

    def __init__(self, request: Any):
        self.request = request
        self.state: Any = None   # per-request state, carried across steps
        self.steps = 0           # iterations this request has been live
        # Paged-KV plan (kv_cache.SlotKV), set at admission when the
        # batcher carries a PagedKVEngine; None on the dense path.
        self.kv: Any = None
        self._done = False
        self._result: Any = None
        self._error: Optional[BaseException] = None
        self._event = threading.Event()
        # The scheduler thread that admitted this slot into its live
        # batch (set at admission, under the batcher lock).  The caller
        # backstop probes ITS liveness: a slot owned by a dead scheduler
        # is unrecoverable even if a respawned scheduler is running —
        # the dead thread's live list (and this slot's place in it)
        # died with it.
        self._owner: Optional[threading.Thread] = None

    def finish(self, result: Any) -> None:
        """Mark this request complete; the scheduler retires the slot
        and wakes the caller after the current step returns."""
        self._result = result
        self._done = True

    @property
    def finished(self) -> bool:
        return self._done

    def _fail(self, err: BaseException) -> None:
        self._error = err
        self._done = True
        self._event.set()


class _ContinuousBatcher:
    """Iteration-level scheduler around one step function.

    ``continuous=False`` keeps the admission/step/retire machinery but
    admits only into an EMPTY batch and never refills mid-flight — the
    legacy one-shot window semantics expressed over the same step
    function (the bench/acceptance A/B baseline).
    """

    # Follower backstop cadence: how often a waiting caller re-checks
    # that the scheduler thread is still alive (a dead scheduler can
    # never fire its event).
    _BACKSTOP_S = 1.0

    def __init__(self, fn: Callable, instance, max_batch_size: int,
                 batch_wait_timeout_s: float, continuous: bool = True,
                 kv=None):
        self._fn = fn
        self._instance = instance
        self._max = max(1, int(max_batch_size))
        self._timeout = batch_wait_timeout_s
        self._continuous = continuous
        # Paged-KV admission engine (kv_cache.PagedKVEngine) or None.
        # With an engine attached, admission is bounded by free KV
        # BLOCKS (plus the engine's slot cap) instead of
        # max_batch_size: a request is admitted when its whole block
        # budget fits, and parks at the queue head otherwise.  The
        # engine adopts THIS batcher's leaf lock as its guard, so block
        # accounting and admission re-checks happen under one lock.
        self._kv = kv
        # LEAF lock (see module docstring): queue + counters + block
        # accounting only.
        self._lock = threading.Lock()  # lock-order: leaf
        if kv is not None:
            kv.bind(self._lock)
        self._queue: deque = deque()
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # True between electing a new scheduler thread (under _lock)
        # and its start() (outside _lock — thread startup acquires
        # interpreter-internal locks, and this lock is a leaf).
        self._spawning = False
        # Observability (serving_stats): cumulative step count, occupied
        # slot-steps (occupancy = occupied/steps), admissions/retires.
        self._steps = 0
        self._occupied_slot_steps = 0
        self._admitted = 0
        self._retired = 0
        self._step_errors = 0

    # ------------------------------------------------------------- caller --
    def submit(self, item: Any) -> Any:
        slot = Slot(item)
        start = None
        with self._lock:
            self._queue.append(slot)
            self._admitted += 1
            t = self._thread
            if (t is None or not t.is_alive()) and not self._spawning:
                self._spawning = True
                start = self._thread = threading.Thread(
                    target=self._loop, daemon=True,
                    name=f"serve-cbatch-{getattr(self._fn, '__name__', '?')}")
        if start is not None:
            # start() outside the (leaf) lock: thread startup takes
            # interpreter-internal locks.
            try:
                start.start()
            finally:
                with self._lock:
                    self._spawning = False
        self._wake.set()
        # Wait with a liveness backstop: the scheduler thread catches
        # step-function errors, so the only way the event can never fire
        # is the scheduler itself dying (interpreter teardown, hard
        # kill) — detectable, unlike an arbitrarily long step.
        while not slot._event.wait(self._BACKSTOP_S):
            dead = False
            with self._lock:
                if slot._event.is_set():
                    break
                # Probe the thread RESPONSIBLE for this slot: its
                # admitting scheduler once admitted, else the current
                # (queue-draining) scheduler — a respawned scheduler
                # cannot revive a dead predecessor's live batch.
                t = slot._owner if slot._owner is not None \
                    else self._thread
                if slot._owner is None and self._spawning:
                    continue
                if t is not None and t.is_alive():
                    continue
                # Scheduler dead: drain our own slot (and let the next
                # submit start a fresh scheduler for the rest).
                try:
                    self._queue.remove(slot)
                except ValueError:
                    pass
                dead = True
            if dead:
                # Event fires OUTSIDE the (leaf) lock.
                slot._fail(SlotCancelled(
                    "continuous-batch scheduler died before this "
                    "request completed"))
        if slot._error is not None:
            raise slot._error
        return slot._result

    # ---------------------------------------------------------- scheduler --
    def _admit_locked(self, live: List[Slot]) -> List[tuple]:
        me = threading.current_thread()
        # Paged admission: bounded by free KV BLOCKS + the engine's slot
        # cap, not max_batch_size.  Availability is (re-)checked under
        # this leaf lock at every boundary; a request whose block budget
        # does not fit PARKS at the queue head (FIFO — retiring requests
        # free blocks and the next boundary re-checks) instead of
        # erroring.  The one exception: a budget no pool state could
        # ever satisfy (RequestTooLarge) is popped and returned for the
        # caller to FAIL outside this (leaf) lock — parking it would
        # wedge the queue head forever.
        doomed: List[tuple] = []
        cap = self._kv.max_slots if self._kv is not None else self._max
        while self._queue and len(live) < cap:
            s = self._queue[0]
            if self._kv is not None:
                try:
                    if not self._kv.try_admit_locked(s):
                        break
                except Exception as err:  # noqa: BLE001 — a malformed
                    # request (sizing hook blew up) or an oversized one
                    # must doom THAT slot, not kill the scheduler: the
                    # bad slot would stay at the queue head and every
                    # respawned scheduler would die on it again.
                    self._queue.popleft()
                    doomed.append((s, err))
                    continue
            self._queue.popleft()
            s._owner = me
            live.append(s)
        return doomed

    def _loop(self) -> None:
        live: List[Slot] = []
        while True:
            doomed = []
            with self._lock:
                if self._continuous or not live:
                    # Continuous: refill freed slots every boundary.
                    # One-shot: admit only into an empty batch.
                    doomed = self._admit_locked(live)
            for s, err in doomed:  # events fire OUTSIDE the leaf lock
                s._fail(err)
            if not live:
                # Idle: park until a request arrives (clear-then-check
                # so a submit racing this window still wakes us).
                self._wake.clear()
                with self._lock:
                    empty = not self._queue
                if empty:
                    self._wake.wait()
                continue
            cap = self._kv.max_slots if self._kv is not None else self._max
            if not self._continuous and self._timeout > 0 \
                    and live and live[0].steps == 0 \
                    and len(live) < cap:
                # Legacy window: a fresh one-shot batch below max waits
                # out the batching window for followers before step 0.
                deadline = time.monotonic() + self._timeout
                while len(live) < cap:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        break
                    self._wake.wait(left)
                    self._wake.clear()
                    with self._lock:
                        doomed = self._admit_locked(live)
                    for s, err in doomed:
                        s._fail(err)
            try:
                if self._instance is not None:
                    self._fn(self._instance, live)
                else:
                    self._fn(live)
            except BaseException as err:  # noqa: BLE001 — fan out, keep loop
                with self._lock:
                    self._step_errors += 1
                    self._steps += 1
                    if self._kv is not None:
                        # Failed slots free their KV blocks too — a
                        # crashing step function must not leak the pool.
                        for s in live:
                            self._kv.retire_locked(s)
                for s in live:
                    s._fail(err)
                live = []
                continue
            finished = [s for s in live if s._done]
            live = [s for s in live if not s._done]
            for s in live:
                s.steps += 1
            with self._lock:
                self._steps += 1
                self._occupied_slot_steps += len(live) + len(finished)
                self._retired += len(finished)
                if self._kv is not None:
                    # Free on retire, under the same leaf lock the
                    # admission check runs under: the next boundary's
                    # block-availability re-check sees these blocks.
                    for s in finished:
                        self._kv.retire_locked(s)
            # Events fire OUTSIDE the lock (leaf convention).
            for s in finished:
                s._event.set()

    # ------------------------------------------------------------- stats ---
    def stats(self) -> Dict[str, Any]:
        with self._lock:
            steps = self._steps
            occ = (self._occupied_slot_steps / steps) if steps else 0.0
            out = {
                "mode": "continuous" if self._continuous else "oneshot",
                "steps": steps,
                "batch_occupancy": round(occ, 3),
                "max_batch_size": self._max,
                "admitted": self._admitted,
                "retired": self._retired,
                "queued": len(self._queue),
                "step_errors": self._step_errors,
            }
            if self._kv is not None:
                # Serving-memory plane: block occupancy, prefix reuse,
                # and speculative-decode counters ride the same stats
                # dict (rolled up per deployment by the controller).
                out["mode"] += "+paged"
                kv = self._kv.stats_locked()
                out.update(kv)
                out["tokens_per_step"] = round(
                    kv["tokens_emitted"] / steps, 3) if steps else 0.0
            return out
