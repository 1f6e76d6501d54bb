"""Worker process: execution loop + worker-side runtime.

Reference analog: the worker half of the core worker
(``src/ray/core_worker/core_worker.cc:2413`` RunTaskExecutionLoop +
``python/ray/_raylet.pyx:702`` execute_task +
``python/ray/_private/workers/default_worker.py``).

A worker is a plain Python process wired to the driver by one duplex pipe.
A reader thread demultiplexes incoming messages into (a) a task queue and
(b) response slots for in-flight requests this worker made (object gets,
nested submits).  Execution runs on the main thread; actors with
``max_concurrency > 1`` get a thread pool, and ``async def`` actor methods
run on a persistent asyncio loop (reference: async actors,
``python/ray/_private/async_compat.py``).

Card ownership: if the driver granted this worker cards, the spawn env
carries ``CUDA_VISIBLE_DEVICES`` naming exactly them (and ``""`` for a CPU
worker), set before any user code imports torch in this process — the
reference's plumbing (``python/ray/_private/worker.py``
set_cuda_visible_devices).
"""

from __future__ import annotations

import asyncio
import itertools
import os
import queue
import sys
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Optional

from ray_tpu_torch._private import direct as direct_mod
from ray_tpu_torch._private import object_transfer, protocol, recovery, \
    serialization
from ray_tpu_torch._private.ids import ActorID, ObjectID, TaskID, new_task_id
from ray_tpu_torch._private import object_ref as object_ref_mod
from ray_tpu_torch._private.object_ref import ObjectRef
from ray_tpu_torch._private.shm_store import ShmStore
from ray_tpu_torch import exceptions as exc
from ray_tpu_torch.util import tracing


class _WorkerRuntime:
    """Worker-side implementation of the runtime accessor used by ObjectRef
    and the public API when running inside a worker."""

    # Bounded caches: pooled workers and long-lived actors must not retain
    # every task's results forever.
    _CACHE_CAP = 64

    def __init__(self, conn, send_lock, shm: ShmStore, max_inline: int):
        self.conn = conn
        self.send_lock = send_lock  # lock-order: io-guard
        self.shm = shm
        self.max_inline = max_inline
        self.req_counter = itertools.count(1)
        self.pending: Dict[int, "queue.SimpleQueue"] = {}
        self.pending_lock = threading.Lock()  # lock-order: leaf
        # Dropped refs accumulate here and ride out as one ("decref_batch")
        # before the next outgoing message (or via the periodic flusher).
        # Append-only from ObjectRef.__del__: __del__ can fire from GC *during*
        # protocol.send's pickling, so it must never take send_lock itself.
        # RLock, not Lock: a GC pass triggered by an allocation made while
        # holding this lock can re-enter __del__ on the same thread.
        self._decref_buf: list = []
        self._decref_lock = threading.RLock()
        # Actor-handle drops, buffered for the same __del__ reasons.
        self._actor_decref_buf: list = []
        # Per-thread task context: concurrent actor threads must not
        # cross-contaminate (reference: per-thread context in worker.py).
        self._tls = threading.local()
        self.worker_id_hex = ""
        self.node_id_hex = ""
        self.job_id_hex = ""
        # Which host object store this worker can mmap directly; SHM
        # descriptors from other stores are shipped as parts via the driver.
        self.store_id = os.environ.get("RAY_TPU_STORE_ID", "")
        # Per-node spill directory: deterministic from the session so
        # every process on a node (and the head's restore path) agrees.
        self.spill_dir = os.environ.get(
            "RAY_TPU_SPILL_DIR_OVERRIDE",
            f"/tmp/ray_tpu_spill_{os.environ.get('RAY_TPU_SESSION', '')}")
        # Peer messaging over the direct-push listener: channel ->
        # handler(payload).  Host-tier collectives register here.
        self.direct_addr = None  # set by worker_entry
        self.peer_handlers: Dict[str, Any] = {}
        self._peer_handlers_lock = threading.Lock()
        self.assigned_resources: Dict[str, float] = {}
        self.tpu_chips: list = []
        # Objects fetched or created locally, cached: id -> value (LRU).
        from collections import OrderedDict, deque as _deque

        self._local_cache: "OrderedDict[ObjectID, Any]" = OrderedDict()
        self._segments = _deque(maxlen=self._CACHE_CAP)
        # Direct chunked pulls from remote object servers; the driver
        # brokers locations only (reference: ObjectManager::Pull through
        # the owner's directory, object_manager.h:206).
        self._puller = object_transfer.ObjectPuller(
            bytes.fromhex(os.environ.get("RAY_TPU_AUTHKEY", "")))
        # Write-direction twin: streams a put's payload straight into a
        # remote store's object server (capability-gated; the client
        # runtime's large puts to the head ride this).  Cheap to hold —
        # pools dial lazily on first push.
        self._pusher = object_transfer.ObjectPusher(
            bytes.fromhex(os.environ.get("RAY_TPU_AUTHKEY", "")))
        # store_id -> (addr, caps) for stores with a reachable object
        # server; misses are never cached (a recovering peer gets its
        # fast path back on the next pull).
        self._store_addrs: Dict[str, Any] = {}
        # Singleflight registry for remote-segment pulls: N concurrent
        # materializations of one segment (prefetcher + executing tasks)
        # share one pull; prefetched segments are retained here until
        # _load_args consumes them (reference: the raylet's pull-manager
        # dedup + dependency prefetch).
        self._pull_registry = object_transfer.PullRegistry()
        self._xfer_sent: Dict[str, int] = {}
        self._xfer_lock = threading.Lock()  # lock-order: leaf
        self.arg_prefetch_depth = int(
            os.environ.get("RAY_TPU_ARG_PREFETCH_DEPTH", "2") or 0)
        self.prefetcher = _ArgPrefetcher(self, self.arg_prefetch_depth)
        # Tasks currently inside _execute (heuristic for "a task is
        # running, queued work is BEHIND it" — the prefetch condition).
        # Lock-guarded updates: threaded actors (max_concurrency > 1)
        # run _execute concurrently, and a lost increment/decrement
        # would wedge the counter (and the prefetch heuristic) forever.
        self._executing = 0
        self._exec_lock = threading.Lock()
        # Completed-task results buffered between queue drains: back-to-
        # back short tasks ride to the driver as ONE result_batch message
        # (reference: batched reply streams; kills per-task head wakeups).
        self._result_buf: list = []
        self._result_lock = threading.Lock()
        # Task execution spans, shipped to the head in periodic batches
        # (reference: task events / tracing_helper.py span injection —
        # every task records submit->run->finish wall times; the head
        # aggregates them for `ray timeline`).
        self._span_buf: list = []
        # Set by worker_entry: True when no tasks are queued.  Results
        # buffer only while more work is queued behind them; a threaded
        # actor's lone reply must go out immediately, not on the 0.25s
        # timer.
        self.queue_empty = lambda: True
        # Caller-side ownership + direct push (reference:
        # direct_task_transport.cc:568 + reference_count.h:61 — this
        # worker OWNS its puts and its direct-submitted tasks' returns;
        # the head is only the lease scheduler for them).
        self._fn_payloads: Dict[str, bytes] = {}
        self.direct = direct_mod.DirectCaller(self)
        # Restartable-actor checkpointing: actor_id -> {"interval",
        # "last"} armed at create_actor when the head said the actor can
        # restart AND the class defines __ray_save__/__ray_restore__.
        self._actor_ck: Dict[bytes, dict] = {}
        self._actor_ck_lock = threading.Lock()
        # --- Head failover (reference: workers reconnecting across GCS
        # restart, gcs_failover_worker_reconnect_timeout).  On head-conn
        # EOF this process PARKS instead of exiting: outgoing head
        # messages buffer in _head_outbox (order preserved), in-flight
        # head requests stay registered in ``pending`` and are replayed
        # verbatim after the re-dial + re-register handshake.  All
        # _conn_down/_head_outbox mutation happens under send_lock.
        self._failover = os.environ.get("RAY_TPU_HEAD_FAILOVER",
                                        "1") == "1"
        self._reconnect_grace = float(os.environ.get(
            "RAY_TPU_HEAD_RECONNECT_GRACE_S", "20") or 0)
        self._conn_down = False
        self._head_outbox: list = []
        # lock-order: io-guard -- serializes re-dial+handshake+replay IO
        self._reconn_lock = threading.Lock()
        self._shutting_down = False
        self.head_reconnects = 0
        # Head-routed PLAIN task specs retained until a return is
        # materialized: their fate at a dead head is unknown, so the
        # re-register replay re-offers them (the head skips any it
        # already knows — at-least-once, the reference retry contract).
        # Bounded FIFO; actor calls are excluded (replay would break
        # per-channel ordering).
        from collections import OrderedDict as _OD

        self._inflight_head_specs: "_OD[bytes, dict]" = _OD()
        self._spec_lock = threading.Lock()  # lock-order: leaf
        # Hooks worker_entry fills in for the re-register payload.
        self.snapshot_tasks = lambda: []
        self.snapshot_actors = lambda: []
        self._executing_tasks: list = []  # (task, is_direct) pairs
        # --- Failure detection (gray failures): head-connection
        # watchdog state.  _last_head_recv/_last_head_send feed the
        # heartbeat floor (quiet link -> one heartbeat per
        # health_check_period_s) and the stalled-head detector: a
        # pending request older than net_stall_timeout_s with total
        # head silence first sends an hc_ping probe; continued silence
        # CLOSES the conn, turning the gray stall into the clean EOF
        # the PR-10 reconnect-and-replay machinery already survives.
        from ray_tpu_torch._private.config import GLOBAL_CONFIG as _cfg

        self._fd_on = _cfg.failure_detection
        self._hc_period = _cfg.health_check_period_s
        self._net_stall_t = _cfg.net_stall_timeout_s
        self._last_head_recv = time.monotonic()
        self._last_head_send = time.monotonic()
        self._hc_probe_sent = 0.0

    # -- peer messaging (ring collectives etc.) ----------------------------
    def register_peer_handler(self, channel: str, fn):
        with self._peer_handlers_lock:
            self.peer_handlers[channel] = fn

    def unregister_peer_handler(self, channel: str):
        with self._peer_handlers_lock:
            self.peer_handlers.pop(channel, None)

    def dispatch_peer_msg(self, channel: str, payload):
        with self._peer_handlers_lock:
            fn = self.peer_handlers.get(channel)
        if fn is not None:
            fn(payload)

    # -- DirectCaller host adapter -----------------------------------------
    def head_request(self, msg_builder):
        return self._request(msg_builder)

    def head_send(self, msg):
        # Raw send: no decref-buffer flush (this is called from within the
        # decref-processing path itself; flushing would recurse into
        # send_lock).
        with self.send_lock:
            self._send_wire([msg])

    def _send_wire(self, msgs: list):
        """One batched write to the head — MUST be called under
        send_lock.  On a broken head conn with failover on, the messages
        PARK in _head_outbox (order preserved) for replay after the
        reconnect instead of raising: every caller on this path is
        fire-and-forget, and the reader thread drives the re-dial."""
        if not msgs:
            return
        if self._conn_down:
            self._head_outbox.extend(msgs)
            return
        try:
            protocol.send_batch(self.conn, msgs)
            self._last_head_send = time.monotonic()
        except Exception:
            if not self._failover or self._shutting_down:
                raise
            self._conn_down = True
            self._head_outbox.extend(msgs)

    def dial(self, addr):
        # Deadline-aware dial (connect timeout + SO_KEEPALIVE when
        # failure detection is on): direct channels to black-holed
        # peers fail in net_connect_timeout_s, not the kernel default.
        conn = protocol.dial(tuple(addr),
                             authkey=bytes.fromhex(
                                 os.environ.get("RAY_TPU_AUTHKEY", "")))
        if self._fd_on and self._net_stall_t > 0:
            # Send half only: pushes to a stalled executor error the
            # sender into the channel-death reroute; the reader stays
            # fully blocking (an idle channel is not a stalled one).
            protocol.set_send_deadline(conn, self._net_stall_t)
        return conn

    def get_payload(self, func_id: str) -> Optional[bytes]:
        return self._fn_payloads.get(func_id)

    def submit_via_head(self, spec: dict):
        # Rerouted specs may carry owned refs: make them head-visible
        # first (same-conn FIFO puts the export before the spec).
        self._export_for_head_path(spec)
        self._note_head_spec(spec)
        self._send(("submit", 0, spec))

    def submit_via_head_many(self, specs: list):
        """Bulk reroute: a starved lease round's REROUTE_CHUNK specs ship
        as ONE ("submit_batch", ...) message (exports first, same-conn
        FIFO) instead of a single-submit storm on the head."""
        for spec in specs:
            self._export_for_head_path(spec)
            self._note_head_spec(spec)
        self._send(("submit_batch", specs))

    @property
    def current_task_id(self) -> Optional[TaskID]:
        return getattr(self._tls, "task_id", None)

    @current_task_id.setter
    def current_task_id(self, v):
        self._tls.task_id = v

    @property
    def current_actor_id(self) -> Optional[ActorID]:
        return getattr(self._tls, "actor_id", None)

    @current_actor_id.setter
    def current_actor_id(self, v):
        self._tls.actor_id = v

    def _cache_put(self, oid: ObjectID, value: Any):
        self._local_cache[oid] = value
        self._local_cache.move_to_end(oid)
        while len(self._local_cache) > self._CACHE_CAP:
            self._local_cache.popitem(last=False)

    # -- plumbing ----------------------------------------------------------
    def _drain_decrefs(self) -> list:
        """Pop the buffered ref drops and apply the OWNED ones locally;
        returns the bins that belong to the head.  Runs outside send_lock
        (owned frees may message lease conns / the head)."""
        with self._decref_lock:
            buf, self._decref_buf = self._decref_buf, []
        if not buf:
            return buf
        head_bins = []
        for b in buf:
            if not self.direct.decref(ObjectID(b)):
                head_bins.append(b)
        return head_bins

    def _drain_put_buffer(self) -> list:
        """Buffered small-put messages that must precede any other
        outgoing message (put -> addref -> later decref ordering).
        Workers put owner-locally so the base buffer is always empty;
        ClientRuntime overrides with its coalescing buffer."""
        return []

    def _send(self, msg, lead=()):
        """Send ``msg``, after any buffered puts, ref drops and the
        ``lead`` messages, in one write."""
        head_bins = self._drain_decrefs()
        abuf = self._drain_actor_decrefs()
        # One ("batch", ...) pickle + one write for the whole burst —
        # buffered ref drops ride the same syscall as the payload.  The
        # put buffer is drained UNDER send_lock (drain is lock-append
        # only, no I/O): draining earlier would open a window where a
        # concurrent flusher's drained-but-unwritten puts let this
        # message overtake a put it references.  Puts precede decrefs —
        # a drop of a coalesced put's ref must never land first.
        with self.send_lock:
            msgs = self._drain_put_buffer()
            if head_bins:
                msgs.append(("decref_batch", head_bins))
            if abuf:
                msgs.append(("actor_decref_batch", abuf))
            msgs.extend(lead)
            msgs.append(msg)
            self._send_wire(msgs)

    def send_result(self, entry):
        """Buffer one completed task's (task_id, ok, returns, meta);
        batches only form while more tasks are queued behind this one."""
        with self._result_lock:
            self._result_buf.append(entry)
            n = len(self._result_buf)
        if n >= 16 or self.queue_empty():
            self.flush_results()

    def flush_results(self):
        with self._result_lock:
            if not self._result_buf:
                return
            buf, self._result_buf = self._result_buf, []
            spans, self._span_buf = self._span_buf, []
        # _send coalesces the results with any buffered decref_batch /
        # actor_decref_batch into ONE ("batch", ...) envelope: the reply
        # burst for N short tasks is one pickle + one write.  The tasks'
        # spans ride ahead of them: a granted worker is retired on its
        # result, and a finished trainer's actor killed, before the
        # periodic flush would ship them.
        lead = [("spans", spans)] if spans else []
        if len(buf) == 1:
            e = buf[0]
            self._send(("result", e[0], e[1], e[2], e[3]), lead)
        else:
            self._send(("result_batch", buf), lead)

    def record_span(self, task_id_bin: bytes, name: str, start: float,
                    end: float, kind: str):
        with self._result_lock:
            self._span_buf.append((task_id_bin, name, start, end, kind))

    def flush_spans(self):
        with self._result_lock:
            if not self._span_buf:
                return
            buf, self._span_buf = self._span_buf, []
        self._send(("spans", buf))

    def flush_xfer_stats(self):
        """Ship data-plane counter deltas (pull dedup, prefetch hit/waste
        bytes) to the head, which aggregates them next to its
        brokered_parts/relayed_segments stats.  Rides the periodic
        flusher and the queue-drain flush; no-delta calls send nothing.

        The stats() snapshots run OUTSIDE _xfer_lock (each takes its own
        lock — the pull registry's leaf, the DirectCaller's big
        ownership lock — and holding the claim lock across them was an
        undeclared nesting edge, found by protocheck RTL505).  The claim
        itself stays atomic under _xfer_lock, and because every counter
        is cumulative, per-key MONOTONIC claiming makes racing flushers
        safe: a flusher that snapshotted earlier but claims later sees
        nothing new and ships nothing — never a duplicate or negative
        delta.  The claim and its write share one send_lock hold
        (``_ship_xfer``)."""
        cur = self._pull_registry.stats()
        # Lease-plane counters ride the same delta stream (the head
        # aggregates leased_submits/spillbacks next to its own
        # lease_grants/head_brokered_submits).
        cur.update(self.direct.stats())
        # Failure-detection counters (stall_timeouts / net_retries /
        # hedged_fetches) — process-wide in the protocol deadline core,
        # aggregated by the head exactly like the rest.
        cur.update(protocol.net_stats())
        # Push-shuffle counters, only if a shuffle actually ran in this
        # process (lazy module lookup: importing the data layer from
        # every worker just to read zeros would be waste).
        shuffle_mod = sys.modules.get("ray_tpu_torch.data.shuffle")
        if shuffle_mod is not None:
            cur.update(shuffle_mod.shuffle_stats())
        # Distributed-training counters, same lazy-lookup contract:
        # present only in workers hosting a pipeline stage actor or an
        # IMPALA learner (stage restores count here too — the restored
        # actor's fresh process imports the module in __ray_restore__).
        train_mod = sys.modules.get("ray_tpu_torch.train.pipeline_actors")
        if train_mod is not None:
            cur.update(train_mod.train_stats())
        self._ship_xfer(cur)

    def flush_train_stats(self):
        """Ship the training counters' deltas AHEAD of a task's result,
        as its spans are: a stage actor is killed as soon as its trainer
        holds the step's results (``PipelineTrainer.shutdown``), before
        the periodic or queue-drain flush would ship what the step
        counted.  Reads only the training module's leaf-locked snapshot
        (no data-plane ``stats()``), and nothing in a worker that never
        imported it."""
        train_mod = sys.modules.get("ray_tpu_torch.train.pipeline_actors")
        if train_mod is not None:
            self._ship_xfer(train_mod.train_stats())

    def _ship_xfer(self, cur: Dict[str, int]):
        """Claim each counter's growth past what was shipped, and write
        the claim, under ONE send_lock hold.  So a flush that returns has
        put on the wire every delta claimed before it, its own and a
        racing flusher's: with the write after the claim's lock, a flush
        could find nothing new while the claimant had yet to write, and
        the process could be killed in between."""
        with self.send_lock:
            with self._xfer_lock:
                delta = {}
                for k, v in cur.items():
                    sent = self._xfer_sent.get(k, 0)
                    if v > sent:
                        delta[k] = v - sent
                        self._xfer_sent[k] = v
            if delta:
                self._send_wire([("xfer_stats", delta)])

    def flush_decrefs(self):
        head_bins = self._drain_decrefs()
        abuf = self._drain_actor_decrefs()
        with self.send_lock:
            # Put drain under send_lock (see _send); puts precede their
            # refs' decrefs in the envelope.
            msgs = self._drain_put_buffer()
            if not msgs and not head_bins and not abuf:
                return
            if head_bins:
                msgs.append(("decref_batch", head_bins))
            if abuf:
                msgs.append(("actor_decref_batch", abuf))
            self._send_wire(msgs)

    # Actor-handle refcounts (reference: actor out-of-scope GC) — the head
    # keeps the authoritative count; addref is sent inline (pickle-time,
    # safe context), decref buffers (fires from __del__).
    def actor_handle_addref(self, actor_id: bytes):
        self._send(("actor_addref", actor_id))

    def actor_handle_serialized(self, actor_id: bytes, token: bytes):
        self._send(("actor_token_new", actor_id, token))

    def actor_handle_deserialized(self, actor_id: bytes, token: bytes):
        self._send(("actor_token_used", actor_id, token))

    def actor_handle_decref(self, actor_id: bytes):
        try:
            with self._decref_lock:
                self._actor_decref_buf.append(actor_id)
        except Exception:
            pass  # shutting down

    def _drain_actor_decrefs(self) -> list:
        """Pop buffered actor-handle drops, HOLDING any whose direct
        channel still has queued/inflight calls — the head cannot see
        direct pushes, so a decref racing ahead of this worker's own
        in-flight calls could zero the count and GC-kill the actor
        mid-call."""
        with self._decref_lock:
            abuf, self._actor_decref_buf = self._actor_decref_buf, []
        if not abuf:
            return abuf
        out, keep = [], []
        for aid in abuf:
            (keep if self.direct.actor_channel_busy(aid)
             else out).append(aid)
        if keep:
            with self._decref_lock:
                self._actor_decref_buf.extend(keep)
        return out

    def _request(self, msg_builder):
        req_id = next(self.req_counter)
        slot: "queue.SimpleQueue" = queue.SimpleQueue()
        msg = msg_builder(req_id)
        with self.pending_lock:
            # The built message is retained alongside the slot: a head
            # restart replays every still-pending request verbatim to
            # the new incarnation (park-and-replay).  The timestamp
            # feeds the head-connection watchdog (a request aging past
            # net_stall_timeout_s under total head silence is the
            # gray-failure signal).
            self.pending[req_id] = (slot, msg, time.monotonic())
        self._send(msg)
        reply = slot.get()
        with self.pending_lock:
            self.pending.pop(req_id, None)
        return reply

    def deliver_reply(self, req_id, payload):
        with self.pending_lock:
            ent = self.pending.get(req_id)
        if ent is not None:
            ent[0].put(payload)

    # -- failure detection: heartbeat floor + head-conn watchdog -----------
    def note_head_recv(self):
        """Reader-thread hook: any head message is liveness."""
        self._last_head_recv = time.monotonic()
        self._hc_probe_sent = 0.0

    def heartbeat_and_watchdog(self):
        """Periodic-flusher hook (failure detection; no-op with the
        switch off).  Two jobs: (a) the heartbeat FLOOR — a link with
        no other outgoing traffic for health_check_period_s sends one
        ("heartbeat", ...) so head-side silence is a signal; (b) the
        stalled-head WATCHDOG — a pending request older than
        net_stall_timeout_s under total head silence probes with
        hc_ping, and a probe unanswered for another full window closes
        the conn, converting the gray stall into the clean EOF the
        reconnect-and-replay machinery already survives."""
        if not self._fd_on or self._shutting_down or self._conn_down:
            return
        now = time.monotonic()
        if self._hc_period > 0 \
                and now - self._last_head_send > self._hc_period:
            try:
                self._send(("heartbeat", self.worker_id_hex))
            except Exception:
                return
        stall_t = self._net_stall_t
        if stall_t <= 0 or not self._failover:
            # Without failover the only answer to a stalled head would
            # be this worker's exit — strictly worse than waiting.
            return
        with self.pending_lock:
            oldest = min((ent[2] for ent in self.pending.values()),
                         default=None)
        if oldest is None:
            self._hc_probe_sent = 0.0
            return
        if now - oldest < stall_t or now - self._last_head_recv < stall_t:
            return
        if not self._hc_probe_sent:
            # First strike: probe.  A busy-but-alive head answers with
            # a generic reply and the reader resets the clock.
            self._hc_probe_sent = now
            try:
                self._send(("hc_ping", next(self.req_counter)))
            except Exception:
                pass
            return
        if now - self._hc_probe_sent > stall_t:
            # Probe unanswered for a full window: the conn is stalled,
            # not busy.  Shutdown (not just close — the reader is by
            # precondition parked inside a blocked recv, which close()
            # cannot wake) so its recv EOFs into _reconnect_head, which
            # re-dials, re-registers, and replays every parked request.
            protocol.note_net_event("stall_timeouts")
            self._hc_probe_sent = 0.0
            try:
                protocol.shutdown_conn(self.conn)
                self.conn.close()
            except Exception:
                pass

    # -- head failover: park, re-dial, re-register, replay -----------------
    def _redial(self):
        """One dial attempt to the head's listener; raises on refusal."""
        addr = protocol.parse_address(os.environ["RAY_TPU_ADDRESS"])
        return protocol.dial(addr, authkey=bytes.fromhex(
            os.environ.get("RAY_TPU_AUTHKEY", "")))

    def _re_handshake(self, conn):
        """Re-register this surviving process with the (restarted) head.
        True = re-admitted; False = permanently refused (nack — the head
        did not restore our cluster); None = transient, retry."""
        protocol.send(conn, ("reregister", self._reregister_info()))
        msg = protocol.recv(conn)  # the ack is first on this conn (FIFO)
        if msg[0] == "reregister_ack":
            return True
        if msg[0] == "reregister_nack":
            return False
        return None

    def _reregister_info(self) -> dict:
        """Everything the restarted head needs to reconcile us back in:
        identity, the actor incarnation we host, our queued/running
        head-dispatched tasks, re-advertised delegated objects, and the
        peer leases we hold."""
        hosted = list(self.snapshot_actors())
        return {
            "worker_id": self.worker_id_hex,
            "node_id": self.node_id_hex,
            "store_id": self.store_id,
            "env_key": os.environ.get("RAY_TPU_ENV_KEY", ""),
            "pid": os.getpid(),
            "direct_addr": self.direct_addr,
            # The node pool's indices of our cards (our
            # CUDA_VISIBLE_DEVICES names them through the host's list).
            "tpu_chips": [c for c in os.environ.get(
                "RAY_TPU_GRANTED_CHIPS", "").split(",") if c],
            "actor_id": (hosted[0] if hosted else None),
            "resources": dict(self.assigned_resources),
            "tasks": self.snapshot_tasks(),
            "objects": self.direct.reregister_exports(),
            "held_leases": self.direct.held_lease_ids(),
        }

    def _reconnect_head(self) -> bool:
        """Reader-thread entry on head-conn EOF: re-dial with backoff
        for the grace window, re-register, then replay pending requests
        and the parked outbox.  False = give up (caller exits, the
        pre-failover behavior)."""
        if not self._failover or self._shutting_down:
            return False
        with self._reconn_lock:
            with self.send_lock:  # noqa: RTL505 -- the reconnect serializer is strictly OUTER to send_lock; no send path takes _reconn_lock
                self._conn_down = True
            deadline = time.monotonic() + self._reconnect_grace
            delay = 0.05
            while time.monotonic() < deadline \
                    and not self._shutting_down:
                conn = None
                try:
                    conn = self._redial()
                    ok = self._re_handshake(conn)
                except Exception:
                    ok = None
                if ok is False:
                    try:
                        conn.close()
                    except Exception:
                        pass
                    return False
                if ok:
                    replay_ok = False
                    with self.send_lock:  # noqa: RTL505 -- reconnect serializer OUTER to send_lock (see above); the replay must exclude concurrent senders
                        self.conn = conn
                        outbox, self._head_outbox = self._head_outbox, []
                        # Requests PARKED while down already sit in the
                        # outbox (in order); replay only the ones that
                        # made it onto the dead conn before the failure,
                        # so nothing is sent twice.
                        parked = {id(m) for m in outbox}
                        with self.pending_lock:
                            replay = [ent[1] for ent in
                                      self.pending.values()
                                      if ent[1] is not None
                                      and id(ent[1]) not in parked]
                        try:
                            # Pending requests were on the wire before
                            # the parked messages existed: replay them
                            # first, then the outbox, in one batch.
                            protocol.send_batch(conn, replay + outbox)
                            self._conn_down = False
                            self.head_reconnects += 1
                            replay_ok = True
                        except Exception:
                            self._head_outbox = outbox
                    if replay_ok:
                        self._after_reconnect()
                        return True
                    # Replay failed (head died again mid-replay): back
                    # off OUTSIDE send_lock so task threads keep parking
                    # into the outbox instead of blocking on the lock.
                    try:
                        conn.close()
                    except Exception:
                        pass
                    time.sleep(delay)
                    delay = min(1.0, delay * 1.7)
                    continue
                if conn is not None:
                    try:
                        conn.close()
                    except Exception:
                        pass
                time.sleep(delay)
                delay = min(1.0, delay * 1.7)
            return False

    def _after_reconnect(self):
        """Post-replay reconciliation: re-offer retained head-routed
        specs whose returns we never materialized — the head runs the
        ones it doesn't already know (at-least-once)."""
        with self._spec_lock:
            specs = list(self._inflight_head_specs.values())
        if specs:
            self._send(("resubmit_batch", specs))

    _HEAD_SPEC_CAP = 512

    def _note_head_spec(self, spec: dict):
        """Retain a head-routed PLAIN spec for failover replay (dropped
        once a return materializes, or FIFO-evicted past the cap)."""
        if not self._failover or "actor_id" in spec:
            return
        with self._spec_lock:
            self._inflight_head_specs[spec["task_id"][:12]] = spec
            while len(self._inflight_head_specs) > self._HEAD_SPEC_CAP:
                self._inflight_head_specs.popitem(last=False)

    def _prune_head_specs(self, oid_bins):
        if not self._inflight_head_specs:
            return
        with self._spec_lock:
            for b in oid_bins:
                self._inflight_head_specs.pop(b[:12], None)

    # -- descriptor handling ----------------------------------------------
    def materialize(self, descr) -> Any:
        try:
            return self._materialize_tracked(descr)
        except exc.ObjectLostError as e:
            # Lost segment: if WE own the object and its lineage
            # survives, re-execute the producer and consume the re-homed
            # result (reference: ObjectRecoveryManager — recovery runs
            # at the owner; head-owned objects already recovered inside
            # the getparts relay, so reaching here means the head
            # refused).
            if not e.reconstructable:
                raise
            oid = self._owned_oid_of(descr)
            if oid is None or not self.direct.reconstruct(oid):
                raise
            try:
                descr2, _st = self.direct.descr_of(oid)
            except Exception:
                raise e from None
            if descr2 is None or descr2[0] == protocol.ERROR:
                raise
            return self._materialize_tracked(descr2)

    def _owned_oid_of(self, descr) -> Optional[ObjectID]:
        """The owned ObjectID a SHM/SPILLED descriptor names (segment
        names embed the oid hex), or None when it isn't ours to
        recover."""
        if descr is None or descr[0] not in (protocol.SHM,
                                             protocol.SPILLED):
            return None
        oid_hex = recovery.seg_oid_hex(descr[1])
        if oid_hex is None:
            return None
        oid = ObjectID(bytes.fromhex(oid_hex))
        if self.direct.status_of(oid) in (None, direct_mod.DELEGATED):
            return None
        return oid

    def _materialize_tracked(self, descr) -> Any:
        prev = getattr(self._tls, "reg_load", None)
        self._tls.reg_load = []
        try:
            return self._materialize_inner(descr)
        finally:
            coll = getattr(self._tls, "reg_load", None)
            self._tls.reg_load = prev
            if coll:
                if prev is not None:
                    prev.extend(coll)  # nested load: outermost applies
                else:
                    adds = [oid for oid, d in coll if d > 0]
                    drops = [oid for oid, d in coll if d <= 0]
                    foreign = self.direct.addref_batch(adds)
                    if foreign:
                        # Rides the conn BEFORE any buffered drop of the
                        # same oid (per-conn FIFO).
                        self._send(("addref_batch", foreign))
                    for oid in drops:
                        if not self.direct.decref(oid):
                            with self._decref_lock:
                                self._decref_buf.append(oid.binary())

    def _materialize_inner(self, descr) -> Any:
        kind = descr[0]
        if kind == protocol.INLINE:
            return serialization.loads_inline(descr[1])
        if kind == protocol.PARTS:
            return serialization.loads(descr[1], descr[2])
        if kind in (protocol.SHM, protocol.SPILLED):
            if len(descr) > 3 and descr[3] != self.store_id:
                # Segment homed in another node's store: pull it directly
                # from that node's object server in 1 MB chunks; the head
                # relays only if the home store has no server (in-process
                # test nodes) or the pull fails.
                if kind == protocol.SHM:
                    value = self._direct_pull(descr)
                    if value is not _PULL_MISS:
                        return value
                ok, reply = self._request(
                    lambda rid: ("getparts", rid, tuple(descr)))
                if not ok:
                    raise self.materialize_error(reply)
                return self.materialize(reply)
            try:
                if kind == protocol.SPILLED:
                    # Same-host spill file: restore by direct read.
                    seg = self.shm.attach_path(descr[1])
                else:
                    seg = self.shm.attach(descr[1])
            except FileNotFoundError:
                # Raced with the owner's spiller (segment moved to disk) or
                # a restore: the owner always knows the current location.
                ok, reply = self._request(
                    lambda rid: ("getparts", rid, tuple(descr)))
                if not ok:
                    raise self.materialize_error(reply)
                return self.materialize(reply)
            self._segments.append(seg)
            return seg.deserialize()
        if kind == protocol.ERROR:
            raise serialization.loads_inline(descr[1])
        raise ValueError(f"bad descriptor {descr!r}")

    def _direct_pull(self, descr):
        seg = self._pull_remote_segment(descr)
        if seg is None:
            return _PULL_MISS
        try:
            meta, bufs = seg.raw_parts()
            return serialization.loads(meta, bufs)
        except Exception:
            # Corrupt/truncated receive: the brokered getparts path
            # re-fetches through the owner (and drives recovery).
            return _PULL_MISS

    def _pull_remote_segment(self, descr, prefetch: bool = False):
        """Singleflight pull of a remote SHM segment into a local read
        Segment (one copy, socket -> mapping).  Concurrent callers for
        the same segment share the leader's pull; a retained prefetched
        segment is consumed directly.  Returns None on any failure — the
        caller falls back to the brokered getparts path (which also
        drives recovery), and a failed leader wakes every waiter into
        that same fallback."""
        key = (descr[3], descr[1])
        reg = self._pull_registry
        for _attempt in range(2):
            ent, leader = reg.begin(key, prefetch=prefetch)
            if leader:
                seg = None
                try:
                    seg = self._pull_segment_once(descr)
                finally:
                    # Publish under all circumstances (incl. an
                    # unexpected raise): waiters must never hang on a
                    # dead leader.
                    reg.finish(key, ent, seg,
                               retain=prefetch and seg is not None)
                return seg
            if prefetch:
                return None  # already in flight or retained: nothing to do
            if not ent.event.is_set():
                ent.wait()
            seg = reg.take(key, ent)
            if seg is not None or ent.failed:
                # A failed leader means the pull path itself is broken:
                # fall back (getparts relay) rather than retry in place.
                return seg
            # Retention evicted the segment between begin() and take():
            # loop once more and re-pull directly as a fresh leader.
        return None

    def resolve_store_addr(self, store):
        """(addr, caps) of a peer store's object server, cached, or None
        when the peer has no server right now.  Shared by the pull path
        and the shuffle map tasks' partition pushes — both need the same
        never-cache-a-miss behavior so a recovered peer gets its fast
        path back."""
        ent = self._store_addrs.get(store)
        if ent is not None:
            return ent
        reply = self._request(
            lambda rid: ("store_addr", rid, store))
        # (addr, caps) from this release's head; a bare addr (no
        # advertised verbs) from an older one.
        if isinstance(reply, tuple):
            addr, caps = reply[0], tuple(reply[1] or ())
        else:
            addr, caps = reply, ()
        if not addr:
            # No server right now (agent dead or mid-restart): do
            # NOT cache the miss — the next pull re-asks, so a
            # recovered peer gets its fast path back.  The relay
            # fallback this returns into is far costlier than the
            # one extra location lookup.
            return None
        ent = self._store_addrs[store] = (addr, caps)
        return ent

    def forget_store_addr(self, store):
        """Drop the cached server address after a failed push/pull so a
        restarted peer re-resolves."""
        self._store_addrs.pop(store, None)

    def _pull_segment_once(self, descr):
        """One actual pull attempt (address resolution + chunk stream);
        returns None instead of raising so singleflight failure wakes
        waiters into their own fallback."""
        store = descr[3]
        ent = self.resolve_store_addr(store)
        if ent is None:
            return None
        addr, caps = ent
        try:
            # One-copy receive: chunks land straight in a local shm
            # mapping; deserialization builds zero-copy views over it
            # (the value's arrays keep the mapping alive).
            return object_transfer.pull_to_segment(
                self._puller, self.shm, store, addr, descr[1], caps=caps)
        except Exception as e:  # noqa: BLE001 -- every failure has the same fallback
            # Agent gone or segment moved: the owner knows the truth —
            # fall back to the brokered path (which also drives recovery).
            # Forget the cached address so a restarted peer re-resolves.
            # A STALLED pull (deadline tripped, transport retries
            # exhausted) lands here too — that fallback is the hedge.
            if protocol.is_stall(e) or (
                    isinstance(e, exc.ObjectLostError)
                    and getattr(e, "phase", None) == "stalled"):
                protocol.note_net_event("hedged_fetches")
            self._store_addrs.pop(store, None)
            return None

    def serialize_value(self, value: Any, object_id: ObjectID):
        """Value -> descriptor, choosing inline vs shm by size (one
        serialization pass; shm buffers memcpy'd once, into the segment).
        Store-full falls back to per-node spilling then direct-to-disk
        (reference: LocalObjectManager spilling + plasma's
        CreateRequestQueue fallback, local_object_manager.h:41)."""
        res = serialization.dumps_adaptive(value, self.max_inline)
        if res[0] == "inline":
            return (protocol.INLINE, res[1])
        try:
            name, size = self.shm.create_from_parts(object_id, res[1],
                                                    res[2])
        except MemoryError:
            need = sum(len(b) for b in res[2]) + len(res[1]) + 65536
            self.direct.spill_owned(need, self.spill_dir)
            try:
                name, size = self.shm.create_from_parts(object_id, res[1],
                                                        res[2])
            except MemoryError:
                path, size = self.shm.create_spilled(
                    object_id, res[1], res[2], self.spill_dir)
                return (protocol.SPILLED, path, size, self.store_id)
        return (protocol.SHM, name, size, self.store_id)

    # -- runtime accessor API (mirrors driver Runtime) ---------------------
    def add_local_reference(self, object_id: ObjectID):
        coll = getattr(self._tls, "reg_load", None)
        if coll is not None:
            # Deserialization in progress: batch-registered at load end —
            # one ownership-lock pass for owned refs, ONE head message for
            # foreign ones (a 10k-ref container otherwise sends 10k
            # addrefs).
            coll.append((object_id, 1))
            return
        if self.direct.addref(object_id):
            return
        self._send(("addref", object_id.binary()))

    def remove_local_reference(self, object_id: ObjectID):
        # Mid-deserialization drop on the loading thread: defer with the
        # batched increments (a drop drained by a nested getparts send
        # could otherwise reach the owner before its matching deferred
        # +1 and transit zero).
        coll = getattr(self._tls, "reg_load", None)
        if coll is not None:
            coll.append((object_id, -1))
            return
        # Buffered, not sent: this runs from ObjectRef.__del__, which the GC
        # may invoke mid-pickle inside _send — taking send_lock here would
        # self-deadlock.  The batch is flushed before the next outgoing
        # message and by the periodic flusher thread.
        try:
            with self._decref_lock:
                self._decref_buf.append(object_id.binary())
        except Exception:
            pass  # shutting down

    def on_ref_serialized(self, object_id: ObjectID):
        # Collect-only, like the driver: the carrying submit/put message
        # lists these ids and the driver pins them on receipt.  Message FIFO
        # per-connection guarantees the pin lands before this worker's own
        # decref for the same ref can.
        collector = getattr(self._tls, "ref_collector", None)
        if collector is not None:
            collector.append(object_id.binary())

    def begin_ref_collection(self):
        self._tls.ref_collector = []

    def end_ref_collection(self) -> list:
        out = getattr(self._tls, "ref_collector", None) or []
        self._tls.ref_collector = None
        return out

    def _notify_blocked(self) -> bool:
        """Whether blocking in get/wait should send the head the
        blocked/unblocked envelope.  The envelope lets the head release
        this worker's lease slot and — crucially for plain task workers
        — excludes it from pipelined dispatch while it waits
        (``w.blocked`` in the pipelinable-worker scan), so PLAIN tasks
        always send it regardless of resources: suppressing it for a
        0-CPU task could queue its own dependency behind its blocked
        get.  ACTOR workers are never pipelined-to (``w.actor_id``
        exclusion) and a client runtime holds no lease at all, so for a
        zero-resource actor (num_cpus=0 normalizes to {"CPU": 0.0} —
        the serve RequestProxy shape, blocking once per routed request)
        and for clients the pair is two head messages per get of pure
        hot-path chatter and is skipped.  Empty/unknown resources keep
        the envelope."""
        if getattr(self, "is_client", False):
            return False
        if self.current_actor_id is None:
            return True
        res = self.assigned_resources
        return not res or any(res.values())

    def get_objects(self, refs, timeout=None):
        """Batched get: owned refs resolve against the local ownership
        table (zero head traffic — the caller IS the metadata authority,
        reference_count.h:61); the rest go to the head in ONE round trip
        (CoreWorker::Get, core_worker.cc:1250)."""
        values = [None] * len(refs)
        owned = []
        missing = []
        for i, ref in enumerate(refs):
            oid = ref.id()
            if oid in self._local_cache:
                values[i] = self._local_cache[oid]
            elif self.direct.status_of(oid) not in (None,
                                                    direct_mod.DELEGATED):
                owned.append((i, oid))
            else:
                missing.append((i, oid))
        if not owned and not missing:
            return values
        import time as _time

        deadline = None if timeout is None else _time.monotonic() + timeout
        tid = self.current_task_id
        # Suppression applies only to purely-OWNED gets (the proxy hot
        # path): before any head fetch — initial misses OR refs that
        # become delegated mid-get — _upgrade_notify below sends the
        # envelope, because the head may need this worker's blocked
        # credit (lend slots) to make the dependency runnable at all on
        # a saturated node.  Clients stay suppressed throughout — they
        # register outside the node worker tables, so their flag feeds
        # nothing.
        notify = self._notify_blocked()
        if notify:
            self._send(("blocked", tid.binary() if tid else b""))

        def _upgrade_notify():
            nonlocal notify
            if not notify and not getattr(self, "is_client", False):
                notify = True
                self._send(("blocked", tid.binary() if tid else b""))
        try:
            if owned:
                done = self.direct.wait_owned([o for _, o in owned],
                                              timeout)
                if not done:
                    raise exc.GetTimeoutError(
                        f"Timed out getting owned objects after {timeout}s")
                for i, oid in owned:
                    if self.direct.status_of(oid) in (
                            None, direct_mod.DELEGATED):
                        # Delegated to the head mid-get (lease starvation
                        # reroute): the head is the authority now.
                        missing.append((i, oid))
                        continue
                    descr, st = self.direct.descr_of(oid)
                    if descr[0] == protocol.ERROR:
                        descr, st = self._maybe_recover_owned(oid, descr,
                                                              st)
                    if descr[0] == protocol.ERROR:
                        raise self.materialize_error(descr)
                    values[i] = self.materialize(descr)
                    if descr[0] == protocol.SHM:
                        st.attached = True
                    self._cache_put(oid, values[i])
            if missing:
                _upgrade_notify()
                left = (None if deadline is None
                        else max(0.0, deadline - _time.monotonic()))
                reply = self._request(
                    lambda rid: ("mget", rid,
                                 [oid.binary() for _, oid in missing],
                                 left))
                self._prune_head_specs(
                    [oid.binary() for ((_i, oid), (ok, _d))
                     in zip(missing, reply) if ok])
                for (i, _oid), (ok, descr) in zip(missing, reply):
                    if not ok:
                        raise self.materialize_error(descr)
                    values[i] = self.materialize(descr)
        finally:
            if notify:
                self._send(("unblocked", tid.binary() if tid else b""))
        return values

    def _maybe_recover_owned(self, oid: ObjectID, descr, st):
        """An ERRORED owned object whose failure wraps a reconstructable
        loss (the producer couldn't fetch a lost argument, or its worker
        died holding the only copy): rebuild through this owner's
        lineage and return the refreshed (descr, state); on refusal the
        original error stands."""
        if self.direct.lineage is None:
            return descr, st
        if self.direct._lost_object_hex(descr) is None:
            return descr, st
        if not self.direct.reconstruct(oid):
            return descr, st
        try:
            return self.direct.descr_of(oid)
        except Exception:
            return descr, st

    def materialize_error(self, descr):
        try:
            return serialization.loads_inline(descr[1])
        except Exception:
            return exc.RayTpuError("unknown error from driver")

    def publish_event(self, topic: str, payload: bytes):
        """Fire-and-forget pubsub to the driver (train session streaming)."""
        self._send(("event", topic, payload))

    def put_object(self, value) -> ObjectRef:
        """Owner-local put: the value lands in this node's store and the
        descriptor stays HERE — no head message at all (reference: plasma
        put + owner-resident metadata; the v1 design registered every put
        at the head, which serialized multi-client put bandwidth through
        one mailbox)."""
        # Apply buffered ref drops first: a put loop's previous segment is
        # freed (and its pages pooled) BEFORE the next allocation, keeping
        # the loop at memcpy speed.  Head-owned drops go back in the
        # buffer — they ride out with the next head message as usual.
        head_bins = self._drain_decrefs()
        if head_bins:
            with self._decref_lock:
                self._decref_buf[:0] = head_bins
        oid = ObjectID.for_put()
        self.begin_ref_collection()
        try:
            descr = self.serialize_value(value, oid)
        finally:
            nested = self.end_ref_collection()
        nested_local, nested_head = [], []
        for b in nested:
            if self.direct.status_of(ObjectID(b)) not in (
                    None, direct_mod.DELEGATED):
                nested_local.append(b)
            else:
                nested_head.append(b)
        if nested_head:
            # Foreign refs nested in the value: hold +1 at the head for
            # this entry's lifetime (pairs with the decref on local free).
            self._send(("addref_batch", nested_head))
        self.direct.register_put(oid, descr, nested_local, nested_head)
        self._cache_put(oid, value)
        return ObjectRef(oid, _register=False)

    def _export_for_head_path(self, spec: dict):
        """A spec routed through the head may carry owned refs (args or
        nested): make them head-visible first (ordering: the export rides
        the same FIFO conn, so it lands before the spec)."""
        bins = set()
        for a in spec.get("args", ()):
            if a[0] == "ref":
                bins.add(a[1])
        for v in (spec.get("kwargs") or {}).values():
            if v[0] == "ref":
                bins.add(v[1])
        bins.update(spec.get("nested_refs", ()))
        owned = [b for b in bins
                 if self.direct.status_of(ObjectID(b))
                 not in (None, direct_mod.DELEGATED)]
        if owned:
            self.direct.export_refs(owned)

    def submit_task(self, spec: dict) -> list:
        """Task submission from inside a worker.  Direct-eligible specs
        are pushed straight to leased peer workers with caller-owned
        returns (direct_task_transport.cc:568); the rest go through the
        head scheduler fire-and-forget (per-conn FIFO makes later uses of
        the returned refs safe)."""
        tid = TaskID(spec["task_id"])
        if spec.get("func_payload") is not None:
            self._fn_payloads.setdefault(spec["func_id"],
                                         spec["func_payload"])
        if "actor_id" in spec:
            states = self.direct.submit_actor(spec)
            if states is not None:
                return [ObjectRef(tid.object_id(i), _register=False)
                        for i in range(spec["num_returns"])]
            self._export_for_head_path(spec)
            self._send(("submit", 0, spec))
            return [ObjectRef(tid.object_id(i), _register=False)
                    for i in range(spec["num_returns"])]
        if self.direct.eligible(spec):
            owned_nested = [
                b for b in spec.get("nested_refs", ())
                if self.direct.status_of(ObjectID(b))
                not in (None, direct_mod.DELEGATED)]
            if owned_nested:
                # Containers in args embed these refs; the executor
                # resolves them through the head, so export first.
                self.direct.export_refs(owned_nested)
            self.direct.submit(spec)
            return [ObjectRef(tid.object_id(i), _register=False)
                    for i in range(spec["num_returns"])]
        self._export_for_head_path(spec)
        self._note_head_spec(spec)
        self._send(("submit", 0, spec))
        # _register=False: the driver counts this worker's reference when it
        # receives the spec (see Runtime.submit_task_from_worker).
        return [ObjectRef(tid.object_id(i), _register=False)
                for i in range(spec["num_returns"])]

    def submit_tasks(self, specs: list) -> list:
        """Bulk fan-out submission from a worker/client: direct-eligible
        specs register in the ownership table under one lock pass and
        pump once per scheduling class (DirectCaller.submit_many);
        head-bound plain specs ship as ONE ("submit_batch", ...) message
        instead of n ("submit", ...) sends.  Actor specs keep the
        per-channel FIFO path (ordering).  Returns one ref list per
        spec, same as n submit_task calls."""
        out = [None] * len(specs)
        direct_specs = []
        head_specs = []
        for i, spec in enumerate(specs):
            if "actor_id" in spec:
                out[i] = self.submit_task(spec)
                continue
            tid = TaskID(spec["task_id"])
            if spec.get("func_payload") is not None:
                self._fn_payloads.setdefault(spec["func_id"],
                                             spec["func_payload"])
            out[i] = [ObjectRef(tid.object_id(j), _register=False)
                      for j in range(spec["num_returns"])]
            if self.direct.eligible(spec):
                direct_specs.append(spec)
            else:
                head_specs.append(spec)
        if direct_specs:
            owned_nested = [
                b for spec in direct_specs
                for b in spec.get("nested_refs", ())
                if self.direct.status_of(ObjectID(b))
                not in (None, direct_mod.DELEGATED)]
            if owned_nested:
                self.direct.export_refs(owned_nested)
            self.direct.submit_many(direct_specs)
        if head_specs:
            for spec in head_specs:
                self._export_for_head_path(spec)
                self._note_head_spec(spec)
            self._send(("submit_batch", head_specs))
        return out

    def wait_objects(self, refs, num_returns, timeout, fetch_local):
        # Same blocked/unblocked envelope as get_objects: the lease's CPU
        # slot is released while this worker sits in ray.wait, so tasks
        # stolen off its pipeline (or anyone else) can actually run.
        import time as _time

        deadline = None if timeout is None else _time.monotonic() + timeout
        tid = self.current_task_id
        # As in get_objects: suppression only for purely-owned waits —
        # foreign (head-routed) refs, whether present up front or
        # appearing mid-wait via delegation, upgrade to the envelope
        # before any head RPC (the blocked credit feeds the head's
        # lend/steal paths).
        notify = self._notify_blocked()
        if notify:
            self._send(("blocked", tid.binary() if tid else b""))

        def _upgrade_notify():
            nonlocal notify
            if not notify and not getattr(self, "is_client", False):
                notify = True
                self._send(("blocked", tid.binary() if tid else b""))

        try:
            while True:
                left = (None if deadline is None
                        else max(0.0, deadline - _time.monotonic()))
                owned, foreign = self.direct.split_refs(refs)
                if foreign:
                    _upgrade_notify()
                if not foreign:
                    ready, delegated = self.direct.wait_owned_n(
                        [r.id() for r in owned], num_returns, left)
                    ready_bin = set(ready)
                    if delegated and len(ready_bin) < num_returns and (
                            left is None or left > 0):
                        continue  # re-split: some refs moved to the head
                    break
                if not owned:
                    ready_bin = set(self._request(
                        lambda rid: ("wait", rid,
                                     [r.id().binary() for r in refs],
                                     num_returns, left)))
                    break
                # Mixed ownership: probe the head (timeout=0 answers
                # immediately, registers nothing) and pace on the local
                # condition variable — no per-poll head state.
                ready, _delegated = self.direct.wait_owned_n(
                    [r.id() for r in owned], num_returns, 0)
                ready_bin = set(ready)
                if len(ready_bin) < num_returns:
                    ready_bin.update(self._request(
                        lambda rid: ("wait", rid,
                                     [r.id().binary() for r in foreign],
                                     num_returns - len(ready_bin), 0)))
                if len(ready_bin) >= num_returns:
                    break
                if deadline is not None and \
                        _time.monotonic() >= deadline:
                    break
                with self.direct.cv:
                    self.direct.cv.wait(0.05)
        finally:
            if notify:
                self._send(("unblocked", tid.binary() if tid else b""))
        ready = [r for r in refs if r.id().binary() in ready_bin]
        not_ready = [r for r in refs if r.id().binary() not in ready_bin]
        return ready, not_ready

    def object_future(self, object_id):
        raise RuntimeError("ObjectRef.future() is driver-only")

    def is_worker(self):
        return True

    # -- restartable-actor checkpoints -------------------------------------
    def arm_actor_checkpoint(self, actor_id: bytes, actor,
                             interval) -> None:
        """Arm periodic __ray_save__ checkpointing for one actor (only
        when the head sent an interval — recovery on + max_restarts != 0
        — and the class actually defines the hook)."""
        if interval is None or not hasattr(actor, "__ray_save__"):
            return
        with self._actor_ck_lock:
            self._actor_ck[actor_id] = {"interval": float(interval),
                                        "last": 0.0}

    def maybe_checkpoint_actor(self, actor_id: bytes, actor) -> None:
        """After a successful method call: serialize __ray_save__ state
        through the store (spill-aware — serialize_value's store-full
        path) and ship the DESCRIPTOR to the head, which retains it for
        the next restart's __ray_restore__.  Throttled by
        actor_checkpoint_interval_s; a failing checkpoint never fails
        the method call that triggered it."""
        ck = self._actor_ck.get(actor_id)
        if ck is None:
            return
        import time as _time

        now = _time.monotonic()
        with self._actor_ck_lock:
            if ck["last"] and now - ck["last"] < ck["interval"]:
                return
            ck["last"] = now
        try:
            state = actor.__ray_save__()
            oid = ObjectID.for_put()
            descr = self.serialize_value(state, oid)
            self._send(("actor_checkpoint", actor_id, descr))
        except Exception:
            traceback.print_exc()

    def force_checkpoint_actor(self, actor_id: bytes, actor) -> None:
        """Drain-time forced checkpoint (head's ``checkpoint_now``):
        serialize ``__ray_save__`` state as raw PARTS — never through
        this node's store, which is about to die with the drain — and
        ship them for the head to re-home on its surviving store.
        ALWAYS replies (descr None without the hook or on a failed
        save) so the head's deadline-bounded drain never stalls on an
        actor that cannot checkpoint."""
        descr = None
        if actor is not None and hasattr(actor, "__ray_save__"):
            try:
                state = actor.__ray_save__()
                kind = serialization.dumps_adaptive(state, self.max_inline)
                if kind[0] == "inline":
                    descr = (protocol.INLINE, kind[1])
                else:
                    # bytes() snapshots: the views borrow the actor's
                    # live buffers, and the send pickles lazily.
                    descr = (protocol.PARTS, kind[1],
                             [bytes(v) for v in kind[2]])
            except Exception:
                traceback.print_exc()
        try:
            # 4th element marks the FORCED reply: the head's drain
            # rendezvous keys on it — a racing periodic checkpoint must
            # not release the drain early (nor clobber the re-homed
            # state; the head guards that side too).
            self._send(("actor_checkpoint", actor_id, descr, True))
        except Exception:
            pass


_PULL_MISS = object()


def _iter_remote_shm_descrs(rt: "_WorkerRuntime", task: dict):
    """The task's arg/kwarg descriptors that live in ANOTHER node's
    store — the ones whose materialization pays a network pull."""
    for d in itertools.chain(task.get("args", ()),
                             (task.get("kwargs") or {}).values()):
        if (isinstance(d, tuple) and d and d[0] == protocol.SHM
                and len(d) > 3 and d[3] != rt.store_id):
            yield d


class _ArgPrefetcher:
    """Pulls the remote SHM args of QUEUED tasks while the current task
    computes, so transfer overlaps compute instead of sitting on the
    task's critical path (reference: the raylet pulls task dependencies
    before the worker starts — dependency_manager.h).

    At most ``depth`` pulls are in flight (one per lazily-started worker
    thread); results land in the runtime's singleflight PullRegistry as
    RETAINED segments that ``_load_args`` consumes.  Everything is
    best-effort: a failed prefetch just leaves the task's own load path
    to do the pull (or fall back to the head relay)."""

    def __init__(self, rt: "_WorkerRuntime", depth: int):
        self._rt = rt
        self._depth = depth
        self._q: "queue.SimpleQueue" = queue.SimpleQueue()
        self._threads = 0
        self._lock = threading.Lock()  # lock-order: leaf
        # Keys queued but not yet processed: duplicate offers of one
        # segment (enqueue-time hook + _load_args, or N queued tasks
        # sharing an arg) collapse to one queue entry instead of N
        # stale items that could re-pull after the segment is consumed.
        self._queued: set = set()

    def offer(self, task: dict):
        """Queue the task's remote args for background pulling."""
        self.offer_descrs(_iter_remote_shm_descrs(self._rt, task))

    def offer_descrs(self, descrs):
        if self._depth <= 0:
            return
        for d in descrs:
            if d[2] > object_transfer.PullRegistry.RETAIN_BYTES:
                # Larger than the retention budget: finish(retain=True)
                # would immediately self-evict it, so a prefetch pull
                # would be pure double transfer — let the task's own
                # load path stream it once.
                continue
            key = (d[3], d[1])
            with self._lock:
                if key in self._queued:
                    continue
                self._queued.add(key)
            self._q.put(d)
            self._ensure_thread()

    def _ensure_thread(self):
        with self._lock:
            if self._threads >= self._depth:
                return
            self._threads += 1
        threading.Thread(target=self._loop, daemon=True,
                         name="ray_tpu_torch-arg-prefetch").start()

    def _loop(self):
        while True:
            d = self._q.get()
            with self._lock:
                self._queued.discard((d[3], d[1]))
            try:
                self._rt._pull_remote_segment(d, prefetch=True)
            except Exception:
                pass  # best-effort; the task's own load path recovers


_runtime: Optional[_WorkerRuntime] = None


def get_worker_runtime() -> Optional[_WorkerRuntime]:
    return _runtime


class _FunctionCache:
    def __init__(self, rt: Optional["_WorkerRuntime"] = None):
        self._fns: Dict[str, Any] = {}
        self._rt = rt

    def has(self, func_id: str) -> bool:
        return func_id in self._fns

    def put(self, func_id: str, payload: bytes):
        self._fns[func_id] = serialization.loads_inline(payload)
        # Raw payloads kept so this worker can re-push definitions to
        # executors it leases directly (reference: the function table is
        # content-addressed and shippable by any holder).
        if self._rt is not None:
            self._rt._fn_payloads[func_id] = payload

    def get(self, func_id: str):
        return self._fns[func_id]


def _execute(rt: _WorkerRuntime, fns: _FunctionCache, task: dict,
             actors: Dict[bytes, Any]):
    """Run one task/actor method; ship results back.

    Reference: _raylet.pyx:702 execute_task — deserialize args, invoke,
    store returns (small inline to owner, large to plasma/shm)."""
    import time as _time

    recovery.syncpoint("exec_start")
    task_id = TaskID(task["task_id"])
    dreply = task.pop("_dreply", None)
    rt.current_task_id = task_id
    num_returns = task["num_returns"]
    name = task.get("name", "task")
    span = [_time.time()]

    def end_span():
        """Record the task's span once: ahead of a head reply (a granted
        worker is retired on its result), else when the task is done."""
        if span:
            rt.record_span(task["task_id"], name, span.pop(), _time.time(),
                           "actor_method" if "actor_id" in task else "task")

    with rt._exec_lock:
        rt._executing += 1
        # Tracked for the failover re-register payload: a head restart
        # mid-execution must learn this task is still producing results
        # here (direct-pushed tasks are owned by their caller, not the
        # head, and are excluded at snapshot time).
        rt._executing_tasks.append((task, dreply is not None))
    try:
        args, kwargs = _load_args(rt, task)
        if "actor_id" in task:
            actor = actors[task["actor_id"]]
            rt.current_actor_id = ActorID(task["actor_id"])
            method = getattr(actor, task["method"])
            result = method(*args, **kwargs)
            if asyncio.iscoroutine(result):
                result = _run_coroutine(result)
        else:
            fn = fns.get(task["func_id"])
            result = fn(*args, **kwargs)
            if asyncio.iscoroutine(result):
                result = _run_coroutine(result)
        returns, nested = _pack_returns(rt, task_id, result, num_returns)
        rt.flush_train_stats()
        if dreply is not None:
            # Direct-pushed task: the reply goes straight to the owning
            # caller on its connection, never through the head.  Nested
            # ref bins ride in meta; this worker addrefs them at the head
            # ON THE CALLER'S BEHALF (the caller's owned entry decrefs on
            # free) so an LRU eviction here cannot free a returned ref
            # before the caller materializes it.
            meta = {}
            if any(nested):
                rt._send(("addref_batch",
                          [b for lst in nested for b in lst]))
                meta = {"nested": nested}
            dreply[0].reply(dreply[1], True, returns, meta)
        else:
            end_span()
            rt.send_result((task["task_id"], True, returns, {}))
        if "actor_id" in task:
            # After the reply (off the caller's latency path): persist
            # __ray_save__ state for restartable actors.
            rt.maybe_checkpoint_actor(task["actor_id"], actor)
    except Exception as e:  # noqa: BLE001 — task errors become objects
        err = exc.TaskError.from_exception(name, e)
        payload = _pickle_error(err)
        returns = [(protocol.ERROR, payload)] * max(1, num_returns)
        rt.flush_train_stats()
        if dreply is not None:
            dreply[0].reply(dreply[1], False, returns, {})
        else:
            end_span()
            rt.send_result((task["task_id"], False, returns, {}))
    finally:
        with rt._exec_lock:
            rt._executing -= 1
            rt._executing_tasks = [
                (t, d) for t, d in rt._executing_tasks
                if t is not task]
        rt.current_task_id = None
        rt.current_actor_id = None
        end_span()


def _pickle_error(err):
    try:
        return serialization.dumps_inline(err)
    except Exception:
        # Exception not picklable — strip the cause, keep the traceback text.
        err.cause = None
        try:
            return serialization.dumps_inline(err)
        except Exception:
            return serialization.dumps_inline(
                exc.RayTpuError(f"unpicklable error: {err}")
            )


def _load_args(rt: _WorkerRuntime, task: dict):
    """Materialize the task's arguments.  Remote SHM args are pulled
    CONCURRENTLY (bounded by arg_prefetch_depth helper threads) instead
    of one blocking stream at a time; materialize() below then consumes
    the pulled segments through the singleflight registry — which also
    makes this a no-op for anything the prefetcher already fetched."""
    depth = getattr(rt, "arg_prefetch_depth", 0)
    if depth > 0:
        remote: Dict[tuple, tuple] = {}
        for d in _iter_remote_shm_descrs(rt, task):
            remote.setdefault((d[3], d[1]), d)
        if len(remote) > 1:
            # The first remote arg streams on THIS thread (inside
            # materialize); the prefetcher's bounded thread pool pulls
            # the rest in parallel — materialize() consumes them through
            # the singleflight registry as they land.
            rt.prefetcher.offer_descrs(list(remote.values())[1:])
    args = [rt.materialize(d) for d in task["args"]]
    kwargs = {k: rt.materialize(d) for k, d in task.get("kwargs", {}).items()}
    return args, kwargs


def _pack_returns(rt: _WorkerRuntime, task_id: TaskID, result, num_returns):
    if num_returns == 1:
        values = [result]
    elif num_returns == 0:
        values = []
    else:
        values = list(result)
        if len(values) != num_returns:
            raise ValueError(
                f"Task declared num_returns={num_returns} but returned "
                f"{len(values)} values"
            )
    out = []
    nested_lists = []
    for i, v in enumerate(values):
        oid = task_id.object_id(i)
        rt.begin_ref_collection()
        try:
            out.append(rt.serialize_value(v, oid))
        finally:
            nested_lists.append(rt.end_ref_collection())
        rt._cache_put(oid, v)
    nested_all = [b for lst in nested_lists for b in lst]
    if nested_all:
        # Returned values embed ObjectRefs: any owned by THIS worker must
        # become head-visible before the consumer tries to use them
        # (simplified borrow protocol — the consumer's addref/get go to
        # the head).
        owned = [b for b in nested_all
                 if rt.direct.status_of(ObjectID(b))
                 not in (None, direct_mod.DELEGATED)]
        if owned:
            rt.direct.export_refs(owned)
    return out, nested_lists


_async_loop = None
_async_loop_lock = threading.Lock()


def _get_async_loop():
    global _async_loop
    with _async_loop_lock:
        if _async_loop is None:
            loop = asyncio.new_event_loop()
            import sys as _sys

            lockcheck = _sys.modules.get("ray_tpu_torch.devtools.lockcheck")
            if lockcheck is not None and lockcheck.enabled():
                # Record async actor handlers that block this loop >50ms
                # (a blocking get/sleep in an async method stalls EVERY
                # coroutine sharing the loop; lint rule RTL101 catches the
                # static cases, this catches the dynamic ones).  Checking
                # sys.modules instead of the env flag honors programmatic
                # lockcheck.install() too, and never imports devtools on
                # the normal path.
                lockcheck.watch_loop(loop)
            t = threading.Thread(target=loop.run_forever, daemon=True,
                                 name="ray_tpu_torch-async")
            t.start()
            _async_loop = loop
    return _async_loop


def _run_coroutine(coro):
    fut = asyncio.run_coroutine_threadsafe(coro, _get_async_loop())
    return fut.result()


def main():
    """Subprocess entry: dial back to the driver's unix socket (reference:
    python/ray/_private/workers/default_worker.py — raylet-spawned worker
    connecting back over the raylet socket)."""
    import time

    from multiprocessing import AuthenticationError

    # runtime_env pip: build/reuse the requirements venv and re-exec
    # under its interpreter BEFORE anything else loads (reference:
    # _private/runtime_env/pip.py materialization).
    from ray_tpu_torch._private.runtime_env_pip import maybe_reexec_into_pip_env

    maybe_reexec_into_pip_env()

    address = protocol.parse_address(os.environ["RAY_TPU_ADDRESS"])
    authkey = bytes.fromhex(os.environ["RAY_TPU_AUTHKEY"])
    conn = None
    for attempt in range(20):
        try:
            # Deadline-aware dial: each attempt bounded by the connect
            # timeout instead of the kernel default.
            conn = protocol.dial(address, authkey=authkey)
            break
        except AuthenticationError:
            # Transient: the accept loop can drop a challenge mid-
            # handshake under load (it serves one handshake at a time);
            # the key itself is from this session's spawn env, so retry.
            time.sleep(0.05 * (attempt + 1))
        except (ConnectionError, OSError):
            time.sleep(0.05 * (attempt + 1))
    if conn is None:
        import sys as _s

        print(f"[ray_tpu_torch worker {os.getpid()}] could not reach driver at "
              f"{address} after 20 attempts", file=_s.stderr)
        raise SystemExit(1)
    worker_entry(
        conn,
        os.environ["RAY_TPU_WORKER_ID"],
        os.environ["RAY_TPU_SESSION"],
        os.environ["RAY_TPU_SHM_DIR_OVERRIDE"],
        int(os.environ["RAY_TPU_MAX_INLINE"]),
        {},
        os.environ["RAY_TPU_NODE_ID"],
        os.environ["RAY_TPU_JOB_ID"],
    )


def _setup_working_dir(rt: "_WorkerRuntime", pkg_id: str):
    """Fetch + extract the job's working_dir package, then chdir into it
    (reference: runtime_env working_dir — agent-materialized per worker;
    here the package ships over the worker's own connection)."""
    import io
    import sys as _sys
    import zipfile

    dest = f"/tmp/ray_tpu_pkg_{pkg_id}"
    if not os.path.isdir(dest):
        blob = rt._request(lambda rid: ("get_package", rid, pkg_id))
        if blob is None:
            return
        tmp = dest + f".tmp{os.getpid()}"
        with zipfile.ZipFile(io.BytesIO(blob)) as z:
            z.extractall(tmp)
        try:
            os.rename(tmp, dest)
        except OSError:
            import shutil

            shutil.rmtree(tmp, ignore_errors=True)
    os.chdir(dest)
    _sys.path.insert(0, dest)


def worker_entry(conn, worker_id_hex: str, session: str, shm_dir: str,
                 max_inline: int, env: Dict[str, str], node_id_hex: str,
                 job_id_hex: str):
    """Worker runtime setup + execution loop (reference:
    core_worker.cc:2413 RunTaskExecutionLoop)."""
    os.environ.update(env)
    # Opt-in chaos rules (RAY_TPU_CHAOS): deterministic self-kills at
    # named syncpoints — armed before anything else so boot-path points
    # fire too.  No-op (and zero steady-state cost) when the var is
    # unset.
    recovery.maybe_arm_env_chaos("worker")
    # Net-chaos rules (RAY_TPU_CHAOS_NET, "worker:<point>:<action>:<n>"):
    # gray failures (stalls/drops/delays) at the protocol seam.
    if os.environ.get("RAY_TPU_CHAOS_NET"):
        from ray_tpu_torch import chaos as chaos_mod

        chaos_mod.maybe_arm_env_net_chaos("worker")
    global _runtime
    send_lock = threading.Lock()  # lock-order: io-guard
    # Workers pool freed segments too (the driver routes "free_segment" back
    # to the creating worker) — without this, every worker-side put writes
    # fresh tmpfs pages at fault+zero speed instead of memcpy speed.
    shm = ShmStore(shm_dir=shm_dir, session_id=session,
                   capacity=int(os.environ.get("RAY_TPU_STORE_BYTES", "0")),
                   pool_bytes=int(os.environ.get("RAY_TPU_POOL_BYTES", "0")))
    rt = _WorkerRuntime(conn, send_lock, shm, max_inline)
    rt.worker_id_hex = worker_id_hex
    rt.node_id_hex = node_id_hex
    rt.job_id_hex = job_id_hex
    rt.tpu_chips = [
        c for c in os.environ.get("CUDA_VISIBLE_DEVICES", "").split(",") if c
    ]
    _runtime = rt
    object_ref_mod._set_runtime_accessor(lambda: _runtime)

    fns = _FunctionCache(rt)
    actors: Dict[bytes, Any] = {}
    # Deque + condition (not SimpleQueue) so the driver can steal back
    # queued-but-unstarted tasks when this worker blocks in ray.get
    # (reference: work stealing in direct_task_transport's pipelining).
    import collections

    tasks = collections.deque()
    tq_cv = threading.Condition()
    pool: Optional[ThreadPoolExecutor] = None
    max_concurrency = 1

    def steal(steal_id, wanted: set):
        stolen = []
        with tq_cv:
            kept = collections.deque()
            while tasks:
                m = tasks.popleft()
                if m[0] == "exec" and "actor_id" not in m[1] \
                        and m[1]["task_id"] in wanted:
                    stolen.append(m[1]["task_id"])
                else:
                    kept.append(m)
            tasks.extend(kept)
        rt._send(("stolen", steal_id, stolen))

    def handle(msg):
        tag = msg[0]
        if tag in ("exec", "create_actor", "kill"):
            with tq_cv:
                queued_behind = bool(tasks) or rt._executing > 0
                tasks.append(msg)
                tq_cv.notify()
            if tag == "exec" and queued_behind:
                # The task landed BEHIND running/queued work: start
                # pulling its remote args now so transfer overlaps the
                # compute ahead of it (the prefetcher is a no-op for
                # local/inline args and when depth is 0).
                rt.prefetcher.offer(msg[1])
        elif tag == "batch" or tag == "msg_batch":
            # Wire-batch envelope (or the legacy conflation-sender
            # spelling): a burst of buffered messages in send order.
            for m in msg[1]:
                handle(m)
        elif tag == "steal":
            steal(msg[1], set(msg[2]))
        elif tag == "lease_grant":
            # Unsolicited bulk lease grant piggybacked on a head-brokered
            # submit burst: adopt off-thread (adoption dials the granted
            # workers; the reader must keep draining).
            threading.Thread(
                target=rt.direct.adopt_grant,
                args=(msg[1], msg[2], msg[3], msg[4], msg[5]),
                daemon=True, name="ray_tpu_torch-lease-adopt").start()
        elif tag == "lease_revoke":
            rt.direct.revoke(msg[1])
        elif tag == "checkpoint_now":
            # Drain: force a __ray_save__ of the hosted actor, parts-
            # shipped so the head re-homes the state on a surviving
            # store.  Rides the EXECUTION queue, not a fresh thread —
            # the save must serialize with the running method exactly
            # like the periodic post-call checkpoint does, or a
            # mid-method snapshot could tear multi-field state.  Jumps
            # the queue (ahead of pending calls, after the running one)
            # unless the actor's create_actor is itself still queued.
            with tq_cv:
                if msg[1] in actors:
                    tasks.appendleft(msg)
                else:
                    tasks.append(msg)
                tq_cv.notify()
        elif tag == "func":
            fns.put(msg[1], msg[2])
        elif tag == "obj":
            rt.deliver_reply(msg[1], (msg[2], msg[3]))
        elif tag == "mgot":
            rt.deliver_reply(msg[1], msg[2])
        elif tag == "waited":
            rt.deliver_reply(msg[1], msg[2])
        elif tag == "reply":
            rt.deliver_reply(msg[1], msg[2])
        elif tag == "hc_probe":
            # Suspicion probe from the head: answer from this reader
            # thread immediately, independent of the exec thread's
            # state — a long task must never read as a dead link.
            rt._send(("heartbeat", rt.worker_id_hex))
        elif tag == "free_segment":
            # The owner freed an object whose segment this worker
            # created; pool the pages for in-place reuse when no other
            # process ever mapped them (reference: plasma arena reuse).
            try:
                rt.shm.unlink(msg[1], msg[2], reusable=msg[3])
            except Exception:
                pass

    def reader():
        while True:
            try:
                msg = protocol.recv(rt.conn)
            except (EOFError, OSError, TypeError):
                # Head gone.  With failover on, PARK: keep executing,
                # buffer outgoing head traffic, re-dial + re-register
                # for the grace window — a head restart is then a blip,
                # not this worker's death.  Reference: workers
                # reconnecting across GCS restart.
                if not rt._reconnect_head():
                    os._exit(0)
            else:
                rt.note_head_recv()  # any head message is liveness
                handle(msg)

    def _queue_empty():
        with tq_cv:
            return not tasks

    rt.queue_empty = _queue_empty

    def snapshot_tasks():
        """Queued + running HEAD-dispatched tasks for the re-register
        payload: (task_id, num_returns, is_actor_call) rows.  Direct-
        pushed tasks are excluded — their owner (the pushing caller) is
        their metadata authority, not the head."""
        with tq_cv:
            queued = [m[1] for m in tasks
                      if m[0] == "exec" and "_dreply" not in m[1]]
        with rt._exec_lock:
            running = [t for t, is_direct in rt._executing_tasks
                       if not is_direct]
        return [(t["task_id"], t["num_returns"], "actor_id" in t)
                for t in queued + running]

    rt.snapshot_tasks = snapshot_tasks
    rt.snapshot_actors = lambda: list(actors.keys())

    threading.Thread(target=reader, daemon=True, name="ray_tpu_torch-reader").start()

    # Direct-push server: peer workers that leased THIS worker connect
    # here and push tasks into the same execution queue (reference: the
    # core worker's PushTask service, core_worker.cc HandlePushTask).
    def direct_enqueue(task: dict, _src):
        with tq_cv:
            tasks.append(("exec", task))
            tq_cv.notify()

    def maybe_prefetch(task: dict):
        # DirectServer calls this BEFORE enqueueing each pushed task:
        # when the task will land behind running/queued work, its remote
        # args start pulling while that work computes.
        with tq_cv:
            busy = bool(tasks) or rt._executing > 0
        if busy:
            rt.prefetcher.offer(task)

    from ray_tpu_torch._private.config import GLOBAL_CONFIG as _cfg

    direct_server = direct_mod.DirectServer(
        bytes.fromhex(os.environ.get("RAY_TPU_AUTHKEY", "")),
        direct_enqueue, fns.put, rt.shm.unlink,
        on_peer_msg=rt.dispatch_peer_msg, queue_empty=_queue_empty,
        on_task_queued=maybe_prefetch,
        queue_depth=lambda: len(tasks),
        spill_depth=(_cfg.lease_spillback_depth
                     if _cfg.decentralized_dispatch else 0),
        spill_info={"node": node_id_hex})
    rt.direct_addr = direct_server.address

    def decref_flusher():
        import time as _time

        while True:
            _time.sleep(0.25)
            try:
                rt.flush_decrefs()
                # Bounds result-batch latency when a long task follows
                # buffered short-task results.
                rt.flush_results()
                rt.flush_spans()
                rt._pull_registry.sweep()
                rt.flush_xfer_stats()
                # Failure detection: the heartbeat floor + the stalled-
                # head watchdog ride the same periodic thread.
                rt.heartbeat_and_watchdog()
                direct_server.flush_replies()
            except Exception:
                return  # conn gone; reader exits the process

    threading.Thread(target=decref_flusher, daemon=True,
                     name="ray_tpu_torch-decref").start()
    protocol.send(conn, ("ready", worker_id_hex, os.getpid(),
                         direct_server.address))

    # After the handshake (the accept loop requires "ready" first): fetch
    # and enter the working_dir package before any task executes — exec
    # messages just queue behind this.
    pkg_id = os.environ.get("RAY_TPU_WORKING_DIR_PKG")
    if pkg_id:
        _setup_working_dir(rt, pkg_id)

    booted = False
    while True:
        with tq_cv:
            drained = not tasks
        if drained:
            # Queue drained: everything buffered goes out as one batch
            # before this worker parks.  Outside tq_cv: the flushes take
            # send locks and must not hold up direct enqueues.
            rt.flush_results()
            rt.flush_xfer_stats()
            direct_server.flush_replies()
        with tq_cv:
            while not tasks:
                tq_cv.wait()
            msg = tasks.popleft()
        tag = msg[0]
        if not booted and tag in ("exec", "create_actor"):
            # The process's start to its first task, shipped ahead of
            # that task's result.
            booted = True
            tracing.record_phase("worker.boot", tracing.process_start(),
                                 time.time(), msg[1]["task_id"])
        if tag == "kill":
            os._exit(0)
        elif tag == "checkpoint_now":
            # On the exec thread: the running method (if any) finished
            # before this popped, so the forced save sees settled state
            # (max_concurrency>1 actors keep the same exposure their
            # periodic checkpoints already have).
            rt.force_checkpoint_actor(msg[1], actors.get(msg[1]))
        elif tag == "create_actor":
            spec = msg[1]
            rt.assigned_resources = spec.get("resources", {})
            max_concurrency = spec.get("max_concurrency", 1)
            if max_concurrency > 1:
                pool = ThreadPoolExecutor(max_workers=max_concurrency)
            try:
                cls = fns.get(spec["func_id"])
                args = [rt.materialize(d) for d in spec["args"]]
                kwargs = {
                    k: rt.materialize(d) for k, d in spec["kwargs"].items()
                }
                actor = cls(*args, **kwargs)
                ck = spec.get("checkpoint")
                if ck is not None and hasattr(actor, "__ray_restore__"):
                    # Restart with retained state: __init__ ran fresh
                    # above, then the last __ray_save__ state restores
                    # over it.  A broken checkpoint degrades to the
                    # fresh actor — it must never fail the restart
                    # (that would turn recovery into the outage).
                    try:
                        actor.__ray_restore__(rt.materialize(ck))
                    except Exception:
                        traceback.print_exc()
                rt.arm_actor_checkpoint(spec["actor_id"], actor,
                                        spec.get("checkpoint_interval"))
                actors[spec["actor_id"]] = actor
                rt._send(("result", spec["task_id"], True,
                          [(protocol.INLINE,
                            serialization.dumps_inline(None))], {}))
            except Exception as e:  # noqa: BLE001
                err = exc.TaskError.from_exception(
                    spec.get("name", "actor.__init__"), e)
                rt._send(("result", spec["task_id"], False,
                          [(protocol.ERROR, _pickle_error(err))], {}))
        elif tag == "exec":
            task = msg[1]
            if "actor_id" not in task:
                # Actor-method execs keep the CREATION resources: the
                # actor's worker holds those for its lifetime, and the
                # head's per-method record defaults to {"CPU": 1} even
                # for a 0-CPU actor (which would wrongly re-enable the
                # blocked envelope on the serve proxy hot path).
                rt.assigned_resources = task.get("resources",
                                                 rt.assigned_resources)
            if pool is not None and "actor_id" in task:
                pool.submit(_execute, rt, fns, task, actors)
            else:
                _execute(rt, fns, task, actors)


if __name__ == "__main__":
    # Run through the canonical module so module globals (the worker runtime
    # singleton) live in ray_tpu_torch._private.worker_main, not __main__.
    from ray_tpu_torch._private.worker_main import main as _canonical_main

    _canonical_main()
