"""Caller-side ownership + direct worker↔worker task push.

This is the TPU-era re-design of the reference's ownership architecture
(``src/ray/core_worker/transport/direct_task_transport.cc:568`` — callers
lease workers from the scheduler and push tasks to them directly, and
``src/ray/core_worker/reference_count.h:61`` — the caller *owns* its tasks'
returns and is the metadata authority for them).  The head grants worker
leases (resource accounting only); task specs, results, object descriptors
and reference counts for worker-submitted work never touch the head.  This
is what makes N concurrent clients scale: in the v1 design every submit,
result, put and decref funneled through the head's single mailbox, which
collapsed multi-client throughput (the reference's microbenchmarks run 4
independent drivers for exactly this reason).

Two halves:

- ``DirectServer``: runs inside every worker.  A TCP listener (cluster
  authkey) accepting connections from peer workers; each connection can
  push ``dexec`` tasks that flow into the worker's normal execution queue,
  with replies routed back on the originating connection.
- ``DirectCaller``: runs inside every worker (and, via the same interface,
  the driver).  Keeps the *owned object table* (our ownership analog of
  ``reference_count.h``), per-scheduling-class lease pools, caller-side
  dependency resolution, pipelined pushes, and executor-death resubmits.

Fallbacks: anything the direct path does not cover (placement groups,
runtime_env, TPU resources, non-owned ref args, lease starvation) routes
through the existing head path, with owned return refs *delegated* to the
head so both paths share one lifetime story.

Data plane: the direct path never moves payload bytes itself.  Results
and big args travel as SHM *location* descriptors (name, size, store);
a consumer on another node resolves the store's object-server address
through the head once (``store_addr`` — address + verb caps) and pulls
the segment over pooled, striped connections straight into local shm
(object_transfer.py).  The head-relayed ``getparts`` path stays as the
fallback for consumers without direct reachability.

Wire contract: every verb this module sends or handles (``dexec``/
``dexec_batch``/``dfunc``/``dfree``/``dmsg``/``dresult``/
``dresult_batch``/``dspill`` on the direct plane, plus the lease and
ownership-delegation verbs to the head) is declared in
``protocol.VERBS`` and machine-checked against these sites by
``python -m ray_tpu_torch.devtools.protocheck`` (roles, arity, caps gating).
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from ray_tpu_torch._private import protocol, recovery, serialization
from ray_tpu_torch._private.config import GLOBAL_CONFIG
from ray_tpu_torch._private.ids import ObjectID, TaskID
from ray_tpu_torch import exceptions as exc

# Owned-object status values.
PENDING = 0
READY = 1
ERRORED = 2
DELEGATED = 3  # handed to the head (exported or rerouted); head is authority

PIPELINE_DEPTH = 8       # default unacked pushes per leased worker (a v1
#                          lease grant overrides this with its slot count)
MAX_LEASES_PER_REQ = 8
LEASE_LINGER_S = 0.2     # idle time before a lease is returned to the head
REROUTE_CHUNK = 32       # specs sent via the head per failed lease round
ACTOR_PIPELINE = 64      # max unacked direct pushes per actor channel
SPILL_MAX = 3            # spillbacks before an entry reroutes to the head
SATURATED_S = 0.1        # how long a spilled-off lease is deprioritized


class OwnedState:
    """Caller-side record of one owned object (reference_count.h:61 — the
    owner holds status, descriptor, refcounts and waiters)."""

    __slots__ = (
        "status", "descr", "local_refs", "pins", "task_id_bin",
        "nested_local", "nested_head", "attached", "shipped", "creator",
    )

    def __init__(self, task_id_bin: Optional[bytes] = None):
        self.status = PENDING
        self.descr = None
        self.local_refs = 0
        self.pins = 0              # inflight-spec / nested-container pins
        self.task_id_bin = task_id_bin  # producing task (resubmit lineage)
        self.nested_local = []     # owned oid_bins pinned inside this value
        self.nested_head = []      # head-owned oid_bins this entry holds +1 on
        self.attached = False      # we mmap'd the segment (no pool reuse)
        self.shipped = False       # descriptor left this process
        self.creator = None        # _Lease whose worker created the segment


class _Lease:
    """One leased executor worker + its direct connection."""

    __slots__ = ("worker_id", "addr", "conn", "send_lock", "inflight",
                 "funcs_sent", "dead", "idle_since", "klass",
                 "outbuf", "buf_lock", "node_hex", "slots", "pushed",
                 "last_renew", "saturated_until", "ttl", "last_recv",
                 "ping_sent")

    def __init__(self, worker_id: str, addr, klass, node_hex=None,
                 slots=PIPELINE_DEPTH, ttl=0.0):
        self.worker_id = worker_id
        self.addr = addr
        self.conn = None
        self.send_lock = threading.Lock()  # lock-order: io-guard
        self.inflight: Dict[int, dict] = {}  # rid -> entry
        self.funcs_sent: set = set()
        self.dead = False
        self.idle_since = time.monotonic()
        self.klass = klass
        # Lease-plane state (decentralized dispatch): the granting node,
        # the granted execution-slot count (pipeline bound for THIS
        # lease), the GRANTED renewal TTL (authoritative — the head's
        # reaper expires against its own clock, so renewal cadence must
        # come from the grant, never this process's local config; 0 =
        # legacy grant, no renewals), pushes since the last renewal, and
        # the spillback deprioritization deadline.
        self.node_hex = node_hex
        self.slots = max(1, slots)
        self.ttl = float(ttl or 0.0)
        self.pushed = 0
        self.last_renew = time.monotonic()
        self.saturated_until = 0.0
        # Conflation-sender buffer: pushes append here (buf_lock only)
        # while a flush's pickle+write runs under send_lock — appenders
        # never block on an in-flight write, which is what lets batches
        # self-clock with no added latency floor.
        self.outbuf: List[tuple] = []
        self.buf_lock = threading.Lock()  # lock-order: leaf
        # Channel-liveness state (failure detection): last_recv is
        # stamped by the reader on EVERY message; the watchdog probes a
        # channel with in-flight pushes and no traffic for
        # net_stall_timeout_s (dping — the executor's conn thread
        # answers even mid-compute) and closes one whose probe went
        # unanswered for another full window, feeding the existing
        # conn-EOF rediscovery/reroute path.
        self.last_recv = time.monotonic()
        self.ping_sent = 0.0

    def send(self, msg):
        with self.send_lock:
            protocol.send(self.conn, msg)

    def queue_msgs(self, msgs):
        with self.buf_lock:
            self.outbuf.extend(msgs)

    def flush_buffered(self):
        with self.buf_lock:
            if not self.outbuf:
                return
            msgs, self.outbuf = self.outbuf, []
        # Merge the buffered dexec/dexec_batch frames into ONE
        # dexec_batch (dfuncs keep their position before the first exec
        # that needs them), then ship everything as one pickle + write.
        pre, execs = [], []
        for m in msgs:
            if m[0] == "dexec":
                execs.append((m[1], m[2]))
            elif m[0] == "dexec_batch":
                execs.extend(m[1])
            else:
                pre.append(m)
        if execs:
            pre.append(("dexec", execs[0][0], execs[0][1])
                       if len(execs) == 1 else ("dexec_batch", execs))
        with self.send_lock:
            protocol.send_batch(self.conn, pre)


class DirectCaller:
    """Ownership table + lease pools for one worker/driver process.

    ``host`` is an adapter exposing what we need from the enclosing
    runtime:  head_request(build_msg) -> reply, head_send(msg),
    submit_via_head(spec), materialize(descr), shm store, store_id,
    authkey, register_payload(func_id) -> payload bytes.
    """

    def __init__(self, host):
        self.host = host
        self.lock = threading.Lock()
        self.cv = threading.Condition(self.lock)
        self.owned: Dict[ObjectID, OwnedState] = {}
        # sched class key -> pool state
        self.pools: Dict[tuple, dict] = {}
        self.rid_counter = itertools.count(1)
        self._stopped = False
        self._linger_thread = None
        # dep oid_bin -> [entries waiting on it] (caller-side resolution)
        self._dep_waiters: Dict[bytes, list] = {}
        self._pending_exports: set = set()
        # Outbound free/decref messages produced under self.lock; sent
        # after release (a peer's full TCP buffer must never stall the
        # whole ownership table).
        self._outbound: List[tuple] = []
        # actor_id -> channel dict for direct actor calls (reference:
        # direct_actor_task_submitter.h:67 — per-actor ordered pushes
        # straight to the actor's worker).  state: new -> resolving ->
        # direct | head ("head" is sticky: once any call routes through
        # the head, later calls do too, preserving per-caller order).
        self.actor_channels: Dict[bytes, dict] = {}
        # Conflation sender for direct pushes: _push_group buffers per
        # lease and this thread flushes; while one flush's pickle+write
        # runs, later submissions coalesce into the next batch — a
        # fan-out burst costs ~1 syscall per batch instead of one per
        # task (reference: gRPC stream write coalescing on PushTask).
        self._dirty_leases: set = set()
        self._lease_dirty_lock = threading.Lock()
        self._send_event = threading.Event()
        self._sender_thread = None
        # Decentralized-dispatch holder counters, shipped to the head in
        # the periodic xfer_stats deltas (zero while the switch is off):
        # leased_submits = specs pushed over leases (the traffic the head
        # never sees), spillbacks = pushes an oversubscribed executor
        # bounced back.
        self.leased_submits = 0
        self.spillbacks = 0
        # Worker-side lineage (reference: the owner retains its tasks'
        # specs, task_manager.h:174): THIS process is the owner directory
        # for its direct-submitted tasks, so reconstruction of their lost
        # returns must run here — the head never saw the specs.  Bounded
        # by the same byte budget as the head's table; None when the
        # recovery subsystem is off (every counter then stays zero).
        # LOCK ORDER: the table's _lock is an independent LEAF acquired
        # under self.lock (record on submit, release on free) — pinned
        # in tests/test_lockcheck.py.
        cfg = GLOBAL_CONFIG
        self.lineage = (recovery.LineageTable(cfg.lineage_bytes_budget)
                        if cfg.recovery and cfg.lineage_enabled else None)
        self.reconstructions = 0
        self.reconstruction_failures = 0
        # Failure detection: the channel-liveness watchdog's stall
        # window (0 = off, nothing new runs — the legacy behavior where
        # only a conn EOF discovers a dead executor).
        self._fd_stall_t = (cfg.net_stall_timeout_s
                            if cfg.failure_detection else 0.0)

    def stats(self) -> Dict[str, int]:
        """Counter snapshot for the xfer_stats delta shipper."""
        with self.lock:
            return {"leased_submits": self.leased_submits,
                    "spillbacks": self.spillbacks,
                    "reconstructions": self.reconstructions,
                    "reconstruction_failures":
                        self.reconstruction_failures}

    # ------------------------------------------------------------- owned --
    def register_put(self, oid: ObjectID, descr, nested_local, nested_head):
        with self.lock:
            st = OwnedState()
            st.status = READY
            st.descr = descr
            st.local_refs = 1
            st.nested_local = list(nested_local)
            st.nested_head = list(nested_head)
            for b in nested_local:
                inner = self.owned.get(ObjectID(b))
                if inner is not None:
                    inner.pins += 1
            self.owned[oid] = st
        return st

    def addref(self, oid: ObjectID) -> bool:
        """True if ``oid`` is owned here (ref counted locally)."""
        with self.lock:
            st = self.owned.get(oid)
            if st is None:
                return False
            st.local_refs += 1
            return True

    def addref_batch(self, oids: List[ObjectID]) -> List[bytes]:
        """Addref every owned oid under ONE lock pass; returns the bins
        of the foreign (head-owned) ones for the caller to batch-send."""
        foreign: List[bytes] = []
        with self.lock:
            for oid in oids:
                st = self.owned.get(oid)
                if st is None:
                    foreign.append(oid.binary())
                else:
                    st.local_refs += 1
        return foreign

    def decref(self, oid: ObjectID) -> bool:
        """True if owned here.  DELEGATED entries forward to the head when
        the last local ref drops (their head refcount carries exactly one
        aggregate ref for this process)."""
        with self.lock:
            st = self.owned.get(oid)
            if st is None:
                return False
            st.local_refs -= 1
            self._maybe_free_locked(oid, st)
        self._flush_outbound()
        return True

    def _maybe_free_locked(self, oid: ObjectID, st: OwnedState):
        if st.local_refs > 0 or st.pins > 0:
            return
        if st.status == PENDING:
            # Refs dropped before the producing task finished: keep the
            # entry; completion re-checks (the result may still matter for
            # pinned consumers).  Mark for free-on-complete.
            return
        self.owned.pop(oid, None)
        if self.lineage is not None:
            # Lineage pinning ends with the object: the table entry
            # drops when its last return object does (leaf lock; no
            # resources to release worker-side).
            self.lineage.release(oid.binary())
        if st.status == DELEGATED:
            # Head holds one aggregate ref for this process.
            self._outbound.append(("head", ("decref", oid.binary())))
        elif st.descr is not None and st.descr[0] == protocol.SHM:
            self._free_segment_locked(st)
        elif st.descr is not None and st.descr[0] == protocol.SPILLED:
            if st.descr[3] == self.host.store_id:
                try:
                    os.unlink(st.descr[1])
                except OSError:
                    pass
            else:
                self._outbound.append(("head", ("free_remote", st.descr[1],
                                                st.descr[2], st.descr[3])))
        for b in st.nested_local:
            inner = self.owned.get(ObjectID(b))
            if inner is not None:
                inner.pins -= 1
                self._maybe_free_locked(ObjectID(b), inner)
        if st.nested_head:
            self._outbound.append(
                ("head", ("decref_batch", list(st.nested_head))))

    def _free_segment_locked(self, st: OwnedState):
        name, size = st.descr[1], st.descr[2]
        store = st.descr[3] if len(st.descr) > 3 else self.host.store_id
        lease = st.creator
        if lease is not None and not lease.dead and lease.conn is not None:
            # The creating worker pools its pages for in-place reuse iff no
            # other process ever mapped the segment.
            self._outbound.append(
                ("lease", lease,
                 ("dfree", name, size, not st.attached and not st.shipped),
                 ("free_remote", name, size, store)))
        elif store == self.host.store_id:
            try:
                # Self-created segments (owner-local puts) whose descriptor
                # never escaped pool their pages for in-place reuse — this
                # is what keeps a put loop at memcpy speed instead of
                # fresh-page fault+zero speed (plasma arena reuse).
                self.host.shm.unlink(
                    name, size,
                    reusable=(st.creator is None and not st.attached
                              and not st.shipped))
            except Exception:
                pass
        else:
            self._outbound.append(
                ("head", ("free_remote", name, size, store)))

    def _flush_outbound(self):
        if not self._outbound:
            return
        with self.lock:
            out, self._outbound = self._outbound, []
        # Consecutive head-bound messages coalesce into one ("batch", ...)
        # envelope (relative order with lease-bound frees is preserved by
        # flushing in segments) — a result burst's decref storm becomes
        # one pickle + one write.
        head_buf: List[tuple] = []

        def flush_head():
            if not head_buf:
                return
            msgs, head_buf[:] = list(head_buf), []
            try:
                self.host.head_send(protocol.make_batch(msgs))
            except Exception:
                pass

        for item in out:
            if item[0] == "lease":
                flush_head()
                _kind, lease, msg, fallback = item
                try:
                    lease.send(msg)
                    continue
                except Exception:
                    pass
                head_buf.append(fallback)
            else:
                head_buf.append(item[1])
        flush_head()

    # ------------------------------------------------------------ submit --
    def eligible(self, spec: dict) -> bool:
        """Direct-pushable?  Conservative: CPU-only, default strategy, no
        runtime_env; ref args must be owned (pending deps resolved caller-
        side) and not delegated."""
        if "actor_id" in spec:
            return False
        if spec.get("scheduling_strategy") is not None:
            return False
        if spec.get("runtime_env"):
            return False
        if spec.get("retry_exceptions"):
            # Opt-in app-error retry lives in the head's result path
            # (one implementation of the retry budget); conservative
            # eligibility is the direct plane's standing pattern.
            return False
        res = spec.get("resources") or {}
        if any(k != "CPU" for k in res):
            return False
        with self.lock:
            for a in self._iter_ref_args(spec):
                st = self.owned.get(ObjectID(a))
                if st is None or st.status == DELEGATED:
                    return False
        return True

    @staticmethod
    def _iter_ref_args(spec):
        for a in spec.get("args", ()):
            if a[0] == "ref":
                yield a[1]
        for a in (spec.get("kwargs") or {}).values():
            if a[0] == "ref":
                yield a[1]

    def _register_entry_locked(self, spec: dict,
                               retries: int) -> Tuple[dict, list]:
        """Shared submit bookkeeping: owned return states, arg/nested
        pins, and dep-waiter registration for pending owned args."""
        tid = TaskID(spec["task_id"])
        entry = {
            "spec": spec, "rid": None, "retries": retries,
            "deps": 0, "tid_bin": spec["task_id"], "pinned": (),
        }
        # Head-owned refs nested in container args get +1 at the head for
        # the task's lifetime (the head path pins nested_refs in
        # submit_task_from_worker; without this the caller's own decref
        # could free them before the executor deserializes the arg).
        foreign_nested = [b for b in spec.get("nested_refs", ())
                          if self.owned.get(ObjectID(b)) is None]
        if foreign_nested:
            entry["foreign_nested"] = foreign_nested
            self._outbound.append(("head", ("addref_batch",
                                            foreign_nested)))
        states = []
        for i in range(spec["num_returns"]):
            st = OwnedState(spec["task_id"])
            st.local_refs = 1
            self.owned[tid.object_id(i)] = st
            states.append(st)
        pinned = list(itertools.chain(self._iter_ref_args(spec),
                                      spec.get("nested_refs", ())))
        for b in pinned:
            ist = self.owned.get(ObjectID(b))
            if ist is not None:
                ist.pins += 1
        entry["pinned"] = pinned
        for b in self._iter_ref_args(spec):
            ist = self.owned.get(ObjectID(b))
            if ist is not None and ist.status == PENDING:
                entry["deps"] += 1
                self._dep_waiters.setdefault(b, []).append(entry)
        return entry, states

    def submit(self, spec: dict) -> List[OwnedState]:
        """Register owned returns + queue the spec for push.  Caller-side
        dependency resolution: the spec is held until every owned ref arg
        is READY (reference: the caller's LocalDependencyResolver,
        direct_task_transport.cc:33)."""
        return self.submit_many([spec])[0]

    def submit_many(self, specs: List[dict]) -> List[List[OwnedState]]:
        """Bulk submission: every spec's owned returns / arg pins
        register under ONE ownership-lock pass, then each scheduling
        class pumps once for the whole batch (reference: the amortized
        per-SchedulingKey submission of direct_task_transport.cc)."""
        states_out: List[List[OwnedState]] = []
        klasses: List[tuple] = []
        with self.lock:
            for spec in specs:
                entry, states = self._register_entry_locked(
                    spec, spec.get("max_retries", 3))
                if self.lineage is not None \
                        and spec.get("num_returns", 0) > 0:
                    # Owner-side lineage (metadata only — evicted
                    # entries hold nothing to release here; a spec's
                    # lost args reconstruct through their OWN lineage,
                    # the head model).
                    self.lineage.record(spec)
                states_out.append(states)
                if entry["deps"] == 0:
                    klass = self._sched_class(spec)
                    self._pool_locked(klass)["queue"].append(entry)
                    klasses.append(klass)
        # Flush BEFORE returning to user code: the foreign-nested addref
        # must be on the wire before the user can drop their own ref
        # (whose buffered decref rides a later send on the same conn).
        self._flush_outbound()
        for klass in dict.fromkeys(klasses):
            self._pump(klass)
        return states_out

    def _sched_class(self, spec) -> tuple:
        res = spec.get("resources") or {"CPU": 1.0}
        return tuple(sorted(res.items()))

    def _pool_locked(self, klass) -> dict:
        pool = self.pools.get(klass)
        if pool is None:
            pool = self.pools[klass] = {
                "queue": deque(), "leases": [], "requesting": False,
                "last_req": 0.0,
            }
        return pool

    # -------------------------------------------------------------- pump --
    def _pump(self, klass):
        """Push queued specs onto leases with free pipeline slots; request
        more leases (or fall back to the head) when short.

        Lease plane: each lease is bounded by its GRANTED slot count (the
        head capped it at max_tasks_in_flight_per_worker), a recently
        spilled-off lease is throttled to a trickle while its
        saturation window runs (the bulk diverts to other leases or a
        hint-steered request), and the TTL renewal rides out of the same
        pass — one ("lease_renew", ...) per lease_renew_tasks pushes, not
        one per task."""
        cfg = GLOBAL_CONFIG
        to_push: List[Tuple[_Lease, dict]] = []
        need_leases = 0
        renew: List[str] = []
        with self.lock:
            pool = self.pools.get(klass)
            if pool is None:
                return
            leases = [l for l in pool["leases"] if not l.dead]
            pool["leases"] = leases
            q = pool["queue"]
            now = time.monotonic()
            while q:
                lease = None
                for cand in leases:
                    cap = (1 if now < cand.saturated_until
                           else cand.slots)
                    if len(cand.inflight) < cap:
                        lease = cand
                        break
                if lease is None:
                    break
                entry = q.popleft()
                rid = next(self.rid_counter)
                entry["rid"] = rid
                lease.inflight[rid] = entry
                lease.idle_since = None
                lease.pushed += 1
                if lease.ttl > 0 and lease.pushed >= max(
                        1, cfg.lease_renew_tasks):
                    lease.pushed = 0
                    lease.last_renew = now
                    renew.append(lease.worker_id)
                to_push.append((lease, entry))
            if cfg.decentralized_dispatch:
                self.leased_submits += len(to_push)
            if q and not pool["requesting"]:
                if now - pool["last_req"] > 0.05 or not leases:
                    pool["requesting"] = True
                    pool["last_req"] = now
                    need_leases = min(MAX_LEASES_PER_REQ,
                                      max(1, len(q) // PIPELINE_DEPTH))
            if renew:
                self._outbound.append(("head", ("lease_renew", renew)))
        by_lease: Dict[int, Tuple[_Lease, list]] = {}
        for lease, entry in to_push:
            by_lease.setdefault(id(lease), (lease, []))[1].append(entry)
        for lease, entries in by_lease.values():
            self._push_group(lease, entries)
        if renew:
            self._flush_outbound()
        if need_leases:
            threading.Thread(
                target=self._request_leases, args=(klass, need_leases),
                daemon=True).start()

    def _push_group(self, lease: _Lease, entries: List[dict]):
        """Queue a burst of entries for the conflation sender.  The
        sender ships everything buffered per lease as ONE wire frame —
        per-task sends made the push path syscall- and pickle-bound
        under multi-client load (reference: gRPC stream write coalescing
        on the PushTask stream)."""
        cfg = GLOBAL_CONFIG
        # Spillback is opt-in PER PUSH (capability gate): only tasks the
        # caller marks may bounce — an executor never spills a push whose
        # sender would not understand the ("dspill", ...) reply.  Actor
        # channels never spill (per-caller ordering).
        spill_ok = (cfg.decentralized_dispatch
                    and cfg.lease_spillback_depth > 0
                    and not (lease.klass and lease.klass[0] == "actor"))
        tasks, failed = [], []
        for entry in entries:
            try:
                task = self._build_task(entry["spec"])
                if spill_ok:
                    task["_spill_ok"] = True
                tasks.append((entry, task))
            except exc.RayTpuError as e:
                failed.append((entry, e))
        if failed:
            with self.lock:
                for entry, _ in failed:
                    lease.inflight.pop(entry["rid"], None)
            for entry, e in failed:
                self._fail_entry(entry, e)
        if not tasks:
            return
        msgs = []
        for entry, _task in tasks:
            fid = entry["spec"].get("func_id")
            if fid and fid not in lease.funcs_sent:
                payload = self.host.get_payload(fid)
                if payload is not None:
                    msgs.append(("dfunc", fid, payload))
                lease.funcs_sent.add(fid)
        if len(tasks) == 1:
            msgs.append(("dexec", tasks[0][0]["rid"], tasks[0][1]))
        else:
            msgs.append(("dexec_batch", [(e["rid"], t) for e, t in tasks]))
        lease.queue_msgs(msgs)
        self._mark_lease_dirty(lease)

    def _mark_lease_dirty(self, lease: _Lease):
        with self._lease_dirty_lock:
            self._dirty_leases.add(lease)
            if self._sender_thread is None:
                self._sender_thread = threading.Thread(
                    target=self._lease_sender_loop, daemon=True,
                    name="ray_tpu_torch-direct-sender")
                self._sender_thread.start()
        self._send_event.set()

    def _lease_sender_loop(self):
        """Flush dirty leases' push buffers.  Self-clocking: while one
        flush's pickle+write runs here, the submitting thread keeps
        appending to the next batch."""
        while not self._stopped:
            self._send_event.wait()
            self._send_event.clear()
            with self._lease_dirty_lock:
                dirty, self._dirty_leases = self._dirty_leases, set()
            for lease in dirty:
                try:
                    lease.flush_buffered()
                except Exception:
                    self._on_lease_dead(lease)

    def _build_task(self, spec: dict) -> dict:
        """Spec -> executable task dict: owned ref args substituted with
        their descriptors (the caller is the metadata authority)."""
        def subst(a):
            if a[0] != "ref":
                return a
            with self.lock:
                st = self.owned.get(ObjectID(a[1]))
                # DELEGATED entries keep a valid descriptor (exports move
                # metadata authority, not data); only a truly descriptor-
                # less entry is an error.
                if st is None or st.descr is None:
                    raise exc.ObjectLostError(
                        object_id=a[1].hex(),
                        owner=getattr(self.host, "worker_id_hex", None),
                        phase="dispatch")
                st.shipped = True
                return st.descr

        task = {
            "task_id": spec["task_id"],
            "num_returns": spec["num_returns"],
            "name": spec.get("name", "task"),
            "args": [subst(a) for a in spec.get("args", ())],
            "kwargs": {k: subst(v)
                       for k, v in (spec.get("kwargs") or {}).items()},
            "resources": spec.get("resources") or {},
        }
        if "actor_id" in spec:
            task["actor_id"] = spec["actor_id"]
            task["method"] = spec["method"]
        else:
            task["func_id"] = spec["func_id"]
        return task

    # ------------------------------------------------------------ actors --
    def submit_actor(self, spec: dict) -> Optional[List[OwnedState]]:
        """Direct actor-call path.  Returns owned return states when the
        call was queued on a direct channel, or None when the caller must
        route through the head (unresolved/dead actor, foreign ref args,
        sticky head mode).

        Ordering: a channel that must fall back enters ``head_draining``
        — queued-and-future calls are held until every already-pushed
        call acks, then flush through the head in order.  This closes
        the window where a head-routed call could overtake an inflight
        direct push (the sequence-number guarantee of
        direct_actor_task_submitter.h:67)."""
        aid = spec["actor_id"]
        # Export owned nested refs BEFORE the entry becomes pushable: a
        # concurrent _pump_actor may push it the moment it is queued, and
        # the executor resolves container refs through the head.
        owned_nested = [b for b in spec.get("nested_refs", ())
                        if self.status_of(ObjectID(b))
                        not in (None, DELEGATED)]
        if owned_nested:
            self.export_refs(owned_nested)
        with self.lock:
            ch = self.actor_channels.get(aid)
            if ch is None:
                ch = self.actor_channels[aid] = {
                    "state": "new", "lease": None, "queue": deque()}
            if ch["state"] == "head":
                return None
            foreign_arg = False
            for b in self._iter_ref_args(spec):
                st = self.owned.get(ObjectID(b))
                if st is None or (st.descr is None
                                  and st.status == DELEGATED):
                    foreign_arg = True
                    break
            if foreign_arg:
                lease = ch["lease"]
                if ch["state"] == "direct" and lease is not None \
                        and lease.inflight:
                    # Inflight direct pushes: drain before any head
                    # routing (order).  This call joins the held queue
                    # as a head-bound entry.
                    ch["state"] = "head_draining"
                    entry, states = self._register_entry_locked(spec, 0)
                    entry["via_head"] = True
                    ch["queue"].append(entry)
                    return states
                queued = list(ch["queue"])
                ch["queue"].clear()
                ch["state"] = "head"
            else:
                queued = None
                entry, states = self._register_entry_locked(spec, 0)
                if ch["state"] == "head_draining":
                    entry["via_head"] = True
                ch["queue"].append(entry)
                if ch["state"] == "new":
                    ch["state"] = "resolving"
                    threading.Thread(target=self._resolve_actor,
                                     args=(aid,), daemon=True).start()
        if queued is not None:
            for e in queued:
                self._reroute_to_head(e)
            return None
        self._flush_outbound()
        self._pump_actor(aid)
        return states

    def _resolve_actor(self, aid: bytes):
        try:
            reply = self.host.head_request(
                lambda rid: ("actor_addr_req", rid, aid))
        except Exception:
            reply = None
        lease = None
        if reply:
            wid, addr = reply
            lease = _Lease(wid, addr, ("actor", aid))
            try:
                lease.conn = self.host.dial(addr)
            except Exception:
                lease = None
        queued = None
        with self.lock:
            ch = self.actor_channels.get(aid)
            if ch is None:
                return
            if lease is None:
                queued = list(ch["queue"])
                ch["queue"].clear()
                ch["state"] = "head"
            else:
                ch["lease"] = lease
                ch["state"] = "direct"
        if queued is not None:
            self._reroute_many(queued)
            return
        threading.Thread(target=self._lease_reader, args=(lease,),
                         daemon=True).start()
        if self._fd_stall_t > 0:
            # Actor channels live outside the lease pools; the linger
            # loop is also their liveness watchdog.
            self._ensure_linger_thread()
        self._pump_actor(aid)

    def _pump_actor(self, aid: bytes):
        """Strictly FIFO: the queue head pushes only once its deps are
        READY — later entries wait behind it (per-caller ordering, the
        sequence-number guarantee of direct_actor_task_submitter.h:67)."""
        to_push, to_head = [], []
        with self.lock:
            ch = self.actor_channels.get(aid)
            if ch is None:
                return
            if ch["state"] == "head_draining":
                lease = ch["lease"]
                if lease is None or not lease.inflight:
                    # Every direct push acked: safe to flush the held
                    # calls through the head in order.
                    to_head = list(ch["queue"])
                    ch["queue"].clear()
                    ch["state"] = "head"
                    ch["lease"] = None
            elif ch["state"] == "direct":
                lease = ch["lease"]
                q = ch["queue"]
                # Bounded pipeline: beyond ACTOR_PIPELINE unacked pushes,
                # calls wait here and ride out in result-clocked batches —
                # unbounded per-call sends made the channel syscall-bound.
                while q and q[0]["deps"] == 0 \
                        and len(lease.inflight) < ACTOR_PIPELINE:
                    entry = q.popleft()
                    rid = next(self.rid_counter)
                    entry["rid"] = rid
                    lease.inflight[rid] = entry
                    to_push.append((lease, entry))
        if to_head:
            self._reroute_many(to_head)
        if to_push:
            self._push_group(to_push[0][0], [e for _, e in to_push])

    def _pump_any(self, klass):
        if klass and klass[0] == "actor":
            self._pump_actor(klass[1])
        else:
            self._pump(klass)

    def actor_channel_busy(self, aid: bytes) -> bool:
        """True while this process still has queued or unacked direct
        calls to the actor (the worker holds its actor-handle decrefs
        until then — the head cannot see direct pushes)."""
        with self.lock:
            ch = self.actor_channels.get(aid)
            if ch is None:
                return False
            if ch["queue"]:
                return True
            lease = ch.get("lease")
            return lease is not None and bool(lease.inflight)

    def _on_actor_channel_dead(self, lease: _Lease, aid: bytes):
        """Actor worker conn broke: already-pushed calls may have run, so
        they fail (ActorDiedError, the reference's default for actor
        tasks); never-pushed queued calls reroute through the head, which
        knows the actor's restart state authoritatively."""
        with self.lock:
            ch = self.actor_channels.get(aid)
            inflight = list(lease.inflight.values())
            lease.inflight.clear()
            queued = []
            if ch is not None and ch.get("lease") is lease:
                queued = list(ch["queue"])
                ch["queue"].clear()
                ch["state"] = "head"
                ch["lease"] = None
        try:
            if lease.conn is not None:
                lease.conn.close()
        except Exception:
            pass
        for entry in inflight:
            self._fail_entry(entry, exc.ActorDiedError(
                "Actor worker connection lost (direct channel)"))
        self._reroute_many(queued)

    # ------------------------------------------------------------ leases --
    def _request_leases(self, klass, n):
        pool = None
        cfg = GLOBAL_CONFIG
        hint = None
        if cfg.decentralized_dispatch:
            with self.lock:
                p = self.pools.get(klass)
                if p is not None:
                    # One-shot spillback hint: steer this request toward
                    # the node the head named as next-best.
                    hint = p.pop("hint", None)
        try:
            res = dict(klass)
            if cfg.decentralized_dispatch:
                opts = {"v": 1}
                if hint:
                    opts["hint"] = hint
                reply = self.host.head_request(
                    lambda rid: ("lease_req", rid, res, n, opts))
            else:
                reply = self.host.head_request(
                    lambda rid: ("lease_req", rid, res, n))
        except Exception:
            reply = []
        slots, ttl = PIPELINE_DEPTH, 0.0
        if isinstance(reply, dict):
            # v1 grant: per-worker node ids + slot count + TTL + the
            # next-best-node hint for a future spillback.
            slots = int(reply.get("slots") or PIPELINE_DEPTH)
            ttl = float(reply.get("ttl") or 0.0)
            if reply.get("hint"):
                with self.lock:
                    p = self.pools.get(klass)
                    if p is not None:
                        p.setdefault("hint", reply["hint"])
            rows = reply.get("grants") or []
        else:
            rows = [(wid, addr, None) for wid, addr in (reply or [])]
        granted = self._dial_grants(klass, rows, slots, ttl)
        with self.lock:
            pool = self.pools.get(klass)
            if pool is None:
                return
            pool["requesting"] = False
            for lease in granted:
                pool["leases"].append(lease)
            stranded = []
            if not granted and pool["queue"] and not pool["leases"]:
                # Starved even after the head parked the request: route a
                # BOUNDED chunk through the head (progress guarantee) and
                # keep the rest queued for the next lease request — the
                # v1 full-queue dump made every concurrent caller collapse
                # onto the head's single mailbox the moment leases
                # momentarily ran out.
                for _ in range(min(len(pool["queue"]), REROUTE_CHUNK)):
                    stranded.append(pool["queue"].popleft())
                if pool["queue"]:
                    pool["last_req"] = 0.0  # next _pump re-requests now
        for lease in granted:
            threading.Thread(target=self._lease_reader, args=(lease,),
                             daemon=True).start()
        if stranded:
            self._reroute_many(stranded)
        if granted:
            self._pump(klass)
            self._ensure_linger_thread()
        elif stranded:
            # Nothing granted and specs remain queued: re-pump so a fresh
            # lease request goes out (no submit/result event will — the
            # caller may already be parked in ray.get).
            self._pump(klass)

    def _dial_grants(self, klass, rows, slots, ttl) -> List["_Lease"]:
        """Granted (wid, addr, node_hex) rows -> dialed _Lease objects
        (the shared adoption core of solicited replies and unsolicited
        lease_grant pushes).  Dial happens here, once, before the lease
        is visible to _pump: the reader thread and pushers then share
        one connection.  A failed dial returns that lease to the head
        immediately."""
        granted: List[_Lease] = []
        for wid, addr, node_hex in rows or []:
            lease = _Lease(wid, addr, klass, node_hex=node_hex,
                           slots=int(slots or PIPELINE_DEPTH),
                           ttl=float(ttl or 0.0))
            try:
                lease.conn = self.host.dial(addr)
            except Exception:
                try:
                    self.host.head_send(("lease_return", [wid]))
                except Exception:
                    pass
                continue
            granted.append(lease)
        return granted

    def adopt_grant(self, klass_items, grants, slots, ttl, hint):
        """Adopt an UNSOLICITED bulk lease grant the head piggybacked on
        a head-brokered submit burst (("lease_grant", ...)): dial the
        granted workers and fold them into the matching pool so the next
        burst pushes direct.  Runs off the reader thread (dials block).
        Unused grants return via the normal linger path."""
        klass = tuple((k, float(v)) for k, v in klass_items)
        granted = self._dial_grants(klass, grants, slots, ttl)
        if not granted:
            return
        with self.lock:
            pool = self._pool_locked(klass)
            pool["leases"].extend(granted)
            if hint:
                pool.setdefault("hint", hint)
        for lease in granted:
            threading.Thread(target=self._lease_reader, args=(lease,),
                             daemon=True).start()
        self._pump(klass)
        self._ensure_linger_thread()

    def revoke(self, worker_ids):
        """Head-initiated lease revocation (("lease_revoke", ...): node/
        worker death or TTL expiry).  The lease-death path reroutes or
        retries everything the lease still carried — same semantics as
        discovering the death via conn EOF, minus the wait."""
        wids = set(worker_ids)
        with self.lock:
            doomed = [l for p in self.pools.values() for l in p["leases"]
                      if l.worker_id in wids and not l.dead]
            for ch in self.actor_channels.values():
                lease = ch.get("lease")
                if lease is not None and lease.worker_id in wids \
                        and not lease.dead:
                    doomed.append(lease)
        for lease in doomed:
            self._on_lease_dead(lease)

    def _on_spillback(self, lease: _Lease, rid, info):
        """An oversubscribed executor bounced a push (reference: hybrid
        policy spillback).  Re-queue the entry at the FRONT of its class
        (rough submission order) and throttle the bouncing lease for the
        saturation window; the next lease request is steered by the
        next-best-node hint the HEAD attached to the grant (``info``
        names only the bouncing executor's node — the executor has no
        cluster view).  An entry that keeps bouncing reroutes to the
        head — guaranteed progress."""
        reroute = None
        with self.lock:
            entry = lease.inflight.pop(rid, None)
            if entry is None:
                return
            if GLOBAL_CONFIG.decentralized_dispatch:
                self.spillbacks += 1
            lease.saturated_until = time.monotonic() + SATURATED_S
            entry["spills"] = entry.get("spills", 0) + 1
            pool = self._pool_locked(lease.klass)
            bounced = (info or {}).get("node")
            if bounced and pool.get("hint") == bounced:
                # The stored next-best hint points at the node that just
                # bounced us — stale; drop it rather than steer the next
                # lease request back into the hot spot.
                pool.pop("hint", None)
            if entry["spills"] >= SPILL_MAX:
                reroute = entry
            else:
                pool["queue"].appendleft(entry)
            if not lease.inflight:
                lease.idle_since = time.monotonic()
        if reroute is not None:
            self._reroute_to_head(reroute)
        else:
            self._pump(lease.klass)

    def _lease_reader(self, lease: _Lease):
        while not self._stopped:
            try:
                msg = protocol.recv(lease.conn)
            except (EOFError, OSError, TypeError):
                self._on_lease_dead(lease)
                return
            lease.last_recv = time.monotonic()
            if msg[0] == "dresult":
                self._on_result_batch(lease, [msg[1:]])
            elif msg[0] == "dresult_batch":
                self._on_result_batch(lease, msg[1])
            elif msg[0] == "dspill":
                self._on_spillback(lease, msg[1], msg[2])
            elif msg[0] == "dpong":
                pass  # the last_recv stamp above IS the liveness signal

    def _on_result_batch(self, lease: _Lease, items):
        """Apply a burst of results under ONE lock pass (one notify, one
        outbound flush, one pump) — per-result locking was the caller-side
        bottleneck at multi-client rates."""
        exported = []
        dep_klasses = set()
        with self.lock:
            for rid, _ok, returns, meta in items:
                entry = lease.inflight.pop(rid, None)
                if entry is None:
                    continue
                tid = TaskID(entry["tid_bin"])
                nested = meta.get("nested") or [[] for _ in returns]
                for i, descr in enumerate(returns):
                    oid = tid.object_id(i)
                    item_ok = descr[0] != protocol.ERROR
                    bin_ = oid.binary()
                    if bin_ in self._pending_exports:
                        # The shell was exported to the head while pending
                        # (delegated): complete it there too.
                        self._pending_exports.discard(bin_)
                        exported.append((bin_, item_ok, descr,
                                         list(nested[i])
                                         if i < len(nested) else [],
                                         lease.worker_id))
                    st = self.owned.get(oid)
                    if st is None:
                        continue
                    if st.status != DELEGATED:
                        st.status = READY if item_ok else ERRORED
                    st.descr = descr
                    if descr[0] == protocol.SHM:
                        st.creator = lease
                    if i < len(nested) and nested[i]:
                        # The executor addref'd these at the head for us
                        # (borrowed-ref transfer).  Bins WE own pin locally
                        # instead — the head shell the executor's addref
                        # created doesn't protect our local entry — and the
                        # on-behalf head ref is returned immediately.
                        for b in nested[i]:
                            ist = self.owned.get(ObjectID(b))
                            if ist is not None and ist.status != DELEGATED:
                                ist.pins += 1
                                st.nested_local.append(b)
                                self._outbound.append(
                                    ("head", ("decref", b)))
                            else:
                                st.nested_head.append(b)
                    self._maybe_free_locked(oid, st)
                self._unpin_entry_locked(entry)
                dep_klasses.update(self._wake_deps_locked(entry))
            if not lease.inflight:
                lease.idle_since = time.monotonic()
            self.cv.notify_all()
        if exported:
            try:
                self.host.head_send(("export_complete", exported))
            except Exception:
                pass
        self._flush_outbound()
        self._pump_any(lease.klass)
        for klass in dep_klasses:
            if klass != lease.klass:
                self._pump_any(klass)

    def _unpin_entry_locked(self, entry):
        for b in entry.get("pinned", ()):
            ist = self.owned.get(ObjectID(b))
            if ist is not None:
                ist.pins -= 1
                self._maybe_free_locked(ObjectID(b), ist)
        entry["pinned"] = ()
        fn = entry.pop("foreign_nested", None)
        if fn:
            self._outbound.append(("head", ("decref_batch", fn)))

    def _wake_deps_locked(self, entry: dict) -> List[tuple]:
        """Dependent specs waiting on this task's returns may now push;
        returns the scheduling classes to pump (after lock release)."""
        tid = TaskID(entry["tid_bin"])
        ready = []
        for i in range(entry["spec"]["num_returns"]):
            waiters = self._dep_waiters.pop(tid.object_id(i).binary(), None)
            for dep_entry in waiters or ():
                dep_entry["deps"] -= 1
                if dep_entry["deps"] == 0:
                    ready.append(dep_entry)
        klasses = set()
        for dep_entry in ready:
            if dep_entry.get("rerouted"):
                continue
            spec = dep_entry["spec"]
            if "actor_id" in spec:
                # Actor entries never left their channel queue (FIFO);
                # just pump the channel.
                klasses.add(("actor", spec["actor_id"]))
            else:
                klass = self._sched_class(spec)
                self._pool_locked(klass)["queue"].append(dep_entry)
                klasses.add(klass)
        return list(klasses)

    def _on_lease_dead(self, lease: _Lease):
        """Executor died or conn broke: resubmit its inflight work
        (caller-side retries; reference: lease worker failure handling in
        direct_task_transport.cc)."""
        if lease.klass and lease.klass[0] == "actor":
            with self.lock:
                if lease.dead:
                    return
                lease.dead = True
            self._on_actor_channel_dead(lease, lease.klass[1])
            return
        with self.lock:
            if lease.dead:
                return
            lease.dead = True
            inflight = list(lease.inflight.values())
            lease.inflight.clear()
            pool = self.pools.get(lease.klass)
            if pool is not None and lease in pool["leases"]:
                pool["leases"].remove(lease)
        try:
            if lease.conn is not None:
                lease.conn.close()
        except Exception:
            pass
        try:
            self.host.head_send(("lease_return", [lease.worker_id]))
        except Exception:
            pass
        retry, fail = [], []
        with self.lock:
            for entry in inflight:
                if entry["retries"] > 0:
                    entry["retries"] -= 1
                    retry.append(entry)
                else:
                    fail.append(entry)
        for entry in retry:
            with self.lock:
                pool = self._pool_locked(lease.klass)
                pool["queue"].append(entry)
        for entry in fail:
            self._fail_entry(entry, exc.WorkerCrashedError(
                f"worker {lease.worker_id} died running "
                f"{entry['spec'].get('name', 'task')}"))
        if retry:
            self._pump(lease.klass)

    def _fail_entry(self, entry, error: BaseException):
        err_descr = (protocol.ERROR, serialization.dumps_inline(error))
        tid = TaskID(entry["tid_bin"])
        exported = []
        with self.lock:
            for i in range(entry["spec"]["num_returns"]):
                bin_ = tid.object_id(i).binary()
                if bin_ in self._pending_exports:
                    self._pending_exports.discard(bin_)
                    exported.append((bin_, False, err_descr, []))
                st = self.owned.get(tid.object_id(i))
                if st is not None:
                    if st.status != DELEGATED:
                        st.status = ERRORED
                    st.descr = err_descr
                    self._maybe_free_locked(tid.object_id(i), st)
            self._unpin_entry_locked(entry)
            dep_klasses = self._wake_deps_locked(entry)
            self.cv.notify_all()
        if exported:
            try:
                self.host.head_send(("export_complete", exported))
            except Exception:
                pass
        self._flush_outbound()
        for klass in dep_klasses:
            self._pump_any(klass)

    def _reroute_to_head(self, entry):
        self._reroute_many([entry])

    def _reroute_many(self, entries):
        """No leases: delegate these specs (and their owned returns) to
        the head scheduler so progress is guaranteed.  A starved round
        reroutes REROUTE_CHUNK specs — they ship as ONE
        ("submit_batch", ...) message (one export pass, one pickle+write,
        one head registration pass) instead of a single-submit storm,
        which is exactly the multi-client fan-in path under contention.
        The entries' arg pins are released only AFTER the head has the
        specs — the export in submit_via_head must still see the args
        alive (a dropped-ref arg would otherwise be freed before the
        head could pin it).

        Dependents parked on these tasks' returns reroute too: no
        dresult will ever arrive here to wake them, and the head
        resolves delegated deps natively (their shells export with the
        specs)."""
        done = []
        dependents = []
        actor_flips = []
        with self.lock:
            for entry in entries:
                if entry.get("rerouted"):
                    continue
                entry["rerouted"] = True
                spec = entry["spec"]
                tid = TaskID(entry["tid_bin"])
                for i in range(spec["num_returns"]):
                    st = self.owned.get(tid.object_id(i))
                    if st is not None:
                        st.status = DELEGATED
                    for dep_entry in self._dep_waiters.pop(
                            tid.object_id(i).binary(), []) or []:
                        dep_entry["deps"] -= 1
                        if dep_entry.get("rerouted"):
                            continue
                        dspec = dep_entry["spec"]
                        if "actor_id" in dspec:
                            # Actor entries stay in their channel queue;
                            # the channel must go head-mode (order-
                            # preserving drain) since this dep resolves
                            # at the head.
                            actor_flips.append(dspec["actor_id"])
                            dep_entry["via_head"] = True
                        else:
                            dependents.append(dep_entry)
                done.append(entry)
        if not done and not actor_flips:
            return
        if len(done) > 1 and hasattr(self.host, "submit_via_head_many"):
            self.host.submit_via_head_many([e["spec"] for e in done])
        else:
            for entry in done:
                self.host.submit_via_head(entry["spec"])
        with self.lock:
            for entry in done:
                self._unpin_entry_locked(entry)
            for aid in actor_flips:
                ch = self.actor_channels.get(aid)
                if ch is not None and ch["state"] in ("direct",
                                                      "resolving", "new"):
                    ch["state"] = "head_draining"
            self.cv.notify_all()
        self._flush_outbound()
        if dependents:
            self._reroute_many(dependents)
        for aid in set(actor_flips):
            self._pump_actor(aid)

    def _ensure_linger_thread(self):
        # The linger loop clears _linger_thread under self.lock in the
        # same critical section where it confirms no leases remain, so
        # this check can't race a thread that is about to exit.
        with self.lock:
            if self._linger_thread is None:
                self._linger_thread = threading.Thread(
                    target=self._linger_loop, daemon=True,
                    name="ray_tpu_torch-lease-linger")
                self._linger_thread.start()

    def _linger_loop(self):
        """Return idle leases to the head after LEASE_LINGER_S; renew
        BUSY leases' TTLs periodically (a long-running pushed task emits
        no per-task renewals, and an unrenewed lease would be revoked
        out from under it).  The deadline comes from each lease's
        GRANTED ttl — the head's reaper expires against its own config,
        which a config-skewed external client does not share."""
        stall_t = self._fd_stall_t
        tick = (min(LEASE_LINGER_S / 2, stall_t / 2) if stall_t > 0
                else LEASE_LINGER_S / 2)
        while not self._stopped:
            time.sleep(tick)
            to_return: List[_Lease] = []
            renew: List[str] = []
            ping: List[_Lease] = []
            stalled: List[_Lease] = []

            def check_liveness(lease):
                # Channel-liveness watchdog (failure detection): a
                # channel with unacked pushes and no traffic for
                # stall_t gets a dping (answered by the executor's conn
                # thread even mid-compute — a LONG TASK is not a
                # stalled link); a probe unanswered for another full
                # window means the channel, and closing it routes
                # everything through the existing conn-EOF rediscovery.
                if (stall_t <= 0 or lease.conn is None or lease.dead
                        or not lease.inflight):
                    return
                if now - lease.last_recv <= stall_t:
                    return
                if lease.ping_sent <= lease.last_recv:
                    lease.ping_sent = now
                    ping.append(lease)
                elif now - lease.ping_sent > stall_t:
                    stalled.append(lease)

            now = time.monotonic()
            with self.lock:
                any_leases = False
                for pool in self.pools.values():
                    keep = []
                    for lease in pool["leases"]:
                        if (not lease.inflight and not pool["queue"]
                                and lease.idle_since is not None
                                and now - lease.idle_since
                                > LEASE_LINGER_S):
                            to_return.append(lease)
                        else:
                            keep.append(lease)
                            any_leases = True
                            if (lease.ttl > 0 and lease.inflight
                                    and now - lease.last_renew
                                    > lease.ttl / 3):
                                lease.last_renew = now
                                renew.append(lease.worker_id)
                            check_liveness(lease)
                    pool["leases"] = keep
                if stall_t > 0:
                    # Actor channels ride the same watchdog (their
                    # leases live outside the pools) and keep this
                    # thread alive while any exist.
                    for ch in self.actor_channels.values():
                        lease = ch.get("lease")
                        if lease is not None:
                            any_leases = True
                            check_liveness(lease)
            if ping:
                # Outside the lock (socket writes).  SO_SNDTIMEO on
                # direct-channel conns bounds these; a send failure IS
                # the stall verdict.
                for lease in ping:
                    try:
                        lease.send(("dping", 0))
                    except Exception:
                        stalled.append(lease)
            if stalled:
                for lease in stalled:
                    protocol.note_net_event("stall_timeouts")
                    try:
                        # Shutdown, not just close: the reader is by
                        # precondition parked inside a blocked recv,
                        # which close() cannot wake on Linux — shutdown
                        # EOFs it immediately.
                        protocol.shutdown_conn(lease.conn)
                        lease.conn.close()
                    except Exception:
                        pass
                    # The parked reader thread's recv now EOFs and
                    # runs _on_lease_dead: in-flight pushes reroute via
                    # the head exactly like conn-EOF discovery.
            if renew:
                try:
                    self.host.head_send(("lease_renew", renew))
                except Exception:
                    pass
            for lease in to_return:
                lease.dead = True
                try:
                    if lease.conn is not None:
                        lease.conn.close()
                except Exception:
                    pass
            if to_return:
                try:
                    self.host.head_send(
                        ("lease_return", [l.worker_id for l in to_return]))
                except Exception:
                    pass
            if not any_leases and not to_return:
                # Exit decision under the SAME lock acquisition that saw
                # zero leases — a concurrent grant either sees the thread
                # cleared (and respawns it) or appended its lease before
                # this scan (and the loop continues).
                with self.lock:
                    still_empty = not any(
                        p["leases"] for p in self.pools.values())
                    if still_empty:
                        self._linger_thread = None
                        return

    # --------------------------------------------------------------- get --
    def split_refs(self, refs):
        """Partition refs into (owned_here, foreign) for the get path."""
        owned, foreign = [], []
        with self.lock:
            for r in refs:
                st = self.owned.get(r.id())
                if st is not None and st.status != DELEGATED:
                    owned.append(r)
                else:
                    foreign.append(r)
        return owned, foreign

    def wait_owned(self, oids: List[ObjectID], timeout=None) -> bool:
        """Block until every owned oid is READY/ERRORED (DELEGATED counts
        as terminal here — the caller re-routes those to the head).
        Returns False on timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self.lock:
            while True:
                pending = [o for o in oids
                           if (st := self.owned.get(o)) is not None
                           and st.status == PENDING]
                if not pending:
                    return True
                if deadline is not None:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        return False
                    self.cv.wait(left)
                else:
                    self.cv.wait()

    def wait_owned_n(self, oids: List[ObjectID], num_returns: int,
                     timeout) -> Tuple[List[bytes], List[bytes]]:
        """ray.wait over owned refs: block until ``num_returns`` are
        READY/ERRORED (or timeout / a ref gets delegated to the head).
        Returns (ready_bins capped at num_returns, delegated_bins) — the
        caller re-routes delegated ones to the head's wait."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self.lock:
            while True:
                ready, delegated = [], []
                for o in oids:
                    st = self.owned.get(o)
                    if st is None or st.status in (READY, ERRORED):
                        ready.append(o.binary())
                    elif st.status == DELEGATED:
                        delegated.append(o.binary())
                if len(ready) >= num_returns or delegated:
                    return ready[:num_returns], delegated
                if deadline is not None:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        return ready, delegated
                    self.cv.wait(left)
                else:
                    self.cv.wait()

    def descr_of(self, oid: ObjectID):
        with self.lock:
            st = self.owned.get(oid)
            if st is None:
                raise exc.ObjectFreedError(
                    object_id=oid.hex(),
                    owner=getattr(self.host, "worker_id_hex", None),
                    phase="get")
            if st.status == PENDING:
                raise exc.GetTimeoutError(f"Object {oid.hex()} not ready")
            return st.descr, st

    def status_of(self, oid: ObjectID) -> Optional[int]:
        with self.lock:
            st = self.owned.get(oid)
            return None if st is None else st.status

    # -------------------------------------------------------- recovery --
    def _lost_object_hex(self, descr) -> Optional[str]:
        """If an ERROR descriptor wraps a RECONSTRUCTABLE lost-object
        failure (directly, or as a TaskError's cause — the shape an
        executor's failed arg fetch produces), the lost object's id hex.
        Keys off the structured error fields, never message text."""
        if descr is None or descr[0] != protocol.ERROR:
            return None
        try:
            err = serialization.loads_inline(descr[1])
        except Exception:
            return None
        for e in (err, getattr(err, "cause", None)):
            if isinstance(e, exc.ObjectLostError):
                return e.object_id if e.reconstructable else None
        return None

    def reconstruct(self, oid: ObjectID, _visited=None) -> bool:
        """Rebuild a lost OWNED object by re-executing its producer from
        this caller's lineage (reference:
        ObjectRecoveryManager::RecoverObject — run by the owner, which
        is this process for direct-submitted tasks).  Covers both loss
        shapes: a READY object whose segment died with its node, and an
        ERRORED object whose producer failed fetching a lost argument —
        the argument reconstructs first (recursively, cycle-safe via
        ``_visited``), then the producer re-runs.  Bounded by the
        lineage entry's max_retries budget; returns True when the
        object is READY again (blocked getters already woke through the
        ownership cv)."""
        if self.lineage is None:
            return False
        visited = set() if _visited is None else _visited
        prefix = oid.binary()[:12]
        if prefix in visited:
            return False  # cycle guard: never re-enter a producer
        visited.add(prefix)
        entry = self.lineage.get(prefix)
        if entry is None:
            with self.lock:
                self.reconstruction_failures += 1
            return False
        spec = entry["spec"]
        for _attempt in range(2):
            with self.lock:
                st = self.owned.get(oid)
                if st is None or st.status == DELEGATED:
                    return False  # freed, or the head owns it now
                pending = st.status == PENDING
                err_descr = (st.descr if st.status == ERRORED else None)
            dep_hex = self._lost_object_hex(err_descr)  # loads: no lock
            if dep_hex:
                dep = ObjectID(bytes.fromhex(dep_hex))
                with self.lock:
                    dep_ours = dep in self.owned
                if dep_ours and dep.binary()[:12] != prefix \
                        and not self.reconstruct(dep, visited):
                    break
            if not pending:
                if not self.lineage.note_attempt(prefix):
                    break  # depleted retries: the loss stands
                self._resubmit_spec(spec)
            if not self.wait_owned([oid], timeout=60.0):
                break
            with self.lock:
                st = self.owned.get(oid)
                if st is not None and st.status == READY:
                    return True
            # ERRORED again: loop once — this attempt may have exposed
            # a lost dependency the next pass can rebuild first.
        with self.lock:
            self.reconstruction_failures += 1
        return False

    def _resubmit_spec(self, spec: dict):
        """Queue the producer again over the SAME task/object ids: the
        owned return states flip back to PENDING (their existing refs
        and waiters carry over — unlike submit_many, NO local_refs are
        added) and the spec rides the normal push path, transparently
        re-homing the results."""
        tid = TaskID(spec["task_id"])
        klass = self._sched_class(spec)
        with self.lock:
            for i in range(spec["num_returns"]):
                rst = self.owned.get(tid.object_id(i))
                if rst is not None and rst.status != DELEGATED:
                    rst.status = PENDING
                    rst.descr = None
                    rst.attached = False
                    rst.shipped = False
                    rst.creator = None
            self.reconstructions += 1
            entry = {"spec": spec, "rid": None, "retries": 0, "deps": 0,
                     "tid_bin": spec["task_id"], "pinned": ()}
            self._pool_locked(klass)["queue"].append(entry)
        self._pump(klass)

    # ------------------------------------------------------------- spill --
    def spill_owned(self, need_bytes: int, spill_dir: str) -> int:
        """Move this worker's unpinned owned resident objects to disk
        until ``need_bytes`` of shm is freed (per-node spilling;
        reference: LocalObjectManager::SpillObjects,
        local_object_manager.h:41 — the v1 design spilled only on the
        head node, so a remote node under pressure just died).  DELEGATED
        entries notify the head of the descriptor flip."""
        victims = []
        with self.lock:
            total = 0
            for oid, st in self.owned.items():
                if (st.descr is not None and st.descr[0] == protocol.SHM
                        and len(st.descr) > 3
                        and st.descr[3] == self.host.store_id
                        and st.creator is None
                        and st.status in (READY, DELEGATED)
                        and st.pins == 0 and not st.attached
                        and not st.shipped):
                    victims.append((oid, st))
                    total += st.descr[2]
                    if total >= need_bytes:
                        break
            for _oid, st in victims:
                st.pins += 1  # survive concurrent frees while copying
        freed = 0
        updates = []
        for oid, st in victims:
            name, size = st.descr[1], st.descr[2]
            try:
                path = self.host.shm.spill(name, size, spill_dir)
            except OSError:
                path = None
            with self.lock:
                st.pins -= 1
                if path is not None:
                    st.descr = (protocol.SPILLED, path, size,
                                self.host.store_id)
                    freed += size
                    if st.status == DELEGATED:
                        updates.append((oid.binary(), st.descr))
                self._maybe_free_locked(oid, st)
        if updates:
            try:
                self.host.head_send(("descr_update", updates))
            except Exception:
                pass
        self._flush_outbound()
        return freed

    # ------------------------------------------------------------ export --
    def export_refs(self, oid_bins) -> None:
        """Make owned objects visible to the head (one-way delegation):
        used when a spec/put carrying them goes through the head path, or
        when a return value embeds them.  The head entry starts with one
        aggregate ref standing for ALL of this process's local refs; the
        final local decref forwards to the head.  Transitive: nested owned
        refs inside an exported container export too (their local pins
        transfer to the head's nested-pin bookkeeping)."""
        batch = []
        unpin_after = []
        with self.lock:
            work = list(oid_bins)
            while work:
                b = work.pop()
                oid = ObjectID(b)
                st = self.owned.get(oid)
                if st is None or st.status == DELEGATED:
                    continue
                if st.status == PENDING:
                    # Export the shell now; _on_result_batch follows up with
                    # ("export_complete", ...).
                    batch.append((b, None, None, [], None))
                    st.status = DELEGATED
                    self._pending_exports.add(b)
                else:
                    inner = list(st.nested_local)
                    batch.append((b, st.status == READY, st.descr,
                                  inner + list(st.nested_head),
                                  (st.creator.worker_id
                                   if st.creator is not None else None)))
                    st.status = DELEGATED
                    # The head now pins nested on this entry's behalf;
                    # release our local pins (after the export message is
                    # on the wire) and export the inner refs too.
                    work.extend(inner)
                    unpin_after.append((st, inner))
                    st.nested_local = []
                    st.nested_head = []
        if not batch:
            return
        try:
            self.host.head_send(("export_obj", batch))
        except Exception:
            return
        with self.lock:
            for _st, inner in unpin_after:
                for b in inner:
                    ist = self.owned.get(ObjectID(b))
                    if ist is not None:
                        ist.pins -= 1
                        self._maybe_free_locked(ObjectID(b), ist)
        self._flush_outbound()

    def held_lease_ids(self) -> List[str]:
        """Worker ids of every live lease this process HOLDS — re-
        advertised at re-register so a restarted head can re-bind the
        lease table rows that survived it (the pushes themselves never
        touched the head)."""
        with self.lock:
            return sorted({lease.worker_id
                           for pool in self.pools.values()
                           for lease in pool["leases"]
                           if not lease.dead})

    def reregister_exports(self) -> List[tuple]:
        """Entries this owner DELEGATED to the (now restarted) head:
        (oid_bin, ok, descr, nested) rows re-advertised at re-register
        so head-routed consumers of our objects keep resolving.  PENDING
        shells are skipped — their export_complete rides the parked
        outbox replay."""
        out = []
        with self.lock:
            for oid, st in self.owned.items():
                if st.status != DELEGATED or st.descr is None:
                    continue
                out.append((oid.binary(),
                            st.descr[0] != protocol.ERROR,
                            st.descr, []))
        return out

    def shutdown(self):
        self._stopped = True
        self._send_event.set()  # unblock the push sender's exit
        with self.lock:
            leases = [l for p in self.pools.values() for l in p["leases"]]
        for lease in leases:
            try:
                if lease.conn is not None:
                    lease.conn.close()
            except Exception:
                pass


class DirectServer:
    """Executor half: accept direct connections from peer callers and feed
    their tasks into the worker's execution queue (reference: the core
    worker's task-receiver gRPC service, core_worker.cc HandlePushTask)."""

    def __init__(self, authkey: bytes, enqueue: Callable[[dict, Any], None],
                 register_func: Callable[[str, bytes], None],
                 shm_unlink: Callable[[str, int, bool], None],
                 on_peer_msg: Optional[Callable] = None,
                 queue_empty: Optional[Callable[[], bool]] = None,
                 on_task_queued: Optional[Callable[[dict], None]] = None,
                 queue_depth: Optional[Callable[[], int]] = None,
                 spill_depth: int = 0,
                 spill_info: Optional[dict] = None):
        from multiprocessing.connection import Listener

        host = os.environ.get("RAY_TPU_AGENT_LISTEN_HOST", "127.0.0.1")
        self._listener = Listener((host, 0), "AF_INET", backlog=128,
                                  authkey=authkey)
        adv = os.environ.get("RAY_TPU_AGENT_ADVERTISE_HOST")
        if adv is None:
            adv = host
            if adv == "0.0.0.0":
                import socket

                adv = socket.gethostbyname(socket.gethostname())
        self.address = (adv, self._listener.address[1])
        self._enqueue = enqueue
        self._register_func = register_func
        self._shm_unlink = shm_unlink
        self._on_peer_msg = on_peer_msg
        self._queue_empty = queue_empty or (lambda: True)
        # Called with each pushed task BEFORE it is enqueued — the
        # worker's argument prefetcher hook: a dexec_batch burst's tasks
        # 2..N land behind task 1 and start pulling their remote args
        # while it computes (direct-path submissions carry the same
        # (size, store) SHM descriptors the head path does).
        self._on_task_queued = on_task_queued
        # Spillback (reference: the raylet hybrid policy bouncing work
        # off an oversubscribed node): a pushed task that opted in
        # (``_spill_ok``, the capability gate) arriving while the local
        # queue is at least spill_depth deep is answered with
        # ("dspill", rid, spill_info) instead of queueing; the holder
        # re-lands it on another lease or the hinted node.  spill_depth
        # 0 disables.
        self._queue_depth = queue_depth or (lambda: 0)
        self._spill_depth = spill_depth
        self._spill_info = spill_info or {}
        # Live reply channels: the worker's exec loop flushes buffered
        # replies on queue drain; the periodic flusher bounds latency.
        self._sources: set = set()
        self._sources_lock = threading.Lock()
        self._stopped = False
        threading.Thread(target=self._accept_loop, daemon=True,
                         name="ray_tpu_torch-direct-accept").start()

    def flush_replies(self):
        with self._sources_lock:
            sources = list(self._sources)
        for src in sources:
            src.flush()

    def _accept_loop(self):
        while not self._stopped:
            try:
                conn = self._listener.accept()
                protocol.enable_nodelay(conn)
            except Exception:
                if self._stopped:
                    return
                continue
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True, name="ray_tpu_torch-direct-rx").start()

    def _serve_conn(self, conn):
        src = _DirectSource(conn, self._queue_empty)
        with self._sources_lock:
            self._sources.add(src)
        try:
            self._serve_conn_inner(conn, src)
        finally:
            with self._sources_lock:
                self._sources.discard(src)

    def _serve_conn_inner(self, conn, src):
        while not self._stopped:
            try:
                msg = protocol.recv(conn)
            except (EOFError, OSError, TypeError):
                try:
                    conn.close()
                except Exception:
                    pass
                return
            if protocol.is_batch(msg):
                for m in msg[1]:
                    self._handle_direct_msg(m, src)
            else:
                self._handle_direct_msg(msg, src)

    def _should_spill(self, task: dict) -> bool:
        # queue_depth is live: the enqueue callback appends synchronously,
        # so tasks accepted earlier in this same batch already count.
        return (self._spill_depth > 0
                and task.get("_spill_ok")
                and "actor_id" not in task
                and self._queue_depth() >= self._spill_depth)

    def _handle_direct_msg(self, msg, src):
        tag = msg[0]
        if tag == "dexec":
            task = msg[2]
            if self._should_spill(task):
                src.spill(msg[1], self._spill_info)
                return
            task["_dreply"] = (src, msg[1])
            src.note_enqueued(1)
            if self._on_task_queued is not None:
                self._on_task_queued(task)
            self._enqueue(task, src)
        elif tag == "dexec_batch":
            for rid, task in msg[1]:
                if self._should_spill(task):
                    src.spill(rid, self._spill_info)
                    continue
                task["_dreply"] = (src, rid)
                src.note_enqueued(1)
                if self._on_task_queued is not None:
                    self._on_task_queued(task)
                self._enqueue(task, src)
        elif tag == "dping":
            # Channel-liveness probe: answer from THIS connection's
            # thread immediately (never buffered behind result batches
            # — the probe exists to distinguish a long task from a
            # stalled link).
            src.pong(msg[1])
        elif tag == "dfunc":
            self._register_func(msg[1], msg[2])
        elif tag == "dfree":
            try:
                self._shm_unlink(msg[1], msg[2], msg[3])
            except Exception:
                pass
        elif tag == "dmsg":
            # Generic peer-to-peer message (host-tier ring
            # collectives ride this; reference: the Gloo transport's
            # peer channels).  (channel, payload) dispatched to the
            # process-local handler registry.
            if self._on_peer_msg is not None:
                try:
                    self._on_peer_msg(msg[1], msg[2])
                except Exception:
                    import traceback

                    traceback.print_exc()

    def close(self):
        self._stopped = True
        try:
            self._listener.close()
        except Exception:
            pass


class _DirectSource:
    """Reply channel for one inbound direct connection.  Replies buffer
    while more tasks are queued behind the current one and ride out as one
    ``dresult_batch`` (mirrors the head-conn ``result_batch`` path) — the
    worker's exec loop flushes on queue drain and the periodic flusher
    bounds worst-case latency."""

    __slots__ = ("conn", "send_lock", "pending", "_queue_empty", "_queued")

    _FLUSH_AT = 16

    def __init__(self, conn, queue_empty=None):
        self.conn = conn
        self.send_lock = threading.Lock()  # lock-order: io-guard
        self.pending: List[tuple] = []
        self._queue_empty = queue_empty or (lambda: True)
        self._queued = 0  # THIS caller's tasks still unanswered

    def note_enqueued(self, n: int):
        with self.send_lock:
            self._queued += n

    def spill(self, rid, info):
        """Bounce one push back to the holder immediately (spillback is
        a flow-control signal — buffering it behind result batches would
        defeat the point)."""
        try:
            with self.send_lock:
                protocol.send(self.conn, ("dspill", rid, dict(info)))
        except Exception:
            pass  # caller went away; its death handling cleans up

    def pong(self, rid):
        """Immediate liveness reply (failure detection) — same
        flow-control exemption as spill()."""
        try:
            with self.send_lock:
                protocol.send(self.conn, ("dpong", rid))
        except Exception:
            pass  # caller went away; its death handling cleans up

    def reply(self, rid, ok, returns, meta):
        with self.send_lock:
            self.pending.append((rid, ok, returns, meta))
            self._queued -= 1
            n = len(self.pending)
            drained = self._queued <= 0
        # Flush on the CALLER's burst boundary, not the worker's global
        # queue: another client's pipelined backlog must not hold a sync
        # caller's lone reply hostage until the periodic flusher.
        if n >= self._FLUSH_AT or drained or self._queue_empty():
            self.flush()

    def flush(self):
        try:
            with self.send_lock:
                if not self.pending:
                    return
                buf, self.pending = self.pending, []
                if len(buf) == 1:
                    protocol.send(self.conn, ("dresult",) + buf[0])
                else:
                    protocol.send(self.conn, ("dresult_batch", buf))
        except Exception:
            pass  # caller went away; its death handling cleans up
