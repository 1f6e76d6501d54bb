"""Driver-resident runtime: object table, scheduler, worker pools, control plane.

This file is the TPU-native condensation of four reference components:

- GCS tables (actors, KV, nodes, placement groups) —
  ``src/ray/gcs/gcs_server/gcs_server.h:77`` and friends.  On a TPU pod the
  control plane is tiny relative to the data plane, so v1 keeps it as
  in-process tables with locks instead of a separate server process; the
  message surface (register/lookup/kv) matches so it can move out-of-process
  for multi-host (see node.py).
- Scheduling — ``src/ray/raylet/scheduling/cluster_task_manager.h:42`` +
  ``local_task_manager.h:58``.  We keep the reference's semantics (resource
  admission, queueing, spillback across nodes, placement-group bundle
  reservation 2-phase style) with a single scheduler since one driver owns
  submission in v1.
- Ownership + reference counting — ``src/ray/core_worker/reference_count.h:61``
  and ``task_manager.h:90`` (retries, error objects).  The driver owns every
  object; local refs, worker refs, and in-flight pins are counted here and
  the object (incl. its shm segment) is freed at zero.
- Worker pool — ``src/ray/raylet/worker_pool.h:156`` (spawn, cache by env,
  dedicated TPU workers, idle reaping).
"""

from __future__ import annotations

import atexit
import itertools
import multiprocessing
import multiprocessing.connection
import os
import sys
import threading
import time
import weakref
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Tuple

from ray_tpu_torch._private import object_transfer, protocol, recovery, \
    serialization
from ray_tpu_torch._private.config import Config
from ray_tpu_torch._private.ids import (
    ActorID,
    JobID,
    NodeID,
    ObjectID,
    PlacementGroupID,
    TaskID,
    WorkerID,
    new_task_id,
)
from ray_tpu_torch._private.shm_store import ShmStore
from ray_tpu_torch import exceptions as exc

PENDING, READY, ERRORED = 0, 1, 2


class ObjectState:
    __slots__ = (
        "status", "descr", "local_refs", "worker_refs", "pins",
        "futures", "waiters", "task_id", "value", "has_value", "segment",
        "nested_ids", "shipped", "creator", "exporter",
    )

    def __init__(self, task_id: Optional[TaskID] = None):
        self.status = PENDING
        self.descr = None
        self.local_refs = 0
        self.worker_refs = 0
        self.pins = 0
        self.futures: List[Future] = []
        self.waiters: List[Callable] = []  # called with (oid,) on completion
        self.task_id = task_id
        self.value = None
        self.has_value = False
        self.segment = None
        # WorkerHandle whose process created this object's shm segment (None
        # when the driver did).  Frees are routed back to the creator so its
        # store can pool the pages for in-place reuse.
        self.creator = None
        # True once this object's descriptor left the process (a worker may
        # hold zero-copy views over the segment) or was mapped locally —
        # such segments must not be pooled for in-place reuse.
        self.shipped = False
        # ObjectIDs (binary) of refs pickled inside this object's value;
        # pinned until this object is freed.
        self.nested_ids: List[bytes] = []
        # WorkerHandle that exported this entry as a PENDING shell and
        # owes an export_complete; its death fails the object (owner
        # death semantics, reference: OwnerDiedError).
        self.exporter = None

    def refcount(self):
        return self.local_refs + self.worker_refs + self.pins


class TaskRecord:
    __slots__ = (
        "spec", "requirements", "deps_pending", "retries_left", "node",
        "worker", "dispatched", "cancelled", "is_actor_creation", "actor_id",
        "pg_id", "bundle_index", "sched_key", "locality_homes",
        "app_retries_left",
    )

    def __init__(self, spec, requirements, retries_left):
        self.spec = spec
        self.requirements = requirements
        self.deps_pending = 0
        # Two independent budgets, both seeded from max_retries:
        # retries_left pays for SYSTEM failures (worker/node death —
        # decremented in the death paths), app_retries_left for the
        # retry_exceptions= opt-in application-error retries.  An app
        # error must never burn a system-retry slot (and vice versa) —
        # pinned by the retry-counting test.
        self.retries_left = retries_left
        self.app_retries_left = retries_left
        self.node = None
        self.worker = None
        self.dispatched = False
        self.cancelled = False
        self.is_actor_creation = False
        self.actor_id: Optional[bytes] = None
        self.pg_id: Optional[PlacementGroupID] = None
        self.bundle_index: Optional[int] = None
        # Scheduling-class tuple, computed once at first enqueue (the
        # spec's strategy/env/requirements never change afterwards) so
        # re-enqueues, cancels and dispatch scans are dict ops only.
        # Locality NEVER folds into this key — it would shatter lease
        # reuse; locality is resolved at pick time per record.
        self.sched_key: Optional[tuple] = None
        # Lazily-scanned {store_id: argument bytes homed there} for
        # locality-aware placement; scanned once at first pick (deps are
        # READY by then, so descriptors are known and pinned).
        self.locality_homes: Optional[Dict[str, int]] = None


ALIVE, RESTARTING, DEAD = "ALIVE", "RESTARTING", "DEAD"


def _apply_strategy(rec: "TaskRecord", spec: dict):
    strategy = spec.get("scheduling_strategy")
    if strategy and strategy[0] == "placement_group":
        rec.pg_id = strategy[1]
        rec.bundle_index = strategy[2]


class ActorState:
    """FSM mirrors the reference's GcsActorManager diagram
    (src/ray/gcs/gcs_server/gcs_actor_manager.h:243-281):
    PENDING_CREATION -> ALIVE -> (RESTARTING ->)* DEAD."""

    __slots__ = (
        "actor_id", "name", "namespace", "cls_payload", "func_id",
        "init_args", "init_kwargs", "options", "worker", "node", "status",
        "restarts_left", "queue", "inflight", "created_future",
        "death_cause", "handle_count", "max_concurrency", "checkpoint",
    )

    def __init__(self, actor_id):
        self.actor_id = actor_id
        self.name = None
        self.namespace = "default"
        self.cls_payload = None
        self.func_id = None
        self.init_args = None
        self.init_kwargs = None
        self.options = {}
        self.worker = None
        self.node = None
        self.status = "PENDING"
        self.restarts_left = 0
        self.queue: deque = deque()  # TaskRecords not yet dispatched
        self.inflight: Dict[bytes, TaskRecord] = {}
        self.created_future = Future()
        self.death_cause = None
        self.handle_count = 0
        self.max_concurrency = 1
        # Latest __ray_save__ state descriptor (restartable actors): the
        # restart's create_actor carries it so __ray_restore__ can run.
        self.checkpoint = None


def _cuda_visible_devices(chips) -> str:
    """``CUDA_VISIBLE_DEVICES`` for a worker granted ``chips`` (indices
    into this process's accelerator pool): each index names the card at
    that place in our own ``CUDA_VISIBLE_DEVICES`` when it is set, else
    the card of that index; no chips -> ``""`` (no card at all)."""
    mine = os.environ.get("CUDA_VISIBLE_DEVICES")
    ids = [t.strip() for t in mine.split(",")] if mine else []
    return ",".join(ids[c] if c < len(ids) else str(c)
                    for c in map(int, chips or ()))


class WorkerHandle:
    __slots__ = (
        "worker_id", "conn", "proc", "node", "send_lock", "env_key",
        "inflight", "actor_id", "tpu_chips", "idle_since", "released",
        "ready", "dead", "outbox", "outbuf", "spawned_at",
        "lease_key", "lease_req", "lease_pg", "blocked",
        "pending_force_kill", "direct_addr", "client_lease",
        "oom_killed", "last_dispatch_ts", "lease_expiry",
        "lease_offer_ts", "lease_caps", "last_seen", "hc_suspect",
        "hc_misses", "hc_probe_ts",
    )

    def __init__(self, worker_id, conn, proc, node, env_key, tpu_chips):
        self.worker_id = worker_id
        self.conn = conn  # None until the worker dials back (accept thread)
        self.proc = proc  # subprocess.Popen
        self.node = node
        self.send_lock = threading.Lock()  # lock-order: io-guard
        self.env_key = env_key
        # Tasks pushed to this worker and not yet resulted, in send order
        # (the worker executes its queue FIFO).  Reference: task pipelining
        # onto leased workers, direct_task_transport.h:75.
        self.inflight: Dict[bytes, TaskRecord] = {}
        self.actor_id: Optional[bytes] = None
        self.tpu_chips = tpu_chips or []
        self.idle_since = time.monotonic()
        self.released = False  # resources released while blocked in get
        self.blocked = False    # inside ray.get: no new pipelined tasks
        self.ready = threading.Event()
        self.dead = False
        self.outbox: List[tuple] = []
        self.outbuf: List[tuple] = []  # conflation-sender batch buffer
        self.spawned_at = time.monotonic()
        # Lease state: while leased, the worker holds lease_req resources on
        # its node (or lease_pg's bundle) and serves one scheduling class.
        self.lease_key: Optional[tuple] = None
        self.lease_req: Optional[Dict[str, float]] = None
        self.lease_pg: Optional[tuple] = None  # (pg_id, bundle_index)
        # Set by force-cancel: victim task id; the proc is terminated only
        # after a steal pass rescues the other pipelined tasks.
        self.pending_force_kill: Optional[bytes] = None
        # Direct-push endpoint (reported in the worker's "ready") and, when
        # leased to a peer caller, that caller's WorkerHandle (the head
        # only does resource accounting for such leases; tasks/results
        # bypass it entirely — direct_task_transport.cc:568).
        self.direct_addr = None
        self.client_lease: Optional["WorkerHandle"] = None
        # Memory-monitor bookkeeping: oom_killed types the death error;
        # last_dispatch_ts picks the NEWEST task's worker as the victim.
        self.oom_killed = False
        self.last_dispatch_ts = 0.0
        # Decentralized dispatch: while client-leased, the holder must
        # renew before this monotonic deadline or the reaper revokes the
        # lease (None = no TTL: legacy holder or TTL disabled).  On a
        # LESSEE handle, lease_offer_ts holds per-scheduling-class
        # [last_offer_ts, eligible_specs_accumulated] pairs that
        # rate-limit and threshold unsolicited bulk grants.
        self.lease_expiry: Optional[float] = None
        self.lease_offer_ts: Dict[tuple, list] = {}
        # Capability gate for UNSOLICITED lease grants (PR-3 convention:
        # never send a new verb to a peer that would silently drop it —
        # here the drop would leak the acquired leases).  True for
        # workers this head spawned (same build, env-matched); an
        # external client earns it by sending a v1 lease_req.
        self.lease_caps = False
        # Failure detection: last message seen from this worker
        # (stamped by the reader wrapper, re-seeded with the initial
        # delay at attach) + the suspicion machine's state.
        self.last_seen = time.monotonic()
        self.hc_suspect = False
        self.hc_misses = 0
        self.hc_probe_ts = 0.0

    def send(self, msg):
        with self.send_lock:
            if self.conn is None:
                self.outbox.append(msg)
            else:
                protocol.send(self.conn, msg)

    def queue_msg(self, msg):
        """Buffer a task-path message for the conflation sender: while
        one flush's pickle+write syscall runs, later dispatches pile into
        the next batch — self-clocking batching with no added latency
        floor (reference: gRPC stream write coalescing)."""
        with self.send_lock:
            self.outbuf.append(msg)

    def flush_buffered(self):
        with self.send_lock:
            if not self.outbuf:
                return
            msgs, self.outbuf = self.outbuf, []
            payload = protocol.make_batch(msgs)
            if self.conn is None:
                self.outbox.append(payload)
            else:
                try:
                    protocol.send(self.conn, payload)
                except BaseException:
                    # Failed delivery is how worker death is usually
                    # discovered: put the batch back (send_lock is held,
                    # so order is preserved) so the death path can
                    # reroute buffered free_segment messages to their
                    # store-side fallback instead of leaking segments.
                    self.outbuf[:0] = msgs
                    raise

    def attach(self, conn):
        with self.send_lock:
            self.conn = conn
            for msg in self.outbox:
                protocol.send(conn, msg)  # noqa: RTL604 -- re-register attaches under the lock by design: the ack must beat any locked send onto this conn; outbox is bounded by the blip window
            self.outbox.clear()


class AgentHandle:
    """Head-side proxy for one node agent daemon (reference: the GCS's
    per-raylet NodeManager client, gcs_node_manager.h:41)."""

    def __init__(self, conn, store_id: str, shm_dir: str, info: dict):
        self.conn = conn
        self.store_id = store_id
        self.shm_dir = shm_dir
        self.info = info
        self.send_lock = threading.Lock()  # lock-order: io-guard
        self.node: Optional["NodeState"] = None
        self.dead = False
        self._rid = 0
        self._pending: Dict[int, Future] = {}
        self._pending_lock = threading.Lock()
        # Failure detection: last message from this agent (heartbeats
        # are the floor) + suspicion state (SUSPECT -> probe -> DEAD).
        self.last_seen = time.monotonic()
        self.hc_suspect = False
        self.hc_misses = 0
        self.hc_probe_ts = 0.0

    def send(self, msg):
        with self.send_lock:
            protocol.send(self.conn, msg)

    def request_segment(self, name: str, timeout: float = 30.0):
        """Blocking HEAD-RELAYED read of a remote segment's serialized
        parts — the fallback when a direct object-server pull is not
        possible.  Must be called WITHOUT the runtime lock held.  The
        deadline makes a stalled agent a structured, reconstructable
        loss (phase="stalled") instead of a 30s-or-forever hang."""
        with self._pending_lock:
            self._rid += 1
            rid = self._rid
            fut = self._pending[rid] = Future()
        self.send(("read_segment", rid, name))
        try:
            ok, payload = fut.result(timeout=timeout)
        except Exception as e:  # concurrent.futures.TimeoutError
            with self._pending_lock:
                self._pending.pop(rid, None)
            protocol.note_net_event("stall_timeouts")
            raise exc.ObjectLostError(
                f"relay read of {name} from {self.store_id} stalled "
                f"past {timeout}s",
                object_id=_seg_oid_hex(name), home=self.store_id,
                phase="stalled") from e
        if not ok:
            raise exc.ObjectLostError(object_id=_seg_oid_hex(name),
                                      home=self.store_id, phase="relay")
        return payload  # (meta, [bytes...])

    def deliver(self, rid, ok, payload):
        with self._pending_lock:
            fut = self._pending.pop(rid, None)
        if fut is not None:
            fut.set_result((ok, payload))

    def fail_all(self, err):
        with self._pending_lock:
            pending, self._pending = self._pending, {}
        for fut in pending.values():
            if not fut.done():
                fut.set_result((False, repr(err)))


class NodeState:
    """One schedulable node.  In-process multi-node (the cluster_utils.Cluster
    pattern, reference python/ray/cluster_utils.py:99) gives several NodeStates
    on one host — the scheduler can't tell the difference, which is exactly
    how the reference tests multi-node logic on one machine."""

    __slots__ = (
        "node_id", "resources", "available", "labels", "idle_workers",
        "all_workers", "tpu_free", "alive", "agent", "store_id",
        "draining",
    )

    def __init__(self, node_id, resources, labels=None, agent=None,
                 store_id=""):
        self.node_id = node_id
        self.resources = dict(resources)
        self.available = dict(resources)
        self.labels = labels or {}
        self.idle_workers: Dict[str, List[WorkerHandle]] = {}
        self.all_workers: Dict[int, WorkerHandle] = {}
        self.tpu_free: List[int] = list(range(int(resources.get("TPU", 0))))
        self.alive = True
        # Out-of-process nodes (real multi-host) have a per-node agent
        # daemon (the raylet analog, _private/node_agent.py) and their own
        # object store; in-process test nodes share the head's store.
        self.agent: Optional["AgentHandle"] = agent
        self.store_id = store_id
        # Drain in progress (elastic pods): the node is on its way out —
        # no new placements of any kind (can_fit refuses), existing work
        # finishes or is stolen/revoked (reference: the raylet's drain
        # state under the GCS DrainNode RPC).
        self.draining = False

    def can_fit(self, req: Dict[str, float]) -> bool:
        if self.draining:
            return False
        return all(self.available.get(k, 0.0) >= v - 1e-9
                   for k, v in req.items())

    def feasible(self, req: Dict[str, float]) -> bool:
        return all(self.resources.get(k, 0.0) >= v - 1e-9
                   for k, v in req.items())

    def acquire(self, req: Dict[str, float]):
        for k, v in req.items():
            self.available[k] = self.available.get(k, 0.0) - v

    def release(self, req: Dict[str, float]):
        for k, v in req.items():
            self.available[k] = self.available.get(k, 0.0) + v


class PlacementGroupState:
    __slots__ = ("pg_id", "bundles", "strategy", "name", "reserved",
                 "created_future", "removed", "used")

    def __init__(self, pg_id, bundles, strategy, name):
        self.pg_id = pg_id
        self.bundles = bundles  # list of resource dicts
        self.strategy = strategy
        self.name = name
        self.reserved: List[Optional[NodeID]] = [None] * len(bundles)
        self.created_future = Future()
        self.removed = False
        # Per-bundle resources currently consumed by running tasks/actors —
        # the shadow-resource accounting of the reference
        # (placement_group_resource_manager.cc CPU_group_<pgid> resources).
        self.used: List[Dict[str, float]] = [dict() for _ in bundles]


def worker_send_safe(worker: "WorkerHandle", msg):
    try:
        worker.send(msg)
    except Exception:
        pass  # requester died; its death path cleans up


# Every loss error carries the structured object_id field even at sites
# that only see the segment (one naming-rule implementation, recovery.py).
_seg_oid_hex = recovery.seg_oid_hex


class Runtime:
    """The driver's runtime.  Public API (api.py) and ObjectRef route here."""

    def __init__(self, config: Config, num_cpus=None, num_tpus=None,
                 resources=None, job_name="default"):
        self.config = config
        # Failover restore peek: the snapshot is read EARLY (before the
        # store/listeners exist) because a restarted head must ADOPT the
        # dead head's session id — shm segment names are
        # ``rtpu-<session>-<oid>`` and the worker rendezvous socket dir
        # is keyed by session, so a fresh session id would orphan every
        # surviving segment and strand reconnecting head-local workers.
        self._restore_data = None
        if config.gcs_restore and config.gcs_snapshot_path \
                and os.path.exists(config.gcs_snapshot_path):
            self._restore_data = self._load_snapshot(
                config.gcs_snapshot_path)
        self.session_id = ((self._restore_data or {}).get("session_id")
                          or os.urandom(4).hex())
        self.job_id = JobID.from_random()
        self.job_name = job_name
        self.lock = threading.RLock()
        self._tls = threading.local()
        self.shm = ShmStore(config.shm_dir, config.object_store_memory,
                            self.session_id,
                            pool_bytes=config.shm_pool_bytes)

        self.objects: Dict[ObjectID, ObjectState] = {}
        self.tasks: Dict[bytes, TaskRecord] = {}
        self.actors: Dict[bytes, ActorState] = {}
        self.named_actors: Dict[Tuple[str, str], bytes] = {}
        self.placement_groups: Dict[bytes, PlacementGroupState] = {}
        self.pending_pgs: deque = deque()
        self.kv: Dict[str, Dict[bytes, bytes]] = {}
        self.nodes: Dict[NodeID, NodeState] = {}
        self.node_order: List[NodeID] = []
        # Resource-waiting TaskRecords, bucketed by scheduling class
        # (resource shape + strategy) so dispatch is O(#classes), not
        # O(#queued): scanning a class stops at its first unplaceable
        # head — same-shaped tasks behind it cannot place either.
        # (Reference: per-SchedulingKey lease queues in
        # direct_task_transport.h:75 / scheduling classes.)
        self.pending_tasks: Dict[tuple, deque] = {}
        # Workers currently holding a lease, by scheduling class — the
        # pipelining pool (reference: the submitter's per-SchedulingKey
        # worker leases, direct_task_transport.h:75).
        self.leased_workers: Dict[tuple, List[WorkerHandle]] = {}
        # Lineage: creating-task spec kept while any of its return objects
        # is alive, so a lost object can be rebuilt by re-execution
        # (reference: object_recovery_manager.h:41, task_manager.h:174
        # lineage pinning).  BOUNDED by lineage_bytes_budget — entries
        # evict oldest-first past it and recovery then refuses (its own
        # leaf _lock is pinned in tests/test_lockcheck.py).
        self.lineage = recovery.LineageTable(config.lineage_bytes_budget)
        self.functions: Dict[str, bytes] = {}
        self.worker_funcs: Dict[int, set] = {}  # conn fileno -> func_ids sent
        self.task_events: deque = deque(maxlen=200_000)
        self.events: Dict[str, deque] = {}  # topic -> payload bytes
        self._conn_to_worker: Dict[Any, WorkerHandle] = {}
        self._conn_to_agent: Dict[Any, AgentHandle] = {}
        self._agents: Dict[str, AgentHandle] = {}  # store_id -> handle
        self._pending_workers: Dict[str, WorkerHandle] = {}
        self._workers_by_hex: Dict[str, WorkerHandle] = {}
        # Direct chunked pulls from remote object servers (reference:
        # ObjectManager::Pull); the head-relay path remains as fallback
        # and counts its uses (tests assert it stays cold).
        self._puller = object_transfer.ObjectPuller(  # authkey set below
            b"", pool_size=config.object_pool_size,
            stripe_threshold=config.object_stripe_threshold,
            # Explicit net params: the head's _system_config overrides
            # must govern its own pulls, not the env-built
            # GLOBAL_CONFIG.
            net_config=object_transfer.net_params(config))
        self.relayed_segments = 0   # head-relayed agent reads (fallback)
        self.brokered_parts = 0     # worker getparts served via the head
        # Write-direction counters (all zero while direct_puts is off —
        # pinned by tests): direct_puts/direct_put_bytes = values that
        # reached this store over the data plane (the head saw only the
        # O(1) put_commit message); brokered_put_parts = legacy
        # whole-value put_parts messages assembled here while the direct
        # path was ON (old-verb clients, push failures, and mid-size
        # puts under the client's direct-put floor — a few MB, where
        # the fire-and-forget message beats three round trips).
        self.direct_puts = 0
        self.direct_put_bytes = 0
        self.brokered_put_parts = 0
        # Legacy put_parts assemblies run off the reader threads but
        # BOUNDED: past this many in flight the reader blocks before
        # spawning (TCP backpressure then throttles the bursting
        # client), so a legacy-put storm cannot pin unbounded buffer
        # memory in concurrent multi-hundred-MB memcpys.
        self._put_assembly_sem = threading.BoundedSemaphore(4)
        # Locality-aware placement counters (tentpole observability):
        # hits = tasks placed on their top-locality node, misses = a
        # preference existed but that node couldn't take the task,
        # bytes_saved = argument bytes that did NOT cross the network
        # because of a locality placement.
        self.locality_hits = 0
        self.locality_misses = 0
        self.locality_bytes_saved = 0
        # Worker-side data-plane counters, aggregated from periodic
        # ("xfer_stats", {...}) deltas: singleflight pull dedup and the
        # argument prefetcher's hit/waste bytes.
        self.deduped_pulls = 0
        self.prefetch_hit_bytes = 0
        self.prefetch_waste_bytes = 0
        # Decentralized-dispatch counters (all zero when the
        # decentralized_dispatch switch is off — pinned by tests):
        # lease_grants     = worker leases handed to peer holders
        #                    (solicited lease_req + unsolicited bulk
        #                    grants piggybacked on submit bursts),
        # lease_revocations= leases the head revoked (node/worker death,
        #                    TTL expiry),
        # head_brokered_submits = specs that reached the head's scheduler
        #                    over the wire (the path leases exist to
        #                    drain),
        # leased_submits / spillbacks = holder-side counters aggregated
        #                    from the periodic xfer_stats deltas.
        self.lease_grants = 0
        self.lease_revocations = 0
        self.head_brokered_submits = 0
        self.leased_submits = 0
        self.spillbacks = 0
        # Recovery counters (all zero while config.recovery is off —
        # pinned by tests): reconstructions = lost objects whose
        # producer was re-queued from lineage (head-side, plus
        # worker-side deltas via xfer_stats); reconstruction_failures =
        # losses recovery could not cover (no/evicted lineage, depleted
        # retries, non-reconstructable types); actor_restarts = actor
        # respawns after worker/node death; chaos_kills = faults the
        # chaos harness injected (ray_tpu_torch.chaos).
        self.reconstructions = 0
        self.reconstruction_failures = 0
        self.actor_restarts = 0
        self.chaos_kills = 0
        # Head-failover counters (all zero while head_failover is off or
        # no restart happened — pinned by tests): gcs_snapshots /
        # gcs_snapshot_failures count the persistence loop's writes;
        # reconnected_nodes = agents that re-dialed and re-claimed their
        # restored node; reregistered_workers = surviving worker/client
        # processes that re-registered across a head restart;
        # adopted_actors = restored actor incarnations re-claimed by
        # their surviving worker (state intact, no __init__ re-run).
        self.gcs_snapshots = 0
        self.gcs_snapshot_failures = 0
        self.reconnected_nodes = 0
        self.reregistered_workers = 0
        self.adopted_actors = 0
        # Elastic-pod counters (all zero while elastic_drain is off —
        # pinned by tests): preemptions = preempt_notice messages
        # received from agents (spot warning windows); drains_completed /
        # drain_timeouts = drain_node() outcomes (a timeout falls
        # through to hard-kill recovery); objects_migrated = sole-copy
        # objects pulled off a draining node and re-homed on the head's
        # surviving store; autoscaler_errors lives autoscaler-side
        # (StandardAutoscaler.stats()) next to these.
        self.preemptions = 0
        self.drains_completed = 0
        self.drain_timeouts = 0
        self.objects_migrated = 0
        # Failure-detection counters (all zero while failure_detection
        # is off — pinned by tests): suspected_nodes = peers (node
        # agents AND workers) the suspicion machine marked SUSPECT
        # after health_check_timeout_s of silence; stall_timeouts /
        # net_retries / hedged_fetches aggregate the deadline core's
        # process-wide counters from every worker/client (xfer_stats
        # deltas) plus this head process's own (merged at
        # transfer_stats time).
        self.suspected_nodes = 0
        self.stall_timeouts = 0
        self.net_retries = 0
        self.hedged_fetches = 0
        # Push-shuffle counters (all zero while push_shuffle is off —
        # pinned by tests): shuffle_pushed_bytes = partition bytes map
        # tasks pushed straight into reducer-node stores (never through
        # the head), shuffle_merges = k-way merge passes reducers ran
        # on arrival, shuffle_spills = partitions reserve_put degraded
        # to spill files under store pressure, shuffle_hedges = pushes
        # re-routed through a healthy store after a stalled/dead link
        # (worker deltas via xfer_stats, plus the driver coordinator's
        # own — merged at transfer_stats time).
        self.shuffle_pushed_bytes = 0
        self.shuffle_merges = 0
        self.shuffle_spills = 0
        self.shuffle_hedges = 0
        # Distributed-training counters (all zero while
        # distributed_training is off — pinned by tests):
        # microbatch_pushes = micro-batch activation/grad segments
        # pipeline stage actors pushed straight into their neighbor
        # stage's store (never through the head), stage_restarts =
        # pipeline stage actors restored from a __ray_save__ checkpoint
        # after a death, learner_queue_stalls = IMPALA learner waits on
        # an empty host->device batch queue (worker deltas via
        # xfer_stats, plus the driver-process trainer's own — merged at
        # transfer_stats time).
        self.microbatch_pushes = 0
        self.stage_restarts = 0
        self.learner_queue_stalls = 0
        # Drain rendezvous: aid -> Event set when the forced
        # ("checkpoint_now", aid) round-trips as an actor_checkpoint;
        # node_id -> [done_event, outcome, deadline_abs] for that
        # node's in-flight drain (a second drain_node call — scale-down
        # racing a preemption notice — waits the FIRST drain out past
        # its own deadline and returns its real outcome, instead of
        # failing into a hard kill mid-drain or mislabeling a timeout
        # as success).
        self._drain_ck_events: Dict[bytes, threading.Event] = {}
        self._node_drains: Dict[NodeID, list] = {}
        # Driver-side pubsub listeners: topic -> callbacks fired (outside
        # the lock) when a worker "event" lands — the serve controller's
        # scale events wake the autoscaler loop through this.
        self._event_listeners: Dict[str, List] = {}
        # Reconcile state for a restarted head: restored-but-unclaimed
        # nodes/actors/leases wait until _failover_grace_until for their
        # surviving owners to re-register; the grace timer then revokes
        # or re-creates the remainder.  _grace_objects tracks object ids
        # a blip-window mget implicitly created (unknown to the restored
        # tables) — still PENDING at the deadline, they fail as
        # reconstruction candidates instead of waiting forever.
        self._awaiting_nodes: Dict[str, NodeState] = {}  # store_id -> node
        self._restored_actors: Dict[bytes, dict] = {}    # aid -> info
        self._restored_leases: List[tuple] = []
        self._pending_lease_claims: Dict[str, tuple] = {}
        self._grace_objects: set = set()
        self._failover_grace_until = 0.0
        # Identity of this process's object store: SHM descriptors carry it
        # so consumers know whether a segment is locally attachable or must
        # be shipped (reference: owner-based object directory).  A
        # restarted head adopts the dead head's store id too — restored
        # descriptors homed "at the head" must keep resolving here.
        self.store_id = ((self._restore_data or {}).get("store_id")
                         or os.urandom(8).hex())
        self.spill_dir = (config.spill_dir
                          or f"/tmp/ray_tpu_spill_{self.session_id}")
        # Direct-put reservations degrade to the spill path (instead of
        # overcommitting tmpfs) through the store's spill_dir.
        self.shm.spill_dir = self.spill_dir
        self._stopped = False
        self._extra_workers = 0
        # Connection admission gate: the accept loops start mid-__init__
        # but a RESTARTED head must not serve agent_ready / reregister
        # until the snapshot restore populated the tables — an early
        # reregister would be nacked (node not restored yet) and the
        # surviving worker would exit instead of being adopted.
        self._boot_ready = threading.Event()

        # Worker rendezvous: workers are plain subprocesses running
        # ``python -m ray_tpu_torch._private.worker_main`` that dial back over a
        # unix socket (reference: raylet spawns default_worker.py which
        # connects back over the raylet socket, services.py:1346).
        self._sock_dir = f"/tmp/ray_tpu_{self.session_id}"
        os.makedirs(self._sock_dir, exist_ok=True)
        self._authkey = (bytes.fromhex(config.authkey_hex)
                         if config.authkey_hex else os.urandom(16))
        self._puller._authkey = self._authkey
        sock_path = os.path.join(self._sock_dir, "worker.sock")
        try:
            # An adopted session leaves the dead head's socket file
            # behind; AF_UNIX bind fails on an existing path.
            os.unlink(sock_path)
        except OSError:
            pass
        self._listener = multiprocessing.connection.Listener(
            sock_path, "AF_UNIX", backlog=512, authkey=self._authkey)
        self._accept_thread = threading.Thread(
            target=self._accept_loop, args=(self._listener,), daemon=True,
            name="ray_tpu_torch-accept")
        self._accept_thread.start()
        # TCP listener: node agents and their workers dial in here
        # (reference: the GCS + raylet gRPC ports).  Head-host-local
        # workers keep the unix socket.
        self._tcp_listener = multiprocessing.connection.Listener(
            (config.listen_host, config.listen_port), "AF_INET",
            backlog=512, authkey=self._authkey)
        self.tcp_address = protocol.format_address(
            self._tcp_listener.address)
        self._tcp_accept_thread = threading.Thread(
            target=self._accept_loop, args=(self._tcp_listener,),
            daemon=True, name="ray_tpu_torch-accept-tcp")
        self._tcp_accept_thread.start()
        # HEAD OBJECT SERVER: direct chunked pulls from the head node's
        # own store (driver puts, head-local worker results).  Keeps the
        # head's control-plane connections out of the payload path — a
        # remote consumer of a head-homed segment dials here instead of
        # round-tripping a multi-hundred-MB getparts reply through the
        # worker-message handler (reference: every node's object manager
        # has a transfer port, object_manager.h:117 — the head included).
        self._obj_listener = multiprocessing.connection.Listener(
            (config.listen_host, 0), "AF_INET", backlog=64,
            authkey=self._authkey)
        obj_adv = config.object_advertise_host or config.listen_host
        if obj_adv == "0.0.0.0":
            import socket as _socket

            obj_adv = _socket.gethostbyname(_socket.gethostname())
        self.object_addr = protocol.format_address(
            (obj_adv, self._obj_listener.address[1]))
        threading.Thread(target=self._object_server_loop, daemon=True,
                         name="ray_tpu_torch-objsrv").start()

        head_resources = {"CPU": float(num_cpus if num_cpus is not None
                                       else os.cpu_count() or 1)}
        if num_tpus:
            head_resources["TPU"] = float(num_tpus)
        if resources:
            head_resources.update(resources)
        head_resources.setdefault("memory", float(2 ** 33))
        restored_head_id = (self._restore_data or {}).get("head_node_id")
        self.head_node = self._add_node_locked(
            head_resources, labels={"head": "1"},
            node_id=(NodeID(bytes.fromhex(restored_head_id))
                     if restored_head_id else None))

        self._reaper = threading.Thread(
            target=self._reap_loop, daemon=True, name="ray_tpu_torch-reaper")
        self._reaper.start()
        if config.failure_detection:
            # Heartbeat suspicion (reference: GcsHealthCheckManager):
            # silence -> SUSPECT -> probe -> DEAD, feeding the existing
            # node/worker-death paths — a stalled peer becomes
            # indistinguishable from a killed one within one suspicion
            # window.  Off-switch = no thread, no probes, counter zero.
            threading.Thread(target=self._suspicion_loop, daemon=True,
                             name="ray_tpu_torch-suspicion").start()
        if config.memory_monitor_threshold > 0:
            threading.Thread(target=self._memory_monitor_loop,
                             daemon=True, name="ray_tpu_torch-memmon").start()
        # Worker log rings (worker_id_hex -> recent lines) + the tailer
        # that feeds them and re-prints to the driver (log_monitor.py).
        self._worker_logs: Dict[str, deque] = {}
        threading.Thread(target=self._log_monitor_loop, daemon=True,
                         name="ray_tpu_torch-logmon").start()
        # Conflation sender: dispatches buffer task-path messages (exec/
        # func/obj/mgot/free_segment/reply) per worker; this thread
        # flushes them as ("batch", ...) frames.  While one flush's
        # pickle+write runs, later dispatches coalesce into the next
        # batch — a burst of .remote() calls costs ~1 syscall per batch
        # instead of one per task.  The dirty set has its own leaf lock
        # so reply paths running off the IO threads don't contend on (or
        # need) the big runtime lock just to mark a worker dirty.
        self._sender_event = threading.Event()
        self._dirty_workers: set = set()
        self._dirty_agent_msgs: List[tuple] = []
        self._dirty_lock = threading.Lock()
        # Client lease requests waiting for capacity (reference: the
        # raylet's queued RequestWorkerLease); serviced by _dispatch_locked
        # on every resource release, expired by a per-request timer.
        self._pending_client_leases: deque = deque()
        # Actor-handle transfer tokens (actor.py __reduce__): token ->
        # actor_id for unconsumed pickled-handle counts; the consumed set
        # absorbs cross-connection create/consume reordering (bounded —
        # eviction of a real early consume merely leaves the actor's
        # count conservatively high).
        self._actor_tokens: Dict[bytes, bytes] = {}
        self._actor_tokens_consumed: set = set()
        # Task execution spans (worker "spans" batches) + per-message-
        # handler latency stats (reference: task events + event_stats.h).
        self.task_spans: deque = deque(maxlen=200_000)
        self._handler_stats: Dict[str, list] = {}
        self._handler_stats_lock = threading.Lock()
        self._sender = threading.Thread(
            target=self._task_sender_loop, daemon=True,
            name="ray_tpu_torch-sender")
        self._sender.start()
        # Sharded dispatch (decentralized_dispatch on): the hot submit
        # and reply paths no longer run the global dispatch scan inside
        # their own lock hold — they mark the affected scheduling
        # class(es) dirty (per-shard dirty set, own LEAF lock: never
        # taken around another lock; the event is set outside it) and
        # the dispatcher thread drains dirty shards, each pass scoped to
        # its class instead of scanning every queue.  With the switch
        # off the shards are never marked and every site dispatches
        # inline exactly as before.
        self._dispatch_dirty: set = set()
        self._dispatch_dirty_lock = threading.Lock()  # lock-order: leaf
        self._dispatch_event = threading.Event()
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, daemon=True,
            name="ray_tpu_torch-dispatch")
        self._dispatcher.start()
        # GCS-analog persistence: mutators bump _gcs_dirty; the snapshot
        # thread writes when it changed (reference: GCS tables persisted
        # to redis, redis_store_client.h:28).  Restore runs after the
        # dispatch machinery is up — it re-creates named actors.
        self._gcs_dirty = 0
        self._gcs_snapshotted = 0
        self._gcs_stop = threading.Event()
        # Serializes snapshot writes: shutdown()'s final clean snapshot
        # must not interleave with an in-flight periodic write (both use
        # the same pid-keyed tmp file — concurrent writers would tear
        # it, and a stale periodic os.replace landing AFTER the clean
        # one would un-mark the shutdown).
        self._gcs_write_lock = threading.Lock()  # lock-order: io-guard
        # Object-row cache for huge tables (see _snapshot_gcs).
        self._snap_obj_cache = None
        if self._restore_data is not None:
            self._apply_restore(self._restore_data)
            self._restore_data = None
        if config.gcs_snapshot_path:
            threading.Thread(target=self._gcs_snapshot_loop, daemon=True,
                             name="ray_tpu_torch-gcs-snap").start()
        self._boot_ready.set()  # admission gate open: tables restored
        atexit.register(self.shutdown)

    def _task_sender_loop(self):
        while not self._stopped:
            self._sender_event.wait()
            self._sender_event.clear()
            with self._dirty_lock:
                dirty, self._dirty_workers = self._dirty_workers, set()
                agent_msgs, self._dirty_agent_msgs = (
                    self._dirty_agent_msgs, [])
            for w in dirty:
                try:
                    w.flush_buffered()
                except Exception:
                    self._on_worker_death(w)
            for agent, msg in agent_msgs:
                if agent.dead:
                    continue
                try:
                    agent.send(msg)
                except Exception:
                    pass  # best-effort, same as the old inline send

    def _mark_dirty(self, worker: "WorkerHandle"):
        with self._dirty_lock:
            self._dirty_workers.add(worker)
        self._sender_event.set()

    def _queue_agent_send(self, agent: "AgentHandle", msg: tuple):
        """Fire-and-forget agent control frame (segment unlinks),
        deferred to the sender thread: the free path runs under the
        runtime lock, and a blocking send there stalls every other
        acquirer on one slow agent conn (lockgraph RTL604)."""
        with self._dirty_lock:
            self._dirty_agent_msgs.append((agent, msg))
        self._sender_event.set()

    # Sentinel marking "every shard needs a pass" (resources freed).
    _DIRTY_ALL = object()

    def _dispatch_loop(self):
        """Drain dirty dispatch shards.  Runs the same per-class pass the
        inline path runs, but OFF the submitting/replying thread: while
        this thread scans one class under the runtime lock, the next
        submit burst's registration only pays its table writes."""
        while not self._stopped:
            self._dispatch_event.wait()
            self._dispatch_event.clear()
            with self._dispatch_dirty_lock:
                dirty, self._dispatch_dirty = self._dispatch_dirty, set()
            if not dirty or self._stopped:
                continue
            keys = (None if self._DIRTY_ALL in dirty
                    else [k for k in dirty])
            try:
                with self.lock:
                    self._dispatch_locked(keys)
            except Exception:
                import traceback
                traceback.print_exc()

    def _request_dispatch_locked(self, keys=None):
        """Dispatch trigger for the hot paths.  decentralized_dispatch
        off: inline full pass, byte-identical to the pre-shard behavior.
        On: mark the affected shard(s) dirty (``keys`` None = all — a
        resource was freed, anything may now place) and let the
        dispatcher thread run the scan outside this caller's lock
        hold."""
        if not self.config.decentralized_dispatch:
            self._dispatch_locked()
            return
        with self._dispatch_dirty_lock:
            if keys is None:
                self._dispatch_dirty.add(self._DIRTY_ALL)
            else:
                self._dispatch_dirty.update(keys)
        self._dispatch_event.set()

    def _queue_send(self, worker: "WorkerHandle", msg: tuple):
        """Buffer ``msg`` for the conflation sender.  Back-to-back sends
        to one worker (a burst of mgot/obj replies, frees, execs) leave
        as one ("batch", ...) pickle + one write."""
        worker.queue_msg(msg)
        self._mark_dirty(worker)

    # ------------------------------------------------------------- nodes --
    def _add_node_locked(self, resources, labels=None, agent=None,
                         store_id=None, node_id=None) -> NodeState:
        # node_id override: a restarted head re-creates restored nodes
        # (its own included) under their OLD ids, so surviving workers'
        # RAY_TPU_NODE_ID and node-affinity strategies stay valid.
        node = NodeState(node_id or NodeID.from_random(), resources,
                         labels, agent=agent,
                         store_id=(self.store_id if store_id is None
                                   else store_id))
        self.nodes[node.node_id] = node
        self.node_order.append(node.node_id)
        return node

    def add_node(self, num_cpus=1.0, num_tpus=0.0, resources=None,
                 labels=None) -> NodeID:
        """Add a simulated cluster node (reference:
        python/ray/cluster_utils.py:165 Cluster.add_node)."""
        r = {"CPU": float(num_cpus)}
        if num_tpus:
            r["TPU"] = float(num_tpus)
        if resources:
            r.update(resources)
        r.setdefault("memory", float(2 ** 33))
        with self.lock:
            node = self._add_node_locked(r, labels)
            self._dispatch_locked()
            return node.node_id

    def remove_node(self, node_id: NodeID):
        """Kill a node and everything on it (chaos-testing hook; reference:
        test_utils.py kill_raylet / NodeKillerActor)."""
        with self.lock:
            node = self.nodes.get(node_id)
            if node is None or not node.alive:
                return
            node.alive = False
            workers = list(node.all_workers.values())
            agent = node.agent
        if agent is not None and not agent.dead:
            # Out-of-process node: the agent terminates its workers and
            # exits; conn EOFs drive the death handling.
            try:
                agent.send(("shutdown",))
            except Exception:
                pass
            try:
                agent.conn.close()
            except Exception:
                pass
            self._on_agent_death(agent)
        for w in workers:
            try:
                w.proc.terminate()
            except Exception:
                pass
        # Death handling proceeds via conn EOF in the IO loop.

    # ------------------------------------------------------ elastic drain --
    def drain_node(self, node_id, deadline_s=None,
                   reason: str = "scale_down") -> bool:
        """Graceful, deadline-bounded node removal — the DrainNode
        protocol (reference: gcs_node_manager DrainNode RPC + the
        raylet's drain state).  Within the deadline: (1) stop new
        placements (``node.draining`` — can_fit refuses), (2) revoke the
        node's outbound leases through the lease revocation path so
        holders reroute now, (3) steal queued-but-unstarted head tasks
        back and wait for the rest to finish, (4) force-checkpoint its
        restartable actors onto a SURVIVING store (``checkpoint_now`` →
        parts-shipped ``__ray_save__`` descriptors re-homed here — a
        checkpoint homed on the dying node would be dropped at restart),
        (5) migrate small sole-copy objects off the node (pull + re-home
        on the head store; larger ones stay lineage-reconstruction
        candidates), then (6) release the agent with ``drain_node`` so
        it exits cleanly.  Returns True when every phase landed inside
        the deadline (``drains_completed``); False on refusal or
        timeout (``drain_timeouts`` — the caller falls through to the
        existing hard-kill recovery, which is always correct, just
        costlier)."""
        if isinstance(node_id, str):
            node_id = NodeID(bytes.fromhex(node_id))
        if not self.config.elastic_drain:
            return False
        if deadline_s is None:
            deadline_s = self.config.drain_deadline_s
        deadline = time.monotonic() + max(0.2, float(deadline_s))
        entry = pending = None
        with self.lock:
            node = self.nodes.get(node_id)
            if node is None or not node.alive or node is self.head_node:
                return False
            if node.draining:
                pending = self._node_drains.get(node_id)
            else:
                node.draining = True
                entry = [threading.Event(), False, deadline]
                self._node_drains[node_id] = entry
            agent = node.agent
        if entry is None:
            # Another drain is in flight (scale-down racing a preemption
            # notice): wait for ITS conclusion — past its own deadline,
            # not just ours (it concludes on its own schedule) — and
            # return its REAL outcome, instead of failing into a hard
            # kill mid-migration or mislabeling a timed-out drain as a
            # success.  A missing entry means that drain already
            # concluded; just let the caller terminate.
            if pending is None:
                return True
            wait_s = max(float(deadline_s),
                         pending[2] - time.monotonic()) + 10.0
            if pending[0].wait(max(0.2, wait_s)):
                return bool(pending[1])
            return False  # wedged past its own deadline: hard fallback
        try:
            completed = self._drain_node_inner(node, agent, deadline,
                                               deadline_s, reason)
            entry[1] = completed
            return completed
        finally:
            with self.lock:
                self._node_drains.pop(node_id, None)
            entry[0].set()

    def _drain_node_inner(self, node, agent, deadline,
                          deadline_s, reason) -> bool:
        with self.lock:
            for w in list(node.all_workers.values()):
                if w.dead:
                    continue
                holder = w.client_lease
                if holder is not None:
                    # Leased-out worker: revoke exactly as node death
                    # would — the holder retries/reroutes everything the
                    # lease carried, but NOW, against a still-healthy
                    # cluster, instead of at the kill.
                    if not holder.dead \
                            and self.config.decentralized_dispatch:
                        self.lease_revocations += 1
                        self._queue_send(holder, ("lease_revoke",
                                                  [w.worker_id.hex()]))
                    w.client_lease = None
                    self._end_lease_locked(w)
                elif w.actor_id is None and w.inflight:
                    # Head-dispatched plain tasks: reclaim what has not
                    # started; what is already running gets the rest of
                    # the deadline to finish.
                    stealable = [tid for tid, r in w.inflight.items()
                                 if not r.is_actor_creation]
                    if stealable:
                        self._queue_send(w, ("steal", 0, stealable))
            self._request_dispatch_locked()
        idle_ok = self._drain_wait_idle(node, deadline)
        ck_ok = self._drain_checkpoint_actors(node, deadline)
        mig_ok = self._drain_migrate_objects(node, deadline)
        completed = idle_ok and ck_ok and mig_ok
        with self.lock:
            if completed:
                self.drains_completed += 1
            else:
                self.drain_timeouts += 1
        if agent is not None and not agent.dead:
            # Release the agent (it exits cleanly; sent even after a
            # timeout — best effort beats nothing, and the hard-kill
            # recovery covers whatever was left).  Caps-gated per the
            # Capability convention: an old agent that would ignore the verb
            # is never probed — its node falls to the legacy teardown.
            agent_drain_caps = tuple(agent.info.get("agent_caps") or ())
            if "drain_node" in agent_drain_caps:
                try:
                    agent.send(("drain_node", float(deadline_s), reason))
                except Exception:
                    pass
        return completed

    def _drain_wait_idle(self, node: NodeState, deadline: float) -> bool:
        """Wait (bounded) for the node's plain workers to finish their
        in-flight head-dispatched tasks; stolen tasks re-enqueue
        elsewhere on their own."""
        while time.monotonic() < deadline:
            with self.lock:
                busy = any(w.inflight and not w.dead
                           and w.actor_id is None
                           for w in node.all_workers.values())
            if not busy:
                return True
            time.sleep(0.05)
        return False

    def _drain_checkpoint_actors(self, node: NodeState,
                                 deadline: float) -> bool:
        """Force an immediate ``__ray_save__`` of every restartable
        actor on the node; the worker ships parts the head re-homes on
        its own store (actor_checkpoint handler).  True when every ack
        landed before the deadline."""
        targets = []
        with self.lock:
            if not self.config.recovery:
                return True
            for aid, actor in self.actors.items():
                w = actor.worker
                if (actor.status == ALIVE and w is not None and not w.dead
                        and w.node is node and actor.restarts_left != 0):
                    ev = threading.Event()
                    self._drain_ck_events[aid] = ev
                    targets.append((aid, w, ev))
            for aid, w, _ev in targets:
                self._queue_send(w, ("checkpoint_now", aid))
        ok = True
        for aid, _w, ev in targets:
            left = deadline - time.monotonic()
            if left <= 0 or not ev.wait(left):
                ok = False
                break
        with self.lock:
            for aid, _w, _ev in targets:
                self._drain_ck_events.pop(aid, None)
        return ok

    def _drain_migrate_objects(self, node: NodeState,
                               deadline: float) -> bool:
        """Migrate sole-copy objects homed in the draining node's store:
        READY shm segments at most ``drain_migrate_max_bytes`` are
        pulled over the data plane and re-homed on the head's surviving
        store (descriptor updated in place — consumers resolving through
        the owner directory see the new home; a stale cached pull falls
        back to getparts, which serves the new copy).  Bigger objects
        are left as lineage-reconstruction candidates.  True when every
        candidate moved (or none needed to) before the deadline."""
        cap = self.config.drain_migrate_max_bytes
        if node.store_id == self.store_id:
            # In-process test node: it shares the HEAD's store, which
            # survives the node — nothing to move (and "migrating"
            # head-homed segments onto themselves would be an
            # unlink-recreate race).
            return True
        victims = []
        with self.lock:
            for oid, st in self.objects.items():
                d = st.descr
                # SPILLED counts too: the node's spill files die with it
                # exactly like its shm pages, and the object server
                # attaches them by (absolute) path just like any
                # segment, so the same pull migrates both.
                if (st.status == READY and d is not None
                        and d[0] in (protocol.SHM, protocol.SPILLED)
                        and len(d) > 3
                        and d[3] == node.store_id and d[2] <= cap):
                    st.pins += 1  # no free/spill mid-migration
                    victims.append((oid, st, d))
        if not victims:
            return True

        def _migrate_one(item) -> bool:
            oid, st, d = item
            moved = None
            if time.monotonic() < deadline:
                try:
                    meta, bufs = self._fetch_parts(d)
                    moved = self._store_parts_locally(oid, meta, bufs)
                except Exception:
                    moved = None  # reconstruction candidate
            with self.lock:
                st.pins -= 1
                if moved is not None:
                    if st.status == READY and st.descr is d:
                        st.descr = moved
                        # Frees now unlink the NEW home (head-local),
                        # not the dead creator's pooled pages.
                        st.creator = None
                        self.objects_migrated += 1
                    else:
                        # Freed/re-written while we copied: drop the
                        # orphan replica (spill-degraded copies are
                        # plain files).
                        try:
                            if moved[0] == protocol.SPILLED:
                                os.unlink(moved[1])
                            else:
                                self.shm.unlink(moved[1], moved[2],
                                                reusable=False)
                        except Exception:
                            pass
                self._maybe_free_locked(oid, st)
            return moved is not None

        # The pulls are independent and all race the SAME closing
        # deadline: overlap them (the node's object server already
        # serves concurrent getparts — the striped pull is built on
        # it) so N victims cost ~N/pool transfers instead of a straight
        # sum that turns a beatable spot warning window into a
        # drain_timeout + avoidable reconstructions.
        ok = True
        with ThreadPoolExecutor(
                max_workers=min(4, len(victims)),
                thread_name_prefix="rtpu-drain-migrate") as pool:
            for done in pool.map(_migrate_one, victims):
                if not done:
                    ok = False
        return ok

    # -------------------------------------------------- runtime accessor --
    def is_worker(self):
        return False

    def add_local_reference(self, object_id: ObjectID):
        coll = getattr(self._tls, "reg_collector", None)
        if coll is not None:
            # Deserialization in progress: refs created by unpickling are
            # registered as ONE batch under one lock when the load
            # finishes (a 10k-ref container would otherwise take the
            # runtime lock 10k times; reference: reference_count.cc
            # batches borrower registration per message).
            coll.append((object_id, 1))
            return
        with self.lock:
            st = self.objects.get(object_id)
            if st is None:
                st = self.objects[object_id] = ObjectState()
            st.local_refs += 1

    def _begin_bulk_refs(self):
        prev = getattr(self._tls, "reg_collector", None)
        self._tls.reg_collector = []
        return prev

    def _end_bulk_refs(self, prev):
        coll = getattr(self._tls, "reg_collector", None)
        self._tls.reg_collector = prev
        if not coll:
            return
        if prev is not None:
            prev.extend(coll)  # nested load: the outermost applies
            return
        with self.lock:
            # Increments first: a (+1, -1) pair for the same oid must
            # never transit zero regardless of arrival order.
            for oid, delta in coll:
                if delta <= 0:
                    continue
                st = self.objects.get(oid)
                if st is None:
                    st = self.objects[oid] = ObjectState()
                st.local_refs += 1
            for oid, delta in coll:
                if delta > 0:
                    continue
                st = self.objects.get(oid)
                if st is not None:
                    st.local_refs -= 1
                    self._maybe_free_locked(oid, st)

    def remove_local_reference(self, object_id: ObjectID):
        if self._stopped:
            return
        coll = getattr(self._tls, "reg_collector", None)
        if coll is not None:
            # Mid-deserialization drop (a load-time __del__): defer it
            # with the batched increments — applying it immediately while
            # the matching +1 sits in the collector could free an object
            # that is still referenced.
            coll.append((object_id, -1))
            return
        with self.lock:
            st = self.objects.get(object_id)
            if st is None:
                return
            st.local_refs -= 1
            self._maybe_free_locked(object_id, st)

    def on_ref_serialized(self, object_id: ObjectID):
        # Collect-only: refs pickled while a collection is active (task-arg /
        # put serialization) are recorded; the submit/put path pins them under
        # the lock and the completion/free path unpins (simplified borrow
        # protocol vs reference_count.cc).  Refs pickled outside a collection
        # (user manually pickling a ref) are NOT pinned — as in the
        # reference, out-of-band ref serialization needs an owner keeping the
        # object alive.
        collector = getattr(self._tls, "ref_collector", None)
        if collector is not None:
            collector.append(object_id.binary())

    def begin_ref_collection(self):
        self._tls.ref_collector = []

    def end_ref_collection(self) -> list:
        out = getattr(self._tls, "ref_collector", None) or []
        self._tls.ref_collector = None
        return out

    def _pin_nested_locked(self, nested: list):
        for b in nested:
            oid = ObjectID(b)
            st = self.objects.get(oid)
            if st is None:
                st = self.objects[oid] = ObjectState()
            st.pins += 1

    def _unpin_nested_locked(self, nested: list):
        for b in nested:
            oid = ObjectID(b)
            st = self.objects.get(oid)
            if st is not None:
                st.pins -= 1
                self._maybe_free_locked(oid, st)

    def _maybe_free_locked(self, oid: ObjectID, st: ObjectState):
        if st.refcount() <= 0 and not st.futures and not st.waiters:
            self.objects.pop(oid, None)
            if st.descr is not None and st.descr[0] == protocol.SPILLED:
                home = (st.descr[3] if len(st.descr) > 3
                        else self.store_id)
                if home == self.store_id:
                    try:
                        os.unlink(st.descr[1])
                    except OSError:
                        pass
                else:
                    # Spill file lives on the owner node: route the
                    # unlink there (the agent's unlink handles absolute
                    # paths).
                    agent = self._agents.get(home)
                    if agent is not None and not agent.dead:
                        self._queue_agent_send(
                            agent, ("unlink_segment", st.descr[1],
                                    st.descr[2]))
            if st.descr is not None and st.descr[0] == protocol.SHM:
                home = st.descr[3] if len(st.descr) > 3 else self.store_id
                cw = st.creator
                if cw is not None and not cw.dead:
                    # A worker's store created the segment: route the free
                    # there so its pages can be pooled for in-place reuse
                    # (shipped segments may be mapped elsewhere — the worker
                    # then just closes + unlinks).  Conflated: a burst of
                    # frees rides one ("batch", ...) frame.  Queueing
                    # cannot fail; if delivery later fails, the worker-
                    # death path reroutes buffered frees to the store-
                    # side fallback (_reroute_dead_worker_frees_locked).
                    self._queue_send(cw, ("free_segment", st.descr[1],
                                          st.descr[2], not st.shipped))
                if cw is None or cw.dead:
                    if home == self.store_id:
                        self.shm.unlink(st.descr[1], st.descr[2],
                                        reusable=(not st.shipped
                                                  and st.creator is None))
                    else:
                        agent = self._agents.get(home)
                        if agent is not None and not agent.dead:
                            self._queue_agent_send(
                                agent, ("unlink_segment", st.descr[1],
                                        st.descr[2]))
            if st.segment is not None:
                st.segment.close()
            if st.nested_ids:
                nested, st.nested_ids = st.nested_ids, []
                self._unpin_nested_locked(nested)
            self._release_lineage_for_locked(oid)

    # ------------------------------------------------------------ objects --
    def serialize_value(self, value, object_id: ObjectID):
        # One serialization pass; shm buffers are memcpy'd exactly once,
        # directly into the segment (plasma create→write-in-place→seal).
        res = serialization.dumps_adaptive(
            value, self.config.max_inline_object_size)
        if res[0] == "inline":
            return (protocol.INLINE, res[1])
        try:
            name, size = self.shm.create_from_parts(object_id, res[1],
                                                    res[2])
        except MemoryError:
            # Store full: spill LRU unpinned residents to disk, then retry;
            # if still no room, write the new object straight to disk
            # (reference: LocalObjectManager spilling + the plasma
            # CreateRequestQueue fallback, local_object_manager.h:41).
            need = (sum(len(b) for b in res[2]) + len(res[1]) + 65536)
            self._spill_objects(need)
            try:
                name, size = self.shm.create_from_parts(object_id, res[1],
                                                        res[2])
            except MemoryError:
                path, size = self.shm.create_spilled(
                    object_id, res[1], res[2], self.spill_dir)
                return (protocol.SPILLED, path, size, self.store_id)
        return (protocol.SHM, name, size, self.store_id)

    def _clear_stale_put_segment(self, oid: ObjectID):
        """A failed direct push can strand the oid's canonical segment
        (the server committed but the ack was lost, or the abort cleanup
        is still draining server-side) — and the put_parts FALLBACK for
        the same oid then collides with it.  This put owns the name:
        clear any pending reservation, and for a committed remnant
        unlink it (restoring accounting) before assembling the
        fallback."""
        name = self.shm.segment_name(oid)
        path = os.path.join(self.shm._dir, name)
        # The spill-degraded reservation commits under spill_dir instead.
        spath = (os.path.join(self.spill_dir, name)
                 if self.spill_dir else None)
        spath = spath if spath and os.path.exists(spath) else None
        if not os.path.exists(path) and spath is None:
            return
        pending = False
        try:
            pending = object_transfer._puts_for(self.shm).abort(name)
        except Exception:
            pass
        if pending:
            # The reservation teardown (possibly deferred to the last
            # draining stripe writer) owns the file + accounting; wait
            # briefly for it to land rather than double-rolling-back.
            deadline = time.monotonic() + 2.0
            while os.path.exists(path) and time.monotonic() < deadline:
                time.sleep(0.01)
            return
        if spath is not None:
            try:
                os.unlink(spath)  # spill files are not store-accounted
            except OSError:
                pass
        try:
            size = os.stat(path).st_size
        except OSError:
            return  # shm remnant already gone
        self.shm.unlink(name, size)

    def _store_parts_locally(self, oid: ObjectID, meta: bytes, bufs):
        """Pre-serialized parts into the driver store (client puts),
        with the same spill fallback as serialize_value."""
        views = [memoryview(b) for b in bufs]
        self._clear_stale_put_segment(oid)

        def create():
            try:
                return self.shm.create_from_parts(oid, meta, views)
            except FileExistsError:
                # Raced a direct-push remnant that landed after the
                # clear above: clear again and retry once.
                self._clear_stale_put_segment(oid)
                return self.shm.create_from_parts(oid, meta, views)

        try:
            name, size = create()
        except MemoryError:
            need = sum(len(b) for b in bufs) + len(meta) + 65536
            self._spill_objects(need)
            try:
                name, size = create()
            except MemoryError:
                path, size = self.shm.create_spilled(
                    oid, meta, views, self.spill_dir)
                return (protocol.SPILLED, path, size, self.store_id)
        return (protocol.SHM, name, size, self.store_id)

    def _spill_objects(self, need_bytes: int) -> int:
        """Move LRU-ish unpinned READY resident objects to spill_dir until
        ``need_bytes`` of shm is freed (or no victims remain).  Insertion
        order of the object table approximates LRU (plasma's eviction
        policy is LRU too, eviction_policy.h)."""
        freed = 0
        with self.lock:
            victims = []
            total = 0
            for oid, st in self.objects.items():
                if (st.status == READY and st.pins == 0
                        and st.descr is not None
                        and st.descr[0] == protocol.SHM
                        and not st.shipped
                        and (len(st.descr) < 4
                             or st.descr[3] == self.store_id)
                        and st.segment is None):
                    victims.append((oid, st))
                    total += st.descr[2]
                    if total >= need_bytes:
                        break
            # Pin the victims: a concurrent free or a second spill pass
            # must not touch them while the copies run WITHOUT the lock
            # (multi-GB disk copies must not stall the whole driver).
            for _oid, st in victims:
                st.pins += 1
        done = []
        for oid, st in victims:
            name, size = st.descr[1], st.descr[2]
            try:
                path = self.shm.spill(name, size, self.spill_dir)
            except OSError:
                path = None
            done.append((oid, st, name, size, path))
            if path is not None:
                freed += size
        with self.lock:
            for oid, st, name, size, path in done:
                st.pins -= 1
                if path is not None:
                    creator = st.creator
                    st.descr = (protocol.SPILLED, path, size,
                                self.store_id)
                    st.creator = None
                    if creator is not None and not creator.dead:
                        # The creating worker may still hold the (now
                        # deleted) file's pages mapped in its pool: let go.
                        self._queue_send(creator, ("free_segment",
                                                   name, size, False))
                self._maybe_free_locked(oid, st)
        return freed

    def put_object(self, value):
        from ray_tpu_torch._private.object_ref import ObjectRef

        oid = ObjectID.for_put()
        self.begin_ref_collection()
        try:
            descr = self.serialize_value(value, oid)
        finally:
            nested = self.end_ref_collection()
        with self.lock:
            st = self.objects.get(oid)
            if st is None:
                st = self.objects[oid] = ObjectState()
            st.status = READY
            st.descr = descr
            st.value = value
            st.has_value = True
            st.local_refs += 1  # the caller's ref, counted under the lock
            st.nested_ids = nested
            self._pin_nested_locked(nested)
        return ObjectRef(oid, _register=False)

    def _register_put_locked(self, oid: ObjectID, st: ObjectState,
                             descr, ok: bool):
        """Publish a client-put descriptor: READY + wake waiters, but —
        unlike task-result completion — WITHOUT the maybe-free check: a
        fresh put's refcount is 0 until the client's addref (the very
        next message on its FIFO connection) lands, and freeing in that
        window would strand the ref forever."""
        st.status = READY if ok else ERRORED
        st.descr = descr
        self._gcs_dirty += 1  # object table rides the GCS snapshot now
        futures, st.futures = st.futures, []
        waiters, st.waiters = st.waiters, []
        for f in futures:
            if not f.done():
                f.set_result(oid)
        for cb in waiters:
            cb(oid)

    def _complete_object_locked(self, oid: ObjectID, descr, ok: bool,
                                creator=None):
        st = self.objects.get(oid)
        if st is None:
            st = self.objects[oid] = ObjectState()
        st.status = READY if ok else ERRORED
        st.descr = descr
        self._gcs_dirty += 1  # object table rides the GCS snapshot now
        if creator is not None and descr is not None \
                and descr[0] == protocol.SHM:
            st.creator = creator
        futures, st.futures = st.futures, []
        waiters, st.waiters = st.waiters, []
        for f in futures:
            if not f.done():
                f.set_result(oid)
        for cb in waiters:
            cb(oid)
        self._maybe_free_locked(oid, st)

    def object_future(self, object_id: ObjectID) -> Future:
        """Future resolving to the deserialized value (driver only)."""
        inner = Future()
        with self.lock:
            st = self.objects.get(object_id)
            if st is None:
                raise exc.ObjectFreedError(object_id=object_id.hex(),
                                           owner="driver", phase="get")
            if st.status != PENDING:
                inner.set_result(object_id)
            else:
                st.futures.append(inner)
        outer = Future()

        def _chain(f):
            try:
                outer.set_result(self._materialize(object_id))
            except BaseException as e:  # noqa: BLE001
                outer.set_exception(e)

        inner.add_done_callback(_chain)
        return outer

    def _materialize(self, oid: ObjectID, _recovering=False):
        with self.lock:
            st = self.objects.get(oid)
            if st is None:
                raise exc.ObjectFreedError(object_id=oid.hex(),
                                           owner="driver", phase="get")
            if st.has_value and st.status == READY:
                return st.value
            descr = st.descr
            if descr is not None and descr[0] == protocol.SHM:
                # Marked before attaching (which happens outside the lock):
                # a concurrent free must not pool and reuse the segment's
                # inode while we are mapping/deserializing it.
                st.shipped = True
        prev = self._begin_bulk_refs()
        try:
            value = self._materialize_value(oid, descr, _recovering)
        finally:
            self._end_bulk_refs(prev)
        with self.lock:
            st2 = self.objects.get(oid)
            if st2 is not None:
                st2.value = value
                st2.has_value = True
        return value

    def _materialize_value(self, oid: ObjectID, descr, _recovering):
        kind = descr[0]
        if kind == protocol.INLINE:
            value = serialization.loads_inline(descr[1])
        elif kind == protocol.PARTS:
            value = serialization.loads(descr[1], descr[2])
        elif kind == protocol.SHM and len(descr) > 3 \
                and descr[3] != self.store_id:
            # Segment lives in another node's store: ship its parts
            # (reference: ObjectManager::Pull via the owner's directory).
            try:
                meta, bufs = self._fetch_parts(descr)
            except exc.ObjectLostError:
                # Home store is gone: rebuild by lineage re-execution
                # (reference: object_recovery_manager.h:41).
                if _recovering or not self._recover_and_wait(oid):
                    raise
                return self._materialize(oid, _recovering=True)
            value = serialization.loads(meta, bufs)
            with self.lock:
                st2 = self.objects.get(oid)
                if st2 is not None:
                    st2.shipped = True
        elif kind == protocol.SHM:
            try:
                seg = self.shm.attach(descr[1])
            except FileNotFoundError:
                with self.lock:
                    st3 = self.objects.get(oid)
                    respilled = (st3 is not None and st3.descr is not None
                                 and st3.descr[0] == protocol.SPILLED)
                if respilled:
                    # Raced with the spiller: the object moved to disk
                    # between descriptor read and attach.
                    return self._materialize(oid, _recovering=_recovering)
                if _recovering or not self._recover_and_wait(oid):
                    raise exc.ObjectLostError(object_id=oid.hex(),
                                              home=self.store_id,
                                              owner="driver", phase="get")
                return self._materialize(oid, _recovering=True)
            value = seg.deserialize()
            with self.lock:
                st2 = self.objects.get(oid)
                if st2 is not None:
                    st2.segment = seg
        elif kind == protocol.SPILLED:
            # Restore from external storage (reference:
            # local_object_manager.h restore path).  Spill files written
            # by a REMOTE node only exist there: ship the parts.
            home = descr[3] if len(descr) > 3 else self.store_id
            if home != self.store_id and not os.path.exists(descr[1]):
                meta, bufs = self._fetch_parts(descr)
                value = serialization.loads(meta, bufs)
            else:
                seg = self.shm.attach_path(descr[1])
                value = seg.deserialize()
                with self.lock:
                    st2 = self.objects.get(oid)
                    if st2 is not None:
                        st2.segment = seg
        else:  # error
            raise serialization.loads_inline(descr[1])
        return value

    def _recovery_on(self) -> bool:
        return self.config.recovery and self.config.lineage_enabled

    def _register_lineage_locked(self, spec: dict):
        if not self._recovery_on():
            return
        if "actor_id" in spec or spec.get("num_returns", 0) <= 0:
            return  # actor methods have side effects; no re-execution
        # Keyed by the 12-byte task prefix: an ObjectID carries only the
        # prefix of its creating TaskID (ids.py), so recovery must be able
        # to go oid -> lineage without the full 16-byte task id.  The
        # table bounds itself: entries evicted for the byte budget get
        # their pinned spec resources released here, at the caller's
        # locking level (table _lock is a leaf; it runs no callbacks) —
        # EXCEPT specs whose task is still queued/in flight: their
        # nested-ref pins and by-value arg segments are live execution
        # state, released by the completion path instead (which
        # re-checks lineage membership and finds the entry gone).
        for old in self.lineage.record(
                spec, default_retries=self.config.default_max_retries):
            if old["spec"]["task_id"] not in self.tasks:
                self._release_spec_resources_locked(old["spec"])

    def _release_lineage_for_locked(self, oid: ObjectID):
        entry = self.lineage.release(oid.binary())
        if entry is not None:
            # The last return object is gone: nothing can ask for
            # re-execution anymore, so the nested-ref pins and by-value arg
            # segments held for it are released now.
            self._release_spec_resources_locked(entry["spec"])

    def _oid_from_segment_name(self, name: str) -> Optional[ObjectID]:
        """Segment names are rtpu-<session>-<oid hex> (shm_store.py;
        one naming-rule implementation, recovery.seg_oid_hex)."""
        oid_hex = recovery.seg_oid_hex(name)
        return None if oid_hex is None else ObjectID(bytes.fromhex(oid_hex))

    def _store_is_dead(self, store_hex: str) -> bool:
        if store_hex == self.store_id:
            return False
        agent = self._agents.get(store_hex)
        return agent is None or agent.dead

    def _try_recover_locked(self, oid: ObjectID) -> bool:
        """Queue re-execution of ``oid``'s creating task (reference:
        ObjectRecoveryManager::RecoverObject).  Returns False when
        recovery is off, no lineage exists (puts, actor results,
        released/evicted lineage), or the entry's reconstruction budget
        — per-task max_retries, a SYSTEM-failure budget — is spent."""
        if not self._recovery_on():
            return False
        entry = self.lineage.get(oid.task_prefix())
        if entry is None:
            return False
        spec = entry["spec"]
        if spec["task_id"] in self.tasks:
            return True  # already re-executing
        if not self.lineage.note_attempt(oid.task_prefix()):
            return False  # depleted retries: the loss stands
        self.reconstructions += 1
        tid = TaskID(spec["task_id"])
        for i in range(spec["num_returns"]):
            oid_i = tid.object_id(i)
            sti = self.objects.get(oid_i)
            if sti is None:
                sti = self.objects[oid_i] = ObjectState(tid)
            elif sti.status != PENDING:
                sti.status = PENDING
                sti.descr = None
                sti.value = None
                sti.has_value = False
                sti.segment = None
                sti.shipped = False
        req = spec.get("resources") or {"CPU": 1.0}
        rec = TaskRecord(spec, req,
                         spec.get("max_retries",
                                  self.config.default_max_retries))
        _apply_strategy(rec, spec)
        self.tasks[spec["task_id"]] = rec
        # Recursively recover lost dependencies first: a dep whose segment
        # store died must be rebuilt before this task can run on it.
        for a in spec.get("args", []):
            if isinstance(a, tuple) and a and a[0] == "ref":
                dep = ObjectID(a[1])
                dst = self.objects.get(dep)
                if (dst is None
                        or (dst.status == READY and dst.descr is not None
                            and dst.descr[0] == protocol.SHM
                            and len(dst.descr) > 3
                            and self._store_is_dead(dst.descr[3]))):
                    self._try_recover_locked(dep)
        self._resolve_deps_locked(rec)
        if rec.deps_pending == 0:
            self._enqueue_pending_locked(rec)
            self._dispatch_locked()
        self.task_events.append(
            {"task_id": spec["task_id"].hex(), "name": spec.get("name"),
             "state": "RECONSTRUCTING", "time": time.time()})
        return True

    def _recover_and_wait(self, oid: ObjectID, timeout=60.0) -> bool:
        """Trigger lineage recovery and block until the object is READY
        again.  Call WITHOUT the runtime lock.  A False return is a
        counted reconstruction failure — the caller surfaces
        ObjectLostError (zero failures counted while recovery is off:
        the refusal is then the legacy path, not a failure of it)."""
        ev = threading.Event()
        ok = False
        known = False
        try:
            with self.lock:
                # "Known" scopes the failure counter: a refusal for an
                # object the head never owned (a worker-owned segment
                # relayed through getparts) is not a head recovery
                # failure — the OWNER's lineage may still rebuild it.
                known = (oid in self.objects
                         or self.lineage.get(oid.task_prefix())
                         is not None)
                if not self._try_recover_locked(oid):
                    return False
                st = self.objects.get(oid)
                if st is None:
                    return False
                if st.status != PENDING:
                    ok = st.status == READY
                    return ok
                st.waiters.append(lambda _oid: ev.set())
            if not ev.wait(timeout):
                return False
            with self.lock:
                st = self.objects.get(oid)
                ok = st is not None and st.status == READY
                return ok
        finally:
            if not ok and known and self._recovery_on():
                with self.lock:
                    self.reconstruction_failures += 1

    def _recover_for_worker(self, worker: "WorkerHandle",
                            oid: ObjectID) -> bool:
        """Run lineage recovery on a WORKER's behalf (the getparts relay
        hit a dead store), releasing the requester's lease slot for the
        duration — the same credit the blocked/unblocked envelope moves.
        Without this, a node full of workers all blocked fetching args
        from a dead peer deadlocks recovery: the re-executed producers
        would have no slot to run on (the getters hold them all), which
        is exactly the cluster state after a node loss."""
        released = False
        with self.lock:
            if worker.lease_req is not None and not worker.released \
                    and worker.lease_pg is None and not worker.dead:
                worker.blocked = True
                worker.node.release(worker.lease_req)
                worker.released = True
                released = True
                self._request_dispatch_locked()
        try:
            return self._recover_and_wait(oid)
        finally:
            if released:
                with self.lock:
                    if not worker.dead and worker.lease_req is not None \
                            and worker.released:
                        worker.node.acquire(worker.lease_req)
                        worker.released = False
                    worker.blocked = False

    def _fetch_parts(self, descr):
        """Serialized (meta, buffers) of a SHM descriptor, shipping across
        stores when the segment is not locally attachable.  Blocking: call
        without the runtime lock held."""
        home = descr[3] if len(descr) > 3 else self.store_id
        if home == self.store_id:
            if descr[0] == protocol.SPILLED:
                seg = self.shm.attach_path(descr[1])
            else:
                seg = self.shm.attach(descr[1])
            try:
                meta, bufs = seg.raw_parts()
                return bytes(meta), [bytes(b) for b in bufs]
            finally:
                seg.close()
        with self.lock:
            agent = self._agents.get(home)
        if agent is None or agent.dead:
            raise exc.ObjectLostError(object_id=_seg_oid_hex(descr[1]),
                                      home=home, phase="pull")
        addr = agent.info.get("object_addr")
        if addr:
            # Direct chunked pull from the home node's object server,
            # striped/pooled, received straight into a local shm mapping
            # (one copy) — the head never touches the payload
            # (object_manager.h:206).  The returned buffers are zero-copy
            # views over the received mapping; they keep it alive.
            caps = tuple(agent.info.get("object_caps") or ())
            try:
                seg = object_transfer.pull_to_segment(
                    self._puller, self.shm, home, addr, descr[1],
                    caps=caps)
                return seg.raw_parts()
            except exc.ObjectLostError as e:
                if getattr(e, "phase", None) != "stalled":
                    raise
                # Stalled direct pull (deadline + retries exhausted):
                # HEDGE to the relay instead of propagating — the
                # agent's control link may still move even when its
                # object server does not.
                protocol.note_net_event("hedged_fetches")
            except Exception:
                pass  # conn trouble: fall back to the head relay
        with self.lock:
            self.relayed_segments += 1
        cfg = self.config
        relay_timeout = (max(2.0 * cfg.net_stall_timeout_s, 5.0)
                         if cfg.failure_detection else 30.0)
        return agent.request_segment(descr[1], timeout=relay_timeout)

    def get_objects(self, refs, timeout=None):
        deadline = None if timeout is None else time.monotonic() + timeout
        out = []
        for ref in refs:
            oid = ref.id()
            ev = threading.Event()
            with self.lock:
                st = self.objects.get(oid)
                if st is None:
                    raise exc.ObjectFreedError(object_id=oid.hex(),
                                               owner="driver", phase="get")
                if st.status == PENDING:
                    st.waiters.append(lambda _oid, ev=ev: ev.set())
                else:
                    ev.set()
            remaining = (None if deadline is None
                         else max(0.0, deadline - time.monotonic()))
            if not ev.wait(remaining):
                raise exc.GetTimeoutError(
                    f"Timed out getting {oid.hex()} after {timeout}s")
            out.append(self._materialize(oid))
        return out

    def wait_objects(self, refs, num_returns=1, timeout=None,
                     fetch_local=True):
        ids = [r.id() for r in refs]
        done_ev = threading.Event()
        state = {"ready": 0}
        with self.lock:
            pending = []
            for oid in ids:
                st = self.objects.get(oid)
                if st is None or st.status != PENDING:
                    state["ready"] += 1
                else:
                    pending.append(st)
            if state["ready"] < num_returns:
                def cb(_oid):
                    state["ready"] += 1
                    if state["ready"] >= num_returns:
                        done_ev.set()
                for st in pending:
                    st.waiters.append(cb)
            else:
                done_ev.set()
        done_ev.wait(timeout)
        ready, not_ready = [], []
        with self.lock:
            for ref, oid in zip(refs, ids):
                st = self.objects.get(oid)
                if st is None or st.status != PENDING:
                    ready.append(ref)
                else:
                    not_ready.append(ref)
        # Cap at num_returns for exact reference semantics
        if len(ready) > num_returns:
            not_ready = ready[num_returns:] + not_ready
            ready = ready[:num_returns]
        return ready, not_ready

    # -------------------------------------------------------- submission --
    def register_function(self, payload: bytes) -> str:
        func_id = serialization.dumps_inline(len(payload)).hex()[:8] + \
            __import__("hashlib").sha1(payload).hexdigest()[:16]
        with self.lock:
            if func_id not in self.functions:
                self.functions[func_id] = payload
                self._gcs_dirty += 1
        return func_id

    def submit_task(self, spec: dict):
        """Entry from RemoteFunction._remote (reference:
        python/ray/remote_function.py:241 → core_worker.cc:1819 SubmitTask)."""
        return self.submit_tasks([spec])[0]

    def submit_tasks(self, specs: List[dict]):
        """Bulk submission: register every spec under ONE lock
        acquisition, then run ONE dispatch pass (and one pump per
        distinct actor) over the whole batch — a fan-out burst pays
        O(1) lock/dispatch instead of O(n) (reference: the per-
        SchedulingKey amortization in direct_task_transport.cc).
        Returns one list of ObjectRefs per spec."""
        from ray_tpu_torch._private.object_ref import ObjectRef

        self._submit_specs(specs, from_worker=False)
        out = []
        for spec in specs:
            tid = TaskID(spec["task_id"])
            out.append([ObjectRef(tid.object_id(i), _register=False)
                        for i in range(spec["num_returns"])])
        return out

    def _submit_specs(self, specs: List[dict], *, from_worker: bool,
                      submitter=None):
        """Shared bulk-registration core for driver submissions and the
        worker/client ("submit"/"submit_batch") path.  Per-spec
        invariants (TaskRecord, strategy parse, SUBMITTED event dicts,
        one shared timestamp) are built OUTSIDE the lock; only table
        writes run inside it, followed by one dispatch pass and one
        pump per distinct actor."""
        now = time.time()
        recs = []
        events = []
        for spec in specs:
            if from_worker and submitter is not None \
                    and spec.get("tmp_segments"):
                # The submitting worker's store created any by-value arg
                # segments in tmp_segments; frees are routed back there
                # (segment-pool reuse).
                spec["_creator_worker"] = submitter
            req = spec.get("resources") or {"CPU": 1.0}
            rec = TaskRecord(spec, req,
                             spec.get("max_retries",
                                      self.config.default_max_retries))
            _apply_strategy(rec, spec)
            recs.append(rec)
            events.append(
                {"task_id": spec["task_id"].hex(),
                 "name": spec.get("name"),
                 "state": "SUBMITTED", "time": now})
        with self.lock:
            dispatch_keys: List[tuple] = []
            actor_ids: List[bytes] = []
            if from_worker and self.config.decentralized_dispatch:
                # The decentralization observable: specs that reached the
                # head's scheduler over the wire.  Under a healthy lease
                # plane this stays bounded by lease-renewal/starvation
                # events, not task count (pinned by the acceptance test).
                self.head_brokered_submits += len(specs)
            for rec, ev in zip(recs, events):
                spec = rec.spec
                tid = TaskID(spec["task_id"])
                for i in range(spec["num_returns"]):
                    oid = tid.object_id(i)
                    st = self.objects.get(oid)
                    if st is None:
                        st = self.objects[oid] = ObjectState(tid)
                    else:
                        st.task_id = tid
                    # Count the submitter's reference NOW, under the lock
                    # — its ObjectRefs are built with _register=False
                    # (the driver's own, or the worker's whose __del__
                    # decrefs pair with this).  Otherwise a fast task
                    # could complete (IO thread) and be freed before the
                    # submitter's ref registers (the classic ownership
                    # race; reference: reference_count.cc AddOwnedObject
                    # happens atomically with submission).
                    if from_worker:
                        st.worker_refs += 1
                    else:
                        st.local_refs += 1
                if from_worker and spec.get("func_payload") is not None:
                    fid = spec["func_id"]
                    self.functions.setdefault(fid,
                                              spec.pop("func_payload"))
                self.tasks[spec["task_id"]] = rec
                # SUBMITTED must precede the RUNNING event that dispatch
                # may append below — state queries take the latest event
                # per task.
                self.task_events.append(ev)
                self._register_lineage_locked(spec)
                self._pin_nested_locked(spec.get("nested_refs", []))
                self._resolve_deps_locked(rec)
                if "actor_id" in spec:
                    aid = self._enqueue_actor_task_nopump_locked(rec)
                    if aid is not None:
                        actor_ids.append(aid)
                elif rec.deps_pending == 0:
                    self._enqueue_pending_locked(rec)
                    dispatch_keys.append(rec.sched_key)
            for aid in dict.fromkeys(actor_ids):
                self._pump_actor_locked(self.actors[aid])
            if dispatch_keys:
                keys = list(dict.fromkeys(dispatch_keys))
                if not self.config.decentralized_dispatch:
                    self._dispatch_locked()
                elif not from_worker and len(specs) == 1:
                    # Driver sync-submit fast path: one spec, dispatch its
                    # class inline (no thread hop on the latency path; the
                    # scan is already scoped to one shard).
                    self._dispatch_locked(keys)
                else:
                    # Burst: hand the scan to the dispatcher thread so
                    # this submitter's lock hold ends at registration.
                    self._request_dispatch_locked(keys)

    def _resolve_deps_locked(self, rec: TaskRecord):
        spec = rec.spec
        deps = []
        for slot in ("args",):
            for a in spec[slot]:
                if a[0] == "ref":
                    deps.append(ObjectID(a[1]))
        for a in spec.get("kwargs", {}).values():
            if a[0] == "ref":
                deps.append(ObjectID(a[1]))
        rec.deps_pending = 0
        for oid in deps:
            st = self.objects.get(oid)
            if st is None:
                # Unknown dependency: surface as lost at dispatch time.
                continue
            if st.status == PENDING:
                rec.deps_pending += 1
                st.waiters.append(
                    lambda _oid, rec=rec: self._dep_ready(rec))
            st.pins += 1  # pinned until the task finishes

    def _dep_ready(self, rec: TaskRecord):
        with self.lock:
            rec.deps_pending -= 1
            if rec.deps_pending == 0 and not rec.dispatched:
                if rec.actor_id is not None:
                    self._pump_actor_locked(self.actors[rec.actor_id])
                else:
                    self._enqueue_pending_locked(rec)
                    self._request_dispatch_locked([rec.sched_key])

    # -------------------------------------------------------- scheduling --
    # Sentinel for _pick_node_locked's pref parameter: "not computed yet"
    # (None is a valid computed preference).
    _PREF_UNSET = object()

    def _pick_node_locked(self, rec: TaskRecord,
                          pref=_PREF_UNSET) -> Optional[NodeState]:
        """Hybrid policy condensed (reference:
        scheduling/policy/hybrid_scheduling_policy.cc — prefer local until
        threshold, then best remote; spillback)."""
        spec = rec.spec
        strategy = spec.get("scheduling_strategy")
        if rec.pg_id is not None:
            pg = self.placement_groups.get(rec.pg_id)
            if pg is None or pg.removed:
                return None
            idx = rec.bundle_index if rec.bundle_index is not None else 0
            node_id = pg.reserved[idx]
            if node_id is None:
                return None
            # PG bundles reserved node resources at creation; tasks must
            # still fit within the bundle's own capacity (shadow-resource
            # model, placement_group_resource_manager.cc).
            if not self._pg_can_fit_locked(pg, idx, rec.requirements):
                return None
            node = self.nodes.get(node_id)
            return node if node and node.alive else None
        if strategy and strategy[0] == "node_affinity":
            node = self.nodes.get(NodeID(strategy[1]))
            if node and node.alive and node.can_fit(rec.requirements):
                return node
            if strategy[2]:  # soft
                pass
            else:
                return None
        if strategy and strategy[0] == "spread":
            best = None
            best_score = 0.0
            for nid in self.node_order:
                node = self.nodes[nid]
                if not node.alive or not node.can_fit(rec.requirements):
                    continue
                score = sum(
                    node.available.get(k, 0) / max(node.resources.get(k, 1),
                                                   1)
                    for k in rec.requirements)
                # Strictly-greater with an epsilon: float near-ties (and
                # exact ties) resolve to the earliest node in node_order,
                # so spread placement is deterministic and testable.
                if best is None or score > best_score + 1e-9:
                    best, best_score = node, score
            return best
        if pref is self._PREF_UNSET:
            pref = self._locality_pref_locked(rec)
        if pref is not None and pref[0].can_fit(rec.requirements):
            # Top-locality node has fresh capacity: place there.  The
            # hit/miss/bytes accounting happens at the dispatch site,
            # which also covers the pipelined-lease placements.
            return pref[0]
        head = self.nodes[self.node_order[0]]
        if head.alive and head.can_fit(rec.requirements):
            return head
        for nid in self.node_order[1:]:
            node = self.nodes[nid]
            if node.alive and node.can_fit(rec.requirements):
                return node
        return None

    def _node_for_store_locked(self, store_hex: str) -> Optional[NodeState]:
        """The node whose object store is ``store_hex`` (in-process test
        nodes share the head's store and map to the head node)."""
        if store_hex == self.store_id:
            return self.head_node
        agent = self._agents.get(store_hex)
        return agent.node if agent is not None and not agent.dead else None

    def _locality_pref_locked(
            self, rec: TaskRecord) -> Optional[Tuple[NodeState, int]]:
        """(top-locality node, argument bytes homed there), or None when
        locality does not apply — strategy/PG tasks, no sizeable homed
        args, or the feature switched off.  Walks the spec's arg/kwarg
        descriptors once per record: every SHM/SPILLED descriptor carries
        (size, home store_id), and a "ref" arg's descriptor is READY in
        the object table by pick time (deps resolved before enqueue).
        Reference: locality-aware lease selection in
        hybrid_scheduling_policy.cc via the owner's object directory
        (the head IS the directory here — Ownership, NSDI'21)."""
        if not self.config.locality_scheduling:
            return None
        if rec.pg_id is not None or rec.spec.get("scheduling_strategy"):
            return None
        homes = rec.locality_homes
        if homes is None:
            homes = {}
            spec = rec.spec
            for d in itertools.chain(spec.get("args", ()),
                                     (spec.get("kwargs") or {}).values()):
                if d and d[0] == "ref":
                    st = self.objects.get(ObjectID(d[1]))
                    d = st.descr if st is not None else None
                if (d is not None and len(d) > 3
                        and d[0] in (protocol.SHM, protocol.SPILLED)):
                    homes[d[3]] = homes.get(d[3], 0) + d[2]
            rec.locality_homes = homes
        if not homes:
            return None
        best = None
        best_bytes = 0
        for store, nbytes in homes.items():
            if nbytes < best_bytes or nbytes < self.config.locality_min_bytes:
                continue
            node = self._node_for_store_locked(store)
            if node is None or not node.alive:
                continue
            if best is None or nbytes > best_bytes:
                best, best_bytes = node, nbytes
        return None if best is None else (best, best_bytes)

    def _lend_node_locked(self, rec: "TaskRecord") -> Optional[NodeState]:
        """Over-capacity admission backed by BLOCKED workers — without
        this, a cluster fully packed with actors deadlocks the moment an
        actor blocks on tasks that need a slot (reference: extra workers
        for blocked ones, worker_pool.cc backpressured by
        ray_config_def.h:174-187).

        Bound: a blocked worker's RELEASED slot already re-entered
        ``available`` (the "blocked" handler), and this path additionally
        admits up to one lent slot per blocked worker (so ≤2x per blocked
        worker, capped by ``max_extra_blocked_workers`` per node).  The
        looser 2x bound is deliberate: the released slot may legally be
        consumed by a permanent holder (a new actor), and the tasks the
        blocker waits on must STILL be admissible or the deadlock
        returns.  CPU oversubscription is transient and OS-scheduled.
        Transient CPU leases only: permanent holders (actors, TPU
        workers, PG bundles) never ride a lent slot."""
        if rec.is_actor_creation or rec.pg_id is not None:
            return None
        if rec.spec.get("scheduling_strategy"):
            return None
        req = rec.requirements
        if any(k not in ("CPU", "memory") for k in req):
            return None
        for nid in self.node_order:
            node = self.nodes[nid]
            if not node.alive or node.draining:
                continue
            blocked = sum(1 for w in node.all_workers.values()
                          if w.blocked and not w.dead)
            if blocked <= 0:
                continue
            lend = min(blocked, self.config.max_extra_blocked_workers)
            if (node.available.get("CPU", 0.0) - req.get("CPU", 0.0)
                    >= -lend - 1e-9
                    and all(node.available.get(k, 0.0) >= v - 1e-9
                            for k, v in req.items() if k != "CPU")):
                return node
        return None

    def _sched_class(self, rec: "TaskRecord") -> tuple:
        strategy = rec.spec.get("scheduling_strategy")
        # pg targeting is already covered by (pg_id, bundle_index); for the
        # rest (node_affinity/spread) the whole tuple keys the class.
        skey = None if strategy and strategy[0] == "placement_group" \
            else repr(strategy)
        # Actor creations get singleton classes: their worker becomes the
        # actor, so plain tasks must never pipeline onto its lease.
        marker = rec.actor_id if rec.is_actor_creation else None
        # runtime_env is part of the class: env_vars and the pip venv are
        # baked into the worker process at spawn, so tasks with different
        # envs must never share a lease (reference: SchedulingKey
        # includes runtime_env hash).
        env = rec.spec.get("runtime_env") or {}
        ekey = None
        if env.get("env_vars") or env.get("pip"):
            parts = []
            if env.get("env_vars"):
                parts.append(repr(sorted(env["env_vars"].items())))
            if env.get("pip"):
                from ray_tpu_torch._private.runtime_env_pip import pip_env_hash

                parts.append("pip=" + pip_env_hash(env["pip"]))
            ekey = "|".join(parts)
        return (tuple(sorted(rec.requirements.items())),
                rec.pg_id, rec.bundle_index, skey, marker, ekey)

    def _enqueue_pending_locked(self, rec: "TaskRecord"):
        if rec.sched_key is None:
            rec.sched_key = self._sched_class(rec)
        self.pending_tasks.setdefault(rec.sched_key, deque()).append(rec)

    def _dispatch_locked(self, keys=None):
        """Assign queued tasks to workers.  Two-step per scheduling class,
        mirroring the reference's lease model (direct_task_transport.h:75):
        first pipeline onto already-leased workers of the class (up to
        max_tasks_in_flight each — the lease holds the resources, so
        pipelined tasks cost no extra slots), then lease new workers while
        resources remain.

        ``keys`` scopes the pass to those scheduling classes (sharded
        dispatch: a submit only needs its own class scanned — nothing it
        did could unblock another class); None scans every class
        (resource-release events, where anything may now place)."""
        # Chaos syncpoint: a RAY_TPU_CHAOS "head:dispatch:N" rule takes
        # the head down deterministically mid-scheduling (no-op unless
        # the head process armed it — see _private/head_main.py).
        recovery.syncpoint("dispatch")
        if self._stopped:
            return
        if self.pending_pgs:
            self._try_reserve_pgs_locked()
        for key in (list(self.pending_tasks) if keys is None else keys):
            self._dispatch_class_locked(key)
        self._service_client_leases_locked()

    def _dispatch_class_locked(self, key):
        """One scheduling class's dispatch pass (the shard body)."""
        q = self.pending_tasks.get(key)
        if q is not None:
            while q:
                rec = q[0]
                if rec.cancelled or rec.dispatched:
                    q.popleft()
                    continue
                pref = self._locality_pref_locked(rec)
                node = self._pick_node_locked(rec, pref)
                worker = None
                if node is None:
                    # No free capacity: overflow onto existing leases
                    # (pipelining) rather than stall the class.  Fresh
                    # capacity is preferred so a long task can't head-of-
                    # line-block a short one while CPUs sit idle.  With a
                    # locality preference, a lease on the preferred node
                    # wins among the pipelinable candidates.
                    worker = self._find_pipelinable_worker_locked(
                        key, prefer_node=(pref[0] if pref else None))
                    if worker is None:
                        # Last resort: blocked workers lend their slots.
                        node = self._lend_node_locked(rec)
                        if node is None:
                            break  # same class behind cannot place either
                elif pref is not None and node is not pref[0]:
                    # Fresh capacity only AWAY from the argument bytes: a
                    # pipelinable leased worker already on the top-
                    # locality node beats it (the lease holds the
                    # resources there and the args need no transfer) —
                    # but only up to the pipeline depth cap; past it the
                    # fresh node wins (locality must never stall a class).
                    w = self._find_pipelinable_worker_locked(
                        key, prefer_node=pref[0])
                    if w is not None and w.node is pref[0]:
                        worker = w
                if worker is not None:
                    q.popleft()
                    self._count_locality_locked(pref, worker.node, rec)
                    self._assign_to_worker_locked(worker, rec)
                    continue
                use_pg = rec.pg_id is not None
                if use_pg:
                    pg = self.placement_groups.get(rec.pg_id)
                    self._pg_acquire_locked(pg, rec.bundle_index or 0,
                                            rec.requirements)
                else:
                    node.acquire(rec.requirements)
                tpu_chips = []
                n_tpu = int(rec.requirements.get("TPU", 0))
                if n_tpu > 0:
                    if len(node.tpu_free) < n_tpu:
                        # Chips still attached to retiring workers.
                        if use_pg:
                            self._pg_release_locked(pg, rec.bundle_index or 0,
                                                    rec.requirements)
                        else:
                            node.release(rec.requirements)
                        break
                    tpu_chips = node.tpu_free[:n_tpu]
                    node.tpu_free = node.tpu_free[n_tpu:]
                q.popleft()
                self._count_locality_locked(pref, node, rec)
                rec.node = node
                worker = self._lease_worker_locked(node, rec, tpu_chips)
                worker.lease_req = dict(rec.requirements)
                worker.lease_pg = ((rec.pg_id, rec.bundle_index or 0)
                                   if use_pg else None)
                # TPU workers are dedicated + retired after their task, and
                # actor-creation workers become the actor: neither joins the
                # pipelining pool.
                if not tpu_chips and not rec.is_actor_creation:
                    worker.lease_key = key
                    self.leased_workers.setdefault(key, []).append(worker)
                self._assign_to_worker_locked(worker, rec)
            if not q:
                self.pending_tasks.pop(key, None)

    def _count_locality_locked(self, pref, target: NodeState,
                               rec: TaskRecord):
        """Account one placement against its locality preference — at the
        dispatch commit point only, so an aborted placement attempt (TPU
        chips mid-retire) can't double-count on the retry pass.

        A hit is credited only when locality actually CHANGED the
        placement: landing on the preferred node when the head-first
        default would have picked it anyway (e.g. head-homed args on a
        single-node cluster, where no byte could ever cross the network)
        counts nothing, so locality_bytes_saved reflects genuinely
        avoided transfers."""
        if pref is None:
            return
        if target is not pref[0]:
            self.locality_misses += 1
            return
        default = None
        alive = 0
        for nid in self.node_order:
            node = self.nodes[nid]
            if not node.alive:
                continue
            alive += 1
            if default is None and node.can_fit(rec.requirements):
                default = node
        if alive < 2 or default is target:
            return  # placement could not have / did not change
        self.locality_hits += 1
        self.locality_bytes_saved += pref[1]

    def _find_pipelinable_worker_locked(
            self, key: tuple,
            prefer_node: Optional[NodeState] = None
    ) -> Optional[WorkerHandle]:
        """Least-loaded leased worker of the class with pipeline room.
        ``prefer_node`` (locality): a candidate on that node wins over a
        less-loaded one elsewhere, but NEVER past the depth cap — the
        cap bounds head-of-line blocking and locality must not bypass
        it."""
        lst = self.leased_workers.get(key)
        if not lst:
            return None
        depth = self.config.max_tasks_in_flight_per_worker
        best = None
        best_pref = None
        for w in lst:
            if w.dead or w.blocked or w.released or w.actor_id is not None \
                    or w.pending_force_kill is not None:
                continue
            if len(w.inflight) >= depth:
                continue
            if best is None or len(w.inflight) < len(best.inflight):
                best = w
            if prefer_node is not None and w.node is prefer_node and (
                    best_pref is None
                    or len(w.inflight) < len(best_pref.inflight)):
                best_pref = w
        return best_pref if best_pref is not None else best

    def _assign_to_worker_locked(self, worker: WorkerHandle,
                                 rec: TaskRecord):
        rec.node = worker.node
        rec.worker = worker
        rec.dispatched = True
        worker.last_dispatch_ts = time.monotonic()
        if self._send_task(worker, rec):
            worker.inflight[rec.spec["task_id"]] = rec
        elif not worker.inflight:
            self._end_lease_locked(worker)

    def _end_lease_locked(self, worker: WorkerHandle, reap=False):
        """Return the worker's lease: release its held resources and pool
        (or retire) the process (reference: ReturnWorker in
        direct_task_transport.cc / raylet lease return)."""
        node = worker.node
        if worker.lease_key is not None:
            lst = self.leased_workers.get(worker.lease_key)
            if lst is not None:
                try:
                    lst.remove(worker)
                except ValueError:
                    pass
                if not lst:
                    self.leased_workers.pop(worker.lease_key, None)
            worker.lease_key = None
        if worker.lease_req is not None and node is not None:
            if not worker.released:
                if worker.lease_pg is not None:
                    pg = self.placement_groups.get(worker.lease_pg[0])
                    if pg is not None and not pg.removed:
                        self._pg_release_locked(pg, worker.lease_pg[1],
                                                worker.lease_req)
                else:
                    node.release(worker.lease_req)
        worker.lease_req = None
        worker.lease_pg = None
        worker.lease_expiry = None
        worker.released = False
        worker.blocked = False
        had_tpu = bool(worker.tpu_chips)
        if had_tpu and node is not None:
            node.tpu_free.extend(worker.tpu_chips)
            worker.tpu_chips = []
        worker.idle_since = time.monotonic()
        if reap or had_tpu:
            # TPU workers are dedicated: the chip set is baked into the
            # process env at spawn, so retire rather than cache.
            self._kill_worker_locked(worker)
        elif not worker.dead:
            worker.node.idle_workers.setdefault(worker.env_key, []).append(
                worker)

    def _env_key_for(self, rec: TaskRecord, tpu_chips) -> str:
        env = rec.spec.get("runtime_env") or {}
        key = repr(sorted(env.get("env_vars", {}).items()))
        if env.get("pip"):
            from ray_tpu_torch._private.runtime_env_pip import pip_env_hash

            key += f"|pip={pip_env_hash(env['pip'])}"
        if env.get("working_dir"):
            # Content hash, not path: edited directories must not reuse
            # idle workers that extracted the previous package.
            key += f"|wd={self._package_working_dir(env['working_dir'])}"
        if tpu_chips:
            key += f"|tpu={','.join(map(str, tpu_chips))}"
        return key

    def _package_working_dir(self, path: str) -> str:
        """Zip a working_dir once and cache by content hash (reference:
        runtime_env packaging.py — zip -> GCS KV -> workers download).
        Workers fetch it over their connection via get_package."""
        import hashlib
        import io
        import zipfile

        path = os.path.abspath(path)
        with self.lock:
            cache = getattr(self, "_pkg_cache", None)
            if cache is None:
                cache = self._pkg_cache = {}      # pkg_id -> zip bytes
                self._pkg_by_path = {}            # path -> (stamp, pkg_id)
            ent = self._pkg_by_path.get(path)
        # Validity stamp covers mtimes AND the file-name set, so deleted
        # files invalidate the cache too.
        names = sorted(os.path.relpath(os.path.join(r, f), path)
                       for r, _d, fs in os.walk(path) for f in fs)
        mtime = max((os.path.getmtime(os.path.join(path, n))
                     for n in names), default=os.path.getmtime(path))
        stamp = (mtime, hashlib.sha1(
            "\0".join(names).encode()).hexdigest())
        if ent is not None and ent[0] == stamp:
            return ent[1]
        buf = io.BytesIO()
        with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as z:
            for n in names:
                z.write(os.path.join(path, n), n)
        blob = buf.getvalue()
        pkg_id = hashlib.sha1(blob).hexdigest()[:16]
        with self.lock:
            if ent is not None and ent[1] != pkg_id:
                # Superseded version: drop its zip unless another path
                # still maps to it (head memory must not grow per edit).
                old = ent[1]
                if not any(v[1] == old for k, v in
                           self._pkg_by_path.items() if k != path):
                    self._pkg_cache.pop(old, None)
            self._pkg_cache[pkg_id] = blob
            self._pkg_by_path[path] = (stamp, pkg_id)
        return pkg_id

    def _lease_worker_locked(self, node: NodeState, rec: TaskRecord,
                             tpu_chips) -> WorkerHandle:
        env_key = self._env_key_for(rec, tpu_chips)
        idle = node.idle_workers.get(env_key)
        if idle:
            w = idle.pop()
            return w
        return self._spawn_worker(node, env_key, rec, tpu_chips)

    def _worker_config_env(self) -> Dict[str, str]:
        """Config knobs that follow _system_config overrides into workers
        via the env namespace (worker GLOBAL_CONFIG is rebuilt from env at
        import).  Shared by both spawn paths so a knob added here reaches
        agent-spawned workers too — the ray_tpu_torch.data entries are what lets
        a Dataset consumed INSIDE a worker (the Train shard contract) see
        the driver's engine switch and byte budget."""
        return {
            "RAY_TPU_MAX_INLINE": str(self.config.max_inline_object_size),
            "RAY_TPU_POOL_BYTES": str(self.config.shm_pool_bytes),
            "RAY_TPU_OBJECT_POOL_SIZE": str(self.config.object_pool_size),
            "RAY_TPU_OBJECT_STRIPE_THRESHOLD":
                str(self.config.object_stripe_threshold),
            "RAY_TPU_DIRECT_PUTS":
                "1" if self.config.direct_puts else "0",
            "RAY_TPU_OBJECT_PUT_STRIPE_THRESHOLD":
                str(self.config.object_put_stripe_threshold),
            "RAY_TPU_OBJECT_PUT_POOL_SIZE":
                str(self.config.object_put_pool_size),
            "RAY_TPU_ARG_PREFETCH_DEPTH":
                str(self.config.arg_prefetch_depth),
            "RAY_TPU_STREAMING_EXECUTOR":
                "1" if self.config.streaming_executor else "0",
            "RAY_TPU_DATA_MEMORY_BUDGET":
                str(self.config.data_memory_budget),
            "RAY_TPU_DATA_MEMORY_BUDGET_FRACTION":
                str(self.config.data_memory_budget_fraction),
            "RAY_TPU_DATA_MAX_INFLIGHT_TASKS":
                str(self.config.data_max_inflight_tasks),
            # Push-shuffle knobs: the switch and both tuning knobs are
            # read in the WORKER process (map tasks partition + push,
            # reducer actors merge on arrival), and a Dataset consumed
            # inside a worker plans its shuffle there too.
            "RAY_TPU_PUSH_SHUFFLE":
                "1" if self.config.push_shuffle else "0",
            "RAY_TPU_SHUFFLE_PARTITION_BYTES_TARGET":
                str(self.config.shuffle_partition_bytes_target),
            "RAY_TPU_SHUFFLE_MERGE_FANIN":
                str(self.config.shuffle_merge_fanin),
            # Distributed-training knobs: the switch and both tuning
            # knobs are read wherever the trainer/learner runs — stage
            # actors push in WORKER processes, and a PipelineTrainer or
            # Impala built inside a Trainable worker must see the
            # driver's _system_config.
            "RAY_TPU_DISTRIBUTED_TRAINING":
                "1" if self.config.distributed_training else "0",
            "RAY_TPU_PIPELINE_MICROBATCHES":
                str(self.config.pipeline_microbatches),
            "RAY_TPU_IMPALA_QUEUE_DEPTH":
                str(self.config.impala_queue_depth),
            "RAY_TPU_DECENTRALIZED_DISPATCH":
                "1" if self.config.decentralized_dispatch else "0",
            "RAY_TPU_LEASE_SLOTS": str(self.config.lease_slots),
            "RAY_TPU_LEASE_TTL_S": str(self.config.lease_ttl_s),
            "RAY_TPU_LEASE_RENEW_TASKS":
                str(self.config.lease_renew_tasks),
            "RAY_TPU_LEASE_SPILLBACK_DEPTH":
                str(self.config.lease_spillback_depth),
            # Serving knobs: the continuous-batching switch is read in
            # the REPLICA worker, the autoscale windows in the
            # controller worker — both only see _system_config through
            # this env namespace.
            "RAY_TPU_CONTINUOUS_BATCHING":
                "1" if self.config.continuous_batching else "0",
            # Serving memory plane: all three are read in the REPLICA
            # worker (paged admission + prefix reuse + draft length).
            "RAY_TPU_PAGED_KV":
                "1" if self.config.paged_kv else "0",
            "RAY_TPU_PREFIX_CACHING":
                "1" if self.config.prefix_caching else "0",
            "RAY_TPU_SPECULATIVE_K": str(self.config.speculative_k),
            "RAY_TPU_SERVE_METRIC_LOOKBACK_S":
                str(self.config.serve_metric_lookback_s),
            "RAY_TPU_SERVE_DOWNSCALE_DELAY_S":
                str(self.config.serve_downscale_delay_s),
            # Disaggregated serving: the split switch is read by the
            # controller (pool twin deploys), replicas (prefill-only /
            # chain-import step paths) and handles/proxies (affinity
            # routing); the stripe threshold wherever a prefill replica
            # pushes a chain.
            "RAY_TPU_DISAGGREGATED_SERVING":
                "1" if self.config.disaggregated_serving else "0",
            "RAY_TPU_KV_STREAM_STRIPE_THRESHOLD":
                str(self.config.kv_stream_stripe_threshold),
            "RAY_TPU_PREFIX_AFFINITY":
                "1" if self.config.prefix_affinity else "0",
            # Fault-tolerance knobs: workers keep their own bounded
            # lineage for direct-path tasks and arm actor checkpoint
            # hooks — both must see the driver's _system_config.
            "RAY_TPU_RECOVERY": "1" if self.config.recovery else "0",
            # The legacy lineage escape hatch gates every DirectCaller's
            # worker-side table exactly like the head's — a driver
            # turning it off via _system_config must reach them (found
            # by protocheck RTL504: the knob was read in workers but
            # plumbed to neither spawn path).
            "RAY_TPU_LINEAGE_ENABLED":
                "1" if self.config.lineage_enabled else "0",
            "RAY_TPU_LINEAGE_BYTES_BUDGET":
                str(self.config.lineage_bytes_budget),
            "RAY_TPU_ACTOR_CHECKPOINT_INTERVAL_S":
                str(self.config.actor_checkpoint_interval_s),
            # Elastic-pod knobs: the drain switch/deadline also reach
            # node agents via the agent_ack config dict (their env wins
            # per node); riding the worker env keeps the whole cluster
            # on the driver's _system_config.
            "RAY_TPU_ELASTIC_DRAIN":
                "1" if self.config.elastic_drain else "0",
            "RAY_TPU_DRAIN_DEADLINE_S":
                str(self.config.drain_deadline_s),
            "RAY_TPU_DRAIN_MIGRATE_MAX_BYTES":
                str(self.config.drain_migrate_max_bytes),
            "RAY_TPU_SPOT_FALLBACK_THRESHOLD":
                str(self.config.spot_fallback_threshold),
            # Head-failover knobs: workers park + re-dial + re-register
            # across a head restart (the switch and both windows are
            # read in the worker process).
            "RAY_TPU_HEAD_FAILOVER":
                "1" if self.config.head_failover else "0",
            "RAY_TPU_HEAD_RECONNECT_GRACE_S":
                str(self.config.head_reconnect_grace_s),
            "RAY_TPU_HEAD_REREGISTER_TIMEOUT_S":
                str(self.config.head_reregister_timeout_s),
            # Failure-detection knobs (gray failures): workers read the
            # master switch, the wire deadlines/retries, and the
            # heartbeat period; the head-side suspicion knobs ride too
            # so a worker-spawned subprocess that becomes a driver sees
            # one coherent config.
            "RAY_TPU_FAILURE_DETECTION":
                "1" if self.config.failure_detection else "0",
            "RAY_TPU_NET_STALL_TIMEOUT_S":
                str(self.config.net_stall_timeout_s),
            "RAY_TPU_NET_CONNECT_TIMEOUT_S":
                str(self.config.net_connect_timeout_s),
            "RAY_TPU_NET_RETRY_COUNT":
                str(self.config.net_retry_count),
            "RAY_TPU_NET_RETRY_BACKOFF_BASE_MS":
                str(self.config.net_retry_backoff_base_ms),
            "RAY_TPU_HEALTH_CHECK_PERIOD_S":
                str(self.config.health_check_period_s),
            "RAY_TPU_HEALTH_CHECK_TIMEOUT_S":
                str(self.config.health_check_timeout_s),
            "RAY_TPU_HEALTH_CHECK_FAILURE_THRESHOLD":
                str(self.config.health_check_failure_threshold),
            "RAY_TPU_HEALTH_CHECK_INITIAL_DELAY_S":
                str(self.config.health_check_initial_delay_s),
        }

    def _spawn_worker(self, node: NodeState, env_key: str,
                      rec: Optional[TaskRecord], tpu_chips) -> WorkerHandle:
        import subprocess
        import sys

        worker_id = WorkerID.from_random()
        if node.agent is not None:
            return self._spawn_worker_via_agent(node, env_key, rec,
                                                tpu_chips, worker_id)
        env = dict(os.environ)
        if rec is not None:
            renv = rec.spec.get("runtime_env") or {}
            env.update(renv.get("env_vars", {}))
            if renv.get("working_dir"):
                env["RAY_TPU_WORKING_DIR_PKG"] = \
                    self._package_working_dir(renv["working_dir"])
            if renv.get("pip"):
                # Worker builds/reuses the requirements venv and
                # re-execs under it (runtime_env_pip.py).
                import json as _json

                env["RAY_TPU_PIP_SPEC"] = _json.dumps(renv["pip"])
        # A granted worker sees exactly its cards; a CPU worker sees none.
        # Hard override (not setdefault): the driver's own
        # CUDA_VISIBLE_DEVICES must not leak a card into a CPU worker.
        env["CUDA_VISIBLE_DEVICES"] = _cuda_visible_devices(tpu_chips)
        pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        # Workers must import what the driver can: cloudpickle serializes
        # module-level functions by reference, so the driver's sys.path
        # (minus interpreter-internal entries) rides along (the reference's
        # workers likewise inherit the job's environment/working dir).
        import sys as _sys
        extra = [p for p in _sys.path
                 if p and p not in (pkg_root,) and os.path.isdir(p)]
        env["PYTHONPATH"] = os.pathsep.join(
            [pkg_root] + extra + ([env["PYTHONPATH"]]
                                  if env.get("PYTHONPATH") else []))
        env.update(self._worker_config_env())
        env.update({
            "RAY_TPU_WORKER_ID": worker_id.hex(),
            "RAY_TPU_ENV_KEY": env_key,
            "RAY_TPU_ADDRESS": self._listener.address,
            "RAY_TPU_AUTHKEY": self._authkey.hex(),
            "RAY_TPU_SESSION": self.session_id,
            "RAY_TPU_SHM_DIR_OVERRIDE": self.shm._dir,
            "RAY_TPU_NODE_ID": node.node_id.hex(),
            "RAY_TPU_JOB_ID": self.job_id.hex(),
            # Per-process slice of the node store cap + the shared spill
            # dir (per-node spilling; local_object_manager.h:41).
            "RAY_TPU_STORE_BYTES": str(self.config.object_store_memory),
            "RAY_TPU_SPILL_DIR_OVERRIDE": self.spill_dir,
        })
        env["RAY_TPU_STORE_ID"] = self.store_id
        # Worker output goes to a per-worker file (reference: workers log
        # under the session dir; log_monitor.py tails them to the
        # driver).  The head's monitor thread re-prints new lines with a
        # worker prefix when log_to_driver is on.
        log_dir = os.path.join(self._sock_dir, "logs")
        os.makedirs(log_dir, exist_ok=True)
        log_f = open(os.path.join(log_dir, f"worker-{worker_id.hex()}.log"),
                     "ab", buffering=0)
        proc = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch._private.worker_main"],
            env=env, cwd=pkg_root, stdout=log_f,
            stderr=subprocess.STDOUT)
        log_f.close()  # the child holds its own fd
        w = WorkerHandle(worker_id, None, proc, node, env_key, tpu_chips)
        node.all_workers[id(w)] = w
        self._pending_workers[worker_id.hex()] = w
        return w

    def _spawn_worker_via_agent(self, node: NodeState, env_key: str,
                                rec, tpu_chips, worker_id) -> WorkerHandle:
        """Lease a worker on an out-of-process node: the agent forks it
        there; the worker dials our TCP listener directly (reference:
        raylet WorkerPool::StartWorkerProcess, worker_pool.h:156)."""
        overrides = {}
        if rec is not None:
            renv = rec.spec.get("runtime_env") or {}
            overrides.update(renv.get("env_vars", {}))
            if renv.get("working_dir"):
                overrides["RAY_TPU_WORKING_DIR_PKG"] = \
                    self._package_working_dir(renv["working_dir"])
            if renv.get("pip"):
                import json as _json

                overrides["RAY_TPU_PIP_SPEC"] = _json.dumps(renv["pip"])
        overrides["CUDA_VISIBLE_DEVICES"] = _cuda_visible_devices(tpu_chips)
        overrides.update(self._worker_config_env())
        overrides.update({
            "RAY_TPU_WORKER_ID": worker_id.hex(),
            "RAY_TPU_ENV_KEY": env_key,
            "RAY_TPU_ADDRESS": self.tcp_address,
            "RAY_TPU_AUTHKEY": self._authkey.hex(),
            "RAY_TPU_SESSION": self.session_id,
            "RAY_TPU_NODE_ID": node.node_id.hex(),
            "RAY_TPU_JOB_ID": self.job_id.hex(),
        })
        w = WorkerHandle(worker_id, None, None, node, env_key, tpu_chips)
        node.all_workers[id(w)] = w
        self._pending_workers[worker_id.hex()] = w
        node.agent.send(("spawn_worker", worker_id.hex(), overrides))  # noqa: RTL604 -- spawn is a rare, already process-fork-slow path; one small control frame
        return w

    def _object_server_loop(self):
        """The head's object server: same shared accept loop the node
        agents run, serving segments from the head's own store."""
        object_transfer.accept_loop(self._obj_listener, self.shm,
                                    lambda: self._stopped,
                                    "ray_tpu_torch-objconn")

    def _adv_caps(self, caps) -> tuple:
        """Advertised object-server verbs, with the put verbs withheld
        while ``direct_puts`` is off — pushers are capability-gated, so
        not advertising IS the off switch (the legacy put_parts path,
        byte-identical, every direct-put counter zero)."""
        caps = tuple(caps or ())
        if self.config.direct_puts:
            return caps
        return tuple(c for c in caps
                     if c not in object_transfer.PUT_CAPS)

    def _accept_loop(self, listener):
        while not self._stopped:
            try:
                conn = listener.accept()
                protocol.enable_nodelay(conn)
            except (OSError, EOFError, multiprocessing.AuthenticationError):
                if self._stopped:
                    return
                continue
            try:
                msg = protocol.recv(conn)
            except (EOFError, OSError):
                continue
            # Admission waits for __init__ (incl. snapshot restore) to
            # finish: reconnecting peers race a restarting head's boot.
            self._boot_ready.wait(timeout=60)
            if msg[0] == "agent_ready":
                self._register_agent(conn, msg[1])
                continue
            if msg[0] == "reregister":
                # A surviving worker of the previous head incarnation
                # re-dialed after our restart: re-admit it under its old
                # identity and reconcile what it re-advertises (held
                # leases, queued/running tasks, owned objects, its actor
                # incarnation).  Reference: workers reconnecting across
                # GCS restart, gcs_failover_worker_reconnect_timeout.
                self._handle_worker_reregister(conn, msg[1])
                continue
            if msg[0] == "client_ready":
                # External process attaching in client mode (reference:
                # Ray Client, python/ray/util/client/) — a worker-protocol
                # connection that never takes a lease.
                w = WorkerHandle(WorkerID.from_random(), None, None,
                                 self.head_node, "client", [])
                w.attach(conn)
                w.ready.set()
                with self.lock:
                    self._conn_to_worker[conn] = w
                # The ack's info dict is the client's direct-put
                # bootstrap: with the head's store identity + object-
                # server address + advertised verbs, a large client put
                # streams straight into the head's store over the data
                # plane.  Old clients ignore the extra element; a new
                # client against an old (2-tuple-ack) head keeps the
                # legacy put_parts path.
                protocol.send(conn, ("client_ack", self.session_id, {
                    "store_id": self.store_id,
                    "object_addr": self.object_addr,
                    "object_caps": list(self._adv_caps(
                        object_transfer.CAPS)),
                }))
                threading.Thread(target=self._worker_reader,
                                 args=(conn, w), daemon=True,
                                 name="ray_tpu_torch-rx-client").start()
                continue
            if msg[0] != "ready":
                conn.close()
                continue
            worker_id_hex = msg[1]
            with self.lock:
                w = self._pending_workers.pop(worker_id_hex, None)
                if w is None or w.dead:
                    conn.close()
                    continue
                if len(msg) > 3:
                    w.direct_addr = msg[3]
                # Spawned by this head: same build, speaks the lease
                # plane (unsolicited grants included).
                w.lease_caps = True
                # First suspicion deadline gets the initial-delay slack
                # (boot/env/JIT warmup legitimately delay heartbeats).
                w.last_seen = (time.monotonic()
                               + self.config.health_check_initial_delay_s)
                self._conn_to_worker[conn] = w
                self._workers_by_hex[worker_id_hex] = w
            # Attach OUTSIDE the runtime lock: the outbox flush is a
            # blocking socket write, and holding the big lock across it
            # stalled every other acquirer on one slow worker conn
            # (found by lockgraph RTL604).  Sends racing the attach just
            # park in the outbox under send_lock — order is preserved.
            try:
                w.attach(conn)
            except Exception:
                self._on_worker_death(w)
                continue
            w.ready.set()
            # One reader thread per connection (replaces the old select
            # loop): recv/unpickle for different workers runs in parallel,
            # and a burst from one worker is drained back-to-back instead
            # of one message per poll cycle.
            threading.Thread(target=self._worker_reader, args=(conn, w),
                             daemon=True, name="ray_tpu_torch-rx").start()

    def _register_agent(self, conn, info: dict):
        """A node agent dialed in: add its node to the cluster (reference:
        NodeManager::RegisterGcs, gcs_node_manager.h:41 HandleRegisterNode).
        """
        agent = AgentHandle(conn, info["store_id"], info["shm_dir"], info)
        agent.last_seen = (time.monotonic()
                           + self.config.health_check_initial_delay_s)
        resources = dict(info.get("resources") or {"CPU": 1.0})
        resources.setdefault("memory", float(2 ** 33))
        with self.lock:
            node = None
            if info.get("reconnect"):
                # Agent of a previous head incarnation re-dialing after
                # our restart: re-claim its restored node under the OLD
                # id so its surviving workers' node identity stays
                # valid.  available is NOT reset — adopted actors may
                # have acquired their slots before the agent returned.
                self._awaiting_nodes.pop(info["store_id"], None)
                for cand in self.nodes.values():
                    if cand.store_id == info["store_id"] \
                            and cand.agent is None \
                            and cand is not self.head_node:
                        node = cand
                        break
                if node is not None:
                    node.alive = True
                    node.agent = agent
                    self.reconnected_nodes += 1
            if node is None:
                node = self._add_node_locked(resources,
                                             labels=info.get("labels"),
                                             agent=agent,
                                             store_id=info["store_id"])
            agent.node = node
            self._agents[agent.store_id] = agent
            self._conn_to_agent[conn] = agent
            # Ack INSIDE the lock: the moment the node is registered, any
            # thread holding the lock may dispatch a spawn_worker to this
            # agent — the ack must be first on the wire (the agent's
            # handshake asserts it).
            # The ack carries head config the agent must mirror (the
            # memory monitor's knobs — _system_config applies cluster-
            # wide, not just to the head's own sampler).
            agent.send(  # noqa: RTL402 -- one-time handshake; the ack must beat any locked spawn_worker onto this conn
                ("agent_ack", node.node_id.hex(), self.session_id,
                 {"memory_monitor_threshold":
                      self.config.memory_monitor_threshold,
                  "memory_monitor_interval_s":
                      self.config.memory_monitor_interval_s,
                  "memory_monitor_test_file":
                      self.config.memory_monitor_test_file,
                  # Failover knobs the agent mirrors (its own env wins
                  # when explicitly set — the per-node escape hatch):
                  # keep-workers vs legacy teardown on head EOF, and
                  # the re-dial grace window.
                  "head_failover": self.config.head_failover,
                  "head_reconnect_grace_s":
                      self.config.head_reconnect_grace_s,
                  "agent_reconnect": self.config.agent_reconnect,
                  # Elastic pods: the drain verbs this head understands
                  # (the agent gates preempt_notice on membership — an
                  # old head is never probed) plus the knobs the agent
                  # mirrors for its self-drain deadline.
                  "drain_caps": (["preempt_notice", "drain_node"]
                                 if self.config.elastic_drain else []),
                  "elastic_drain": self.config.elastic_drain,
                  "drain_deadline_s": self.config.drain_deadline_s,
                  # Failure detection: the agent mirrors the master
                  # switch and heartbeat cadence (its env wins per
                  # node) so an off-switch cluster sends zero
                  # heartbeats and a tuned period applies everywhere.
                  "failure_detection": self.config.failure_detection,
                  "health_check_period_s":
                      self.config.health_check_period_s}))
        threading.Thread(target=self._agent_reader, args=(conn, agent),
                         daemon=True, name="ray_tpu_torch-rx-agent").start()
        with self.lock:
            self._dispatch_locked()

    def _handle_worker_reregister(self, conn, info: dict):
        """A worker process that survived the previous head's death
        re-dialed: re-admit it under its OLD identity (worker id, node,
        env key — the process, its store segments, and its direct-push
        endpoint are all still live) and reconcile its claims."""
        worker_hex = info.get("worker_id", "")
        node_hex = info.get("node_id", "")
        with self.lock:
            node = self._node_by_hex_locked(node_hex)
            refused = node is None or not self.config.head_failover
        if refused:
            # Unknown node (fresh head, no snapshot) or duplicate:
            # refuse — the worker exits, which is the pre-failover
            # behavior and the correct one for a cluster that did not
            # restore.  (Outside the lock: nobody holds this conn yet.)
            try:
                protocol.send(conn, ("reregister_nack",))
            except Exception:
                pass
            try:
                conn.close()
            except Exception:
                pass
            return
        try:
            w = WorkerHandle(
                WorkerID(bytes.fromhex(worker_hex)), None, None,
                node, info.get("env_key") or "default",
                list(info.get("tpu_chips") or []))
        except ValueError:
            try:
                conn.close()
            except Exception:
                pass
            return
        w.lease_caps = True
        if info.get("direct_addr"):
            w.direct_addr = info["direct_addr"]
        with self.lock:
            stale = self._workers_by_hex.get(worker_hex)
            if stale is not None and not stale.dead:
                # The SAME process re-dialing again: its previous
                # reregister was accepted but the ack never arrived
                # (conn broke in the window).  The retry supersedes the
                # stale handle — nacking it would exit a live worker
                # the head believes it adopted.  Detach the stale handle
                # without the death path (nothing died), transfer its
                # claims, and re-park its actor for re-adoption below.
                stale.dead = True
                self._conn_to_worker.pop(stale.conn, None)
                stale.node.all_workers.pop(id(stale), None)
                for lst in stale.node.idle_workers.values():
                    if stale in lst:
                        lst.remove(stale)
                try:
                    stale.conn.close()
                except Exception:
                    pass
                if stale.lease_req is not None and not stale.released:
                    stale.node.release(stale.lease_req)
                stale.lease_req = None
                if stale.actor_id is not None:
                    actor = self.actors.get(stale.actor_id)
                    if actor is not None and actor.worker is stale:
                        actor.worker = None
                        actor.status = RESTARTING
                        self._restored_actors.setdefault(
                            stale.actor_id, {})
                for tid_bin, rec in stale.inflight.items():
                    rec.worker = w
                    w.inflight[tid_bin] = rec
                stale.inflight.clear()
            # Ack straight on the conn BEFORE attach: registration under
            # the lock means another thread may send through the handle
            # the moment it lands in the tables — the ack must be first
            # on the wire (the worker recv()s it inline).
            try:
                protocol.send(conn, ("reregister_ack", self.session_id))  # noqa: RTL402 -- one-time handshake; the ack must beat any locked send onto this conn
            except Exception:
                return
            w.attach(conn)
            w.ready.set()
            self._conn_to_worker[conn] = w
            self._workers_by_hex[worker_hex] = w
            node.all_workers[id(w)] = w
            self.reregistered_workers += 1
            self._apply_reregister_claims_locked(w, info)
            if not w.inflight and w.actor_id is None \
                    and w.client_lease is None:
                w.idle_since = time.monotonic()
                node.idle_workers.setdefault(w.env_key, []).append(w)
        threading.Thread(target=self._worker_reader, args=(conn, w),
                         daemon=True, name="ray_tpu_torch-rx").start()
        with self.lock:
            self._dispatch_locked()

    def _apply_reregister_claims_locked(self, w: WorkerHandle,
                                        info: dict):
        """Reconcile one re-registration's claims against the restored
        tables: the actor incarnation it hosts, the owned objects it
        re-advertises, its queued/running head-dispatched tasks, and the
        peer leases it holds."""
        aid = info.get("actor_id")
        if aid:
            actor = self.actors.get(aid)
            # Adoption only while the actor is still PARKED: once a cold
            # restore claimed it (popped from _restored_actors), this
            # surviving incarnation is stale — adopting it too would
            # split the actor across two workers.
            if actor is not None and aid in self._restored_actors \
                    and actor.worker is None and actor.status != DEAD:
                # Adoption: the incarnation (and its in-memory state)
                # survived — no __init__ re-run, no checkpoint restore.
                actor.status = ALIVE
                actor.worker = w
                actor.node = w.node
                w.actor_id = aid
                req = actor.options.get("resources") or {"CPU": 1.0}
                w.lease_req = dict(req)
                w.node.acquire(req)
                if not actor.created_future.done():
                    actor.created_future.set_result(True)
                self._restored_actors.pop(aid, None)
                self.adopted_actors += 1
                self._gcs_dirty += 1
                self._pump_actor_locked(actor)
            elif actor is None:
                # Created after the last snapshot: adopt a minimal
                # record so addressing/kill/death paths keep working.
                actor = ActorState(aid)
                actor.status = ALIVE
                actor.worker = w
                actor.node = w.node
                req = dict(info.get("resources") or {"CPU": 1.0})
                actor.options = {"resources": req}
                actor.created_future.set_result(True)
                self.actors[aid] = actor
                w.actor_id = aid
                w.lease_req = dict(req)
                w.node.acquire(req)
                self.adopted_actors += 1
        for item in info.get("objects", ()):
            b, ok, descr, nested = item[0], item[1], item[2], item[3]
            oid = ObjectID(b)
            st = self.objects.get(oid)
            if st is None:
                st = self.objects[oid] = ObjectState()
                st.pins = 1        # failover pin (restore semantics)
                st.worker_refs = 1  # the exporter's aggregate ref
            if st.status == PENDING and descr is not None:
                self._complete_object_locked(oid, descr, bool(ok))
            st.shipped = True
        for t in info.get("tasks", ()):
            tid_bin, num_returns, is_actor_task = t[0], t[1], t[2]
            if tid_bin in self.tasks:
                continue
            spec = {"task_id": tid_bin, "num_returns": num_returns,
                    "name": "failover_readopted", "resources": {},
                    "args": [], "kwargs": {}}
            rec = TaskRecord(spec, {}, 0)
            rec.dispatched = True
            rec.worker = w
            rec.node = w.node
            tid = TaskID(tid_bin)
            for i in range(num_returns):
                oid = tid.object_id(i)
                if oid not in self.objects:
                    self.objects[oid] = ObjectState(tid)
            self.tasks[tid_bin] = rec
            if is_actor_task and w.actor_id is not None:
                actor = self.actors.get(w.actor_id)
                if actor is not None:
                    rec.actor_id = w.actor_id
                    actor.inflight[tid_bin] = rec
            else:
                w.inflight[tid_bin] = rec
        restored_req = {row[0]: row[2] for row in self._restored_leases}
        now = time.monotonic()
        ttl = self.config.lease_ttl_s
        for wid in info.get("held_leases", ()):
            lw = self._workers_by_hex.get(wid)
            req = restored_req.get(wid) or {"CPU": 1.0}
            if lw is not None and not lw.dead \
                    and lw.client_lease is None and lw.actor_id is None:
                lw.client_lease = w
                lw.lease_req = dict(req)
                lw.node.acquire(lw.lease_req)
                lw.lease_expiry = (now + ttl) if ttl > 0 else None
                # A worker that re-registered before its holder was
                # pooled as idle; a leased worker must not be double-
                # booked by head dispatch (the normal grant path pops
                # it out of idle the same way).
                for lst in lw.node.idle_workers.values():
                    if lw in lst:
                        lst.remove(lw)
            else:
                # The leased worker hasn't re-registered yet: park the
                # claim; its own reregister consumes it below.
                self._pending_lease_claims[wid] = (w.worker_id.hex(),
                                                   req)
        claim = self._pending_lease_claims.pop(
            w.worker_id.hex(), None)
        if claim is not None and w.actor_id is None and not w.inflight \
                and w.client_lease is None:
            holder = self._workers_by_hex.get(claim[0])
            if holder is not None and not holder.dead:
                w.client_lease = holder
                w.lease_req = dict(claim[1] or {"CPU": 1.0})
                w.node.acquire(w.lease_req)
                w.lease_expiry = (now + ttl) if ttl > 0 else None

    # How long an unfulfillable client lease request is parked at the head
    # before an empty grant is returned (the caller then falls back to the
    # head path for a bounded chunk and re-requests).  The reference's
    # raylet queues RequestWorkerLease indefinitely; we bound it so a
    # zero-capacity cluster still makes progress via the head scheduler.
    CLIENT_LEASE_PARK_S = 1.0

    def _grant_client_leases(self, lessee: WorkerHandle, rid,
                             resources: Dict[str, float], n: int,
                             opts: Optional[dict] = None):
        """Lease up to ``n`` workers to a peer caller for direct task
        push.  The head acquires node resources (exactly like a dispatch
        lease) but never sees the tasks; the caller returns the lease via
        ("lease_return", ...) or by dying (reference: raylet
        RequestWorkerLease / ReturnWorker).

        ``opts`` (lease-plane capability gate): {"v": 1} selects the
        dict-shaped reply carrying per-worker node ids, the granted slot
        count, the TTL the holder must renew within, and a next-best-node
        hint; {"hint": node_hex} steers the grant toward that node (the
        spillback hint round-tripping back, reference hybrid policy).
        Absent/None keeps the legacy bare-list reply.

        Zero-grant requests are PARKED, not refused: the request waits
        (bounded) for resources to free, exactly like the raylet's lease
        queue — an immediate empty reply made every concurrent caller dump
        its whole queue on the head the moment leases momentarily ran out,
        which is what collapsed multi-client task throughput."""
        recovery.syncpoint("lease_grant")
        req = {k: float(v) for k, v in resources.items()}
        with self.lock:
            granted = self._try_client_grant_locked(
                lessee, req, n, hint=(opts or {}).get("hint"))
            if not granted:
                park = {"lessee": lessee, "rid": rid, "req": req, "n": n,
                        "opts": opts,
                        "deadline": time.monotonic()
                        + self.CLIENT_LEASE_PARK_S}
                self._pending_client_leases.append(park)
                t = threading.Timer(self.CLIENT_LEASE_PARK_S + 0.02,
                                    self._sweep_client_leases)
                t.daemon = True
                t.start()
                return
        self._finish_client_grant(lessee, rid, granted, opts=opts)

    def _node_by_hex_locked(self, node_hex) -> Optional[NodeState]:
        if not node_hex:
            return None
        for nid in self.node_order:
            if nid.hex() == node_hex:
                return self.nodes[nid]
        return None

    def _try_client_grant_locked(self, lessee: WorkerHandle,
                                 req: Dict[str, float], n: int,
                                 hint=None) -> List[WorkerHandle]:
        hint_node = self._node_by_hex_locked(hint)
        granted: List[WorkerHandle] = []
        for _ in range(max(1, n)):
            pseudo = TaskRecord(
                {"resources": req, "num_returns": 0,
                 "name": "client_lease", "task_id": b""}, req, 0)
            if hint_node is not None and hint_node.alive \
                    and hint_node.can_fit(req):
                # Spillback hint: the holder just bounced off an
                # oversubscribed node — place the replacement lease where
                # the head said the capacity was.
                node = hint_node
            else:
                node = self._pick_node_locked(pseudo)
            if node is None:
                # Client leases are transient: blocked workers (usually
                # the requesting clients themselves, parked in ray.get)
                # lend their slots here too.
                node = self._lend_node_locked(pseudo)
            if node is None:
                break
            node.acquire(req)
            pseudo.node = node
            w = self._lease_worker_locked(node, pseudo, [])
            w.lease_req = dict(req)
            w.client_lease = lessee
            granted.append(w)
        return granted

    def _spill_hint_locked(self, req: Dict[str, float],
                           granted: List[WorkerHandle]) -> Optional[str]:
        """Next-best node for this class BESIDES the ones just granted on
        — shipped with the grant so a holder bouncing off an
        oversubscribed worker knows where to ask next (the reference
        hybrid policy's spillback target)."""
        used = {id(w.node) for w in granted}
        for nid in self.node_order:
            node = self.nodes[nid]
            if node.alive and id(node) not in used and node.can_fit(req):
                return node.node_id.hex()
        return None

    def _service_client_leases_locked(self):
        """Try parked client lease requests against freed capacity; called
        from _dispatch_locked (which runs on every resource release).
        Successful grants finish on a thread (they wait for worker spawn);
        expired requests get their empty reply so the caller can fall
        back."""
        if not self._pending_client_leases:
            return
        now = time.monotonic()
        still: deque = deque()
        while self._pending_client_leases:
            p = self._pending_client_leases.popleft()
            if p["lessee"].dead:
                continue
            opts = p.get("opts")
            granted = self._try_client_grant_locked(
                p["lessee"], p["req"], p["n"],
                hint=(opts or {}).get("hint"))
            if granted:
                self._finish_client_grant(p["lessee"], p["rid"], granted,
                                          opts=opts)
            elif now >= p["deadline"]:
                empty = ({"grants": []} if opts and opts.get("v")
                         else [])
                self._queue_send(p["lessee"], ("reply", p["rid"], empty))
            else:
                still.append(p)
        self._pending_client_leases = still

    def _sweep_client_leases(self):
        with self.lock:
            self._service_client_leases_locked()

    def _finish_client_grant(self, lessee: WorkerHandle, rid,
                             granted: List[WorkerHandle],
                             opts: Optional[dict] = None,
                             klass_items=None):
        """Wait for the granted workers' handshakes off-thread, then ship
        the grant.  Three reply shapes: the legacy bare list (no opts),
        the v1 dict (opts["v"]), and — when ``rid`` is None — an
        unsolicited ("lease_grant", ...) push piggybacked on a
        head-brokered submit burst (``klass_items`` names the holder-side
        scheduling class it belongs to)."""
        v1 = bool(opts and opts.get("v")) or rid is None
        cfg = self.config
        ttl = (cfg.lease_ttl_s
               if v1 and cfg.decentralized_dispatch else 0.0)
        slots = min(cfg.lease_slots, cfg.max_tasks_in_flight_per_worker)

        def finish():
            # One shared deadline across the batch (not 15s each): a
            # stuck spawn must not serialize into minutes of stall.
            deadline = time.monotonic() + 15.0
            out, failed = [], []
            for w in granted:
                left = max(0.0, deadline - time.monotonic())
                if (w.ready.wait(timeout=left) and w.direct_addr
                        and not w.dead):
                    out.append((w.worker_id.hex(), tuple(w.direct_addr),
                                w.node.node_id.hex()))
                else:
                    failed.append(w)
            hint = None
            with self.lock:
                for w in failed:
                    w.client_lease = None
                    if not w.dead:
                        self._end_lease_locked(w)
                if failed:
                    self._dispatch_locked()
                ok = [w for w in granted if w not in failed]
                if cfg.decentralized_dispatch:
                    self.lease_grants += len(ok)
                    if ttl > 0:
                        expiry = time.monotonic() + ttl
                        for w in ok:
                            w.lease_expiry = expiry
                if v1 and ok:
                    hint = self._spill_hint_locked(ok[0].lease_req or {},
                                                   ok)
            if rid is None:
                worker_send_safe(lessee, ("lease_grant", klass_items, out,  # noqa: RTL503 -- rid-None pushes are built only by _maybe_offer_lease, which gates on worker.lease_caps; solicited grants ride the "reply" verb
                                          slots, ttl, hint))
            elif v1:
                worker_send_safe(lessee, ("reply", rid,
                                          {"grants": out, "slots": slots,
                                           "ttl": ttl, "hint": hint}))
            else:
                worker_send_safe(
                    lessee, ("reply", rid, [g[:2] for g in out]))

        threading.Thread(target=finish, daemon=True,
                         name="ray_tpu_torch-lease-grant").start()

    # Unsolicited bulk grants: minimum direct-eligible specs in one
    # head-brokered burst before the head piggybacks a lease grant on it,
    # and the per-(lessee, class) re-offer interval.
    LEASE_OFFER_MIN = 4
    LEASE_OFFER_INTERVAL_S = 0.25

    def _maybe_offer_lease(self, worker: WorkerHandle, specs: List[dict]):
        """A worker/client just pushed a submit burst through the head.
        If the burst is full of direct-eligible work, that means its
        holder is short on leases (starvation reroute or first contact):
        grant it a bulk lease on matching execution slots NOW, piggybacked
        on this very exchange, so the NEXT burst rides the direct plane
        instead of the head (reference: the raylet granting leases from
        the queue that the spillback landed in).

        Capability-gated: offered only to peers known to handle the
        ("lease_grant", ...) verb — a peer that silently dropped it
        would leak the acquired leases (PR-3 convention: new verbs are
        never sent to a peer that would ignore them)."""
        if not self.config.decentralized_dispatch or not worker.lease_caps:
            return
        elig = [s for s in specs
                if "actor_id" not in s
                and not s.get("scheduling_strategy")
                and not s.get("runtime_env")
                # Ref-carrying specs reached the head because their refs
                # are HEAD-owned — the holder's eligible() will keep
                # routing them here regardless of leases, so granting on
                # their account would be pure worker churn.
                and not any(a and a[0] == "ref"
                            for a in s.get("args", ()))
                and not any(v and v[0] == "ref"
                            for v in (s.get("kwargs") or {}).values())
                and all(k == "CPU"
                        for k in (s.get("resources") or {"CPU": 1.0}))]
        if not elig:
            return
        # Per-class accumulation: a mixed burst must not credit the
        # first spec's class with the whole count (oversized grants for
        # one class, starvation for the rest).
        by_klass: Dict[tuple, int] = {}
        for s in elig:
            req = {k: float(v) for k, v in (s.get("resources")
                                            or {"CPU": 1.0}).items()}
            key = tuple(sorted(req.items()))
            by_klass[key] = by_klass.get(key, 0) + 1
        now = time.monotonic()
        slots = max(1, min(self.config.lease_slots,
                           self.config.max_tasks_in_flight_per_worker))
        offers = []
        with self.lock:
            for klass_items, count in by_klass.items():
                ent = worker.lease_offer_ts.get(klass_items)
                if ent is None:
                    ent = worker.lease_offer_ts[klass_items] = [0.0, 0]
                # Accumulate across bursts: a starved holder reroutes
                # specs as SINGLE ("submit", ...) messages, so the offer
                # threshold must trigger on their sum, not any one
                # message's size.  These O(1) checks run FIRST — the
                # cluster scans below are paid at most once per offer
                # interval per class, never per submit message on the
                # contended fan-in path.
                ent[1] += count
                if ent[1] < self.LEASE_OFFER_MIN \
                        or now - ent[0] < self.LEASE_OFFER_INTERVAL_S:
                    continue
                # Redundant-grant guard: a holder with a PARKED
                # lease_req is already first in line for freed capacity,
                # and one that still holds leases is not starved — an
                # unsolicited grant on top would just churn extra worker
                # processes.  Reset the accumulator: this burst is
                # already being served.
                if any(p["lessee"] is worker
                       for p in self._pending_client_leases) \
                        or any(w.client_lease is worker and not w.dead
                               for node in self.nodes.values()
                               for w in node.all_workers.values()):
                    ent[0], ent[1] = now, 0
                    continue
                n = min(8, max(1, ent[1] // slots))
                ent[0], ent[1] = now, 0
                granted = self._try_client_grant_locked(
                    worker, dict(klass_items), n)
                if granted:
                    offers.append((klass_items, granted))
        for klass_items, granted in offers:
            self._finish_client_grant(worker, None, granted,
                                      klass_items=klass_items)

    def _send_task(self, worker: WorkerHandle, rec: TaskRecord):
        # Chaos syncpoint (one global None-check when unarmed): lets the
        # harness kill a worker/agent deterministically at the n-th
        # dispatch instead of racing wall-clock timers.
        recovery.syncpoint("dispatch")
        spec = rec.spec
        # Substitute resolved dependencies with value descriptors.
        def subst(a):
            if a[0] == "ref":
                oid = ObjectID(a[1])
                st = self.objects.get(oid)
                if st is None:
                    raise exc.ObjectLostError(object_id=oid.hex(),
                                              owner="driver",
                                              phase="dispatch")
                if st.status == ERRORED:
                    return st.descr  # error propagates to the task
                st.shipped = True
                return st.descr
            return a

        try:
            args = [subst(a) for a in spec["args"]]
            kwargs = {k: subst(a) for k, a in spec.get("kwargs", {}).items()}
        except exc.ObjectLostError as e:
            self._fail_task_locked(rec, e)
            return False
        # Dependency errors: fail the task without running it (reference:
        # task_manager.cc marks children failed on dep error).
        for d in list(args) + list(kwargs.values()):
            if d is not None and d[0] == protocol.ERROR:
                self._fail_task_locked(
                    rec, serialization.loads_inline(d[1]), dispatchable=False)  # noqa: RTL604 -- inline ERROR payloads are bounded-small; no socket IO
                return False
        msg_task = {
            "task_id": spec["task_id"],
            "func_id": spec.get("func_id"),
            "args": args,
            "kwargs": kwargs,
            "num_returns": spec["num_returns"],
            "name": spec.get("name", "task"),
            "resources": rec.requirements,
        }
        if "actor_id" in spec:
            msg_task["actor_id"] = spec["actor_id"]
            msg_task["method"] = spec["method"]
        fileno = id(worker)
        sent = self.worker_funcs.setdefault(fileno, set())
        func_id = spec.get("func_id")
        if func_id and func_id not in sent:
            worker.queue_msg(("func", func_id, self.functions[func_id]))
            sent.add(func_id)
        if rec.is_actor_creation:
            actor = self.actors[rec.actor_id]
            # Restartable-actor checkpointing: the worker arms the
            # __ray_save__ hook only when recovery is on AND the actor
            # can actually restart; a retained checkpoint whose home
            # store died with its node is dropped (fresh __init__ beats
            # a restore that can only fail).
            ck = actor.checkpoint
            if ck is not None and len(ck) > 3 \
                    and self._store_is_dead(ck[3]):
                ck = None
            ck_interval = (self.config.actor_checkpoint_interval_s
                           if (self.config.recovery
                               and actor.options.get("max_restarts", 0)
                               != 0)
                           else None)
            worker.queue_msg(("create_actor", {
                "task_id": spec["task_id"],
                "actor_id": rec.actor_id,
                "func_id": func_id,
                "args": args,
                "kwargs": kwargs,
                "name": spec.get("name"),
                "resources": rec.requirements,
                "max_concurrency": actor.max_concurrency,
                "checkpoint": ck,
                "checkpoint_interval": ck_interval,
            }))
        else:
            worker.queue_msg(("exec", msg_task))
        self._mark_dirty(worker)
        self.task_events.append(
            {"task_id": spec["task_id"].hex(), "name": spec.get("name"),
             "state": "RUNNING", "time": time.time()})
        return True

    def _fail_task_locked(self, rec: TaskRecord, error: BaseException,
                          dispatchable=True):
        spec = rec.spec
        payload = serialization.dumps_inline(error)  # noqa: RTL604 -- task-failure path; error payloads are bounded-small
        tid = TaskID(spec["task_id"])
        for i in range(max(1, spec["num_returns"])):
            self._complete_object_locked(
                tid.object_id(i), (protocol.ERROR, payload), ok=False)
        self._unpin_task_deps_locked(rec)
        self.tasks.pop(spec["task_id"], None)
        self.task_events.append(
            {"task_id": spec["task_id"].hex(), "name": spec.get("name"),
             "state": "FAILED", "time": time.time()})
        if rec.is_actor_creation and rec.actor_id in self.actors:
            actor = self.actors[rec.actor_id]
            actor.status = DEAD
            actor.death_cause = error
            if not actor.created_future.done():
                actor.created_future.set_exception(error)
            self._fail_actor_queue_locked(actor, error)

    def _unpin_task_deps_locked(self, rec: TaskRecord):
        spec = rec.spec
        for slot_vals in (spec["args"], list(spec.get("kwargs", {}).values())):
            for a in slot_vals:
                if a[0] == "ref":
                    oid = ObjectID(a[1])
                    st = self.objects.get(oid)
                    if st is not None:
                        st.pins -= 1
                        self._maybe_free_locked(oid, st)
        # Nested refs and by-value arg segments are kept while lineage holds
        # the spec — re-execution needs them; _release_lineage_for_locked
        # frees them when the last return object dies.
        if spec["task_id"][:12] not in self.lineage:
            self._release_spec_resources_locked(spec)

    def _release_spec_resources_locked(self, spec: dict):
        # Refs pickled inside argument containers (pinned at submission).
        nested = spec.get("nested_refs", [])
        if nested:
            spec["nested_refs"] = []
            self._unpin_nested_locked(nested)
        # Ephemeral shm segments that carried large by-value args; created
        # by the submitter's store (driver or worker), freed there.
        creator = spec.get("_creator_worker")
        for name, size in spec.get("tmp_segments", []):
            if os.path.isabs(name):
                # A spill-file path (store was full at submission time).
                try:
                    os.unlink(name)
                except OSError:
                    pass
                continue
            if creator is not None and not creator.dead:
                # Queueing cannot fail; undeliverable frees reroute via
                # the creator's death path.
                self._queue_send(creator,
                                 ("free_segment", name, size, False))
                continue
            self.shm.unlink(name, size)
        spec["tmp_segments"] = []

    # ------------------------------------------------------------- actors --
    def create_actor(self, spec: dict, options: dict):
        actor_id = os.urandom(16)
        actor = ActorState(actor_id)
        actor.func_id = spec["func_id"]
        actor.options = options
        actor.max_concurrency = options.get("max_concurrency", 1)
        actor.restarts_left = options.get("max_restarts", 0)
        actor.name = options.get("name")
        actor.namespace = options.get("namespace", "default")
        req = spec.get("resources") or {"CPU": 1.0}
        rec = TaskRecord(spec, req, 0)
        rec.is_actor_creation = True
        rec.actor_id = actor_id
        strategy = spec.get("scheduling_strategy")
        if strategy and strategy[0] == "placement_group":
            rec.pg_id = strategy[1]
            rec.bundle_index = strategy[2]
        actor.init_args = spec["args"]
        actor.init_kwargs = spec.get("kwargs", {})
        with self.lock:
            if spec.get("func_payload") is not None:
                self.functions.setdefault(spec["func_id"],
                                          spec.pop("func_payload"))
            self._pin_nested_locked(spec.get("nested_refs", []))
            if actor.name:
                key = (actor.namespace, actor.name)
                if key in self.named_actors:
                    raise ValueError(
                        f"Actor name {actor.name!r} already taken")
                self.named_actors[key] = actor_id
            self.actors[actor_id] = actor
            self.tasks[spec["task_id"]] = rec
            self._resolve_deps_locked(rec)
            self._gcs_dirty += 1
            if rec.deps_pending == 0:
                self._enqueue_pending_locked(rec)
                self._dispatch_locked()
        return actor_id

    # --------------------------------------------- GCS snapshot/restore --
    def _gcs_snapshot_loop(self):
        while not self._stopped:
            # Wake on the stop event instead of sleeping out the full
            # interval: shutdown() writes its final snapshot and must not
            # race a stale periodic write (or wait interval_s to exit).
            if self._gcs_stop.wait(self.config.gcs_snapshot_interval_s):
                return
            if self._gcs_dirty != self._gcs_snapshotted:
                try:
                    self._snapshot_gcs()
                except Exception:
                    with self.lock:
                        self.gcs_snapshot_failures += 1
                    import traceback

                    traceback.print_exc()

    def _snapshot_gcs(self, clean: bool = False):
        """Atomically persist head metadata — the full GCS table set a
        RESUMING cluster needs (reference: redis_store_client.h:28 table
        persistence + GcsInitData load, gcs_server.h:77): KV, functions,
        jobs, the OBJECT table (descriptor + home store — shm segments in
        surviving agent stores outlive a head restart, and the adopted
        session id keeps their ``rtpu-<session>-<oid>`` names valid), the
        ACTOR table including retained ``__ray_save__`` checkpoint
        descriptors, the client-lease table, and node registrations.

        ``clean`` marks the final shutdown() snapshot: workers, agents,
        and segments are about to be torn down with the session, so a
        restore from it must NOT wait for re-registrations (nothing
        survives to re-register) — it cold-restores immediately, which
        is also what keeps the in-process snapshot->restore drill
        deterministic."""
        recovery.syncpoint("snapshot")
        with self._gcs_write_lock:
            # A periodic write that lost the race to shutdown's final
            # clean snapshot must not replace it with a stale image.
            if self._stopped and not clean:
                return
            self._snapshot_gcs_inner(clean)  # noqa: RTL505 -- _gcs_write_lock is strictly OUTER to the runtime lock (this is its only acquisition site); nothing takes it under self.lock

    # Object-row rebuild policy for huge tables: below the threshold
    # every snapshot rebuilds the rows (exact); above it the O(#objects)
    # scan under the runtime lock would stall dispatch every interval,
    # so rows are reused for up to OBJ_REUSE_SNAPSHOTS writes — restore
    # already tolerates row staleness (the blip-window grace machinery
    # covers objects newer than the snapshot).
    SNAP_OBJ_EXACT_MAX = 50_000
    SNAP_OBJ_REUSE = 5

    def _snapshot_gcs_inner(self, clean: bool):
        with self.lock:
            ver = self._gcs_dirty
            named = []
            for (ns, name), aid in self.named_actors.items():
                a = self.actors.get(aid)
                if a is None or a.status == DEAD:
                    continue
                # v1-compat list (old heads restore from it).  Only
                # inline init args ship here.
                args_ok = all(d[0] == protocol.INLINE
                              for d in (a.init_args or ()))
                kwargs_ok = all(d[0] == protocol.INLINE
                                for d in (a.init_kwargs or {}).values())
                if not (args_ok and kwargs_ok):
                    continue
                named.append({
                    "namespace": ns, "name": name,
                    "func_id": a.func_id,
                    "init_args": list(a.init_args or ()),
                    "init_kwargs": dict(a.init_kwargs or {}),
                    "options": {k: v for k, v in a.options.items()
                                if k != "scheduling_strategy"},
                })
            actors = []
            for aid, a in self.actors.items():
                if a.status == DEAD:
                    continue
                args_ok = all(
                    d[0] == protocol.INLINE for d in (a.init_args or ())
                ) and all(d[0] == protocol.INLINE
                          for d in (a.init_kwargs or {}).values())
                actors.append({
                    "actor_id": aid,
                    "name": a.name, "namespace": a.namespace,
                    "func_id": a.func_id,
                    "init_args": (list(a.init_args or ())
                                  if args_ok else None),
                    "init_kwargs": (dict(a.init_kwargs or {})
                                    if args_ok else None),
                    "options": {k: v for k, v in a.options.items()
                                if k != "scheduling_strategy"},
                    "restarts_left": a.restarts_left,
                    "checkpoint": a.checkpoint,
                    "home_store": (a.node.store_id
                                   if a.node is not None else ""),
                })
            cache = self._snap_obj_cache
            if (len(self.objects) <= self.SNAP_OBJ_EXACT_MAX or clean
                    or cache is None or cache[0] <= 0):
                objects = []
                for oid, st in self.objects.items():
                    if st.status != READY or st.descr is None:
                        continue
                    if st.descr[0] not in (protocol.INLINE, protocol.SHM,
                                           protocol.SPILLED):
                        continue
                    objects.append((oid.binary(), st.descr,
                                    list(st.nested_ids)))
                self._snap_obj_cache = [self.SNAP_OBJ_REUSE, objects]
            else:
                cache[0] -= 1
                objects = cache[1]
            nodes = []
            for node in self.nodes.values():
                if node.agent is None or not node.alive:
                    continue
                nodes.append({
                    "node_id": node.node_id.hex(),
                    "resources": dict(node.resources),
                    "labels": dict(node.labels),
                    "store_id": node.store_id,
                })
            leases = []
            for node in self.nodes.values():
                for w in node.all_workers.values():
                    if w.client_lease is not None and not w.dead:
                        leases.append((w.worker_id.hex(),
                                       w.client_lease.worker_id.hex(),
                                       dict(w.lease_req or {})))
            data = {
                "version": 2,
                "clean": bool(clean),
                "session_id": self.session_id,
                "store_id": self.store_id,
                "head_node_id": self.head_node.node_id.hex(),
                "kv": {ns: dict(tbl) for ns, tbl in self.kv.items()},
                "functions": dict(self.functions),
                "named_actors": named,
                "actors": actors,
                "objects": objects,
                "nodes": nodes,
                "leases": leases,
                "jobs": self._snapshot_jobs_locked(),
                "tcp_address": self.tcp_address,
            }
        blob = serialization.dumps_inline(data)
        path = self.config.gcs_snapshot_path
        tmp = f"{path}.tmp{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())  # torn snapshot = unrestartable head
        os.replace(tmp, path)
        self._gcs_snapshotted = ver
        with self.lock:
            self.gcs_snapshots += 1

    def _snapshot_jobs_locked(self):
        mgr = getattr(self, "_job_manager", None)
        if mgr is not None:
            return mgr.snapshot_rows()
        # No manager instantiated (yet): carry restored rows forward so a
        # snapshot written before first job use can't wipe job history.
        return list(getattr(self, "_restored_jobs", []) or [])

    def _load_snapshot(self, path: str) -> Optional[dict]:
        try:
            with open(path, "rb") as f:
                return serialization.loads_inline(f.read())
        except Exception as e:  # noqa: BLE001
            # A corrupt snapshot must not make the head unstartable —
            # that is the exact failure this feature exists to survive.
            print(f"ray_tpu_torch: GCS snapshot {path!r} unreadable ({e!r}); "
                  f"starting fresh")
            return None

    def _apply_restore(self, data: dict):
        """Head restart: reload the persisted tables, then RECONCILE
        against re-registrations instead of assuming the cluster died
        with the old head (reference: GcsInitData load + workers
        reconnecting across GCS restart, gcs_server.h:77).

        - Restored agent NODES come back not-alive under their old ids;
          a reconnecting agent re-claims its node by store id.  Nodes
          that miss the grace window stay dead (their objects surface as
          losses lazily, the reconstruction candidates).
        - Restored OBJECTS come back READY with a permanent failover pin
          (pins=1): exact refcounts died with the old head, so the safe
          direction is leak-until-shutdown, never free-early.
        - Restored ACTORS wait for their surviving worker to re-claim
          the incarnation (state intact); unclaimed ones are re-created
          at the grace deadline from their creation spec, restoring the
          last ``__ray_save__`` checkpoint over ``__init__``.
        - Restored LEASES re-bind when both sides re-register; the
          remainder is revoked through the revocation path at the deadline.
        """
        v2 = data.get("version", 1) >= 2
        # Crash restores WAIT for surviving peers to re-register
        # (adoption beats re-creation: state continuity is free).  A
        # snapshot written by a CLEAN shutdown has nothing surviving it
        # — its session's workers/agents/segments were torn down — so
        # restore is immediate and SHM residue is skipped.  With the
        # failover switch off, re-registration is refused anyway, so
        # waiting would only delay the cold restores.
        wait = (not data.get("clean")) and self.config.head_failover
        with self.lock:
            for ns, tbl in data.get("kv", {}).items():
                self.kv.setdefault(ns, {}).update(tbl)
            self.functions.update(data.get("functions", {}))
            for oid_bin, descr, nested in data.get("objects", []):
                if data.get("clean") and descr[0] != protocol.INLINE:
                    continue  # segments died with the clean shutdown
                oid = ObjectID(oid_bin)
                if oid in self.objects:
                    continue
                st = self.objects[oid] = ObjectState()
                st.status = READY
                st.descr = descr
                st.pins = 1  # failover pin (see docstring)
                st.nested_ids = list(nested)
                st.shipped = True  # never pool a pre-blip segment
            if not data.get("clean"):
                for info in data.get("nodes", []):
                    node = self._add_node_locked(
                        info["resources"], labels=info.get("labels"),
                        agent=None, store_id=info["store_id"],
                        node_id=NodeID(bytes.fromhex(info["node_id"])))
                    node.alive = False  # until its agent re-registers
                    if wait:
                        self._awaiting_nodes[info["store_id"]] = node
            for info in data.get("actors", []):
                if data.get("clean"):
                    # The clean shutdown swept the session's segments
                    # and spill dir: a retained checkpoint descriptor
                    # points at deleted storage — drop it so the cold
                    # restore goes straight to fresh __init__ instead
                    # of a doomed __ray_restore__ attempt.
                    info = dict(info, checkpoint=None)
                self._restore_actor_locked(info)
            self._restored_leases = (list(data.get("leases", []))
                                     if wait else [])
        self._restored_jobs = data.get("jobs", [])
        if not v2:
            # v1 snapshot: no actor table — fall back to re-creating the
            # named actors from their inline creation specs.
            for info in data.get("named_actors", []):
                opts = dict(info["options"])
                opts["name"] = info["name"]
                opts["namespace"] = info["namespace"]
                try:
                    self.create_actor({
                        "task_id": new_task_id().binary(),
                        "func_id": info["func_id"],
                        "args": info["init_args"],
                        "kwargs": info["init_kwargs"],
                        "num_returns": 1,
                        "name": f"{info['name']}.__restore__",
                        "resources": (opts.get("resources")
                                      or {"CPU": 1.0}),
                    }, opts)
                except Exception as e:  # noqa: BLE001
                    print(f"ray_tpu_torch: could not restore actor "
                          f"{info['name']!r}: {e!r}")
        if wait and v2:
            grace = self.config.head_reregister_timeout_s
            self._failover_grace_until = time.monotonic() + grace
            t = threading.Timer(grace, self._reconcile_failover)
            t.daemon = True
            t.start()
        else:
            # Nothing can (clean) or may (failover off) re-register:
            # cold-restore every parked actor right now.
            self._reconcile_actors(wait_for_adoption=False)

    def _restore_actor_locked(self, info: dict):
        """Rebuild one ActorState under its OLD id (surviving handles
        and direct actor channels keep working) in RESTARTING state,
        parked until its worker re-claims it or the grace timer re-
        creates it."""
        aid = info["actor_id"]
        actor = ActorState(aid)
        actor.func_id = info["func_id"]
        actor.options = dict(info.get("options") or {})
        actor.max_concurrency = actor.options.get("max_concurrency", 1)
        actor.restarts_left = info.get("restarts_left", 0)
        actor.name = info.get("name")
        actor.namespace = info.get("namespace", "default")
        actor.init_args = info.get("init_args")
        actor.init_kwargs = info.get("init_kwargs")
        actor.checkpoint = info.get("checkpoint")
        actor.status = RESTARTING
        actor.handle_count = 1  # conservative: a surviving handle may exist
        self.actors[aid] = actor
        if actor.name:
            self.named_actors[(actor.namespace, actor.name)] = aid
        self._restored_actors[aid] = info

    def _reconcile_failover(self):
        """Grace deadline: revoke/re-create everything no surviving peer
        re-claimed (reference: gcs_failover_worker_reconnect_timeout)."""
        lease_rows = []
        with self.lock:
            leases, self._restored_leases = self._restored_leases, []
            for worker_hex, holder_hex, req in leases:
                w = self._workers_by_hex.get(worker_hex)
                holder = self._workers_by_hex.get(holder_hex)
                if w is None or w.dead or w.client_lease is not None:
                    continue  # never re-registered, or already re-bound
                # Worker came back but its holder missed the window:
                # revoke through the revocation path so the slot frees.
                self.lease_revocations += 1
                lease_rows.append((w, holder))
            missed = {sid: n for sid, n in self._awaiting_nodes.items()
                      if n.agent is None}
            self._awaiting_nodes.clear()
            for node in missed.values():
                node.alive = False
            # Implicit blip-window objects still PENDING with no task to
            # produce them: fail as reconstruction candidates (recovery
            # refuses without lineage — that surfaces the honest
            # ObjectLostError instead of an eternal hang).
            for oid_bin in list(self._grace_objects):
                oid = ObjectID(oid_bin)
                st = self.objects.get(oid)
                if st is None or st.status != PENDING:
                    continue
                if self._try_recover_locked(oid):
                    continue
                err = (protocol.ERROR, serialization.dumps_inline(  # noqa: RTL402 -- cold once-per-failover path
                    exc.ObjectLostError(
                        object_id=oid.hex(), phase="head_failover")))
                self._complete_object_locked(oid, err, False)
            self._grace_objects.clear()
        for w, holder in lease_rows:
            if holder is not None and not holder.dead:
                try:
                    self._queue_send(holder, ("lease_revoke",
                                              [w.worker_id.hex()]))
                except Exception:
                    pass
        self._reconcile_actors(wait_for_adoption=False)
        with self.lock:
            self._dispatch_locked()

    def _reconcile_actors(self, wait_for_adoption: bool):
        """Re-create restored actors nobody re-claimed.  Adoption (the
        surviving worker re-registering its incarnation) always beats
        re-creation — state continuity is free — so a crash restore
        leaves parked actors alone until the grace deadline calls back
        in with ``wait_for_adoption=False``."""
        if wait_for_adoption:
            return
        with self.lock:
            todo = []
            for aid, info in list(self._restored_actors.items()):
                # Popping under the lock closes the adoption race: a
                # reregister arriving after this pass sees the actor
                # gone from _restored_actors and is refused — one
                # incarnation, never two.
                self._restored_actors.pop(aid, None)
                actor = self.actors.get(aid)
                if actor is None or actor.status != RESTARTING \
                        or actor.worker is not None:
                    continue
                todo.append((actor, info))
        for actor, info in todo:
            self._cold_restore_actor(actor, info)

    def _cold_restore_actor(self, actor: ActorState, info: dict):
        """Re-run an unclaimed restored actor's creation spec under its
        OLD id, restoring the retained ``__ray_save__`` checkpoint over
        ``__init__`` (reference: actor restart on GCS failover +
        checkpointable actors)."""
        if actor.init_args is None:
            # Non-inline creation args died with the old session and no
            # surviving worker re-claimed the incarnation: the actor is
            # honestly dead.
            err = exc.ActorDiedError(
                f"Actor {actor.actor_id.hex()} could not be restored "
                f"across the head restart (non-inline creation args and "
                f"no surviving incarnation)")
            with self.lock:
                actor.status = DEAD
                actor.death_cause = err
                self._gcs_dirty += 1
                self._fail_actor_queue_locked(actor, err)
            return
        req = actor.options.get("resources") or {"CPU": 1.0}
        spec = {
            "task_id": new_task_id().binary(),
            "func_id": actor.func_id,
            "args": actor.init_args,
            "kwargs": actor.init_kwargs or {},
            "num_returns": 1,
            "name": "actor.__failover_restore__",
            "resources": req,
        }
        rec = TaskRecord(spec, req, 0)
        rec.is_actor_creation = True
        rec.actor_id = actor.actor_id
        tid = TaskID(spec["task_id"])
        with self.lock:
            actor.restarts_left = info.get("restarts_left", 0)
            self.objects[tid.object_id(0)] = ObjectState(tid)
            self.tasks[spec["task_id"]] = rec
            self._gcs_dirty += 1
            self._enqueue_pending_locked(rec)
            self._dispatch_locked()

    def _enqueue_actor_task_nopump_locked(
            self, rec: TaskRecord) -> Optional[bytes]:
        """Queue an actor task without pumping; returns the actor id (or
        None for a dead actor) so bulk submitters can pump each distinct
        actor once per batch instead of once per call."""
        rec.actor_id = rec.spec["actor_id"]
        actor = self.actors.get(rec.actor_id)
        if actor is None or actor.status == DEAD:
            cause = actor.death_cause if actor else None
            self._fail_task_locked(rec, exc.ActorDiedError(
                f"Actor is dead: {cause}"))
            return None
        # Method calls replay across actor restarts per the ACTOR's
        # max_task_retries (0 = fail on death, the legacy default; -1 =
        # unlimited) — not the plain-task max_retries default.
        rec.retries_left = actor.options.get("max_task_retries", 0)
        actor.queue.append(rec)
        return rec.actor_id

    def _enqueue_actor_task_locked(self, rec: TaskRecord):
        aid = self._enqueue_actor_task_nopump_locked(rec)
        if aid is not None:
            self._pump_actor_locked(self.actors[aid])

    def _pump_actor_locked(self, actor: ActorState):
        if actor.status != ALIVE or actor.worker is None:
            return
        # Per-handle ordering: dispatch strictly FIFO; head-of-line waits for
        # its deps (reference: sequence numbers in
        # direct_actor_task_submitter.h:67).
        while actor.queue:
            rec = actor.queue[0]
            if rec.cancelled:
                actor.queue.popleft()
                continue
            if rec.deps_pending > 0:
                break
            actor.queue.popleft()
            rec.dispatched = True
            rec.node = actor.node
            rec.worker = actor.worker
            if self._send_task(actor.worker, rec):
                actor.inflight[rec.spec["task_id"]] = rec

    def _fail_actor_queue_locked(self, actor: ActorState,
                                 error: BaseException):
        while actor.queue:
            rec = actor.queue.popleft()
            self._fail_task_locked(rec, error)
        for rec in list(actor.inflight.values()):
            self._fail_task_locked(rec, error)
        actor.inflight.clear()

    # ------------------------------------------- actor handle refcounts --
    # Reference: actor out-of-scope GC (gcs_actor_manager.h + the core
    # worker's actor handle reference counting).  Every live handle holds
    # one count; pickling adds an in-flight count the deserialized copy
    # owns.  Zero count on an unnamed, non-detached actor schedules a
    # deferred termination check — deferred (not immediate) because an
    # in-flight +1 from another process's pickle may still be on the wire.
    _ACTOR_GC_DEFER_S = 1.0

    def actor_handle_addref(self, actor_id: bytes):
        with self.lock:
            actor = self.actors.get(actor_id)
            if actor is not None:
                actor.handle_count += 1

    def actor_handle_serialized(self, actor_id: bytes, token: bytes):
        """A pickled handle holds one count bound to ``token`` until the
        first deserialization returns it (actor.py __reduce__)."""
        with self.lock:
            actor = self.actors.get(actor_id)
            if actor is None:
                return
            if token in self._actor_tokens_consumed:
                # The consume beat the create across connections: cancel
                # out without ever incrementing.
                self._actor_tokens_consumed.discard(token)
                return
            self._actor_tokens[token] = actor_id
            actor.handle_count += 1

    _TOKEN_CONSUMED_CAP = 1 << 16

    def actor_handle_deserialized(self, actor_id: bytes, token: bytes):
        with self.lock:
            aid = self._actor_tokens.pop(token, None)
            if aid is None:
                # create not seen yet (cross-conn race) — or a second+
                # materialization of the same pickle, which holds no
                # transfer count.  Only the former must be remembered.
                if len(self._actor_tokens_consumed) < \
                        self._TOKEN_CONSUMED_CAP:
                    self._actor_tokens_consumed.add(token)
                return
        self.actor_handle_decref(aid)

    def actor_handle_decref(self, actor_id: bytes):
        if self._stopped:
            return
        schedule = False
        with self.lock:
            actor = self.actors.get(actor_id)
            if actor is None:
                return
            actor.handle_count -= 1
            if (actor.handle_count <= 0 and actor.name is None
                    and actor.options.get("lifetime") != "detached"
                    and actor.status != DEAD):
                schedule = True
        if schedule:
            t = threading.Timer(self._ACTOR_GC_DEFER_S,
                                self._maybe_gc_actor, args=(actor_id,))
            t.daemon = True
            t.start()

    def _maybe_gc_actor(self, actor_id: bytes):
        """Terminate an actor whose handle count stayed at zero; waits for
        queued/inflight method calls to drain first (their result refs are
        still live even though the handle is gone — the reference also
        runs outstanding work before the out-of-scope kill)."""
        if self._stopped:
            return
        with self.lock:
            actor = self.actors.get(actor_id)
            if actor is None or actor.status == DEAD:
                return
            if actor.handle_count > 0 or actor.name is not None:
                return
            if actor.inflight or actor.queue:
                busy = True
            elif actor.status == "PENDING":
                # Not yet created and nobody can reference it anymore.
                # Queued creation: fail the record now (releases its
                # pinned init-arg refs).  Dispatched creation: mark it
                # cancelled — the creation result handler reaps the
                # worker on arrival.
                busy = False
                for rec in list(self.tasks.values()):
                    if rec.is_actor_creation and rec.actor_id == actor_id:
                        rec.cancelled = True
                        if not rec.dispatched:
                            self._fail_task_locked(
                                rec, exc.ActorDiedError(
                                    "Actor went out of scope before "
                                    "creation"), dispatchable=False)
                actor.status = DEAD
                actor.death_cause = "out of scope"
                self._gcs_dirty += 1
                return
            else:
                busy = False
        if busy:
            t = threading.Timer(self._ACTOR_GC_DEFER_S,
                                self._maybe_gc_actor, args=(actor_id,))
            t.daemon = True
            t.start()
            return
        self.kill_actor(actor_id, no_restart=True)

    def kill_actor(self, actor_id: bytes, no_restart=True):
        with self.lock:
            actor = self.actors.get(actor_id)
            if actor is None:
                return
            if no_restart:
                actor.restarts_left = 0
                # Snapshot must observe the kill: a restarted head must
                # not resurrect an actor the user explicitly destroyed.
                self._gcs_dirty += 1
            worker = actor.worker
            if worker is not None:
                try:
                    worker.proc.terminate()
                except Exception:
                    pass

    def actor_exit(self, actor_id: bytes):
        """Graceful __ray_terminate__ equivalent."""
        self.kill_actor(actor_id, no_restart=True)

    def get_named_actor(self, name, namespace="default"):
        with self.lock:
            aid = self.named_actors.get((namespace, name))
            if aid is None:
                raise ValueError(f"No actor named {name!r}")
            return aid, self.actors[aid]

    # ---------------------------------------------------- placement groups --
    def create_placement_group(self, bundles, strategy="PACK", name=""):
        pg = PlacementGroupState(PlacementGroupID.from_random(), bundles,
                                 strategy, name)
        with self.lock:
            self.placement_groups[pg.pg_id.binary()] = pg
            self.pending_pgs.append(pg)
            self._try_reserve_pgs_locked()
        return pg

    def _pg_can_fit_locked(self, pg, idx: int, req: Dict[str, float]) -> bool:
        bundle = pg.bundles[idx]
        used = pg.used[idx]
        return all(bundle.get(k, 0.0) - used.get(k, 0.0) >= v - 1e-9
                   for k, v in req.items())

    def _pg_acquire_locked(self, pg, idx: int, req: Dict[str, float]):
        used = pg.used[idx]
        for k, v in req.items():
            used[k] = used.get(k, 0.0) + v

    def _pg_release_locked(self, pg, idx: int, req: Dict[str, float]):
        used = pg.used[idx]
        for k, v in req.items():
            used[k] = used.get(k, 0.0) - v

    def _try_reserve_pgs_locked(self):
        """2-phase bundle reservation condensed to one phase under the global
        lock (reference: GcsPlacementGroupScheduler prepare/commit)."""
        still = deque()
        while self.pending_pgs:
            pg = self.pending_pgs.popleft()
            if pg.removed:
                continue
            plan = self._plan_pg_locked(pg)
            if plan is None:
                still.append(pg)
                continue
            for idx, node in enumerate(plan):
                node.acquire(pg.bundles[idx])
                pg.reserved[idx] = node.node_id
            if not pg.created_future.done():
                pg.created_future.set_result(True)
        self.pending_pgs = still

    def _plan_pg_locked(self, pg) -> Optional[List[NodeState]]:
        alive = [self.nodes[nid] for nid in self.node_order
                 if self.nodes[nid].alive
                 and not self.nodes[nid].draining]
        avail = {id(n): dict(n.available) for n in alive}

        def fits(n, b):
            return all(avail[id(n)].get(k, 0) >= v - 1e-9
                       for k, v in b.items())

        def take(n, b):
            for k, v in b.items():
                avail[id(n)][k] = avail[id(n)].get(k, 0) - v

        plan: List[NodeState] = []
        if pg.strategy in ("PACK", "STRICT_PACK"):
            for n in alive:
                trial = []
                ok = True
                snapshot = {k: dict(v) for k, v in avail.items()}
                for b in pg.bundles:
                    if fits(n, b):
                        take(n, b)
                        trial.append(n)
                    else:
                        ok = False
                        break
                if ok:
                    return trial
                avail.update(snapshot)
            if pg.strategy == "STRICT_PACK":
                return None
        if pg.strategy in ("SPREAD", "STRICT_SPREAD", "PACK"):
            used_nodes = set()
            for b in pg.bundles:
                placed = None
                for n in alive:
                    if pg.strategy == "STRICT_SPREAD" and id(n) in used_nodes:
                        continue
                    if fits(n, b):
                        placed = n
                        break
                if placed is None:
                    return None
                take(placed, b)
                used_nodes.add(id(placed))
                plan.append(placed)
            return plan
        return None

    def remove_placement_group(self, pg_id: bytes):
        with self.lock:
            pg = self.placement_groups.get(pg_id)
            if pg is None or pg.removed:
                return
            pg.removed = True
            for idx, node_id in enumerate(pg.reserved):
                if node_id is not None and node_id in self.nodes:
                    self.nodes[node_id].release(pg.bundles[idx])
            self._try_reserve_pgs_locked()
            self._dispatch_locked()

    # ----------------------------------------------------- per-conn readers --
    def _worker_reader(self, conn, worker: WorkerHandle):
        """One thread per worker connection (reference: each core worker's
        gRPC stream is served independently — the single select loop of v1
        serialized all control traffic through one thread)."""
        while not self._stopped:
            try:
                msg = protocol.recv(conn)
            except (EOFError, OSError, TypeError):
                # TypeError: conn.close()d out from under a blocked recv
                # (its handle becomes None mid-read).
                self._on_worker_death(worker)
                return
            try:
                self._handle_worker_msg(worker, msg)
            except Exception:
                import traceback
                traceback.print_exc()

    def _agent_reader(self, conn, agent: "AgentHandle"):
        while not self._stopped:
            try:
                msg = protocol.recv(conn)
            except (EOFError, OSError, TypeError):
                self._on_agent_death(agent)
                return
            # Failure detection: ANY agent message is liveness (the
            # heartbeat floor guarantees at least one per period).
            # Benign unlocked write — the suspicion loop reads it
            # monotonically.
            agent.last_seen = time.monotonic()
            try:
                self._handle_agent_msg(agent, msg)
            except Exception:
                import traceback
                traceback.print_exc()

    def _handle_agent_msg(self, agent: AgentHandle, msg: tuple):
        if msg[0] == "heartbeat":
            pass  # liveness stamped by the reader wrapper
        elif msg[0] == "segment":
            agent.deliver(msg[1], msg[2], msg[3])
        elif msg[0] == "oom_pressure":
            # The node's agent sampled its own memory over threshold;
            # the victim policy runs here where the task table lives.
            self._oom_kill_one(msg[1], node=agent.node)
        elif msg[0] == "worker_logs":
            node_hex = (agent.node.node_id.hex()
                        if agent.node is not None else "")
            for wid, lines in msg[1]:
                self._record_worker_lines(wid, lines, node=node_hex)
        elif msg[0] == "preempt_notice":
            # Spot/preemptible warning window: drain the node within the
            # agent's deadline, then release it with drain_node so the
            # agent exits before the plug pulls.  Off-thread — the drain
            # waits on checkpoints and migration pulls, and this is the
            # agent's reader thread.  With elastic_drain off the notice
            # is ignored (the agent also never sends one then: the head
            # withheld drain_caps in agent_ack) and the node death rides
            # the legacy hard-kill path with every counter zero.
            if self.config.elastic_drain and agent.node is not None:
                with self.lock:
                    self.preemptions += 1
                threading.Thread(
                    target=self.drain_node,
                    args=(agent.node.node_id, msg[1], msg[2]),
                    daemon=True, name="ray_tpu_torch-drain").start()

    def _on_agent_death(self, agent: AgentHandle):
        """Node agent connection dropped: the node is gone (reference: GCS
        health-check failure -> node death broadcast,
        gcs_health_check_manager.h:39)."""
        with self.lock:
            if agent.dead:
                return
            agent.dead = True
            self._conn_to_agent.pop(agent.conn, None)
            self._agents.pop(agent.store_id, None)
            node = agent.node
            if node is not None:
                node.alive = False
            workers = list(node.all_workers.values()) if node else []
        agent.fail_all(exc.RayTpuError("node agent died"))
        # Its workers are unreachable (and die with the agent when it exits
        # cleanly).  Drive the death path directly — a closed conn makes
        # connection.wait() raise rather than report EOF, so waiting on the
        # IO loop to notice would spin.
        for w in workers:
            conn = w.conn
            self._on_worker_death(w)
            if conn is not None:
                try:
                    conn.close()
                except Exception:
                    pass

    def _handle_worker_msg(self, worker: WorkerHandle, msg: tuple):
        """Per-handler latency accounting wraps every control message
        (reference: src/ray/common/event_stats.h — per-handler event
        stats; this is the instrumentation that shows WHERE head time
        goes under load)."""
        if protocol.is_batch(msg):
            # Wire-batch envelope: unwrap so each sub-message keeps its
            # own handler stats AND its own failure isolation — a bad
            # sub-message must not abort the rest of the frame (they
            # were independent messages before batching).
            for m in msg[1]:
                try:
                    self._handle_worker_msg(worker, m)
                except Exception:
                    import traceback
                    traceback.print_exc()
            return
        # Failure detection: any worker message is liveness (benign
        # unlocked write; the suspicion loop reads it monotonically).
        worker.last_seen = time.monotonic()
        t0 = time.perf_counter()
        try:
            return self._handle_worker_msg_inner(worker, msg)
        finally:
            dt = time.perf_counter() - t0
            tag = msg[0] if isinstance(msg[0], str) else "?"
            with self._handler_stats_lock:
                s = self._handler_stats.get(tag)
                if s is None:
                    s = self._handler_stats[tag] = [0, 0.0, 0.0]
                s[0] += 1
                s[1] += dt
                if dt > s[2]:
                    s[2] = dt

    def _handle_worker_msg_inner(self, worker: WorkerHandle, msg: tuple):
        tag = msg[0]
        if tag == "ready":
            worker.ready.set()
        elif tag == "heartbeat":
            pass  # liveness stamped by the handler wrapper
        elif tag == "hc_ping":
            # Stalled-head watchdog probe from a worker/client stuck
            # waiting on us: any reply resets its clock.  Rides the
            # conflation sender — proving the whole send path moves is
            # the point.
            self._queue_send(worker, ("reply", msg[1], "pong"))
        elif tag == "spans":
            # Task execution spans from a worker (task events; feeds
            # `ray_tpu_torch.timeline()` — scripts.py:1840 `ray timeline`).
            wid = worker.worker_id.hex()
            nid = (worker.node.node_id.hex()
                   if worker.node is not None else "")
            with self.lock:
                for tid_bin, name, start, end, kind in msg[1]:
                    self.task_spans.append({
                        "task_id": tid_bin.hex(), "name": name,
                        "start": start, "end": end, "kind": kind,
                        "worker_id": wid, "node_id": nid})
        elif tag == "event":
            # Generic worker->driver pubsub (reference: src/ray/pubsub/
            # long-poll channels) — used by train session streaming and
            # the serve controller's autoscale events.
            with self.lock:
                self.events.setdefault(msg[1], deque(maxlen=10000)).append(
                    msg[2])
                listeners = list(self._event_listeners.get(msg[1], ()))
            for cb in listeners:
                # Outside the lock: a listener (the autoscaler's wake)
                # may take its own locks; it must only nudge, not block.
                try:
                    cb()
                except Exception:
                    pass
        elif tag == "xfer_stats":
            # Periodic data-plane counter DELTAS from a worker (pull
            # dedup, argument-prefetch hit/waste bytes) — aggregated
            # here next to brokered_parts/relayed_segments.
            with self.lock:
                d = msg[1]
                self.deduped_pulls += d.get("deduped_pulls", 0)
                self.prefetch_hit_bytes += d.get("prefetch_hit_bytes", 0)
                self.prefetch_waste_bytes += d.get(
                    "prefetch_waste_bytes", 0)
                self.leased_submits += d.get("leased_submits", 0)
                self.spillbacks += d.get("spillbacks", 0)
                # Worker-owned (direct-path) lineage reconstructions ride
                # the same delta stream as every holder-side counter.
                self.reconstructions += d.get("reconstructions", 0)
                self.reconstruction_failures += d.get(
                    "reconstruction_failures", 0)
                # Failure-detection deltas from the worker's deadline
                # core (zero with the switch off).
                self.stall_timeouts += d.get("stall_timeouts", 0)
                self.net_retries += d.get("net_retries", 0)
                self.hedged_fetches += d.get("hedged_fetches", 0)
                # Push-shuffle deltas from map tasks and reducer
                # actors (zero with the switch off).
                self.shuffle_pushed_bytes += d.get(
                    "shuffle_pushed_bytes", 0)
                self.shuffle_merges += d.get("shuffle_merges", 0)
                self.shuffle_spills += d.get("shuffle_spills", 0)
                self.shuffle_hedges += d.get("shuffle_hedges", 0)
                # Distributed-training deltas from pipeline stage
                # actors / IMPALA learner workers (zero with the
                # switch off).
                self.microbatch_pushes += d.get("microbatch_pushes", 0)
                self.stage_restarts += d.get("stage_restarts", 0)
                self.learner_queue_stalls += d.get(
                    "learner_queue_stalls", 0)
        elif tag == "result":
            self._on_result(worker, msg[1], msg[2], msg[3], msg[4])
        elif tag == "result_batch":
            for tid_bin, ok, returns, meta in msg[1]:
                self._on_result(worker, tid_bin, ok, returns, meta)
        elif tag == "getparts":
            # Worker holds a descriptor for a segment in another node's
            # store: ship the serialized parts.  Fetch may block on a
            # remote agent, so it runs off the IO thread.
            rid, descr = msg[1], msg[2]
            with self.lock:
                self.brokered_parts += 1

            def fetch_and_reply(worker=worker, rid=rid, descr=descr):
                try:
                    # The worker's descriptor may be stale (object spilled
                    # or restored since): the owner's table has the current
                    # location.
                    cur_oid = self._oid_from_segment_name(descr[1])
                    if cur_oid is not None:
                        with self.lock:
                            st0 = self.objects.get(cur_oid)
                            if st0 is not None and st0.descr is not None \
                                    and st0.descr[0] in (protocol.SHM,
                                                         protocol.SPILLED):
                                descr = st0.descr
                    try:
                        meta, bufs = self._fetch_parts(descr)
                    except exc.ObjectLostError:
                        # Home store died: recover by lineage re-execution,
                        # then ship the rebuilt object (reference:
                        # object_recovery_manager.h:41).
                        oid = self._oid_from_segment_name(descr[1])
                        if oid is None \
                                or not self._recover_for_worker(worker,
                                                                oid):
                            raise
                        with self.lock:
                            st = self.objects.get(oid)
                            descr2 = st.descr if st is not None else None
                        if descr2 is None:
                            raise
                        if descr2[0] != protocol.SHM:
                            worker.send(("obj", rid, True, descr2))
                            return
                        meta, bufs = self._fetch_parts(descr2)
                    # Direct pulls hand back memoryviews (zero-copy for
                    # driver-local use); pickling the reply needs bytes.
                    bufs = [b if isinstance(b, bytes) else bytes(b)
                            for b in bufs]
                    # Direct send, NOT the conflation sender: this reply
                    # can carry hundreds of MB of PARTS bytes, and this
                    # fetch thread is already per-request — funneling it
                    # through the one sender thread would head-of-line
                    # block exec dispatch to every other worker.
                    worker.send(("obj", rid, True,
                                 (protocol.PARTS, meta, bufs)))
                except BaseException as e:  # noqa: BLE001
                    err = serialization.dumps_inline(
                        e if isinstance(e, exc.RayTpuError)
                        else exc.ObjectLostError(
                            repr(e), object_id=_seg_oid_hex(descr[1]),
                            phase="relay"))
                    worker.send(("obj", rid, False, (protocol.ERROR, err)))

            threading.Thread(target=fetch_and_reply, daemon=True).start()
        elif tag == "wait":
            _, rid, id_bins, num_returns, timeout = msg
            from ray_tpu_torch._private.object_ref import ObjectRef

            def respond():
                with self.lock:
                    ready_ids = [
                        b for b in id_bins
                        if (st := self.objects.get(ObjectID(b))) is not None
                        and st.status != PENDING
                    ]
                self._queue_send(worker,
                                 ("waited", rid, ready_ids[:num_returns]))

            count = {"ready": 0, "sent": False}
            with self.lock:
                pend = []
                for b in id_bins:
                    st = self.objects.get(ObjectID(b))
                    if st is None or st.status != PENDING:
                        count["ready"] += 1
                    else:
                        pend.append(st)
                if count["ready"] >= num_returns or not pend \
                        or timeout == 0:
                    # timeout == 0 is a PROBE (the mixed-ownership wait
                    # poll): answer immediately, register nothing — no
                    # leaked waiter callbacks or Timer threads per poll.
                    count["sent"] = True
                else:
                    # The wait really blocks this worker: steal back its
                    # pipelined-but-unstarted tasks — one of them may be
                    # what the wait awaits (same head-of-line hazard as
                    # the mget path).
                    stealable = [tid for tid, r in worker.inflight.items()
                                 if not r.is_actor_creation]
                    if stealable:
                        try:
                            self._queue_send(worker, ("steal", 0, stealable))
                        except Exception:
                            pass
                    def cb(_oid):
                        count["ready"] += 1
                        if count["ready"] >= num_returns and not count["sent"]:
                            count["sent"] = True
                            threading.Thread(target=respond,
                                             daemon=True).start()
                    for st in pend:
                        st.waiters.append(cb)
                    if timeout is not None:
                        threading.Timer(timeout, lambda: (
                            None if count["sent"]
                            else (count.__setitem__("sent", True), respond())
                        )).start()
            if count["sent"]:
                respond()
        elif tag == "submit":
            # Fire-and-forget (reference: PushNormalTask pipelining,
            # direct_task_transport.cc:568): the worker built its return
            # refs locally; per-connection FIFO guarantees any later use
            # of them arrives after this spec.
            self.submit_task_from_worker(msg[2], submitter=worker)
            self._maybe_offer_lease(worker, [msg[2]])
        elif tag == "submit_batch":
            # Bulk fire-and-forget submission (worker/client fan-out):
            # one lock pass + one dispatch for the whole list.  A burst
            # of direct-eligible specs arriving HERE means the holder is
            # lease-starved: piggyback a bulk lease grant on the exchange
            # so the next burst rides the direct plane.
            self.submit_tasks_from_worker(msg[1], submitter=worker)
            self._maybe_offer_lease(worker, msg[1])
        elif tag == "create_actor_req":
            _, rid, spec, creation_opts = msg
            try:
                actor_id = self.create_actor(spec, creation_opts)
                self._queue_send(worker, ("reply", rid, actor_id))
            except Exception as e:  # noqa: BLE001
                self._queue_send(worker, ("reply", rid, e))
        elif tag == "store_addr":
            # Location brokering only (reference: the owner-based object
            # directory answering WHERE, never carrying bytes).  Replies
            # (addr, caps): the advertised verb set lets pullers stripe
            # against peers that speak fetch_range without ever probing
            # one that doesn't.  The HEAD's own store has an object
            # server too, so head-homed segments are pulled directly
            # instead of relayed through getparts.  Compat note: a
            # pre-caps worker handed this tuple fails its address parse
            # and degrades to the (pre-existing) getparts relay — safe
            # but slow; the inverse (new worker, bare-addr old head) is
            # parsed explicitly in _direct_pull.  A new request tag
            # can't fix this: old heads drop unknown tags without
            # replying, which would hang the requester instead.
            _, rid, store_hex = msg
            if store_hex == self.store_id:
                reply = (self.object_addr,
                         self._adv_caps(object_transfer.CAPS))
            else:
                with self.lock:
                    agent = self._agents.get(store_hex)
                    alive = agent is not None and not agent.dead
                    addr = (agent.info.get("object_addr")
                            if alive else None)
                    caps = (self._adv_caps(agent.info.get("object_caps"))
                            if alive else ())
                reply = (addr, caps) if addr else None
            self._queue_send(worker, ("reply", rid, reply))
        elif tag == "state_req":
            _, rid, kind, kwargs = msg
            try:
                self._queue_send(
                    worker, ("reply", rid, self.state_query(kind, **kwargs)))
            except Exception as e:  # noqa: BLE001
                self._queue_send(worker, ("reply", rid, e))
        elif tag == "kill_actor_req":
            _, rid, actor_id, no_restart = msg
            self.kill_actor(actor_id, no_restart)
            self._queue_send(worker, ("reply", rid, True))
        elif tag == "get_actor_req":
            _, rid, name, namespace = msg
            try:
                actor_id, actor = self.get_named_actor(name, namespace)
                self._queue_send(
                    worker, ("reply", rid,
                             (True, actor_id,
                              actor.options.get("method_names", {}))))
            except ValueError:
                self._queue_send(worker, ("reply", rid, (False, None, None)))
        elif tag == "put_parts":
            # Legacy client-shipped value: land it in the HEAD's store
            # so any worker can consume it (clients share no /dev/shm).
            # The table entry registers PENDING under the lock here (so
            # later messages on this FIFO see the object), but the
            # multi-hundred-MB assembly memcpy runs OFF this reader
            # thread and outside the runtime lock — the lock-hold
            # convention: the lock is held only for table registration.
            _, oid_bin, meta, bufs, nested = msg
            oid = ObjectID(oid_bin)
            with self.lock:
                if self.config.direct_puts:
                    # Counted only while the direct path is on: this
                    # message is then a FALLBACK (old-verb client, push
                    # failure) worth watching.
                    self.brokered_put_parts += 1
                st = self.objects.get(oid)
                if st is None:
                    st = self.objects[oid] = ObjectState()
                st.pins += 1  # assembly pin: no free mid-assembly
                st.nested_ids = list(nested)
                self._pin_nested_locked(st.nested_ids)

            def assemble(oid=oid, meta=meta, bufs=bufs):
                try:
                    descr = self._store_parts_locally(oid, meta, bufs)
                except Exception as e:  # noqa: BLE001
                    descr = (protocol.ERROR, serialization.dumps_inline(
                        exc.RayTpuError(f"client put failed: {e!r}")))
                finally:
                    self._put_assembly_sem.release()
                with self.lock:
                    st2 = self.objects.get(oid)
                    if st2 is not None:
                        st2.pins -= 1
                        self._register_put_locked(
                            oid, st2, descr, descr[0] != protocol.ERROR)
                        drop_candidate = st2.refcount() <= 0
                if st2 is not None and drop_candidate:
                    # Refs dropped DURING assembly: the decref's free ran
                    # into the assembly pin and deferred, and
                    # _register_put_locked deliberately skips the free
                    # check (the client's addref may still be in flight
                    # on its FIFO conn, microseconds behind).  Re-check
                    # after a beat — by then the addref has long landed
                    # if it is ever coming — so a fire-and-forget client
                    # put cannot leak its segment.
                    def _late_free(oid=oid):
                        with self.lock:
                            st3 = self.objects.get(oid)
                            if st3 is not None:
                                self._maybe_free_locked(oid, st3)

                    threading.Timer(1.0, _late_free).start()
                if st2 is None:
                    # Entry freed mid-assembly (ref dropped): don't leak
                    # the just-written segment/spill file.
                    if descr[0] == protocol.SHM:
                        self.shm.unlink(descr[1], descr[2])
                    elif descr[0] == protocol.SPILLED:
                        try:
                            os.unlink(descr[1])
                        except OSError:
                            pass

            # Blocks this reader past the in-flight bound — deliberate:
            # the bursting client's TCP window then backpressures it,
            # as the old inline assembly did per connection.
            self._put_assembly_sem.acquire()  # noqa: RTL401 -- cross-thread handoff: released in assemble()'s finally on the assembly thread
            threading.Thread(target=assemble, daemon=True,
                             name="ray_tpu_torch-put-parts").start()
        elif tag == "put_commit":
            # Direct-put commit: the payload already streamed into this
            # node's store over the data plane (object-server verbs
            # reserve_put/put_range/commit_put) — the control plane sees
            # only this O(1) descriptor registration, the write-direction
            # analog of the head staying out of the pull payload path.
            _, oid_bin, descr, nested = msg
            oid = ObjectID(oid_bin)
            with self.lock:
                self.direct_puts += 1
                if descr is not None and len(descr) > 2 \
                        and isinstance(descr[2], int):
                    self.direct_put_bytes += descr[2]
                st = self.objects.get(oid)
                if st is None:
                    st = self.objects[oid] = ObjectState()
                st.nested_ids = list(nested)
                self._pin_nested_locked(st.nested_ids)
                self._register_put_locked(oid, st, descr, True)
        elif tag in ("job_submit", "job_status", "job_logs", "job_stop",
                     "job_list"):
            from ray_tpu_torch.job_submission import _get_manager

            mgr = _get_manager(self)
            try:
                if tag == "job_submit":
                    out = mgr.submit(msg[2], msg[3], msg[4])
                elif tag == "job_status":
                    out = mgr.status(msg[2])
                elif tag == "job_logs":
                    out = mgr.logs(msg[2])
                elif tag == "job_stop":
                    out = mgr.stop(msg[2])
                else:
                    out = mgr.list()
            except Exception as e:  # noqa: BLE001
                out = e
            self._queue_send(worker, ("reply", msg[1], out))
        elif tag == "get_package":
            blob = getattr(self, "_pkg_cache", {}).get(msg[2])
            self._queue_send(worker, ("reply", msg[1], blob))
        elif tag == "cluster_info":
            self._queue_send(worker, ("reply", msg[1], {
                "resources": self.cluster_resources(),
                "available": self.available_resources(),
                "nodes": self.list_nodes(),
                "session_id": self.session_id,
            }))
        elif tag == "put":
            _, oid_bin, descr, nested = msg
            oid = ObjectID(oid_bin)
            with self.lock:
                st = self.objects.get(oid)
                if st is None:
                    st = self.objects[oid] = ObjectState()
                st.status = READY
                st.descr = descr
                if descr[0] == protocol.SHM:
                    st.creator = worker
                st.nested_ids = list(nested)
                self._pin_nested_locked(st.nested_ids)
        elif tag == "addref":
            with self.lock:
                oid = ObjectID(msg[1])
                st = self.objects.get(oid)
                if st is None:
                    st = self.objects[oid] = ObjectState()
                st.worker_refs += 1
        elif tag == "decref":
            with self.lock:
                oid = ObjectID(msg[1])
                st = self.objects.get(oid)
                if st is not None:
                    st.worker_refs -= 1
                    self._maybe_free_locked(oid, st)
        elif tag == "decref_batch":
            with self.lock:
                for b in msg[1]:
                    oid = ObjectID(b)
                    st = self.objects.get(oid)
                    if st is not None:
                        st.worker_refs -= 1
                        self._maybe_free_locked(oid, st)
        elif tag == "actor_addref":
            self.actor_handle_addref(msg[1])
        elif tag == "actor_decref_batch":
            for aid in msg[1]:
                self.actor_handle_decref(aid)
        elif tag == "actor_token_new":
            self.actor_handle_serialized(msg[1], msg[2])
        elif tag == "actor_token_used":
            self.actor_handle_deserialized(msg[1], msg[2])
        elif tag == "addref_batch":
            with self.lock:
                for b in msg[1]:
                    oid = ObjectID(b)
                    st = self.objects.get(oid)
                    if st is None:
                        st = self.objects[oid] = ObjectState()
                    st.worker_refs += 1
        elif tag == "actor_addr_req":
            # Resolve an actor to its worker's direct endpoint so the
            # caller can push method calls straight to it (reference:
            # direct_actor_task_submitter resolving the actor's address
            # via the GCS actor table).
            _, rid, aid = msg
            with self.lock:
                actor = self.actors.get(aid)
            if actor is None:
                worker_send_safe(worker, ("reply", rid, None))
            else:
                def on_created(_fut, aid=aid, rid=rid, lessee=worker):
                    with self.lock:
                        a = self.actors.get(aid)
                        w = (a.worker if a is not None and a.status == ALIVE
                             else None)
                        out = ((w.worker_id.hex(), tuple(w.direct_addr))
                               if w is not None and not w.dead
                               and w.direct_addr else None)
                    worker_send_safe(lessee, ("reply", rid, out))

                actor.created_future.add_done_callback(on_created)
        elif tag == "lease_req":
            # A caller wants executor workers to push tasks to directly;
            # the head only does the resource accounting (reference: the
            # raylet's RequestWorkerLease, direct_task_transport.cc:568).
            opts = msg[4] if len(msg) > 4 else None
            if opts and opts.get("v"):
                # The peer just proved it speaks the v1 lease plane:
                # unsolicited grants may now be pushed to it too.
                worker.lease_caps = True
            self._grant_client_leases(worker, msg[1], msg[2], msg[3],
                                      opts)
        elif tag == "lease_renew":
            # Holder liveness, one message per N leased pushes: bump the
            # named leases' TTL deadlines (pushed tasks never touch the
            # head, so this is the only signal the holder is still
            # driving them).
            if self.config.lease_ttl_s > 0:
                expiry = time.monotonic() + self.config.lease_ttl_s
                with self.lock:
                    for wid in msg[1]:
                        w = self._workers_by_hex.get(wid)
                        if w is not None and w.client_lease is worker \
                                and not w.dead:
                            w.lease_expiry = expiry
        elif tag == "lease_return":
            with self.lock:
                for wid in msg[1]:
                    w = self._workers_by_hex.get(wid)
                    if w is not None and w.client_lease is not None \
                            and not w.dead:
                        w.client_lease = None
                        self._end_lease_locked(w)
                self._request_dispatch_locked()
        elif tag == "export_obj":
            # A worker delegates ownership of objects it created to the
            # head (they are about to be consumed through head-routed
            # specs or returned values).  worker_refs starts at 1: one
            # aggregate ref standing for all of the exporter's local refs.
            with self.lock:
                for item in msg[1]:
                    b, ok, descr, nested = item[0], item[1], item[2], item[3]
                    creator_hex = item[4] if len(item) > 4 else None
                    oid = ObjectID(b)
                    st = self.objects.get(oid)
                    if st is None:
                        st = self.objects[oid] = ObjectState()
                    st.worker_refs += 1
                    if ok is None:
                        # Pending shell; export_complete follows — unless
                        # the exporter dies first (death path fails it).
                        st.exporter = worker
                        continue
                    st.nested_ids = list(nested)
                    self._pin_nested_locked(st.nested_ids)
                    if descr is not None and descr[0] == protocol.SHM:
                        st.shipped = True
                    cw = (self._workers_by_hex.get(creator_hex)
                          if creator_hex else worker)
                    # _complete_object_locked (not a bare status write):
                    # a consumer may ALREADY be blocked on this object —
                    # e.g. it deserialized the ref from a direct task's
                    # container arg before this export was processed —
                    # and its mget waiter must fire.
                    self._complete_object_locked(
                        oid, descr, bool(ok),
                        creator=(cw if cw is not None and not cw.dead
                                 else None))
        elif tag == "export_complete":
            with self.lock:
                for item in msg[1]:
                    b, ok, descr = item[0], item[1], item[2]
                    nested = item[3] if len(item) > 3 else []
                    creator_hex = item[4] if len(item) > 4 else None
                    oid = ObjectID(b)
                    st = self.objects.get(oid)
                    if st is not None and nested:
                        st.nested_ids = list(nested)
                        self._pin_nested_locked(st.nested_ids)
                    if st is not None and descr is not None \
                            and descr[0] == protocol.SHM:
                        st.shipped = True
                    cw = (self._workers_by_hex.get(creator_hex)
                          if creator_hex else None)
                    if st is not None:
                        st.exporter = None
                    self._complete_object_locked(oid, descr, bool(ok),
                                                 creator=cw)
        elif tag == "descr_update":
            # Owner spilled a delegated object: its head descriptor
            # flips to the spill location (consumers restore through
            # the normal SPILLED paths).
            with self.lock:
                for b, descr in msg[1]:
                    st = self.objects.get(ObjectID(b))
                    if st is not None and st.status != PENDING:
                        st.descr = descr
        elif tag == "free_remote":
            # Owner-side free of a segment homed in another store (its
            # direct conn to the creator is gone): route the unlink.
            _, name, size, store_hex = msg
            if store_hex == self.store_id:
                try:
                    self.shm.unlink(name, size, reusable=False)
                except Exception:
                    pass
            else:
                with self.lock:
                    agent = self._agents.get(store_hex)
                if agent is not None and not agent.dead:
                    try:
                        agent.send(("unlink_segment", name, size))
                    except Exception:
                        pass
        elif tag == "mget":
            self._on_worker_mget(worker, msg[1], msg[2], msg[3])
        elif tag == "blocked":
            # A worker blocked in ray.get releases its lease's CPU slot so
            # the cluster can make progress (reference: raylet releases
            # resources for blocked workers, node_manager.cc).  PG tasks
            # keep their bundle slot — the gang reservation is the point.
            with self.lock:
                worker.blocked = True
                if (worker.lease_req is not None and not worker.released
                        and worker.lease_pg is None):
                    worker.node.release(worker.lease_req)
                    worker.released = True
                self._request_dispatch_locked()
        elif tag == "unblocked":
            with self.lock:
                worker.blocked = False
                if worker.lease_req is not None and worker.released:
                    worker.node.acquire(worker.lease_req)
                    worker.released = False
                self._request_dispatch_locked()
        elif tag == "stolen":
            # Tasks the worker relinquished (never started): re-dispatch
            # elsewhere.  Their results can no longer arrive from it.
            with self.lock:
                for tid_bin in msg[2]:
                    rec = worker.inflight.pop(tid_bin, None)
                    if rec is None:
                        continue
                    if rec.cancelled:
                        self._fail_task_locked(rec, exc.TaskCancelledError(
                            rec.spec.get("name", "task")))
                        continue
                    rec.dispatched = False
                    rec.worker = None
                    self._enqueue_pending_locked(rec)
                if worker.pending_force_kill is not None:
                    victim = worker.pending_force_kill
                    worker.pending_force_kill = None
                    if victim in worker.inflight:
                        # Victim already started: kill the process (the
                        # bystanders were just stolen back).
                        try:
                            worker.proc.terminate()
                        except Exception:
                            pass
                if not worker.inflight and worker.lease_req is not None \
                        and not worker.dead and worker.actor_id is None:
                    self._end_lease_locked(worker)
                self._request_dispatch_locked()
        elif tag == "reregister":
            # In-band re-registration from a CLIENT that re-dialed after
            # a head restart (its conn-level handshake already ran via
            # client_ready): reconcile its claims — held leases and
            # re-advertised owned objects.  Gated like the worker path:
            # with the failover switch off nothing reconciles and every
            # failover counter stays zero (the client session itself
            # still works — it re-entered through client_ready).
            if self.config.head_failover:
                with self.lock:
                    self.reregistered_workers += 1
                    self._apply_reregister_claims_locked(worker, msg[1])
        elif tag == "resubmit_batch":
            # Failover replay: specs whose fate at the dead head is
            # unknown to the submitter.  At-least-once semantics (the
            # reference's retry contract): skip anything already known
            # or already completed, run the rest.
            with self.lock:
                fresh = []
                for spec in msg[1]:
                    tid_bin = spec["task_id"]
                    if tid_bin in self.tasks:
                        continue
                    tid = TaskID(tid_bin)
                    sts = [self.objects.get(tid.object_id(i))
                           for i in range(max(1, spec["num_returns"]))]
                    if all(s is not None and s.status != PENDING
                           for s in sts):
                        continue
                    fresh.append(spec)
            if fresh:
                self.submit_tasks_from_worker(fresh, submitter=worker)
        elif tag == "actor_checkpoint":
            # Latest __ray_save__ state from a restartable actor's
            # worker: retain the descriptor for the next restart's
            # __ray_restore__; the superseded checkpoint's storage is
            # freed (checkpoints live outside the object table).
            aid, descr = msg[1], msg[2]
            forced = len(msg) > 3 and bool(msg[3])
            if descr is not None and descr[0] == protocol.PARTS:
                # Drain-forced checkpoint: the worker shipped raw parts
                # because its own store is about to die with the node —
                # re-home the state on the HEAD's surviving store before
                # retaining the descriptor (outside the lock: a big
                # create_from_parts must not stall the reader).
                try:
                    descr = self._store_parts_locally(
                        ObjectID.for_put(), descr[1], descr[2])
                except Exception:
                    descr = None
            ck_ev = None
            with self.lock:
                # A drain waiting on this actor's FORCED checkpoint is
                # released even when the reply carries no state (hookless
                # actor / failed save): the drain must not stall a full
                # deadline on an actor that can never checkpoint.  Only
                # the forced reply releases it — a racing periodic
                # checkpoint (node-homed, mid-flight at drain start)
                # must not end the wait before the re-homed state lands.
                if forced:
                    ck_ev = self._drain_ck_events.pop(aid, None)
                if descr is not None:
                    actor = self.actors.get(aid)
                    if actor is None or actor.status == DEAD:
                        # Racing a death/GC: don't strand the bytes.
                        self._free_checkpoint_locked(actor, descr)
                    elif self._ck_home_dying_locked(descr) \
                            and actor.checkpoint is not None \
                            and not self._ck_home_dying_locked(
                                actor.checkpoint):
                        # A periodic checkpoint homed on a DRAINING/dead
                        # store must never supersede a safely-homed one:
                        # the exec thread's post-method save races the
                        # drain's forced re-homed checkpoint, and losing
                        # that race would strand the restart on a store
                        # that dies with the node.
                        self._free_checkpoint_locked(None, descr)
                    else:
                        old, actor.checkpoint = actor.checkpoint, descr
                        if old is not None:
                            self._free_checkpoint_locked(actor, old)
            if ck_ev is not None:
                ck_ev.set()

    def submit_task_from_worker(self, spec: dict, submitter=None):
        """Nested submission: worker-generated task, driver-owned objects."""
        self.submit_tasks_from_worker([spec], submitter=submitter)

    def submit_tasks_from_worker(self, specs: List[dict], submitter=None):
        """Bulk form of the nested-submission path (the wire carries it
        as one ("submit_batch", [spec, ...]) message): every spec
        registers under ONE lock acquisition, then one dispatch pass /
        one pump per distinct actor covers the whole batch."""
        self._submit_specs(specs, from_worker=True, submitter=submitter)

    def _on_worker_mget(self, worker: WorkerHandle, rid, id_bins, timeout):
        """Batched worker get: ONE reply listing (ok, descr) per id, sent
        when all are complete (or the timeout fires).  Reference:
        CoreWorker::Get resolves the whole batch (core_worker.cc:1250)."""
        state = {"left": 0, "done": False, "timer": None}

        def finish_locked():
            if state["done"]:
                return
            state["done"] = True
            if state["timer"] is not None:
                state["timer"].cancel()
            out = []
            for b in id_bins:
                st = self.objects.get(ObjectID(b))
                if st is None:
                    err = serialization.dumps_inline(exc.ObjectFreedError(  # noqa: RTL604 -- bounded-small error payload on the miss path
                        object_id=b.hex(), owner="driver", phase="get"))
                    out.append((False, (protocol.ERROR, err)))
                elif st.status == PENDING:
                    err = serialization.dumps_inline(exc.GetTimeoutError(  # noqa: RTL604 -- bounded-small error payload on the timeout path
                        f"Timed out getting {b.hex()} after {timeout}s"))
                    out.append((False, (protocol.ERROR, err)))
                else:
                    st.shipped = True
                    out.append((st.status == READY, st.descr))
            try:
                self._queue_send(worker, ("mgot", rid, out))
            except Exception:
                # Requester died mid-wait: never let its broken conn abort
                # the completing worker's result handling (this runs inside
                # _complete_object_locked's waiter loop).
                pass

        with self.lock:
            if time.monotonic() < self._failover_grace_until:
                # Post-restart grace: an unknown id may belong to the
                # blip window (task finished after the last snapshot, or
                # still running on a worker that has not re-registered
                # yet).  Park it as implicitly-PENDING instead of
                # insta-failing; the reconcile timer fails the remainder
                # as reconstruction candidates.
                for b in id_bins:
                    oid = ObjectID(b)
                    if oid not in self.objects:
                        self.objects[oid] = ObjectState()
                        self._grace_objects.add(b)
            pend = [st for b in id_bins
                    if (st := self.objects.get(ObjectID(b))) is not None
                    and st.status == PENDING]
            if not pend:
                # Everything ready: answer immediately, no steal — the
                # worker unblocks right away, so stripping its pipeline
                # would be pure churn.
                finish_locked()
                return
            # The get really waits.  Steal back the worker's pipelined-but-
            # unstarted tasks: one of them may be (or produce a dependency
            # of) exactly what this get awaits — the head-of-line deadlock
            # (reference: work stealing in direct_task_transport).  The
            # worker replies "stolen" with the ids it had not started.
            stealable = [tid for tid, r in worker.inflight.items()
                         if not r.is_actor_creation]
            if stealable:
                try:
                    self._queue_send(worker, ("steal", 0, stealable))
                except Exception:
                    pass
            state["left"] = len(pend)

            def cb(_oid):  # runs under self.lock (RLock) in _complete
                state["left"] -= 1
                if state["left"] == 0:
                    finish_locked()

            for st in pend:
                st.waiters.append(cb)
            if timeout is not None:
                def on_timeout():
                    with self.lock:
                        finish_locked()
                t = state["timer"] = threading.Timer(timeout, on_timeout)
                t.daemon = True
                t.start()

    def _on_result(self, worker: WorkerHandle, task_id_bin, ok, returns,
                   meta):
        recovery.syncpoint("result")
        retry_err = None
        if not ok and returns and returns[0][0] == protocol.ERROR:
            # Only tasks that OPTED INTO retry_exceptions get their
            # error payload deserialized (outside the lock — RTL402);
            # for everyone else the head keeps treating error bytes as
            # opaque, exactly as before — a failure storm must not turn
            # the result loop into a user-exception unpickling loop.
            with self.lock:
                rec0 = self.tasks.get(task_id_bin)
                wants_retry = (rec0 is not None
                               and rec0.spec.get("retry_exceptions")
                               and rec0.app_retries_left > 0
                               and rec0.actor_id is None
                               and not rec0.is_actor_creation
                               and not rec0.cancelled)
            if wants_retry:
                # An unloadable payload just skips the retry check.
                try:
                    retry_err = serialization.loads_inline(returns[0][1])
                except Exception:
                    retry_err = None
        with self.lock:
            rec = self.tasks.pop(task_id_bin, None)
            if rec is None:
                # No record, but PENDING return entries exist: a blip-
                # window result (task finished while the head was down;
                # the worker's outbox replayed it after re-register).
                # Live retries keep their task record, so this can never
                # swallow a result a retry now owns.
                tid = TaskID(task_id_bin)
                for i, descr in enumerate(returns):
                    st = self.objects.get(tid.object_id(i))
                    if st is not None and st.status == PENDING:
                        self._complete_object_locked(
                            tid.object_id(i), descr,
                            descr[0] != protocol.ERROR, creator=worker)
                return
            if (retry_err is not None and not rec.is_actor_creation
                    and rec.actor_id is None and not rec.cancelled
                    and rec.app_retries_left > 0
                    and recovery.retry_matches(
                        rec.spec.get("retry_exceptions"), retry_err)):
                # Opt-in APPLICATION-error retry: re-queue the task
                # instead of completing its error objects.  Draws from
                # its own budget — the system-failure retries_left is
                # untouched (max_retries decrements only on worker/node
                # death; pinned by the retry-counting test).
                rec.app_retries_left -= 1
                rec.dispatched = False
                rec.worker = None
                self.tasks[task_id_bin] = rec
                worker.inflight.pop(task_id_bin, None)
                self.task_events.append(
                    {"task_id": task_id_bin.hex(),
                     "name": rec.spec.get("name"),
                     "state": "RETRYING", "time": time.time()})
                self._enqueue_pending_locked(rec)
                self._request_dispatch_locked([rec.sched_key])
                if not worker.inflight and not worker.dead \
                        and worker.lease_req is not None:
                    self._end_lease_locked(worker)
                    self._request_dispatch_locked()
                return
            tid = TaskID(task_id_bin)
            for i, descr in enumerate(returns):
                item_ok = descr[0] != protocol.ERROR
                self._complete_object_locked(tid.object_id(i), descr,
                                             item_ok, creator=worker)
            self._unpin_task_deps_locked(rec)
            self.task_events.append(
                {"task_id": task_id_bin.hex(),
                 "name": rec.spec.get("name"),
                 "state": "FINISHED" if ok else "FAILED",
                 "time": time.time()})
            if rec.is_actor_creation:
                actor = self.actors[rec.actor_id]
                worker.inflight.pop(task_id_bin, None)
                if actor.status == DEAD or rec.cancelled:
                    # GC'd (all handles dropped) or cancelled while the
                    # creation was in flight: the worker must not become
                    # a live actor nobody can ever reference — retire it
                    # and return its slot.
                    self._end_lease_locked(worker, reap=True)
                    self._dispatch_locked()
                    return
                if ok:
                    actor.status = ALIVE
                    actor.worker = worker
                    actor.node = rec.node
                    worker.actor_id = rec.actor_id
                    if not actor.created_future.done():
                        actor.created_future.set_result(True)
                    self._pump_actor_locked(actor)
                # failure path handled via _fail_task? create failure comes
                # back as result with ok=False:
                else:
                    err = serialization.loads_inline(returns[0][1])  # noqa: RTL402 -- cold actor-creation-failure path; inline error payloads are small
                    actor.status = DEAD
                    actor.death_cause = err
                    if not actor.created_future.done():
                        actor.created_future.set_exception(err)
                    self._fail_actor_queue_locked(actor, err)
                    self._end_lease_locked(worker, reap=True)
                return
            if worker.actor_id is not None:
                actor = self.actors.get(worker.actor_id)
                if actor is not None:
                    actor.inflight.pop(task_id_bin, None)
                    self._pump_actor_locked(actor)
                return
            worker.inflight.pop(task_id_bin, None)
            # Top up this worker's pipeline before deciding the lease is
            # over.  Sharded: only this worker's own class can have
            # gained a slot — scan just that shard inline; the global
            # pass runs (deferred) only when the lease actually ends and
            # returns resources anything could use.
            if self.config.decentralized_dispatch:
                if worker.lease_key is not None:
                    self._dispatch_class_locked(worker.lease_key)
                if not worker.inflight and not worker.dead \
                        and worker.lease_req is not None:
                    self._end_lease_locked(worker)
                    self._request_dispatch_locked()
            else:
                self._dispatch_locked()
                if not worker.inflight and not worker.dead \
                        and worker.lease_req is not None:
                    self._end_lease_locked(worker)

    def _reroute_dead_worker_frees_locked(self, worker: WorkerHandle):
        """A dead worker's buffered free_segment messages would vanish
        with its conn: run the store-side fallback unlink instead (the
        path the pre-conflation direct-send error handling took) so the
        segments don't leak until session end."""
        with worker.send_lock:
            msgs = worker.outbuf + worker.outbox
            worker.outbuf = []
            worker.outbox = []
        flat: List[tuple] = []
        for m in msgs:
            if protocol.is_batch(m):
                flat.extend(m[1])
            else:
                flat.append(m)
        agent = worker.node.agent if worker.node is not None else None
        for m in flat:
            if m[0] != "free_segment":
                continue
            name, size = m[1], m[2]
            if agent is None:
                try:
                    self.shm.unlink(name, size, reusable=False)
                except Exception:
                    pass
            elif not agent.dead:
                try:
                    agent.send(("unlink_segment", name, size))  # noqa: RTL604 -- worker-death path; final best-effort reroute of its buffered frees
                except Exception:
                    pass

    def _kill_worker_locked(self, worker: WorkerHandle):
        worker.dead = True
        self._conn_to_worker.pop(worker.conn, None)
        self._workers_by_hex.pop(worker.worker_id.hex(), None)
        worker.node.all_workers.pop(id(worker), None)
        self.worker_funcs.pop(id(worker), None)
        # Ship anything still buffered (frees, steals) before the kill;
        # whatever cannot be delivered gets its store-side fallback.
        try:
            worker.flush_buffered()
        except Exception:
            pass
        self._reroute_dead_worker_frees_locked(worker)
        try:
            worker.send(("kill",))  # noqa: RTL604 -- death path: kill must be ordered after the final flush on this conn
        except Exception:
            pass
        try:
            worker.conn.close()
        except Exception:
            pass

    def _on_worker_death(self, worker: WorkerHandle):
        with self.lock:
            if worker.dead:
                # A failed flush can re-buffer messages AFTER the first
                # death pass drained them (reader-thread EOF and sender-
                # thread send failure race): drain again so rerouted
                # frees are never lost.  Idempotent.
                self._reroute_dead_worker_frees_locked(worker)
                return
            worker.dead = True
            self._conn_to_worker.pop(worker.conn, None)
            self._workers_by_hex.pop(worker.worker_id.hex(), None)
            worker.node.all_workers.pop(id(worker), None)
            self.worker_funcs.pop(id(worker), None)
            self._reroute_dead_worker_frees_locked(worker)
            for key, lst in worker.node.idle_workers.items():
                if worker in lst:
                    lst.remove(worker)
            # Workers this one had leased for direct push return to the
            # pool (their direct conns EOF on their own).
            for node in self.nodes.values():
                for w in list(node.all_workers.values()):
                    if w.client_lease is worker:
                        w.client_lease = None
                        if not w.dead:
                            self._end_lease_locked(w)
            if worker.client_lease is not None \
                    and not worker.client_lease.dead \
                    and self.config.decentralized_dispatch:
                # This worker was leased OUT and died (node death rides
                # the same path — the agent's death handler drives it):
                # revoke explicitly so the holder reroutes its pushed
                # specs now instead of waiting on a direct-conn EOF.
                # Rides the conflation sender like every control-plane
                # notification.
                self.lease_revocations += 1
                self._queue_send(worker.client_lease,
                                 ("lease_revoke",
                                  [worker.worker_id.hex()]))
            worker.client_lease = None
            # Pending-export shells this worker owed a completion for:
            # the owner is gone, fail them (owner-death semantics).
            for oid, st in list(self.objects.items()):
                if st.exporter is worker and st.status == PENDING:
                    # OwnerDiedError (non-reconstructable): the exporter
                    # was the metadata authority; its lineage died too.
                    err = (protocol.ERROR, serialization.dumps_inline(  # noqa: RTL402 -- cold worker-death path; constant-sized error payload
                        exc.OwnerDiedError(
                            object_id=oid.hex(),
                            owner=worker.worker_id.hex(),
                            phase="export")))
                    st.exporter = None
                    self._complete_object_locked(oid, err, False)
            if worker.actor_id is not None:
                self._on_actor_worker_death(worker)
                return
            inflight = list(worker.inflight.values())
            worker.inflight.clear()
            self._end_lease_locked(worker)
            for rec in inflight:
                # Every task pipelined onto the dead worker retries
                # elsewhere (reference: task retries by the owner,
                # task_manager.h:174).
                if rec.retries_left > 0 and not rec.cancelled:
                    rec.retries_left -= 1
                    rec.dispatched = False
                    rec.worker = None
                    self.tasks[rec.spec["task_id"]] = rec
                    self._enqueue_pending_locked(rec)
                else:
                    self.tasks.pop(rec.spec["task_id"], None)
                    if rec.cancelled:
                        err = exc.TaskCancelledError(
                            rec.spec.get("name", "task"))
                    elif worker.oom_killed:
                        err = exc.OutOfMemoryError(
                            f"Task {rec.spec.get('name', 'task')} was "
                            f"killed by the memory monitor (node memory "
                            f"over threshold) and has no retries left")
                    else:
                        err = exc.WorkerCrashedError(
                            f"Worker died executing "
                            f"{rec.spec.get('name', 'task')}")
                    self._fail_task_locked(rec, err)
            self._dispatch_locked()

    def _on_actor_worker_death(self, worker: WorkerHandle):
        actor = self.actors.get(worker.actor_id)
        if actor is None:
            return
        # The actor held its creation lease for life; return it (resources,
        # PG bundle share, TPU chips).
        self._end_lease_locked(worker)
        req = actor.options.get("resources") or {"CPU": 1.0}
        err = exc.ActorDiedError(
            f"Actor {worker.actor_id.hex()} died (worker exit)")
        will_restart = actor.restarts_left != 0 and not self._stopped
        # In-flight method calls: replayed onto the restarted actor per
        # max_task_retries (at-least-once — the call may have partially
        # executed before the death, exactly the reference's contract),
        # else failed with ActorDiedError.  Queued-but-undispatched
        # calls always survive the restart (they never reached the dead
        # worker).  Worker/node death is a SYSTEM failure: it alone
        # decrements the replay budget.
        replay: List[TaskRecord] = []
        mtr = actor.options.get("max_task_retries", 0)
        for tid_bin, rec in list(actor.inflight.items()):
            if (will_restart and self.config.recovery and mtr != 0
                    and (mtr < 0 or rec.retries_left > 0)
                    and not rec.cancelled):
                if rec.retries_left > 0:
                    rec.retries_left -= 1
                rec.dispatched = False
                rec.worker = None
                replay.append(rec)
            else:
                self._fail_task_locked(rec, err)
        actor.inflight.clear()
        actor.worker = None
        if will_restart:
            if actor.restarts_left > 0:
                actor.restarts_left -= 1
            actor.status = RESTARTING
            if self.config.recovery:
                self.actor_restarts += 1
            # Replayed calls go BACK TO THE FRONT in their original send
            # order, ahead of anything queued behind them.
            for rec in reversed(replay):
                actor.queue.appendleft(rec)
            spec = {
                "task_id": new_task_id().binary(),
                "func_id": actor.func_id,
                "args": actor.init_args,
                "kwargs": actor.init_kwargs,
                "num_returns": 1,
                "name": "actor.__restart__",
                "resources": req,
                "scheduling_strategy": actor.options.get(
                    "scheduling_strategy"),
            }
            rec = TaskRecord(spec, req, 0)
            rec.is_actor_creation = True
            rec.actor_id = actor.actor_id
            strategy = spec.get("scheduling_strategy")
            if strategy and strategy[0] == "placement_group":
                rec.pg_id = strategy[1]
                rec.bundle_index = strategy[2]
            tid = TaskID(spec["task_id"])
            self.objects[tid.object_id(0)] = ObjectState(tid)
            self.tasks[spec["task_id"]] = rec
            self._enqueue_pending_locked(rec)
            self._dispatch_locked()
        else:
            actor.status = DEAD
            actor.death_cause = err
            self._gcs_dirty += 1
            self._fail_actor_queue_locked(actor, err)
            self._free_checkpoint_locked(actor)
            # The lease just returned the actor's resources: anything
            # waiting on capacity (pending tasks, parked client leases)
            # must get a dispatch pass — without this, a task submitted
            # while the actor held the last slot pends forever.
            self._dispatch_locked()

    def _ck_home_dying_locked(self, descr) -> bool:
        """Whether a checkpoint descriptor is homed on a store that is
        draining or already gone — state that dies with its node and
        must not displace a safely-homed checkpoint."""
        if descr is None or descr[0] not in (protocol.SHM,
                                             protocol.SPILLED) \
                or len(descr) <= 3:
            return False
        home = descr[3]
        if home == self.store_id:
            return False
        node = self._node_for_store_locked(home)
        return node is None or not node.alive or node.draining

    def _free_checkpoint_locked(self, actor: Optional[ActorState],
                                descr=None):
        """Unlink a checkpoint's storage (the superseded one on refresh,
        the last one at actor death).  Checkpoint segments live outside
        the object table, so their lifecycle is managed here: home-store
        routed like free_remote."""
        if descr is None:
            if actor is None:
                return
            descr, actor.checkpoint = actor.checkpoint, None
        if descr is None or descr[0] not in (protocol.SHM,
                                             protocol.SPILLED):
            return
        home = descr[3] if len(descr) > 3 else self.store_id
        if home == self.store_id:
            try:
                if descr[0] == protocol.SPILLED:
                    os.unlink(descr[1])
                else:
                    self.shm.unlink(descr[1], descr[2], reusable=False)
            except Exception:
                pass
        else:
            agent = self._agents.get(home)
            if agent is not None and not agent.dead:
                try:
                    agent.send(("unlink_segment", descr[1], descr[2]))  # noqa: RTL604 -- checkpoint GC is rare; one small control frame per freed ckpt
                except Exception:
                    pass

    # ----------------------------------------------------- memory monitor --
    def _memory_monitor_loop(self):
        """Kill one task worker per interval while node memory stays
        above the threshold (reference: memory_monitor.h sampling +
        worker_killing_policy_group_by_owner.cc — newest retriable task
        first, so long-running work survives and the retry is cheap)."""
        from ray_tpu_torch._private import memmon

        cfg = self.config
        while not self._stopped:
            time.sleep(cfg.memory_monitor_interval_s)
            try:
                frac = memmon.memory_usage_fraction(
                    cfg.memory_monitor_test_file)
            except Exception:
                continue
            if frac >= cfg.memory_monitor_threshold:
                # This loop samples HEAD-node memory: victims must be
                # head-local (remote nodes sample via their agent's
                # oom_pressure, scoped the same way).
                self._oom_kill_one(frac, node=self.head_node)

    def _oom_kill_one(self, frac: float, node: Optional[NodeState] = None):
        """Pick and kill the newest-dispatched plain-task worker (actors
        and idle workers are never victims); its tasks retry via the
        normal death path, typed OutOfMemoryError when retries run out."""
        victim = None
        with self.lock:
            nodes = [node] if node is not None else list(
                self.nodes.values())
            best = -1.0
            for nd in nodes:
                for w in nd.all_workers.values():
                    if (w.dead or w.oom_killed or w.actor_id is not None
                            or not w.inflight):
                        continue
                    if any(rec.is_actor_creation
                           for rec in w.inflight.values()):
                        # actor_id is only set AFTER __init__ returns:
                        # without this check the monitor would target
                        # actors mid-creation (peak memory = exactly
                        # when pressure fires), inverting the
                        # actors-are-never-victims policy.
                        continue
                    if w.last_dispatch_ts > best:
                        best = w.last_dispatch_ts
                        victim = w
            if victim is not None:
                victim.oom_killed = True
        if victim is None:
            return
        print(f"[ray_tpu_torch] memory monitor: node usage {frac:.0%} >= "
              f"{self.config.memory_monitor_threshold:.0%}, killing "
              f"worker {victim.worker_id.hex()[:12]} "
              f"({len(victim.inflight)} task(s) will retry)",
              file=sys.stderr)
        if victim.proc is not None:
            try:
                victim.proc.terminate()
            except Exception:
                pass
        elif victim.node.agent is not None and not victim.node.agent.dead:
            try:
                victim.node.agent.send(
                    ("kill_worker", victim.worker_id.hex()))
            except Exception:
                pass

    # -------------------------------------------------------- log monitor --
    def _record_worker_lines(self, worker_id_hex: str, lines, node=""):
        # Ring mutation under the lock: state_query("worker_log")
        # iterates these structures under the same lock.
        with self.lock:
            ring = self._worker_logs.setdefault(worker_id_hex,
                                                deque(maxlen=1000))
            ring.extend(lines)
        if self.config.log_to_driver:
            prefix = f"(worker={worker_id_hex[:8]}" + (
                f" node={node[:8]})" if node else ")")
            for ln in lines:
                print(f"{prefix} {ln}", file=sys.stderr)

    def _log_monitor_loop(self):
        """Tail head-local worker log files into per-worker rings and the
        driver's stderr (reference: log_monitor.py — file tailing with
        (pid=, ip=) prefixes; remote nodes' agents ship their lines via
        ("worker_logs", ...) instead)."""
        from ray_tpu_torch._private.logtail import tail_worker_logs

        log_dir = os.path.join(self._sock_dir, "logs")
        offsets: Dict[str, int] = {}
        partial: Dict[str, bytes] = {}
        while not self._stopped:
            time.sleep(0.5)
            for wid, lines in tail_worker_logs(log_dir, offsets, partial):
                self._record_worker_lines(wid, lines)

    # -------------------------------------------------------- suspicion --
    def _suspicion_loop(self):
        """Head-side gray-failure detector (reference:
        gcs_health_check_manager.h — initial delay / timeout / period /
        failure threshold; HotOS'17 gray failure: DIFFERENTIAL
        observation, this peer's link to us, not its process table).

        Every live agent and worker is expected to message us at least
        once per ``health_check_period_s`` (the heartbeat floor rides
        under their existing periodic traffic).  Silence past
        ``health_check_timeout_s`` marks the peer SUSPECT (counted) and
        starts probing (``hc_probe`` — answered by the peer's reader
        thread even while it computes); ``health_check_failure_threshold``
        unanswered probes declare it DEAD and feed the EXISTING death
        path — lease revocation, lineage reconstruction, drain
        bookkeeping — exactly as a clean kill would."""
        cfg = self.config
        timeout = cfg.health_check_timeout_s
        period = cfg.health_check_period_s
        threshold = max(1, cfg.health_check_failure_threshold)
        tick = max(0.1, min(period, timeout / 2.0 or period) / 2.0)
        # Initial grace: a freshly-booted cluster's peers get extra slack
        # before their first deadline (boot + env build + JIT warmup).
        initial = cfg.health_check_initial_delay_s
        time.sleep(min(initial, 2.0) if initial > 0 else tick)
        while not self._stopped:
            time.sleep(tick)
            now = time.monotonic()
            probes = []   # (send_fn, peer) pairs, fired outside the lock
            dead_agents = []
            dead_workers = []
            with self.lock:
                for agent in list(self._agents.values()):
                    if agent.dead or agent.node is None:
                        continue
                    if "hc_probe" not in tuple(
                            agent.info.get("agent_caps") or ()):
                        continue  # old agent: never probed (PR-3 rule)
                    self._suspect_step_locked(agent, now, timeout,
                                              period, threshold,
                                              probes, dead_agents)
                for node in self.nodes.values():
                    for w in node.all_workers.values():
                        if (w.dead or w.conn is None
                                or not w.ready.is_set()
                                or w.env_key == "client"):
                            continue
                        self._suspect_step_locked(w, now, timeout,
                                                  period, threshold,
                                                  probes, dead_workers)
            for peer in probes:
                # Try-lock, not send(): a dispatcher blocked mid-send
                # to this very peer (wedged reader, full buffer) holds
                # send_lock — the probe must not wedge the suspicion
                # thread with it.  The miss was already counted; an
                # unsendable probe is just a confirmed miss.
                if not peer.send_lock.acquire(timeout=0.5):
                    continue
                try:
                    protocol.send(peer.conn, ("hc_probe", 0))
                except Exception:
                    pass  # a failed probe send is itself a miss
                finally:
                    peer.send_lock.release()
            for agent in dead_agents:
                print(f"[ray_tpu_torch] failure detection: node "
                      f"{agent.node.node_id.hex()[:12]} declared DEAD "
                      f"after {threshold} missed probes "
                      f"(silent {now - agent.last_seen:.1f}s)",
                      file=sys.stderr)
                try:
                    # Shutdown frees a reader parked inside a stalled
                    # recv (close alone cannot wake it); it exits via
                    # the idempotent death path.
                    protocol.shutdown_conn(agent.conn)
                    agent.conn.close()
                except Exception:
                    pass
                # Drive death handling NOW, like chaos.kill_agent —
                # don't depend on the reader waking at all.
                self._on_agent_death(agent)
            for w in dead_workers:
                print(f"[ray_tpu_torch] failure detection: worker "
                      f"{w.worker_id.hex()[:12]} declared DEAD after "
                      f"{threshold} missed probes",
                      file=sys.stderr)
                conn = w.conn
                self._on_worker_death(w)
                if conn is not None:
                    try:
                        protocol.shutdown_conn(conn)
                        conn.close()
                    except Exception:
                        pass

    def _suspect_step_locked(self, peer, now, timeout, period, threshold,
                             probes, dead):
        """One suspicion-machine step for one peer (WorkerHandle or
        AgentHandle — both carry last_seen/hc_* state).  Appends to
        ``probes``/``dead`` for the caller to act on OUTSIDE the lock."""
        silence = now - peer.last_seen
        if silence <= timeout:
            if peer.hc_suspect:
                peer.hc_suspect = False  # spoke again: fully absolved
            peer.hc_misses = 0
            return
        if not peer.hc_suspect:
            peer.hc_suspect = True
            peer.hc_misses = 0
            peer.hc_probe_ts = 0.0
            self.suspected_nodes += 1
        if now - peer.hc_probe_ts >= period:
            peer.hc_probe_ts = now
            peer.hc_misses += 1
            if peer.hc_misses > threshold:
                dead.append(peer)
            else:
                probes.append(peer)

    # ------------------------------------------------------------- reaper --
    def _reap_loop(self):
        while not self._stopped:
            time.sleep(self.config.health_check_period_s)
            now = time.monotonic()
            dead_pending = []
            with self.lock:
                if self.config.decentralized_dispatch \
                        and self.config.lease_ttl_s > 0:
                    # Expired client leases: the holder stopped renewing
                    # (died or hung mid-push).  Pushed-task state is
                    # invisible to the head, so the worker is RETIRED,
                    # not pooled — holder-side retries cover its queue,
                    # the same semantics as worker death.
                    expired = [
                        w for node in self.nodes.values()
                        for w in node.all_workers.values()
                        if w.client_lease is not None and not w.dead
                        and w.lease_expiry is not None
                        and now > w.lease_expiry]
                    for w in expired:
                        lessee = w.client_lease
                        w.client_lease = None
                        self.lease_revocations += 1
                        if lessee is not None and not lessee.dead:
                            self._queue_send(
                                lessee, ("lease_revoke",
                                         [w.worker_id.hex()]))
                        self._end_lease_locked(w, reap=True)
                    if expired:
                        self._request_dispatch_locked()
                for node in self.nodes.values():
                    for key, lst in node.idle_workers.items():
                        keep = []
                        for w in lst:
                            if (now - w.idle_since >
                                    self.config.idle_worker_timeout_s):
                                self._kill_worker_locked(w)
                            else:
                                keep.append(w)
                        node.idle_workers[key] = keep
                # Workers that died (or hung) before dialing back.
                for wid, w in list(self._pending_workers.items()):
                    # Agent-spawned workers have no local proc handle;
                    # their crash shows as a start timeout.
                    crashed = (w.proc is not None
                               and w.proc.poll() is not None)
                    timed_out = (now - w.spawned_at >
                                 self.config.worker_start_timeout_s)
                    if crashed or timed_out:
                        self._pending_workers.pop(wid, None)
                        dead_pending.append(w)
            for w in dead_pending:
                if w.proc is not None:
                    try:
                        w.proc.terminate()
                    except Exception:
                        pass
                elif w.node.agent is not None and not w.node.agent.dead:
                    try:
                        w.node.agent.send(
                            ("kill_worker", w.worker_id.hex()))
                    except Exception:
                        pass
                self._on_worker_death(w)

    # ----------------------------------------------------------- KV store --
    def kv_put(self, key: bytes, value: bytes, namespace="default",
               overwrite=True) -> bool:
        with self.lock:
            ns = self.kv.setdefault(namespace, {})
            if not overwrite and key in ns:
                return False
            ns[key] = value
            self._gcs_dirty += 1
            return True

    def kv_get(self, key: bytes, namespace="default"):
        with self.lock:
            return self.kv.get(namespace, {}).get(key)

    def kv_del(self, key: bytes, namespace="default"):
        with self.lock:
            self._gcs_dirty += 1
            return self.kv.get(namespace, {}).pop(key, None) is not None

    def kv_keys(self, prefix: bytes = b"", namespace="default"):
        with self.lock:
            return [k for k in self.kv.get(namespace, {})
                    if k.startswith(prefix)]

    # ------------------------------------------------------------ cancel --
    def poll_events(self, topic: str) -> list:
        """Drain pubsub payloads for a topic (driver side)."""
        with self.lock:
            q = self.events.get(topic)
            if not q:
                return []
            out = list(q)
            q.clear()
            return out

    def add_event_listener(self, topic: str, cb) -> None:
        """Fire ``cb()`` (no payload — consumers drain via poll_events)
        whenever a worker publishes on ``topic``.  The autoscaler's
        serve-event trigger: a controller scale event wakes the
        reconcile loop immediately instead of waiting out its tick."""
        with self.lock:
            self._event_listeners.setdefault(topic, []).append(cb)

    def remove_event_listener(self, topic: str, cb) -> None:
        """Unregister a listener added by add_event_listener (a stopped
        autoscaler must not stay referenced — and woken — forever)."""
        with self.lock:
            lst = self._event_listeners.get(topic)
            if lst is not None:
                try:
                    lst.remove(cb)
                except ValueError:
                    pass
                if not lst:
                    self._event_listeners.pop(topic, None)

    def cancel_task(self, object_id: ObjectID, force=False):
        with self.lock:
            st = self.objects.get(object_id)
            if st is None or st.task_id is None:
                return
            rec = self.tasks.get(st.task_id.binary())
            if rec is None:
                return
            rec.cancelled = True
            if not rec.dispatched:
                # Drop the record from its scheduling-class queue now —
                # dispatch stops at an unplaceable class head, so cancelled
                # records behind it would otherwise be retained forever.
                q = self.pending_tasks.get(rec.sched_key
                                           or self._sched_class(rec))
                if q is not None:
                    try:
                        q.remove(rec)
                    except ValueError:
                        pass
                self._fail_task_locked(rec, exc.TaskCancelledError(
                    rec.spec.get("name", "task")))
            elif force and rec.worker is not None:
                rec.retries_left = 0
                w = rec.worker
                if w.actor_id is not None or not w.inflight:
                    # Actor worker (no pipelined plain tasks) or nothing to
                    # rescue: kill immediately.
                    try:
                        w.proc.terminate()
                    except Exception:
                        pass
                else:
                    # Steal back every unstarted pipelined task first; the
                    # "stolen" handler terminates the process only if the
                    # victim had actually started (bystanders would
                    # otherwise burn retries or die as WorkerCrashedError).
                    w.pending_force_kill = rec.spec["task_id"]
                    try:
                        self._queue_send(w, ("steal", 0,
                                             list(w.inflight.keys())))
                    except Exception:
                        try:
                            w.proc.terminate()
                        except Exception:
                            pass
                    # A wedged worker (GIL held in C code) never answers
                    # the steal — the whole point of force-kill.  Fall back
                    # to terminate if no "stolen" reply resolves it in time.
                    def _force_kill_fallback(w=w):
                        with self.lock:
                            if w.pending_force_kill is None or w.dead:
                                return
                            w.pending_force_kill = None
                        try:
                            w.proc.terminate()
                        except Exception:
                            pass
                    t = threading.Timer(2.0, _force_kill_fallback)
                    t.daemon = True
                    t.start()
            elif rec.worker is not None:
                # Pipelined onto a worker but possibly not started: try to
                # steal it back; the "stolen" handler sees cancelled=True
                # and fails it.  Already-started tasks are uncancellable
                # without force (reference semantics).
                try:
                    self._queue_send(rec.worker,
                                     ("steal", 0, [rec.spec["task_id"]]))
                except Exception:
                    pass

    # ---------------------------------------------------------- shutdown --
    def shutdown(self):
        if self._stopped:
            return
        self._stopped = True
        self._gcs_stop.set()  # wake the snapshot loop out of its wait
        if self.config.gcs_snapshot_path:
            # Final snapshot while the tables are still live: a clean
            # shutdown must leave a restartable image even if the last
            # periodic write raced this exit.
            try:
                self._snapshot_gcs(clean=True)
            except Exception:
                with self.lock:
                    self.gcs_snapshot_failures += 1
        self._sender_event.set()  # unblock the conflation sender's exit
        self._dispatch_event.set()  # unblock the dispatcher's exit
        with self.lock:
            workers = [w for n in self.nodes.values()
                       for w in list(n.all_workers.values())]
            for n in self.nodes.values():
                for lst in n.idle_workers.values():
                    workers.extend(lst)
        with self.lock:
            workers.extend(self._pending_workers.values())
            self._pending_workers.clear()
        for w in set(workers):
            try:
                w.send(("kill",))
            except Exception:
                pass
        deadline = time.monotonic() + 2.0
        for w in set(workers):
            try:
                w.proc.wait(max(0.05, deadline - time.monotonic()))
            except Exception:
                try:
                    w.proc.terminate()
                except Exception:
                    pass
        try:
            self._listener.close()
            self._tcp_listener.close()
        except Exception:
            pass
        try:
            self._obj_listener.close()
        except Exception:
            pass
        try:
            self._puller.close()
        except Exception:
            pass
        for agent in list(self._agents.values()):
            try:
                agent.send(("shutdown",))
                agent.conn.close()
            except Exception:
                pass
        self.shm.cleanup()
        # Worker-created segments (task results still referenced at exit)
        # are in this session's namespace but not in the driver store's
        # created-set; sweep them by prefix.
        import glob as _glob

        for path in _glob.glob(os.path.join(
                self.shm._dir, f"rtpu-{self.session_id}-*")):
            try:
                os.unlink(path)
            except OSError:
                pass
        try:
            import shutil as _shutil

            _shutil.rmtree(self.spill_dir, ignore_errors=True)
        except Exception:
            pass
        try:
            import shutil

            shutil.rmtree(self._sock_dir, ignore_errors=True)
        except Exception:
            pass

    # ------------------------------------------------------- introspection --
    def cluster_resources(self):
        with self.lock:
            total: Dict[str, float] = {}
            for n in self.nodes.values():
                if not n.alive:
                    continue
                for k, v in n.resources.items():
                    total[k] = total.get(k, 0.0) + v
            return total

    def available_resources(self):
        with self.lock:
            total: Dict[str, float] = {}
            for n in self.nodes.values():
                if not n.alive:
                    continue
                for k, v in n.available.items():
                    total[k] = total.get(k, 0.0) + v
            return total

    def pending_resource_demand(self) -> List[Dict[str, float]]:
        """Resource shapes of everything queued-but-unplaced: the
        autoscaler's scale-up signal (reference: pending demand reported to
        the monitor, resource_demand_scheduler.py)."""
        with self.lock:
            out: List[Dict[str, float]] = []
            for q in self.pending_tasks.values():
                for rec in q:
                    if not rec.dispatched and not rec.cancelled:
                        out.append(dict(rec.requirements))
            for pg in self.pending_pgs:
                out.extend(dict(b) for b in pg.bundles)
            # Lease starvation: client lease requests PARKED for lack of
            # capacity are demand the task queues never show — the
            # holder's tasks wait inside its own DirectCaller, invisible
            # here.  Feeding the parked shapes in is what lets the
            # autoscaler scale for direct-path (leased) traffic too.
            for p in self._pending_client_leases:
                if not p["lessee"].dead:
                    out.extend(dict(p["req"]) for _ in range(max(1,
                                                                 p["n"])))
            return out

    def node_activity(self) -> List[Dict[str, Any]]:
        """Per-node busy/idle for autoscaler scale-down decisions."""
        with self.lock:
            out = []
            for node in self.nodes.values():
                busy = any((w.inflight or w.actor_id is not None)
                           and not w.dead
                           for w in node.all_workers.values())
                out.append({
                    "node_id": node.node_id.hex(),
                    "alive": node.alive,
                    "is_head": node is self.head_node,
                    "busy": busy,
                    "draining": node.draining,
                    "resources": dict(node.resources),
                    "available": dict(node.available),
                })
            return out

    def state_query(self, kind: str, limit: int = 10000,
                    **filters) -> list:
        """State-observability reads over the authoritative tables
        (reference: python/ray/experimental/state/api.py:738,961,1005 —
        there an aggregator service queries GCS + raylets; here the tables
        are driver-resident so this is a read under the lock)."""
        if kind == "nodes":
            return self.list_nodes()[:limit]
        if kind == "actors":
            with self.lock:
                out = []
                for aid, a in self.actors.items():
                    out.append({
                        "actor_id": aid.hex(),
                        "state": a.status,
                        "name": a.name,
                        "class_name": a.options.get("class_name"),
                        "node_id": (a.node.node_id.hex()
                                    if a.node is not None else None),
                        "pending_tasks": len(a.queue) + len(a.inflight),
                        "restarts_left": a.restarts_left,
                    })
                return out[:limit]
        if kind == "tasks":
            # task_events is a bounded ring (latest event per id wins); the
            # LIVE task table overlays it so queued/running tasks are
            # always visible even if their events were evicted.
            with self.lock:
                latest: Dict[str, dict] = {}
                for ev in self.task_events:
                    latest[ev["task_id"]] = ev
                for tid_bin, rec in self.tasks.items():
                    tid = tid_bin.hex()
                    st = "RUNNING" if rec.dispatched else "PENDING"
                    cur = latest.get(tid)
                    if cur is None or cur["state"] in ("SUBMITTED",
                                                      "PENDING"):
                        latest[tid] = {"task_id": tid,
                                       "name": rec.spec.get("name"),
                                       "state": st,
                                       "time": time.time()}
                out = [dict(ev) for ev in latest.values()]
            return out[:limit]
        if kind == "objects":
            with self.lock:
                status_names = {PENDING: "PENDING", READY: "READY",
                                ERRORED: "ERRORED"}
                out = []
                for oid, st in self.objects.items():
                    d = st.descr
                    out.append({
                        "object_id": oid.hex(),
                        "state": status_names.get(st.status, "?"),
                        "kind": (d[0] if d is not None else None),
                        "size": (d[2] if d is not None
                                 and d[0] in (protocol.SHM,
                                              protocol.SPILLED)
                                 else None),
                        "local_refs": st.local_refs,
                        "worker_refs": st.worker_refs,
                        "pins": st.pins,
                    })
                return out[:limit]
        if kind == "workers":
            with self.lock:
                out = []
                for node in self.nodes.values():
                    for w in node.all_workers.values():
                        out.append({
                            "worker_id": w.worker_id.hex(),
                            "node_id": node.node_id.hex(),
                            "alive": not w.dead,
                            "actor_id": (w.actor_id.hex()
                                         if w.actor_id else None),
                            "inflight": len(w.inflight),
                            "blocked": w.blocked,
                        })
                return out[:limit]
        if kind == "placement_groups":
            with self.lock:
                return [{
                    "placement_group_id": pg.pg_id.hex(),
                    "name": pg.name,
                    "strategy": pg.strategy,
                    "bundles": list(pg.bundles),
                    "reserved": [n.hex() if n is not None else None
                                 for n in pg.reserved],
                    "removed": pg.removed,
                } for pg in self.placement_groups.values()][:limit]
        if kind == "spans":
            with self.lock:
                n = len(self.task_spans)
                return list(itertools.islice(self.task_spans,
                                             max(0, n - limit), None))
        if kind == "worker_log":
            # filters: worker_id (hex prefix ok), tail (line count).
            prefix = filters.get("worker_id", "")
            tail = int(filters.get("tail", 200))
            with self.lock:
                out = []
                for wid, ring in self._worker_logs.items():
                    if wid.startswith(prefix):
                        out.append({"worker_id": wid,
                                    "lines": list(ring)[-tail:]})
            return out[:limit]
        if kind == "transfer_stats":
            return [self.transfer_stats()]
        if kind == "handler_stats":
            with self._handler_stats_lock:
                return [{
                    "handler": tag, "count": s[0],
                    "total_ms": round(s[1] * 1e3, 3),
                    "mean_us": round(s[1] / s[0] * 1e6, 1),
                    "max_ms": round(s[2] * 1e3, 3),
                } for tag, s in sorted(self._handler_stats.items(),
                                       key=lambda kv: -kv[1][1])][:limit]
        raise ValueError(f"unknown state query kind {kind!r}")

    def transfer_stats(self) -> Dict[str, int]:
        """Data-plane + locality counters in one snapshot: the scheduler's
        locality accounting plus the aggregated worker-side prefetch/
        dedup deltas, next to the head's own relay fallbacks."""
        # The head process's OWN deadline-core counters (its puller /
        # relay stalls) merge with the worker/client deltas aggregated
        # below — one cluster-wide number per counter.
        head_net = protocol.net_stats()
        # Same pattern for the push-shuffle coordinator: when the
        # driver IS this head process, its map/merge/hedge work counts
        # in the shuffle module's process-local registry, not in any
        # worker's xfer_stats delta.  Lazy module lookup: never imported
        # (switch off, or no shuffle ran) means all-zero.
        shuffle_mod = sys.modules.get("ray_tpu_torch.data.shuffle")
        head_shuf = (shuffle_mod.shuffle_stats() if shuffle_mod is not None
                     else {})
        # And for the distributed-training planes: the PipelineTrainer
        # driver and IMPALA's learner-side loader usually ARE this head
        # process, so their counters live in the train module's
        # process-local registry, not in any worker delta.
        train_mod = sys.modules.get("ray_tpu_torch.train.pipeline_actors")
        head_train = (train_mod.train_stats() if train_mod is not None
                      else {})
        with self.lock:
            return {
                "shuffle_pushed_bytes":
                    self.shuffle_pushed_bytes
                    + head_shuf.get("shuffle_pushed_bytes", 0),
                "shuffle_merges":
                    self.shuffle_merges
                    + head_shuf.get("shuffle_merges", 0),
                "shuffle_spills":
                    self.shuffle_spills
                    + head_shuf.get("shuffle_spills", 0),
                "shuffle_hedges":
                    self.shuffle_hedges
                    + head_shuf.get("shuffle_hedges", 0),
                "microbatch_pushes":
                    self.microbatch_pushes
                    + head_train.get("microbatch_pushes", 0),
                "stage_restarts":
                    self.stage_restarts
                    + head_train.get("stage_restarts", 0),
                "learner_queue_stalls":
                    self.learner_queue_stalls
                    + head_train.get("learner_queue_stalls", 0),
                "suspected_nodes": self.suspected_nodes,
                "stall_timeouts":
                    self.stall_timeouts + head_net["stall_timeouts"],
                "net_retries":
                    self.net_retries + head_net["net_retries"],
                "hedged_fetches":
                    self.hedged_fetches + head_net["hedged_fetches"],
                "locality_hits": self.locality_hits,
                "locality_misses": self.locality_misses,
                "locality_bytes_saved": self.locality_bytes_saved,
                "prefetch_hit_bytes": self.prefetch_hit_bytes,
                "prefetch_waste_bytes": self.prefetch_waste_bytes,
                "deduped_pulls": self.deduped_pulls,
                "brokered_parts": self.brokered_parts,
                "relayed_segments": self.relayed_segments,
                "direct_puts": self.direct_puts,
                "direct_put_bytes": self.direct_put_bytes,
                "brokered_put_parts": self.brokered_put_parts,
                "lease_grants": self.lease_grants,
                "leased_submits": self.leased_submits,
                "spillbacks": self.spillbacks,
                "lease_revocations": self.lease_revocations,
                "head_brokered_submits": self.head_brokered_submits,
                "reconstructions": self.reconstructions,
                "reconstruction_failures": self.reconstruction_failures,
                "actor_restarts": self.actor_restarts,
                "chaos_kills": self.chaos_kills,
                "gcs_snapshots": self.gcs_snapshots,
                "gcs_snapshot_failures": self.gcs_snapshot_failures,
                "reconnected_nodes": self.reconnected_nodes,
                "reregistered_workers": self.reregistered_workers,
                "adopted_actors": self.adopted_actors,
                "preemptions": self.preemptions,
                "drains_completed": self.drains_completed,
                "drain_timeouts": self.drain_timeouts,
                "objects_migrated": self.objects_migrated,
            }

    def list_nodes(self):
        with self.lock:
            return [
                {"node_id": n.node_id.hex(), "alive": n.alive,
                 "resources": dict(n.resources),
                 "available": dict(n.available), "labels": dict(n.labels)}
                for n in self.nodes.values()
            ]


