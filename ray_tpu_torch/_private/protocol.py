"""Driver ⇄ worker wire protocol.

The reference speaks gRPC between core workers and raylets
(``src/ray/rpc/``, ``core_worker.proto``, ``node_manager.proto``).  Our v1
topology is one driver process + N worker processes per host, so the
transport is a duplex OS pipe per worker (``multiprocessing.Pipe``) carrying
pickled tuples — no serialization schema to keep in sync, and small-message
latency (~10µs) far below gRPC's.  A TCP transport with the same message set
slots in for multi-host (see node.py).

Message grammar (first element = type tag):

driver → worker
  ("exec",   task: dict)            run a task / actor method
  ("create_actor", spec: dict)      instantiate actor class on this worker
  ("func",   func_id, payload)      function/class definition (cloudpickle)
  ("obj",    req_id, ok, descr)     reply to a worker "getparts"
  ("mgot",   req_id, [(ok, descr)]) reply to a batched "mget"
  ("free_segment", name, size, reusable)  owner freed a segment this worker
                                    created; pool pages iff reusable
  ("kill",   )                      graceful shutdown
worker → driver
  ("ready",  worker_id_hex, pid)
  ("result", task_id_bytes, ok, returns: list[Descr], meta: dict)
  ("mget",   req_id, [object_id_bytes], timeout)   batched get
  ("submit", 0, spec: dict)         nested task submission (fire-and-forget;
                                    per-conn FIFO makes later uses safe)
  ("put",    object_id_bytes, descr, nested_ids)
  ("put_parts", object_id_bytes, meta, [buffers], nested_ids)
                                    legacy client put: whole value in one
                                    control message, head assembles
  ("put_commit", object_id_bytes, descr, nested_ids)
                                    direct put: the payload already
                                    streamed into the destination store
                                    over the object-server data plane
                                    (reserve_put/put_range/commit_put/
                                    abort_put verbs, capability-gated);
                                    the control plane sees only this
                                    O(1) descriptor registration
  ("addref", object_id_bytes) / ("decref", object_id_bytes)
  ("decref_batch", [object_id_bytes])   buffered ref drops
  ("blocked", task_id_bytes) / ("unblocked", task_id_bytes)
lease plane (decentralized dispatch; all verbs are capability-gated:
holders opt in via the ``lease_req`` opts dict / the ``_spill_ok`` task
flag, so a peer that never advertises them is never sent one)
  ("lease_req", rid, resources, n[, opts])   worker/client asks for leases;
                                    opts {"v": 1, "hint": node_hex} selects
                                    the dict-shaped reply {"grants":
                                    [(wid, addr, node_hex)...], "slots",
                                    "ttl", "hint"} (bare list without)
  ("lease_grant", klass_items, grants, slots, ttl, hint)   head → holder:
                                    unsolicited bulk grant piggybacked on a
                                    head-brokered submit burst
  ("lease_renew", [wid_hex])        holder liveness, one message per N
                                    leased pushes (lease_renew_tasks)
  ("lease_revoke", [wid_hex])       head → holder: leased worker gone
                                    (node death / TTL expiry); rides the
                                    conflation sender
  ("dspill", rid, info)             executor → holder on the direct conn:
                                    pushed task bounced (queue over
                                    lease_spillback_depth); info names the
                                    bouncing executor's node — the
                                    next-best hint rides the lease grant
either direction
  ("batch",  [msg, ...])            envelope: N back-to-back messages as
                                    ONE pickle + one write.  Receivers
                                    unwrap and handle each message in
                                    order; sub-messages are never
                                    themselves batches.  Purely an
                                    optimization: a peer that only ever
                                    sends unbatched messages (or the
                                    legacy "msg_batch" form) interoperates
                                    unchanged (reference: gRPC stream
                                    write coalescing in
                                    direct_task_transport.cc).

Object descriptors (Descr) carry values between processes:
  ("inline", bytes)                 pickled value, small
  ("shm", name, size, store_id)     shared-memory segment (zero-copy mmap,
                                    attachable only by processes sharing the
                                    creating host's object store)
  ("parts", meta, [bytes...])       serialized parts shipped over the wire —
                                    the cross-node transfer form (reference:
                                    object_manager.h:206 chunked push/pull)
  ("error", bytes)                  pickled exception

Transport: same message set over an AF_UNIX socket (workers on the head
host) or TCP (node agents and the workers they spawn on other hosts) —
the reference speaks gRPC for both (``node_manager.proto``).

The grammar above is narrative; the AUTHORITATIVE contract is the
``VERBS`` catalog below (verb → sender/handler roles, arity, capability
gate, doc — our one-file analog of the reference's 22 proto schemas).
``python -m ray_tpu_torch.devtools.protocheck`` statically cross-checks every
send and handle site in the tree against it, and ``protocheck --doc``
renders it as the README's wire-protocol table.
"""

from __future__ import annotations

import os
import pickle
import threading
from typing import NamedTuple, Optional, Tuple


class Verb(NamedTuple):
    """One wire verb's contract — the machine-checked half of the
    docstring above (``ray_tpu_torch.devtools.protocheck`` cross-checks every
    send and handle site against this catalog; ``protocheck --doc``
    renders it as the README's wire-protocol table).

    ``senders``/``handlers`` name module roles (head = runtime/head_main,
    worker = worker_main/direct, client, agent = node_agent, objsrv =
    object_transfer/shm_store).  ``arity`` is the legal tuple length
    INCLUDING the verb tag, as an inclusive (min, max) — ``None`` means
    deliberately variable (the per-exchange ``ok`` replies).  ``caps``
    names the capability family that must gate every send (the "never
    probe an old peer" convention).  ``external`` marks verbs
    whose peers live outside the analyzed tree (legacy spellings,
    dynamically-built envelopes) so the whole-program liveness check
    skips them."""

    senders: Tuple[str, ...]
    handlers: Tuple[str, ...]
    arity: Optional[Tuple[int, int]]
    doc: str
    caps: Optional[str] = None
    external: bool = False


VERBS = {
    # -- driver/head <-> worker control plane ------------------------------
    "exec": Verb(("head", "worker"), ("worker",), (2, 2),
                 "run a task / actor method (workers also self-enqueue "
                 "direct-pushed tasks under this tag)"),
    "create_actor": Verb(("head",), ("worker",), (2, 2),
                         "instantiate an actor class on this worker"),
    "func": Verb(("head",), ("worker",), (3, 3),
                 "function/class definition (cloudpickle)"),
    "obj": Verb(("head",), ("worker", "client"), (4, 4),
                "reply to a worker getparts"),
    "mgot": Verb(("head",), ("worker", "client"), (3, 3),
                 "reply to a batched mget"),
    "waited": Verb(("head",), ("worker", "client"), (3, 3),
                   "reply to a wait"),
    "reply": Verb(("head",), ("worker", "client"), (3, 3),
                  "generic request reply (store_addr, state_req, jobs, "
                  "actor requests, v1 lease_req)"),
    "free_segment": Verb(("head",), ("worker",), (4, 4),
                         "owner freed a segment this worker created; "
                         "pool pages iff reusable"),
    "kill": Verb(("head",), ("worker",), (1, 1), "graceful shutdown"),
    "steal": Verb(("head",), ("worker",), (3, 3),
                  "reclaim queued-but-unstarted task ids from a worker"),
    "ready": Verb(("worker",), ("head",), (4, 4),
                  "worker hello: id, pid, direct-server address"),
    "result": Verb(("worker",), ("head",), (5, 5),
                   "task finished: id, ok, returns, meta"),
    "result_batch": Verb(("worker",), ("head",), (2, 2),
                         "coalesced results (one pickle+write)"),
    "spans": Verb(("worker",), ("head",), (2, 2),
                  "task execution spans (ray timeline)"),
    "event": Verb(("worker",), ("head",), (3, 3),
                  "generic worker->driver pubsub (train streaming)"),
    "xfer_stats": Verb(("worker",), ("head",), (2, 2),
                       "periodic data-plane/lease counter deltas"),
    "getparts": Verb(("worker",), ("head",), (3, 3),
                     "fetch a remote segment's serialized parts"),
    "wait": Verb(("worker",), ("head",), (5, 5),
                 "blocking wait on object ids"),
    "mget": Verb(("worker", "client"), ("head",), (4, 4),
                 "batched get"),
    "submit": Verb(("worker", "client"), ("head",), (3, 3),
                   "nested task submission (fire-and-forget)"),
    "submit_batch": Verb(("worker", "client"), ("head",), (2, 2),
                         "bulk nested submission (one registration "
                         "pass)"),
    "resubmit_batch": Verb(("worker", "client"), ("head",), (2, 2),
                           "failover replay of retained head-routed "
                           "specs (head filters for at-least-once)"),
    "put": Verb(("client",), ("head",), (4, 4),
                "small inline client put (rides the put conflation "
                "buffer)"),
    "put_parts": Verb(("client",), ("head",), (5, 5),
                      "legacy client put: whole value in one control "
                      "message, head assembles"),
    "put_commit": Verb(("client",), ("head",), (4, 4),
                       "direct put: payload already streamed into the "
                       "destination store; O(1) descriptor "
                       "registration"),
    "addref": Verb(("worker", "client"), ("head",), (2, 2),
                   "object refcount +1"),
    "decref": Verb(("worker", "client"), ("head",), (2, 2),
                   "object refcount -1 (aggregate head ref of a "
                   "delegated object)"),
    "decref_batch": Verb(("worker", "client"), ("head",), (2, 2),
                         "buffered ref drops"),
    "addref_batch": Verb(("worker", "client"), ("head",), (2, 2),
                         "buffered ref bumps (nested ids in results)"),
    "actor_addref": Verb(("worker", "client"), ("head",), (2, 2),
                         "actor-handle refcount +1 (pickle-time)"),
    "actor_decref_batch": Verb(("worker", "client"), ("head",), (2, 2),
                               "buffered actor-handle ref drops"),
    "actor_token_new": Verb(("worker", "client"), ("head",), (3, 3),
                            "actor handle serialized (borrow token)"),
    "actor_token_used": Verb(("worker", "client"), ("head",), (3, 3),
                             "borrowed actor handle deserialized"),
    "actor_addr_req": Verb(("worker", "client"), ("head",), (3, 3),
                           "resolve an actor's direct-channel address"),
    "blocked": Verb(("worker",), ("head",), (2, 2),
                    "worker blocked in get/wait (lend the slot)"),
    "unblocked": Verb(("worker",), ("head",), (2, 2),
                      "worker resumed from get/wait"),
    "stolen": Verb(("worker",), ("head",), (3, 3),
                   "reply to a steal: task ids actually reclaimed"),
    "store_addr": Verb(("worker",), ("head",), (3, 3),
                       "resolve a store's object-server address "
                       "(+ caps)"),
    "state_req": Verb(("worker", "client"), ("head",), (4, 4),
                      "state introspection query (ray status/list)"),
    "kill_actor_req": Verb(("worker", "client"), ("head",), (4, 4),
                           "ray.kill(actor)"),
    "get_actor_req": Verb(("worker", "client"), ("head",), (4, 4),
                          "ray.get_actor(name)"),
    "create_actor_req": Verb(("worker", "client"), ("head",), (4, 4),
                             "synchronous actor creation request"),
    "cluster_info": Verb(("worker", "client"), ("head",), (2, 2),
                         "nodes/resources snapshot"),
    "get_package": Verb(("worker",), ("head",), (3, 3),
                        "fetch a working_dir package by id"),
    "job_submit": Verb(("client",), ("head",), (5, 5),
                       "job API: submit entrypoint"),
    "job_status": Verb(("client",), ("head",), (3, 3),
                       "job API: status"),
    "job_logs": Verb(("client",), ("head",), (3, 3), "job API: logs"),
    "job_stop": Verb(("client",), ("head",), (3, 3), "job API: stop"),
    "job_list": Verb(("client",), ("head",), (2, 2), "job API: list"),
    "actor_checkpoint": Verb(("worker",), ("head",), (3, 4),
                             "latest __ray_save__ descriptor from a "
                             "restartable actor; the optional 4th "
                             "element marks a drain-FORCED reply (parts "
                             "the head re-homes on a surviving store, "
                             "or None for a hookless actor) and is what "
                             "releases the drain's rendezvous"),
    "checkpoint_now": Verb(("head",), ("worker",), (2, 2),
                           "drain: force an immediate __ray_save__ of "
                           "the named actor, shipped as parts so the "
                           "head re-homes it on a surviving store; the "
                           "worker always replies actor_checkpoint "
                           "(None without the hook) so the drain never "
                           "stalls"),
    # -- lease plane (decentralized dispatch) ------------------------------
    "lease_req": Verb(("worker", "client"), ("head",), (4, 5),
                      "worker/client asks for leases; optional opts "
                      "dict {v:1, hint} selects the v1 dict reply"),
    "lease_grant": Verb(("head",), ("worker", "client"), (6, 6),
                        "unsolicited bulk grant piggybacked on a "
                        "head-brokered submit burst", caps="lease_v1"),
    "lease_renew": Verb(("worker",), ("head",), (2, 2),
                        "holder liveness, one message per N leased "
                        "pushes"),
    "lease_return": Verb(("worker",), ("head",), (2, 2),
                         "holder done with a leased worker"),
    "lease_revoke": Verb(("head",), ("worker", "client"), (2, 2),
                         "leased worker gone (node death / TTL "
                         "expiry)"),
    "dspill": Verb(("worker",), ("worker",), (3, 3),
                   "executor -> holder: pushed task bounced (queue over "
                   "lease_spillback_depth)"),
    # -- direct plane (worker <-> worker actor/lease channels) -------------
    "dexec": Verb(("worker",), ("worker",), (3, 3),
                  "push one task over a lease/actor channel"),
    "dexec_batch": Verb(("worker",), ("worker",), (2, 2),
                        "coalesced dexec frames (per-lease conflation "
                        "sender)"),
    "dfunc": Verb(("worker",), ("worker",), (3, 3),
                  "function definition rides the direct channel"),
    "dfree": Verb(("worker",), ("worker",), (4, 4),
                  "owner freed a segment the executor created"),
    "dmsg": Verb(("worker",), ("worker",), (3, 3),
                 "out-of-band payload on an actor channel "
                 "(collectives)"),
    "dresult": Verb(("worker",), ("worker",), (5, 5),
                    "direct task result (rid, ok, returns, meta)"),
    "dresult_batch": Verb(("worker",), ("worker",), (2, 2),
                          "coalesced direct results"),
    "dping": Verb(("worker",), ("worker",), (2, 2),
                  "holder -> executor channel-liveness probe: a lease/"
                  "actor channel with in-flight pushes and no traffic "
                  "for net_stall_timeout_s gets one; the executor's "
                  "connection thread answers dpong even while the task "
                  "computes, so a long task is never mistaken for a "
                  "stalled link"),
    "dpong": Verb(("worker",), ("worker",), (2, 2),
                  "executor -> holder reply to dping; any channel "
                  "traffic (this included) resets the holder's stall "
                  "clock"),
    # -- worker-ownership plane (direct path, via head) --------------------
    "export_obj": Verb(("worker",), ("head",), (2, 2),
                       "delegate worker-owned objects to the head "
                       "directory"),
    "export_complete": Verb(("worker",), ("head",), (2, 2),
                            "delegated export descriptors are final"),
    "descr_update": Verb(("worker",), ("head",), (2, 2),
                         "owner-side descriptor moves (spill/restore)"),
    "free_remote": Verb(("worker",), ("head",), (4, 4),
                        "unlink a segment homed in another node's "
                        "store"),
    # -- node-agent plane --------------------------------------------------
    "agent_ready": Verb(("agent",), ("head",), (2, 2),
                        "agent hello: node info + advertised "
                        "object_caps"),
    "agent_ack": Verb(("head",), ("agent",), (4, 4),
                      "agent handshake reply: node id, session, "
                      "config"),
    "spawn_worker": Verb(("head",), ("agent",), (3, 3),
                         "fork a worker on this node with env "
                         "overrides"),
    "kill_worker": Verb(("head",), ("agent",), (2, 2),
                        "terminate a worker process"),
    "kill_worker_hard": Verb(("head",), ("agent",), (2, 2),
                             "SIGKILL a worker (chaos/OOM paths)"),
    "read_segment": Verb(("head",), ("agent",), (3, 3),
                         "relay-read a segment from the agent's store"),
    "unlink_segment": Verb(("head",), ("agent",), (3, 3),
                           "free a segment in the agent's store"),
    "shutdown": Verb(("head",), ("agent",), (1, 1),
                     "tear the node down"),
    "segment": Verb(("agent",), ("head",), (4, 4),
                    "reply to read_segment"),
    "oom_pressure": Verb(("agent",), ("head",), (2, 2),
                         "node memory fraction crossed the monitor "
                         "threshold"),
    # -- elastic pods: preemption-aware drain (caps family "drain_caps":
    # agents advertise it in agent_ready, the head advertises it back in
    # the agent_ack config dict — the "never probe an old peer"
    # convention) --------------------------------------------------------
    "preempt_notice": Verb(("agent",), ("head",), (3, 3),
                           "agent got a preemption warning (SIGTERM / "
                           "provider poll / chaos preempt): drain this "
                           "node within deadline_s, then release it "
                           "with drain_node", caps="drain_caps"),
    "drain_node": Verb(("head",), ("agent",), (3, 3),
                       "head -> agent: node drained (leases revoked, "
                       "actors checkpointed to a surviving store, small "
                       "sole-copy objects migrated) — finish up and "
                       "exit cleanly; doubles as the preempt_notice "
                       "ack and the graceful scale-down order",
                       caps="drain_caps"),
    "worker_logs": Verb(("agent",), ("head",), (2, 2),
                        "batched worker stdout/stderr lines"),
    # -- failure detection (gray failures; reference:
    # GcsHealthCheckManager + per-RPC gRPC deadlines).  Heartbeats are
    # the liveness FLOOR under the existing periodic traffic
    # (xfer_stats, renewals): a peer with nothing else to say still
    # sends one per health_check_period_s, so head-side silence is a
    # signal.  All four verbs are sent only while the
    # ``failure_detection`` switch is on (both sides read the same
    # plumbed knob, so an off-switch cluster never sees them). --------
    "heartbeat": Verb(("worker", "client", "agent"), ("head",), (2, 2),
                      "periodic liveness floor (worker/store id); also "
                      "the immediate reply to an hc_probe"),
    "hc_probe": Verb(("head",), ("worker", "agent"), (2, 2),
                     "suspicion probe: the peer's reader replies "
                     "heartbeat immediately even while its main thread "
                     "computes — differential observation of the LINK, "
                     "not the process"),
    "hc_ping": Verb(("worker", "client"), ("head",), (2, 2),
                    "head-connection watchdog probe: a worker/client "
                    "stuck waiting on a silent head sends one; the "
                    "head answers with a generic reply — continued "
                    "silence means the conn is stalled and the "
                    "watchdog closes it into the reconnect-and-replay "
                    "path"),
    # -- handshakes / failover ---------------------------------------------
    "client_ready": Verb(("client",), ("head",), (2, 2),
                         "client hello (nonce)"),
    "client_ack": Verb(("head",), ("client",), (2, 3),
                       "client handshake reply; the 3rd element "
                       "(direct-put bootstrap info dict) is absent from "
                       "old heads"),
    "reregister": Verb(("worker", "client"), ("head",), (2, 2),
                       "failover re-registration (workers, clients, "
                       "reconnecting agents' workers)"),
    "reregister_ack": Verb(("head",), ("worker",), (2, 2),
                           "re-registration accepted"),
    "reregister_nack": Verb(("head",), ("worker",), (1, 1),
                            "re-registration refused (unknown "
                            "session)"),
    # -- object-server data plane (capability-gated verbs) -----------------
    "fetch": Verb(("objsrv",), ("objsrv",), (2, 2),
                  "stream a whole segment"),
    "fetch_range": Verb(("objsrv",), ("objsrv",), (4, 4),
                        "stream one byte-range stripe; first stripe "
                        "doubles as the size probe", caps="object_caps"),
    "reserve_put": Verb(("objsrv",), ("objsrv",), (3, 3),
                        "preallocate the destination segment for a "
                        "direct put", caps="object_caps"),
    "put_range": Verb(("objsrv",), ("objsrv",), (4, 4),
                      "one byte-range stripe of a pending put",
                      caps="object_caps"),
    "commit_put": Verb(("objsrv",), ("objsrv",), (2, 2),
                       "seal a pending put", caps="object_caps"),
    "abort_put": Verb(("objsrv",), ("objsrv",), (2, 2),
                      "tear down a pending put", caps="object_caps"),
    "close": Verb(("objsrv",), ("objsrv",), (1, 1),
                  "end this object-server connection"),
    "ok": Verb(("objsrv",), ("objsrv",), None,
               "per-exchange success reply (shape varies by request; "
               "consumed inline by the requester, not via a dispatch "
               "chain)", external=True),
    "err": Verb(("objsrv",), ("objsrv",), (2, 2),
                "per-exchange failure reply (consumed inline)",
                external=True),
    # -- envelopes ---------------------------------------------------------
    "batch": Verb(("head", "worker", "client", "agent"),
                  ("head", "worker", "client", "agent"), (2, 2),
                  "N back-to-back messages as one pickle+write "
                  "(built dynamically by make_batch)", external=True),
    "msg_batch": Verb(("head", "worker", "client", "agent"),
                      ("head", "worker", "client", "agent"), (2, 2),
                      "legacy batch-envelope spelling from old peers",
                      external=True),
}


def enable_nodelay(conn) -> None:
    """Disable Nagle on a TCP connection (no-op for AF_UNIX pipes).

    The protocol often issues back-to-back small sends on one socket
    (blocked + mget, decref_batch + submit); with Nagle on, the second
    write stalls until the peer's delayed ACK (~40ms) — the classic
    Nagle/delayed-ACK interaction that collapsed client-mode gets to
    ~26/s.  The reference's gRPC channels disable Nagle the same way."""
    import socket as _socket

    try:
        fd = os.dup(conn.fileno())
    except (OSError, AttributeError):
        return
    try:
        s = _socket.socket(fileno=fd)
    except OSError:
        os.close(fd)
        return
    try:
        # Options bind to the open file description, which the original
        # connection shares with this dup.
        s.setsockopt(_socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1)
    except OSError:
        pass  # AF_UNIX
    finally:
        s.close()


class NetTimeoutError(OSError):
    """A wire operation made zero progress for its whole deadline
    (stalled peer/link) or a dial never completed.  An ``OSError``
    subclass on purpose: every existing ``except (EOFError, OSError)``
    discovery site treats a stall exactly like a broken connection —
    which is the point of the failure-detection plane."""


# ------------------------------------------------- net-chaos seam --------
# The armed hook: callable(point, conn) -> None | "drop" | "dup", or
# None.  ``ray_tpu_torch.chaos.ChaosNet`` installs it (controller methods in
# the driver/head, RAY_TPU_CHAOS_NET env rules in spawned workers/
# agents) to create gray failures AT this seam: delays, full stalls,
# silent drops (one-way partition), duplicates.  Cost unarmed: one
# module-global ``is None`` check per send/recv.
_NET_HOOK = None


def set_net_hook(fn) -> None:
    global _NET_HOOK
    _NET_HOOK = fn


def net_point(point: str, conn) -> Optional[str]:
    """Named net-chaos point for raw chunk streams (``chunk_send`` in
    the object servers/pushers); ``send``/``recv`` fire implicitly."""
    hook = _NET_HOOK
    if hook is not None:
        return hook(point, conn)
    return None


# ------------------------------------------------- net counters ----------
# Process-wide failure-detection counters (the deadline core is the one
# place every stall/retry/hedge flows through).  Workers and clients
# ship them to the head in the periodic xfer_stats deltas; the head
# merges its own process's values in transfer_stats().  All zero with
# failure_detection off.
_NET_STATS_LOCK = threading.Lock()  # lock-order: leaf
_NET_STATS = {"stall_timeouts": 0, "net_retries": 0, "hedged_fetches": 0}


def note_net_event(key: str, n: int = 1) -> None:
    with _NET_STATS_LOCK:
        _NET_STATS[key] = _NET_STATS.get(key, 0) + n


def net_stats() -> dict:
    with _NET_STATS_LOCK:
        return dict(_NET_STATS)


def _is_timeout_oserror(e: BaseException) -> bool:
    import errno

    return isinstance(e, OSError) and e.errno in (errno.EAGAIN,
                                                  errno.EWOULDBLOCK)


def is_stall(e: BaseException) -> bool:
    """Whether an exception is a zero-progress deadline trip — either
    the typed :class:`NetTimeoutError` or the raw EAGAIN ``OSError`` an
    armed ``set_conn_deadline`` socket raises from mid-stream
    ``recv_bytes_into``/``send_bytes`` syscalls."""
    return isinstance(e, NetTimeoutError) or _is_timeout_oserror(e)


def _conn_socket(conn):
    """A connection's underlying fd duplicated as a ``socket`` object
    (the caller closes it), or None when the conn has no fd / the fd is
    not a socket — callers then leave the conn on its legacy
    fully-blocking behavior."""
    import socket as _socket

    try:
        fd = os.dup(conn.fileno())
    except (OSError, AttributeError):
        return None
    try:
        return _socket.socket(fileno=fd)
    except OSError:
        os.close(fd)
        return None


def _set_deadline_opts(conn, timeout_s: Optional[float], opts) -> bool:
    import socket as _socket
    import struct as _struct

    s = _conn_socket(conn)
    if s is None:
        return False
    try:
        t = timeout_s or 0.0
        tv = _struct.pack("ll", int(t), int((t - int(t)) * 1e6))
        for opt in opts:
            s.setsockopt(_socket.SOL_SOCKET, opt, tv)
        return True
    except OSError:
        return False
    finally:
        s.close()


def set_conn_deadline(conn, timeout_s: Optional[float]) -> bool:
    """Arm a ZERO-PROGRESS deadline on a connection's underlying socket
    (``SO_RCVTIMEO`` + ``SO_SNDTIMEO``): every read/write syscall gets
    ``timeout_s`` to move at least one byte, so progress resets the
    clock at the kernel and only a fully stalled transfer dies.  A
    tripped deadline surfaces from the in-flight ``recv_bytes``/
    ``send_bytes`` as an EAGAIN ``OSError`` — convert at the call site
    (``recv_deadline`` / the object-transfer range loops) into
    :class:`NetTimeoutError`.  ``None``/``0`` clears.  Returns False
    (no-op) when the fd is not a socket — the conn then keeps its
    legacy fully-blocking behavior."""
    import socket as _socket

    return _set_deadline_opts(conn, timeout_s,
                              (_socket.SO_RCVTIMEO, _socket.SO_SNDTIMEO))


def set_send_deadline(conn, timeout_s: Optional[float]) -> bool:
    """Arm only the SEND half of the zero-progress deadline
    (``SO_SNDTIMEO``).  For long-lived direct channels whose reader
    legitimately idles between results: sends get bounded (a stalled
    peer errors the sender into the existing channel-death path) while
    the blocking reader keeps waiting forever, as it should."""
    import socket as _socket

    return _set_deadline_opts(conn, timeout_s, (_socket.SO_SNDTIMEO,))


def enable_keepalive(conn) -> None:
    """Arm TCP keepalive on a dialed connection so a peer that vanishes
    without a FIN (powered-off VM, dropped route) eventually errors out
    of even the legacy blocking paths (reference: gRPC channel
    keepalive).  No-op for AF_UNIX."""
    import socket as _socket

    s = _conn_socket(conn)
    if s is None:
        return
    try:
        s.setsockopt(_socket.SOL_SOCKET, _socket.SO_KEEPALIVE, 1)
        for opt, val in (("TCP_KEEPIDLE", 30), ("TCP_KEEPINTVL", 10),
                         ("TCP_KEEPCNT", 6)):
            if hasattr(_socket, opt):
                s.setsockopt(_socket.IPPROTO_TCP,
                             getattr(_socket, opt), val)
    except OSError:
        pass  # AF_UNIX
    finally:
        s.close()


def shutdown_conn(conn) -> None:
    """``shutdown(SHUT_RDWR)`` a connection's underlying socket, then
    nothing else — the caller still owns the close.  THE way to take a
    connection away from a thread parked inside a blocking ``recv``:
    on Linux, ``close()`` alone does NOT wake a thread already blocked
    in ``read()`` on the fd (it only drops this process's reference),
    while shutdown delivers an immediate EOF to it.  Every watchdog
    that retires a stalled connection (the direct-channel liveness
    probe, the worker's stalled-head watchdog) must go through this or
    its parked reader never runs the death/reconnect path."""
    s = _conn_socket(conn)
    if s is None:
        return
    import socket as _socket

    try:
        s.shutdown(_socket.SHUT_RDWR)
    except OSError:
        pass  # already disconnected
    finally:
        s.close()


def dial(address, authkey: Optional[bytes] = None,
         connect_timeout: Optional[float] = None):
    """Deadline-aware ``multiprocessing.connection.Client``: bounded
    connect (a dial to a black-holed address fails in
    ``net_connect_timeout_s``, not the kernel's ~2 min default),
    ``SO_KEEPALIVE`` armed, Nagle off, and the auth handshake bounded
    by the same window (an accepted-but-stalled listener cannot hang
    the dialer).  ``connect_timeout=None`` reads the config knob; with
    ``failure_detection`` off this is byte-identical to the legacy
    ``Client()`` dial."""
    from multiprocessing.connection import Client

    if isinstance(address, str) and address.startswith("tcp://"):
        address = parse_address(address)
    if connect_timeout is None:
        from ray_tpu_torch._private.config import GLOBAL_CONFIG as _cfg

        connect_timeout = (_cfg.net_connect_timeout_s
                           if _cfg.failure_detection else 0.0)
    if not connect_timeout or connect_timeout <= 0:
        conn = Client(tuple(address) if isinstance(address, (tuple, list))
                      else address, authkey=authkey)
        enable_nodelay(conn)
        return conn

    import socket as _socket
    from multiprocessing.connection import (Connection, answer_challenge,
                                            deliver_challenge)

    try:
        if isinstance(address, (tuple, list)):
            s = _socket.create_connection(tuple(address),
                                          timeout=connect_timeout)
            try:
                s.setsockopt(_socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1)
            except OSError:
                pass
        else:
            s = _socket.socket(_socket.AF_UNIX)
            s.settimeout(connect_timeout)
            s.connect(address)
        try:
            s.setsockopt(_socket.SOL_SOCKET, _socket.SO_KEEPALIVE, 1)
        except OSError:
            pass
        s.settimeout(None)  # back to blocking; deadlines are per-op
    except (_socket.timeout, TimeoutError) as e:
        raise NetTimeoutError(
            f"dial to {address!r} timed out after "
            f"{connect_timeout}s") from e
    conn = Connection(s.detach())
    if authkey is not None:
        # Bound the handshake too: the listener accepted but its
        # process may be hung.
        set_conn_deadline(conn, connect_timeout)
        try:
            answer_challenge(conn, authkey)
            deliver_challenge(conn, authkey)
        except OSError as e:
            conn.close()
            if _is_timeout_oserror(e):
                raise NetTimeoutError(
                    f"auth handshake with {address!r} stalled past "
                    f"{connect_timeout}s") from e
            raise
        except EOFError:
            conn.close()
            raise
        finally:
            try:
                set_conn_deadline(conn, None)
            except OSError:
                pass
    enable_keepalive(conn)
    return conn


def send(conn, msg: tuple):
    hook = _NET_HOOK
    if hook is not None:
        verdict = hook("send", conn)
        if verdict == "drop":
            return
        if verdict == "dup":
            conn.send_bytes(pickle.dumps(msg, protocol=5))
    conn.send_bytes(pickle.dumps(msg, protocol=5))


def recv(conn) -> tuple:
    hook = _NET_HOOK
    if hook is not None:
        hook("recv", conn)
    return pickle.loads(conn.recv_bytes())  # noqa: RTL403 -- the deadline core's own primitive; deadlines arm via set_conn_deadline/recv_deadline


def recv_deadline(conn, timeout_s: Optional[float]) -> tuple:
    """``recv`` bounded by a zero-progress deadline: the peer gets
    ``timeout_s`` per syscall to move bytes (progress resets the
    clock); full silence raises :class:`NetTimeoutError`.  ``None``/
    ``<=0`` falls back to the plain blocking recv (the legacy path)."""
    if not timeout_s or timeout_s <= 0:
        return recv(conn)
    armed = set_conn_deadline(conn, timeout_s)
    try:
        return recv(conn)
    except OSError as e:
        if armed and _is_timeout_oserror(e):
            raise NetTimeoutError(
                f"recv stalled past {timeout_s}s") from e
        raise
    finally:
        if armed:
            try:
                set_conn_deadline(conn, None)
            except OSError:
                pass


# Batch-envelope tag (plus the pre-envelope spelling still emitted by old
# peers; both unwrap identically).
BATCH = "batch"
LEGACY_BATCH = "msg_batch"


def make_batch(msgs):
    """List of messages -> the cheapest single wire message: the message
    itself for a singleton, a ("batch", msgs) envelope otherwise."""
    if len(msgs) == 1:
        return msgs[0]
    return (BATCH, msgs)


def send_batch(conn, msgs) -> None:
    """Ship back-to-back messages as ONE pickle + one write (no-op for an
    empty list) — the wire-level amortization that keeps fan-out paths at
    ~O(n/batch) syscalls instead of O(n)."""
    if not msgs:
        return
    send(conn, make_batch(msgs))


def is_batch(msg) -> bool:
    return msg[0] == BATCH or msg[0] == LEGACY_BATCH


INLINE = "inline"
SHM = "shm"
PARTS = "parts"
SPILLED = "spilled"  # ("spilled", path, size, store_id): on-disk segment
ERROR = "error"


def format_address(addr) -> str:
    """Listener address -> env-var string ("tcp://host:port" or a path)."""
    if isinstance(addr, tuple):
        return f"tcp://{addr[0]}:{addr[1]}"
    return addr


def parse_address(s: str):
    """Env-var string -> Client()-compatible address."""
    if s.startswith("tcp://"):
        host, port = s[len("tcp://"):].rsplit(":", 1)
        return (host, int(port))
    return s
