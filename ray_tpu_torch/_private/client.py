"""Client mode: attach an external process to a running cluster.

Reference: ``python/ray/util/client/`` (Ray Client — a gRPC proxy that
lets a process outside the cluster drive tasks/actors/objects;
ARCHITECTURE.md).  Re-designed for this runtime's symmetric worker
protocol: a client IS a worker connection that never takes a lease — it
dials the head's TCP listener, handshakes ``client_ready``, and then the
existing submit/mget/put/actor messages just work.  Large values ship as
parts and land in the HEAD's store (clients cannot assume a shared
/dev/shm), and large results stream back via the direct object-transfer
pull or the head relay.

Usage::

    import ray_tpu_torch as ray
    ray.init(address="tcp://head:port", _authkey="<hex>")
    # or env: RAY_TPU_CLIENT_ADDRESS / RAY_TPU_CLIENT_AUTHKEY
"""

from __future__ import annotations

import os
import pickle
import tempfile
import threading
from typing import Optional

from ray_tpu_torch._private import object_transfer, protocol, serialization
from ray_tpu_torch._private import object_ref as object_ref_mod
from ray_tpu_torch._private.ids import ObjectID
from ray_tpu_torch._private.object_ref import ObjectRef
from ray_tpu_torch._private.shm_store import ShmStore
from ray_tpu_torch._private.worker_main import _WorkerRuntime

# Small-put coalescing bounds: buffered inline puts flush as ONE
# ("batch", ...) pickle+write once this many accumulate (or this many
# payload bytes), before any other outgoing message, and at worst on the
# 0.25s periodic flusher.
_PUT_FLUSH_COUNT = 16
_PUT_FLUSH_BYTES = 4 << 20

# Direct-put floor: below this, the legacy fire-and-forget put_parts
# message (one local pickle+write, no reply awaited) beats the direct
# path's three blocking round trips (reserve ack, range ack, commit ack)
# on any link with real latency; above it, transfer time dominates and
# the zero-copy data plane wins.
_DIRECT_PUT_MIN = 4 << 20


class ClientRuntime(_WorkerRuntime):
    """Worker runtime minus execution: submits, gets, puts, actors."""

    is_client = True

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        # (store_id, object_addr, caps) of the head's object server,
        # from the client_ack info dict — None against an old head (no
        # info element) keeps every put on the legacy path.
        self._head_put_info = None
        # Failover re-dial target, set by client_connect (clients have
        # no RAY_TPU_ADDRESS env; the worker-flavor _redial is
        # overridden below).
        self._address = None
        self._authkey = b""
        # Buffered small ("put", ...)/("addref", ...) message pairs:
        # many tiny puts ride out as one pickle+write instead of one
        # each (the conflation envelope, applied to the put path).
        self._put_buf: list = []
        self._put_buf_bytes = 0
        self._put_lock = threading.Lock()  # lock-order: leaf

    def put_object(self, value) -> ObjectRef:
        oid = ObjectID.for_put()
        self.begin_ref_collection()
        try:
            res = serialization.dumps_adaptive(value, self.max_inline)
        finally:
            nested = self.end_ref_collection()
        if res[0] == "inline":
            # Coalesced: the ref's addref rides the same buffer (in
            # order), so _register=False below — the head still counts
            # exactly one ref for this client.
            self._queue_small_put(
                ("put", oid.binary(), (protocol.INLINE, res[1]), nested),
                oid, len(res[1]))
            self._cache_put(oid, value)
            return ObjectRef(oid, _register=False)
        descr = (self._direct_put(oid, res[1], res[2])
                 if res[3] >= _DIRECT_PUT_MIN else None)
        if descr is not None:
            # Payload already landed in the head's store over the data
            # plane; the control connection carries only this O(1)
            # commit.
            self._send(("put_commit", oid.binary(), descr, nested))
        else:
            # Legacy path: ship parts for the head to assemble into ITS
            # store (clients share no /dev/shm).  PickleBuffer wrapping
            # sends the buffer views — pickle already copies once into
            # the message stream; the old [bytes(b) ...] copied twice.
            self._send(("put_parts", oid.binary(), res[1],
                        [pickle.PickleBuffer(b) for b in res[2]], nested))
        self._cache_put(oid, value)
        return ObjectRef(oid)

    def _direct_put(self, oid: ObjectID, meta, views):
        """Push a large value straight into the head's store over the
        object-transfer data plane; returns the committed descriptor, or
        None (caller falls back to legacy put_parts) when the head never
        advertised the put verbs, the master switch is off, or the push
        failed."""
        from ray_tpu_torch._private.config import GLOBAL_CONFIG as _cfg

        info = self._head_put_info
        if info is None or not _cfg.direct_puts:
            return None
        store_id, addr, caps = info
        if not object_transfer.peer_accepts_puts(caps):
            return None
        try:
            kind, ident, size = self._pusher.push(
                store_id, addr, oid.binary(), meta, views, caps=caps)
        except Exception:
            return None
        if kind == "spilled":
            # Admission degraded the reservation to the head node's
            # spill path rather than overcommitting tmpfs.
            return (protocol.SPILLED, ident, size, store_id)
        return (protocol.SHM, ident, size, store_id)

    def _queue_small_put(self, msg, oid: ObjectID, nbytes: int):
        with self._put_lock:
            self._put_buf.append(msg)
            self._put_buf.append(("addref", oid.binary()))
            self._put_buf_bytes += nbytes
            full = (len(self._put_buf) >= 2 * _PUT_FLUSH_COUNT
                    or self._put_buf_bytes >= _PUT_FLUSH_BYTES)
        if full:
            self.flush_puts()

    def _drain_put_buffer(self) -> list:
        with self._put_lock:
            buf, self._put_buf = self._put_buf, []
            self._put_buf_bytes = 0
        return buf

    def flush_puts(self):
        # Drain under send_lock: a drained-but-unwritten batch here must
        # not let a concurrent _send (whose message may reference one of
        # these puts) overtake it on the wire.  _send_wire parks the
        # batch across a head blip instead of raising.
        with self.send_lock:
            buf = self._drain_put_buffer()
            self._send_wire(buf)

    def serialize_value(self, value, object_id: ObjectID):
        """By-value task args travel inline or as parts inside the spec —
        never via a client-local shm segment nobody else can map.

        bytes() SNAPSHOT, deliberately: unlike put_object (whose message
        pickles synchronously before return), a spec can sit UNPICKLED
        in lease queues / dep-wait lists and be (re)pickled much later —
        live PickleBuffer views would capture the caller's buffer at
        push time, so a mutation after .remote() (reused rollout
        buffers) would tear the argument."""
        res = serialization.dumps_adaptive(value, self.max_inline)
        if res[0] == "inline":
            return (protocol.INLINE, res[1])
        return (protocol.PARTS, res[1], [bytes(b) for b in res[2]])

    def request(self, builder):
        """Generic control request (cluster_info, jobs, state...)."""
        return self._request(builder)

    # Client-side spellings of the head's introspection surface (the
    # failover drill drives an external head purely through a client).
    def list_nodes(self):
        return self.request(lambda rid: ("cluster_info", rid))["nodes"]

    def state_query(self, kind: str, **kwargs):
        out = self.request(lambda rid: ("state_req", rid, kind, kwargs))
        if isinstance(out, Exception):
            raise out
        return out

    def transfer_stats(self):
        return self.state_query("transfer_stats")[0]

    def dial(self, addr):
        """Direct-plane dials (granted lease workers, actor channels)
        use THIS session's authkey — the env fallback the worker-side
        dial reads may hold a stale key from an earlier client session
        in the same process (client_connect's setdefault), which would
        silently break every lease adoption with an auth error.
        Deadline-aware (connect timeout + SO_KEEPALIVE) like every
        other dial site."""
        conn = protocol.dial(tuple(addr), authkey=self._authkey)
        if self._fd_on and self._net_stall_t > 0:
            # Send half only (see _WorkerRuntime.dial).
            protocol.set_send_deadline(conn, self._net_stall_t)
        return conn

    # -- head failover (client flavor of the worker machinery) -------------
    def _redial(self):
        return protocol.dial(protocol.parse_address(self._address),
                             authkey=self._authkey)

    def _re_handshake(self, conn):
        """Clients re-enter through the client_ready handshake (which
        refreshes the head's direct-put bootstrap), then re-register
        in-band: held leases and delegated objects re-advertised so the
        restarted head can reconcile them."""
        protocol.send(conn, ("client_ready", os.urandom(16).hex()))
        msg = protocol.recv(conn)
        if msg[0] != "client_ack":
            return None
        info = msg[2] if len(msg) > 2 else {}
        if isinstance(info, dict) and info.get("object_addr") \
                and info.get("store_id"):
            self._head_put_info = (info["store_id"],
                                   info["object_addr"],
                                   tuple(info.get("object_caps") or ()))
        protocol.send(conn, ("reregister", {
            "held_leases": self.direct.held_lease_ids(),
            "objects": self.direct.reregister_exports(),
        }))
        return True

    def disconnect(self):
        self._shutting_down = True  # the reader must exit, not re-dial
        try:
            self.flush_puts()
            self.flush_decrefs()
        except Exception:
            pass
        try:
            self.conn.close()
        except Exception:
            pass
        for pools in (self._puller, self._pusher):
            try:
                pools.close()
            except Exception:
                pass
        from ray_tpu_torch._private import api_internal

        if api_internal.get_runtime() is self:
            api_internal.set_global_runtime(None)


def client_connect(address: str, authkey: bytes,
                   max_inline: int = 1024 * 1024) -> ClientRuntime:
    import time

    addr = protocol.parse_address(address)
    conn = None
    err: Optional[BaseException] = None
    for attempt in range(20):
        try:
            # Deadline-aware dial: a black-holed head address fails
            # each attempt in net_connect_timeout_s (the kernel default
            # is ~2 min — twenty of those is not a retry loop).
            conn = protocol.dial(addr, authkey=authkey)
            break
        except (ConnectionError, OSError) as e:
            err = e
            time.sleep(0.1 * (attempt + 1))
    if conn is None:
        raise ConnectionError(f"cannot reach cluster at {address}: {err}")
    os.environ.setdefault("RAY_TPU_AUTHKEY", authkey.hex())
    shm = ShmStore(shm_dir=tempfile.mkdtemp(prefix="ray_tpu_client_"))
    send_lock = threading.Lock()  # lock-order: io-guard
    rt = ClientRuntime(conn, send_lock, shm, max_inline)
    rt._address = address
    rt._authkey = authkey
    # The puller dials remote object servers (including the head's own —
    # large results stream back directly instead of relaying through the
    # control-plane connection).  Hand it THIS cluster's authkey
    # explicitly: the env setdefault above must not leave a stale key
    # from an earlier session on the pull path.
    rt._puller._authkey = authkey
    rt._pusher._authkey = authkey
    protocol.send(conn, ("client_ready", os.urandom(16).hex()))
    msg = protocol.recv(conn)
    assert msg[0] == "client_ack", msg
    rt.store_id = f"client-{os.urandom(4).hex()}"  # nothing shares it
    # Direct-put bootstrap (this release's heads): the head's store
    # identity + object-server address + advertised verbs.  An old
    # 2-tuple ack leaves _head_put_info None — every put then rides the
    # legacy put_parts path, and no new verb is ever sent.
    info = msg[2] if len(msg) > 2 else {}
    if isinstance(info, dict) and info.get("object_addr") \
            and info.get("store_id"):
        rt._head_put_info = (info["store_id"], info["object_addr"],
                             tuple(info.get("object_caps") or ()))

    def handle(m):
        tag = m[0]
        if protocol.is_batch(m):
            # Conflation-sender frame from the head: unwrap in order.
            for sub in m[1]:
                handle(sub)
        elif tag == "obj":
            rt.deliver_reply(m[1], (m[2], m[3]))
        elif tag == "mgot":
            rt.deliver_reply(m[1], m[2])
        elif tag == "waited":
            rt.deliver_reply(m[1], m[2])
        elif tag == "reply":
            rt.deliver_reply(m[1], m[2])
        elif tag == "lease_grant":
            # Unsolicited bulk grant piggybacked on this client's
            # head-brokered submit burst; adopt off the reader thread
            # (adoption dials the granted workers).
            threading.Thread(
                target=rt.direct.adopt_grant,
                args=(m[1], m[2], m[3], m[4], m[5]),
                daemon=True, name="ray_tpu_torch-client-lease").start()
        elif tag == "lease_revoke":
            rt.direct.revoke(m[1])

    def reader():
        while True:
            try:
                m = protocol.recv(rt.conn)
            except (EOFError, OSError, TypeError):
                # Head gone.  Park in-flight calls and re-dial for the
                # grace window (worker-flavor machinery, client-flavor
                # handshake) — a head restart becomes a stall, not a
                # dead session.  disconnect() sets _shutting_down so a
                # deliberate close still exits here.
                if not rt._reconnect_head():
                    return
            else:
                rt.note_head_recv()  # any head message is liveness
                handle(m)

    threading.Thread(target=reader, daemon=True,
                     name="ray_tpu_torch-client-reader").start()

    def flusher():
        import time as _t

        while True:
            _t.sleep(0.25)
            try:
                rt.flush_decrefs()
                # Lease-plane counter deltas (leased_submits/spillbacks):
                # a client drives direct pushes too and its counters feed
                # the same head-side transfer_stats aggregation.
                rt.flush_xfer_stats()
                # Failure detection: heartbeat floor + stalled-head
                # watchdog (client flavor of the worker machinery).
                rt.heartbeat_and_watchdog()
            except Exception:
                return

    threading.Thread(target=flusher, daemon=True,
                     name="ray_tpu_torch-client-flush").start()
    # Route ObjectRef callbacks through the GLOBAL accessor, not a
    # closure over this client: after disconnect + re-init, refs must
    # see the new runtime, not a closed connection.
    from ray_tpu_torch._private import api_internal

    object_ref_mod._set_runtime_accessor(api_internal.get_runtime)
    return rt
