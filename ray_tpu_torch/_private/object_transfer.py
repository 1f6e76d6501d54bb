"""Direct node-to-node object transfer, chunked, pooled and striped.

Reference: ``src/ray/object_manager/object_manager.h:117,206`` +
``object_buffer_pool.h`` — objects move between nodes in bounded chunks
directly between the object managers, with MULTIPLE transfers in flight;
the control plane (GCS) only brokers *locations*.  Here every node agent
(and the head, for its own store) runs an object server on its own TCP
listener; consumers (workers on other nodes, the driver, clients) dial it
and pull segments as streams of ≤1 MB chunks.  The head carries location
lookups only — never payload bytes.

Parallelism (the reference's in-flight chunk window,
``object_buffer_pool.h``): the puller keeps a small CONNECTION POOL per
peer store (``config.object_pool_size``, default 4).  Concurrent fetches
of different segments from one peer each ride their own pooled
connection, and a single large segment (≥ ``config.
object_stripe_threshold``, default 32 MB) is fetched as concurrent
byte-range STRIPES over several connections via the ``fetch_range`` verb.
Peers that only speak the original ``fetch`` verb (no ``fetch_range`` in
their advertised caps) are served by plain whole-segment streams — the
pool still parallelizes across segments.

Zero-copy receive: the receiver reserves its destination buffer up front
(a shm mapping via ``ShmStore.reserve_recv`` — see ``pull_to_segment``)
and ``recv_bytes_into``\\ s every chunk straight into it at its final
offset.  Receive is one copy end-to-end, like the send side (which
streams ``memoryview`` slices of the source mmap).

Write direction (direct puts; reference: plasma ``CreateObject``/
``Seal`` on the store socket): ``ObjectPusher`` streams a serialized
value INTO a peer's store through the same pooled connections — a
``reserve_put`` preallocates the PUBLIC destination segment (spill-aware
admission in the store), ``put_range`` stripes recv straight into the
mapping at final offsets, ``commit_put`` seals it.  The control plane
then carries only an O(1) ``put_commit`` descriptor registration.  All
put verbs ride the same CAPS advertisement as ``fetch_range``.
"""

from __future__ import annotations

import logging
import random
import threading
import time
import weakref
from collections import deque
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch._private import protocol, recovery, serialization
from ray_tpu_torch._private.shm_store import _HEADER, _MAGIC


# Structured ObjectLostError fields from a segment name (one
# naming-rule implementation, recovery.py).
_seg_oid_hex = recovery.seg_oid_hex

logger = logging.getLogger(__name__)

CHUNK = 1 << 20  # 1 MB, the reference's object-manager chunk size

# Write-direction verbs (direct puts): a pusher streams a value's bytes
# into a reservation on the destination store.  Advertised together —
# a pusher engages only against peers declaring ALL of them.
PUT_CAPS: Tuple[str, ...] = ("reserve_put", "put_range", "commit_put",
                             "abort_put")

# Verbs this side's object server speaks beyond the original "fetch".
# Advertised out of band (agent_ready info / store_addr / client_ack
# replies) so pullers and pushers never probe a peer with a verb it
# would silently ignore.
CAPS: Tuple[str, ...] = ("fetch_range",) + PUT_CAPS


def peer_accepts_puts(caps) -> bool:
    """True when the peer's advertised verb set covers the whole direct-
    put lifecycle — the capability gate that keeps old-verb-only peers
    on the legacy ``put_parts`` path without ever seeing a new verb."""
    return all(v in caps for v in PUT_CAPS)


def _net_stall_timeout() -> float:
    """This process's zero-progress deadline for wire transfers; 0.0
    (never arm a deadline — the legacy fully-blocking behavior) with
    ``failure_detection`` off."""
    from ray_tpu_torch._private.config import GLOBAL_CONFIG as _cfg

    return (_cfg.net_stall_timeout_s if _cfg.failure_detection else 0.0)


def net_params(cfg) -> Tuple[float, float, int, float]:
    """A Config -> the pool hosts' frozen failure-detection tuple
    (stall_timeout_s, connect_timeout_s, retry_count, backoff_base_ms);
    all-zero with the master switch off so nothing new ever runs."""
    if not cfg.failure_detection:
        return (0.0, 0.0, 0, 0.0)
    return (cfg.net_stall_timeout_s, cfg.net_connect_timeout_s,
            int(cfg.net_retry_count), cfg.net_retry_backoff_base_ms)

# Segment names whose metadata table failed to parse in _true_extent —
# each is logged once at debug level (bounded; see below).
_extent_fallbacks: set = set()


def _true_extent(view: memoryview, name: str = "?") -> int:
    """Bytes actually used by the segment — pooled reuse can leave a file
    up to ~2x the object (plus stale freed-object bytes); shipping the
    slack would waste network and receiver memory."""
    try:
        _magic, meta_len = _HEADER.unpack_from(view, 0)
        table = bytes(view[_HEADER.size:_HEADER.size + meta_len])
        offsets, lengths, _payload = serialization.loads_inline(table)
        end = _HEADER.size + meta_len
        for o, n in zip(offsets, lengths):
            end = max(end, o + n)
        return min(end, len(view))
    except Exception as e:  # noqa: BLE001 — fall back to whole-file extent
        # The fallback ships every byte of the file (incl. pool slack);
        # log once per segment so the wasted bytes are diagnosable.
        if name not in _extent_fallbacks:
            if len(_extent_fallbacks) > 4096:
                _extent_fallbacks.clear()
            _extent_fallbacks.add(name)
            logger.debug(
                "object_transfer: cannot parse segment table of %s "
                "(%r); shipping full file extent of %d bytes",
                name, e, len(view))
        return len(view)


def serve_connection(conn, store):
    """Agent-side loop for one consumer/producer connection: stream
    requested segments (or byte ranges of them) chunk by chunk
    (reference: ObjectManager::Push), and receive pushed puts into
    store reservations (reference: plasma CreateObject/Seal on the
    store socket).  ``reserved`` tracks reservations made on THIS
    connection so a pusher dying between ``reserve_put`` and
    ``commit_put`` (its socket closes) triggers the abort cleanup —
    no leaked segments, accounting restored."""
    reserved: set = set()
    try:
        while True:
            msg = protocol.recv(conn)
            if msg[0] == "fetch":
                name = msg[1]
                try:
                    seg = store.attach(name)
                except Exception as e:  # noqa: BLE001
                    protocol.send(conn, ("err", repr(e)))
                    continue
                try:
                    mv = memoryview(seg._mm)
                    total = _true_extent(mv, name)
                    protocol.send(conn, ("ok", total))
                    for off in range(0, total, CHUNK):
                        protocol.net_point("chunk_send", conn)
                        conn.send_bytes(mv[off:min(off + CHUNK, total)])
                finally:
                    del mv
                    seg.close()
            elif msg[0] == "fetch_range":
                # Byte-range stripe (clamped to the true extent).  The
                # reply carries BOTH the clamped stripe length and the
                # segment's total extent, so the first stripe doubles as
                # the size probe — no extra stat round trip.
                _tag, name, off, length = msg
                try:
                    seg = store.attach(name)
                except Exception as e:  # noqa: BLE001
                    protocol.send(conn, ("err", repr(e)))
                    continue
                try:
                    mv = memoryview(seg._mm)
                    total = _true_extent(mv, name)
                    off = min(max(0, off), total)
                    n = max(0, min(length, total - off))
                    protocol.send(conn, ("ok", n, total))
                    for o in range(off, off + n, CHUNK):
                        protocol.net_point("chunk_send", conn)
                        conn.send_bytes(mv[o:min(o + CHUNK, off + n)])
                finally:
                    del mv
                    seg.close()
            elif msg[0] == "reserve_put":
                # Direct-put reservation: preallocate the destination
                # mapping (public segment; spill-aware admission happens
                # in the store) and reply with its canonical name —
                # stripes and the commit address it by name, possibly
                # over OTHER pooled connections.
                _tag, oid_bin, total = msg
                try:
                    name = _puts_for(store).reserve(oid_bin, total)
                except Exception as e:  # noqa: BLE001
                    protocol.send(conn, ("err", repr(e)))
                    continue
                reserved.add(name)
                protocol.send(conn, ("ok", name))
            elif msg[0] == "put_range":
                # One byte-range stripe of a pending put: the payload
                # chunks following this message land straight in the
                # reserved mapping at their final offsets (socket ->
                # mmap, one copy).  The ack is the pusher's durability
                # signal for this range.
                _tag, name, off, length = msg
                if _puts_for(store).write(name, conn, off, length):
                    protocol.send(conn, ("ok", length))
                else:
                    protocol.send(conn, ("err",
                                         f"no pending put {name!r}"))
            elif msg[0] == "commit_put":
                name = msg[1]
                reserved.discard(name)
                try:
                    kind, ident, total = _puts_for(store).commit(name)
                except Exception as e:  # noqa: BLE001
                    protocol.send(conn, ("err", repr(e)))
                    continue
                protocol.send(conn, ("ok", kind, ident, total))
            elif msg[0] == "abort_put":
                reserved.discard(msg[1])
                _puts_for(store).abort(msg[1])
                protocol.send(conn, ("ok",))
            elif msg[0] == "close":
                return
    except (EOFError, OSError, TypeError):
        return
    finally:
        for name in reserved:
            # Reserving connection died/closed without commit: tear the
            # reservation down (pusher-death hygiene).
            try:
                _puts_for(store).abort(name)
            except Exception:
                pass
        try:
            conn.close()
        except Exception:
            pass


def accept_loop(listener, store, stopped, conn_name: str):
    """Shared object-server accept loop (node agents and the head run the
    identical one): accept, disable Nagle, and hand each consumer
    connection to its own ``serve_connection`` thread.  ``stopped`` is a
    callable polled so the owner's shutdown (which closes the listener)
    ends the loop."""
    while not stopped():
        try:
            conn = listener.accept()
            protocol.enable_nodelay(conn)
        except Exception:
            if stopped():
                return
            continue
        threading.Thread(target=serve_connection, args=(conn, store),
                         daemon=True, name=conn_name).start()


# One server-side put registry per store instance, shared by every
# consumer connection of that store's object server (reservation on one
# connection, stripes on others).  Keyed weakly so a retired store (agent
# re-registration) drops its registry with it.
_put_registries: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_put_registries_lock = threading.Lock()


def _puts_for(store) -> "PutRegistry":
    with _put_registries_lock:
        reg = _put_registries.get(store)
        if reg is None:
            reg = _put_registries[store] = PutRegistry(store)
        return reg


class PutRegistry:
    """Pending direct puts on ONE destination store (server side).

    A put's lifecycle spans multiple connections: ``reserve_put`` on the
    pusher's primary connection creates the entry, ``put_range`` stripes
    arrive on any pooled connection and recv straight into the shared
    mapping at disjoint offsets, ``commit_put``/``abort_put`` retire it.

    LOCK ORDER (checked by tests/test_lockcheck.py): ``_lock`` is an
    INDEPENDENT LEAF — it guards only the entry table and each entry's
    writer count / dead flag; reservation (file create), the stripe
    recv streaming, and the mapping teardown all run OUTSIDE it.  The
    writer count is what makes ``abort`` safe against in-flight stripes:
    the mapping is closed by the aborter only at writer count zero,
    else by the last draining writer.
    """

    def __init__(self, store):
        # weakref, NOT a strong reference: the registry is the VALUE in
        # a WeakKeyDictionary keyed by this store — a strong value->key
        # path would pin retired stores (and their registries) forever.
        # Pending reservations still legitimately pin the store through
        # their own PutReservation.store until resolved.
        self._store_ref = weakref.ref(store)
        self._lock = threading.Lock()  # lock-order: leaf
        self._pending: dict = {}  # name -> shm_store.PutReservation

    def reserve(self, oid_bin: bytes, total: int) -> str:
        store = self._store_ref()
        if store is None:
            raise OSError("destination store retired")
        res = store.reserve_put(oid_bin, total)
        with self._lock:
            if res.name in self._pending:
                dup = True
            else:
                dup = False
                self._pending[res.name] = res
        if dup:  # same object pushed twice concurrently: refuse the 2nd
            res.abort()
            raise ValueError(f"put already pending for {res.name}")
        return res.name

    def write(self, name: str, conn, off: int, length: int) -> bool:
        """Receive one stripe's payload into the reservation; returns
        False (after draining the payload, keeping the connection in
        sync) when the reservation is gone/dead or the range is out of
        bounds."""
        with self._lock:
            res = self._pending.get(name)
            if (res is None or res.dead or off < 0 or length < 0
                    or off + length > res.total):
                res = None
            else:
                res.writers += 1
        if res is None:
            _drain_discard(conn, length)
            return False
        # Zero-progress deadline while the stripe payload streams in: a
        # pusher that stalls mid-stripe errors this connection (the
        # serve loop's cleanup then aborts the reservation) instead of
        # wedging a server thread forever.  Cleared before the reply so
        # the connection's idle wait stays blocking.
        stall_t = _net_stall_timeout()
        if stall_t > 0:
            protocol.set_conn_deadline(conn, stall_t)
        try:
            view = memoryview(res.mm)
            try:
                _recv_range(conn, view, off, length)
            finally:
                del view
        finally:
            if stall_t > 0:
                try:
                    protocol.set_conn_deadline(conn, None)
                except OSError:
                    pass
            dispose = False
            with self._lock:
                res.writers -= 1
                if res.dead and res.writers == 0:
                    dispose = True
            if dispose:
                res.abort()
        return True

    def commit(self, name: str):
        with self._lock:
            res = self._pending.pop(name, None)
        if res is None:
            raise ValueError(f"no pending put {name!r}")
        res.commit()
        return res.kind, res.ident, res.total

    def abort(self, name: str) -> bool:
        """Tear down a pending reservation; returns True when one was
        found (its file/accounting teardown is owned by this call or —
        with stripes still draining — by the last writer)."""
        dispose = None
        with self._lock:
            res = self._pending.pop(name, None)
            if res is not None:
                if res.writers > 0:
                    res.dead = True  # last draining writer disposes
                else:
                    dispose = res
        if dispose is not None:
            dispose.abort()
        return res is not None


def _drain_discard(conn, n: int):
    """Consume and discard ``n`` payload bytes from a desynced-put
    stripe so the connection stays at a message boundary for the error
    reply.  Deadline-armed: a pusher that stalls mid-drain errors this
    connection (the serve loop's cleanup closes it) instead of wedging
    a server thread on a doomed stream."""
    from multiprocessing import BufferTooShort

    stall_t = _net_stall_timeout()
    if stall_t > 0:
        protocol.set_conn_deadline(conn, stall_t)
    scratch = bytearray(CHUNK)
    got = 0
    try:
        while got < n:
            try:
                got += conn.recv_bytes_into(scratch)  # noqa: RTL403 -- deadline armed above (legacy blocking with the switch off)
            except BufferTooShort as e:
                got += len(e.args[0])
    finally:
        if stall_t > 0:
            try:
                protocol.set_conn_deadline(conn, None)
            except OSError:
                pass


class _ConnPool:
    """Connections to ONE peer object server.

    The condition's lock guards only ``idle``/``total``/``closed`` —
    it is NEVER held across a dial or any stream I/O, so a connection
    mid-transfer cannot stall another thread's acquire/release.

    Failure isolation: ``evict`` closes ONLY the broken connection and
    decrements ``total`` under the condition, waking any waiter so it can
    dial a replacement — other pooled connections (and the threads
    streaming on them) are untouched.
    """

    __slots__ = ("addr", "authkey", "limit", "idle", "total", "cv",
                 "closed", "connect_timeout")

    def __init__(self, addr: str, authkey: bytes, limit: int,
                 connect_timeout: float = 0.0):
        self.addr = addr
        self.authkey = authkey
        self.limit = max(1, limit)
        self.idle: list = []
        self.total = 0
        self.cv = threading.Condition()
        self.closed = False
        # 0.0 = legacy unbounded dial (failure_detection off).
        self.connect_timeout = connect_timeout

    def acquire(self, timeout: Optional[float] = None):
        """An exclusive connection: a pooled idle one, a fresh dial while
        under the limit, else wait for a release/evict.  Returns None on
        timeout (stripe helpers give up and let the primary connection
        finish the job)."""
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        with self.cv:
            while True:
                if self.closed:
                    raise OSError(f"connection pool to {self.addr} closed")
                if self.idle:
                    return self.idle.pop()
                if self.total < self.limit:
                    self.total += 1
                    break  # dial outside the condition
                left = (None if deadline is None
                        else deadline - time.monotonic())
                if left is not None and left <= 0:
                    return None
                self.cv.wait(left)
        try:
            # Deadline-aware dial: connect timeout + SO_KEEPALIVE when
            # the failure-detection plane is on (a black-holed peer
            # fails the dial in net_connect_timeout_s instead of the
            # kernel's ~2 min default); the legacy Client() dial with
            # it off.
            conn = protocol.dial(protocol.parse_address(self.addr),
                                 authkey=self.authkey,
                                 connect_timeout=self.connect_timeout)
            return conn
        except BaseException:
            with self.cv:
                self.total -= 1
                self.cv.notify()
            raise

    def release(self, conn):
        close_it = False
        with self.cv:
            if self.closed:
                self.total -= 1
                close_it = True
            else:
                self.idle.append(conn)
            self.cv.notify()
        if close_it:
            try:
                conn.close()
            except Exception:
                pass

    def evict(self, conn):
        """Close ONLY this (broken) connection; waiters redial."""
        try:
            conn.close()
        except Exception:
            pass
        with self.cv:
            self.total -= 1
            self.cv.notify()

    def close(self):
        with self.cv:
            self.closed = True
            conns, self.idle = self.idle, []
            self.total -= len(conns)
            self.cv.notify_all()
        for conn in conns:
            try:
                protocol.send(conn, ("close",))
            except Exception:
                pass
            try:
                conn.close()
            except Exception:
                pass


class _PoolHost:
    """Per-peer connection-pool registry shared by the pull and push
    sides (ObjectPuller / ObjectPusher).

    LOCK ORDER (checked by tests/test_lockcheck.py via devtools.lockcheck):
    the registry ``_lock`` and every pool's condition lock are INDEPENDENT
    LEAVES — neither may be acquired while the other is held.  The
    registry lock guards only the ``_pools`` dict (lookup/insert/pop,
    never I/O and never a pool-condition acquire under it); a pool's
    condition guards only that pool's idle list and connection count and
    is never held across a dial or any stream I/O.  Streaming itself runs
    on an exclusively-acquired connection and holds NO lock at all — this
    is what lets N transfers to/from one peer proceed in parallel where
    the old design serialized them behind one per-connection lock held
    for the whole stream.
    """

    def __init__(self, authkey: bytes, pool_size: int,
                 net_config=None):
        self._authkey = authkey
        self._pool_size = pool_size
        self._pools: Dict[str, _ConnPool] = {}  # store_id -> pool
        self._lock = threading.Lock()  # lock-order: leaf
        # Failure-detection parameters, frozen at construction
        # (stall_timeout_s, connect_timeout_s, retry_count,
        # backoff_base_ms).  Default: this process's GLOBAL_CONFIG; the
        # head passes its _system_config explicitly.  All zero with the
        # switch off — no deadline is ever armed, no retry ever runs,
        # byte-identical legacy blocking transfers.
        if net_config is None:
            from ray_tpu_torch._private.config import GLOBAL_CONFIG as _cfg

            net_config = net_params(_cfg)
        (self._stall_t, self._connect_t, self._net_retries,
         self._backoff_base_ms) = net_config

    def _pool_for(self, store_id: str, addr: str) -> _ConnPool:
        stale = None
        with self._lock:
            pool = self._pools.get(store_id)
            if pool is not None and pool.addr != addr:
                # Peer restarted on a new port: retire the old pool.
                stale, pool = pool, None
            if pool is None:
                pool = self._pools[store_id] = _ConnPool(
                    addr, self._authkey, self._pool_size,
                    connect_timeout=self._connect_t)
        if stale is not None:
            stale.close()
        return pool

    # ------------------------------------------- deadlines & retries --
    def _arm(self, conn):
        """Zero-progress deadline on an exclusively-acquired pooled
        connection for the duration of one transfer: every syscall gets
        ``net_stall_timeout_s`` to move bytes (progress resets the
        clock in the kernel), so a slow-but-moving stripe is never
        killed while a stalled one dies on time."""
        if self._stall_t > 0:
            protocol.set_conn_deadline(conn, self._stall_t)

    def _disarm(self, conn):
        """Clear the deadline before the connection returns to the pool
        (idle pooled connections must wait blocking, not time out)."""
        if self._stall_t > 0:
            try:
                protocol.set_conn_deadline(conn, None)
            except OSError:
                pass

    def _backoff(self, attempt: int):
        """Exponential backoff with jitter between transport retries —
        an in-lockstep retry storm against a recovering peer is its own
        failure mode."""
        base = self._backoff_base_ms / 1000.0
        delay = base * (2 ** (attempt - 1))
        time.sleep(delay * (1.0 + 0.5 * random.random()))

    def _run_with_net_retries(self, op, describe):
        """Run one transfer attempt function with the transport-retry
        policy: a zero-progress stall counts ``stall_timeouts``, evicts
        only the broken pooled connection (inside ``op``), and retries
        with backoff+jitter up to ``net_retry_count`` times
        (``net_retries``); exhaustion raises NetTimeoutError for the
        caller to wrap into its structured loss error.  Non-stall
        failures propagate untouched (they were never deadline
        trips)."""
        attempt = 0
        while True:
            try:
                return op()
            except BaseException as e:  # noqa: BLE001 -- stalls filtered, rest re-raised
                # A helper-stripe stall surfaces wrapped (_StripeError
                # from the pusher, the raw EAGAIN OSError re-raised from
                # the error list on the pull side): look one cause deep.
                if not (protocol.is_stall(e)
                        or (e.__cause__ is not None
                            and protocol.is_stall(e.__cause__))):
                    raise
                protocol.note_net_event("stall_timeouts")
                if attempt >= self._net_retries:
                    raise protocol.NetTimeoutError(
                        f"{describe} stalled past {self._stall_t}s "
                        f"({attempt} retr{'y' if attempt == 1 else 'ies'}"
                        f" exhausted)") from e
                attempt += 1
                protocol.note_net_event("net_retries")
                self._backoff(attempt)

    def drop(self, store_id: str):
        with self._lock:
            pool = self._pools.pop(store_id, None)
        if pool is not None:
            pool.close()

    def close(self):
        with self._lock:
            pools, self._pools = list(self._pools.values()), {}
        for pool in pools:
            pool.close()


class ObjectPuller(_PoolHost):
    """Consumer-side client: pooled connections to home-store object
    servers, pulling segments as chunk streams — whole segments or
    concurrent byte-range stripes (reference: ObjectManager::Pull +
    ObjectBufferPool chunk assembly with multiple chunks in flight).
    Lock conventions: see _PoolHost.
    """

    def __init__(self, authkey: bytes, pool_size: Optional[int] = None,
                 stripe_threshold: Optional[int] = None,
                 net_config=None):
        from ray_tpu_torch._private.config import GLOBAL_CONFIG as _cfg

        super().__init__(authkey,
                         pool_size if pool_size is not None
                         else _cfg.object_pool_size,
                         net_config=net_config)
        self._stripe = (stripe_threshold if stripe_threshold is not None
                        else _cfg.object_stripe_threshold)

    # ------------------------------------------------------------ fetch --
    def fetch(self, store_id: str, addr: str, name: str, sink=None,
              caps: Tuple[str, ...] = ()):
        """The raw segment bytes, pulled in CHUNK pieces.

        ``sink(total)`` supplies the destination buffer once the size is
        known (default: a fresh ``bytearray``) — pass a shm mapping for a
        one-copy receive (``pull_to_segment``).  ``caps`` is the peer's
        advertised verb set: with ``"fetch_range"`` present, a segment at
        least the stripe threshold long arrives as concurrent byte-range
        stripes over several pooled connections.  Returns the filled
        buffer.

        Failure detection: every attempt runs under the zero-progress
        stall deadline; a stall evicts only the broken pooled connection
        and the fetch retries (backoff+jitter, ``net_retries``) before
        surfacing a structured, reconstructable
        ``ObjectLostError(phase="stalled")`` — the caller then hedges to
        its existing getparts/relay fallback and ultimately to lineage
        reconstruction.  A timeout is never a hang."""
        try:
            return self._run_with_net_retries(
                lambda: self._fetch_attempt(store_id, addr, name, sink,
                                            caps),
                f"pull of {name} from {store_id}")
        except protocol.NetTimeoutError as e:
            from ray_tpu_torch import exceptions as exc

            raise exc.ObjectLostError(
                f"segment {name} stalled at {store_id}: {e}",
                object_id=_seg_oid_hex(name), home=store_id,
                phase="stalled") from e

    def _fetch_attempt(self, store_id: str, addr: str, name: str, sink,
                       caps: Tuple[str, ...]):
        pool = self._pool_for(store_id, addr)
        conn = pool.acquire()
        self._arm(conn)
        try:
            if "fetch_range" in caps and self._stripe > 0:
                buf = self._fetch_striped(pool, conn, store_id, name, sink)
            else:
                buf = self._fetch_whole(conn, store_id, name, sink)
        except BaseException:
            # Evict ONLY this connection (a peer error reply leaves the
            # stream positioned at the next request, but a transport or
            # mid-stream failure leaves it desynced — close it either
            # way; redial is cheap and rare).  Concurrent fetches on the
            # pool's other connections are unaffected.
            pool.evict(conn)
            raise
        self._disarm(conn)
        pool.release(conn)
        return buf

    def _fetch_whole(self, conn, store_id: str, name: str, sink):
        protocol.send(conn, ("fetch", name))
        reply = protocol.recv(conn)
        if reply[0] != "ok":
            from ray_tpu_torch import exceptions as exc

            raise exc.ObjectLostError(
                f"segment {name} unreadable at {store_id}: {reply[1]}",
                object_id=_seg_oid_hex(name), home=store_id,
                phase="pull")
        total = reply[1]
        buf = bytearray(total) if sink is None else sink(total)
        view = memoryview(buf)
        _recv_range(conn, view, 0, total)
        return buf

    def _fetch_striped(self, pool: _ConnPool, conn, store_id: str,
                      name: str, sink):
        """Whole segment via byte-range requests: the first request is
        both size probe and first stripe; anything beyond it is split
        into stripe-sized ranges drained by this thread AND helper
        threads on additional pooled connections."""
        from ray_tpu_torch import exceptions as exc

        stripe = self._stripe
        protocol.send(conn, ("fetch_range", name, 0, stripe))
        reply = protocol.recv(conn)
        if reply[0] != "ok":
            raise exc.ObjectLostError(
                f"segment {name} unreadable at {store_id}: {reply[1]}",
                object_id=_seg_oid_hex(name), home=store_id,
                phase="pull")
        _tag, first_n, total = reply
        buf = bytearray(total) if sink is None else sink(total)
        view = memoryview(buf)
        _recv_range(conn, view, 0, first_n)
        if first_n >= total:
            return buf

        ranges = deque((off, min(stripe, total - off))
                       for off in range(first_n, total, stripe))
        errors: list = []

        def drain(c):
            while not errors:
                try:
                    off, length = ranges.popleft()
                except IndexError:
                    return
                protocol.send(c, ("fetch_range", name, off, length))
                r = protocol.recv(c)
                if r[0] != "ok" or r[1] != length:
                    raise exc.ObjectLostError(
                        f"segment {name} changed mid-stripe at "
                        f"{store_id}: {r!r}",
                        object_id=_seg_oid_hex(name), home=store_id,
                        phase="pull")
                _recv_range(c, view, off, length)

        def helper():
            # A busy pool is not an error: give up quickly and let the
            # primary connection finish the remaining ranges.
            try:
                c = pool.acquire(timeout=0.25)
            except OSError:
                return
            if c is None:
                return
            self._arm(c)
            try:
                drain(c)
            except BaseException as e:  # noqa: BLE001 — joined below
                errors.append(e)
                pool.evict(c)
                return
            self._disarm(c)
            pool.release(c)

        helpers = [
            threading.Thread(target=helper, daemon=True,
                             name="rtpu-stripe")
            for _ in range(min(len(ranges), self._pool_size - 1))
        ]
        for t in helpers:
            t.start()
        try:
            drain(conn)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            # Signal the helpers (their loop checks ``errors``) so they
            # stop at their next range instead of streaming the rest of
            # a doomed transfer; failure propagates after the join.
            errors.append(e)
            raise
        finally:
            for t in helpers:
                t.join()
        if errors:
            raise errors[0]
        return buf


class PutUnsupportedError(RuntimeError):
    """The destination's advertised caps lack the put verbs — the caller
    keeps the legacy ``put_parts`` control-plane path (never probed)."""


class _StripeError(Exception):
    """A HELPER stripe connection failed; the primary connection is at a
    message boundary (safe to send ``abort_put`` on it)."""


class ObjectPusher(_PoolHost):
    """Producer-side twin of ObjectPuller: stream a serialized value
    straight into a reservation on the destination store's object server
    — whole on one pooled connection, or as concurrent byte-range
    stripes over several (reference: plasma CreateObject/Seal through
    the store socket; writes never ride the control plane).

    The pusher computes the destination segment's exact on-disk image
    locally (``shm_store.segment_layout`` — header+table+aligned
    buffers) and streams byte ranges of that LOGICAL image without ever
    materializing it: each range walks the source buffer views, with
    alignment/padding gaps sent as zeros.  One copy end-to-end
    (source buffer -> socket -> destination mmap).

    Failure hygiene mirrors the pull side: a mid-stream error evicts
    ONLY the broken pooled connection; a reservation whose push failed
    is aborted — explicitly via ``abort_put`` when the primary
    connection is at a message boundary, else implicitly by the server's
    reserving-connection-close cleanup.  Lock conventions: _PoolHost.
    """

    def __init__(self, authkey: bytes, pool_size: Optional[int] = None,
                 stripe_threshold: Optional[int] = None,
                 net_config=None):
        from ray_tpu_torch._private.config import GLOBAL_CONFIG as _cfg

        super().__init__(authkey,
                         pool_size if pool_size is not None
                         else (_cfg.object_put_pool_size
                               or _cfg.object_pool_size),
                         net_config=net_config)
        self._stripe = (stripe_threshold if stripe_threshold is not None
                        else _cfg.object_put_stripe_threshold)

    def push(self, store_id: str, addr: str, oid_bin: bytes, meta,
             buffers, caps: Tuple[str, ...] = (),
             stripe_threshold: Optional[int] = None):
        """Push one serialized value (``meta`` + out-of-band buffer
        views) into ``store_id``'s store; returns ``(kind, ident,
        total)`` — kind ``"shm"``/``"spilled"``, ident the segment name
        or spill path, total the committed byte size — for the caller's
        ``("put_commit", ...)`` control message.  Raises
        PutUnsupportedError (without any wire traffic) when the peer
        does not advertise the put verbs.

        The put verbs double as the serving tier's chain-handoff wire
        protocol: a prefill replica streams a finished KV block chain
        (contiguous block pages + pickled block table, laid out by
        ``segment_layout``) into the decode replica's node store with
        exactly this ``reserve_put`` → ``put_range``* → ``commit_put``
        sequence, and the decode side attaches the committed segment by
        the returned ident.  ``stripe_threshold`` overrides the pusher's
        configured stripe cutover for one call — chain images are
        typically much larger than task args, so that path stripes
        earlier (``kv_stream_stripe_threshold``).

        Failure detection mirrors the pull side: attempts run under the
        zero-progress stall deadline and retry with backoff+jitter; a
        retry's fresh ``reserve_put`` is safe because the evicted
        reserving connection's close already triggered the server-side
        abort cleanup (the backoff gives it time to land) — the same
        cleanup that aborts a half-received chain when a prefill
        replica dies mid-stream.  Exhaustion raises NetTimeoutError —
        every caller already treats any push failure as "fall back to
        the legacy put_parts path"."""
        if not peer_accepts_puts(caps):
            raise PutUnsupportedError(
                f"peer {store_id} does not speak the put verbs")
        from ray_tpu_torch._private.shm_store import segment_layout

        meta = bytes(meta)
        table, offsets, total = segment_layout(meta, buffers)
        head = bytearray(_HEADER.size)
        _HEADER.pack_into(head, 0, _MAGIC, len(table))
        # Header and table as separate pieces: for a buffer-less value
        # the whole meta lives in the (multi-MB) table pickle, and
        # concatenating would copy it once more before streaming.
        pieces = [(0, memoryview(head)), (_HEADER.size, memoryview(table))]
        pieces += [(off, memoryview(b).cast("B"))
                   for off, b in zip(offsets, buffers)]
        return self._run_with_net_retries(
            lambda: self._push_attempt(store_id, addr, oid_bin, pieces,
                                       total, stripe=stripe_threshold),
            f"push of {oid_bin.hex()[:12]} to {store_id}")

    def _push_attempt(self, store_id: str, addr: str, oid_bin: bytes,
                      pieces, total: int, stripe: Optional[int] = None):
        pool = self._pool_for(store_id, addr)
        conn = pool.acquire()
        self._arm(conn)
        name = None
        boundary = True  # primary conn at a message boundary?
        try:
            protocol.send(conn, ("reserve_put", oid_bin, total))
            reply = protocol.recv(conn)
            if reply[0] != "ok":
                raise OSError(f"put refused by {store_id}: {reply!r}")
            name = reply[1]
            if stripe is None:
                stripe = self._stripe
            try:
                boundary = False
                if stripe > 0 and total > stripe:
                    self._push_striped(pool, conn, name, pieces, total,
                                       stripe)
                else:
                    _push_range(conn, name, pieces, 0, total)
                boundary = True
            except _StripeError:
                boundary = True  # helpers failed; primary drained clean
                raise
            protocol.send(conn, ("commit_put", name))
            reply = protocol.recv(conn)
            if reply[0] != "ok":
                raise OSError(f"put commit failed at {store_id}: "
                              f"{reply!r}")
            kind, ident, size = reply[1], reply[2], reply[3]
        except BaseException:
            # Best-effort explicit abort when the primary stream is at a
            # message boundary; otherwise evicting the (reserving)
            # connection makes the server's close-cleanup abort it.
            if name is not None and boundary:
                try:
                    protocol.send(conn, ("abort_put", name))
                    protocol.recv(conn)
                except Exception:
                    pass
            pool.evict(conn)
            raise
        self._disarm(conn)
        pool.release(conn)
        return kind, ident, size

    def _push_striped(self, pool: _ConnPool, conn, name: str, pieces,
                      total: int, stripe: int):
        """Concurrent byte-range stripes: this thread drains ranges on
        the primary connection; helpers drain on additional pooled
        connections (same shape as ObjectPuller._fetch_striped, pointed
        the other way)."""
        ranges = deque((off, min(stripe, total - off))
                       for off in range(0, total, stripe))
        errors: list = []

        def drain(c):
            while not errors:
                try:
                    off, length = ranges.popleft()
                except IndexError:
                    return
                _push_range(c, name, pieces, off, length)

        def helper():
            # A busy pool is not an error: give up quickly and let the
            # primary connection finish the remaining ranges.
            try:
                c = pool.acquire(timeout=0.25)
            except OSError:
                return
            if c is None:
                return
            self._arm(c)
            try:
                drain(c)
            except BaseException as e:  # noqa: BLE001 — joined below
                errors.append(e)
                pool.evict(c)
                return
            self._disarm(c)
            pool.release(c)

        helpers = [
            threading.Thread(target=helper, daemon=True,
                             name="rtpu-put-stripe")
            for _ in range(min(len(ranges) - 1, self._pool_size - 1))
        ]
        for t in helpers:
            t.start()
        try:
            drain(conn)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)  # helpers stop at their next range
            raise
        finally:
            for t in helpers:
                t.join()
        if errors:
            # Primary drained clean (or we'd have raised above): wrap so
            # the caller knows an explicit abort_put is safe.
            raise _StripeError() from errors[0]


_ZEROS = bytes(1 << 14)


def _push_range(conn, name: str, pieces, off: int, n: int):
    """One put_range exchange: header, exactly ``n`` payload bytes of
    the logical segment image in ≤CHUNK messages, ack."""
    protocol.send(conn, ("put_range", name, off, n))
    _send_piece_range(conn, pieces, off, n)
    reply = protocol.recv(conn)
    if reply[0] != "ok" or reply[1] != n:
        raise OSError(f"put_range [{off}, {off + n}) of {name} refused: "
                      f"{reply!r}")


def _send_piece_range(conn, pieces, off: int, n: int):
    """Stream bytes [off, off+n) of the logical segment image.
    ``pieces`` is a sorted list of (offset, memoryview); bytes covered
    by no piece (alignment gaps, table padding) are zeros."""
    end = off + n
    pos = off
    for poff, view in pieces:
        plen = len(view)
        if poff + plen <= pos:
            continue
        if poff >= end:
            break
        if poff > pos:
            _send_zeros(conn, poff - pos)
            pos = poff
        lo = pos - poff
        hi = min(plen, end - poff)
        for o in range(lo, hi, CHUNK):
            protocol.net_point("chunk_send", conn)
            conn.send_bytes(view[o:min(o + CHUNK, hi)])
        pos = poff + hi
        if pos >= end:
            break
    if pos < end:
        _send_zeros(conn, end - pos)


def _send_zeros(conn, n: int):
    while n > 0:
        m = min(n, len(_ZEROS))
        conn.send_bytes(_ZEROS if m == len(_ZEROS) else _ZEROS[:m])
        n -= m


def _recv_range(conn, view: memoryview, off: int, n: int):
    """Receive exactly ``n`` chunk messages' worth of bytes straight into
    ``view`` at ``off`` (one copy: socket -> destination buffer)."""
    got = 0
    while got < n:
        # Chaos syncpoint (one global None-check when unarmed): a
        # RAY_TPU_CHAOS rule can kill this process deterministically
        # mid-stream — the chaos battery's "die during a striped pull".
        recovery.syncpoint("pull_chunk")
        got += conn.recv_bytes_into(view, off + got)  # noqa: RTL403 -- zero-progress deadline armed by every caller (_PoolHost._arm / recv_parts) before the loop
    if got != n:
        raise OSError(
            f"object stream desync: got {got} bytes for a {n}-byte range")


def pull_to_segment(puller: ObjectPuller, store, store_id: str, addr: str,
                    name: str, caps: Tuple[str, ...] = ()):
    """Pull ``name`` from a remote object server straight into a local shm
    mapping and return it as a read ``Segment`` — the one-copy receive
    path (socket -> mmap; deserialization then builds zero-copy views over
    the mapping).  Uses ``ShmStore.reserve_recv``/``commit_recv``; the
    reservation is aborted on any failure.  When the store cannot host the
    reservation (capacity gate, tmpfs full), the receive degrades to a
    heap buffer — the transfer still completes one-copy, it just doesn't
    live in shm."""
    from ray_tpu_torch._private.shm_store import Segment

    state: dict = {}

    def sink(total: int):
        if state.get("reserved"):
            # A transport retry re-invokes the sink: release the failed
            # attempt's reservation before making a fresh one.
            try:
                store.abort_recv(state["buf"])
            except Exception:
                pass
        state["total"] = total
        try:
            buf = store.reserve_recv(name, total)
            state["reserved"] = True
        except (MemoryError, ValueError, OSError):
            buf = bytearray(total)
            state["reserved"] = False
        state["buf"] = buf
        return buf

    try:
        puller.fetch(store_id, addr, name, sink=sink, caps=caps)
    except BaseException:
        if state.get("reserved"):
            store.abort_recv(state["buf"])
        raise
    if state.get("reserved"):
        return store.commit_recv(name, state["buf"], state["total"])
    return Segment(name, "", state["total"], state["buf"])


class _PullEntry:
    """One in-flight (or retained prefetched) pull of a remote segment."""

    __slots__ = ("event", "seg", "failed", "prefetch", "size", "evicted",
                 "retained_at")

    def __init__(self, prefetch: bool):
        self.event = threading.Event()
        self.seg = None          # Segment once the pull completed
        self.failed = False
        self.prefetch = prefetch  # started by the prefetcher (not a task)
        self.size = 0
        self.evicted = False     # retention cap/TTL closed the segment
        self.retained_at = 0.0   # monotonic retain time (TTL sweep)

    def wait(self, timeout: Optional[float] = None):
        """The pulled Segment, or None when the leader's pull failed (the
        waiter then runs its own fallback path)."""
        if not self.event.wait(timeout):
            return None
        return None if self.failed else self.seg


class PullRegistry:
    """Per-process singleflight registry for remote-segment pulls.

    N concurrent materializations of the same remote segment (executing
    tasks + the argument prefetcher) share ONE pull: the first caller
    becomes the leader and streams the bytes; everyone else attaches to
    its entry and consumes the same received Segment (segments received
    via ``reserve_recv`` are process-private mappings, so sharing one
    read-only Segment between consumers in this process is safe).  A
    failed pull wakes every waiter with None — each then falls back to
    its own existing path (redial / head relay).

    Prefetched pulls are RETAINED (state DONE) until a task's
    ``_load_args`` consumes them or the retention cap evicts them
    (evictions count as ``prefetch_waste_bytes`` — bytes pulled for a
    task that never ran here, e.g. stolen back by the head).

    Reference: the raylet's local pull manager dedup — one
    ``ObjectManager::Pull`` per object regardless of how many queued
    tasks depend on it (pull_manager.h).

    LOCK ORDER (checked by tests/test_lockcheck.py): ``_lock`` is an
    INDEPENDENT LEAF — it guards only the entry dict and the counters,
    is never held across a dial, any stream I/O, or an event wait, and
    no other lock is ever acquired under it.
    """

    # Completed prefetched segments retained for consumption; past either
    # bound the oldest unconsumed one is evicted (counted as waste).  The
    # byte budget keeps a burst of large prefetched-then-stolen args from
    # pinning unbounded shm on the worker, and the TTL sweep (driven by
    # the worker's periodic flusher) reclaims stragglers whose task never
    # ran here even if no further prefetch ever fires.
    RETAIN_CAP = 32
    RETAIN_BYTES = 256 << 20
    RETAIN_TTL_S = 10.0

    def __init__(self):
        self._lock = threading.Lock()  # lock-order: leaf
        self._inflight: Dict[tuple, _PullEntry] = {}
        self._retained: "deque[tuple]" = deque()  # FIFO of DONE keys
        self._retained_bytes = 0
        self.deduped_pulls = 0       # waiters that shared a leader's pull
        self.prefetch_hit_bytes = 0  # prefetched bytes a task consumed
        self.prefetch_waste_bytes = 0  # prefetched bytes never consumed

    def begin(self, key: tuple,
              prefetch: bool = False) -> Tuple[_PullEntry, bool]:
        """Join or start the pull for ``key``; returns (entry, is_leader).

        A non-leader either waits on ``entry.wait()`` (pull in flight) or
        finds ``entry.event`` already set (a retained prefetched
        segment); task-path callers then :meth:`take` the entry to
        consume it."""
        with self._lock:
            ent = self._inflight.get(key)
            if ent is not None:
                if not ent.event.is_set() and not prefetch:
                    self.deduped_pulls += 1
                return ent, False
            ent = _PullEntry(prefetch)
            self._inflight[key] = ent
            return ent, True

    def take(self, key: tuple, ent: _PullEntry):
        """Consume a DONE entry's segment for task materialization (pops
        retained prefetches and credits the hit).  Returns None when the
        retention cap evicted (and closed) the segment between the
        caller's begin() and now — the caller re-pulls directly
        (_pull_remote_segment retries as a fresh leader)."""
        with self._lock:
            if ent.evicted:
                return None
            cur = self._inflight.get(key)
            if cur is ent and ent.event.is_set():
                self._inflight.pop(key, None)
                try:
                    self._retained.remove(key)
                    self._retained_bytes -= ent.size
                except ValueError:
                    pass
                if ent.prefetch and not ent.failed:
                    self.prefetch_hit_bytes += ent.size
        return None if ent.failed else ent.seg

    def finish(self, key: tuple, ent: _PullEntry, seg, *,
               retain: bool = False):
        """Leader completion: publish the result and wake waiters.  With
        ``retain`` (prefetch), a successful pull stays registered as DONE
        until consumed or evicted."""
        evicted = []
        with self._lock:
            ent.seg = seg
            ent.failed = seg is None
            if seg is not None:
                ent.size = getattr(seg, "size", 0)
            if retain and seg is not None:
                ent.retained_at = time.monotonic()
                self._retained.append(key)
                self._retained_bytes += ent.size
                while self._retained and (
                        len(self._retained) > self.RETAIN_CAP
                        or self._retained_bytes > self.RETAIN_BYTES):
                    old = self._retained.popleft()
                    old_ent = self._inflight.pop(old, None)
                    if old_ent is not None:
                        # Flagged under the lock; a concurrent take()
                        # checks it under the same lock, so nobody can
                        # receive the segment we close below.
                        old_ent.evicted = True
                        self._retained_bytes -= old_ent.size
                        self.prefetch_waste_bytes += old_ent.size
                        evicted.append(old_ent)
            else:
                self._inflight.pop(key, None)
        # Outside _lock (leaf discipline): Event.set acquires the event's
        # internal condition lock.  The result fields were published under
        # _lock above, so woken waiters read them consistently.
        ent.event.set()
        for old_ent in evicted:
            if old_ent.seg is not None:
                old_ent.seg.close()

    def sweep(self):
        """Evict retained prefetched segments older than RETAIN_TTL_S.
        Without this, a worker whose prefetched tasks were stolen back
        (and that never prefetches again) would pin up to RETAIN_BYTES of
        shm mappings until process exit — the FIFO eviction loop only
        runs on later retains.  Called from the worker's periodic
        flusher; retain order is FIFO, so the scan stops at the first
        young entry."""
        now = time.monotonic()
        evicted = []
        with self._lock:
            while self._retained:
                key = self._retained[0]
                ent = self._inflight.get(key)
                if ent is None:
                    self._retained.popleft()
                    continue
                if now - ent.retained_at < self.RETAIN_TTL_S:
                    break
                self._retained.popleft()
                self._inflight.pop(key, None)
                ent.evicted = True
                self._retained_bytes -= ent.size
                self.prefetch_waste_bytes += ent.size
                evicted.append(ent)
        for ent in evicted:
            if ent.seg is not None:
                ent.seg.close()

    def stats(self) -> dict:
        with self._lock:
            return {
                "deduped_pulls": self.deduped_pulls,
                "prefetch_hit_bytes": self.prefetch_hit_bytes,
                "prefetch_waste_bytes": self.prefetch_waste_bytes,
            }


def parse_segment_bytes(buf) -> Tuple[bytes, List[memoryview]]:
    """(payload_meta, buffer views) from raw segment bytes — the same
    layout Segment.raw_parts reads from an mmap (shm_store.py)."""
    view = memoryview(buf)
    magic, meta_len = _HEADER.unpack_from(view, 0)
    if magic != _MAGIC:
        raise ValueError("corrupt segment stream")
    table = bytes(view[_HEADER.size:_HEADER.size + meta_len])
    offsets, lengths, payload = serialization.loads_inline(table)
    buffers = [view[o:o + n] for o, n in zip(offsets, lengths)]
    return payload, buffers
