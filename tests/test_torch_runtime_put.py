"""The non-slow cases of ``tests/test_put_path.py``, run unchanged
against the port's copy of the runtime (its ``_private`` modules and
``import ray_tpu_torch as ray``).  The slow 4x64 MB speed A/B
(``test_four_concurrent_puts_2x_over_legacy_baseline``) is not copied.

Put-path parity: striped zero-copy writes, direct-to-store ingest,
and the head's control plane out of the put payload path.

Reference analog: the plasma store takes writes through
``CreateObject``/``Seal`` on a dedicated store socket
(``src/ray/object_manager/plasma/store.h``) — never through a GCS RPC.
Here a client/worker put of a value destined for another store reserves
the destination mapping (``reserve_put``), streams concurrent byte-range
stripes straight into it (``put_range``; socket -> mmap, one copy),
seals it (``commit_put``) and sends the head only an O(1)
``("put_commit", ...)`` control message.

Covered here:
- striped push reassembly is byte-identical across randomized sizes
  around the stripe threshold (the destination segment deserializes to
  the original value);
- old-verb peer interop: a pusher never engages (no wire traffic at
  all) against a peer that does not advertise the put verbs — the
  caller keeps the legacy ``put_parts`` path;
- failure hygiene: a pusher dying between ``reserve_put`` and
  ``commit_put`` triggers the abort cleanup (no leaked reservation,
  store accounting restored); a mid-push connection death evicts ONLY
  the broken pooled connection and a retry on the same pool succeeds;
- spill-aware admission: an over-capacity reservation degrades to the
  spill path instead of overcommitting tmpfs;
- the acceptance micro: 4 concurrent large puts over a paced
  (latency-bound) link complete ≥2x faster striped/pooled than the
  legacy whole-value-through-one-control-message baseline;
- cluster: one large client put produces O(1) control-plane messages at
  the head (exactly one ``put_commit``, zero ``put_parts``) with
  ``direct_puts``/``direct_put_bytes`` counted; ``direct_puts=off``
  reproduces the legacy path with every new counter zero, and the knobs
  follow ``_system_config`` into spawned workers;
- the concurrent multi-client put battery re-run under the lockcheck
  instrumentation with zero lock-order cycles.
"""

import os
import random
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import pytest

from multiprocessing.connection import Client, Listener

from ray_tpu_torch._private import object_transfer as ot
from ray_tpu_torch._private import protocol, serialization
from ray_tpu_torch._private.ids import ObjectID
from ray_tpu_torch._private.shm_store import ShmStore

AUTH = b"put-path-test"


# --------------------------------------------------------------- helpers --

class _Server:
    """A loopback object server over a real store, with optional
    per-connection wrapping (pacing, chaos)."""

    def __init__(self, store, wrap=None, serve=ot.serve_connection):
        self.store = store
        self._wrap = wrap or (lambda conn: conn)
        self._serve = serve
        self._listener = Listener(("127.0.0.1", 0), "AF_INET",
                                  backlog=16, authkey=AUTH)
        self.addr = f"tcp://127.0.0.1:{self._listener.address[1]}"
        self.port = self._listener.address[1]
        self._stopped = False
        threading.Thread(target=self._accept, daemon=True).start()

    def _accept(self):
        while not self._stopped:
            try:
                conn = self._listener.accept()
            except Exception:
                return
            threading.Thread(target=self._serve,
                             args=(self._wrap(conn), self.store),
                             daemon=True).start()

    def close(self):
        self._stopped = True
        try:
            self._listener.close()
        except Exception:
            pass


@pytest.fixture
def shm_store():
    d = tempfile.mkdtemp(prefix="rtpu-put-", dir="/dev/shm"
                         if os.path.isdir("/dev/shm") else None)
    store = ShmStore(shm_dir=d, session_id="puttest")
    yield store
    import shutil

    store.cleanup()
    shutil.rmtree(d, ignore_errors=True)


def _parts_of(payload: bytes):
    res = serialization.dumps_adaptive(
        np.frombuffer(payload, dtype=np.uint8), 0)
    assert res[0] == "parts"
    return res[1], res[2]


def _push_value(pusher, server, payload: bytes, caps=ot.CAPS):
    meta, views = _parts_of(payload)
    oid = ObjectID.for_put()
    return pusher.push("peer", server.addr, oid.binary(), meta, views,
                       caps=caps)


def _read_back(store: ShmStore, kind: str, ident: str) -> bytes:
    seg = (store.attach_path(ident) if kind == "spilled"
           else store.attach(ident))
    try:
        return bytes(seg.deserialize().tobytes())
    finally:
        seg.close()


# ------------------------------------------------- striped reassembly ----

def test_striped_put_reassembles_byte_identical(shm_store):
    """Randomized sizes around the stripe threshold: the pushed segment
    must deserialize to the original value whether it streamed whole or
    as concurrent byte-range stripes."""
    thr = 256 * 1024
    rng = random.Random(7)
    sizes = [1, thr // 2, thr - 64, thr - 1, thr, thr + 1, thr + 177,
             2 * thr, 3 * thr + rng.randrange(thr)]
    server = _Server(shm_store)
    striped = ot.ObjectPusher(AUTH, pool_size=4, stripe_threshold=thr)
    whole = ot.ObjectPusher(AUTH, pool_size=4, stripe_threshold=0)
    try:
        for n in sizes:
            payload = rng.randbytes(n)
            for pusher in (striped, whole):
                kind, ident, total = _push_value(pusher, server, payload)
                assert kind == "shm"
                assert _read_back(shm_store, kind, ident) == payload, n
                shm_store.unlink(ident, total)
    finally:
        striped.close()
        whole.close()
        server.close()


def test_meta_only_value_pushes(shm_store):
    """A big pickle with no out-of-band buffers (pure meta) still pushes
    and round-trips."""
    value = {"k": "v" * (2 << 20)}
    res = serialization.dumps_adaptive(value, 1024)
    assert res[0] == "parts" and res[2] == []
    server = _Server(shm_store)
    pusher = ot.ObjectPusher(AUTH, pool_size=2,
                             stripe_threshold=512 * 1024)
    try:
        kind, ident, _total = pusher.push(
            "peer", server.addr, ObjectID.for_put().binary(), res[1],
            res[2], caps=ot.CAPS)
        seg = shm_store.attach(ident)
        try:
            assert seg.deserialize() == value
        finally:
            seg.close()
    finally:
        pusher.close()
        server.close()


# ------------------------------------------------- old-verb peer interop --

def _old_serve_connection(conn, store):
    """The pre-put object server, verbatim: speaks ONLY fetch/close and
    records anything else (which is why the put verbs must be gated on
    advertised caps, never probed)."""
    unknown = getattr(store, "_unknown_verbs", None)
    try:
        while True:
            msg = protocol.recv(conn)
            if msg[0] == "fetch":
                try:
                    seg = store.attach(msg[1])
                except Exception as e:  # noqa: BLE001
                    protocol.send(conn, ("err", repr(e)))
                    continue
                try:
                    mv = memoryview(seg._mm)
                    protocol.send(conn, ("ok", len(mv)))
                    for off in range(0, len(mv), ot.CHUNK):
                        conn.send_bytes(mv[off:off + ot.CHUNK])
                finally:
                    del mv
                    seg.close()
            elif msg[0] == "close":
                return
            elif unknown is not None:
                unknown.append(msg[0])
    except (EOFError, OSError, TypeError):
        return
    finally:
        try:
            conn.close()
        except Exception:
            pass


def test_old_verb_peer_never_sees_put_verbs(shm_store):
    """Against a peer whose advertised caps lack the put verbs, the
    pusher refuses WITHOUT any wire traffic (the caller then keeps the
    legacy ``put_parts`` control-plane path) — and partial caps do not
    slip through the gate either."""
    shm_store._unknown_verbs = []
    server = _Server(shm_store, serve=_old_serve_connection)
    pusher = ot.ObjectPusher(AUTH, pool_size=2, stripe_threshold=0)
    payload = random.Random(3).randbytes(64 * 1024)
    try:
        for caps in ((), ("fetch_range",), ("reserve_put",),
                     ("reserve_put", "put_range", "commit_put")):
            with pytest.raises(ot.PutUnsupportedError):
                _push_value(pusher, server, payload, caps=caps)
        assert not pusher._pools, "refused push still dialed the peer"
        assert shm_store._unknown_verbs == []
        assert ot.peer_accepts_puts(ot.CAPS)
    finally:
        pusher.close()
        server.close()


# ------------------------------------------ failure hygiene / admission --

def test_reservation_aborted_when_pusher_dies(shm_store):
    """A reservation whose connection closes before commit_put is torn
    down by the server: no leaked segment file, accounting restored."""
    server = _Server(shm_store)
    used0 = shm_store._used
    conn = Client(("127.0.0.1", server.port), authkey=AUTH)
    try:
        protocol.send(conn, ("reserve_put", ObjectID.for_put().binary(),
                             1 << 20))
        reply = protocol.recv(conn)
        assert reply[0] == "ok"
        name = reply[1]
        path = os.path.join(shm_store._dir, name)
        assert os.path.exists(path)
        assert shm_store._used == used0 + (1 << 20)
    finally:
        conn.close()  # pusher "dies" between reserve and commit
    deadline = time.monotonic() + 10
    # The server unlinks the file, then rolls the accounting back: wait
    # for both (checked one after the other, the second could be caught
    # between the two steps).
    while (os.path.exists(path) or shm_store._used != used0) and \
            time.monotonic() < deadline:
        time.sleep(0.02)
    assert not os.path.exists(path), "reservation segment leaked"
    assert shm_store._used == used0, "store accounting not restored"
    server.close()


def test_explicit_abort_put_cleans_up(shm_store):
    server = _Server(shm_store)
    used0 = shm_store._used
    conn = Client(("127.0.0.1", server.port), authkey=AUTH)
    try:
        protocol.send(conn, ("reserve_put", ObjectID.for_put().binary(),
                             1 << 20))
        reply = protocol.recv(conn)
        assert reply[0] == "ok"
        name = reply[1]
        protocol.send(conn, ("abort_put", name))
        assert protocol.recv(conn) == ("ok",)
        assert not os.path.exists(os.path.join(shm_store._dir, name))
        assert shm_store._used == used0
        # Stripes/commits for the aborted put are refused in sync (the
        # payload is drained, the connection stays usable).
        protocol.send(conn, ("put_range", name, 0, ot.CHUNK))
        conn.send_bytes(b"\0" * ot.CHUNK)
        assert protocol.recv(conn)[0] == "err"
        protocol.send(conn, ("commit_put", name))
        assert protocol.recv(conn)[0] == "err"
        # ...and a fresh reserve on the SAME connection still works.
        protocol.send(conn, ("reserve_put", ObjectID.for_put().binary(),
                             4096))
        assert protocol.recv(conn)[0] == "ok"
    finally:
        conn.close()
    server.close()


class _DieOnNthRecv:
    """Kills the server side of a connection on the Nth payload recv —
    the pusher observes a mid-stripe transport failure."""

    def __init__(self, conn, owner):
        self._conn = conn
        self._owner = owner

    def recv_bytes_into(self, *a, **kw):
        if self._owner["fuse"] > 0:
            self._owner["fuse"] -= 1
            if self._owner["fuse"] == 0:
                self._conn.close()
                raise OSError("injected mid-put death")
        return self._conn.recv_bytes_into(*a, **kw)  # noqa: RTL403 -- fault-injection wrapper delegating to the real conn

    def __getattr__(self, item):
        return getattr(self._conn, item)


def test_mid_push_death_evicts_only_broken_conn_and_recovers(shm_store):
    """A connection dying mid-push fails that push, evicts ONLY the
    broken pooled connection, aborts the reservation (server cleanup),
    and a retry on the same pool redials and succeeds."""
    owner = {"fuse": 2}
    server = _Server(shm_store, wrap=lambda c: _DieOnNthRecv(c, owner))
    pusher = ot.ObjectPusher(AUTH, pool_size=2, stripe_threshold=0)
    payload = random.Random(5).randbytes(3 << 20)
    used0 = shm_store._used
    try:
        with pytest.raises((OSError, EOFError)):
            _push_value(pusher, server, payload)
        pool = pusher._pools["peer"]
        assert pool.total == 0, "broken connection not evicted"
        # Reservation cleanup restores accounting (async on conn close).
        deadline = time.monotonic() + 10
        while shm_store._used != used0 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert shm_store._used == used0
        kind, ident, total = _push_value(pusher, server, payload)
        assert _read_back(shm_store, kind, ident) == payload
    finally:
        pusher.close()
        server.close()


def test_over_capacity_reservation_degrades_to_spill(tmp_path):
    """Admission gates on node capacity: a reservation that cannot fit
    degrades to a spill-file destination (readable via attach_path, like
    any spilled segment) instead of overcommitting tmpfs — and with no
    spill_dir configured it refuses outright."""
    d = tempfile.mkdtemp(prefix="rtpu-putcap-", dir="/dev/shm"
                         if os.path.isdir("/dev/shm") else None)
    store = ShmStore(shm_dir=d, session_id="putcap", capacity=256 * 1024)
    store.spill_dir = str(tmp_path / "spill")
    server = _Server(store)
    pusher = ot.ObjectPusher(AUTH, pool_size=2, stripe_threshold=0)
    payload = random.Random(9).randbytes(1 << 20)
    try:
        meta, views = _parts_of(payload)
        kind, ident, total = pusher.push(
            "peer", server.addr, ObjectID.for_put().binary(), meta,
            views, caps=ot.CAPS)
        assert kind == "spilled"
        assert ident.startswith(str(tmp_path / "spill"))
        assert _read_back(store, kind, ident) == payload
        assert store._used == 0  # spill bytes are not tmpfs-accounted
        store.spill_dir = ""
        with pytest.raises(OSError):
            _push_value(pusher, server, payload)
    finally:
        pusher.close()
        server.close()
        store.cleanup()
        import shutil

        shutil.rmtree(d, ignore_errors=True)


def test_put_parts_fallback_clears_stale_direct_push_remnant():
    """A failed direct push can strand the oid's canonical segment (the
    server committed but the ack was lost); the put_parts FALLBACK for
    the same oid must clear the remnant and assemble cleanly instead of
    colliding on O_EXCL or double-counting the bytes."""
    import ray_tpu_torch as ray
    from ray_tpu_torch._private import api_internal

    ray.init(num_cpus=1)
    try:
        rt = api_internal.get_runtime()
        oid = ObjectID.for_put()
        payload = random.Random(21).randbytes(2 << 20)
        meta, views = _parts_of(payload)
        # Simulate the remnant: a committed direct-push reservation for
        # this oid whose commit ack the client never saw.
        res = rt.shm.reserve_put(oid.binary(), 4 << 20)
        memoryview(res.mm)[:8] = b"garbage!"
        res.commit()
        used_with_remnant = rt.shm._used
        descr = rt._store_parts_locally(oid, bytes(meta),
                                        [bytes(v) for v in views])
        assert descr[0] == protocol.SHM
        seg = rt.shm.attach(descr[1])
        try:
            assert bytes(seg.deserialize().tobytes()) == payload
        finally:
            seg.close()
        # The remnant's 4 MB left the accounting; only the fresh
        # segment's bytes remain on top of the pre-remnant base.
        assert rt.shm._used <= used_with_remnant - (4 << 20) + descr[2]
    finally:
        ray.shutdown()


# --------------------------------------------- lockcheck on concurrency --

def test_concurrent_multi_client_puts_lockcheck_clean(shm_store):
    """The multi-client put battery under the RAY_TPU_LOCKCHECK
    instrumentation: concurrent striped pushes from several pushers into
    one destination must record zero lock-order cycles."""
    from ray_tpu_torch.devtools import lockcheck

    lockcheck.install(raise_on_cycle=False)
    lockcheck.clear()
    try:
        server = _Server(shm_store)
        rng = random.Random(13)
        payloads = [rng.randbytes(700 * 1024) for _ in range(3)]
        pushers = [ot.ObjectPusher(AUTH, pool_size=3,
                                   stripe_threshold=128 * 1024)
                   for _ in range(3)]
        results = {}

        def push(i):
            kind, ident, _total = _push_value(pushers[i], server,
                                              payloads[i])
            results[i] = _read_back(shm_store, kind, ident)

        threads = [threading.Thread(target=push, args=(i,))
                   for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert [results[i] for i in range(3)] == payloads
        for p in pushers:
            p.close()
        server.close()
        assert lockcheck.violations() == [], lockcheck.violations()
        lockcheck.assert_acyclic()
    finally:
        lockcheck.uninstall()


# --------------------------------------------- cluster: O(1) control plane --

def _client_env(rt):
    env = dict(os.environ)
    env["RAY_TPU_CLIENT_ADDRESS"] = rt.tcp_address
    env["RAY_TPU_CLIENT_AUTHKEY"] = rt._authkey.hex()
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = (os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))) + os.pathsep
        + env.get("PYTHONPATH", ""))
    return env


_CLIENT_PUT_SCRIPT = """
import numpy as np
import ray_tpu_torch as ray
ray.init()
big = np.arange(3_000_000, dtype=np.int64)  # 24 MB

@ray.remote
def total(a):
    return int(a.sum())

ref = ray.put(big)
assert ray.get(total.remote(ref), timeout=90) == int(big.sum())
assert int(ray.get(ref, timeout=90).sum()) == int(big.sum())
ray.shutdown()
print("CLIENT_PUT_OK")
"""


def test_one_direct_put_is_o1_control_messages():
    """One large client put reaches the head as exactly ONE control-
    plane message (the put_commit) — zero put_parts — with the payload
    counted in direct_puts/direct_put_bytes and the legacy fallback
    counter flat.  A worker still consumes the pushed segment."""
    import ray_tpu_torch as ray
    from ray_tpu_torch._private import api_internal

    ray.init(num_cpus=2)
    try:
        rt = api_internal.get_runtime()
        p = subprocess.run([sys.executable, "-c", _CLIENT_PUT_SCRIPT],
                           env=_client_env(rt), capture_output=True,
                           text=True, timeout=180)
        assert p.returncode == 0, p.stderr[-3000:]
        assert "CLIENT_PUT_OK" in p.stdout
        stats = rt.transfer_stats()
        assert stats["direct_puts"] == 1, stats
        assert stats["direct_put_bytes"] >= 24_000_000, stats
        assert stats["brokered_put_parts"] == 0, stats
        with rt._handler_stats_lock:
            counts = {tag: s[0] for tag, s in rt._handler_stats.items()}
        assert counts.get("put_commit", 0) == 1, counts
        assert counts.get("put_parts", 0) == 0, counts
    finally:
        ray.shutdown()


def test_direct_puts_off_restores_legacy_with_zero_counters():
    """Master switch off: the client put rides the legacy put_parts
    path (the head never advertises the put verbs, so the client never
    sends one), completes, and EVERY new counter stays zero.  The knobs
    follow _system_config into spawned workers via the env namespace."""
    import ray_tpu_torch as ray
    from ray_tpu_torch._private import api_internal

    ray.init(num_cpus=2, _system_config={
        "direct_puts": False,
        "object_put_stripe_threshold": 12345,
        "object_put_pool_size": 7,
    })
    try:
        rt = api_internal.get_runtime()

        @ray.remote
        def probe():
            import os

            return (os.environ.get("RAY_TPU_DIRECT_PUTS"),
                    os.environ.get("RAY_TPU_OBJECT_PUT_STRIPE_THRESHOLD"),
                    os.environ.get("RAY_TPU_OBJECT_PUT_POOL_SIZE"))

        assert ray.get(probe.remote(), timeout=60) == \
            ("0", "12345", "7")
        p = subprocess.run([sys.executable, "-c", _CLIENT_PUT_SCRIPT],
                           env=_client_env(rt), capture_output=True,
                           text=True, timeout=180)
        assert p.returncode == 0, p.stderr[-3000:]
        assert "CLIENT_PUT_OK" in p.stdout
        stats = rt.transfer_stats()
        assert stats["direct_puts"] == 0, stats
        assert stats["direct_put_bytes"] == 0, stats
        assert stats["brokered_put_parts"] == 0, stats
        with rt._handler_stats_lock:
            counts = {tag: s[0] for tag, s in rt._handler_stats.items()}
        assert counts.get("put_parts", 0) >= 1, counts
        assert counts.get("put_commit", 0) == 0, counts
    finally:
        ray.shutdown()


def test_small_put_coalescing_one_write_per_burst():
    """Many tiny client puts ride out as few ("batch", ...) frames (one
    pickle+write per burst) instead of one frame per put — message
    ORDER (put before its addref, both before any decref) preserved."""
    from multiprocessing.connection import Pipe

    from ray_tpu_torch._private import object_ref as object_ref_mod
    from ray_tpu_torch._private.client import ClientRuntime

    here, there = Pipe()
    d = tempfile.mkdtemp(prefix="rtpu-coal-")
    rt = ClientRuntime(there, threading.Lock(), ShmStore(shm_dir=d),
                       1024 * 1024)
    old_accessor = object_ref_mod._runtime_accessor
    object_ref_mod._set_runtime_accessor(lambda: rt)
    try:
        refs = [rt.put_object(i) for i in range(20)]
        rt.flush_puts()
        frames = []
        while here.poll(0.1):
            frames.append(serialization.loads_inline(here.recv_bytes()))
        assert len(frames) <= 3, f"{len(frames)} writes for 20 tiny puts"
        msgs = []
        for f in frames:
            msgs.extend(f[1] if protocol.is_batch(f) else [f])
        puts = [m for m in msgs if m[0] == "put"]
        addrefs = [m for m in msgs if m[0] == "addref"]
        assert len(puts) == 20 and len(addrefs) == 20
        for i, ref in enumerate(refs):
            put_at = next(j for j, m in enumerate(msgs)
                          if m[0] == "put" and m[1] == ref.id().binary())
            add_at = next(j for j, m in enumerate(msgs)
                          if m[0] == "addref"
                          and m[1] == ref.id().binary())
            assert put_at < add_at, "addref overtook its put"
    finally:
        # Drop the refs while the accessor still routes to THIS client
        # runtime (their __del__ decrefs land in its buffer, never
        # sent), then restore.
        refs = None
        object_ref_mod._set_runtime_accessor(old_accessor)
        import shutil

        shutil.rmtree(d, ignore_errors=True)
        here.close()
        there.close()
