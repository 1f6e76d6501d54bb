"""Shared-memory object segments — the plasma-store equivalent.

The reference's plasma (``src/ray/object_manager/plasma/store.h``,
``dlmalloc.cc``) is a single mmap arena with a malloc inside, served over a
unix-socket protocol, one store per node, embedded in the raylet.  On a TPU
VM the picture is simpler: host RAM is big, objects are mostly numpy/jax
host arrays moving between one driver and a handful of worker processes on
the same host.  So v1 uses one POSIX shm file per object under ``/dev/shm``
— creation is O(1), cross-process attach is just open+mmap, and the kernel
does refcounting of the mapping for us.  The plasma-arena analog is the
segment pool below: freed-but-still-mapped segments are recycled so writes
go through already-faulted pages at memcpy speed.

Each segment:  [8B magic][8B meta_len][meta pickle][aligned buffers...]

Zero-copy property: consumers ``mmap`` the file and reconstruct numpy/jax
host arrays as views over the mapping — same guarantee plasma gives
(``plasma/client.cc`` Get returns mmap'd buffers).
"""

from __future__ import annotations

import bisect
import mmap
import os
import struct
import threading
from typing import Any, List, Optional, Tuple

from ray_tpu_torch._private import serialization
from ray_tpu_torch._private.ids import ObjectID

_MAGIC = b"RTPUOBJ1"
_HEADER = struct.Struct("<8sQ")  # magic, meta_len

# Large-buffer writes fan out across threads: numpy's copy releases the
# GIL, so a single put saturates memory bandwidth instead of one core's
# memcpy (the plasma store's parallel memcopy, store.cc memcopy_threads).
#
# LOCK ORDER (checked by tests/test_lockcheck.py via devtools.lockcheck):
# the module-level ``_copy_pool_lock`` and every store's ``_lock`` are
# INDEPENDENT LEAVES — no code path may hold one while acquiring the
# other.  Concretely: ``create_from_parts`` runs its copies (which may
# take ``_copy_pool_lock`` to build the pool) BEFORE taking ``_lock`` for
# accounting, and nothing under ``_lock`` ever copies buffer bytes.
# Breaking this would serialize every store's 8 GB/s parallel memcpy
# behind one global mutex — or deadlock against a second store.
_PARALLEL_COPY_MIN = 16 << 20
_COPY_THREADS = min(8, max(1, (os.cpu_count() or 1)))
_copy_pool = None
_copy_pool_lock = threading.Lock()  # lock-order: leaf


def _parallel_copy(mm: mmap.mmap, off: int, buf) -> None:
    global _copy_pool
    import numpy as np

    n = len(buf)
    cores = os.cpu_count() or 1
    if cores < 2:
        mm[off : off + n] = buf
        return
    if _copy_pool is None:
        from concurrent.futures import ThreadPoolExecutor

        with _copy_pool_lock:
            if _copy_pool is None:
                _copy_pool = ThreadPoolExecutor(
                    max_workers=_COPY_THREADS,
                    thread_name_prefix="rtpu-memcpy")
    dst = np.frombuffer(mm, dtype=np.uint8, count=n, offset=off)
    src = np.frombuffer(memoryview(buf).cast("B"), dtype=np.uint8)
    threads = min(_COPY_THREADS, cores)
    step = (n + threads - 1) // threads
    futs = [
        _copy_pool.submit(np.copyto, dst[i : i + step], src[i : i + step])
        for i in range(0, n, step)
    ]
    for f in futs:
        f.result()
    del dst


def _segment_path(shm_dir: str, name: str) -> str:
    return os.path.join(shm_dir, name)


def segment_layout(meta: bytes, buffers: List[memoryview]):
    """(table_pickle, buffer_offsets, total_size) for the on-disk segment
    layout: [header][table][aligned buffers...].  The table is pickled
    together with the payload meta so readers need one load.  Two-pass:
    compute offsets assuming a table pickle of the final length; table
    size varies with offsets' magnitude only slightly, so pad
    generously instead of iterating.  Module-level because the layout is
    a WIRE contract too: a remote pusher (object_transfer.ObjectPusher)
    computes the identical image so its byte-range stripes land at the
    offsets local readers expect."""
    sizes = [len(b) for b in buffers]
    probe = serialization.dumps_inline(([0] * len(sizes), sizes, meta))
    table_room = len(probe) + 256
    base = _HEADER.size + table_room
    offsets, total = serialization.aligned_offsets(sizes, base)
    table = serialization.dumps_inline((offsets, sizes, meta))
    if len(table) > table_room:
        # Offsets grew the pickle beyond the pad (pathological); redo
        # with exact room.
        table_room = len(table) + 256
        base = _HEADER.size + table_room
        offsets, total = serialization.aligned_offsets(sizes, base)
        table = serialization.dumps_inline((offsets, sizes, meta))
    return table, offsets, total


class Segment:
    """An open mapping of one shared object."""

    __slots__ = ("name", "path", "size", "_mm", "_closed")

    def __init__(self, name: str, path: str, size: int, mm: mmap.mmap):
        self.name = name
        self.path = path
        self.size = size
        self._mm = mm
        self._closed = False

    def deserialize(self) -> Any:
        magic, meta_len = _HEADER.unpack_from(self._mm, 0)
        if magic != _MAGIC:
            raise ValueError(f"Corrupt shm segment {self.name}")
        view = memoryview(self._mm)
        meta = bytes(view[_HEADER.size : _HEADER.size + meta_len])
        # Buffer table is pickled inside meta as (offset, length) pairs by
        # the writer; serialization.loads reconstructs via these views.
        table_and_meta = serialization.loads_inline(meta)
        offsets, lengths, payload = table_and_meta
        buffers = [view[o : o + l] for o, l in zip(offsets, lengths)]
        return serialization.loads(payload, buffers)

    def raw_parts(self):
        """(meta, buffer views) WITHOUT deserializing — the wire form for
        cross-node object transfer (the head ships these to another store's
        consumer; reference: object_manager.h:206 chunk push/pull)."""
        magic, meta_len = _HEADER.unpack_from(self._mm, 0)
        if magic != _MAGIC:
            raise ValueError(f"Corrupt shm segment {self.name}")
        view = memoryview(self._mm)
        table = bytes(view[_HEADER.size: _HEADER.size + meta_len])
        offsets, lengths, payload = serialization.loads_inline(table)
        buffers = [view[o: o + l] for o, l in zip(offsets, lengths)]
        return payload, buffers

    def close(self):
        # The deserialized value may hold views into the mapping; mmap.close
        # will fail with BufferError if so — let the GC of those arrays
        # release it instead.  AttributeError: heap-backed receive
        # fallbacks wrap a bytearray, which has nothing to close.
        if self._closed:
            return
        self._closed = True
        try:
            self._mm.close()
        except (BufferError, AttributeError):
            pass


class ShmStore:
    """Create/attach/unlink shared object segments on this node.

    Reference analog: plasma store + client
    (``src/ray/object_manager/plasma/store.h``, ``client.cc``).  Eviction is
    the owner's job here (ownership-based freeing), not an LRU inside the
    store — TPU training workloads want deterministic memory, not surprise
    eviction of a batch mid-step.
    """

    def __init__(self, shm_dir: str = "/dev/shm", capacity: int = 0,
                 session_id: str = "", pool_bytes: int = 0):
        self._dir = shm_dir if os.path.isdir(shm_dir) else "/tmp"
        self._capacity = capacity
        self._session = session_id or os.urandom(4).hex()
        self._lock = threading.Lock()  # lock-order: leaf
        self._used = 0
        # Per-NODE accounting: every process writing this directory under
        # a capacity shares one flock'd counter file, so the cap bounds
        # the node's aggregate usage, not each process's (the reference
        # has one plasma store process per node; we have N writers).
        self._acct_fd = None
        if capacity:
            acct = os.path.join(self._dir, f".rtpu-acct-{self._session}")
            try:
                self._acct_fd = os.open(acct, os.O_CREAT | os.O_RDWR,
                                        0o600)
            except OSError:
                self._acct_fd = None
        self._created: set[str] = set()
        # Segment pool: freed-but-still-mapped segments kept for reuse.
        # Fresh tmpfs pages cost a fault + zero-fill per 4K page (~1 GB/s on
        # a TPU VM); writing through an already-faulted mapping runs at
        # memcpy speed (~8 GB/s).  This is the moral equivalent of plasma's
        # single pre-mapped arena + dlmalloc (``plasma/dlmalloc.cc``):
        # allocate pages once, recycle them across objects.  Only segments
        # whose descriptor never left this process may be pooled (the
        # caller passes ``reusable=True``) — otherwise another process may
        # still hold zero-copy views over the old inode.
        self._pool_limit = pool_bytes
        self._pool_bytes = 0
        self._pool: List[Tuple[int, str, mmap.mmap]] = []  # sorted by size
        self._live_mm: dict = {}  # name -> (mmap, alloc_size), pool=True only

    def _acct(self, delta: int) -> int:
        """Atomically add ``delta`` to the node-shared usage counter;
        returns the new value.  Caller holds self._lock."""
        if self._acct_fd is None:
            return self._used
        import fcntl

        fcntl.flock(self._acct_fd, fcntl.LOCK_EX)
        try:
            os.lseek(self._acct_fd, 0, os.SEEK_SET)
            raw = os.read(self._acct_fd, 16)
            cur = int(raw.decode() or "0") if raw else 0
            cur = max(0, cur + delta)
            os.lseek(self._acct_fd, 0, os.SEEK_SET)
            os.ftruncate(self._acct_fd, 0)
            os.write(self._acct_fd, str(cur).encode())
            return cur
        finally:
            fcntl.flock(self._acct_fd, fcntl.LOCK_UN)

    def _node_used(self) -> int:
        if self._acct_fd is None:
            return self._used
        return self._acct(0)

    def segment_name(self, object_id: ObjectID) -> str:
        return f"rtpu-{self._session}-{object_id.hex()}"

    def create_from_parts(self, object_id: ObjectID, meta: bytes,
                          buffers: List[memoryview]) -> Tuple[str, int]:
        """Write pre-serialized (meta, out-of-band buffers) into a segment —
        the plasma create→write-in-place→seal path (``plasma/client.cc``):
        the caller serializes once and each buffer is memcpy'd exactly once,
        directly into shared memory."""
        table, offsets, total = self._layout(meta, buffers)
        name, mm, alloc = self._acquire_segment(object_id, total)
        _HEADER.pack_into(mm, 0, _MAGIC, len(table))
        mm[_HEADER.size : _HEADER.size + len(table)] = table
        for off, buf in zip(offsets, buffers):
            if len(buf) >= _PARALLEL_COPY_MIN:
                _parallel_copy(mm, off, buf)
            else:
                mm[off : off + len(buf)] = buf
        if self._pool_limit:
            # Keep the mapping open so a future reuse writes through
            # already-faulted pages; released in unlink()/cleanup().
            with self._lock:
                self._live_mm[name] = (mm, alloc)
        else:
            mm.close()
        with self._lock:
            self._used += alloc
            self._acct(alloc)
            self._created.add(name)
        return name, alloc

    def _layout(self, meta: bytes, buffers: List[memoryview]):
        return segment_layout(meta, buffers)

    def _acquire_segment(self, object_id: ObjectID, total: int):
        """A writable mapping of >= ``total`` bytes: pooled if one fits
        (within 2x waste), else a fresh shm file.  Fresh allocations evict
        pooled (free) segments first when that makes room under capacity."""
        evict = []
        new_name = self.segment_name(object_id)
        with self._lock:
            for i, (size, name, mm) in enumerate(self._pool):
                if size >= total:
                    if size <= 2 * total + (1 << 20):
                        self._pool.pop(i)
                        self._pool_bytes -= size
                        self._used -= size  # re-added by create_from_parts
                        self._acct(-size)
                        # Rename to the new object's canonical name: the
                        # mmap stays valid (it binds the inode, not the
                        # path) and the segment-name -> ObjectID invariant
                        # that lineage recovery parses stays true.
                        os.rename(_segment_path(self._dir, name),
                                  _segment_path(self._dir, new_name))
                        return new_name, mm, size
                    break  # sorted: everything later is even more wasteful
            if self._capacity:
                node_used = self._evict_pool_until_fits_locked(total,
                                                               evict)
                if node_used + total > self._capacity:
                    raise MemoryError(
                        f"Object store over capacity: need {total}, "
                        f"node used {node_used}/{self._capacity}")
        self._close_evicted(evict)
        name = self.segment_name(object_id)
        path = _segment_path(self._dir, name)
        fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_RDWR, 0o600)
        try:
            os.ftruncate(fd, total)
            mm = mmap.mmap(fd, total)
        finally:
            os.close(fd)
        return name, mm, total

    def _evict_pool_until_fits_locked(self, total: int,
                                      evict: list) -> int:
        """Pooled bytes are free memory: pop pool entries (appending
        them to ``evict``) until ``total`` fits under the node cap or
        the pool is empty; returns the final node usage.  The cap
        applies to the whole NODE's usage (shared flock'd counter), not
        this process's.  Caller holds ``self._lock`` and must pass
        ``evict`` to ``_close_evicted`` AFTER releasing it.  One
        implementation for every admission site (_acquire_segment,
        reserve_put) — the shared-counter policy must not diverge."""
        node_used = self._node_used()
        while node_used + total > self._capacity and self._pool:
            size, name, mm = self._pool.pop()
            self._pool_bytes -= size
            self._used -= size
            node_used = self._acct(-size)
            evict.append((name, mm))
        return node_used

    def _close_evicted(self, evict: list):
        for name, mm in evict:
            try:
                mm.close()
            except BufferError:
                pass
            try:
                os.unlink(_segment_path(self._dir, name))
            except OSError:
                pass

    # ------------------------------------------------- zero-copy receive --
    # The cross-node puller's destination buffers (object_transfer.
    # pull_to_segment): reserve a writable mapping up front, let the
    # network stack recv_bytes_into it at final offsets, then seal it as
    # a read Segment.  The backing file is unlinked the moment the
    # mapping exists (an mmap binds the inode, not the path), so a
    # received replica is private to this process, can never collide
    # with the canonical segment name, needs no free/eviction
    # bookkeeping, and cannot leak even if the process dies
    # mid-receive — the kernel reclaims the pages when the last view
    # over the mapping is dropped.

    def reserve_recv(self, name: str, total: int) -> mmap.mmap:
        """A writable ``total``-byte shm mapping for an incoming copy of
        segment ``name``.  Pair with ``commit_recv`` (success) or
        ``abort_recv`` (failure)."""
        if total <= 0:
            raise ValueError(f"cannot reserve {total}-byte segment {name}")
        if self._capacity:
            # Reservations are transient (freed when the consumer drops
            # the value) and deliberately NOT added to the node counter —
            # but a pull that clearly cannot fit must not sparsely
            # overcommit tmpfs and SIGBUS mid-receive.  Raising here
            # sends the caller to its heap-buffer fallback
            # (object_transfer.pull_to_segment), which keeps the store's
            # accounted capacity intact — the pre-reserve behavior.
            with self._lock:
                used = self._node_used()
            if used + total > self._capacity:
                raise MemoryError(
                    f"recv reservation over store capacity: need {total}, "
                    f"node used {used}/{self._capacity}")
        # basename: remote SPILLED descriptors name segments by absolute
        # path; the reservation always lives in THIS store's directory.
        path = _segment_path(
            self._dir,
            f"{os.path.basename(name)}.recv-{os.urandom(4).hex()}")
        fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_RDWR, 0o600)
        try:
            os.ftruncate(fd, total)
            mm = mmap.mmap(fd, total)
        finally:
            os.close(fd)
        try:
            os.unlink(path)
        except OSError:
            pass
        return mm

    def commit_recv(self, name: str, mm: mmap.mmap, total: int) -> Segment:
        """Seal a filled reservation as a read Segment (its buffers are
        zero-copy views over the received mapping)."""
        return Segment(name, "", total, mm)

    def abort_recv(self, mm: mmap.mmap):
        try:
            mm.close()
        except BufferError:
            pass

    # --------------------------------------------------- direct-put ingest --
    # The write-direction twin of reserve_recv: a remote pusher
    # (object_transfer verbs reserve_put/put_range/commit_put) streams a
    # value's byte-range stripes straight into a preallocated mapping —
    # but unlike a received replica, the destination is a PUBLIC named
    # segment other processes on this node will attach, so the file
    # stays linked, the bytes are capacity-accounted up front (admission
    # gates on the NODE counter, so concurrent pushers cannot overcommit
    # tmpfs), and an over-capacity reservation degrades to the spill
    # path (a disk-backed mapping under ``spill_dir``) instead of
    # raising — the reference's plasma CreateObject fallback queue.

    # Set by the embedding runtime/agent after construction; "" disables
    # the spill degradation (over-capacity reservations then raise).
    spill_dir: str = ""

    def reserve_put(self, oid_bin: bytes, total: int) -> "PutReservation":
        """A writable mapping for a pushed object, registered under the
        object's canonical public segment name.  Pair with the
        reservation's ``commit()`` (seal; file stays) or ``abort()``
        (unlink + accounting rollback)."""
        if total <= 0:
            raise ValueError(f"cannot reserve {total}-byte put")
        name = self.segment_name(ObjectID(oid_bin))
        evict = []
        over = False
        newly_tracked = False
        with self._lock:
            if self._capacity:
                node_used = self._evict_pool_until_fits_locked(total,
                                                               evict)
                over = node_used + total > self._capacity
            if not over:
                self._used += total
                self._acct(total)
                newly_tracked = name not in self._created
                self._created.add(name)
        self._close_evicted(evict)
        if over:
            if not self.spill_dir:
                raise MemoryError(
                    f"put reservation over store capacity: need {total} "
                    f"(capacity {self._capacity}) and no spill_dir")
            os.makedirs(self.spill_dir, exist_ok=True)
            path = os.path.join(self.spill_dir, name)
            mm = self._map_new_file(path, total)
            return PutReservation(self, "spilled", name, path, total, mm)
        path = _segment_path(self._dir, name)
        try:
            mm = self._map_new_file(path, total)
        except BaseException:
            with self._lock:
                # Roll back only what THIS call added: on an EEXIST
                # collision the _created entry belongs to the existing
                # segment, not to us.
                if newly_tracked:
                    self._created.discard(name)
                self._used -= total
                self._acct(-total)
            raise
        return PutReservation(self, "shm", name, name, total, mm)

    @staticmethod
    def _map_new_file(path: str, total: int) -> mmap.mmap:
        fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_RDWR, 0o600)
        try:
            os.ftruncate(fd, total)
            return mmap.mmap(fd, total)
        finally:
            os.close(fd)

    def _finish_put(self, res: "PutReservation", commit: bool):
        try:
            res.mm.close()
        except BufferError:
            pass  # a straggling writer's view; the GC releases it
        if commit:
            return
        try:
            os.unlink(res.ident if res.kind == "spilled"
                      else _segment_path(self._dir, res.name))
        except OSError:
            pass
        if res.kind == "shm":
            with self._lock:
                self._created.discard(res.name)
                self._used -= res.total
                self._acct(-res.total)

    def attach(self, name: str) -> Segment:
        return self.attach_path(_segment_path(self._dir, name))

    def attach_path(self, path: str) -> Segment:
        """Map a segment by absolute path — shm or a spill file (restore
        path; reference: local_object_manager.h:41 restore-from-external).
        The on-disk layout is identical, so readers cannot tell spilled
        objects from resident ones."""
        fd = os.open(path, os.O_RDONLY)
        try:
            size = os.fstat(fd).st_size
            mm = mmap.mmap(fd, size, prot=mmap.PROT_READ)
        finally:
            os.close(fd)
        return Segment(os.path.basename(path), path, size, mm)

    def spill(self, name: str, size: int, spill_dir: str) -> str:
        """Copy a resident segment to ``spill_dir`` and free its shm pages
        (reference: LocalObjectManager::SpillObjects,
        local_object_manager.h:41).  Copy (not rename): /dev/shm -> disk is
        cross-device, and the point is releasing tmpfs RAM."""
        import shutil

        os.makedirs(spill_dir, exist_ok=True)
        src = _segment_path(self._dir, name)
        dst = os.path.join(spill_dir, name)
        with open(src, "rb") as f, open(dst, "wb") as g:
            shutil.copyfileobj(f, g, 1 << 20)
        self.unlink(name, size)
        return dst

    def create_spilled(self, object_id: ObjectID, meta: bytes,
                       buffers: List[memoryview],
                       spill_dir: str) -> Tuple[str, int]:
        """Serialize directly to a spill file, bypassing shm entirely — the
        over-capacity path when nothing (enough) can be evicted."""
        os.makedirs(spill_dir, exist_ok=True)
        table, offsets, total = self._layout(meta, buffers)
        path = os.path.join(spill_dir, self.segment_name(object_id))
        with open(path, "wb") as f:
            mm_bytes = bytearray(_HEADER.size)
            _HEADER.pack_into(mm_bytes, 0, _MAGIC, len(table))
            f.write(mm_bytes)
            f.write(table)
            pos = _HEADER.size + len(table)
            for off, buf in zip(offsets, buffers):
                if off > pos:
                    f.write(b"\x00" * (off - pos))
                f.write(buf)
                pos = off + len(buf)
        return path, total

    def unlink(self, name: str, size: int = 0, reusable: bool = False):
        """Free a segment.  ``reusable=True`` (caller guarantees no other
        process ever saw this segment's descriptor) pools the still-open
        mapping for in-place reuse instead of returning pages to the kernel.
        """
        with self._lock:
            entry = self._live_mm.pop(name, None)
            if (reusable and entry is not None
                    and self._pool_bytes + entry[1] <= self._pool_limit):
                mm, alloc = entry
                bisect.insort(self._pool, (alloc, name, mm),
                              key=lambda t: t[0])
                self._pool_bytes += alloc
                self._created.discard(name)
                return
        if entry is not None:
            try:
                entry[0].close()
            except BufferError:
                pass
        path = _segment_path(self._dir, name)
        removed = False
        try:
            os.unlink(path)
            removed = True
        except FileNotFoundError:
            pass
        with self._lock:
            if name in self._created:
                self._created.discard(name)
                self._used -= size
                self._acct(-size)
            elif removed and size:
                # Another process created this segment (owner-routed
                # free): its bytes leave the node-shared count here.
                self._acct(-size)

    def cleanup(self):
        """Unlink everything this process created (driver shutdown path)."""
        with self._lock:
            names = list(self._created)
            names += [name for _, name, _ in self._pool]
            mms = [mm for mm, _ in self._live_mm.values()]
            mms += [mm for _, _, mm in self._pool]
            self._created.clear()
            self._live_mm.clear()
            self._pool.clear()
            self._pool_bytes = 0
            self._used = 0
        for mm in mms:
            try:
                mm.close()
            except BufferError:
                pass
        for name in names:
            try:
                os.unlink(_segment_path(self._dir, name))
            except OSError:
                pass
        if self._acct_fd is not None:
            try:
                os.close(self._acct_fd)
                os.unlink(os.path.join(self._dir,
                                       f".rtpu-acct-{self._session}"))
            except OSError:
                pass
            self._acct_fd = None


class PutReservation:
    """One pending direct-put destination: a writable public mapping the
    object server's ``put_range`` stripes recv straight into.

    ``kind`` is ``"shm"`` (``ident`` == segment name) or ``"spilled"``
    (``ident`` == absolute spill-file path — the over-capacity
    degradation).  ``writers``/``dead`` belong to the object server's
    put registry (guarded by ITS lock): concurrent stripe connections
    ref-count in-flight writes so an abort never closes the mapping
    under an active ``recv_bytes_into``."""

    __slots__ = ("store", "kind", "name", "ident", "total", "mm",
                 "writers", "dead")

    def __init__(self, store: ShmStore, kind: str, name: str, ident: str,
                 total: int, mm: mmap.mmap):
        self.store = store
        self.kind = kind
        self.name = name
        self.ident = ident
        self.total = total
        self.mm = mm
        self.writers = 0
        self.dead = False

    def commit(self):
        """Seal: close the writable mapping; the (linked, accounted)
        file becomes attachable like any locally-created segment."""
        self.store._finish_put(self, commit=True)

    def abort(self):
        """Tear down: close + unlink + restore store accounting."""
        self.store._finish_put(self, commit=False)


def put_local(store: ShmStore, oid_bin: bytes, meta: bytes,
              buffers: List[memoryview]):
    """Write a full segment image into THIS node's store through the
    same reserve/commit admission the remote put verbs use — the local
    short-circuit of ``ObjectPusher.push`` (a shuffle map task whose
    reducer lives on its own node must not dial itself).  Inherits
    reserve_put's over-capacity degradation, so the return mirrors the
    pusher's: ``(kind, ident, total)`` with kind ``"shm"`` or
    ``"spilled"``."""
    table, offsets, total = segment_layout(meta, buffers)
    res = store.reserve_put(oid_bin, total)
    try:
        mm = res.mm
        _HEADER.pack_into(mm, 0, _MAGIC, len(table))
        mm[_HEADER.size: _HEADER.size + len(table)] = table
        for off, buf in zip(offsets, buffers):
            if len(buf) >= _PARALLEL_COPY_MIN:
                _parallel_copy(mm, off, buf)
            else:
                mm[off: off + len(buf)] = buf
    except BaseException:
        res.abort()
        raise
    res.commit()
    return res.kind, res.ident, total
