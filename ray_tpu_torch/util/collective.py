"""Host-level collectives between actors (ray.util.collective equivalent).

Reference: ``python/ray/util/collective/collective.py`` —
``init_collective_group`` (:120), declarative ``create_collective_group``
(:151), ``allreduce/allgather/reducescatter/broadcast/send/recv``
(:258,423,472,373,531,594) over NCCL/Gloo groups.

TPU split (SURVEY.md §2.3): *device* collectives are XLA (``jax.lax.p*``
under jit over the mesh — see ray_tpu_torch.parallel), so this module only covers
the *host* tier the reference used Gloo for: numpy buffers between actor
processes, rendezvoused through a named coordinator actor (threaded, so
blocking barriers work).  That is the DCN-control-plane analog — checkpoint
shards, rollout aggregation, eval gathers; never the gradient hot path.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

import numpy as np

import ray_tpu_torch as ray

_GROUP_PREFIX = "collective_group:"
# Process-scoped (NOT thread-local): in an actor with max_concurrency > 1,
# method calls are serviced by different pool threads, so a group inited on
# one thread must be visible to collective ops handled by another.
_groups_lock = threading.Lock()
_GROUPS: Dict[str, "_GroupState"] = {}


@ray.remote
class _Coordinator:
    """Rendezvous + reduction point for one group.  max_concurrency lets all
    ranks block inside contribute() simultaneously."""

    def __init__(self, world_size: int):
        self.world_size = world_size
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._rounds: Dict[tuple, Dict[int, Any]] = {}
        self._results: Dict[tuple, Any] = {}

    def _gather(self, key, rank, value):
        """Block until all ranks contributed; the completion flag is
        monotonic (a waiter's predicate can never flip back to false while
        another rank starts consuming the round)."""
        with self._cond:
            slot = self._rounds.setdefault(
                key, {"vals": {}, "done": False, "left": self.world_size})
            slot["vals"][rank] = value
            if len(slot["vals"]) == self.world_size:
                slot["done"] = True
                self._cond.notify_all()
            elif not self._cond.wait_for(lambda: slot["done"], timeout=120):
                raise TimeoutError(
                    f"collective round {key} timed out with "
                    f"{len(slot['vals'])}/{self.world_size} ranks")
            return slot

    def _finish(self, key, slot, compute):
        """First-finisher computes; everyone reads; last rank cleans up."""
        with self._lock:
            if key not in self._results:
                self._results[key] = compute(slot["vals"])
            out = self._results[key]
            slot["left"] -= 1
            if slot["left"] == 0:
                self._rounds.pop(key, None)
                self._results.pop(key, None)
            return out

    def allreduce(self, seq, rank, arr, op):
        key = ("ar", seq)
        slot = self._gather(key, rank, arr)

        def compute(vals):
            vs = [vals[r] for r in sorted(vals)]
            if op == "sum":
                return sum(vs[1:], start=vs[0].copy())
            if op == "max":
                return np.maximum.reduce(vs)
            if op == "min":
                return np.minimum.reduce(vs)
            if op == "mean":
                return sum(vs[1:], start=vs[0].copy()) / len(vs)
            raise ValueError(op)

        return self._finish(key, slot, compute)

    def allgather(self, seq, rank, arr):
        key = ("ag", seq)
        slot = self._gather(key, rank, arr)
        return self._finish(
            key, slot, lambda vals: [vals[r] for r in sorted(vals)])

    def reducescatter(self, seq, rank, arr, op):
        key = ("rs", seq)
        slot = self._gather(key, rank, arr)

        def compute(vals):
            vs = [vals[r] for r in sorted(vals)]
            if op in ("sum", "mean"):
                total = sum(vs[1:], start=vs[0].copy())
                if op == "mean":
                    total = total / len(vs)
            elif op == "max":
                total = np.maximum.reduce(vs)
            elif op == "min":
                total = np.minimum.reduce(vs)
            else:
                raise ValueError(op)
            return np.array_split(total, self.world_size)

        return self._finish(key, slot, compute)[rank]

    def broadcast(self, seq, rank, arr, src):
        key = ("bc", seq)
        slot = self._gather(key, rank, arr if rank == src else None)
        return self._finish(key, slot, lambda vals: vals[src])

    def barrier(self, seq, rank):
        key = ("ba", seq)
        slot = self._gather(key, rank, True)
        return self._finish(key, slot, lambda vals: True)

    def put_p2p(self, seq, dst, arr):
        with self._cond:
            self._rounds[("p2p", seq, dst)] = {0: arr}
            self._cond.notify_all()
        return True

    def get_p2p(self, seq, dst):
        with self._cond:
            self._cond.wait_for(
                lambda: ("p2p", seq, dst) in self._rounds, timeout=120)
            return self._rounds.pop(("p2p", seq, dst))[0]


class _GroupState:
    def __init__(self, name, rank, world_size, coordinator):
        self.name = name
        self.rank = rank
        self.world_size = world_size
        self.coordinator = coordinator
        self.seq = 0
        # p2p counters are per (src, dst) pair: only the two endpoints
        # advance them, so they stay matched without a global barrier.
        self.p2p_seq: Dict[tuple, int] = {}
        self.ring: Optional["_Ring"] = None

    def next_seq(self):
        self.seq += 1
        return self.seq

    def next_p2p_seq(self, src: int, dst: int):
        key = (src, dst)
        self.p2p_seq[key] = self.p2p_seq.get(key, 0) + 1
        return self.p2p_seq[key]


class _Ring:
    """Ring transport over the workers' direct-push listeners: each rank
    holds ONE connection to its right neighbour and receives from its
    left via the process's DirectServer ``dmsg`` channel.

    This replaces the star coordinator for bulk collectives — the star
    shipped world_size FULL arrays through one actor's pickled call path
    (its GIL and NIC serialized every round); a ring moves
    2*(N-1)/N * bytes per rank over direct peer sockets, all links busy
    simultaneously (reference shape: ring allreduce in
    nccl_collective_group.py:821 — re-designed over our own transport;
    TPU-device collectives remain XLA's, ray_tpu_torch.parallel)."""

    def __init__(self, group_name: str, rank: int, world_size: int):
        import queue as _q

        from ray_tpu_torch._private import protocol as _protocol
        from ray_tpu_torch._private.worker_main import get_worker_runtime

        self._protocol = _protocol
        self.rank = rank
        self.world = world_size
        self.channel = f"coll:{group_name}:{rank}"
        self._rt = get_worker_runtime()
        self._inbox: "_q.SimpleQueue" = _q.SimpleQueue()
        # Handler registered BEFORE the address barrier: a fast
        # neighbour's first step may land the instant the barrier
        # releases it, and an unregistered channel drops silently.
        self._rt.register_peer_handler(self.channel, self._inbox.put)
        self._right = None
        self._right_lock = threading.Lock()

    def connect(self, addrs: List[tuple]):
        import os
        from multiprocessing.connection import Client

        right = addrs[(self.rank + 1) % self.world]
        authkey = bytes.fromhex(os.environ.get("RAY_TPU_AUTHKEY", ""))
        self._right = Client(tuple(right), authkey=authkey)

    def send_right(self, step: int, payload: bytes):
        dst_channel = f"{self.channel.rsplit(':', 1)[0]}:" \
                      f"{(self.rank + 1) % self.world}"
        with self._right_lock:
            self._protocol.send(self._right,
                                ("dmsg", dst_channel, (step, payload)))

    def recv_left(self, step: int) -> bytes:
        # Per-step matching: collective calls are issued in the same
        # order on every rank, and the left neighbour sends steps in
        # order, so messages arrive matched (assert guards drift).
        got_step, payload = self._inbox.get(timeout=120)
        assert got_step == step, (got_step, step)
        return payload

    def close(self):
        try:
            self._rt.unregister_peer_handler(self.channel)
        except Exception:
            pass
        try:
            self._right.close()
        except Exception:
            pass


def _groups() -> Dict[str, _GroupState]:
    with _groups_lock:
        return dict(_GROUPS)


def init_collective_group(world_size: int, rank: int,
                          group_name: str = "default"):
    """Called by each participating actor/task (reference:
    collective.py:120)."""
    name = _GROUP_PREFIX + group_name
    with _groups_lock:
        if group_name in _GROUPS:
            raise RuntimeError(
                f"collective group {group_name!r} already initialized in "
                f"this process")
    if rank == 0:
        coord = _Coordinator.options(
            name=name, max_concurrency=max(world_size + 2, 4),
            num_cpus=0).remote(world_size)
    else:
        coord = _wait_for_actor(name)
    g = _GroupState(group_name, rank, world_size, coord)
    with _groups_lock:
        _GROUPS[group_name] = g
    # Ring setup: exchange each rank's direct-listener address (tiny)
    # through the star; bulk collectives then bypass it entirely.  Two
    # agreement rounds: addresses, then per-rank connect success — ALL
    # ranks use the ring or NONE do (a mixed group would deadlock).
    ring = None
    addr = None
    try:
        from ray_tpu_torch._private.worker_main import get_worker_runtime

        rt = get_worker_runtime()
        if rt is not None and rt.direct_addr and world_size > 1:
            ring = _Ring(group_name, rank, world_size)
            addr = tuple(rt.direct_addr)
    except Exception:
        ring = None
    addrs = ray.get(g.coordinator.allgather.remote(
        g.next_seq(), rank, addr))
    ok = ring is not None and all(a is not None for a in addrs)
    if ok:
        try:
            ring.connect(addrs)
        except Exception:
            ok = False
    oks = ray.get(g.coordinator.allgather.remote(g.next_seq(), rank, ok))
    if all(oks) and ring is not None:
        g.ring = ring
    elif ring is not None:
        ring.close()


def _wait_for_actor(name, timeout=30.0):
    import time
    deadline = time.time() + timeout
    while time.time() < deadline:
        try:
            return ray.get_actor(name)
        except Exception:
            time.sleep(0.05)
    raise TimeoutError(f"collective group actor {name} not found")


def create_collective_group(actors: List[Any], world_size: int,
                            ranks: List[int],
                            group_name: str = "default"):
    """Declarative setup from the driver (reference: collective.py:151)."""
    futs = []
    for actor, rank in zip(actors, ranks):
        futs.append(actor.execute.remote(
            init_collective_group, world_size, rank, group_name))
    ray.get(futs)


def _group(group_name) -> _GroupState:
    g = _groups().get(group_name)
    if g is None:
        raise RuntimeError(
            f"collective group {group_name!r} not initialized in this "
            f"process — call init_collective_group first")
    return g


def _op_apply(op: str, dst: np.ndarray, src: np.ndarray):
    if op in ("sum", "mean"):
        np.add(dst, src, out=dst)
    elif op == "max":
        np.maximum(dst, src, out=dst)
    elif op == "min":
        np.minimum(dst, src, out=dst)
    else:
        raise ValueError(op)


def _ring_reduce_phase(g: _GroupState, seq: int, chunks: List[np.ndarray],
                       op: str):
    """Ring reduce-scatter pass: indices shifted so that after n-1 steps
    rank r fully owns chunk r (matching the star's array_split[rank]
    semantics)."""
    n, ring = g.world_size, g.ring
    rr = (g.rank - 1) % n
    for i in range(n - 1):
        send_idx = (rr - i) % n
        recv_idx = (rr - i - 1) % n
        ring.send_right((seq, "rs", i), chunks[send_idx])
        incoming = ring.recv_left((seq, "rs", i))
        _op_apply(op, chunks[recv_idx], incoming)


def _ring_allgather_phase(g: _GroupState, seq: int,
                          chunks: List[np.ndarray]):
    n, ring = g.world_size, g.ring
    rr = (g.rank - 1) % n
    for i in range(n - 1):
        send_idx = (rr + 1 - i) % n
        recv_idx = (rr - i) % n
        ring.send_right((seq, "ag", i), chunks[send_idx])
        chunks[recv_idx][...] = ring.recv_left((seq, "ag", i))


def allreduce(tensor: np.ndarray, group_name: str = "default",
              op: str = "sum") -> np.ndarray:
    g = _group(group_name)
    arr = np.asarray(tensor)
    if g.ring is not None and arr.size >= 1024:
        seq = g.next_seq()
        out = np.ascontiguousarray(arr).copy()
        flat = out.reshape(-1)
        chunks = np.array_split(flat, g.world_size)  # views into out
        _ring_reduce_phase(g, seq, chunks, op)
        _ring_allgather_phase(g, seq, chunks)
        if op == "mean":
            # True division promotes (int inputs -> float), matching
            # the star path's sum/len.
            return (out / g.world_size).reshape(arr.shape)
        return out
    return ray.get(g.coordinator.allreduce.remote(
        g.next_seq(), g.rank, arr, op))


def allgather(tensor: np.ndarray, group_name: str = "default"
              ) -> List[np.ndarray]:
    g = _group(group_name)
    arr = np.asarray(tensor)
    # No size threshold: per-rank sizes may differ, and a size-dependent
    # branch would let ranks pick different transports and deadlock.
    if g.ring is not None:
        # Pass each rank's whole array around the ring: n-1 steps, every
        # link busy, nothing through the coordinator.
        seq = g.next_seq()
        n, r, ring = g.world_size, g.rank, g.ring
        out: List[Optional[np.ndarray]] = [None] * n
        out[r] = arr.copy()  # snapshot: callers may mutate their input
        cur = arr
        for i in range(n - 1):
            ring.send_right((seq, "ag", i), cur)
            cur = ring.recv_left((seq, "ag", i))
            out[(r - i - 1) % n] = cur
        return [np.asarray(a) for a in out]
    return ray.get(g.coordinator.allgather.remote(
        g.next_seq(), g.rank, arr))


def reducescatter(tensor: np.ndarray, group_name: str = "default",
                  op: str = "sum") -> np.ndarray:
    g = _group(group_name)
    arr = np.asarray(tensor)
    if g.ring is not None and arr.size >= 1024:
        seq = g.next_seq()
        # Split along axis 0 like the star path (array_split on the
        # UNflattened total), so multi-dim tensors partition into the
        # same row blocks on either transport.
        buf = np.ascontiguousarray(arr).copy()
        chunks = np.array_split(buf, g.world_size)
        _ring_reduce_phase(g, seq, chunks, op)
        mine = chunks[g.rank]
        if op == "mean":
            return mine / g.world_size
        return mine.copy()  # drop the world_size-times-larger backing buf
    return ray.get(g.coordinator.reducescatter.remote(
        g.next_seq(), g.rank, arr, op))


def broadcast(tensor: np.ndarray, src_rank: int = 0,
              group_name: str = "default") -> np.ndarray:
    g = _group(group_name)
    return ray.get(g.coordinator.broadcast.remote(
        g.next_seq(), g.rank, np.asarray(tensor), src_rank))


def barrier(group_name: str = "default"):
    g = _group(group_name)
    ray.get(g.coordinator.barrier.remote(g.next_seq(), g.rank))


def send(tensor: np.ndarray, dst_rank: int, group_name: str = "default"):
    g = _group(group_name)
    seq = g.next_p2p_seq(g.rank, dst_rank)
    ray.get(g.coordinator.put_p2p.remote(
        (g.rank, dst_rank, seq), dst_rank, np.asarray(tensor)))


def recv(src_rank: int, group_name: str = "default") -> np.ndarray:
    g = _group(group_name)
    seq = g.next_p2p_seq(src_rank, g.rank)
    return ray.get(g.coordinator.get_p2p.remote(
        (src_rank, g.rank, seq), g.rank))


def destroy_collective_group(group_name: str = "default"):
    # Mutate _GROUPS itself under its lock — _groups() hands out a copy, so
    # popping from that copy would leak the entry and make any later
    # destroy-then-reinit of the same name fail the duplicate check.
    with _groups_lock:
        g = _GROUPS.pop(group_name, None)
    if g is not None and g.ring is not None:
        g.ring.close()
    if g is not None and g.rank == 0:
        try:
            ray.kill(g.coordinator)
        except Exception:
            pass
