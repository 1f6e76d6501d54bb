"""Fault-tolerance plumbing shared by the head and workers.

Three pieces, kept dependency-free so every process tier can import it
(driver runtime, worker runtime, node agent, the chaos harness):

- ``LineageTable`` — a BOUNDED object -> producing-TaskSpec table
  (reference: lineage pinning in ``task_manager.h:174`` + the recovery
  walk of ``object_recovery_manager.h:41``).  The owner records each
  submitted spec; a lost object is rebuilt by re-executing its producer.
  Entries evict when the last return object's refcount drops OR when the
  table's byte budget (``config.lineage_bytes_budget``) overflows —
  mirroring the reference's ``lineage_pinning`` byte cap, so lineage is
  metadata the owner already holds, never an unbounded log.

- retry classification — ``retry_matches``.  ``max_retries`` budgets
  SYSTEM failures (worker/node death, OOM kills — classified at their
  discovery sites in the death paths); application exceptions are
  retried only under the explicit ``retry_exceptions=`` opt-in
  (reference: ``retry_exceptions`` on ``@ray.remote``).

- chaos syncpoints — ``syncpoint(name)`` is a near-zero-cost hook
  (one module-global ``is None`` check on the fast path) that the
  chaos harness (``ray_tpu_torch.chaos``) arms in-process, and that
  ``RAY_TPU_CHAOS`` env rules arm in spawned workers/agents for
  deterministic mid-operation kills.  Never active unless explicitly
  opted in.  Points: dispatch/result/lease_grant (head), exec_start
  (worker), pull_chunk (every transfer chunk), agent_msg (agent
  control messages), snapshot/dispatch (standalone head), and
  ``preempt`` — fired at the start of an agent's self-drain, so an
  ``agent:preempt:1`` rule models the warning window getting yanked
  mid-drain (notice received, plug pulled early).
"""

from __future__ import annotations

import os
import threading
from collections import deque
from typing import Dict, List, Optional, Tuple

# --------------------------------------------------------------- lineage --

def seg_oid_hex(name: str) -> Optional[str]:
    """Object id hex embedded in a segment name or spill path
    (``rtpu-<session>-<oid hex>``, shm_store.py) — THE one
    implementation of that naming rule for loss errors and owned-object
    recovery; returns None for anything unparseable."""
    try:
        tail = os.path.basename(name).rsplit("-", 1)[1]
        bytes.fromhex(tail)
        return tail
    except Exception:
        return None


_SPEC_BASE_COST = 512       # table entry + ids + small spec fields
_DESCR_COST = 64            # non-inline arg descriptor (name + ints)


def spec_cost(spec: dict) -> int:
    """Cheap byte-cost estimate for retaining one TaskSpec: inline arg
    payloads dominate; everything else is near-constant metadata.  Must
    stay O(#args) with no serialization — lineage recording sits on the
    submit hot path and its steady-state overhead must be ~zero."""
    cost = _SPEC_BASE_COST
    for a in spec.get("args", ()):
        cost += (len(a[1]) if a and a[0] == "inline" else _DESCR_COST)
    for a in (spec.get("kwargs") or {}).values():
        cost += (len(a[1]) if a and a[0] == "inline" else _DESCR_COST)
    return cost


class LineageTable:
    """Bounded lineage: task prefix (12 bytes) -> entry dict.

    An entry holds the producing ``spec``, the set of its still-alive
    return-object bins, the remaining reconstruction budget (``retries``,
    seeded from the spec's ``max_retries`` — reconstruction is a SYSTEM-
    failure retry and draws from the same budget), and its byte ``cost``.

    LOCK ORDER: ``_lock`` is an independent LEAF — no other lock is ever
    acquired while holding it, and callers (the head's runtime lock, the
    DirectCaller ownership lock) may hold their own lock when calling in.
    Pinned in tests/test_lockcheck.py.  Eviction never runs callbacks
    under ``_lock``: evicted entries are RETURNED for the caller to
    release resources at its own locking level.
    """

    def __init__(self, budget_bytes: int):
        self._lock = threading.Lock()  # lock-order: leaf
        self.budget = int(budget_bytes)
        self._entries: Dict[bytes, dict] = {}
        self._order: deque = deque()  # FIFO of task prefixes for eviction
        self.bytes = 0
        self.evicted = 0

    def record(self, spec: dict,
               default_retries: int = 3) -> List[dict]:
        """Retain ``spec``; returns the entries evicted to stay within
        the byte budget (oldest-first) so the caller can release any
        resources it pinned for them."""
        from ray_tpu_torch._private.ids import TaskID

        prefix = spec["task_id"][:12]
        tid = TaskID(spec["task_id"])
        cost = spec_cost(spec)
        entry = {
            "spec": spec,
            "alive": {tid.object_id(i).binary()
                      for i in range(spec["num_returns"])},
            "retries": spec.get("max_retries", default_retries),
            "cost": cost,
        }
        evicted: List[dict] = []
        with self._lock:
            prev = self._entries.get(prefix)
            if prev is not None:
                self.bytes -= prev["cost"]
            self._entries[prefix] = entry
            if prev is None:
                self._order.append(prefix)
            self.bytes += cost
            while self.bytes > self.budget > 0 and len(self._entries) > 1:
                old_prefix = self._order.popleft()
                if old_prefix == prefix:
                    self._order.append(prefix)
                    continue
                old = self._entries.pop(old_prefix, None)
                if old is None:
                    continue
                self.bytes -= old["cost"]
                self.evicted += 1
                evicted.append(old)
        return evicted

    def get(self, prefix: bytes) -> Optional[dict]:
        with self._lock:
            return self._entries.get(prefix)

    def __contains__(self, prefix: bytes) -> bool:
        with self._lock:
            return prefix in self._entries

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def note_attempt(self, prefix: bytes) -> bool:
        """Consume one reconstruction attempt; False when depleted (the
        caller then refuses recovery — depleted retries surface as
        ``ObjectLostError``)."""
        with self._lock:
            entry = self._entries.get(prefix)
            if entry is None or entry["retries"] <= 0:
                return False
            entry["retries"] -= 1
            return True

    def release(self, oid_bin: bytes) -> Optional[dict]:
        """A return object's refcount dropped; when the entry's last one
        goes, the entry is dropped and returned (caller releases the
        spec's pinned resources)."""
        prefix = oid_bin[:12]
        with self._lock:
            entry = self._entries.get(prefix)
            if entry is None:
                return None
            entry["alive"].discard(oid_bin)
            if entry["alive"]:
                return None
            self._entries.pop(prefix, None)
            # The prefix stays in _order as a TOMBSTONE (eviction skips
            # entries no longer present) — a deque.remove here would be
            # O(table) under the owner's big lock on every object free.
            # Compact when tombstones dominate, amortizing to O(1).
            self.bytes -= entry["cost"]
            if len(self._order) > 4 * len(self._entries) + 64:
                self._order = deque(p for p in self._order
                                    if p in self._entries)
            return entry

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"entries": len(self._entries), "bytes": self.bytes,
                    "evicted": self.evicted}


# --------------------------------------------- retry classification --
# System failures (worker/node death, OOM kills) are classified AT
# their discovery sites — the death paths in runtime.py/direct.py
# decrement retries_left directly; only the app-error opt-in needs a
# shared matcher.

def retry_matches(retry_exceptions, err: BaseException) -> bool:
    """Whether an APPLICATION error qualifies for the opt-in retry.
    ``retry_exceptions`` is ``True`` (any app error) or a list/tuple of
    exception types matched against the task error's original cause."""
    if not retry_exceptions:
        return False
    from ray_tpu_torch import exceptions as exc

    if not isinstance(err, exc.TaskError):
        return False  # system failures ride the max_retries path instead
    if retry_exceptions is True:
        return True
    cause = getattr(err, "cause", None)
    try:
        types = tuple(t for t in retry_exceptions
                      if isinstance(t, type) and issubclass(t, BaseException))
    except TypeError:
        return False
    return cause is not None and isinstance(cause, types)


# -------------------------------------------------- chaos syncpoints --

# The armed hook: callable(name, info_dict) or None.  The fast path is
# one global read + None check; nothing else runs until a controller
# (ray_tpu_torch.chaos.ChaosController) or an env rule arms it.
_CHAOS_HOOK = None


def set_chaos_hook(fn) -> None:
    global _CHAOS_HOOK
    _CHAOS_HOOK = fn


def chaos_armed() -> bool:
    return _CHAOS_HOOK is not None


def syncpoint(name: str, **info) -> None:
    """Named chaos syncpoint.  ~Zero cost unless a controller armed the
    process (opt-in via ``RAY_TPU_CHAOS`` or an explicit
    ``ChaosController``)."""
    hook = _CHAOS_HOOK
    if hook is not None:
        hook(name, info)


def parse_chaos_rules(raw: str) -> List[Tuple[str, str, int]]:
    """``RAY_TPU_CHAOS`` grammar: comma-separated ``role:point:n`` rules
    — processes of ``role`` ("worker" / "agent" / "driver") exit hard at
    the ``n``-th firing of syncpoint ``point``.  Unparseable rules are
    ignored (chaos must never break a production boot that inherited a
    stray env var)."""
    rules = []
    for part in (raw or "").split(","):
        bits = part.strip().split(":")
        if len(bits) != 3:
            continue
        role, point, n = bits
        try:
            rules.append((role, point, max(1, int(n))))
        except ValueError:
            continue
    return rules


def maybe_arm_env_chaos(role: str) -> bool:
    """Arm env-driven chaos rules for this process (worker/agent entry
    points call this).  Each rule fires AT MOST ONCE per cluster: the
    first process to reach the rule's count claims an O_EXCL lockfile
    keyed by (session, rule) and dies with ``os._exit(137)`` — a hard
    kill indistinguishable from a crash, which is the point.  Without
    the claim the process sails through, so a RETRIED task does not die
    again at the same spot and the cluster converges."""
    rules = [r for r in parse_chaos_rules(os.environ.get("RAY_TPU_CHAOS", ""))
             if r[0] == role]
    if not rules:
        return False
    session = os.environ.get("RAY_TPU_SESSION", "nosession")
    counters: Dict[str, int] = {}
    counters_lock = threading.Lock()

    def hook(name, _info):
        for r_role, point, n in rules:
            if point != name:
                continue
            with counters_lock:
                counters[point] = counters.get(point, 0) + 1
                hit = counters[point] >= n
            if not hit:
                continue
            claim = os.path.join(
                os.environ.get("RAY_TPU_CHAOS_DIR", "/tmp"),
                f"ray_tpu_chaos_{session}_{r_role}_{point}_{n}")
            try:
                fd = os.open(claim, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            except OSError:
                continue  # another process already died for this rule
            os.write(fd, str(os.getpid()).encode())
            os.close(fd)
            os._exit(137)

    set_chaos_hook(hook)
    return True
