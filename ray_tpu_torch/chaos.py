"""Chaos-injection harness: kill workers/agents/connections on schedule
or at named syncpoints.

Reference analog: ``python/ray/_private/test_utils.py`` ``kill_raylet``/
``NodeKillerActor`` + the chaos-testing release jobs (``ray/release/
chaos_test``) — fault tolerance that is not exercised does not exist.

Opt-in twice over: nothing in this module runs unless (a) a test/driver
constructs a :class:`ChaosController`, or (b) ``RAY_TPU_CHAOS`` env
rules arm a spawned worker/agent process for deterministic self-kills
(see ``recovery.maybe_arm_env_chaos``; grammar ``role:point:n`` — e.g.
``worker:pull_chunk:3`` hard-kills the first worker to receive its 3rd
pull chunk).  Steady-state cost with chaos off is one module-global
``is None`` check per syncpoint.

Driver-side controller::

    chaos = ChaosController(rt)
    chaos.schedule(0.5, chaos.kill_worker)      # wall-clock schedule
    chaos.at_syncpoint("dispatch", chaos.kill_agent, n=10)
    ...
    chaos.stop()

Every kill increments the runtime's ``chaos_kills`` counter
(``transfer_stats()``), so tests can assert the injected faults actually
happened — a chaos test whose kill silently missed proves nothing.
"""

from __future__ import annotations

import os
import signal
import threading
import time
from typing import Callable, Dict, List, Optional

from ray_tpu_torch._private import recovery

# Re-export: framework code fires syncpoints through recovery (no import
# cycle); tests and user code may import them from here.
syncpoint = recovery.syncpoint
parse_chaos_rules = recovery.parse_chaos_rules


def enabled() -> bool:
    """Whether env-driven chaos is requested (``RAY_TPU_CHAOS`` set)."""
    return bool(os.environ.get("RAY_TPU_CHAOS"))


# ---------------------------------------------------------- net chaos ----
# Gray-failure injection at the ``protocol.py`` send/recv seam: where
# the kill rules produce CLEAN failures (a process dies, its peer sees
# EOF), these produce the failures that announce nothing — full stalls
# (paused VM, wedged switch), silent drops (one-way partition), added
# latency, duplicates.  The failure-detection plane (deadlines,
# heartbeat suspicion) exists to survive exactly this class, and these
# rules are what make it testable.

def parse_net_rules(raw: str) -> List[Tuple[str, str, str, float, int]]:
    """``RAY_TPU_CHAOS_NET`` grammar: comma-separated
    ``role:point:action:n`` rules — in processes of ``role``
    ("worker"/"agent"/"driver"), the ``n``-th operation hitting net
    point ``point`` ("send", "recv", "chunk_send", or ``*`` for any)
    triggers ``action``:

    - ``stall``      — that operation and every later matching one
                       blocks forever (the alive-but-hung peer),
    - ``drop``       — sends are silently discarded from then on (the
                       outbound half of a partition),
    - ``delay-<ms>`` — every later matching operation sleeps first
                       (the saturated link),
    - ``dup``        — every later matching send goes out twice.

    Returns (role, point, action, param, n) tuples; unparseable rules
    are ignored (chaos must never break a production boot that
    inherited a stray env var)."""
    rules = []
    for part in (raw or "").split(","):
        bits = part.strip().split(":")
        if len(bits) != 4:
            continue
        role, point, action, n = bits
        param = 0.0
        if action.startswith("delay-"):
            try:
                param = float(action[len("delay-"):])
            except ValueError:
                continue
            action = "delay"
        if action not in ("stall", "drop", "delay", "dup"):
            continue
        try:
            rules.append((role, point, action, param, max(1, int(n))))
        except ValueError:
            continue
    return rules


class ChaosNet:
    """Per-process net-fault injector installed at the protocol seam.

    Two users: RAY_TPU_CHAOS_NET env rules armed at worker/agent entry
    (one-shot per cluster via the same O_EXCL claim-file convention as
    the kill rules, so a retried operation does not re-hit the fault
    elsewhere and the cluster converges), and the driver-side
    :class:`ChaosController` link methods (``stall_link``/
    ``partition``/``restore_link``), which scope rules to ONE peer
    connection in this process.

    The hook cost is one module-global ``is None`` check per send/recv
    until installed.  A ``stall`` parks the calling thread on the
    rule's resume event — ``restore`` (or controller stop) releases it;
    env-rule stalls are deliberately permanent for the process, the
    paused-VM semantics."""

    def __init__(self):
        self._lock = threading.Lock()
        self._rules: List[dict] = []
        self.net_faults = 0  # rules that actually fired

    # ------------------------------------------------------- install --
    def install(self) -> "ChaosNet":
        from ray_tpu_torch._private import protocol

        protocol.set_net_hook(self._hook)
        return self

    def uninstall(self):
        from ray_tpu_torch._private import protocol

        protocol.set_net_hook(None)
        self.restore()

    # --------------------------------------------------------- rules --
    def add_rule(self, point: str, action: str, conn=None,
                 param: float = 0.0, after: int = 1,
                 claim: Optional[str] = None) -> dict:
        rule = {
            "point": point, "action": action, "conn": conn,
            "param": param, "countdown": max(1, after),
            "claim": claim, "armed": False, "dead": False,
            "resume": threading.Event(),
        }
        with self._lock:
            self._rules.append(rule)
        return rule

    def restore(self, conn=None):
        """Lift rules (all, or just one connection's): stalled threads
        resume, drops/delays stop."""
        with self._lock:
            keep = []
            for r in self._rules:
                if conn is None or r["conn"] is conn:
                    r["dead"] = True
                    r["resume"].set()
                else:
                    keep.append(r)
            self._rules = keep

    # ---------------------------------------------------------- hook --
    def _hook(self, point: str, conn) -> Optional[str]:
        verdict = None
        fire = []
        with self._lock:
            for r in self._rules:
                if r["dead"]:
                    continue
                if r["point"] != "*" and r["point"] != point:
                    continue
                if r["conn"] is not None and r["conn"] is not conn:
                    continue
                if not r["armed"]:
                    r["countdown"] -= 1
                    if r["countdown"] > 0:
                        continue
                    if r["claim"] and not _claim_once(r["claim"]):
                        # Another process already owns this one-shot
                        # cluster-wide rule: this process sails through.
                        r["dead"] = True
                        continue
                    r["armed"] = True
                    self.net_faults += 1
                fire.append(r)
        for r in fire:
            act = r["action"]
            if act == "delay":
                time.sleep(r["param"] / 1000.0)
            elif act == "stall":
                # Park until restored: the gray failure itself.  The
                # socket stays open — no EOF ever announces this.
                r["resume"].wait()
            elif act == "drop":
                if point == "recv":
                    # Inbound drop = never deliver: equivalent to not
                    # reading (the bytes sit in the kernel buffer).
                    r["resume"].wait()
                else:
                    verdict = "drop"
            elif act == "dup":
                verdict = "dup"
        return verdict

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"net_faults": self.net_faults,
                    "net_rules": len(self._rules)}


def _claim_once(claim_path: str) -> bool:
    """O_EXCL one-shot claim (the kill rules' convention): the first
    process to trigger a cluster-wide env rule owns it."""
    try:
        fd = os.open(claim_path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
    except OSError:
        return False
    os.write(fd, str(os.getpid()).encode())
    os.close(fd)
    return True


def maybe_arm_env_net_chaos(role: str) -> bool:
    """Arm ``RAY_TPU_CHAOS_NET`` rules for this process (worker/agent
    entry points call this next to ``recovery.maybe_arm_env_chaos``).
    Each rule fires in AT MOST ONE process per cluster via the claim
    file.  Zero cost when the env var is unset."""
    rules = [r for r in parse_net_rules(
        os.environ.get("RAY_TPU_CHAOS_NET", "")) if r[0] == role]
    if not rules:
        return False
    session = os.environ.get("RAY_TPU_SESSION", "nosession")
    chaos_dir = os.environ.get("RAY_TPU_CHAOS_DIR", "/tmp")
    net = ChaosNet()
    for r_role, point, action, param, n in rules:
        claim = os.path.join(
            chaos_dir,
            f"ray_tpu_chaos_net_{session}_{r_role}_{point}_{action}_{n}")
        net.add_rule(point, action, param=param, after=n, claim=claim)
    net.install()
    return True


class ChaosController:
    """Drives fault injection against one driver runtime.

    Kill primitives take the runtime lock only long enough to pick a
    victim and bump ``chaos_kills``; the actual kill (SIGKILL / conn
    close) runs outside it.  Syncpoint-triggered actions execute on a
    dedicated thread — the firing site may hold framework locks, and a
    kill that re-enters the runtime from under them would deadlock."""

    def __init__(self, rt=None, arm_syncpoints: bool = True, head=None):
        if rt is None:
            from ray_tpu_torch._private.api_internal import require_runtime

            rt = require_runtime()
        self._rt = rt
        # Head manager for kill_head/restart_head: anything exposing
        # those two methods — canonically cluster_utils.Cluster with
        # external_head=True.  None = in-process head (killing it would
        # kill ourselves; the methods then raise).
        self._head = head
        self._head_kills = 0
        self._net: Optional[ChaosNet] = None  # lazy gray-failure seam
        self._lock = threading.Lock()
        self._timers: List[threading.Timer] = []
        # name -> list of [countdown, action, args] triples
        self._sync_actions: Dict[str, List[list]] = {}
        self._pending: List[tuple] = []
        self._pending_ev = threading.Event()
        self._stopped = False
        self._runner = threading.Thread(target=self._run_loop, daemon=True,
                                        name="ray_tpu_torch-chaos")
        self._runner.start()
        if arm_syncpoints:
            recovery.set_chaos_hook(self._fire)

    # ------------------------------------------------------ scheduling --
    def schedule(self, delay_s: float, action: Callable, *args, **kwargs):
        """Run ``action`` after ``delay_s`` wall-clock seconds."""
        t = threading.Timer(delay_s,
                            lambda: self._enqueue(action, args, kwargs))
        t.daemon = True
        with self._lock:
            self._timers.append(t)
        t.start()
        return t

    def at_syncpoint(self, name: str, action: Callable, *args,
                     n: int = 1, **kwargs):
        """Run ``action`` when syncpoint ``name`` fires for the n-th
        time (counted from registration)."""
        with self._lock:
            self._sync_actions.setdefault(name, []).append(
                [max(1, n), action, args, kwargs])

    def _fire(self, name: str, _info: dict):
        todo = []
        with self._lock:
            lst = self._sync_actions.get(name)
            if not lst:
                return
            for item in list(lst):
                item[0] -= 1
                if item[0] <= 0:
                    lst.remove(item)
                    todo.append(item)
        for _n, action, args, kwargs in todo:
            self._enqueue(action, args, kwargs)

    def _enqueue(self, action, args, kwargs):
        with self._lock:
            if self._stopped:
                return
            self._pending.append((action, args, kwargs))
        self._pending_ev.set()

    def _run_loop(self):
        while not self._stopped:
            self._pending_ev.wait()
            self._pending_ev.clear()
            while True:
                with self._lock:
                    if not self._pending:
                        break
                    action, args, kwargs = self._pending.pop(0)
                try:
                    action(*args, **kwargs)
                except Exception:
                    pass  # a missed kill must not crash the harness

    # ------------------------------------------------------------ kills --
    def _count_kill(self):
        with self._rt.lock:
            self._rt.chaos_kills += 1

    def kill_worker(self, node_id: Optional[str] = None,
                    actor: Optional[bool] = None,
                    mid_task: bool = True) -> Optional[str]:
        """SIGKILL one worker process.  ``node_id`` scopes the pick to a
        node (hex); ``actor`` True/False filters actor vs plain workers;
        ``mid_task`` prefers a worker with in-flight work (the
        interesting case).  Returns the victim's worker id hex, or None
        when nothing matched."""
        victim = None
        with self._rt.lock:
            candidates = []
            for node in self._rt.nodes.values():
                if node_id is not None and node.node_id.hex() != node_id:
                    continue
                for w in node.all_workers.values():
                    if w.dead:
                        continue
                    if actor is True and w.actor_id is None:
                        continue
                    if actor is False and w.actor_id is not None:
                        continue
                    busy = bool(w.inflight) or (
                        w.actor_id is not None and w.conn is not None)
                    candidates.append((busy, w))
            for busy, w in candidates:
                if busy or not mid_task:
                    victim = w
                    break
            if victim is None:
                return None
            self._rt.chaos_kills += 1
        wid = victim.worker_id.hex()
        if victim.proc is not None:
            try:
                victim.proc.kill()
            except Exception:
                pass
        else:
            agent = (victim.node.agent
                     if victim.node is not None else None)
            if agent is not None and not agent.dead:
                try:
                    agent.send(("kill_worker_hard", wid))
                except Exception:
                    pass
        return wid

    def _pick_agent_locked(self, node_id: Optional[str]):
        """First live agent (optionally scoped to a node hex) — the ONE
        selection rule for kill_agent and preempt_node, so the two
        faults always aim at the same target for the same scope."""
        for agent in self._rt._agents.values():
            if agent.dead or agent.node is None:
                continue
            if node_id is not None \
                    and agent.node.node_id.hex() != node_id:
                continue
            return agent
        return None

    def kill_agent(self, node_id: Optional[str] = None) -> Optional[str]:
        """SIGKILL a node agent process (no graceful shutdown — its
        workers are orphaned exactly as on real node loss).  Returns the
        node id hex, or None."""
        with self._rt.lock:
            target = self._pick_agent_locked(node_id)
            if target is None:
                return None
            self._rt.chaos_kills += 1
        pid = target.info.get("pid")
        nid = target.node.node_id.hex()
        if pid:
            try:
                os.kill(pid, signal.SIGKILL)
            except OSError:
                pass
        # Don't wait for the conn EOF: drive death handling now, like
        # remove_node does — chaos tests need deterministic discovery.
        try:
            target.conn.close()
        except Exception:
            pass
        self._rt._on_agent_death(target)
        return nid

    def preempt_node(self, node_id: Optional[str] = None,
                     notice: bool = True) -> Optional[str]:
        """Preempt one agent-backed node — the spot/preemptible-slice
        fault.  With ``notice`` (the provider's warning window) the
        agent gets SIGUSR1 and self-drains through the head
        (``preempt_notice`` → drain → clean exit); without, this is the
        no-warning variant — a straight ``kill_agent`` SIGKILL.
        Returns the node id hex, or None when nothing matched."""
        if not notice:
            return self.kill_agent(node_id)
        with self._rt.lock:
            target = self._pick_agent_locked(node_id)
        if target is None or not target.info.get("pid"):
            # kill_agent can still take a pid-less agent down (conn
            # close drives death handling); a NOTICE needs the pid.
            return None
        try:
            os.kill(target.info["pid"], signal.SIGUSR1)
        except OSError:
            return None  # pid already gone: no fault was injected
        # Counted only after the signal landed — unlike kill_agent,
        # which always drives death handling, a failed notice here is
        # no event at all and must not burn the exact-count asserts.
        self._count_kill()
        return target.node.node_id.hex()

    def drop_worker_connection(self,
                               worker_id: Optional[str] = None,
                               stall: bool = False) -> Optional[str]:
        """Take a worker's control connection away WITHOUT killing the
        process.  Default (``stall=False``): close it — the half-death
        case whose EOF the head discovers immediately and reroutes.
        ``stall=True`` is the GRAY variant: the socket stays open but
        the head stops reading it (and the worker's results rot in the
        kernel buffer) — no EOF ever fires, and only the heartbeat
        suspicion machinery can discover it.  One API, A/B-able clean
        vs gray."""
        victim = None
        with self._rt.lock:
            for node in self._rt.nodes.values():
                for w in node.all_workers.values():
                    if w.dead or w.conn is None:
                        continue
                    if worker_id is not None \
                            and w.worker_id.hex() != worker_id:
                        continue
                    victim = w
                    break
                if victim is not None:
                    break
            if victim is None:
                return None
            self._rt.chaos_kills += 1
        if stall:
            # Hold the socket open, stop reading: the head-side reader
            # parks inside the net hook; sends to the worker are
            # swallowed so its gets/waits starve too.  net_faults
            # counts it as an injected gray fault.
            net = self._ensure_net()
            net.add_rule("recv", "stall", conn=victim.conn)
            net.add_rule("send", "drop", conn=victim.conn)
        else:
            try:
                victim.conn.close()
            except Exception:
                pass
        return victim.worker_id.hex()

    # ------------------------------------------------------ net faults --
    def _ensure_net(self) -> ChaosNet:
        with self._lock:
            if self._net is None:
                self._net = ChaosNet().install()
            return self._net

    def stall_link(self, node_id: Optional[str] = None) -> Optional[str]:
        """Full gray stall of the head<->agent link of one node: the
        head stops reading the agent's messages (heartbeats included)
        and its sends are silently swallowed — both processes stay
        alive, nothing EOFs.  The suspicion machine is what must notice.
        Returns the node id hex, or None."""
        with self._rt.lock:
            target = self._pick_agent_locked(node_id)
        if target is None:
            return None
        net = self._ensure_net()
        net.add_rule("recv", "stall", conn=target.conn)
        net.add_rule("send", "drop", conn=target.conn)
        return target.node.node_id.hex()

    def partition(self, node_id: Optional[str] = None,
                  direction: str = "in") -> Optional[str]:
        """One-way partition of a node's head link: ``direction="in"``
        drops everything the agent sends (the head goes deaf to it —
        heartbeat silence with a perfectly healthy agent process);
        ``"out"`` silently swallows the head's sends instead.  Returns
        the node id hex, or None."""
        with self._rt.lock:
            target = self._pick_agent_locked(node_id)
        if target is None:
            return None
        net = self._ensure_net()
        if direction == "in":
            net.add_rule("recv", "stall", conn=target.conn)
        else:
            net.add_rule("send", "drop", conn=target.conn)
        return target.node.node_id.hex()

    def restore_link(self, node_id: Optional[str] = None):
        """Lift controller-installed link faults (one node's, or all)."""
        if self._net is None:
            return
        if node_id is None:
            self._net.restore()
            return
        with self._rt.lock:
            target = self._pick_agent_locked(node_id)
        if target is not None:
            self._net.restore(target.conn)

    def attach_head(self, head) -> None:
        """Late-bind the head manager (the pytest fixture constructs the
        controller before a test decides to boot an external head)."""
        self._head = head

    def kill_head(self) -> Optional[int]:
        """SIGKILL the HEAD process — the last single point of failure.
        Requires an external head (``Cluster(external_head=True)``
        passed as ``head=``/``attach_head``); an in-process head shares
        our pid, so there is nothing survivable to kill.  Counted
        locally (``stats()["head_kills"]``) because the head's own
        counter dies with it."""
        if self._head is None:
            raise RuntimeError(
                "kill_head needs an external head: pass head="
                "Cluster(external_head=True) (or attach_head it)")
        pid = self._head.kill_head()
        with self._lock:
            self._head_kills += 1
        return pid

    def restart_head(self) -> Optional[int]:
        """Re-run the killed head with gcs_restore on the same
        port/authkey; surviving agents/workers/clients reconnect-and-
        replay on their own."""
        if self._head is None:
            raise RuntimeError(
                "restart_head needs an external head: pass head="
                "Cluster(external_head=True) (or attach_head it)")
        return self._head.restart_head()

    # ------------------------------------------------------------ admin --
    def stats(self) -> Dict[str, int]:
        out = {"chaos_kills": 0, "net_faults": 0}
        try:
            with self._rt.lock:
                out["chaos_kills"] = self._rt.chaos_kills
        except AttributeError:
            # Client-runtime controller (external head): the cluster
            # counter lives server-side — transfer_stats() has it.
            pass
        with self._lock:
            out["head_kills"] = self._head_kills
            if self._net is not None:
                out["net_faults"] = self._net.stats()["net_faults"]
        return out

    def stop(self):
        with self._lock:
            self._stopped = True
            timers, self._timers = self._timers, []
            self._sync_actions.clear()
            self._pending.clear()
            net, self._net = self._net, None
        for t in timers:
            t.cancel()
        recovery.set_chaos_hook(None)
        if net is not None:
            net.uninstall()  # stalled threads resume; rules lift
        self._pending_ev.set()

    def __enter__(self):
        return self

    def __exit__(self, *exc_info):
        self.stop()
        return False
