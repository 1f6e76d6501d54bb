"""Per-node agent process — the raylet-analog for non-head hosts.

The reference runs one raylet per node (``src/ray/raylet/main.cc:318``,
``node_manager.h:115``): it registers with the GCS, spawns language workers
on demand, and embeds the local object store.  This agent is the condensed
TPU-era equivalent:

- dials the head's TCP listener and registers its node (resources, labels,
  object-store id) — reference: ``NodeManager::RegisterGcs``;
- spawns worker processes when the head's scheduler leases one here
  (reference: ``worker_pool.cc``); workers dial the head directly, so the
  agent stays out of the task hot path;
- runs an OBJECT SERVER on its own TCP listener: consumers on other nodes
  (and the driver) pull segments directly as 1 MB chunk streams — the
  head brokers locations only (``ObjectManager::Push/Pull``,
  ``object_manager.h:117,206``; chunking per ``object_buffer_pool.h``);
- still serves head-relayed ``read_segment`` as the fallback path.

Run: ``python -m ray_tpu_torch._private.node_agent`` with RAY_TPU_HEAD_ADDRESS /
RAY_TPU_AUTHKEY / RAY_TPU_AGENT_* env vars (see cluster_utils.Cluster).

Wire contract: the agent-plane verbs (``agent_ready``/``agent_ack``,
``spawn_worker``/``kill_worker``/``kill_worker_hard``,
``read_segment``/``segment``, ``unlink_segment``, ``oom_pressure``,
``worker_logs``, ``shutdown``, and the elastic-drain pair
``preempt_notice``/``drain_node`` — caps family ``drain_caps``,
advertised both ways) are declared in ``protocol.VERBS`` and
machine-checked against this module's send/handle sites by
``python -m ray_tpu_torch.devtools.protocheck``.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import time
from multiprocessing.connection import Listener
from typing import Dict

from ray_tpu_torch._private import object_transfer, protocol, recovery
from ray_tpu_torch._private.cards import cuda_visible_devices
from ray_tpu_torch._private.shm_store import ShmStore


class _AgentStoreProxy:
    """Store view that always resolves the agent's CURRENT store — it is
    re-created with the session id after the head's ack, and the object
    server may accept consumers on both sides of that.  Reads attach;
    the only write path is the direct-put reservation (pushed values
    land here as public segments for this node's workers)."""

    def __init__(self, agent: "NodeAgent"):
        self._agent = agent

    def attach(self, name: str):
        return self._agent.store.attach(name)

    def reserve_put(self, oid_bin: bytes, total: int):
        return self._agent.store.reserve_put(oid_bin, total)


class NodeAgent:
    def __init__(self, head_address: str, authkey: bytes,
                 resources: Dict[str, float], shm_dir: str,
                 labels: Dict[str, str]):
        self.head_address = head_address
        self.authkey = authkey
        self.resources = resources
        self.labels = labels
        self.store_id = os.urandom(8).hex()
        self.shm_dir = shm_dir
        os.makedirs(shm_dir, exist_ok=True)
        # Attach-only store; re-created with the session id after the head
        # acks registration (the object server may get connections first).
        self.store = ShmStore(shm_dir=shm_dir)
        self.conn = None
        self.send_lock = threading.Lock()  # lock-order: io-guard
        self.workers: Dict[str, subprocess.Popen] = {}
        self.session = ""
        # Set once the head's agent_ack has been processed.  The memory
        # monitor gates on THIS, not on the config dict's truthiness — an
        # empty {} handshake payload must still arm the monitor (gating
        # on the dict left the thread spinning forever and the remote OOM
        # monitor silently disabled).
        self.head_config: Dict = {}
        self._handshake_done = threading.Event()
        self._stopped = False
        # Elastic drain state: a preemption notice (SIGTERM with
        # RAY_TPU_PREEMPT_SIGTERM=1, SIGUSR1, provider poll, chaos
        # "preempt") starts ONE self-drain; _drain_done releases it when
        # the head's drain_node ack lands (or the deadline expires and
        # the plug pulls).
        self._drain_lock = threading.Lock()
        self._draining = False
        self._drain_done = threading.Event()
        # Object server: direct chunked pulls from this node's store
        # (reference: the per-node object manager's transfer port).
        host = os.environ.get("RAY_TPU_AGENT_LISTEN_HOST", "127.0.0.1")
        self._obj_listener = Listener((host, 0), "AF_INET", backlog=64,
                                      authkey=authkey)
        # Advertise an address other hosts can reach: binding 0.0.0.0 (a
        # real multi-host cluster) must not advertise the bind address.
        adv = os.environ.get("RAY_TPU_AGENT_ADVERTISE_HOST")
        if adv is None:
            adv = host
            if adv == "0.0.0.0":
                import socket

                adv = socket.gethostbyname(socket.gethostname())
        port = self._obj_listener.address[1]
        self.object_addr = protocol.format_address((adv, port))
        threading.Thread(target=self._object_server, daemon=True,
                         name="agent-objsrv").start()
        threading.Thread(target=self._memory_monitor, daemon=True,
                         name="agent-memmon").start()
        threading.Thread(target=self._log_tailer, daemon=True,
                         name="agent-logmon").start()
        # Provider-poll preemption notice (the GCE metadata-server
        # analog): when RAY_TPU_PREEMPT_FILE names a path, its
        # appearance is the warning — self-drain starts the moment the
        # poller sees it.  Off (no thread) when unset.
        if os.environ.get("RAY_TPU_PREEMPT_FILE"):
            threading.Thread(target=self._preempt_poller, daemon=True,
                             name="agent-preempt-poll").start()
        # Heartbeat floor (failure detection): one ("heartbeat", ...)
        # per health_check_period_s so head-side silence from this node
        # is a SIGNAL, not an idle link.  The thread starts
        # unconditionally and gates per-tick on the handshake-resolved
        # knobs (env wins per node, else the head's agent_ack config).
        threading.Thread(target=self._heartbeat_loop, daemon=True,
                         name="agent-heartbeat").start()

    def _heartbeat_loop(self):
        while not self._stopped and not self._handshake_done.wait(0.2):
            pass
        period = float(self._failover_knob("RAY_TPU_HEALTH_CHECK_PERIOD_S",
                                           "health_check_period_s", 5.0))
        on = self._failover_knob("RAY_TPU_FAILURE_DETECTION",
                                 "failure_detection", True)
        if not on or period <= 0:
            return
        while not self._stopped:
            time.sleep(period)
            if self.conn is None:
                continue
            try:
                self._send(("heartbeat", self.store_id))
            except Exception:
                pass  # head blip: the serve loop owns reconnects

    def _preempt_poller(self):
        path = os.environ["RAY_TPU_PREEMPT_FILE"]
        while not self._stopped:
            if os.path.exists(path):
                self.notice_preemption("provider_poll")
                return
            time.sleep(0.25)

    def _log_tailer(self):
        """Ship this node's worker log lines to the head in 0.5s batches
        (the remote half of the driver's log_monitor)."""
        from ray_tpu_torch._private.logtail import tail_worker_logs

        log_dir = os.path.join(self.shm_dir, "logs")
        offsets: Dict[str, int] = {}
        partial: Dict[str, bytes] = {}
        while not self._stopped:
            time.sleep(0.5)
            if self.conn is None:
                continue
            batch = tail_worker_logs(log_dir, offsets, partial)
            if batch:
                try:
                    self._send(("worker_logs", batch))
                except Exception:
                    pass

    def _memory_monitor(self):
        """Sample this node's memory; over threshold, report pressure to
        the head, which picks and kills a victim among OUR workers
        (reference: memory_monitor.h sampling in the raylet; the policy
        runs centrally here because the task table is head-resident).
        Knobs come from the head's agent_ack (so ``_system_config``
        applies cluster-wide), overridable per node via the standard
        ``RAY_TPU_MEMORY_MONITOR_*`` env flags (config.py)."""
        from ray_tpu_torch._private import memmon
        from ray_tpu_torch._private.config import Config

        env_cfg = Config.from_env()
        while not self._stopped and not self._handshake_done.wait(0.2):
            pass  # wait for the agent_ack (explicit handshake flag)
        head_cfg = self.head_config

        def knob(name):
            env_val = getattr(env_cfg, name)
            default = getattr(Config, name)
            return env_val if env_val != default else head_cfg.get(
                name, default)

        threshold = float(knob("memory_monitor_threshold"))
        interval = float(knob("memory_monitor_interval_s"))
        test_file = str(knob("memory_monitor_test_file"))
        if threshold <= 0:
            return
        while not self._stopped:
            time.sleep(interval)
            if self.conn is None:
                continue
            try:
                frac = memmon.memory_usage_fraction(test_file)
                if frac >= threshold:
                    self._send(("oom_pressure", frac))
            except Exception:
                pass

    def _send(self, msg):
        with self.send_lock:
            protocol.send(self.conn, msg)

    def _failover_knob(self, env_name: str, cfg_key: str, default):
        """Env wins when explicitly set (the per-node escape hatch);
        else the head-pushed agent_ack config (so the head's
        ``_system_config`` governs the whole cluster); else default."""
        raw = os.environ.get(env_name)
        if raw is not None:
            if isinstance(default, bool):
                return raw.lower() in ("1", "true", "yes")
            return type(default)(raw)
        return self.head_config.get(cfg_key, default)

    def connect(self, reconnect: bool = False):
        addr = protocol.parse_address(self.head_address)
        if reconnect:
            # Failover grace window: the head may take a while to
            # restart; keep dialing until it expires.
            grace = self._failover_knob("RAY_TPU_HEAD_RECONNECT_GRACE_S",
                                        "head_reconnect_grace_s", 20.0)
            deadline = time.time() + max(1.0, grace)
            attempt = 0
            while time.time() < deadline:
                try:
                    # Deadline-aware dial (connect timeout +
                    # SO_KEEPALIVE): a black-holed head fails this
                    # attempt in net_connect_timeout_s instead of
                    # eating the whole grace window in one kernel-
                    # default connect.
                    self.conn = protocol.dial(addr, authkey=self.authkey)
                    break
                except (ConnectionError, OSError):
                    attempt += 1
                    time.sleep(min(1.0, 0.1 * (attempt + 1)))
        else:
            for attempt in range(40):
                try:
                    self.conn = protocol.dial(addr, authkey=self.authkey)
                    break
                except (ConnectionError, OSError):
                    time.sleep(0.1 * (attempt + 1))
        if self.conn is None:
            raise SystemExit("node agent: cannot reach head at "
                             + self.head_address)
        prev_node = getattr(self, "node_id_hex", "")
        prev_session = self.session
        self._send(("agent_ready", {
            "resources": self.resources,
            "labels": self.labels,
            "store_id": self.store_id,
            "shm_dir": self.shm_dir,
            "object_addr": self.object_addr,
            # Advertised object-server verbs beyond the original
            # "fetch" — consumers only send e.g. "fetch_range" (striped
            # pulls) to peers that declare it, so an old agent that
            # would silently ignore the verb is never probed with it.
            "object_caps": list(object_transfer.CAPS),
            # Agent-plane verbs beyond the original set: the head sends
            # drain_node only to agents declaring it (old agents fall to
            # the legacy hard teardown), and probes suspicion suspects
            # only when they declared hc_probe.
            "agent_caps": ["drain_node", "preempt_notice", "hc_probe"],
            "pid": os.getpid(),
            "hostname": os.uname().nodename,
            # Failover re-registration: a restarted head re-binds this
            # node under its OLD id (matched by store_id) so surviving
            # workers' node identity stays valid.
            "reconnect": bool(reconnect),
            "node_id": prev_node,
            "session": prev_session,
        }))
        msg = protocol.recv(self.conn)
        assert msg[0] == "agent_ack", msg
        self.node_id_hex = msg[1]
        self.session = msg[2]
        # Head-pushed config this node mirrors (memory monitor knobs);
        # the event marks handshake completion even when the payload is
        # empty (see _memory_monitor).
        self.head_config = msg[3] if len(msg) > 3 else {}
        self._handshake_done.set()
        if reconnect and self.session == prev_session \
                and self.node_id_hex == prev_node:
            # Same session, same node: the restarted head restored our
            # registration — keep the live store (and its capacity
            # accounting) and the surviving workers exactly as they are.
            return
        if reconnect and self.workers:
            # The head came back as a DIFFERENT cluster (no restore):
            # our workers belong to a dead session — tear them down, as
            # the pre-failover reconnect always did.
            self._terminate_workers()
        # Store for read_segment + direct-put ingest.  Segments here are
        # otherwise created by this node's workers; the agent allocates
        # only put reservations — under the same NODE capacity the
        # workers get (shared flock'd counter), so pushed ingest cannot
        # overcommit tmpfs past what local puts respect, and an
        # over-capacity reservation degrades to this node's spill dir.
        self.store = ShmStore(shm_dir=self.shm_dir, session_id=self.session,
                              capacity=self._node_store_bytes())
        # Same node-local spill dir this node's workers resolve
        # (worker_main): the env override when set, else the per-session
        # default — so degraded put ingest lands where local spills do.
        self.store.spill_dir = os.environ.get(
            "RAY_TPU_SPILL_DIR_OVERRIDE",
            f"/tmp/ray_tpu_spill_{self.session}")

    def _object_server(self):
        object_transfer.accept_loop(self._obj_listener,
                                    _AgentStoreProxy(self),
                                    lambda: self._stopped,
                                    "agent-objconn")

    def serve(self):
        while not self._stopped:
            try:
                msg = protocol.recv(self.conn)
            except (EOFError, OSError):
                # Head gone.  If it persists GCS state it may restart on
                # the same port: keep our workers ALIVE (head_failover —
                # they park and re-register on their own conns) and
                # re-dial for a grace period before giving the node up
                # (reference: workers reconnecting across GCS restart,
                # gcs_failover_worker_reconnect_timeout,
                # ray_config_def.h:62).
                if not self._reconnect():
                    break
                continue
            tag = msg[0]
            # Chaos syncpoint: one firing per control message lets a
            # RAY_TPU_CHAOS "agent:agent_msg:N" rule take this node down
            # deterministically mid-protocol (no-op unless armed).
            recovery.syncpoint("agent_msg")
            if tag == "spawn_worker":
                self._spawn_worker(msg[1], msg[2])
            elif tag == "kill_worker":
                self._kill_worker(msg[1])
            elif tag == "kill_worker_hard":
                # SIGKILL, no graceful terminate: the chaos harness's
                # worker-crash injection (a terminate lets atexit/finally
                # blocks run, which is not what real crashes do).
                self._kill_worker(msg[1], hard=True)
            elif tag == "read_segment":
                threading.Thread(target=self._read_segment,
                                 args=(msg[1], msg[2]), daemon=True).start()
            elif tag == "unlink_segment":
                # Owner freed an object homed here (the owner-driven
                # deletion of local_object_manager.h:41).
                self.store.unlink(msg[1], msg[2])
            elif tag == "hc_probe":
                # Suspicion probe: answer from THIS reader thread
                # immediately — liveness of the LINK and the process,
                # independent of whatever the node's workers compute.
                try:
                    self._send(("heartbeat", self.store_id))
                except Exception:
                    pass
            elif tag == "drain_node":
                # The head drained this node (scale-down order, or the
                # ack to our own preempt_notice): release any waiting
                # self-drain and exit cleanly — workers terminated,
                # listeners closed, a zero-surprise departure.
                self._drain_done.set()
                break
            elif tag == "shutdown":
                break
        self.shutdown()

    def _reconnect(self) -> bool:
        if not self._failover_knob("RAY_TPU_AGENT_RECONNECT",
                                   "agent_reconnect", True):
            return False
        keep = self._failover_knob("RAY_TPU_HEAD_FAILOVER",
                                   "head_failover", True)
        if not keep:
            # Legacy reconnect: the old session's workers hold dead head
            # conns and stale state — terminate before re-dialing.  With
            # failover ON the workers stay ALIVE (they park and
            # re-register on their own conns; worker PIDs survive the
            # blip), and connect() tears them down only if the head
            # comes back as a different cluster.
            self._terminate_workers()
        try:
            self.conn.close()
        except Exception:
            pass
        self.conn = None  # connect()'s retry-exhaustion guard needs this
        try:
            self.connect(reconnect=keep)
            return True
        except (SystemExit, Exception):
            if keep:
                # Grace exhausted with workers still up: fall through to
                # shutdown(), which terminates them — the legacy outage.
                pass
            return False

    def notice_preemption(self, source: str):
        """Preemption-notice entry point (signal handlers, the provider
        poller, chaos ``preempt``): hand off to a thread — the drain
        blocks on the head, and signal context must not."""
        threading.Thread(target=self._self_drain, args=(source,),
                         daemon=True, name="agent-self-drain").start()

    def _self_drain(self, source: str):
        """Deadline-bounded self-drain before the plug pulls: ask the
        head to drain this node (``preempt_notice``), wait for its
        ``drain_node`` release, then exit.  Degrades to the legacy
        immediate exit when the drain protocol is off, the head never
        advertised the verbs, or the deadline expires — exactly the
        no-warning preemption the hard-kill recovery already covers."""
        with self._drain_lock:
            if self._draining or self._stopped:
                return
            self._draining = True
        # Chaos syncpoint: "agent:preempt:n" rules kill THIS process
        # mid-warning-window — the notice-then-plug-pulled-early drill.
        recovery.syncpoint("preempt")
        deadline_s = float(self._failover_knob("RAY_TPU_DRAIN_DEADLINE_S",
                                               "drain_deadline_s", 10.0))
        on = self._failover_knob("RAY_TPU_ELASTIC_DRAIN",
                                 "elastic_drain", True)
        head_drain_caps = tuple(self.head_config.get("drain_caps") or ())
        if on and self.conn is not None \
                and "preempt_notice" in head_drain_caps:
            try:
                self._send(("preempt_notice", deadline_s, source))
                self._drain_done.wait(deadline_s)
            except Exception:
                pass
        self.shutdown()
        os._exit(0)

    def _terminate_workers(self):
        """terminate -> wait -> kill, as in shutdown(): a TPU worker
        mid-computation takes seconds to die, and new workers must not
        race it for the chips."""
        for proc in self.workers.values():
            try:
                proc.terminate()
            except Exception:
                pass
        deadline = time.time() + 3.0
        for proc in self.workers.values():
            try:
                proc.wait(timeout=max(0.1, deadline - time.time()))
            except Exception:
                try:
                    proc.kill()
                except Exception:
                    pass
        self.workers.clear()

    def _node_store_bytes(self) -> int:
        """THIS node's store cap: the explicit env override, else 80% of
        the store filesystem (so an uncapped node can't fill tmpfs and
        die — per-node spilling engages instead).  Shared by worker
        spawns and the agent's own put-reservation admission."""
        if "RAY_TPU_STORE_BYTES" in os.environ:
            return int(os.environ["RAY_TPU_STORE_BYTES"] or 0)
        import shutil as _shutil

        try:
            return int(_shutil.disk_usage(self.shm_dir).total * 0.8)
        except OSError:
            return 0

    def _spawn_worker(self, worker_id_hex: str, env_overrides: Dict[str, str]):
        env = dict(os.environ)
        env.update(env_overrides)
        # The head grants indices into this node's pool; they name cards
        # through THIS host's CUDA_VISIBLE_DEVICES, not the head's.
        env["CUDA_VISIBLE_DEVICES"] = cuda_visible_devices(
            c for c in env.pop("RAY_TPU_GRANTED_CHIPS", "").split(",") if c)
        env["RAY_TPU_SHM_DIR_OVERRIDE"] = self.shm_dir
        env["RAY_TPU_STORE_ID"] = self.store_id
        # THIS node's store policy wins over head defaults (see
        # _node_store_bytes) — and matches the agent's own put-ingest
        # admission gate.  An explicit env value is forwarded VERBATIM
        # ("0" means uncapped and must reach the workers as such).
        if "RAY_TPU_STORE_BYTES" in os.environ:
            env["RAY_TPU_STORE_BYTES"] = os.environ["RAY_TPU_STORE_BYTES"]
        else:
            cap = self._node_store_bytes()
            if cap:
                env["RAY_TPU_STORE_BYTES"] = str(cap)
        if "RAY_TPU_POOL_BYTES" in os.environ:
            env["RAY_TPU_POOL_BYTES"] = os.environ["RAY_TPU_POOL_BYTES"]
        pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        existing = env.get("PYTHONPATH", "")
        env["PYTHONPATH"] = (pkg_root + (os.pathsep + existing
                                         if existing else ""))
        # Per-worker log file; the agent's tailer ships new lines to the
        # head (reference: per-node log_monitor shipping to the driver).
        log_dir = os.path.join(self.shm_dir, "logs")
        os.makedirs(log_dir, exist_ok=True)
        log_f = open(os.path.join(log_dir, f"worker-{worker_id_hex}.log"),
                     "ab", buffering=0)
        proc = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch._private.worker_main"],
            env=env, cwd=pkg_root, stdout=log_f,
            stderr=subprocess.STDOUT)
        log_f.close()
        self.workers[worker_id_hex] = proc

    def _kill_worker(self, worker_id_hex: str, hard: bool = False):
        proc = self.workers.pop(worker_id_hex, None)
        if proc is not None:
            threading.Thread(target=self._reap, args=(proc, hard),
                             daemon=True).start()

    @staticmethod
    def _reap(proc, hard: bool):
        """terminate (kill when ``hard``) -> wait -> kill -> wait, off the
        reader thread: the worker is reaped, not left a zombie holding its
        pid, and one that outlives its terminate still dies, so that what
        it holds (a granted card) is released."""
        try:
            proc.kill() if hard else proc.terminate()
            try:
                proc.wait(timeout=3.0)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        except OSError:
            pass

    def _read_segment(self, rid, name: str):
        try:
            seg = self.store.attach(name)
            meta, bufs = seg.raw_parts()
            # Copy out before close: the reply pickles them anyway.
            payload = (bytes(meta), [bytes(b) for b in bufs])
            seg.close()
            self._send(("segment", rid, True, payload))
        except Exception as e:  # noqa: BLE001
            self._send(("segment", rid, False, repr(e)))

    def shutdown(self):
        if self._stopped:
            return
        self._stopped = True
        self._terminate_workers()
        try:
            self.conn.close()
        except Exception:
            pass
        try:
            self._obj_listener.close()
        except Exception:
            pass


def main():
    # Opt-in chaos rules for agent processes (RAY_TPU_CHAOS,
    # "agent:<point>:<n>"); zero cost when unset.
    recovery.maybe_arm_env_chaos("agent")
    # Net-chaos rules (RAY_TPU_CHAOS_NET, "agent:<point>:<action>:<n>"):
    # gray failures — stalls/drops/delays at the protocol seam instead
    # of kills.  Imported lazily so an unarmed agent never loads the
    # harness.
    if os.environ.get("RAY_TPU_CHAOS_NET"):
        from ray_tpu_torch import chaos as chaos_mod

        chaos_mod.maybe_arm_env_net_chaos("agent")
    agent = NodeAgent(
        head_address=os.environ["RAY_TPU_HEAD_ADDRESS"],
        authkey=bytes.fromhex(os.environ["RAY_TPU_AUTHKEY"]),
        resources=json.loads(os.environ.get("RAY_TPU_AGENT_RESOURCES",
                                            '{"CPU": 1.0}')),
        shm_dir=os.environ.get("RAY_TPU_AGENT_SHM_DIR",
                               f"/tmp/ray_tpu_node_{os.getpid()}"),
        labels=json.loads(os.environ.get("RAY_TPU_AGENT_LABELS", "{}")),
    )
    # Preemption notice sources (elastic pods): SIGUSR1 is always a
    # notice (the chaos harness's graceful ``preempt`` and the
    # launcher's forwarded warning); SIGTERM becomes one only under
    # RAY_TPU_PREEMPT_SIGTERM=1 — what an operator sets on a real spot
    # VM, where SIGTERM IS the warning — because the test/teardown
    # path SIGTERMs agents for plain shutdown.
    signal.signal(signal.SIGUSR1,
                  lambda *_: agent.notice_preemption("sigusr1"))
    if os.environ.get("RAY_TPU_PREEMPT_SIGTERM", "").lower() in (
            "1", "true", "yes"):
        signal.signal(signal.SIGTERM,
                      lambda *_: agent.notice_preemption("sigterm"))
    else:
        signal.signal(signal.SIGTERM,
                      lambda *_: agent.shutdown() or sys.exit(0))
    agent.connect()
    agent.serve()


if __name__ == "__main__":
    main()
