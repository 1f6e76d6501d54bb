"""Serve control + data plane.

Reference call path (SURVEY.md §3.5): serve.run -> controller actor ->
DeploymentState reconciliation -> replica actors; request path: proxy/handle
-> router -> replica.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch as ray
from ray_tpu_torch import exceptions as exc
from ray_tpu_torch.remote_function import _bulk_submit

CONTROLLER_NAME = "SERVE_CONTROLLER"
# Disaggregated serving: the prefill pool of logical deployment ``name``
# is a controller-level twin deployment named ``name + PREFILL_SUFFIX``
# — all replica machinery (health checks, rolling updates, long-polled
# handle snapshots, draining) applies to it unchanged.
PREFILL_SUFFIX = "@prefill"


def _disagg_capable(cls_or_fn) -> bool:
    """A deployment class that can serve a split tier: it exports the
    prefill handoff AND the decode-side adoption verbs."""
    return (isinstance(cls_or_fn, type)
            and hasattr(cls_or_fn, "prefill_export")
            and hasattr(cls_or_fn, "disagg_generate"))


def _active_config():
    """The effective config: the runtime's (carries ``_system_config``
    overrides) when one is up, else the env-derived global.  The DRIVER
    reads knobs here — its module-level GLOBAL_CONFIG predates
    ray.init; worker-side readers (controller, proxies, replicas) get
    the same values via _worker_config_env."""
    from ray_tpu_torch._private import api_internal
    from ray_tpu_torch._private.config import GLOBAL_CONFIG

    rt = api_internal.get_runtime()
    return getattr(rt, "config", None) or GLOBAL_CONFIG


class ReplicaWrapper:
    """Runs the user callable inside a replica actor process."""

    def __init__(self, cls_or_fn, init_args, init_kwargs, role=None):
        if isinstance(cls_or_fn, type):
            self._callable = cls_or_fn(*init_args, **init_kwargs)
        else:
            self._callable = cls_or_fn
        # Pool tag for the disaggregated tier ("prefill"/"decode"; None
        # = monolithic).  Passed through to the callable so replicas
        # can specialize (tpu_replica.MeshShardedDecoder records it).
        self._role = role
        if role and hasattr(self._callable, "set_serve_role"):
            try:
                self._callable.set_serve_role(role)
            except Exception:
                pass

    def handle_request(self, args, kwargs):
        fn = self._callable
        if not callable(fn):
            fn = fn.__call__
        return fn(*args, **kwargs)

    def call_method(self, method, args, kwargs):
        return getattr(self._callable, method)(*args, **kwargs)

    def health_check(self):
        if hasattr(self._callable, "check_health"):
            self._callable.check_health()
        return True

    def serving_stats(self):
        """Batching observability: one stats dict per batcher attached
        to the user callable (legacy one-shot and continuous engines
        share the shape — steps/batch_occupancy/queued/admitted/
        retired), aggregated per deployment by the controller.  Each
        row is tagged with this replica's pool role so the controller
        can roll the saturation signals up PER POOL."""
        from ray_tpu_torch.serve.batching import _Batcher
        from ray_tpu_torch.serve.continuous import _ContinuousBatcher

        out = []
        holder = self._callable
        for v in list(vars(holder).values()) if hasattr(holder, "__dict__") \
                else []:
            if isinstance(v, (_Batcher, _ContinuousBatcher)):
                row = v.stats()
                row["role"] = self._role or "all"
                out.append(row)
        return out


@ray.remote
class ServeController:
    """Reference: serve/controller.py:69 + _private/deployment_state.py
    (DeploymentStateManager.update, :1855) — a BACKGROUND reconciliation
    loop continuously drives actual replica sets toward target state:
    dead replicas are replaced with no deploy call, autoscaling targets
    are recomputed from handle-reported queue depth
    (_private/autoscaling_policy.py), and version changes roll replicas
    one per tick (rolling update)."""

    RECONCILE_PERIOD_S = 1.0
    METRIC_LOOK_BACK_S = 3.0

    def __init__(self):
        # Autoscale smoothing window: overridable via _system_config /
        # RAY_TPU_SERVE_METRIC_LOOKBACK_S (the controller runs in a
        # worker, so the knob rides _worker_config_env).
        from ray_tpu_torch._private.config import GLOBAL_CONFIG

        self.METRIC_LOOK_BACK_S = GLOBAL_CONFIG.serve_metric_lookback_s
        self._default_downscale_delay_s = \
            GLOBAL_CONFIG.serve_downscale_delay_s
        self._deployments: Dict[str, Dict[str, Any]] = {}
        # name -> list of {"actor": handle, "version": int}
        self._replicas: Dict[str, List[Dict[str, Any]]] = {}
        # route prefix -> deployment name: controller-resident so EVERY
        # node's proxy serves the same routing table (reference: the
        # proxy's route table long-polled from the controller,
        # _private/http_proxy.py + long_poll.py ROUTE_TABLE key).
        self._routes: Dict[str, str] = {}
        # autoscaling inputs: (name, incarnation, handle_id) -> recent
        # (ongoing, ts) samples.  A short look-back window, not just the
        # last sample: instantaneous queue depth oscillates with
        # sampling phase (scale up -> queue drains faster -> next sample
        # reads low -> scale back down), so decisions smooth over
        # METRIC_LOOK_BACK_S (reference: look_back_period_s in
        # autoscaling_policy.py).  Keyed by the deployment INCARNATION
        # (bumped when a name is deleted and redeployed) so a stale
        # handle from a deleted deployment can never feed the fresh
        # deployment's autoscaler (its samples are dropped at record
        # time).
        self._handle_metrics: Dict[tuple, deque] = {}
        # name -> deploy generation; delete+redeploy under one name
        # yields a new incarnation.
        self._incarnations: Dict[str, int] = {}
        # Pool-saturation windows for the disaggregated tier, keyed
        # (name, metric key) — the SAME peak-over-lookback shape as the
        # handle metric windows: reconcile ticks sample each role
        # pool's replica batchers (admission_parks cumulative,
        # tokens_per_step instantaneous) and _pool_desired reads the
        # fresh samples.  record_pool_metric is also a public actor
        # method so tests can inject samples directly.
        self._pool_metrics: Dict[tuple, deque] = {}
        self._last_scale_up: Dict[str, float] = {}
        # Autoscaling observability: name -> [scale_up_events,
        # scale_down_events] (surfaced via serving_stats()).
        self._scale_events: Dict[str, List[int]] = {}
        # Retired replicas draining before the actual kill: handles stop
        # routing to them immediately (they leave get_replicas), but the
        # process lives past the handle-refresh TTL so in-flight requests
        # finish (reference: graceful_shutdown_wait_loop_s drain).
        self._draining: List[tuple] = []  # (actor, kill_at_monotonic)
        self._lock = threading.RLock()
        # Push-based handle updates (reference: _private/long_poll.py:185
        # LongPollHost): every replica-set mutation bumps the version and
        # wakes blocked wait_replicas calls; handles hold one such call
        # open at all times, so scaling/death/drain propagate in one
        # notify instead of a TTL window.
        self._replica_version: Dict[str, int] = {}
        self._version_cv = threading.Condition(self._lock)
        # Serializes whole reconcile ticks: the background loop thread and
        # an actor-method reconcile (deploy/scale) must not both spawn.
        self._reconcile_lock = threading.Lock()
        self._stopped = False
        threading.Thread(target=self._loop, daemon=True,
                         name="serve-reconcile").start()

    def _loop(self):
        while not self._stopped:
            time.sleep(self.RECONCILE_PERIOD_S)
            try:
                self.reconcile()
            except Exception:
                pass

    def deploy(self, name: str, payload: Dict[str, Any]):
        """payload: cls_or_fn, init_args/kwargs, num_replicas, resources,
        optional autoscaling_config.  A changed payload bumps the version;
        reconcile then rolls replicas over to it."""
        def _same(a, b):
            # Compare by pickled bytes: cls_or_fn crosses the wire by
            # value (cloudpickle), so two deploys of identical code
            # deserialize to distinct class objects that == treats as
            # different.  Byte equality is a sound idempotence check; a
            # false negative merely costs a (safe) rolling restart.
            from ray_tpu_torch._private import serialization as _ser

            keys = ("cls_or_fn", "init_args", "init_kwargs",
                    "num_replicas", "num_cpus", "num_tpus",
                    "autoscaling_config", "ray_actor_options", "role")
            try:
                return all(
                    _ser.dumps_inline(a.get(k)) == _ser.dumps_inline(
                        b.get(k)) for k in keys)
            except Exception:
                return False

        with self._lock:
            prev = self._deployments.get(name)
            if prev is not None and _same(prev, payload):
                return True  # idempotent redeploy: no rolling restart
            version = (prev["version"] + 1) if prev is not None else 1
            payload["version"] = version
            if prev is None and name not in self._incarnations:
                # First-ever deploy of this name.  (A redeploy after a
                # delete keeps the incarnation delete_deployment already
                # bumped — bumping at DELETE time, not redeploy time,
                # also invalidates still-live handles' reports during
                # the deleted window, so they cannot repopulate the
                # purged metric map.)
                self._incarnations[name] = 1
            self._deployments[name] = payload
        # Reconcile outside _lock: the tick takes _reconcile_lock then
        # _lock — holding _lock here would invert the order vs the
        # background loop and deadlock.
        self.reconcile()
        return True

    def delete_deployment(self, name: str):
        # A logical deployment's prefill twin dies with it (the twin is
        # never useful alone — its exports have no decode pool to land
        # in).  Cascade BEFORE taking the lock: the recursive call
        # reconciles on its own.
        if not name.endswith(PREFILL_SUFFIX):
            with self._lock:
                twin = name + PREFILL_SUFFIX in self._deployments
            if twin:
                self.delete_deployment(name + PREFILL_SUFFIX)
        with self._lock:
            self._deployments.pop(name, None)
            for key in [k for k in self._pool_metrics if k[0] == name]:
                self._pool_metrics.pop(key, None)
            # Drop the dead incarnation's autoscale state wholesale —
            # metric windows, scale counters, last-scale-up stamp — so
            # the next same-name deploy starts with a clean slate (a
            # stale _last_scale_up would gate the fresh deployment's
            # first downscale against the DEAD deployment's history).
            for key in [k for k in self._handle_metrics if k[0] == name]:
                self._handle_metrics.pop(key, None)
            self._scale_events.pop(name, None)
            self._last_scale_up.pop(name, None)
            # Bump NOW (not at redeploy): surviving handles' reports go
            # stale immediately and record_handle_metric drops them, so
            # the purge above cannot be undone by a live handle still
            # reporting between the delete and a redeploy.
            self._incarnations[name] = self._incarnations.get(name, 0) + 1
            reps = self._replicas.pop(name, [])
            # Routes to a deleted deployment 404 (proxies refresh the
            # table within their TTL) instead of erroring forever.
            for prefix in [p for p, n in self._routes.items()
                           if n == name]:
                self._routes.pop(prefix, None)
            self._bump_version_locked(name)
        for r in reps:
            try:
                ray.kill(r["actor"])
            except Exception:
                pass
        return True

    def _bump_version_locked(self, name: str):
        self._replica_version[name] = \
            self._replica_version.get(name, 0) + 1
        self._version_cv.notify_all()

    def record_handle_metric(self, name: str, handle_id: str,
                             ongoing: int,
                             incarnation: Optional[int] = None):
        """Handles report their in-flight request count — the autoscaling
        signal (reference: handle-side metrics pushed to the controller,
        _private/router.py + autoscaling_policy.py).  Samples are keyed
        by (name, incarnation, handle_id); a report carrying a stale
        incarnation (the handle predates a delete+redeploy of this name)
        is DROPPED — it describes requests against replicas that no
        longer exist and must not scale the fresh deployment."""
        now = time.monotonic()
        with self._lock:
            cur = self._incarnations.get(name, 0)
            if incarnation is None:
                incarnation = cur  # legacy caller: assume current
            if incarnation != cur:
                return False
            q = self._handle_metrics.get((name, incarnation, handle_id))
            if q is None:
                q = self._handle_metrics[
                    (name, incarnation, handle_id)] = deque(maxlen=32)
            q.append((ongoing, now))
        return True

    def deployment_incarnation(self, name: str) -> int:
        with self._lock:
            return self._incarnations.get(name, 0)

    def handle_snapshot(self, name: str):
        """One-RPC handle bootstrap: (replica_version, replicas,
        incarnation)."""
        with self._lock:
            return (self._replica_version.get(name, 0),
                    [r["actor"] for r in self._replicas.get(name, [])],
                    self._incarnations.get(name, 0))

    def _ongoing_locked(self, name: str, now: float) -> int:
        """Summed per-handle PEAK ongoing inside the look-back window —
        robust to sampling phase while load is sustained; an idle
        handle's samples age out and read 0 (downscale_delay then gates
        the shrink).  Only the CURRENT incarnation's windows count
        (record_handle_metric drops stale reports; windows recorded
        before a delete were purged there).  The single source for both
        the autoscaler and serving_stats()."""
        inc = self._incarnations.get(name, 0)
        ongoing = 0
        for (n, i, _h), samples in self._handle_metrics.items():
            if n != name or i != inc:
                continue
            fresh = [v for v, ts in samples
                     if now - ts < self.METRIC_LOOK_BACK_S]
            if fresh:
                ongoing += max(fresh)
        return ongoing

    def _spawn(self, d: Dict[str, Any], version: int):
        # Threaded replicas: concurrent requests are what @serve.batch
        # coalesces (reference: replicas default to many concurrent
        # queries, max_concurrent_queries).
        opts = {"num_cpus": d.get("num_cpus", 1),
                "max_concurrency": d.get("max_concurrency", 8)}
        if d.get("num_tpus"):
            opts["num_tpus"] = d["num_tpus"]
        # Extra actor options (elastic pods: a preemption-tolerant
        # deployment sets {"max_restarts": -1, "max_task_retries": -1}
        # so replicas ride the actor restart + in-flight replay path
        # instead of failing requests at the controller's replacement
        # latency).
        opts.update(d.get("ray_actor_options") or {})
        remote_cls = ray.remote(ReplicaWrapper)
        actor = remote_cls.options(**opts).remote(
            d["cls_or_fn"], d.get("init_args", ()),
            d.get("init_kwargs", {}), d.get("role"))
        return {"actor": actor, "version": version,
                "spawned": time.monotonic(), "ready": False}

    def record_pool_metric(self, name: str, key: str, value: float):
        """One pool-saturation sample ((value, ts) into the (name, key)
        window).  Fed by the reconcile tick's replica polls; public so
        tests can drive the pool autoscaler without real traffic."""
        now = time.monotonic()
        with self._lock:
            q = self._pool_metrics.get((name, key))
            if q is None:
                q = self._pool_metrics[(name, key)] = deque(maxlen=32)
            q.append((float(value), now))
        return True

    def _sample_pool_metrics(self, name: str, reps: List[Dict[str, Any]]):
        """Sample a role pool's saturation signals from its replica
        batchers (parallel, one short shared deadline — a wedged
        replica must not stall the reconcile tick)."""
        refs = []
        for r in reps:
            try:
                refs.append(r["actor"].serving_stats.remote())
            except Exception:
                pass
        done = ray.wait(refs, num_returns=len(refs),
                        timeout=1)[0] if refs else []
        parks = steps = toks = 0
        got = False
        for ref in done:
            try:
                rows = ray.get(ref, timeout=1)
            except Exception:
                continue
            for b in rows:
                got = True
                parks += b.get("admission_parks", 0)
                steps += b.get("steps", 0)
                toks += b.get("tokens_emitted", 0)
        if got:
            self.record_pool_metric(name, "admission_parks", parks)
            self.record_pool_metric(
                name, "tokens_per_step", toks / steps if steps else 0.0)

    def _pool_desired(self, name: str, d: Dict[str, Any],
                      cfg: Dict[str, Any], desired: int,
                      now: float) -> int:
        """Disaggregated pool-saturation scaling on top of the
        handle-ongoing target: a PREFILL pool grows while admission
        parks GREW inside the look-back window (requests are queuing on
        KV admission, not on request count), a DECODE pool grows while
        its tokens_per_step peak sits at/above the configured
        saturation target.  Both only raise ``desired`` — shrinking
        stays with the ongoing-based target + downscale delay."""
        role = d.get("role")
        if not role:
            return desired
        with self._lock:
            cur = len(self._replicas.get(name, []))

            def fresh(key):
                q = self._pool_metrics.get((name, key), ())
                return [v for v, ts in q
                        if now - ts < self.METRIC_LOOK_BACK_S]

            parks = fresh("admission_parks")
            tps = fresh("tokens_per_step")
        if role == "prefill" and cfg.get("scale_on_parks"):
            if len(parks) >= 2 and max(parks) > min(parks):
                desired = max(desired, cur + 1)
        if role == "decode" and cfg.get("target_tokens_per_step"):
            if tps and max(tps) >= float(cfg["target_tokens_per_step"]):
                desired = max(desired, cur + 1)
        return desired

    def _autoscale_target(self, name: str, d: Dict[str, Any]) -> int:
        cfg = d.get("autoscaling_config")
        if not cfg:
            return d.get("num_replicas", 1)
        now = time.monotonic()
        with self._lock:
            ongoing = self._ongoing_locked(name, now)
        target_per = max(cfg.get("target_ongoing_requests", 1), 1e-9)
        import math

        desired = math.ceil(ongoing / target_per)
        desired = self._pool_desired(name, d, cfg, desired, now)
        desired = max(cfg.get("min_replicas", 1),
                      min(cfg.get("max_replicas", 1), desired))
        cur = len(self._replicas.get(name, []))
        if desired > cur:
            fire = False
            with self._lock:
                # Deleted mid-tick: don't repopulate the state the
                # delete-time purge just cleared (a same-name redeploy
                # would inherit the dead deployment's scale-up stamp).
                if name in self._deployments:
                    self._last_scale_up[name] = now
                    self._scale_events.setdefault(name, [0, 0])[0] += 1
                    fire = True
            if fire:
                self._publish_scale_event(name, "up", d)
            return desired
        if desired < cur:
            # Downscale only after a quiet period (reference:
            # downscale_delay_s in autoscaling_policy.py).
            delay = cfg.get("downscale_delay_s",
                            self._default_downscale_delay_s)
            if now - self._last_scale_up.get(name, 0.0) < delay:
                return cur
            fire = False
            with self._lock:
                if name in self._deployments:
                    self._scale_events.setdefault(name, [0, 0])[1] += 1
                    fire = True
            if fire:
                self._publish_scale_event(name, "down", d)
        return desired

    def _publish_scale_event(self, name: str, direction: str,
                             d: Dict[str, Any]):
        """Feed the driver-side node autoscaler (elastic pods): scale
        events ride the worker->driver pubsub ("serve_scale" topic) and
        the head wakes any registered listener, so NODE-level scaling
        reacts to serve-level scaling within one reconcile tick instead
        of a polling interval.  The payload carries the replica resource
        shape for observability; the demand itself reaches the
        autoscaler as the queued replica-creation shapes.  Built and
        sent OUTSIDE the controller lock (socket IO)."""
        try:
            from ray_tpu_torch._private import serialization as _ser
            from ray_tpu_torch._private.worker_main import get_worker_runtime

            rt = get_worker_runtime()
            if rt is None:
                return  # in-process controller (unit tests): no pubsub
            shape = {"CPU": float(d.get("num_cpus", 1))}
            if d.get("num_tpus"):
                shape["TPU"] = float(d["num_tpus"])
            rt.publish_event("serve_scale", _ser.dumps_inline(
                {"deployment": name, "direction": direction,
                 "shape": shape}))
        except Exception:
            pass  # observability only: never fail a reconcile over it

    def reconcile(self):
        """One control-loop tick: health-check, replace dead, scale to
        target (static or autoscaled), roll one outdated replica."""
        with self._reconcile_lock:
            return self._reconcile_once()  # noqa: RTL505 -- the reconcile serializer is strictly OUTER to the controller lock; no path under _lock takes _reconcile_lock

    DRAIN_S = 3.0
    # A replica whose constructor has not returned yet (a model loading,
    # a card's context starting) answers no health check: it is kept, not
    # replaced, for this long after its spawn.  A replacement of a replica
    # still holding its accelerator could never be placed.
    START_TIMEOUT_S = 300.0

    def _retire(self, rep):
        with self._lock:
            self._draining.append(
                (rep["actor"], time.monotonic() + self.DRAIN_S))

    def _reap_draining(self):
        now = time.monotonic()
        with self._lock:
            due = [a for a, t in self._draining if t <= now]
            self._draining = [(a, t) for a, t in self._draining if t > now]
        for a in due:
            try:
                ray.kill(a)
            except Exception:
                pass

    def _reconcile_once(self):
        self._reap_draining()
        with self._lock:
            names = list(self._deployments)
        counts = {}
        for name in names:
            with self._lock:
                d = self._deployments.get(name)
                if d is None:
                    continue
                reps = list(self._replicas.get(name, []))
                version = d["version"]
            alive = []
            for r in reps:
                try:
                    ray.get(r["actor"].health_check.remote(), timeout=5)
                    r["ready"] = True
                    alive.append(r)
                    continue
                except exc.GetTimeoutError:
                    if not r.get("ready", True) and time.monotonic() - \
                            r["spawned"] < self.START_TIMEOUT_S:
                        alive.append(r)  # still starting
                        continue
                except Exception:
                    pass
                # Dead, hung or unhealthy: dropped and replaced below,
                # and killed after the drain, so that what it holds (a
                # granted card too) returns to the pool.
                self._retire(r)
            if d.get("role") and d.get("autoscaling_config"):
                # Role pools autoscale on batcher saturation too: feed
                # this tick's sample into the pool metric window.
                self._sample_pool_metrics(name, alive)
            target = self._autoscale_target(name, d)
            while len(alive) < target:
                alive.append(self._spawn(d, version))
            while len(alive) > target:
                self._retire(alive.pop())
            # Rolling update: one outdated replica per tick — spawn the
            # replacement first, then retire (drain) the old one, so
            # capacity never dips and in-flight requests finish
            # (reference: rolling updates in deployment_state).
            outdated = [r for r in alive if r["version"] != version]
            if outdated:
                alive.append(self._spawn(d, version))
                old = outdated[0]
                alive.remove(old)
                self._retire(old)
            with self._lock:
                if name in self._deployments:
                    prev_ids = [id(r["actor"])
                                for r in self._replicas.get(name, [])]
                    self._replicas[name] = alive
                    if prev_ids != [id(r["actor"]) for r in alive]:
                        self._bump_version_locked(name)
                    counts[name] = len(alive)
                    continue
            # Deleted mid-tick: nothing tracks these replicas anymore.
            for r in alive:
                try:
                    ray.kill(r["actor"])
                except Exception:
                    pass
        return counts

    def get_replicas(self, name: str):
        with self._lock:
            return [r["actor"] for r in self._replicas.get(name, [])]

    def get_replicas_versioned(self, name: str):
        with self._lock:
            return (self._replica_version.get(name, 0),
                    [r["actor"] for r in self._replicas.get(name, [])])

    def wait_replicas(self, name: str, seen_version: int,
                      timeout: float = 30.0):
        """Long-poll: block until the replica set changes past
        ``seen_version`` (or timeout), then return (version, replicas,
        incarnation) (reference: LongPollHost.listen_for_change,
        _private/long_poll.py:185).  The incarnation rides along so a
        handle surviving a delete+redeploy of its name re-keys its
        metric reports instead of feeding the controller stale-keyed
        samples forever."""
        deadline = time.monotonic() + timeout
        with self._version_cv:
            while self._replica_version.get(name, 0) <= seen_version:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                self._version_cv.wait(left)
            return (self._replica_version.get(name, 0),
                    [r["actor"] for r in self._replicas.get(name, [])],
                    self._incarnations.get(name, 0))

    def num_replicas(self, name: str) -> int:
        with self._lock:
            return len(self._replicas.get(name, []))

    def list_deployments(self):
        with self._lock:
            return {n: {"num_replicas": d.get("num_replicas", 1),
                        "version": d.get("version", 1),
                        "autoscaling": bool(d.get("autoscaling_config"))}
                    for n, d in self._deployments.items()}

    def serving_stats(self, name: Optional[str] = None):
        """Per-deployment serving observability (the transfer_stats()
        analog for the serve plane): queued/ongoing request counts,
        batch occupancy and step totals aggregated over the replicas'
        batchers, plus the autoscale scale-up/scale-down event pair."""
        now = time.monotonic()
        with self._lock:
            names = [name] if name is not None else list(self._deployments)
            if name is not None and not name.endswith(PREFILL_SUFFIX) \
                    and name + PREFILL_SUFFIX in self._deployments:
                # Single-name queries cover the logical deployment: the
                # prefill twin's pools fold into the base entry below.
                names.append(name + PREFILL_SUFFIX)
            snap = {}
            for n in names:
                ups, downs = self._scale_events.get(n, [0, 0])
                snap[n] = {
                    "replicas": [r["actor"]
                                 for r in self._replicas.get(n, [])],
                    "ongoing": self._ongoing_locked(n, now),
                    "scale_ups": ups,
                    "scale_downs": downs,
                }
        # Serving-memory counters (paged KV plane): summed across every
        # replica batcher; zero when the paged_kv knob is off or no
        # engine is attached (the batcher then omits the keys and
        # .get() keeps the zeros — the knob-off pin).
        _KV_SUM = ("kv_blocks_total", "kv_blocks_used", "prefix_hits",
                   "prefix_blocks_shared", "cow_copies", "spec_proposed",
                   "spec_accepted", "tokens_emitted", "admission_parks",
                   "admission_rejects", "kv_chains_exported",
                   "kv_chains_imported", "kv_chain_bytes_streamed")
        out = {}
        for n, s in snap.items():
            reps = s.pop("replicas")
            agg = {"replicas": len(reps), "queued": 0, "steps": 0,
                   "admitted": 0, "retired": 0, "step_errors": 0,
                   "batch_occupancy": 0.0, "max_batch_size": 0,
                   "kv_occupancy": 0.0, "tokens_per_step": 0.0, **s}
            agg.update({k: 0 for k in _KV_SUM})
            # Per-pool saturation rollup (the autoscaler's observable
            # inputs): replica rows are tagged with their pool role by
            # ReplicaWrapper ("all" when monolithic).
            pools: Dict[str, Dict[str, Any]] = {}
            occ_steps = 0.0
            modes = set()
            # Replica RPCs run OUTSIDE _lock (a saturated replica must
            # not wedge the controller) and are issued in PARALLEL with
            # one shared deadline — N unreachable replicas cost one 5s
            # wait, not N; whoever cannot answer in time is skipped and
            # the aggregate stays partial-but-live.
            refs = []
            for r in reps:
                try:
                    refs.append(r.serving_stats.remote())
                except Exception:
                    pass
            done = ray.wait(refs, num_returns=len(refs),
                            timeout=5)[0] if refs else []
            for ref in done:
                try:
                    rows = ray.get(ref, timeout=1)
                except Exception:
                    continue
                for b in rows:
                    agg["queued"] += b["queued"]
                    agg["steps"] += b["steps"]
                    agg["admitted"] += b["admitted"]
                    agg["retired"] += b["retired"]
                    agg["step_errors"] += b["step_errors"]
                    occ_steps += b["batch_occupancy"] * b["steps"]
                    # The mode string carries the paged flag
                    # ("continuous+paged"), so the rollup's mode/mixed
                    # logic reports the memory plane too.
                    modes.add(b["mode"])
                    agg["max_batch_size"] = max(agg["max_batch_size"],
                                                b["max_batch_size"])
                    for k in _KV_SUM:
                        agg[k] += b.get(k, 0)
                    p = pools.setdefault(b.get("role") or "all", {
                        "replicas": 0, "queued": 0, "steps": 0,
                        "tokens_emitted": 0, "admission_parks": 0,
                        "tokens_per_step": 0.0})
                    p["replicas"] += 1
                    p["queued"] += b["queued"]
                    p["steps"] += b["steps"]
                    p["tokens_emitted"] += b.get("tokens_emitted", 0)
                    p["admission_parks"] += b.get("admission_parks", 0)
            if modes:
                agg["mode"] = modes.pop() if len(modes) == 1 else "mixed"
            if agg["steps"]:
                agg["batch_occupancy"] = round(occ_steps / agg["steps"], 3)
                agg["tokens_per_step"] = round(
                    agg["tokens_emitted"] / agg["steps"], 3)
            if agg["kv_blocks_total"]:
                agg["kv_occupancy"] = round(
                    agg["kv_blocks_used"] / agg["kv_blocks_total"], 3)
            for p in pools.values():
                if p["steps"]:
                    p["tokens_per_step"] = round(
                        p["tokens_emitted"] / p["steps"], 3)
            agg["pools"] = pools
            out[n] = agg
        # Fold each prefill twin into its logical deployment's entry:
        # the twin's pool rollup appears under the base name's "pools"
        # and its chain-handoff stream counters add to the base (chains
        # stream FROM prefill replicas, imports count on decode ones).
        for tn in [k for k in list(out) if k.endswith(PREFILL_SUFFIX)]:
            base = tn[: -len(PREFILL_SUFFIX)]
            if base not in out:
                continue
            twin = out.pop(tn)
            out[base]["pools"].update(twin.get("pools", {}))
            out[base]["prefill_replicas"] = twin.get("replicas", 0)
            for k in ("kv_chains_exported", "kv_chain_bytes_streamed",
                      "admission_parks", "prefix_hits",
                      "prefix_blocks_shared"):
                out[base][k] = out[base].get(k, 0) + twin.get(k, 0)
        return out if name is None else out.get(name, {})

    def set_route(self, prefix: str, name: str):
        with self._lock:
            self._routes[prefix] = name
        return True

    def get_routes(self) -> Dict[str, str]:
        with self._lock:
            return dict(self._routes)

    def scale(self, name: str, num_replicas: int):
        with self._lock:
            self._deployments[name]["num_replicas"] = num_replicas
        self.reconcile()
        return True

    def stop(self):
        self._stopped = True
        return True


class _P2CRouterBase:
    """Shared power-of-two-choices routing state (used by replica
    handles AND proxy handles): live in-flight counts per target,
    incremented at dispatch, decremented by an idempotent weakref
    finalizer when the caller drops the result ref.  Subclasses own
    ``self._lock`` acquisition around the ``_locked`` helpers."""

    def _router_init(self):
        self._rr = itertools.count()
        # The prefill pool's tie-break counter must be SEPARATE: a
        # disagg dispatch ticks both pickers, and a shared counter's
        # stride-2 aliasing over a two-replica pool would propose the
        # same prefill replica on every tie.
        self._prefill_rr = itertools.count()
        self._lock = threading.Lock()
        self._inflight: Dict[int, int] = {}  # target key -> live count
        # Result-ref ids currently counted in _inflight: finalizers
        # decrement only while their ref is still counted, so a ref an
        # external reconcile already pruned cannot decrement twice and
        # erase another request's count.
        self._counted: Dict[bytes, int] = {}  # ref id -> target key
        # (weakref(result_ref), target key) per dispatched request: the
        # periodic ground-truth reconcile — finalizers only fire when
        # the caller DROPS a ref, so a completed-but-held ref would
        # otherwise read as in-flight forever and skew routing.
        self._outstanding: List[tuple] = []
        self._last_reconcile = 0.0
        # The count reported to the autoscaler: the most requests in
        # flight since the last reconcile (the pending count at the
        # reconcile alone misses a burst that completed in between).
        self._ongoing = 0
        self._peak = 0
        # Dropped-ref ids queued by the (LOCK-FREE) finalizer, drained
        # under _lock on the next pick/dispatch: CPython runs finalizers
        # synchronously at deallocation, which can happen in a frame
        # that already holds _lock (the reconcile's temporaries can be
        # the last strong reference) — taking the non-reentrant lock
        # there would self-deadlock the router.
        self._dead_refs: List[bytes] = []

    def _pick_two_locked(self, reps: List[Any], rr=None):
        """Two DISTINCT candidates (round-robin first — idle routers
        keep alternating — a random draw second), route to the
        less-loaded one, ties to the round-robin choice."""
        import random

        self._drain_dead_locked()
        i = next(rr if rr is not None else self._rr) % len(reps)
        j = random.randrange(len(reps))
        if j == i:
            j = (j + 1) % len(reps)
        a, b = reps[i], reps[j]
        if self._inflight.get(id(b), 0) < self._inflight.get(id(a), 0):
            return b
        return a

    def _dec_inflight(self, idbin: bytes):
        """Weakref finalizer for a result ref: the caller consumed (and
        dropped) the result — no longer in flight on its target.
        LOCK-FREE (list.append is GIL-atomic): see _dead_refs."""
        self._dead_refs.append(idbin)

    def _drain_dead_locked(self):
        """Apply queued finalizer decrements.  Runs at every pick and
        dispatch, under _lock."""
        while True:
            try:
                idbin = self._dead_refs.pop()
            except IndexError:
                return
            rkey = self._counted.pop(idbin, None)
            if rkey is None:
                continue
            for k in (rkey if isinstance(rkey, tuple) else (rkey,)):
                c = self._inflight.get(k, 0)
                if c <= 1:
                    self._inflight.pop(k, None)
                else:
                    self._inflight[k] = c - 1

    def _count_dispatch_locked(self, idbin: bytes, rkey):
        """``rkey`` is one target key or a tuple of them: a disagg
        dispatch counts against BOTH its decode and prefill picks, so
        p2c over the prefill pool sees a live load signal too."""
        self._drain_dead_locked()
        for k in (rkey if isinstance(rkey, tuple) else (rkey,)):
            self._inflight[k] = self._inflight.get(k, 0) + 1
        self._counted[idbin] = rkey

    # How often dispatch triggers the ground-truth reconcile (also the
    # handle's controller-metric cadence).
    _RECONCILE_PERIOD = 0.5

    def _finalize_on_drop(self, ref):
        import weakref

        weakref.finalize(ref, self._dec_inflight, ref.id().binary())

    def _note_dispatch(self, ref, target) -> bool:
        """Register one dispatched request: weak-track the result ref
        (the router must never pin results), bump the target's live
        count, arm the drop finalizer; every _RECONCILE_PERIOD also run
        the ground-truth reconcile and leave in ``self._ongoing`` the
        most requests in flight since the last one.  A client that
        sends bursts (8, wait for all, 8 again) reconciles at the first
        request of a burst, when 1 is pending.  Returns True when the
        reconcile ran."""
        import weakref

        now = time.monotonic()
        key = (tuple(id(t) for t in target)
               if isinstance(target, tuple) else id(target))
        with self._lock:
            self._outstanding.append((weakref.ref(ref), key))
            self._count_dispatch_locked(ref.id().binary(), key)
            self._peak = max(self._peak, len(self._counted))
            ran = now - self._last_reconcile >= self._RECONCILE_PERIOD
            if ran:
                self._last_reconcile = now
                pending = self._reconcile_outstanding_locked()
                self._ongoing = max(self._peak, pending)
                self._peak = pending
        self._finalize_on_drop(ref)
        return ran

    def _reconcile_outstanding_locked(self) -> int:
        """Ground-truth prune: drop completed/collected refs from the
        outstanding list and rebuild the in-flight counts AND the
        counted-ref map from the actually-pending refs (keeping the
        finalizers idempotent).  Returns the ongoing request count."""
        live = [(w(), k) for w, k in self._outstanding]
        live = [(r, k) for r, k in live if r is not None]
        if live:
            import ray_tpu_torch as _ray

            done, pending = _ray.wait(
                [r for r, _ in live], num_returns=len(live), timeout=0)
            pend_set = {r.id() for r in pending}
            self._outstanding = [
                (w, k) for w, k in self._outstanding
                if (r := w()) is not None and r.id() in pend_set]
        else:
            self._outstanding = []
        counts: Dict[int, int] = {}
        counted: Dict[bytes, Any] = {}
        for w, k in self._outstanding:
            for kk in (k if isinstance(k, tuple) else (k,)):
                counts[kk] = counts.get(kk, 0) + 1
            r = w()
            if r is not None:
                counted[r.id().binary()] = k
        self._inflight = counts
        self._counted = counted
        return len(self._outstanding)


class DeploymentHandle(_P2CRouterBase):
    """Router over replicas (reference: _private/router.py:262
    ReplicaSet / handle API).

    Replica-set changes arrive by PUSH: a background long-poll thread
    keeps one blocking ``wait_replicas`` call open at the controller
    (reference: LongPollClient, _private/long_poll.py:68), so a
    downscaled/drained replica stops receiving traffic the moment the
    controller retires it — no TTL window.  Routing is least-loaded
    power-of-two-choices on LIVE per-replica ongoing-request counts —
    the same metric the handle reports to the controller's autoscaler —
    incremented at dispatch and decremented when the caller's result
    ref dies (weakref finalizer), with the periodic ray.wait prune as
    the ground-truth reconciler (reference: the queue-length-aware
    replica scheduler in _private/router.py).
    """

    # Prefix-affinity granularity: prompts map to their chunk-aligned
    # prefixes; longest-match lookup walks chunk boundaries down.
    _AFFINITY_CHUNK = 8
    # LRU cap on the affinity table (a routing hint, not a registry).
    _AFFINITY_CAP = 512

    def __init__(self, name: str, controller):
        import os

        _CFG = _active_config()
        self._name = name
        self._controller = controller
        self._replicas: List[Any] = []
        self._version = -1
        self._incarnation = 0
        self._router_init()
        # Disaggregated routing state: with the split on, requests
        # divert to decode-orchestrated handoff once the prefill twin
        # has replicas; prefill choice is prefix-affinity over p2c.
        # The affinity lock is a documented LEAF (pinned in
        # tests/test_lockcheck.py): it guards only the table + counters
        # and never wraps an out-call.
        self._disagg = bool(_CFG.disaggregated_serving) \
            and not name.endswith(PREFILL_SUFFIX)
        self._affinity_on = bool(_CFG.prefix_affinity)
        self._prefill_name = name + PREFILL_SUFFIX
        self._prefill_replicas: List[Any] = []
        self._prefill_version = -1
        from collections import OrderedDict as _OD

        self._affinity: "_OD[tuple, bytes]" = _OD()  # chunk key -> actor id
        self._affinity_lock = threading.Lock()  # lock-order: leaf
        self._router_prefix_hits = 0
        self._router_prefix_misses = 0
        # Autoscaling signal: the router's outstanding-ref prune also
        # yields the ongoing count reported to the controller
        # (reference: handle-side num_queued/ongoing metrics feeding
        # autoscaling_policy.py).
        self._handle_id = os.urandom(4).hex()
        self._closed = False
        self._refresh()
        self._poller = threading.Thread(
            target=self._long_poll_loop, daemon=True,
            name=f"serve-handle-{name}")
        self._poller.start()
        if self._disagg:
            self._prefill_poller = threading.Thread(
                target=self._prefill_poll_loop, daemon=True,
                name=f"serve-handle-{name}-prefill")
            self._prefill_poller.start()

    def _refresh(self):
        ver, reps, inc = ray.get(
            self._controller.handle_snapshot.remote(self._name))
        with self._lock:
            self._version = ver
            self._replicas = reps
            self._incarnation = inc
        if self._disagg:
            pver, preps, _inc = ray.get(
                self._controller.handle_snapshot.remote(
                    self._prefill_name))
            with self._lock:
                if pver > self._prefill_version:
                    self._prefill_version = pver
                    self._prefill_replicas = preps

    def _long_poll_loop(self):
        while not self._closed:
            try:
                ver, reps, inc = ray.get(
                    self._controller.wait_replicas.remote(
                        self._name, self._version, 30.0),
                    timeout=40.0)
            except Exception:
                time.sleep(1.0)
                continue
            with self._lock:
                if ver > self._version:
                    self._version = ver
                    self._replicas = reps
                    self._incarnation = inc

    def _prefill_poll_loop(self):
        """Second long-poll, over the prefill twin's replica set: the
        disagg diversion engages only once the twin has replicas, so a
        handle created before the split deployed (or after the twin
        was deleted) keeps serving the monolithic path."""
        while not self._closed:
            try:
                ver, reps, _inc = ray.get(
                    self._controller.wait_replicas.remote(
                        self._prefill_name, self._prefill_version, 30.0),
                    timeout=40.0)
            except Exception:
                time.sleep(1.0)
                continue
            with self._lock:
                if ver > self._prefill_version:
                    self._prefill_version = ver
                    self._prefill_replicas = reps

    def close(self):
        """Stop the long-poll thread (handles replaced by
        get_deployment_handle's stale-swap would otherwise leak a
        poller holding a standing controller RPC forever)."""
        self._closed = True

    def _pick(self):
        with self._lock:
            if not self._replicas:
                pass  # fall through to the blocking refresh below
            else:
                reps = self._replicas
                if len(reps) == 1:
                    return reps[0]
                # Power-of-two-choices on the live ongoing-request
                # counts — the same metric this handle reports to the
                # controller's autoscaler.
                return self._pick_two_locked(reps)
        self._refresh()
        with self._lock:
            if not self._replicas:
                raise RuntimeError(
                    f"deployment {self._name} has no replicas")
            return self._replicas[next(self._rr) % len(self._replicas)]

    def _track(self, ref, replica):
        if self._note_dispatch(ref, replica):
            # Fire-and-forget: the metric must never block the data
            # path.  (_incarnation is a bare int read — a racing
            # long-poll update at worst sends one report the controller
            # drops as stale.)
            self._controller.record_handle_metric.remote(
                self._name, self._handle_id, self._ongoing,
                self._incarnation)
        return ref

    def _pick_prefill(self, prompt):
        """Prefix-affinity choice over the prefill pool: route to the
        replica that most recently served the LONGEST chunk-aligned
        prefix of ``prompt`` (its PrefixCache holds those blocks — the
        prefill there is mostly cache reuse), p2c on miss.  The picked
        replica is registered under every chunk boundary of the prompt
        so longer shared-prefix prompts keep landing with it."""
        with self._lock:
            reps = list(self._prefill_replicas)
        if not reps:
            return None
        by_id = {getattr(r, "_actor_id", id(r)): r for r in reps}
        chunk = self._AFFINITY_CHUNK
        keys: List[tuple] = []
        if isinstance(prompt, (list, tuple)) and prompt:
            keys = [tuple(prompt[: L * chunk])
                    for L in range(1, len(prompt) // chunk + 1)]
        pick = None
        if self._affinity_on and keys:
            with self._affinity_lock:
                for key in reversed(keys):  # longest match first
                    aid = self._affinity.get(key)
                    if aid is None:
                        continue
                    target = by_id.get(aid)
                    if target is None:
                        # Dead/retired replica: prune the stale hint.
                        self._affinity.pop(key, None)
                        continue
                    self._affinity.move_to_end(key)
                    self._router_prefix_hits += 1
                    pick = target
                    break
                else:
                    self._router_prefix_misses += 1
        if pick is None:
            if len(reps) == 1:
                pick = reps[0]
            else:
                with self._lock:
                    pick = self._pick_two_locked(
                        reps, rr=self._prefill_rr)
        if self._affinity_on and keys:
            aid = getattr(pick, "_actor_id", id(pick))
            with self._affinity_lock:
                for key in keys:
                    self._affinity[key] = aid
                    self._affinity.move_to_end(key)
                while len(self._affinity) > self._AFFINITY_CAP:
                    self._affinity.popitem(last=False)
        return pick

    def _remote_disagg(self, body: Dict[str, Any]):
        """Disaggregated dispatch: pick the prefill replica by prefix
        affinity and a decode replica by p2c, then hand the request to
        the DECODE side (``disagg_generate`` orchestrates prefill →
        chain stream → local decode) — the caller still holds exactly
        one result ref, and the chain itself rides the data plane
        between the two replica workers."""
        pre = self._pick_prefill(body.get("prompt"))
        dec = self._pick()
        ref = dec.call_method.remote(
            "disagg_generate", (body, pre, self._prefill_name), {})
        # Count the dispatch against BOTH picks: the prefill leg is a
        # prefix of the request's lifetime, and without a live count
        # p2c over the (decode-traffic-free) prefill pool would tie on
        # zero forever and pile every miss onto one replica.
        return self._track(ref, (dec, pre))

    def router_stats(self) -> Dict[str, int]:
        """Affinity routing counters (zero while the split is off)."""
        with self._affinity_lock:
            return {"router_prefix_hits": self._router_prefix_hits,
                    "router_prefix_misses": self._router_prefix_misses}

    def remote(self, *args, **kwargs):
        if self._disagg and not kwargs and len(args) == 1 \
                and isinstance(args[0], dict):
            with self._lock:
                ready = bool(self._prefill_replicas)
            if ready:
                return self._remote_disagg(args[0])
        replica = self._pick()
        return self._track(replica.handle_request.remote(args, kwargs),
                           replica)

    def method(self, method_name: str):
        handle = self

        class _M:
            def remote(self, *args, **kwargs):
                replica = handle._pick()
                return handle._track(replica.call_method.remote(
                    method_name, args, kwargs), replica)

        return _M()


@ray.remote
class RequestProxy:
    """Data-plane request proxy (the serving twin of the per-node HTTP
    proxies, minus HTTP): a worker-resident actor holding worker-side
    ``DeploymentHandle``s, so every replica call it routes rides the
    DirectCaller actor channels — request/response payloads move over
    the striped object plane and lease-granted dispatch, and steady-
    state serving traffic adds ZERO ``head_brokered_submits`` (the head
    sees only actor resolution + blocked/unblocked control messages).
    Callers reach it through :class:`ProxiedDeploymentHandle`.

    LOCK ORDER: ``_stats_lock`` is an independent leaf (counters only);
    ``_create_lock`` serializes first-request handle construction and
    is held across controller RPCs but never while another local serve
    lock is held.
    """

    def __init__(self):
        self._controller = ray.get_actor(CONTROLLER_NAME)
        self._handles: Dict[str, DeploymentHandle] = {}
        self._create_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self._routed = 0

    def ping(self):
        return True

    def _handle_for(self, name: str) -> DeploymentHandle:
        h = self._handles.get(name)  # GIL-atomic read; writes below
        if h is not None:
            return h
        with self._create_lock:
            h = self._handles.get(name)
            if h is None:
                h = self._handles[name] = DeploymentHandle(
                    name, self._controller)
        return h

    def handle_request(self, name: str, args, kwargs):
        with self._stats_lock:
            self._routed += 1
        h = self._handle_for(name)
        # Blocking get on a proxy thread (max_concurrency bounds the
        # concurrent request streams): the replica's result payload is
        # pulled over the data plane into this worker's store and
        # returned as this call's own result.
        return ray.get(h.remote(*args, **(kwargs or {})))

    def call_method(self, name: str, method: str, args, kwargs):
        with self._stats_lock:
            self._routed += 1
        h = self._handle_for(name)
        return ray.get(h.method(method).remote(*args, **(kwargs or {})))

    def proxy_stats(self):
        # Router counters summed OUTSIDE _stats_lock: router_stats()
        # takes each handle's affinity leaf lock, and nesting it under
        # _stats_lock would give this proxy's two leaves an ordering.
        hits = misses = 0
        for h in list(self._handles.values()):
            rs = h.router_stats()
            hits += rs["router_prefix_hits"]
            misses += rs["router_prefix_misses"]
        with self._stats_lock:
            return {"routed": self._routed,
                    "deployments": sorted(self._handles),
                    "router_prefix_hits": hits,
                    "router_prefix_misses": misses}


class ProxiedDeploymentHandle(_P2CRouterBase):
    """Caller-side handle that routes requests through the proxy tier
    (``serve.start(num_proxies=N)``) instead of calling replicas
    directly: proxy choice is power-of-two-choices on this handle's
    live in-flight counts, replica choice happens inside the proxy
    (its own p2c handle).  Drivers and external clients thus never
    touch replica actors; their single actor call lands on a proxy
    whose replica traffic stays on the direct data plane."""

    def __init__(self, name: str, proxies: List[Any]):
        if not proxies:
            raise ValueError("proxy tier is empty")
        self._name = name
        self._proxies = list(proxies)
        self._tier_gen = _state.get("proxy_tier_gen", 0)
        self._router_init()

    def _pick(self):
        reps = self._proxies
        if len(reps) == 1:
            return reps[0]
        with self._lock:
            return self._pick_two_locked(reps)

    def _track(self, ref, proxy):
        # Same dispatch bookkeeping as DeploymentHandle, minus the
        # controller metric (proxies report replica-side).
        self._note_dispatch(ref, proxy)
        return ref

    def remote(self, *args, **kwargs):
        p = self._pick()
        return self._track(
            p.handle_request.remote(self._name, args, kwargs), p)

    def method(self, method_name: str):
        handle = self

        class _M:
            def remote(self, *args, **kwargs):
                p = handle._pick()
                return handle._track(p.call_method.remote(
                    handle._name, method_name, args, kwargs), p)

        return _M()


class Deployment:
    """Result of @serve.deployment — bind/deploy surface (reference:
    serve/deployment.py)."""

    def __init__(self, cls_or_fn, name: str, num_replicas: int = 1,
                 num_cpus: float = 1, num_tpus: int = 0,
                 route_prefix: Optional[str] = None,
                 autoscaling_config: Optional[Dict[str, Any]] = None,
                 max_concurrency: int = 8,
                 ray_actor_options: Optional[Dict[str, Any]] = None,
                 role: Optional[str] = None,
                 prefill_replicas: int = 0):
        if role not in (None, "prefill", "decode"):
            raise ValueError(
                f"role must be 'prefill', 'decode' or None, got {role!r}")
        self._cls_or_fn = cls_or_fn
        self.name = name
        self.num_replicas = num_replicas
        self.num_cpus = num_cpus
        self.num_tpus = num_tpus
        self.route_prefix = route_prefix or f"/{name}"
        # Disaggregated serving: role pins this deployment to one side
        # of the prefill/decode split; prefill_replicas sizes the
        # auto-created prefill twin when serve.run splits a role-less
        # deployment under GLOBAL_CONFIG.disaggregated_serving.
        self.role = role
        self.prefill_replicas = prefill_replicas
        # {min_replicas, max_replicas, target_ongoing_requests,
        #  downscale_delay_s} (reference: serve AutoscalingConfig)
        self.autoscaling_config = autoscaling_config
        # Concurrent request threads per replica (reference:
        # max_concurrent_queries).  A continuous-batching replica wants
        # this ABOVE max_batch_size: callers park in the batcher, so
        # the thread pool bounds admission, not batch occupancy.
        self.max_concurrency = max_concurrency
        # Extra @ray.remote options for the replica actors (reference:
        # serve's ray_actor_options).  Elastic pods: {"max_restarts":
        # -1, "max_task_retries": -1} makes replicas preemption-
        # tolerant (restart + in-flight call replay).
        self.ray_actor_options = ray_actor_options
        self._init_args = ()
        self._init_kwargs = {}

    def options(self, **kw) -> "Deployment":
        d = Deployment(self._cls_or_fn, kw.get("name", self.name),
                       kw.get("num_replicas", self.num_replicas),
                       kw.get("num_cpus", self.num_cpus),
                       kw.get("num_tpus", self.num_tpus),
                       kw.get("route_prefix", self.route_prefix),
                       kw.get("autoscaling_config",
                              self.autoscaling_config),
                       kw.get("max_concurrency", self.max_concurrency),
                       kw.get("ray_actor_options",
                              self.ray_actor_options),
                       kw.get("role", self.role),
                       kw.get("prefill_replicas", self.prefill_replicas))
        d._init_args = self._init_args
        d._init_kwargs = self._init_kwargs
        return d

    def bind(self, *args, **kwargs) -> "Deployment":
        d = self.options()
        d._init_args = args
        d._init_kwargs = kwargs
        return d


def deployment(cls_or_fn=None, *, name: Optional[str] = None,
               num_replicas: int = 1, num_cpus: float = 1,
               num_tpus: int = 0, route_prefix: Optional[str] = None,
               autoscaling_config: Optional[Dict[str, Any]] = None,
               max_concurrency: int = 8,
               ray_actor_options: Optional[Dict[str, Any]] = None,
               role: Optional[str] = None, prefill_replicas: int = 0):
    """@serve.deployment (reference: serve/api.py deployment)."""

    def wrap(target):
        return Deployment(target, name or target.__name__, num_replicas,
                          num_cpus, num_tpus, route_prefix,
                          autoscaling_config, max_concurrency,
                          ray_actor_options, role, prefill_replicas)

    if cls_or_fn is not None:
        return wrap(cls_or_fn)
    return wrap


_state: Dict[str, Any] = {"controller": None, "proxy": None,
                          "handles": {}, "routes": {}}


def _get_controller():
    if _state["controller"] is None:
        _state["controller"] = ServeController.options(
            name=CONTROLLER_NAME, max_concurrency=64).remote()
    return _state["controller"]


def run(target: Deployment, *, name: Optional[str] = None
        ) -> DeploymentHandle:
    """Deploy + return a handle (reference: serve.run, api.py:458).

    Disaggregated split: with ``GLOBAL_CONFIG.disaggregated_serving``
    on and a role-less, disagg-capable target, ONE serve.run call
    deploys TWO pools behind the logical name — the base deployment
    becomes the decode pool and a ``<name>@prefill`` twin (sized by
    ``prefill_replicas``, default 1) runs prompt-only steps.  The
    returned handle routes requests decode-side with prefix-affinity
    prefill choice; an explicit ``role="prefill"`` deployment lands
    directly under the twin name (manual pool management)."""
    _CFG = _active_config()
    controller = _get_controller()
    dep_name = name or target.name
    role = target.role
    split = (_CFG.disaggregated_serving and role is None
             and _disagg_capable(target._cls_or_fn))
    if role == "prefill" and not dep_name.endswith(PREFILL_SUFFIX):
        dep_name = dep_name + PREFILL_SUFFIX
    payload = {
        "cls_or_fn": target._cls_or_fn,
        "init_args": target._init_args,
        "init_kwargs": target._init_kwargs,
        "num_replicas": target.num_replicas,
        "num_cpus": target.num_cpus,
        "num_tpus": target.num_tpus,
        "autoscaling_config": target.autoscaling_config,
        "max_concurrency": target.max_concurrency,
        "ray_actor_options": target.ray_actor_options,
        "role": "decode" if split else role,
    }
    ray.get(controller.deploy.remote(dep_name, payload))
    if split:
        twin = dict(payload)
        twin["role"] = "prefill"
        twin["num_replicas"] = target.prefill_replicas or 1
        ray.get(controller.deploy.remote(
            dep_name + PREFILL_SUFFIX, twin))
    # Route registered at the CONTROLLER so every node's proxy serves it
    # (the driver-thread proxy keeps its local copy too).
    ray.get(controller.set_route.remote(target.route_prefix, dep_name))
    old = _state["handles"].get(dep_name)
    if isinstance(old, DeploymentHandle):
        old.close()  # a redeploy replaces the cached handle: stop its poller
    handle = _make_handle(dep_name, controller)
    _state["handles"][dep_name] = handle
    _state["routes"][target.route_prefix] = handle
    return handle


def _make_handle(name: str, controller):
    """Proxy-tier routing when serve.start(num_proxies=N) ran; direct
    replica routing otherwise."""
    proxies = _state.get("request_proxies")
    if proxies:
        return ProxiedDeploymentHandle(name, proxies)
    return DeploymentHandle(name, controller)


def get_deployment_handle(name: str):
    h = _state["handles"].get(name)
    proxies = _state.get("request_proxies")
    stale = (proxies and isinstance(h, DeploymentHandle)) or \
        (not proxies and isinstance(h, ProxiedDeploymentHandle)) or \
        (isinstance(h, ProxiedDeploymentHandle)
         and h._tier_gen != _state.get("proxy_tier_gen", 0))
    if h is None or stale:
        if isinstance(h, DeploymentHandle):
            h.close()  # stop the replaced handle's long-poll thread
        nh = _make_handle(name, _get_controller())
        _state["handles"][name] = nh
        # The routes table may hold the SAME object (serve.run stores
        # one handle in both); the HTTP proxy reads routes directly, so
        # swap it there too — a closed handle's replica set is frozen.
        for prefix, rh in list(_state["routes"].items()):
            if rh is h:
                _state["routes"][prefix] = nh
        h = nh
    return h


def serving_stats(name: Optional[str] = None) -> Dict[str, Any]:
    """Per-deployment serving observability snapshot (the serve-plane
    analog of Runtime.transfer_stats()): replicas, queued/ongoing
    requests, batch occupancy + step totals from the replica batchers,
    autoscale scale-up/scale-down counters, and — when the proxy tier
    is running — per-proxy routed counts."""
    controller = _get_controller()
    out = ray.get(controller.serving_stats.remote(name))
    # Prefix-affinity routing counters live ROUTER-side (each handle
    # owns its table), so the rollup sums every router this driver can
    # see: its own direct handles plus the proxy tier's.
    r_hits = r_misses = 0
    for h in list(_state["handles"].values()):
        if isinstance(h, DeploymentHandle):
            rs = h.router_stats()
            r_hits += rs["router_prefix_hits"]
            r_misses += rs["router_prefix_misses"]
    proxies = _state.get("request_proxies")
    if proxies and name is None:
        # Parallel with ONE shared deadline (same pattern as the
        # controller's replica polls): N unreachable proxies cost one
        # 5s wait, not N serialized timeouts.
        refs = [p.proxy_stats.remote() for p in proxies]
        done = set(ray.wait(refs, num_returns=len(refs), timeout=5)[0])
        routed = []
        for ref in refs:
            try:
                ps = ray.get(ref, timeout=1) if ref in done else None
            except Exception:
                ps = None
            routed.append(ps["routed"] if ps else None)
            if ps:
                r_hits += ps.get("router_prefix_hits", 0)
                r_misses += ps.get("router_prefix_misses", 0)
        out["_proxies"] = {"count": len(proxies), "routed": routed}
    if name is None:
        out["_router"] = {"prefix_hits": r_hits,
                          "prefix_misses": r_misses}
    return out


def start_http_proxy(host: str = "127.0.0.1", port: int = 8000):
    """HTTP ingress (reference: HTTPProxyActor, _private/http_proxy.py:415).
    Runs an aiohttp server on a driver thread; routes by path prefix."""
    import asyncio

    from aiohttp import web

    async def handle(request: web.Request):
        path = "/" + request.path.strip("/").split("/")[0]
        h = _state["routes"].get(path)
        if h is None:
            return web.json_response({"error": "no such route"}, status=404)
        try:
            body = await request.json() if request.can_read_body else {}
        except Exception:
            body = {}
        loop = asyncio.get_event_loop()
        ref = h.remote(body)
        result = await loop.run_in_executor(None, lambda: ray.get(ref))
        return web.json_response({"result": result})

    app = web.Application()
    app.router.add_route("*", "/{tail:.*}", handle)
    runner = web.AppRunner(app)
    ready = threading.Event()
    state: Dict[str, Any] = {}

    def serve_thread():
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        loop.run_until_complete(runner.setup())
        site = web.TCPSite(runner, host, port)
        loop.run_until_complete(site.start())
        state["loop"] = loop
        ready.set()
        loop.run_forever()

    t = threading.Thread(target=serve_thread, daemon=True,
                         name="serve-http-proxy")
    t.start()
    ready.wait(10)
    _state["proxy"] = (t, runner, state)
    return f"http://{host}:{port}"


@ray.remote
class HTTPProxyActor:
    """Per-node HTTP ingress (reference: one HTTPProxyActor per node,
    _private/http_proxy.py:415 + proxy_state_manager).  Routes come from
    the controller's table; replica routing rides this proxy's own
    DeploymentHandles (push-updated, least-loaded) — requests never
    touch the driver."""

    _ROUTE_TTL_S = 2.0

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        import asyncio

        from aiohttp import web

        self._controller = ray.get_actor(CONTROLLER_NAME)
        self._handles: Dict[str, DeploymentHandle] = {}
        self._routes: Dict[str, str] = {}
        self._routes_ts = 0.0
        self._routes_lock = threading.Lock()

        def call_sync(path: str, body):
            """Route lookup + handle construction + replica call: every
            step may RPC the controller, so the WHOLE chain runs in the
            executor — any blocking call on the event loop would
            serialize this proxy's request stream."""
            dep = self._route_for(path)
            if dep is None:
                return None  # distinct from ("ok", None): a None RESULT
            h = self._handles.get(dep)
            if h is None:
                h = self._handles[dep] = DeploymentHandle(
                    dep, self._controller)
            return ("ok", ray.get(h.remote(body)))

        async def handle(request: web.Request):
            path = "/" + request.path.strip("/").split("/")[0]
            try:
                body = await request.json() if request.can_read_body \
                    else {}
            except Exception:
                body = {}
            loop = asyncio.get_event_loop()
            out = await loop.run_in_executor(None, call_sync, path, body)
            if out is None:
                return web.json_response({"error": "no such route"},
                                         status=404)
            return web.json_response({"result": out[1]})

        app = web.Application()
        app.router.add_route("*", "/{tail:.*}", handle)
        runner = web.AppRunner(app)
        ready = threading.Event()
        state: Dict[str, Any] = {}

        def serve_thread():
            try:
                loop = asyncio.new_event_loop()
                asyncio.set_event_loop(loop)
                loop.run_until_complete(runner.setup())
                site = web.TCPSite(runner, host, port)
                loop.run_until_complete(site.start())
                state["port"] = site._server.sockets[0].getsockname()[1]
            except BaseException as e:  # noqa: BLE001 — surfaced below
                state["error"] = e
                ready.set()
                return
            ready.set()
            loop.run_forever()

        threading.Thread(target=serve_thread, daemon=True,
                         name="serve-proxy").start()
        if not ready.wait(15):
            raise RuntimeError("proxy HTTP server failed to start (15s)")
        if "error" in state:
            raise RuntimeError(
                f"proxy HTTP server failed to start on "
                f"{host}:{port}") from state["error"]
        self._url = f"http://{host}:{state['port']}"

    def _route_for(self, path: str) -> Optional[str]:
        now = time.monotonic()
        with self._routes_lock:
            stale = now - self._routes_ts > self._ROUTE_TTL_S
            dep = self._routes.get(path)
        if stale:
            # Refresh on TTL only: unknown paths stay negative-cached
            # until then, so a 404 flood cannot serialize requests on
            # controller RPCs.
            routes = ray.get(self._controller.get_routes.remote())
            with self._routes_lock:
                self._routes = routes
                self._routes_ts = now
                dep = routes.get(path)
        return dep

    def url(self) -> str:
        return self._url

    def node_id(self) -> str:
        import ray_tpu_torch

        return ray_tpu_torch.get_runtime_context().node_id


def start(proxy_location: str = "HeadOnly", http_options: Optional[
        Dict[str, Any]] = None, num_proxies: int = 0) -> List[str]:
    """Start Serve ingress (reference: serve.start(proxy_location=...) —
    ProxyLocation.EveryNode runs one proxy per node).  Returns the proxy
    URLs.

    ``num_proxies=N`` additionally spawns N :class:`RequestProxy`
    actors — the non-HTTP data-plane tier: handles created AFTER this
    (serve.run / get_deployment_handle) route requests through them,
    keeping steady-state request traffic off the head (proxy→replica
    calls ride the DirectCaller actor channels).
    ``proxy_location="Disabled"`` skips HTTP ingress entirely (request
    proxies only)."""
    http_options = http_options or {}
    host = http_options.get("host", "127.0.0.1")
    port = int(http_options.get("port", 0))
    _get_controller()
    if num_proxies > 0:
        # A second start() replaces the tier: the OLD proxies are
        # killed (their handles' pollers would otherwise poll the
        # controller forever) and the tier generation bumps so cached
        # ProxiedDeploymentHandles re-resolve onto the new actors.
        old = _state.get("request_proxies") or []
        proxies = [RequestProxy.options(
            num_cpus=0, max_concurrency=32).remote()
            for _ in range(num_proxies)]
        ray.get(_bulk_submit([(p.ping, (), None) for p in proxies]))
        _state["request_proxies"] = proxies
        _state["proxy_tier_gen"] = _state.get("proxy_tier_gen", 0) + 1
        for p in old:
            try:
                ray.kill(p)
            except Exception:
                pass
        # Re-resolve every cached proxied handle onto the new tier —
        # the HTTP proxy thread reads _state["routes"] directly and
        # would otherwise dispatch onto the killed actors.  (Handles
        # the USER kept from a pre-replacement serve.run go stale;
        # re-fetch via get_deployment_handle after replacing the tier.)
        fresh: Dict[str, ProxiedDeploymentHandle] = {}
        for table in (_state["handles"], _state["routes"]):
            for key, h in list(table.items()):
                if isinstance(h, ProxiedDeploymentHandle):
                    nh = fresh.get(h._name)
                    if nh is None:
                        nh = fresh[h._name] = ProxiedDeploymentHandle(
                            h._name, proxies)
                    table[key] = nh
        # Existing direct handles keep working; fresh ones route through
        # the tier (get_deployment_handle re-resolves cached entries).
    if proxy_location == "Disabled":
        return []
    if proxy_location != "EveryNode":
        return [start_http_proxy(host, port or 8000)]
    proxies = []
    from ray_tpu_torch.util.scheduling_strategies import (
        NodeAffinitySchedulingStrategy,
    )

    for n in ray.nodes():
        if not n.get("alive", True):
            continue
        p = HTTPProxyActor.options(
            num_cpus=0,
            scheduling_strategy=NodeAffinitySchedulingStrategy(
                n["node_id"], soft=False)).remote(host, port)
        proxies.append(p)
    urls = ray.get(_bulk_submit([(p.url, (), None) for p in proxies]))
    _state["node_proxies"] = proxies
    return urls


def shutdown():
    for p in _state.pop("node_proxies", []) or []:
        try:
            ray.kill(p)
        except Exception:
            pass
    for p in _state.pop("request_proxies", []) or []:
        try:
            ray.kill(p)
        except Exception:
            pass
    if _state["controller"] is not None:
        try:
            for name in list(
                    ray.get(_state["controller"].list_deployments.remote())):
                ray.get(_state["controller"].delete_deployment.remote(name))
            ray.kill(_state["controller"])
        except Exception:
            pass
    proxy = _state.get("proxy")
    if proxy:
        try:
            proxy[2]["loop"].call_soon_threadsafe(proxy[2]["loop"].stop)
        except Exception:
            pass
    for h in _state["handles"].values():
        if isinstance(h, DeploymentHandle):
            h.close()
    _state.update({"controller": None, "proxy": None, "handles": {},
                   "routes": {}})
