"""The cases of ``tests/test_serve.py``, run unchanged against the port's
copy of the serve control plane (``import ray_tpu_torch as ray``), but
for the HTTP proxy's port: 18473 in place of the reference test's 18472,
so that the two files can run at once.

Serve-layer tests (reference pattern: python/ray/serve/tests)."""

import time

import pytest

import ray_tpu_torch as ray
from ray_tpu_torch import serve


@pytest.fixture
def ray8():
    rt = ray.init(num_cpus=8)
    yield rt
    serve.shutdown()
    ray.shutdown()


def test_function_deployment(ray8):
    @serve.deployment
    def echo(body):
        return {"echo": body}

    handle = serve.run(echo)
    out = ray.get(handle.remote({"x": 1}))
    assert out == {"echo": {"x": 1}}


def test_class_deployment_with_state(ray8):
    @serve.deployment(num_replicas=1)
    class Counter:
        def __init__(self, start):
            self.n = start

        def __call__(self, body):
            self.n += 1
            return self.n

    handle = serve.run(Counter.bind(10))
    vals = [ray.get(handle.remote({})) for _ in range(3)]
    assert vals == [11, 12, 13]


def test_multiple_replicas_round_robin(ray8):
    @serve.deployment(num_replicas=2)
    class WhoAmI:
        def __call__(self, body):
            import os
            return os.getpid()

    handle = serve.run(WhoAmI.bind())
    pids = {ray.get(handle.remote({})) for _ in range(6)}
    assert len(pids) == 2


def test_scale_and_reconcile(ray8):
    @serve.deployment(num_replicas=1)
    class S:
        def __call__(self, body):
            return "ok"

    serve.run(S.bind(), name="s")
    controller = serve._get_controller() if hasattr(serve, "_get_controller") \
        else None
    from ray_tpu_torch.serve.api import _get_controller
    controller = _get_controller()
    ray.get(controller.scale.remote("s", 3))
    assert len(ray.get(controller.get_replicas.remote("s"))) == 3
    ray.get(controller.scale.remote("s", 1))
    assert len(ray.get(controller.get_replicas.remote("s"))) == 1


def test_dead_replica_replacement(ray8):
    @serve.deployment(num_replicas=2)
    class D:
        def __call__(self, body):
            return "alive"

    serve.run(D.bind(), name="d")
    from ray_tpu_torch.serve.api import _get_controller
    controller = _get_controller()
    reps = ray.get(controller.get_replicas.remote("d"))
    ray.kill(reps[0])
    time.sleep(0.3)
    counts = ray.get(controller.reconcile.remote())
    assert counts["d"] == 2


def test_http_proxy_end_to_end(ray8):
    import requests

    @serve.deployment(route_prefix="/classify")
    def classify(body):
        return {"label": "cat", "score": body.get("score", 0.5)}

    serve.run(classify)
    url = serve.start_http_proxy(port=18473)
    r = requests.post(f"{url}/classify", json={"score": 0.9}, timeout=10)
    assert r.status_code == 200
    assert r.json()["result"]["label"] == "cat"
    r404 = requests.get(f"{url}/nope", timeout=10)
    assert r404.status_code == 404


def test_background_reconcile_heals_without_deploy(ray8):
    """Kill a replica: the controller's OWN loop replaces it — no deploy,
    scale, or explicit reconcile call (reference: the continuously-running
    DeploymentStateManager.update loop, deployment_state.py:1855)."""
    @serve.deployment(num_replicas=2)
    class D:
        def __call__(self, body):
            return "alive"

    h = serve.run(D.bind(), name="heal")
    from ray_tpu_torch.serve.api import _get_controller
    controller = _get_controller()
    reps = ray.get(controller.get_replicas.remote("heal"))
    ray.kill(reps[0])
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline:
        if ray.get(controller.num_replicas.remote("heal")) == 2:
            # and requests flow again
            assert ray.get(h.remote({}), timeout=30) == "alive"
            return
        time.sleep(0.3)
    raise AssertionError("background loop never replaced the dead replica")


def test_autoscaling_up_and_down(ray8):
    """Queue depth above target doubles replicas; idle + downscale delay
    shrinks back to min (reference: autoscaling_policy.py)."""
    @serve.deployment(autoscaling_config={
        "min_replicas": 1, "max_replicas": 3,
        "target_ongoing_requests": 2, "downscale_delay_s": 2.0})
    class Slow:
        def __call__(self, body):
            time.sleep(0.4)
            return "ok"

    h = serve.run(Slow.bind(), name="auto")
    from ray_tpu_torch.serve.api import _get_controller
    controller = _get_controller()
    assert ray.get(controller.num_replicas.remote("auto")) == 1

    # sustained load: keep ~8 in flight for a few seconds
    stop = time.monotonic() + 6
    refs = []
    peak = 1
    while time.monotonic() < stop:
        refs = [r for r in refs
                if not ray.wait([r], num_returns=1, timeout=0)[0]]
        while len(refs) < 8:
            refs.append(h.remote({}))
        peak = max(peak, ray.get(controller.num_replicas.remote("auto")))
        time.sleep(0.2)
    assert peak >= 2, f"never scaled up (peak={peak})"
    for r in refs:
        ray.get(r, timeout=60)
    # idle: back to min after the downscale delay
    deadline = time.monotonic() + 25
    while time.monotonic() < deadline:
        if ray.get(controller.num_replicas.remote("auto")) == 1:
            return
        time.sleep(0.5)
    raise AssertionError("never scaled back down to min_replicas")


def test_rolling_update_changes_version(ray8):
    """Redeploying a changed callable rolls replicas to the new version
    while the deployment keeps serving."""
    @serve.deployment(num_replicas=2)
    class V:
        def __call__(self, body):
            return "v1"

    h = serve.run(V.bind(), name="roll")
    assert ray.get(h.remote({}), timeout=30) == "v1"

    @serve.deployment(num_replicas=2, name="V")
    class V2:
        def __call__(self, body):
            return "v2"

    h = serve.run(V2.bind(), name="roll")
    deadline = time.monotonic() + 30
    seen = set()
    while time.monotonic() < deadline:
        out = ray.get(h.remote({}), timeout=30)  # never errors mid-roll
        seen.add(out)
        if out == "v2":
            # drain: eventually ONLY v2 responds
            got = {ray.get(h.remote({}), timeout=30) for _ in range(8)}
            if got == {"v2"}:
                return
        time.sleep(0.3)
    raise AssertionError(f"rolling update never completed (saw {seen})")


def test_push_propagation_on_downscale(ray8):
    """After a downscale, no request lands on a
    retired replica — the handle learns by PUSH (long-poll), not TTL."""
    @serve.deployment(num_replicas=3)
    class Who:
        def __init__(self):
            import os

            self.pid = os.getpid()

        def __call__(self, body):
            return self.pid

    handle = serve.run(Who.bind())
    pids = {ray.get(handle.remote({})) for _ in range(30)}
    assert len(pids) == 3
    from ray_tpu_torch.serve.api import _get_controller

    ray.get(_get_controller().scale.remote(Who.name
                                           if hasattr(Who, "name")
                                           else "Who", 1))
    # Push should land well inside a second (no 2s TTL window).
    deadline = time.time() + 10
    while time.time() < deadline:
        with handle._lock:
            n = len(handle._replicas)
        if n == 1:
            break
        time.sleep(0.05)
    with handle._lock:
        assert len(handle._replicas) == 1
    after = {ray.get(handle.remote({})) for _ in range(20)}
    assert len(after) == 1


def test_serve_batch_coalesces(ray8):
    """@serve.batch: concurrent requests coalesce into list calls
    (reference: serve/batching.py)."""
    @serve.deployment(num_replicas=1)
    class Doubler:
        def __init__(self):
            self.calls = 0

        @serve.batch(max_batch_size=8, batch_wait_timeout_s=0.1)
        def handle_batch(self, items):
            self.calls += 1
            return [x * 2 for x in items]

        def __call__(self, body):
            return self.handle_batch(body)

        def n_calls(self, body):
            return self.calls

    handle = serve.run(Doubler.bind())
    refs = [handle.remote(i) for i in range(16)]
    vals = ray.get(refs, timeout=60)
    assert sorted(vals) == [i * 2 for i in range(16)]
    calls = ray.get(handle.method("call_method_is_not")
                    if False else handle.method("n_calls").remote({}))
    # 16 requests, batches of up to 8 -> far fewer underlying calls.
    assert calls <= 6, calls


def test_batch_leader_exception_fails_followers_not_hangs():
    """Pin: an exception landing in the LEADER before the
    batch runs (async kill, interrupted wait) must set every follower
    entry's event — nobody hangs forever."""
    import threading

    from ray_tpu_torch.serve.batching import _Batcher

    def fn(items):
        return [x * 2 for x in items]

    b = _Batcher(fn, None, max_batch_size=4, batch_wait_timeout_s=0.2)
    orig_wait = b._full.wait
    release = threading.Event()

    def dying_wait(timeout=None):
        release.wait(5)  # let followers enqueue first
        raise RuntimeError("async kill in the batching window")

    b._full.wait = dying_wait
    results = {}

    def leader():
        try:
            results["leader"] = ("ok", b.submit(1))
        except BaseException as e:  # noqa: BLE001 — recorded for asserts
            results["leader"] = ("err", e)

    def follower():
        b._full.wait = orig_wait  # only the first (leader) wait dies
        try:
            results["follower"] = ("ok", b.submit(2))
        except BaseException as e:  # noqa: BLE001 — recorded for asserts
            results["follower"] = ("err", e)

    lt = threading.Thread(target=leader)
    lt.start()
    time.sleep(0.05)  # leader is parked in the window
    ft = threading.Thread(target=follower)
    ft.start()
    time.sleep(0.05)
    release.set()
    lt.join(10)
    ft.join(10)
    assert not lt.is_alive() and not ft.is_alive(), "batch entry hung"
    assert results["leader"][0] == "err"
    assert results["follower"][0] == "err"
    assert "leader failed" in str(results["follower"][1])
    # The batcher stays usable: the next batch elects a fresh leader.
    assert b.submit(3) == 6


def test_batch_leader_death_rescued_by_follower_backstop(monkeypatch):
    """Pin: a HARD-killed leader (thread gone, no exception
    path ran) leaves its entries pending forever in the old code; the
    follower backstop must detect the dead leader and rescue-run the
    pending batch."""
    import threading

    from ray_tpu_torch.serve.batching import _Batcher, _Entry

    monkeypatch.setattr(_Batcher, "_BACKSTOP_S", 0.1)

    def fn(items):
        return [x * 10 for x in items]

    b = _Batcher(fn, None, max_batch_size=8, batch_wait_timeout_s=30.0)
    # Simulate the post-mortem state: a leader that appended its entry
    # and died before collecting the batch.
    dead = threading.Thread(target=lambda: None)
    dead.start()
    dead.join()
    orphan = _Entry(1)
    with b._lock:
        b._pending.append(orphan)
        b._leader = dead
    # A live follower joins the orphaned batch; its backstop must take
    # over leadership and run BOTH entries.
    assert b.submit(2) == 20
    assert orphan.event.is_set() and orphan.result == 10


def test_redeploy_same_name_ignores_stale_handle_metrics(ray8):
    """Pin: metric windows are keyed by (name, incarnation) —
    a handle from a DELETED deployment keeps reporting, but its samples
    must not feed the autoscaler of a same-name redeploy (the old
    controller keyed by name only and scaled the fresh deployment on
    the stale handle's ongoing count)."""
    from ray_tpu_torch.serve.api import _get_controller

    cfg = {"min_replicas": 1, "max_replicas": 4,
           "target_ongoing_requests": 1, "downscale_delay_s": 1.0}

    @serve.deployment(autoscaling_config=cfg)
    class A:
        def __call__(self, body):
            return "a"

    handle = serve.run(A.bind(), name="redeploy")
    controller = _get_controller()
    assert ray.get(handle.remote({})) == "a"
    stale_inc = ray.get(
        controller.deployment_incarnation.remote("redeploy"))
    ray.get(controller.delete_deployment.remote("redeploy"))

    @serve.deployment(autoscaling_config=cfg)
    class B:
        def __call__(self, body):
            return "b"

    handle2 = serve.run(B.bind(), name="redeploy")
    assert ray.get(handle2.remote({})) == "b"
    new_inc = ray.get(
        controller.deployment_incarnation.remote("redeploy"))
    assert new_inc == stale_inc + 1
    # A SURVIVING old handle re-keys itself: its long-poll carries the
    # new incarnation along with the replica set, so a handle that
    # keeps being used after a redeploy reports under the fresh key
    # instead of being dropped forever.
    deadline = time.monotonic() + 15
    while time.monotonic() < deadline:
        with handle._lock:
            if handle._incarnation == new_inc:
                break
        time.sleep(0.2)
    with handle._lock:
        assert handle._incarnation == new_inc
    # The stale handle screams "12 ongoing" (dangling refs against dead
    # replicas).  Keyed by incarnation, the report is dropped...
    assert ray.get(controller.record_handle_metric.remote(
        "redeploy", "stale-handle", 12, stale_inc)) is False
    for _ in range(3):
        ray.get(controller.reconcile.remote())
    assert ray.get(controller.num_replicas.remote("redeploy")) == 1
    # ...while a current-incarnation report still drives scaling.
    assert ray.get(controller.record_handle_metric.remote(
        "redeploy", "live-handle", 4, new_inc)) is True
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        ray.get(controller.reconcile.remote())
        if ray.get(controller.num_replicas.remote("redeploy")) == 4:
            break
        time.sleep(0.2)
    assert ray.get(controller.num_replicas.remote("redeploy")) == 4
    stats = ray.get(controller.serving_stats.remote("redeploy"))
    assert stats["scale_ups"] >= 1


def test_least_loaded_routing_skews_away_from_busy(ray8):
    @serve.deployment(num_replicas=2)
    class Sleepy:
        def __call__(self, body):
            import os
            import time as _t

            _t.sleep(body.get("sleep", 0))
            return os.getpid()

    handle = serve.run(Sleepy.bind())
    # Saturate one replica with slow calls, then fire quick ones; the
    # quick ones should mostly land on the other replica.
    slow = [handle.remote({"sleep": 2.0}) for _ in range(6)]
    time.sleep(0.6)  # metrics period: in-flight counts materialize
    quick = ray.get([handle.remote({"sleep": 0}) for _ in range(10)],
                    timeout=60)
    assert len(set(quick)) >= 1  # sanity: quick calls completed fast
    ray.get(slow, timeout=60)
