"""The cases of ``tests/test_serve_proxies.py``, run unchanged against
the port's copy of the serve control plane, its proxies and its
``devtools.lockcheck`` (``import ray_tpu_torch as ray``).

Per-node Serve proxies (reference: serve.start(proxy_location=
"EveryNode") — one HTTPProxyActor per node, _private/http_proxy.py:415;
routing state shared via the controller's route table) and the
data-plane RequestProxy tier (serve.start(num_proxies=N)): steady-state
serving traffic rides the DirectCaller actor channels, producing zero
head_brokered_submits."""
import json
import os
import subprocess
import sys
import textwrap
import time
import urllib.request

import pytest

import ray_tpu_torch as ray
from ray_tpu_torch import serve


@pytest.fixture
def two_node_cluster():
    rt = ray.init(num_cpus=2)
    rt.add_node(num_cpus=2)
    yield rt
    serve.shutdown()
    ray.shutdown()


def _post(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def test_every_node_proxies_serve_requests(two_node_cluster):
    @serve.deployment(num_replicas=2, route_prefix="/echo")
    def echo(body):
        return {"echo": body.get("x", 0) * 2}

    urls = serve.start(proxy_location="EveryNode")
    assert len(urls) == 2, urls
    assert len(set(urls)) == 2  # distinct ports (in-process nodes)

    serve.run(echo)
    for i, url in enumerate(urls):
        out = _post(url + "/echo", {"x": 10 + i})
        assert out["result"]["echo"] == (10 + i) * 2, (url, out)

    # Unknown route 404s on every proxy.
    for url in urls:
        try:
            _post(url + "/nope", {})
            assert False, "expected 404"
        except urllib.error.HTTPError as e:
            assert e.code == 404


def test_proxies_land_on_distinct_nodes(two_node_cluster):
    serve.start(proxy_location="EveryNode")
    proxies = serve.api._state["node_proxies"]
    nodes = ray.get([p.node_id.remote() for p in proxies])
    assert len(set(nodes)) == 2, nodes


# -- data-plane RequestProxy tier -------------------------------------------

@pytest.fixture
def ray4():
    rt = ray.init(num_cpus=4)
    yield rt
    serve.shutdown()
    ray.shutdown()


def test_request_proxies_route_and_head_brokered_stays_flat(ray4):
    """THE proxy-tier observable: steady-state serving over
    serve.start(num_proxies=N) adds ZERO head_brokered_submits — every
    proxy→replica call rides the DirectCaller actor channels; the head
    sees only actor resolution (warm-up) and control messages."""
    urls = serve.start(proxy_location="Disabled", num_proxies=2)
    assert urls == []

    @serve.deployment(num_replicas=2, max_concurrency=16)
    class Echo:
        def __call__(self, body):
            return {"echo": body["x"] * 2}

    handle = serve.run(Echo.bind(), name="echo")
    assert isinstance(handle, serve.ProxiedDeploymentHandle)
    # Warm-up: resolve proxy + replica actor channels (first calls may
    # legitimately fall back to the head) and let two reconcile ticks
    # (health checks, metric reports) run so their channels settle too.
    out = ray.get([handle.remote({"x": i}) for i in range(8)],
                  timeout=120)
    assert [o["echo"] for o in out] == [2 * i for i in range(8)]
    time.sleep(2.2)
    before = ray4.transfer_stats()["head_brokered_submits"]
    out = ray.get([handle.remote({"x": i}) for i in range(40)],
                  timeout=120)
    assert [o["echo"] for o in out] == [2 * i for i in range(40)]
    after = ray4.transfer_stats()["head_brokered_submits"]
    assert after == before, (
        f"steady-state serving brokered {after - before} submits "
        f"through the head")
    stats = serve.serving_stats()
    assert stats["_proxies"]["count"] == 2
    assert sum(r or 0 for r in stats["_proxies"]["routed"]) >= 48


def test_proxied_handle_spreads_over_proxies(ray4):
    """Power-of-two-choices at the handle keeps both proxies in play
    (round-robin floor guarantees spread on an idle tier)."""
    serve.start(proxy_location="Disabled", num_proxies=2)

    @serve.deployment(num_replicas=1, max_concurrency=16)
    def hello(body):
        return "hi"

    handle = serve.run(hello.bind(), name="hello")
    assert set(ray.get([handle.remote({}) for _ in range(12)],
                       timeout=120)) == {"hi"}
    proxies = serve.api._state["request_proxies"]
    routed = [ray.get(p.proxy_stats.remote(), timeout=30)["routed"]
              for p in proxies]
    assert all(r > 0 for r in routed), routed
    # method() routing rides the proxy tier too.
    assert ray.get(handle.method("__call__").remote({}), timeout=60) \
        == "hi"


def test_zero_cpu_actor_get_skips_blocked_envelope(ray4):
    """Proxy hot path: a worker whose actor holds NO positive
    resources (the RequestProxy shape, num_cpus=0) skips the
    blocked/unblocked head envelope around ray.get — it has no lease
    slot to release, so the pair was two head messages per routed
    request of pure chatter.  A CPU-holding actor must keep sending it
    (slot release while blocked is load-bearing)."""

    @ray.remote
    def produce():
        return 41

    @ray.remote(num_cpus=0)
    class ZeroCpu:
        def go(self):
            import ray_tpu_torch as ray
            return ray.get(produce.remote()) + 1

    @ray.remote(num_cpus=1)
    class OneCpu:
        def go(self):
            import ray_tpu_torch as ray
            return ray.get(produce.remote()) + 1

    def blocked_count(rt):
        with rt._handler_stats_lock:
            return {t: s[0] for t, s in rt._handler_stats.items()
                    }.get("blocked", 0)

    rt = ray4
    z = ZeroCpu.remote()
    assert ray.get(z.go.remote(), timeout=60) == 42  # warm (actor boot)
    time.sleep(0.3)
    before = blocked_count(rt)
    assert ray.get([z.go.remote() for _ in range(5)], timeout=60) \
        == [42] * 5
    time.sleep(0.3)
    assert blocked_count(rt) == before, "0-CPU actor sent blocked"

    o = OneCpu.remote()
    assert ray.get(o.go.remote(), timeout=60) == 42
    time.sleep(0.3)
    assert blocked_count(rt) > before, \
        "CPU-holding actor no longer reports blocked"


def test_serve_lockcheck_battery_over_proxies_and_continuous_batcher():
    """The concurrent multi-client serving battery — client
    actors fanning requests over the RequestProxy tier into a
    continuous-batching replica — re-run under RAY_TPU_LOCKCHECK=1 with
    zero lock-order cycles, plus the head-brokered-submits-flat
    assertion under the concurrent load."""
    code = textwrap.dedent("""
        import time
        import ray_tpu_torch as ray
        from ray_tpu_torch import serve
        from ray_tpu_torch.devtools import lockcheck
        from ray_tpu_torch._private import api_internal

        assert lockcheck.enabled()
        rt = ray.init(num_cpus=6)

        @serve.deployment(num_replicas=1, max_concurrency=24)
        class Decode:
            @serve.batch(mode="continuous", max_batch_size=4,
                         batch_wait_timeout_s=0.005)
            def step(self, slots):
                time.sleep(0.002)
                for s in slots:
                    if s.state is None:
                        s.state = {"n": 0, "need": s.request["tokens"]}
                    s.state["n"] += 1
                    if s.state["n"] >= s.state["need"]:
                        s.finish(s.state["n"])

            def __call__(self, body):
                return self.step(body)

        serve.start(proxy_location="Disabled", num_proxies=2)
        handle = serve.run(Decode.bind(), name="decode")

        @ray.remote
        class LoadGen:
            def run(self, proxies, n):
                import ray_tpu_torch as ray
                refs = [proxies[i % len(proxies)].handle_request.remote(
                            "decode", ({"tokens": 1 + i % 4},), None)
                        for i in range(n)]
                return ray.get(refs, timeout=120)

        proxies = serve.api._state["request_proxies"]
        # warm every channel, then measure the steady state
        gens = [LoadGen.remote() for _ in range(3)]
        ray.get([g.run.remote(proxies, 4) for g in gens], timeout=120)
        time.sleep(1.5)
        before = rt.transfer_stats()["head_brokered_submits"]
        out = ray.get([g.run.remote(proxies, 16) for g in gens],
                      timeout=180)
        assert [sorted(set(o)) for o in out] == [[1, 2, 3, 4]] * 3
        after = rt.transfer_stats()["head_brokered_submits"]
        assert after == before, (before, after)
        stats = serve.serving_stats("decode")
        assert stats["mode"] == "continuous" and stats["retired"] >= 48
        serve.shutdown()
        ray.shutdown()
        bad = lockcheck.violations()
        assert not bad, "lock-order violations: " + repr(bad)
        print("SERVE_LOCKCHECK_OK")
    """)
    env = dict(os.environ, RAY_TPU_LOCKCHECK="1", JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "SERVE_LOCKCHECK_OK" in proc.stdout
