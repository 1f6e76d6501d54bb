"""The cases of ``tests/test_disagg_serving.py``, run unchanged against
the port's copy of the serve control plane and its decoder (``import
ray_tpu_torch as ray``; deployments bound to ``device=["cpu"] * 8``: 8
projection shards, as the reference's decoder runs on its 8-device CPU
mesh; reference chains from ``device="cpu"``).

Disaggregated prefill/decode serving: KV-chain streaming over the
striped put path, prefix-affinity routing, per-pool observability, and
the chaos battery.

The battery pins the acceptance contract: with the
``disaggregated_serving`` knob on, one serve.run deploys a prefill twin
pool behind the logical name, prefill replicas export finished KV-block
chains as segment images streamed into the decode replica's node store
(counted in ``kv_chain_bytes_streamed``), decode replicas adopt the
blocks under their own allocator, and every decoded chain stays bitwise
the host reference.  With the knob OFF the deployment is the
byte-identical monolithic engine and every new counter is pinned zero.
A killed prefill replica re-prefills on a healthy pool member; a killed
decode replica leaks nothing prefill-side.  The pool autoscaler raises
a prefill pool on admission-park growth and a decode pool on
tokens_per_step saturation, via the controller metric windows.
"""

import time

import pytest

import ray_tpu_torch as ray
from ray_tpu_torch import serve
from ray_tpu_torch.serve.api import CONTROLLER_NAME, PREFILL_SUFFIX

DISAGG_CONF = {"paged_kv": True, "disaggregated_serving": True}


def _deploy(name, *, prefill_replicas=1, num_replicas=1, **dep_kw):
    from ray_tpu_torch.serve.gpu_replica import MeshShardedDecoder

    dep = serve.deployment(MeshShardedDecoder, name=name,
                           max_concurrency=16,
                           num_replicas=num_replicas,
                           prefill_replicas=prefill_replicas, **dep_kw)
    return serve.run(dep.bind(device=["cpu"] * 8), name=name)


def _pool_reps(name):
    """Live replica ActorHandles of a (possibly twin) deployment."""
    ctrl = ray.get_actor(CONTROLLER_NAME)
    _ver, reps, _inc = ray.get(ctrl.handle_snapshot.remote(name))
    return reps


def _kv_debug(rep):
    return ray.get(rep.call_method.remote("kv_debug", (), {}))


# -- the tentpole e2e: split pools, streamed chains, bitwise output ---------

def test_disagg_e2e_bitwise_streamed_chains_and_pool_rollup():
    """One serve.run under the knob => prefill twin + decode pool; every
    response is bitwise the host reference (imported page rows ARE the
    recomputed prefill rows); the chain counters move and the bytes ride
    the put path; serving_stats rolls the pools up per role and folds
    the twin into the logical name."""
    ray.init(num_cpus=6, _system_config=DISAGG_CONF)
    try:
        from ray_tpu_torch.serve.gpu_replica import MeshShardedDecoder

        handle = _deploy("disagg")
        shared = list(range(16))                 # 2 shared prefix blocks
        reqs = [{"prompt": shared + [i], "tokens": 1 + i % 5}
                for i in range(10)]
        outs = ray.get([handle.remote(r) for r in reqs], timeout=120)
        ref = MeshShardedDecoder(device="cpu")
        for r, out in zip(reqs, outs):
            assert out == ref.reference_decode(r["prompt"], r["tokens"])
        stats = serve.serving_stats("disagg")
        # Chain handoff counters: one export + one import per request,
        # bytes > 0 (pages crossed as a streamed segment, not inline).
        assert stats["kv_chains_exported"] >= len(reqs)
        assert stats["kv_chains_imported"] >= len(reqs)
        assert stats["kv_chain_bytes_streamed"] > 0
        # Per-pool rollup: the twin folded under the logical name.
        assert set(stats["pools"]) == {"prefill", "decode"}
        assert stats["pools"]["prefill"]["replicas"] == 1
        assert stats["pools"]["decode"]["replicas"] == 1
        assert stats["prefill_replicas"] == 1
        for pool in stats["pools"].values():
            assert "admission_parks" in pool
            assert "tokens_per_step" in pool
        # Decode emitted every token; prefill emitted none (prompt-only
        # steps finish before the emit phase).
        assert stats["pools"]["prefill"]["tokens_emitted"] == 0
        assert stats["pools"]["decode"]["tokens_emitted"] == \
            sum(r["tokens"] for r in reqs)
        # The shared prefix paid off router-side and the global rollup
        # carries the router counters.
        rs = handle.router_stats()
        assert rs["router_prefix_hits"] > 0
        agg = serve.serving_stats()
        assert agg["_router"]["prefix_hits"] == rs["router_prefix_hits"]
        # No unreleased exports once idle (blocks still resident belong
        # to the PrefixCache — deliberate retention, not a leak; the
        # chaos battery pins used==0 with caching off).
        for rep in _pool_reps("disagg" + PREFILL_SUFFIX):
            dbg = _kv_debug(rep)
            assert dbg["role"] == "prefill"
            assert dbg["exports_outstanding"] == 0
    finally:
        serve.shutdown()
        ray.shutdown()


def test_prefix_affinity_beats_random_routing():
    """Acceptance: affinity routing lands shared-prefix prompts on the
    prefill replica that already holds the chain — its engine-level
    prefix_hits must sit STRICTLY above the affinity-off (p2c/random)
    baseline on the identical workload, and the router's own hit
    counter only moves when affinity is on."""
    def run(affinity):
        ray.init(num_cpus=8, _system_config={
            **DISAGG_CONF, "prefix_affinity": affinity})
        try:
            handle = _deploy("aff", prefill_replicas=2)
            families = [list(range(100, 116)), list(range(200, 216)),
                        list(range(300, 316))]
            reqs = [{"prompt": fam + [i], "tokens": 2}
                    for i in range(6) for fam in families]
            # Serialized on purpose: a family's second request must
            # not race the first one's prefix registration, and both
            # pools hold all three families, so a concurrent burst
            # makes BOTH sides' hit counts schedule-dependent.
            for r in reqs:
                ray.get(handle.remote(r), timeout=120)
            hits = sum(_kv_debug(r)["prefix_hits"]
                       for r in _pool_reps("aff" + PREFILL_SUFFIX))
            return hits, handle.router_stats()
        finally:
            serve.shutdown()
            ray.shutdown()

    aff_hits, aff_router = run(True)
    rnd_hits, rnd_router = run(False)
    assert aff_router["router_prefix_hits"] > 0
    assert rnd_router["router_prefix_hits"] == 0
    assert aff_hits > rnd_hits, (aff_hits, rnd_hits)


# -- the off switch ---------------------------------------------------------

def test_disagg_off_monolithic_byte_identical_zero_counters():
    """Knob off (the default): the SAME deployment call is the
    monolithic paged engine — no twin deployment exists, the handle
    never diverts, outputs match the host reference bitwise, and every
    disaggregation counter (engine chain counters, router affinity
    counters, pool split) is pinned zero/absent."""
    ray.init(num_cpus=4, _system_config={"paged_kv": True})
    try:
        from ray_tpu_torch.serve.gpu_replica import MeshShardedDecoder

        handle = _deploy("mono")
        shared = list(range(16))
        reqs = [{"prompt": shared + [i], "tokens": 1 + i % 5}
                for i in range(10)]
        outs = ray.get([handle.remote(r) for r in reqs], timeout=120)
        ref = MeshShardedDecoder(device="cpu")
        for r, out in zip(reqs, outs):
            assert out == ref.reference_decode(r["prompt"], r["tokens"])
        stats = serve.serving_stats("mono")
        assert stats["kv_chains_exported"] == 0
        assert stats["kv_chains_imported"] == 0
        assert stats["kv_chain_bytes_streamed"] == 0
        assert set(stats["pools"]) == {"all"}
        assert "prefill_replicas" not in stats
        assert not handle._disagg
        rs = handle.router_stats()
        assert rs == {"router_prefix_hits": 0, "router_prefix_misses": 0}
        agg = serve.serving_stats()
        assert agg["_router"] == {"prefix_hits": 0, "prefix_misses": 0}
        ctrl = ray.get_actor(CONTROLLER_NAME)
        deps = ray.get(ctrl.list_deployments.remote())
        assert not any(n.endswith(PREFILL_SUFFIX) for n in deps), deps
        # Monolithic replica never exported/imported: no handoff state.
        (rep,) = _pool_reps("mono")
        dbg = _kv_debug(rep)
        assert dbg["chain"] == {"inline_fallbacks": 0,
                                "handoff_retries": 0}
        assert dbg["role"] is None
    finally:
        serve.shutdown()
        ray.shutdown()


def test_disagg_knobs_ride_worker_config_env():
    """The three knobs probe through _worker_config_env (the dict BOTH
    spawn paths consume — RTL504 keeps that invariant) so replica and
    controller workers rebuild the driver's _system_config from env."""
    from ray_tpu_torch._private import api_internal

    ray.init(num_cpus=2, _system_config={
        "disaggregated_serving": True,
        "kv_stream_stripe_threshold": 12345,
        "prefix_affinity": False})
    try:
        rt = api_internal.get_runtime()
        env = rt._worker_config_env()
        assert env["RAY_TPU_DISAGGREGATED_SERVING"] == "1"
        assert env["RAY_TPU_KV_STREAM_STRIPE_THRESHOLD"] == "12345"
        assert env["RAY_TPU_PREFIX_AFFINITY"] == "0"

        @ray.remote
        def probe():
            from ray_tpu_torch._private.config import GLOBAL_CONFIG
            return (GLOBAL_CONFIG.disaggregated_serving,
                    GLOBAL_CONFIG.kv_stream_stripe_threshold,
                    GLOBAL_CONFIG.prefix_affinity)

        assert ray.get(probe.remote(), timeout=60) == (True, 12345, False)
    finally:
        ray.shutdown()


# -- chaos ------------------------------------------------------------------

def test_chaos_killed_prefill_replica_reprefills_on_healthy_pool():
    """Kill one of two prefill replicas, then hand its (dead) handle to
    disagg_generate: the decode side's retry re-fetches the pool from
    the controller and re-prefills on the healthy member — the request
    completes bitwise-correct and the retry is counted.  (Any half-
    received chain on the decode node was aborted by the put path's
    reserving-connection-close cleanup, so the retry starts clean.)"""
    ray.init(num_cpus=8, _system_config=DISAGG_CONF)
    try:
        from ray_tpu_torch.serve.gpu_replica import MeshShardedDecoder

        handle = _deploy("chaosp", prefill_replicas=2)
        # Warm both pools up on the normal path first.
        warm = {"prompt": list(range(8)), "tokens": 2}
        ray.get(handle.remote(warm), timeout=60)
        pre = _pool_reps("chaosp" + PREFILL_SUFFIX)
        assert len(pre) == 2
        (dec,) = _pool_reps("chaosp")
        ray.kill(pre[0])
        body = {"prompt": list(range(40, 52)), "tokens": 3}
        out = ray.get(dec.call_method.remote(
            "disagg_generate", (body, pre[0], "chaosp" + PREFILL_SUFFIX),
            {}), timeout=60)
        ref = MeshShardedDecoder(device="cpu")
        assert out == ref.reference_decode(body["prompt"], body["tokens"])
        assert _kv_debug(dec)["chain"]["handoff_retries"] >= 1
        # The router path keeps serving through the death too (the
        # controller replaces the replica; the handle long-poll and the
        # in-call retry cover the gap).
        reqs = [{"prompt": list(range(60, 70)) + [i], "tokens": 2}
                for i in range(4)]
        outs = ray.get([handle.remote(r) for r in reqs], timeout=120)
        for r, o in zip(reqs, outs):
            assert o == ref.reference_decode(r["prompt"], r["tokens"])
    finally:
        serve.shutdown()
        ray.shutdown()


def test_chaos_killed_decode_replica_leaks_nothing_prefill_side():
    """Kill the decode replica after it adopted streamed chains: the
    prefill pool's allocator must sit back at baseline (exports are
    released at handoff completion, not decode retirement — a dead
    importer cannot pin exporter blocks), and the deployment keeps
    serving once the controller replaces the replica.  Prefix caching
    is OFF here so the prefill baseline is exactly zero blocks (with it
    on, the cache deliberately retains chain blocks for reuse)."""
    ray.init(num_cpus=8, _system_config={
        **DISAGG_CONF, "prefix_caching": False})
    try:
        from ray_tpu_torch.serve.gpu_replica import MeshShardedDecoder

        handle = _deploy("chaosd")
        reqs = [{"prompt": list(range(16)) + [i], "tokens": 2}
                for i in range(6)]
        outs = ray.get([handle.remote(r) for r in reqs], timeout=120)
        ref = MeshShardedDecoder(device="cpu")
        for r, o in zip(reqs, outs):
            assert o == ref.reference_decode(r["prompt"], r["tokens"])
        (dec,) = _pool_reps("chaosd")
        ray.kill(dec)
        (pre,) = _pool_reps("chaosd" + PREFILL_SUFFIX)
        dbg = _kv_debug(pre)
        assert dbg["exports_outstanding"] == 0
        assert dbg["used"] == 0, dbg
        # Recovery: the controller replaces the dead decode replica and
        # fresh requests complete (retry until the replacement lands).
        deadline = time.monotonic() + 60
        out = None
        body = {"prompt": list(range(16)) + [99], "tokens": 2}
        while time.monotonic() < deadline:
            try:
                out = ray.get(handle.remote(body), timeout=30)
                break
            except Exception:
                time.sleep(0.5)
        assert out == ref.reference_decode(body["prompt"], body["tokens"])
    finally:
        serve.shutdown()
        ray.shutdown()


# -- independent pool autoscaling -------------------------------------------

def test_pool_autoscaler_parks_grow_prefill_and_tps_grows_decode():
    """Pool-saturation scaling rides the controller metric windows
    (record_pool_metric is public precisely so tests can drive the
    scaler without real traffic): a GROWING admission_parks window
    raises the prefill pool, a tokens_per_step peak at/above the
    configured target raises the decode pool — both within their
    autoscaling_config max."""
    ray.init(num_cpus=10, _system_config=DISAGG_CONF)
    try:
        _deploy("scale", autoscaling_config={
            "min_replicas": 1, "max_replicas": 2,
            "target_ongoing_requests": 1000,   # ongoing never triggers
            "scale_on_parks": True,
            "target_tokens_per_step": 4.0})
        ctrl = ray.get_actor(CONTROLLER_NAME)
        twin = "scale" + PREFILL_SUFFIX
        assert len(_pool_reps("scale")) == 1
        assert len(_pool_reps(twin)) == 1
        # Prefill: parks grew inside the look-back window.
        ray.get(ctrl.record_pool_metric.remote(
            twin, "admission_parks", 0))
        ray.get(ctrl.record_pool_metric.remote(
            twin, "admission_parks", 5))
        # Decode: tokens_per_step peaked at the saturation target.
        ray.get(ctrl.record_pool_metric.remote(
            "scale", "tokens_per_step", 4.5))
        # Keep feeding the windows while we wait: the look-back is
        # short (serve_metric_lookback_s) and a reconcile tick that is
        # busy spawning the decode replica can outlive a one-shot
        # sample — a genuinely saturated pool keeps reporting growing
        # parks, so the test does too.
        parks_v = 5
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            if len(_pool_reps("scale")) == 2 and \
                    len(_pool_reps(twin)) == 2:
                break
            parks_v += 1
            ray.get(ctrl.record_pool_metric.remote(
                twin, "admission_parks", parks_v))
            ray.get(ctrl.record_pool_metric.remote(
                "scale", "tokens_per_step", 4.5))
            time.sleep(0.25)
        assert len(_pool_reps(twin)) == 2, "prefill pool did not scale"
        assert len(_pool_reps("scale")) == 2, "decode pool did not scale"
    finally:
        serve.shutdown()
        ray.shutdown()


# -- delete cascade ---------------------------------------------------------

def test_delete_deployment_cascades_to_prefill_twin():
    ray.init(num_cpus=6, _system_config=DISAGG_CONF)
    try:
        _deploy("gone")
        ctrl = ray.get_actor(CONTROLLER_NAME)
        deps = ray.get(ctrl.list_deployments.remote())
        assert "gone" in deps and "gone" + PREFILL_SUFFIX in deps
        ray.get(ctrl.delete_deployment.remote("gone"))
        deps = ray.get(ctrl.list_deployments.remote())
        assert "gone" not in deps
        assert "gone" + PREFILL_SUFFIX not in deps, deps
    finally:
        serve.shutdown()
        ray.shutdown()
