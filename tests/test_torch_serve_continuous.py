"""The cases of ``tests/test_serve_continuous.py``, run unchanged against
the port's copy of the continuous batcher and serve control plane and
its decoder (``import ray_tpu_torch as ray``; deployments bound to
``device=["cpu"] * 8``: 8 projection shards, as the reference's decoder
runs on its 8-device CPU mesh; reference chains from ``device="cpu"``).

Continuous (iteration-level) batching engine tests: in-process
scheduler semantics (mid-flight admission, one-shot all-or-nothing
baseline, error isolation, scheduler-death backstop), the paced-decode
acceptance micro (continuous >= 2x one-shot req/s at equal
max_batch_size, best-of-3), the mesh-sharded TPU-resident replica
example end to end through serve, and the RAY_TPU_CONTINUOUS_BATCHING
switch plumbing into replica workers."""

import threading
import time

import pytest

import ray_tpu_torch as ray
from ray_tpu_torch import serve
from ray_tpu_torch.serve.continuous import SlotCancelled, _ContinuousBatcher


def _paced_decode_step(step_s):
    """Step fn: every live slot needs request["tokens"] iterations; one
    fixed sleep per step models the device step cost (occupancy-
    independent, like a real fused decode step)."""

    def stepfn(slots):
        time.sleep(step_s)
        for s in slots:
            if s.state is None:
                s.state = {"n": 0, "need": s.request["tokens"]}
            s.state["n"] += 1
            if s.state["n"] >= s.state["need"]:
                s.finish({"tokens": s.state["n"],
                          "id": s.request.get("id")})
        return None

    return stepfn


def _drive(batcher, requests, timeout=60):
    """Submit every request from its own thread; return results by id."""
    results = {}
    errors = {}

    def client(req):
        try:
            results[req["id"]] = batcher.submit(req)
        except BaseException as e:  # noqa: BLE001 — recorded for asserts
            errors[req["id"]] = e

    threads = [threading.Thread(target=client, args=(r,))
               for r in requests]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    return results, errors, time.perf_counter() - t0


def test_continuous_engine_varied_lengths():
    b = _ContinuousBatcher(_paced_decode_step(0.002), None, 4, 0.01,
                           continuous=True)
    reqs = [{"id": i, "tokens": 1 + i % 5} for i in range(12)]
    results, errors, _ = _drive(b, reqs)
    assert not errors
    assert all(results[i]["tokens"] == 1 + i % 5 for i in range(12))
    s = b.stats()
    assert s["mode"] == "continuous"
    assert s["admitted"] == s["retired"] == 12
    assert s["steps"] >= 5 and s["batch_occupancy"] > 1.0


def test_continuous_admits_mid_flight():
    """Iteration-level admission: a short request submitted while a
    long one is mid-decode joins the RUNNING batch and finishes first
    — impossible under the all-or-nothing window."""
    b = _ContinuousBatcher(_paced_decode_step(0.01), None, 4, 0.0,
                           continuous=True)
    order = []

    def run(req):
        b.submit(req)
        order.append(req["id"])

    long_t = threading.Thread(target=run,
                              args=({"id": "long", "tokens": 40},))
    long_t.start()
    deadline = time.monotonic() + 5
    while b.stats()["steps"] < 3 and time.monotonic() < deadline:
        time.sleep(0.005)  # the long request is decoding now
    short_t = threading.Thread(target=run,
                               args=({"id": "short", "tokens": 2},))
    short_t.start()
    long_t.join(30)
    short_t.join(30)
    assert order == ["short", "long"]


def test_oneshot_mode_is_all_or_nothing():
    """continuous=False (the RAY_TPU_CONTINUOUS_BATCHING=0 baseline):
    a request arriving mid-batch is admitted only after EVERY slot of
    the running batch finished.  A real batching window (0.3s) makes
    the FIRST batch deterministically contain both long requests —
    with a zero window the leader can step off with only one of them
    and the latecomer shares the second batch instead of waiting."""
    b = _ContinuousBatcher(_paced_decode_step(0.01), None, 4, 0.3,
                           continuous=False)
    finished_at = {}

    def run(req):
        b.submit(req)
        finished_at[req["id"]] = time.monotonic()

    first = [threading.Thread(target=run,
                              args=({"id": f"a{i}", "tokens": 12},))
             for i in range(2)]
    for t in first:
        t.start()
    deadline = time.monotonic() + 5
    while b.stats()["steps"] < 3 and time.monotonic() < deadline:
        time.sleep(0.005)
    late = threading.Thread(target=run,
                            args=({"id": "late", "tokens": 1},))
    late.start()
    for t in first + [late]:
        t.join(30)
    # The 1-token latecomer (admitted mid-batch under continuous mode)
    # had to wait for both 12-token requests.
    assert finished_at["late"] >= max(finished_at["a0"],
                                      finished_at["a1"])
    s = b.stats()
    assert s["mode"] == "oneshot" and s["retired"] == 3


def test_step_error_fails_live_batch_and_recovers():
    calls = {"n": 0}

    def stepfn(slots):
        calls["n"] += 1
        if calls["n"] == 2:
            raise ValueError("device poof")
        for s in slots:
            if s.state is None:
                s.state = 0
            s.state += 1
            if s.state >= s.request["tokens"]:
                s.finish("ok")

    b = _ContinuousBatcher(stepfn, None, 4, 0.0, continuous=True)
    with pytest.raises(ValueError, match="device poof"):
        b.submit({"tokens": 3})
    # The scheduler survives the step error; fresh requests complete.
    assert b.submit({"tokens": 2}) == "ok"
    s = b.stats()
    assert s["step_errors"] == 1 and s["retired"] == 1


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_scheduler_death_backstop(monkeypatch):
    """A hard-killed scheduler thread can never fire caller events; the
    caller-side liveness backstop must surface SlotCancelled instead of
    hanging, and the next submit must start a fresh scheduler."""
    b = _ContinuousBatcher(_paced_decode_step(0.001), None, 4, 0.0,
                           continuous=True)
    monkeypatch.setattr(_ContinuousBatcher, "_BACKSTOP_S", 0.1)

    def boom(live):
        raise SystemExit  # escapes the step-error handler's BaseException
        # (SystemExit inside _admit_locked, i.e. OUTSIDE the step call)

    b._admit_locked = boom  # scheduler dies before admitting anything
    with pytest.raises(SlotCancelled):
        b.submit({"id": 0, "tokens": 1})
    del b.__dict__["_admit_locked"]  # restore the real (class) method
    assert b.submit({"id": 1, "tokens": 1})["tokens"] == 1


def test_acceptance_continuous_2x_oneshot_paced_decode():
    """THE acceptance micro: a paced decode workload (fixed per-step
    cost, skewed request lengths — most short, some long, the shape
    continuous batching exists for) sustains >= 2x the req/s of
    one-shot batching at equal max_batch_size.  Best-of-3 per mode;
    sleep-paced steps make the ratio host-load-independent."""
    step_s = 0.004
    reqs = [{"id": i, "tokens": 24 if i % 4 == 0 else 2}
            for i in range(96)]

    def req_rate(continuous):
        best = 0.0
        samples = []
        for _ in range(3):
            # 50ms window: the one-shot baseline's FIRST batch gets a
            # fair chance to fill (later batches fill from the queue
            # instantly; continuous mode never waits).
            b = _ContinuousBatcher(_paced_decode_step(step_s), None, 8,
                                   0.05, continuous=continuous)
            results, errors, dt = _drive(b, reqs)
            assert not errors and len(results) == len(reqs)
            samples.append(round(len(reqs) / dt, 1))
            best = max(best, len(reqs) / dt)
        return best, samples

    cont, cont_samples = req_rate(True)
    oneshot, oneshot_samples = req_rate(False)
    assert cont >= 2.0 * oneshot, (
        f"continuous {cont:.0f} req/s vs one-shot {oneshot:.0f} req/s "
        f"(samples: {cont_samples} vs {oneshot_samples})")


# -- the TPU-resident replica example through serve -------------------------

@pytest.fixture
def ray4():
    rt = ray.init(num_cpus=4)
    yield rt
    serve.shutdown()
    ray.shutdown()


def test_mesh_sharded_decoder_numerics_via_serve(ray4):
    """The TPU-resident replica example end to end: weights resident on
    the (degenerate, CPU) device mesh, device-resident decode state,
    double-buffered joins — decoded chains must match the host-side
    sequential reference exactly (integer-exact weights)."""
    from ray_tpu_torch.serve.gpu_replica import MeshShardedDecoder

    dep = serve.deployment(MeshShardedDecoder, name="decoder",
                           max_concurrency=16)
    handle = serve.run(dep.bind(device=["cpu"] * 8), name="decoder")
    reqs = [{"prompt": i, "tokens": 1 + i % 6} for i in range(12)]
    outs = ray.get([handle.remote(r) for r in reqs], timeout=120)
    ref = MeshShardedDecoder(device="cpu")
    for r, out in zip(reqs, outs):
        assert out == ref.reference_decode(r["prompt"], r["tokens"]), r
    stats = serve.serving_stats("decoder")
    assert stats["mode"] == "continuous"
    assert stats["steps"] >= 6 and stats["retired"] == 12
    assert stats["batch_occupancy"] > 0


def test_continuous_switch_off_env_plumbing():
    """_system_config{continuous_batching: False} must reach replica
    workers (the knob rides _worker_config_env): the same deployment's
    batcher then reports one-shot mode and still serves correctly."""
    ray.init(num_cpus=4,
             _system_config={"continuous_batching": False})
    try:
        from ray_tpu_torch.serve.gpu_replica import MeshShardedDecoder

        dep = serve.deployment(MeshShardedDecoder, name="decoder_off",
                               max_concurrency=16)
        handle = serve.run(dep.bind(device=["cpu"] * 8), name="decoder_off")
        outs = ray.get([handle.remote({"prompt": i, "tokens": 2})
                        for i in range(6)], timeout=120)
        ref = MeshShardedDecoder(device="cpu")
        for i, out in enumerate(outs):
            assert out == ref.reference_decode(i, 2)
        stats = serve.serving_stats("decoder_off")
        assert stats["mode"] == "oneshot"
        assert stats["retired"] == 6
    finally:
        serve.shutdown()
        ray.shutdown()
