"""The cases of ``tests/test_core_tasks.py``, run unchanged against the
port's copy of the runtime (``import ray_tpu_torch as ray``).

Core task API tests (reference model: python/ray/tests/test_basic.py)."""

import os
import time

import numpy as np
import pytest

import ray_tpu_torch as ray


@pytest.fixture
def ray_start_regular():
    """Single-node runtime of the port with 4 CPUs (in place of
    conftest's fixture of the same name, which boots the reference)."""
    rt = ray.init(num_cpus=4, num_tpus=0, ignore_reinit_error=False)
    yield rt
    ray.shutdown()


def test_simple_task(ray_start_regular):
    @ray.remote
    def f(a, b):
        return a + b

    assert ray.get(f.remote(1, 2)) == 3


def test_task_kwargs(ray_start_regular):
    @ray.remote
    def f(a, b=10, c=0):
        return a + b + c

    assert ray.get(f.remote(1, c=5)) == 16


def test_chained_dependencies(ray_start_regular):
    @ray.remote
    def inc(x):
        return x + 1

    ref = inc.remote(0)
    for _ in range(4):
        ref = inc.remote(ref)
    assert ray.get(ref, timeout=30) == 5


def test_put_get_roundtrip(ray_start_regular):
    for value in [1, "s", {"a": [1, 2]}, None, (1, 2)]:
        assert ray.get(ray.put(value)) == value


def test_large_object_zero_copy(ray_start_regular):
    arr = np.arange(2_000_000, dtype=np.float32)
    ref = ray.put(arr)
    out = ray.get(ref)
    np.testing.assert_array_equal(arr, out)

    @ray.remote
    def total(x):
        return float(x.sum())

    assert ray.get(total.remote(ref), timeout=30) == float(arr.sum())


def test_large_task_arg_and_return(ray_start_regular):
    @ray.remote
    def make(n):
        return np.ones(n, dtype=np.float64)

    @ray.remote
    def consume(x):
        return float(x.sum())

    big = make.remote(1_000_000)  # 8 MB -> shm
    assert ray.get(consume.remote(big), timeout=60) == 1_000_000.0


def test_multiple_returns(ray_start_regular):
    @ray.remote(num_returns=3)
    def three():
        return 1, 2, 3

    a, b, c = three.remote()
    assert ray.get([a, b, c]) == [1, 2, 3]


def test_error_propagation(ray_start_regular):
    @ray.remote
    def boom():
        raise ValueError("nope")

    with pytest.raises(ray.exceptions.TaskError) as ei:
        ray.get(boom.remote(), timeout=30)
    assert isinstance(ei.value.cause, ValueError)


def test_dependency_error_propagates(ray_start_regular):
    @ray.remote
    def boom():
        raise ValueError("upstream")

    @ray.remote
    def consume(x):
        return x

    with pytest.raises(ray.exceptions.RayTpuError):
        ray.get(consume.remote(boom.remote()), timeout=30)


def test_wait(ray_start_regular):
    @ray.remote
    def slow(i):
        time.sleep(0.05 * i)
        return i

    refs = [slow.remote(i) for i in range(4)]
    ready, not_ready = ray.wait(refs, num_returns=2, timeout=15)
    assert len(ready) == 2
    assert len(not_ready) == 2
    ready2, _ = ray.wait(refs, num_returns=4, timeout=15)
    assert len(ready2) == 4


def test_wait_timeout(ray_start_regular):
    @ray.remote
    def never():
        time.sleep(60)

    ref = never.remote()
    t0 = time.monotonic()
    ready, not_ready = ray.wait([ref], num_returns=1, timeout=0.5)
    assert time.monotonic() - t0 < 5
    assert ready == [] and not_ready == [ref]
    ray.cancel(ref, force=True)


def test_get_timeout(ray_start_regular):
    @ray.remote
    def never():
        time.sleep(60)

    ref = never.remote()
    with pytest.raises(ray.exceptions.GetTimeoutError):
        ray.get(ref, timeout=0.5)
    ray.cancel(ref, force=True)


def test_nested_tasks(ray_start_regular):
    @ray.remote
    def outer():
        @ray.remote
        def inner(x):
            return x * 2

        return ray.get(inner.remote(21))

    assert ray.get(outer.remote(), timeout=60) == 42


def test_task_retry_on_worker_crash(ray_start_regular):
    marker = f"/tmp/ray_tpu_test_marker_{os.getpid()}"
    if os.path.exists(marker):
        os.remove(marker)

    @ray.remote(max_retries=2)
    def flaky():
        if not os.path.exists(marker):
            open(marker, "w").close()
            os._exit(1)
        os.remove(marker)
        return "recovered"

    assert ray.get(flaky.remote(), timeout=60) == "recovered"


def test_no_retry_surfaces_crash(ray_start_regular):
    @ray.remote(max_retries=0)
    def die():
        os._exit(1)

    with pytest.raises(ray.exceptions.WorkerCrashedError):
        ray.get(die.remote(), timeout=60)


def test_cancel_pending(ray_start_regular):
    @ray.remote
    def block():
        time.sleep(60)

    # fill all 4 cpus, then queue one more
    blockers = [block.remote() for _ in range(4)]
    victim = block.remote()
    ray.cancel(victim)
    with pytest.raises(ray.exceptions.TaskCancelledError):
        ray.get(victim, timeout=30)
    for b in blockers:
        ray.cancel(b, force=True)


def test_options_override(ray_start_regular):
    @ray.remote(num_cpus=1)
    def f():
        return ray.get_runtime_context() is not None

    # runs even though it asks for fewer cpus than default
    assert ray.get(f.options(num_cpus=2).remote(), timeout=30)


def test_runtime_env_env_vars(ray_start_regular):
    @ray.remote(runtime_env={"env_vars": {"MY_FLAG": "abc"}})
    def read_env():
        return os.environ.get("MY_FLAG")

    assert ray.get(read_env.remote(), timeout=60) == "abc"


def test_cluster_resources(ray_start_regular):
    total = ray.cluster_resources()
    assert total["CPU"] == 4.0


def test_nested_ref_in_container_arg(ray_start_regular):
    """Refs pickled inside containers are pinned until the task completes
    (regression: serialize-time pins used to leak forever)."""

    @ray.remote
    def consume(lst):
        return ray.get(lst[0]) + 1

    x = ray.put(41)
    assert ray.get(consume.remote([x]), timeout=60) == 42
    # the pin must be released: dropping the last ref frees the object
    rt = ray_start_regular
    oid = x.id()
    del x
    deadline = time.time() + 10
    while time.time() < deadline:
        with rt.lock:
            if oid not in rt.objects:
                break
        time.sleep(0.1)
    with rt.lock:
        assert oid not in rt.objects, "nested-ref pin leaked"


def test_worker_side_get_timeout(ray_start_regular):
    """ray.get(timeout=...) inside a task raises instead of hanging."""

    @ray.remote
    def waiter(refs):
        # refs arrives inside a container, so it is NOT awaited as a task
        # dependency (top-level ref args are; same as the reference).
        try:
            ray.get(refs[0], timeout=0.5)
            return "no-timeout"
        except ray.exceptions.GetTimeoutError:
            return "timed-out"

    @ray.remote
    def never():
        time.sleep(60)

    pending = never.remote()
    assert ray.get(waiter.remote([pending]), timeout=60) == "timed-out"
    ray.cancel(pending, force=True)
