"""The port's paged decoder served through the port's own runtime and
serve control plane, on CPU.

``serve.run`` deploys the port's ``MeshShardedDecoder`` into a worker
process; ``paged_kv`` and ``speculative_k`` reach that worker only
through ``GLOBAL_CONFIG``'s environment (``_system_config``).  The
replica takes the JAX decoder's integer weights, so the 8 chains sent
through the handle from 8 threads must be bitwise the port's
``reference_decode`` and the JAX paged replica's own chains (run
in-process through its Pallas kernel in interpret mode).

Also: a replica granted the card whose constructor outlasts the
controller's 5 s health check (a model loading, a card's context
starting) is kept while it starts, not replaced by a replica that could
never get the card.
"""

import os
import threading
import time

import pytest

SYS_PROMPT = list(range(20))            # 2 full blocks of 8, then 4 tokens
REQS = [{"prompt": SYS_PROMPT + [i], "tokens": 3 + i % 6}
        for i in range(8)]
BLOCK = 8


@pytest.fixture(scope="module")
def jax_chains():
    from ray_tpu.serve.continuous import _ContinuousBatcher
    from ray_tpu.serve.tpu_replica import MeshShardedDecoder

    dec = MeshShardedDecoder(paged=True, kv_blocks=64, kv_block_size=BLOCK,
                             speculative_k=3)
    b = _ContinuousBatcher(dec._paged_step, None, 8, 0.0, continuous=True,
                           kv=dec.serve_kv_engine)
    chains = [None] * len(REQS)

    def client(i):
        chains[i] = b.submit(REQS[i])

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(REQS))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    weights = {"w": dec._w_host, "emb": dec._emb_host, "wd": dec._wd_host}
    return weights, chains


def test_paged_decoder_served_through_the_port_runtime(jax_chains):
    import ray_tpu_torch as ray
    from ray_tpu_torch import serve
    from ray_tpu_torch.serve.gpu_replica import MeshShardedDecoder

    weights, want = jax_chains
    ray.init(num_cpus=4,
             _system_config={"paged_kv": True, "speculative_k": 3})
    try:
        dep = serve.deployment(MeshShardedDecoder, name="port-paged",
                               max_concurrency=16)
        handle = serve.run(dep.bind(device="cpu", weights=weights,
                                    kv_blocks=64, kv_block_size=BLOCK),
                           name="port-paged")
        got = [None] * len(REQS)

        def client(i):
            got[i] = ray.get(handle.remote(REQS[i]), timeout=120)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(REQS))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(150)
        assert not any(t.is_alive() for t in threads)
        ref = MeshShardedDecoder(weights=weights, device="cpu")
        for r, chain, jax_chain in zip(REQS, got, want):
            assert chain == ref.reference_decode(r["prompt"], r["tokens"])
            assert chain == jax_chain
        dbg = ray.get(handle.method("kv_debug").remote(), timeout=60)
        assert dbg["paged"] is True and dbg["role"] is None
        assert dbg["kv_blocks_total"] == 64
        assert dbg["used"] + dbg["available"] == 64
        assert dbg["prefix_hits"] > 0 and dbg["spec_proposed"] > 0
        assert dbg["exports_outstanding"] == 0
        # Every request's blocks came back; what stays is the prefix
        # cache's: each distinct prompt's own partial last block, and the
        # system prompt's full blocks once for every request that missed
        # the cache (the first, and any admitted in the same step before
        # its registration, which keep theirs under their own prompt).
        missed = len(REQS) - dbg["prefix_hits"]
        assert missed >= 1
        assert dbg["used"] == len(SYS_PROMPT) // BLOCK * missed + len(REQS)
    finally:
        serve.shutdown()
        ray.shutdown()


class _SlowStart:
    """A replica whose constructor outlasts one health check."""

    def __init__(self, delay):
        time.sleep(delay)

    def __call__(self, x):
        return x + 1

    def pid(self):
        return os.getpid()


class _FallsSick:
    """A replica that answers, then fails its health check."""

    def __init__(self):
        self._sick = False

    def __call__(self, x):
        return x + 1

    def pid(self):
        return os.getpid()

    def fall_sick(self):
        self._sick = True

    def check_health(self):
        if self._sick:
            raise RuntimeError("unhealthy")


def _process_gone(pid):
    """No such process, or one that has exited and awaits its parent."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] in ("Z", "X")
    except FileNotFoundError:
        return True


def test_dropped_granted_replica_is_killed_and_its_card_released(
        monkeypatch):
    """A replica that has answered and then fails its health check is
    dropped, killed, and its card granted to its replacement (which could
    never be placed while the dropped replica held the only card)."""
    import ray_tpu_torch as ray
    from ray_tpu_torch import serve

    monkeypatch.setenv("RAY_TPU_FORCE_NUM_TPUS", "1")
    ray.init(num_cpus=2)
    try:
        dep = serve.deployment(_FallsSick, name="falls-sick", num_tpus=1,
                               max_concurrency=4)
        handle = serve.run(dep.bind(), name="falls-sick")
        assert ray.get(handle.remote(1), timeout=60) == 2
        pid = ray.get(handle.method("pid").remote(), timeout=60)
        ray.get(handle.method("fall_sick").remote(), timeout=60)
        new_pid = ray.get(handle.method("pid").remote(), timeout=60)
        deadline = time.monotonic() + 30
        while new_pid == pid and time.monotonic() < deadline:
            time.sleep(0.5)
            new_pid = ray.get(handle.method("pid").remote(), timeout=60)
        assert new_pid != pid
        assert _process_gone(pid)
        assert ray.get(handle.remote(2), timeout=60) == 3
    finally:
        serve.shutdown()
        ray.shutdown()


def test_slow_starting_granted_replica_is_kept(monkeypatch):
    import ray_tpu_torch as ray
    from ray_tpu_torch import serve

    monkeypatch.setenv("RAY_TPU_FORCE_NUM_TPUS", "1")
    ray.init(num_cpus=2)
    try:
        dep = serve.deployment(_SlowStart, name="slow-start", num_tpus=1,
                               max_concurrency=4)
        handle = serve.run(dep.bind(8.0), name="slow-start")
        pid = ray.get(handle.method("pid").remote(), timeout=60)
        assert ray.get([handle.remote(i) for i in range(4)],
                       timeout=60) == [1, 2, 3, 4]
        assert ray.get(handle.method("pid").remote(), timeout=60) == pid
    finally:
        serve.shutdown()
        ray.shutdown()


def test_handle_reports_the_peak_ongoing_of_request_bursts():
    """A client that keeps 8 requests in flight as bursts (send 8, wait
    for all, send 8 again) has 8 ongoing, and that is what its handle
    must report to the autoscaler.  The handle reports at the first
    dispatch after its reconcile period: the count pending at that
    instant alone is 1 (the burst before it has just completed), so it
    reports the peak in flight since its last report."""
    import ray_tpu_torch as ray
    from ray_tpu_torch import serve

    class Recorder:
        """The controller, but for the metric reports, which it keeps."""

        def __init__(self, real):
            self._real = real
            self.sent = []

        def __getattr__(self, name):
            return getattr(self._real, name)

        @property
        def record_handle_metric(self):
            sent = self.sent

            class Method:
                def remote(self, name, handle_id, ongoing, incarnation):
                    sent.append(ongoing)

            return Method()

    ray.init(num_cpus=4)
    try:
        @serve.deployment(num_replicas=1, max_concurrency=16)
        class Slow:
            def __call__(self, body):
                time.sleep(0.2)
                return "ok"

        handle = serve.run(Slow.bind(), name="bursty")
        assert ray.get(handle.remote({}), timeout=60) == "ok"
        rec = handle._controller = Recorder(handle._controller)
        for _ in range(3):
            time.sleep(handle._RECONCILE_PERIOD + 0.1)
            refs = [handle.remote({}) for _ in range(8)]
            assert ray.get(refs, timeout=60) == ["ok"] * 8
            del refs
        assert len(rec.sent) == 3, rec.sent
        assert rec.sent[1:] == [8, 8], rec.sent
    finally:
        serve.shutdown()
        ray.shutdown()
