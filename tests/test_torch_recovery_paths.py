"""The two recovery paths of ``chip_smoke.py``'s phase 21, on the CPU at a
small size, against the reference.

- The trainer: a one-worker CPU ``DataParallelTrainer`` with
  ``FailureConfig(max_failures=1)`` trains ``LlamaConfig.tiny`` (2 layers,
  f32, flash attention's plain path) from the reference's initial params
  (``params_from_jax``) on one numpy token batch for 4 steps.  At step 2
  it reports a checkpoint of its whole state (the f32 params, both AdamW
  moments, the step count); on the first attempt the loop then kills its
  own process with SIGKILL.  ``fit()`` restarts the group from that
  checkpoint and the new worker runs steps 3-4: their losses, grad norms
  and params are bitwise those of an uninterrupted run.  The
  uninterrupted run's 4 losses and grad norms are within 1e-5 of the
  reference's ``make_train_step`` on the same params and batch
  (``test_torch_train.py``'s tolerance).
- The replica: the port's decoder served through ``serve.run`` on the
  CPU (paged KV, prefix caching, ``speculative_k=3``) answers 8 requests;
  its worker is killed with SIGKILL; the controller replaces it, and the
  replacement answers 8 more.  Every chain of both batches is bitwise the
  reference decoder's ``reference_decode``, no request fails, and the
  replica's actor id and process change.
- The driver's drain of a streamed checkpoint: taking 512 MiB out of the
  node store holds the GIL no longer than a leaf at a time, so the head's
  reader threads in the same process see a worker's death at once.
- Requests in flight at a replica's death (phase 21 (c)), in each
  package: 8 requests wait in a gated paged step when the replica's
  worker is killed; each caller gets a chain bitwise
  ``reference_decode`` or an actor error within 60 s, the port's callers
  what the reference's get, and the replacement answers each failed
  request bitwise when the test sends it again.

The loops run in worker processes, which import this module to unpickle
them: it imports neither torch nor jax at its top.
"""

import os
import signal
import threading
import time

import numpy as np
import pytest

import ray_tpu_torch as ray
from ray_tpu_torch.air import (
    Checkpoint, FailureConfig, RunConfig, ScalingConfig)
from ray_tpu_torch.air import session as air_session
from ray_tpu_torch.train import DataParallelTrainer, TorchConfig

OPT = dict(lr=1e-2, warmup=1, decay_steps=10)
STEPS = 4
KILL_AFTER = 2


@pytest.fixture(scope="module")
def jax_run():
    """The reference's initial params (numpy leaves), the token batch,
    and the metrics of its ``STEPS`` steps."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import llama as jax_llama
    from ray_tpu.train import core as jax_core

    jcfg = jax_llama.LlamaConfig.tiny(attn_impl="flash")
    opt = jax_core.default_optimizer(**OPT)
    state = jax_core.init_train_state(jax.random.PRNGKey(0), jcfg, opt)
    params = jax.tree.map(np.asarray, state.params)
    step = jax_core.make_train_step(jcfg, opt, donate=False)
    toks = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, size=(2, 33)).astype(np.int32)
    metrics = []
    for _ in range(STEPS):
        state, m = step(state, {"tokens": jnp.asarray(toks)})
        metrics.append({k: float(v) for k, v in m.items()})
    return params, toks, metrics


def _recovery_loop(config):
    """``config["steps"]`` steps of the port's train step, each reported
    with its params; a checkpoint of the whole state at step
    ``config["kill_after"]``, after which the first attempt (no
    checkpoint to start from) kills its own process when
    ``config["kill"]``.  A later attempt starts from the checkpoint."""
    import torch

    from ray_tpu_torch.models import LlamaConfig, params_from_jax
    from ray_tpu_torch.train import (
        default_optimizer, make_train_step, train_state_from_params)
    from ray_tpu_torch.train.core import TrainState, tree_map

    torch.set_num_threads(1)
    cfg = LlamaConfig.tiny(attn_impl="flash")
    opt = default_optimizer(**OPT)
    start = air_session.get_checkpoint()
    if start is None:
        state = train_state_from_params(
            params_from_jax(config["params"], cfg, "cpu"), opt)
        writer = None
    else:
        d = start.to_dict()
        state = TrainState(step=d["step"], params=d["params"], opt_state={
            "count": d["count"], "mu": d["mu"], "nu": d["nu"]})
        writer = d["pid"]
    step = make_train_step(cfg, opt)
    batch = {"tokens": torch.from_numpy(config["tokens"])}
    for i in range(state.step, config["steps"]):
        state, m = step(state, batch)
        copy = tree_map(lambda t: t.detach().clone(), {
            "params": state.params, "mu": state.opt_state["mu"],
            "nu": state.opt_state["nu"]})
        ckpt = None
        if i + 1 == config["kill_after"]:
            ckpt = Checkpoint.from_dict({
                "step": state.step, "count": state.opt_state["count"],
                "pid": os.getpid(), **copy})
        air_session.report({
            "step": i + 1, "loss": float(m["loss"]),
            "grad_norm": float(m["grad_norm"]), "pid": os.getpid(),
            "restored_from_pid": writer,
            "params": tree_map(lambda t: t.numpy(), copy["params"])},
            checkpoint=ckpt)
        if ckpt is not None and config["kill"] and start is None:
            os.kill(os.getpid(), signal.SIGKILL)


def _fit(jax_run, kill):
    params, toks, _ = jax_run
    trainer = DataParallelTrainer(
        _recovery_loop, train_loop_config={
            "params": params, "tokens": toks, "steps": STEPS,
            "kill_after": KILL_AFTER, "kill": kill},
        backend_config=TorchConfig(distributed=False),
        scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(failure_config=FailureConfig(max_failures=1)))
    result = trainer.fit()
    assert result.error is None, result.error
    return result.metrics_history


def test_trainer_resumes_bitwise_after_its_worker_is_killed(jax_run):
    _, _, want = jax_run
    ray.init(num_cpus=4)
    try:
        whole = _fit(jax_run, kill=False)
        resumed = _fit(jax_run, kill=True)
    finally:
        ray.shutdown()
    assert [h["step"] for h in whole] == list(range(1, STEPS + 1))
    assert all(h["restored_from_pid"] is None for h in whole)
    for got, ref in zip(whole, want):
        for k in ("loss", "grad_norm"):
            assert abs(got[k] - ref[k]) <= 1e-5, (got["step"], k)
    # Only the restarted attempt's reports reach the result: steps 3-4,
    # from the checkpoint the killed worker wrote.
    assert [h["step"] for h in resumed] == list(range(KILL_AFTER + 1,
                                                      STEPS + 1))
    for got, ref in zip(resumed, whole[KILL_AFTER:]):
        assert got["restored_from_pid"] not in (None, got["pid"])
        assert got["loss"] == ref["loss"]
        assert got["grad_norm"] == ref["grad_norm"]
        a = _leaves(got["params"])
        b = _leaves(ref["params"])
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and np.array_equal(x, y)


class _Stream:
    """The one event a worker's report of a streamed checkpoint
    publishes, for ``BackendExecutor._drain_stream``."""

    def __init__(self, payload):
        self._payload = [payload]

    def poll_events(self, topic):
        out, self._payload = self._payload, []
        return out


def test_drain_of_a_large_checkpoint_leaves_the_head_its_threads():
    """Taking a streamed checkpoint of 512 MiB out of the node store
    holds the GIL for no more than a leaf at a time (the leaves are CPU
    tensors, as a train loop's are).  The driver's drain runs in the
    process of the head's reader threads: one copy of the whole blob
    under the GIL (``tobytes()``) held off the EOF of a worker killed
    right after its report for as long as the copy took."""
    import pickle

    import torch

    from ray_tpu_torch._private import api_internal, segment_stream
    from ray_tpu_torch.train.backend_executor import BackendExecutor

    leaves = {f"w{i}": torch.full((4 << 20,), float(i)) for i in range(32)}
    ray.init(num_cpus=1)
    gaps, stop = [], threading.Event()

    def sleeper():
        last = time.monotonic()
        while not stop.is_set():
            time.sleep(0.001)
            now = time.monotonic()
            gaps.append(now - last)
            last = now

    try:
        rt = api_internal.require_runtime()
        blob = Checkpoint.from_dict({"step": 2, "params": leaves}).to_bytes()
        seg = segment_stream.land(np.frombuffer(blob, np.uint8),
                                  rt.store_id)
        assert seg is not None
        del blob
        ex = BackendExecutor(TorchConfig(distributed=False),
                             ScalingConfig(num_workers=1))
        stream = _Stream(pickle.dumps({
            "rank": 0, "metrics": {"step": 2}, "checkpoint": None,
            "checkpoint_segment": seg}))
        watch = threading.Thread(target=sleeper, daemon=True)
        watch.start()
        time.sleep(0.05)
        ex._drain_stream(stream, "train-drain", pickle)
    finally:
        stop.set()
        ray.shutdown()
    got = ex.latest_checkpoint.to_dict()
    assert got["step"] == 2 and sorted(got["params"]) == sorted(leaves)
    for k, v in leaves.items():
        assert torch.equal(got["params"][k], v), k
    assert max(gaps) < 0.2, f"the drain held the GIL {max(gaps)} s"


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [np.asarray(tree)]


SYS_PROMPT = list(range(20))
REQS = [{"prompt": SYS_PROMPT + [32 + i % 32, i], "tokens": 3 + i % 10}
        for i in range(16)]


def _pid_decoder():
    """The port's decoder with a ``pid`` method (defined here, so that it
    pickles by value into the replica's worker)."""
    from ray_tpu_torch.serve.gpu_replica import MeshShardedDecoder

    class PidDecoder(MeshShardedDecoder):
        def pid(self):
            import os

            return os.getpid()

    return PidDecoder


def _batch(handle, reqs):
    out, errors = [None] * len(reqs), []

    def client(i):
        try:
            out[i] = ray.get(handle.remote(reqs[i]), timeout=120)
        except Exception as e:  # noqa: BLE001 -- every failure is reported
            errors.append((i, repr(e)))

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(150)
    assert not any(t.is_alive() for t in threads)
    return out, errors


def test_killed_replica_is_replaced_and_answers_bitwise():
    from ray_tpu.serve.tpu_replica import MeshShardedDecoder as JaxDecoder

    from ray_tpu_torch import serve

    jdec = JaxDecoder(paged=True, kv_blocks=64, speculative_k=3)
    weights = {"w": jdec._w_host, "emb": jdec._emb_host,
               "wd": jdec._wd_host}
    want = [jdec.reference_decode(r["prompt"], r["tokens"]) for r in REQS]
    ray.init(num_cpus=4, _system_config={
        "paged_kv": True, "prefix_caching": True, "speculative_k": 3})
    try:
        dep = serve.deployment(_pid_decoder(), name="recovered",
                               max_concurrency=16)
        handle = serve.run(dep.bind(device="cpu", weights=weights,
                                    kv_blocks=64), name="recovered")
        first, errors1 = _batch(handle, REQS[:8])
        old_pid = ray.get(handle.method("pid").remote(), timeout=60)
        (old,) = handle._replicas
        os.kill(old_pid, signal.SIGKILL)
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and [
                r._actor_id for r in handle._replicas] in (
                [old._actor_id], []):
            time.sleep(0.05)
        (new,) = handle._replicas
        second, errors2 = _batch(handle, REQS[8:])
        new_pid = ray.get(handle.method("pid").remote(), timeout=60)
    finally:
        serve.shutdown()
        ray.shutdown()
    assert errors1 == [] and errors2 == []
    assert new._actor_id != old._actor_id and new_pid != old_pid
    for r, got, w in zip(REQS, first + second, want):
        assert got == w, r


INFLIGHT = 8
OUTCOMES = {}


def _gated_decoder(base):
    """``base`` (either package's decoder) with a ``pid`` method and a
    paged step that waits for the file ``gate`` to exist: requests sent
    before the gate opens stay in flight in the replica.  Defined here,
    so that it pickles by value into the replica's worker."""

    class GatedDecoder(base):
        def __init__(self, *args, gate=None, **kwargs):
            super().__init__(*args, **kwargs)
            self._gate = gate

        def pid(self):
            import os

            return os.getpid()

        def _paged_step(self, slots):
            import os
            import time

            while not os.path.exists(self._gate):
                time.sleep(0.005)
            return super()._paged_step(slots)

    return GatedDecoder


def _inflight_scenario(pkg_name, gate, want):
    """``INFLIGHT`` requests held in flight by the gate, the replica's
    worker killed with SIGKILL, then the gate opened: each caller's
    answer or exception class, the seconds from the kill to each
    outcome, and the chains the replacement gives the failed requests
    when the test sends them again."""
    import importlib

    ray_ = importlib.import_module(pkg_name)
    serve = importlib.import_module(pkg_name + ".serve")
    if pkg_name == "ray_tpu":
        from ray_tpu.serve.tpu_replica import MeshShardedDecoder as base

        bind = {}
    else:
        from ray_tpu_torch.serve.gpu_replica import MeshShardedDecoder as base

        bind = {"device": "cpu", "weights": want["weights"]}
    reqs = REQS[:INFLIGHT]
    out = {"outcome": [None] * INFLIGHT, "after_s": [None] * INFLIGHT}
    ray_.init(num_cpus=4, _system_config={
        "paged_kv": True, "prefix_caching": True, "speculative_k": 3})
    try:
        dep = serve.deployment(_gated_decoder(base), name="inflight",
                               max_concurrency=16)
        handle = serve.run(dep.bind(kv_blocks=64, gate=gate, **bind),
                           name="inflight")
        pid = ray_.get(handle.method("pid").remote(), timeout=120)
        (old,) = handle._replicas
        refs = [handle.remote(r) for r in reqs]
        time.sleep(0.5)
        ready, _ = ray_.wait(refs, num_returns=INFLIGHT, timeout=0)
        with handle._lock:
            out["ongoing"] = handle._reconcile_outstanding_locked()
        out["ready_at_kill"] = len(ready)
        t_kill = time.time()
        os.kill(pid, signal.SIGKILL)
        open(gate, "w").close()

        def caller(i):
            try:
                out["outcome"][i] = ray_.get(refs[i], timeout=60)
            except Exception as e:  # noqa: BLE001 -- the class is compared
                out["outcome"][i] = type(e).__name__
            out["after_s"][i] = time.time() - t_kill

        threads = [threading.Thread(target=caller, args=(i,))
                   for i in range(INFLIGHT)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(70)
        out["hung"] = sum(t.is_alive() for t in threads)
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and [
                r._actor_id for r in handle._replicas] in (
                [old._actor_id], []):
            time.sleep(0.05)
        failed = [i for i, o in enumerate(out["outcome"])
                  if isinstance(o, str)]
        out["resubmitted"] = {
            i: ray_.get(handle.remote(reqs[i]), timeout=120)
            for i in failed}
        out["new_pid"] = ray_.get(handle.method("pid").remote(), timeout=60)
        out["pid"] = pid
    finally:
        serve.shutdown()
        ray_.shutdown()
    return out


@pytest.fixture(scope="module")
def inflight_want():
    """The reference decoder's weights and its ``reference_decode`` of
    the in-flight requests."""
    from ray_tpu.serve.tpu_replica import MeshShardedDecoder as JaxDecoder

    jdec = JaxDecoder(paged=True, kv_blocks=64, speculative_k=3)
    return {"weights": {"w": jdec._w_host, "emb": jdec._emb_host,
                        "wd": jdec._wd_host},
            "chains": [jdec.reference_decode(r["prompt"], r["tokens"])
                       for r in REQS[:INFLIGHT]]}


@pytest.mark.parametrize("pkg_name", ["ray_tpu", "ray_tpu_torch"])
def test_replica_killed_with_requests_in_flight(tmp_path, inflight_want,
                                                pkg_name):
    """A replica killed while ``INFLIGHT`` requests wait in its step:
    each caller gets an answer bitwise ``reference_decode`` or an actor
    error, none waits past 60 s, and the replacement answers every failed
    request bitwise when it is sent again.  The handle adds no retry of
    its own; the port's callers get what the reference's get."""
    out = _inflight_scenario(pkg_name, str(tmp_path / "gate"),
                             inflight_want)
    OUTCOMES[pkg_name] = out
    print(f"{pkg_name}: ongoing {out['ongoing']} at the kill; outcomes "
          f"{[o if isinstance(o, str) else 'answer' for o in out['outcome']]}"
          f", seconds from the kill {out['after_s']}")
    chains = inflight_want["chains"]
    assert out["ongoing"] == INFLIGHT and out["ready_at_kill"] == 0
    assert out["hung"] == 0
    assert all(s is not None and s < 60 for s in out["after_s"])
    for o, w in zip(out["outcome"], chains):
        assert o == w or o in ("ActorDiedError", "RayActorError"), o
    for i, got in out["resubmitted"].items():
        assert got == chains[i], i
    assert out["new_pid"] != out["pid"]
    ref = OUTCOMES.get("ray_tpu")
    if pkg_name == "ray_tpu_torch" and ref is not None:
        assert [o if isinstance(o, str) else "answer"
                for o in out["outcome"]] == \
            [o if isinstance(o, str) else "answer" for o in ref["outcome"]]
