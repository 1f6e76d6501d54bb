"""The port's data-parallel trainer (``ray_tpu_torch.train``: the trainer,
backend executor, worker group and ``TorchConfig``) on CPU, against the
reference.

- ``MeshConfig.sizes``/``auto`` equal ``ray_tpu.parallel.mesh``'s.
- ``tests/test_train.py``'s trainer cases (one worker, two workers, resume
  from a checkpoint, group restart under ``FailureConfig``) run against
  the port with the same numpy ``_sgd_loop``.
- Data-parallel parity: ``DataParallelTrainer`` with
  ``TorchConfig(distributed=True)`` runs 2 CPU workers over gloo, each on
  half of one (4, 33) token batch of ``LlamaConfig.tiny`` in f32, from
  the reference's initial params.  After 1 and 2 steps it must equal the
  reference's single-process ``make_train_step`` on the whole batch, at
  ``test_torch_train.py``'s tolerances: loss and grad_norm within 1e-5,
  every param within 1e-4 with at most 0.1% of the elements beyond 1e-5.
  Both ranks hold bitwise the same params.
- The same with 4 experts: the step routes the whole batch (the group as
  a ``dp`` mesh), so loss, aux loss and grad_norm equal the reference's
  whole-batch step's within 1e-5, and the params hold
  ``test_torch_llama_moe.py``'s limits.
- With no process group the step is the one-device step, and a group of
  world size 1 changes no bit of it.
- A streamed checkpoint crosses the object plane into the driver's node
  store, and the store's bytes come back.

One runtime for the module.  The loops run in worker processes, which
import this module to unpickle them: it imports neither torch nor jax at
its top (each function imports what it needs).
"""

import dataclasses

import numpy as np
import pytest

import ray_tpu_torch as ray
from ray_tpu_torch.air import (
    Checkpoint, FailureConfig, RunConfig, ScalingConfig)
from ray_tpu_torch.air import session as air_session
from ray_tpu_torch.parallel import MESH_AXES, MeshConfig
from ray_tpu_torch.train import DataParallelTrainer, TorchConfig

OPT = dict(lr=1e-2, warmup=1, decay_steps=10)
MOE = {"num_experts": 4}


@pytest.fixture(scope="module")
def runtime():
    ray.init(num_cpus=6)
    yield
    ray.shutdown()


def _sizes_or_error(mesh, n):
    try:
        return mesh.sizes(n)
    except ValueError as e:
        return f"ValueError: {e}"


@pytest.mark.parametrize("mesh,n", [
    (MeshConfig(), 8), (MeshConfig(dp=2, tp=4), 8),
    (MeshConfig(dp=-1, fsdp=2, sp=2), 8), (MeshConfig(tp=-1, dp=1), 4),
    (MeshConfig(dp=-1, ep=3), 6), (MeshConfig(dp=-1, tp=-1), 8),
    (MeshConfig(dp=3, tp=2), 8), (MeshConfig(dp=-1, pp=3), 8),
    ("auto", 1), ("auto", 8), ("auto", 12), ("auto", 96)])
def test_mesh_config_matches_reference(mesh, n):
    from ray_tpu.parallel import mesh as ref

    assert MESH_AXES == ref.MESH_AXES
    if mesh == "auto":
        mesh, want_mesh = MeshConfig.auto(n), ref.MeshConfig.auto(n)
        assert dataclasses.astuple(mesh) == dataclasses.astuple(want_mesh)
    else:
        want_mesh = ref.MeshConfig(**dataclasses.asdict(mesh))
    assert _sizes_or_error(mesh, n) == _sizes_or_error(want_mesh, n)


# -- tests/test_train.py's trainer cases, against the port ------------------

def _sgd_loop(config):
    """Tiny numpy regression loop using the session API."""
    rng = np.random.default_rng(0)
    w = np.zeros(4)
    ckpt = air_session.get_checkpoint()
    start = 0
    if ckpt is not None:
        st = ckpt.to_dict()
        w, start = st["w"], st["step"]
    x = rng.normal(size=(64, 4))
    y = x @ np.array([1.0, -2.0, 3.0, 0.5])
    for step in range(start, config["steps"]):
        g = 2 * x.T @ (x @ w - y) / len(x)
        w -= config["lr"] * g
        loss = float(np.mean((x @ w - y) ** 2))
        air_session.report(
            {"loss": loss, "step": step,
             "rank": air_session.get_world_rank()},
            checkpoint=Checkpoint.from_dict({"w": w, "step": step + 1}))


def test_data_parallel_trainer_single_worker(runtime):
    trainer = DataParallelTrainer(
        _sgd_loop, train_loop_config={"steps": 5, "lr": 0.05},
        backend_config=TorchConfig(distributed=False),
        scaling_config=ScalingConfig(num_workers=1))
    result = trainer.fit()
    assert result.metrics["loss"] < 5.0
    assert len(result.metrics_history) == 5
    st = result.checkpoint.to_dict()
    assert st["step"] == 5


def test_data_parallel_trainer_two_workers(runtime):
    trainer = DataParallelTrainer(
        _sgd_loop, train_loop_config={"steps": 3, "lr": 0.05},
        backend_config=TorchConfig(distributed=False),
        scaling_config=ScalingConfig(num_workers=2))
    result = trainer.fit()
    assert result.metrics["rank"] == 0
    assert len(result.metrics_history) == 3


def test_resume_from_checkpoint(runtime):
    trainer = DataParallelTrainer(
        _sgd_loop, train_loop_config={"steps": 3, "lr": 0.05},
        backend_config=TorchConfig(distributed=False),
        scaling_config=ScalingConfig(num_workers=1))
    r1 = trainer.fit()
    trainer2 = DataParallelTrainer(
        _sgd_loop, train_loop_config={"steps": 6, "lr": 0.05},
        backend_config=TorchConfig(distributed=False),
        scaling_config=ScalingConfig(num_workers=1),
        resume_from_checkpoint=r1.checkpoint)
    r2 = trainer2.fit()
    # resumed at step 3, ran 3 more
    assert len(r2.metrics_history) == 3
    assert r2.checkpoint.to_dict()["step"] == 6
    assert r2.metrics["loss"] < r1.metrics["loss"]


def _failing_loop(config):
    import os
    rank = air_session.get_world_rank()
    ckpt = air_session.get_checkpoint()
    attempt = ckpt.to_dict()["attempt"] if ckpt else 0
    if attempt == 0 and rank == 0 and not os.environ.get("_RT_NO_CRASH"):
        air_session.report(
            {"phase": "precrash"},
            checkpoint=Checkpoint.from_dict({"attempt": 1}))
        os._exit(1)  # simulate worker death mid-training
    air_session.report({"phase": "done", "attempt": attempt},
                       checkpoint=Checkpoint.from_dict({"attempt": attempt}))


def test_failure_config_group_restart(runtime):
    """Reference: FailureConfig(max_failures) + group restart
    (backend_executor.py:522)."""
    trainer = DataParallelTrainer(
        _failing_loop, train_loop_config={},
        backend_config=TorchConfig(distributed=False),
        scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(failure_config=FailureConfig(max_failures=2)))
    result = trainer.fit()
    assert result.error is None
    assert result.metrics["phase"] == "done"
    assert result.metrics["attempt"] == 1  # restarted from the checkpoint


def test_streamed_checkpoints_cross_the_object_plane(runtime):
    """Each streamed checkpoint lands in the driver's node store as a
    segment (its event carries only the descriptor), the executor takes
    it back, and the store's bytes return to where they were."""
    from ray_tpu_torch._private import api_internal
    from ray_tpu_torch.train import BackendExecutor

    shm = api_internal.require_runtime().shm
    before = shm._node_used()
    ex = BackendExecutor(TorchConfig(distributed=False),
                         ScalingConfig(num_workers=1))
    ex.start()
    try:
        out = ex.run_training(_sgd_loop, {"steps": 3, "lr": 0.05})
    finally:
        ex.shutdown()
    assert [Checkpoint.from_bytes(b).to_dict()["step"]
            for b in out[0]["checkpoints"]] == [1, 2, 3]
    assert len(ex.streamed_reports) == 3
    for ev in ex.streamed_reports:
        kind = ev["checkpoint_segment"][0]
        assert kind in ("shm", "spilled")
        assert Checkpoint.from_bytes(ev["checkpoint"]).to_dict()["step"] \
            == ev["metrics"]["step"] + 1
    assert ex.latest_checkpoint.to_dict()["step"] == 3
    assert shm._node_used() == before


# -- data-parallel parity with the reference's single-process step ----------

def _jax_steps(cfg_kw):
    """The reference's initial params, its params and metrics after 1
    and 2 steps on the whole (4, 33) batch, and its first grads (numpy
    leaves)."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import llama as jax_llama
    from ray_tpu.train import core as jax_core

    jcfg = jax_llama.LlamaConfig.tiny(**cfg_kw)
    opt = jax_core.default_optimizer(**OPT)
    state = jax_core.init_train_state(jax.random.PRNGKey(0), jcfg, opt)
    step = jax_core.make_train_step(jcfg, opt, donate=False)
    toks = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, size=(4, 33)).astype(np.int32)
    grads = jax.tree.map(np.asarray, jax.grad(lambda p: jax_llama.loss_fn(
        p, {"tokens": jnp.asarray(toks)}, jcfg)[0])(state.params))
    params, metrics = [jax.tree.map(np.asarray, state.params)], []
    for _ in range(2):
        state, m = step(state, {"tokens": jnp.asarray(toks)})
        params.append(jax.tree.map(np.asarray, state.params))
        metrics.append({k: float(v) for k, v in m.items()})
    return params, metrics, toks, grads


@pytest.fixture(scope="module")
def jax_run():
    return _jax_steps({"attn_impl": "flash"})


@pytest.fixture(scope="module")
def jax_moe_run():
    return _jax_steps(MOE)


def _dp_loop(config):
    """Each rank: its half of the batch, ``config["steps"]`` steps of the
    port's train step; reports the metrics, the params (numpy) and how
    far the ranks' params are apart."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.models import LlamaConfig, params_from_jax
    from ray_tpu_torch.train import (
        default_optimizer, make_train_step, train_state_from_params)
    from ray_tpu_torch.train.core import tree_leaves, tree_map

    torch.set_num_threads(1)
    cfg = LlamaConfig.tiny(**config["cfg"])
    opt = default_optimizer(**config["opt"])
    state = train_state_from_params(
        params_from_jax(config["params"], cfg, "cpu"), opt)
    step = make_train_step(cfg, opt)
    rank, n = air_session.get_world_rank(), air_session.get_world_size()
    toks = config["tokens"]
    per = len(toks) // n
    batch = {"tokens": torch.from_numpy(toks[rank * per:(rank + 1) * per])}
    for _ in range(config["steps"]):
        state, m = step(state, batch)
        flat = torch.cat([p.reshape(-1) for p in tree_leaves(state.params)])
        rank0 = flat.clone()
        dist.broadcast(rank0, src=0)
        apart = (flat - rank0).abs().max()
        dist.all_reduce(apart, op=dist.ReduceOp.MAX)
        air_session.report({
            **{k: float(v) for k, v in m.items()},
            "backend": dist.get_backend(), "world": dist.get_world_size(),
            "rows": len(batch["tokens"]), "ranks_apart": float(apart),
            "params": tree_map(lambda t: t.numpy().copy(), state.params)})


def _assert_params_close(got, np_params, cfg_kw, first_grads=None):
    """``test_torch_train.py``'s limits; with ``first_grads`` (MoE),
    ``test_torch_llama_moe.py``'s: the 1e-4 maximum holds where the
    reference's first grad is at least 1e-6, and every element within lr
    per step."""
    import torch

    from ray_tpu_torch.models import LlamaConfig, params_from_jax
    from ray_tpu_torch.train.core import tree_leaves, tree_map

    want = params_from_jax(np_params, LlamaConfig.tiny(**cfg_kw), "cpu")
    n_far = n = 0
    for i, (a, b) in enumerate(zip(tree_leaves(tree_map(torch.from_numpy,
                                                        got)),
                                   tree_leaves(want))):
        assert a.shape == b.shape
        d = (a - b).abs()
        if first_grads is None:
            assert float(d.max()) <= 1e-4
        else:
            assert float(d.max()) <= 2 * OPT["lr"]
            sure = torch.from_numpy(
                np.abs(tree_leaves(first_grads)[i]) >= 1e-6)
            if bool(sure.any()):
                assert float(d[sure].max()) <= 1e-4
        n_far += int((d > 1e-5).sum())
        n += d.numel()
    assert n_far <= 1e-3 * n


def test_two_gloo_workers_match_the_reference_whole_batch_step(runtime,
                                                               jax_run):
    params, metrics, toks, _ = jax_run
    cfg_kw = {"attn_impl": "flash"}
    trainer = DataParallelTrainer(
        _dp_loop, train_loop_config={"opt": OPT, "params": params[0],
                                     "tokens": toks, "steps": 2,
                                     "cfg": cfg_kw},
        backend_config=TorchConfig(distributed=True),
        scaling_config=ScalingConfig(num_workers=2))
    result = trainer.fit()
    assert result.error is None, result.error
    hist = result.metrics_history
    assert len(hist) == 2
    for i, got in enumerate(hist):
        assert got["backend"] == "gloo" and got["world"] == 2
        assert got["rows"] == 2 and got["ranks_apart"] == 0.0
        for k in ("loss", "grad_norm"):
            assert abs(got[k] - metrics[i][k]) <= 1e-5, (i, k)
        assert abs(got["perplexity"] - metrics[i]["perplexity"]) <= \
            1e-5 * metrics[i]["perplexity"]
        _assert_params_close(got["params"], params[i + 1], cfg_kw)


def test_two_gloo_workers_route_moe_over_the_whole_batch(runtime,
                                                         jax_moe_run):
    """MoE under the group: each rank holds half of the batch, and the
    step routes the whole batch (capacity, drops and the aux loss of all
    4 rows), as the reference's single-process step does."""
    params, metrics, toks, grads = jax_moe_run
    trainer = DataParallelTrainer(
        _dp_loop, train_loop_config={"opt": OPT, "params": params[0],
                                     "tokens": toks, "steps": 2,
                                     "cfg": MOE},
        backend_config=TorchConfig(distributed=True),
        scaling_config=ScalingConfig(num_workers=2))
    result = trainer.fit()
    assert result.error is None, result.error
    hist = result.metrics_history
    assert len(hist) == 2
    for i, got in enumerate(hist):
        assert got["world"] == 2 and got["rows"] == 2
        assert got["ranks_apart"] == 0.0
        for k in ("loss", "aux_loss", "grad_norm"):
            assert abs(got[k] - metrics[i][k]) <= 1e-5, (i, k)
        _assert_params_close(got["params"], params[i + 1], MOE, grads)


def test_step_without_group_is_the_one_device_step():
    """No process group: ``loss_and_grads`` gives autograd's grads of
    ``loss_fn`` untouched.  A gloo group of world size 1: the same step,
    bitwise."""
    import socket

    import torch
    import torch.distributed as dist

    from ray_tpu_torch.models import LlamaConfig, init_params, loss_fn
    from ray_tpu_torch.train import (
        default_optimizer, loss_and_grads, make_train_step,
        train_state_from_params)
    from ray_tpu_torch.train.core import tree_leaves, tree_map

    assert not dist.is_initialized()
    cfg = LlamaConfig.tiny(attn_impl="flash")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = {"tokens": torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(2, 17)))}
    total, metrics, grads = loss_and_grads(params, batch, cfg)
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    it = iter(leaves)
    want_total, want_m = loss_fn(tree_map(lambda _: next(it), params),
                                 batch, cfg)
    want = torch.autograd.grad(want_total, leaves)
    assert torch.equal(total, want_total.detach())
    assert torch.equal(metrics["perplexity"], want_m["perplexity"])
    for a, b in zip(tree_leaves(grads), want):
        assert torch.equal(a, b)

    def run():
        opt = default_optimizer(**OPT)
        state = train_state_from_params(tree_map(torch.clone, params), opt)
        step = make_train_step(cfg, opt)
        ms = [step(state, batch)[1] for _ in range(2)]
        return state, ms

    s0, m0 = run()
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        s1, m1 = run()
    finally:
        dist.destroy_process_group()
    for a, b in zip(m0, m1):
        assert all(torch.equal(a[k], b[k]) for k in a)
    for a, b in zip(tree_leaves(s0.params), tree_leaves(s1.params)):
        assert torch.equal(a, b)
