"""The port's 1F1B pipeline actors (``ray_tpu_torch.train.pipeline_actors``)
and the llama stage helpers, against the reference on CPU.

- The 1F1B schedule's shape and stash bound, and the ragged-split error.
- The integer toy of ``tests/test_pipeline_actors.py`` (D = 4, B = 8, 4
  layers, ``sgd(1.0)``, M = 4) through 2 CPU stage actors of the port's
  runtime (``device="cpu"``): loss and per-stage grads BITWISE the
  reference's single-host ``PipelineTrainer`` step and ``pipeline_apply``
  under ``jax.value_and_grad``.  The reference's own pin calls
  ``pipeline_apply`` without a mesh in context, which JAX 0.9 refuses
  inside the trace (``set_mesh`` under ``value_and_grad``): here the
  gradient runs inside ``use_mesh(mesh)`` and under ``jax.jit`` (the
  reference's partial-manual ``shard_map`` lowers only under jit, as
  ``tests/test_torch_pipeline.py`` runs it).
- ``fill_drain`` bitwise 1F1B; the master switch off runs the single-host
  path with every counter unchanged; a stage killed between steps
  restores from its checkpoint and the trajectory stays bitwise, in f32
  and with bf16 params and activations on the wire.
- A card-bound trainer without a card raises (no quiet CPU).
- The llama stage helpers from the reference's weights: the composed
  stages equal the reference's ``forward`` and the loss its ``loss_fn``
  within 2e-5; one 2-stage step with CPU actors equals the reference's
  single-host step with its own stage functions within 1e-5.

One runtime for the module.  The stage actors unpickle this module's
functions, so it imports neither torch nor jax at its top.
"""

import os
import time

import numpy as np
import pytest

import ray_tpu_torch as ray
from ray_tpu_torch.train.pipeline_actors import (
    PipelineTrainer, _split_microbatches)

M = 4


@pytest.fixture(scope="module")
def runtime():
    rt = ray.init(num_cpus=4)
    yield rt
    ray.shutdown()


# Module-level so the stage actors resolve them by reference.
def _stage_fn(sp, x):
    for w in sp["w"].unbind(0):
        x = x @ w
    return x


def _loss_fn(y, t):
    import torch

    # Integer-valued data: every term is an exact small rational.
    return torch.sum(y - t) / y.numel()


def _int_data(seed=0, D=4, B=8, L=4):
    rng = np.random.default_rng(seed)
    w = rng.integers(-2, 3, size=(L, D, D)).astype(np.float32)
    x = rng.integers(-2, 3, size=(B, D)).astype(np.float32)
    t = rng.integers(-2, 3, size=(B, D)).astype(np.float32)
    return w, x, t


def _trainer(w, num_microbatches=M, **kw):
    from ray_tpu_torch.train import sgd

    kw.setdefault("device", "cpu")
    return PipelineTrainer(
        _stage_fn, _loss_fn, [{"w": w[:2]}, {"w": w[2:]}],
        optimizer=sgd(1.0), num_microbatches=num_microbatches, **kw)


def _counters(rt):
    st = rt.transfer_stats()
    return {k: st[k] for k in ("microbatch_pushes", "stage_restarts",
                               "learner_queue_stalls")}


def test_1f1b_schedule_shape_and_stash_bound():
    """Warmup is min(pp-1-s, M) forwards; each B(i) follows F(i); the
    live activation stash never exceeds pp entries."""
    w, _, _ = _int_data()
    tr = _trainer(w, num_microbatches=6, distributed=False)
    tr._pp = 4  # schedule shape is pure arithmetic over (pp, M, s)
    for s in range(4):
        seq = tr._stage_sched(s)
        warmup = 0
        for kind, _ in seq:
            if kind != "F":
                break
            warmup += 1
        assert warmup == min(min(4 - 1 - s, 6) + 1, 6)
        assert len(seq) == 2 * 6
        live, high = 0, 0
        done_f, done_b = set(), set()
        for kind, i in seq:
            if kind == "F":
                done_f.add(i)
                live += 1
            else:
                assert i in done_f, "backward before its forward"
                done_b.add(i)
                live -= 1
            high = max(high, live)
        assert done_f == done_b == set(range(6))
        assert high <= 4, f"stage {s}: {high} live stashes > pp"


def test_split_microbatches_rejects_ragged():
    with pytest.raises(ValueError):
        _split_microbatches(np.zeros((7, 3)), 2)
    parts = _split_microbatches({"a": np.arange(8), "b": [np.ones((8, 2))]},
                                4)
    assert [p["a"].tolist() for p in parts] == [[0, 1], [2, 3], [4, 5],
                                                 [6, 7]]
    assert parts[3]["b"][0].shape == (2, 2)


def _reference_step(w, x, t):
    """The reference: its single-host PipelineTrainer step (sgd(1.0)) and
    ``pipeline_apply`` at pp=2 under ``jax.value_and_grad`` (jitted,
    inside ``use_mesh``)."""
    import jax
    import jax.numpy as jnp
    import optax

    from ray_tpu.parallel import MeshConfig, make_mesh, use_mesh
    from ray_tpu.parallel.pipeline import pipeline_apply
    from ray_tpu.train.pipeline_actors import PipelineTrainer as JaxTrainer

    def stage_fn(sp, x_):
        y, _ = jax.lax.scan(lambda c, w_: (c @ w_, None), x_, sp["w"])
        return y

    def loss_fn(y, t_):
        return jnp.sum(y - t_) / y.size

    tr = JaxTrainer(stage_fn, loss_fn, [{"w": w[:2]}, {"w": w[2:]}],
                    optimizer=optax.sgd(1.0), num_microbatches=M,
                    distributed=False)
    m = tr.step(x, t)
    single = [p["w"] for p in tr.get_stage_params()]

    mesh = make_mesh(MeshConfig(dp=1, pp=2), devices=jax.devices()[:2])
    stacked = {"w": w.reshape(2, 2, *w.shape[1:])}

    def ref_loss(sp):
        y = pipeline_apply(stage_fn, sp, jnp.asarray(x), mesh=mesh,
                           num_microbatches=M)
        return loss_fn(y, jnp.asarray(t))

    with use_mesh(mesh):
        loss, g = jax.jit(jax.value_and_grad(ref_loss))(stacked)
    return (np.float32(m["loss"]), single, np.float32(loss),
            [np.asarray(g["w"][s]) for s in range(2)])


def test_distributed_1f1b_bitwise_vs_reference(runtime):
    """The acceptance pin: 2 CPU stage actors of the port, one 1F1B
    step: loss and per-stage grads bitwise the reference's single-host
    step and ``pipeline_apply``'s gradients."""
    w, x, t = _int_data()
    before = _counters(runtime)
    tr = _trainer(w)
    assert tr.distributed
    metrics = tr.step(x, t)
    after = [p["w"] for p in tr.get_stage_params()]
    # sgd(lr=1.0): the applied update IS the mean micro-batch gradient.
    grads = [b - a for b, a in zip((w[:2], w[2:]), after)]
    assert [s["applied_step"] for s in tr.stage_stats()] == [0, 0]
    tr.shutdown()

    ref_single_loss, ref_single, ref_loss, ref_grads = \
        _reference_step(w, x, t)
    assert np.float32(metrics["loss"]) == ref_single_loss == ref_loss
    for s in range(2):
        np.testing.assert_array_equal(after[s], ref_single[s])
        np.testing.assert_array_equal(grads[s], ref_grads[s])

    # (pp-1) * M activations forward plus (pp-1) * M grads backward.
    time.sleep(1.2)
    got = _counters(runtime)
    assert got["microbatch_pushes"] - before["microbatch_pushes"] >= 2 * M
    assert got["stage_restarts"] == before["stage_restarts"]


LATE_FLUSH_S = 30.0


class _LateFlushStageFn:
    """``_stage_fn``, which, unpickled in a stage's process (its actor's
    constructor), makes that worker's periodic and queue-drain flush of
    counter deltas ship nothing for ``LATE_FLUSH_S``: a late tick, held
    open for as long as the test needs it."""

    def __call__(self, sp, x):
        return _stage_fn(sp, x)

    def __getstate__(self):
        return {"late_s": LATE_FLUSH_S}

    def __setstate__(self, state):
        from ray_tpu_torch._private import worker_main

        rt = worker_main.get_worker_runtime()
        if rt is None or getattr(rt, "_late_flush", False):
            return
        flush, since = rt.flush_xfer_stats, time.monotonic()

        def late_flush():
            if time.monotonic() - since >= state["late_s"]:
                flush()

        rt.flush_xfer_stats = late_flush
        rt._late_flush = True


def test_stage_counters_reach_the_head_before_its_kill(runtime):
    """A stage's counters do not wait for its periodic flush: with that
    flush held back in both stages, one 1F1B step and an immediate
    ``shutdown()`` (``ray.kill`` of the stages) still leave the step's
    (pp-1) * M + (pp-1) * M pushes at the head, as the pin above reads
    them."""
    from ray_tpu_torch.train import sgd

    w, x, t = _int_data()
    before = _counters(runtime)
    tr = PipelineTrainer(
        _LateFlushStageFn(), _loss_fn, [{"w": w[:2]}, {"w": w[2:]}],
        optimizer=sgd(1.0), num_microbatches=M, device="cpu")
    assert tr.distributed
    t0 = time.monotonic()
    tr.step(x, t)
    tr.shutdown()
    assert time.monotonic() - t0 < LATE_FLUSH_S
    time.sleep(1.2)
    got = _counters(runtime)
    assert got["microbatch_pushes"] - before["microbatch_pushes"] >= 2 * M


def test_fill_drain_matches_1f1b_and_single_host(runtime):
    """The fill/drain baseline and the single-host path compute the
    1F1B step bitwise, over two steps."""
    w, x, t = _int_data(seed=3)
    runs = []
    for kw in ({"schedule": "fill_drain"}, {"schedule": "1f1b"}, None):
        tr = _trainer(w, distributed=kw is not None)
        losses = [tr.step(x, t, **(kw or {}))["loss"] for _ in range(2)]
        runs.append((losses, tr.get_stage_params()))
        tr.shutdown()
    for losses, params in runs[1:]:
        assert losses == runs[0][0]
        for a, b in zip(params, runs[0][1]):
            np.testing.assert_array_equal(a["w"], b["w"])


def test_switch_off_is_single_host_with_zero_counters(runtime,
                                                      monkeypatch):
    """``distributed_training`` off in the runtime's config: the trainer
    takes the single-host path, M falls back to the config's
    ``pipeline_microbatches``, and no counter moves."""
    monkeypatch.setattr(runtime.config, "distributed_training", False)
    monkeypatch.setattr(runtime.config, "pipeline_microbatches", 6)
    w, x, t = _int_data()
    before = _counters(runtime)
    tr = _trainer(w, num_microbatches=0)  # 0 -> the config knob (6)
    assert not tr.distributed and tr.num_microbatches == 6
    tr = _trainer(w)                      # 6 does not divide 8: use 4
    assert not tr.distributed
    tr.step(x, t)
    time.sleep(1.0)
    assert _counters(runtime) == before


def test_stage_kill_restores_with_bounded_replay(runtime):
    """Kill the last stage between steps: the actor restores from its
    ``__ray_save__`` checkpoint and the trajectory is bitwise an
    uninterrupted run's (the reference's ``test_inflight_replay_after_
    stage_kill``)."""
    w, x, t = _int_data()
    before = _counters(runtime)
    tr = _trainer(w)
    losses = [tr.step(x, t)["loss"] for _ in range(2)]
    pids = tr.stage_pids()
    time.sleep(0.5)  # let the post-call checkpoint message land
    os.kill(pids[1], 9)
    losses += [tr.step(x, t)["loss"] for _ in range(2)]
    final = tr.get_stage_params()
    assert tr.stage_pids()[1] != pids[1]
    tr.shutdown()

    ref = _trainer(w, distributed=False)
    want = [ref.step(x, t)["loss"] for _ in range(4)]
    assert [np.float32(v) for v in losses] == [np.float32(v) for v in want]
    for a, b in zip(final, ref.get_stage_params()):
        np.testing.assert_array_equal(a["w"], b["w"])
    time.sleep(1.2)
    assert _counters(runtime)["stage_restarts"] >= \
        before["stage_restarts"] + 1


def test_bf16_stages_cross_the_object_plane_bitwise(runtime):
    """bf16 params, batch and stage outputs (the flagship's activation
    dtype) through 2 CPU stage actors: the activations and their grads
    cross as tagged int16 bits, and a stage killed between the steps
    restores its bf16 params from its checkpoint.  Losses and params are
    bitwise the single-host path's."""
    import torch

    from ray_tpu_torch.train.pipeline_actors import _Bf16Bits

    def bf16(a):
        return torch.from_numpy(a).to(torch.bfloat16)

    w, x, t = _int_data(seed=5)
    stages = [{"w": bf16(w[:2])}, {"w": bf16(w[2:])}]
    x, t = bf16(x), bf16(t)
    before = _counters(runtime)

    def trainer(**kw):
        from ray_tpu_torch.train import sgd

        return PipelineTrainer(_stage_fn, _loss_fn, stages,
                               optimizer=sgd(1.0), num_microbatches=M,
                               device="cpu", **kw)

    tr = trainer()
    assert tr.distributed
    losses = [tr.step(x, t)["loss"]]
    pid0 = tr.stage_pids()[0]
    time.sleep(0.5)  # let the post-call checkpoint message land
    os.kill(pid0, 9)
    losses.append(tr.step(x, t)["loss"])
    final = tr.get_stage_params()
    assert tr.stage_pids()[0] != pid0
    tr.shutdown()

    ref = trainer(distributed=False)
    want = [ref.step(x, t)["loss"] for _ in range(2)]
    assert losses == want
    for a, b in zip(final, ref.get_stage_params()):
        assert isinstance(a["w"], _Bf16Bits) and isinstance(b["w"],
                                                            _Bf16Bits)
        np.testing.assert_array_equal(a["w"].bits, b["w"].bits)
    time.sleep(1.2)
    got = _counters(runtime)
    assert got["microbatch_pushes"] - before["microbatch_pushes"] >= 4 * M
    assert got["stage_restarts"] >= before["stage_restarts"] + 1


def test_card_bound_trainer_without_a_card_raises(runtime):
    """No quiet CPU: a trainer that was not told ``device="cpu"`` needs
    the card (single-host path) or one card per stage (actor path)."""
    w, _, _ = _int_data()
    with pytest.raises(RuntimeError, match="2 cards"):
        _trainer(w, device=None)
    with pytest.raises(RuntimeError, match="CUDA"):
        _trainer(w, device=None, distributed=False)


def _llama_setup(num_layers=4):
    import jax

    from ray_tpu.models import llama as jax_llama
    from ray_tpu_torch.models import LlamaConfig, params_from_jax

    jcfg = jax_llama.LlamaConfig.tiny(num_layers=num_layers)
    jparams = jax.tree.map(np.asarray, jax_llama.init_params(
        jax.random.PRNGKey(0), jcfg))
    cfg = LlamaConfig.tiny(num_layers=num_layers)
    params = params_from_jax(jparams, cfg, "cpu")
    rng = np.random.default_rng(1)
    tok = rng.integers(0, cfg.vocab_size, size=(4, 9)).astype(np.int32)
    return jax_llama, jcfg, jparams, cfg, params, tok


def test_llama_stage_helpers_match_reference():
    """Splitting covers every layer once; the composed stage functions
    equal the reference's ``forward`` and the loss its ``loss_fn``."""
    import jax.numpy as jnp
    import torch

    from ray_tpu_torch.models import llama as L

    jax_llama, jcfg, jparams, cfg, params, tok = _llama_setup()
    sps = L.pipeline_stage_params(params, 2)
    assert "embed" in sps[0] and "lm_head" in sps[1]
    assert "embed" not in sps[1] and "lm_head" not in sps[0]
    assert [sp["layers"]["wq"].shape[0] for sp in sps] == [2, 2]
    with pytest.raises(ValueError):
        L.pipeline_stage_params(params, 3)
    inputs, targets = tok[:, :-1], tok[:, 1:]
    stage_fn = L.make_pipeline_stage_fn(cfg)
    y = torch.from_numpy(inputs).long()
    with torch.no_grad():
        for sp in sps:
            y = stage_fn(sp, y)
        loss = L.make_pipeline_loss_fn(cfg)(y, torch.from_numpy(targets))
    ref_logits, _ = jax_llama.forward(jparams, jnp.asarray(inputs), jcfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(ref_logits),
                               rtol=2e-5, atol=2e-5)
    _, ref_m = jax_llama.loss_fn(
        jparams, {"inputs": jnp.asarray(inputs),
                  "targets": jnp.asarray(targets)}, jcfg)
    np.testing.assert_allclose(float(loss), float(ref_m["loss"]),
                               rtol=2e-5, atol=2e-5)


def test_llama_two_stage_step_with_cpu_actors(runtime):
    """One 2-stage llama step through 2 CPU stage actors (f32, plain
    attention, 2 microbatches, sgd(0.5)) against the reference's
    single-host PipelineTrainer step with its own stage functions:
    loss and every updated param within 1e-5."""
    import optax

    from ray_tpu.train.pipeline_actors import PipelineTrainer as JaxTrainer
    from ray_tpu_torch.models import llama as L
    from ray_tpu_torch.train import sgd

    jax_llama, jcfg, jparams, cfg, params, tok = _llama_setup()
    inputs, targets = tok[:, :-1], tok[:, 1:]
    ref = JaxTrainer(jax_llama.make_pipeline_stage_fn(jcfg),
                     jax_llama.make_pipeline_loss_fn(jcfg),
                     jax_llama.pipeline_stage_params(jparams, 2),
                     optimizer=optax.sgd(0.5), num_microbatches=2,
                     distributed=False)
    want = ref.step(inputs, targets)
    want_params = ref.get_stage_params()

    tr = PipelineTrainer(L.make_pipeline_stage_fn(cfg),
                         L.make_pipeline_loss_fn(cfg),
                         L.pipeline_stage_params(params, 2),
                         optimizer=sgd(0.5), num_microbatches=2,
                         device="cpu")
    assert tr.distributed
    got = tr.step(inputs, targets)
    got_params = tr.get_stage_params()
    tr.shutdown()
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5,
                               atol=1e-5)
    for g, r in zip(got_params, want_params):
        assert set(g) == set(r) and set(g["layers"]) == set(r["layers"])
        for k in r["layers"]:
            np.testing.assert_allclose(g["layers"][k], r["layers"][k],
                                       rtol=1e-5, atol=1e-5, err_msg=k)
        for k in set(r) - {"layers"}:
            np.testing.assert_allclose(g[k], r[k], rtol=1e-5, atol=1e-5,
                                       err_msg=k)
