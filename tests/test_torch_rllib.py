"""The port's rllib on-policy stack (``ray_tpu_torch.rllib``) and the
optax-shaped transforms of ``train.core``, against the reference on CPU.

- ``sgd``/``adam`` (with and without the global-norm clip) against optax
  over 4 steps (1e-6).
- GAE equal to the reference's; V-trace against ``ray_tpu/rllib/vtrace.py``
  on fixed off-policy arrays (1e-6); ``ActorCriticMLP.apply`` on the
  reference's weights (1e-6).
- ``ppo_loss``/``impala_loss``/``appo_loss``: value and every grad against
  ``jax.value_and_grad`` of the reference's (1e-5).
- Two ``Learner.update`` calls against the JAX Learner from the same
  weights and batches (optax's ``chain(clip_by_global_norm, adam)``):
  metrics and weights within 1e-5.
- ``LearnerGroup(num_learners=2)`` against a single learner (the
  reference's ``tests/test_learner_group.py`` limits).
- The H2D queue's order and stall counting, the aggregator's time-major
  layout, the vector env, a checkpoint round trip, and a learner that
  was not told ``device="cpu"`` raising without a card.
- PPO learns CartPole within the reference's budget (12 iterations to
  ``episode_reward_mean >= 120``); IMPALA's distributed path (aggregators
  and the H2D queue) runs; APPO trains with target-network syncs.
  IMPALA's learning run is in the slow lane, as the reference's.

One runtime for the module.  The rollout workers unpickle this module's
``cartpole``, so it imports neither torch nor jax at its top.
"""

import numpy as np
import pytest

import ray_tpu_torch as ray
from ray_tpu_torch.rllib.sample_batch import (
    ACTIONS, ADVANTAGES, DONES, LOGP, NEXT_OBS, OBS, REWARDS, SampleBatch,
    VALUE_TARGETS, VF_PREDS)


@pytest.fixture(scope="module")
def runtime():
    rt = ray.init(num_cpus=8)
    yield rt
    ray.shutdown()


def cartpole():
    import gymnasium
    return gymnasium.make("CartPole-v1")


def _ppo_batch(n=64, obs_dim=6, num_actions=3, seed=0):
    rng = np.random.default_rng(seed)
    return SampleBatch({
        OBS: rng.normal(size=(n, obs_dim)).astype(np.float32),
        ACTIONS: rng.integers(num_actions, size=n).astype(np.int32),
        LOGP: rng.normal(scale=0.1, size=n).astype(np.float32) - 1.0,
        ADVANTAGES: rng.normal(size=n).astype(np.float32),
        VALUE_TARGETS: rng.normal(size=n).astype(np.float32),
    })


def _tm_batch(t=6, b=4, obs_dim=6, num_actions=3, seed=0, target=False):
    """A time-major IMPALA/APPO batch (with APPO's target riders)."""
    rng = np.random.default_rng(seed)
    out = {
        OBS: rng.normal(size=(t, b, obs_dim)).astype(np.float32),
        ACTIONS: rng.integers(num_actions, size=(t, b)).astype(np.int32),
        REWARDS: rng.normal(size=(t, b)).astype(np.float32),
        DONES: rng.random((t, b)) < 0.2,
        LOGP: (rng.normal(scale=0.3, size=(t, b)) - 1.1).astype(np.float32),
        "bootstrap_obs": rng.normal(size=(b, obs_dim)).astype(np.float32),
    }
    if target:
        out["target_logp"] = (rng.normal(scale=0.3, size=(t, b))
                              - 1.1).astype(np.float32)
        out["target_values"] = rng.normal(size=(t, b)).astype(np.float32)
        out["target_bootstrap"] = rng.normal(size=(b,)).astype(np.float32)
    return out


def _jax_weights(obs_dim=6, num_actions=3, hidden=(16, 16), seed=0):
    import jax

    from ray_tpu.rllib.models import ActorCriticMLP as JaxMLP

    return jax.tree.map(np.asarray, JaxMLP(obs_dim, num_actions, hidden)
                        .init(jax.random.PRNGKey(seed)))


def _leaves(tree):
    """Leaves in JAX's order (sorted dict keys, lists in order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


@pytest.mark.parametrize("opt", ["sgd", "adam", "adam_clip"])
def test_optimizers_match_optax(opt):
    import jax.numpy as jnp
    import optax
    import torch

    from ray_tpu_torch.train.core import adam, global_norm, sgd, tree_leaves

    rng = np.random.default_rng(0)
    params = {"a": rng.normal(size=(5, 3)).astype(np.float32),
              "b": [rng.normal(size=(3,)).astype(np.float32)]}
    grads = [{"a": rng.normal(size=(5, 3)).astype(np.float32),
              "b": [rng.normal(size=(3,)).astype(np.float32)]}
             for _ in range(4)]
    ours, ref = {"sgd": (sgd(0.1), optax.sgd(0.1)),
                 "adam": (adam(1e-2), optax.adam(1e-2)),
                 "adam_clip": (adam(1e-2, grad_clip=0.5), optax.chain(
                     optax.clip_by_global_norm(0.5), optax.adam(1e-2)))}[opt]
    p = {"a": torch.tensor(params["a"]), "b": [torch.tensor(params["b"][0])]}
    state = ours.init(p)
    jp = {"a": jnp.asarray(params["a"]), "b": [jnp.asarray(params["b"][0])]}
    jstate = ref.init(jp)
    for g in grads:
        tg = {"a": torch.tensor(g["a"]), "b": [torch.tensor(g["b"][0])]}
        ours.update_(tg, state, p, global_norm(tree_leaves(tg)))
        upd, jstate = ref.update(g, jstate, jp)
        jp = optax.apply_updates(jp, upd)
    for a, b in zip(_leaves(p), _leaves(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)


def test_gae_matches_reference():
    from ray_tpu.rllib.rollout_worker import compute_gae as jax_gae
    from ray_tpu_torch.rllib.rollout_worker import compute_gae

    rng = np.random.default_rng(0)

    def batch():
        r = np.random.default_rng(0)
        return SampleBatch({
            REWARDS: r.normal(size=20).astype(np.float32),
            VF_PREDS: r.normal(size=20).astype(np.float32),
            DONES: r.random(20) < 0.2})

    last = float(rng.normal())
    got = compute_gae(batch(), last, 0.97, 0.9)
    want = jax_gae(batch(), last, 0.97, 0.9)
    for k in (ADVANTAGES, VALUE_TARGETS):
        np.testing.assert_array_equal(got[k], want[k])


def test_vtrace_matches_reference():
    import jax.numpy as jnp
    import torch

    from ray_tpu.rllib.vtrace import vtrace as jax_vtrace
    from ray_tpu_torch.rllib.vtrace import vtrace

    t, b = 9, 5
    rng = np.random.default_rng(0)
    arrs = [rng.normal(scale=0.5, size=(t, b)).astype(np.float32) - 1.0,
            rng.normal(scale=0.5, size=(t, b)).astype(np.float32) - 1.0,
            rng.normal(size=(t, b)).astype(np.float32),
            rng.normal(size=(t, b)).astype(np.float32),
            rng.normal(size=(b,)).astype(np.float32),
            (0.99 * (rng.random((t, b)) > 0.2)).astype(np.float32)]
    for clip in ((1.0, 1.0), (0.8, 1.2)):
        got = vtrace(*map(torch.from_numpy, arrs), *clip)
        want = jax_vtrace(*map(jnp.asarray, arrs), *clip)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-6)


def test_actor_critic_apply_matches_reference():
    import jax.numpy as jnp
    import torch

    from ray_tpu.rllib.models import ActorCriticMLP as JaxMLP
    from ray_tpu_torch.rllib.models import ActorCriticMLP
    from ray_tpu_torch.train.pipeline_actors import to_device_tree

    w = _jax_weights()
    obs = np.random.default_rng(1).normal(size=(32, 6)).astype(np.float32)
    logits, values = ActorCriticMLP(6, 3, (16, 16)).apply(
        to_device_tree(w, "cpu"), torch.from_numpy(obs))
    jl, jv = JaxMLP(6, 3, (16, 16)).apply(w, jnp.asarray(obs))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(values.numpy(), np.asarray(jv), rtol=1e-6,
                               atol=1e-6)
    # init draws the reference's shapes (its numbers are jax.random's).
    mine = ActorCriticMLP(6, 3, (16, 16)).init(
        torch.Generator().manual_seed(0))
    assert [tuple(x.shape) for x in _leaves(mine)] == \
        [x.shape for x in _leaves(w)]


def _loss_pair(name):
    """(the port's loss, the reference's, batch maker)."""
    from ray_tpu.rllib import appo as jappo, impala as jimpala, ppo as jppo
    from ray_tpu_torch.rllib import appo, impala, ppo

    kw_appo = dict(gamma=0.97, clip_param=0.3, vf_coef=0.5, ent_coef=0.01,
                   clip_rho=1.0, clip_c=1.0)
    return {
        "ppo": (lambda p, m, b: ppo.ppo_loss(p, m, b, ent_coef=0.01),
                lambda p, m, b: jppo.ppo_loss(p, m, b, ent_coef=0.01),
                _ppo_batch),
        "impala": (lambda p, m, b: impala.impala_loss(p, m, b, gamma=0.97),
                   lambda p, m, b: jimpala.impala_loss(p, m, b, gamma=0.97),
                   _tm_batch),
        "appo": (lambda p, m, b: appo.appo_loss(p, m, b, **kw_appo),
                 lambda p, m, b: jappo.appo_loss(p, m, b, **kw_appo),
                 lambda: _tm_batch(target=True)),
    }[name]


@pytest.mark.parametrize("name", ["ppo", "impala", "appo"])
def test_loss_and_grads_match_jax(name):
    import jax
    import jax.numpy as jnp
    import torch

    from ray_tpu.rllib.models import ActorCriticMLP as JaxMLP
    from ray_tpu_torch.rllib.models import ActorCriticMLP
    from ray_tpu_torch.train.pipeline_actors import to_device_tree

    ours, ref, make = _loss_pair(name)
    w, batch = _jax_weights(), make()
    (jl, jm), jg = jax.value_and_grad(ref, has_aux=True)(
        w, JaxMLP(6, 3, (16, 16)), {k: jnp.asarray(v)
                                    for k, v in batch.items()})
    params = to_device_tree(w, "cpu")
    leaves = [p.requires_grad_() for p in _leaves(params)]
    loss, metrics = ours(params, ActorCriticMLP(6, 3, (16, 16)),
                         {k: torch.from_numpy(np.asarray(v))
                          for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5,
                               atol=1e-5)
    assert set(metrics) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(metrics[k].detach()), float(jm[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    for g, r in zip(grads, _leaves(jg)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-5)


def test_learner_update_matches_jax_learner():
    """Two updates of the port's Learner and of the reference's, from
    the reference's weights, on the same batches."""
    import jax
    import optax

    from ray_tpu.rllib.learner import Learner as JaxLearner
    from ray_tpu.rllib.models import ActorCriticMLP as JaxMLP
    from ray_tpu.rllib.ppo import ppo_loss as jax_ppo_loss
    from ray_tpu_torch.rllib import ActorCriticMLP, Learner
    from ray_tpu_torch.rllib.ppo import ppo_loss
    from ray_tpu_torch.train import adam

    ref = JaxLearner(JaxMLP(6, 3, (16, 16)), jax_ppo_loss,
                     optimizer=optax.chain(optax.clip_by_global_norm(0.5),
                                           optax.adam(1e-3)), seed=0)
    ours = Learner(ActorCriticMLP(6, 3, (16, 16)), ppo_loss,
                   optimizer=adam(1e-3, grad_clip=0.5), device="cpu")
    ours.set_weights(jax.tree.map(np.asarray, ref.get_weights()))
    for seed in (0, 1):
        batch = _ppo_batch(seed=seed)
        want = ref.update(batch)
        got = ours.update(batch)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       atol=1e-5, err_msg=k)
    for a, b in zip(_leaves(ours.get_weights()),
                    _leaves(jax.tree.map(np.asarray, ref.get_weights()))):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    # The optimizer state round-trips as numpy.
    state = ours.state()
    assert state["opt_state"]["count"] == 2
    again = Learner(ActorCriticMLP(6, 3, (16, 16)), ppo_loss,
                    optimizer=adam(1e-3, grad_clip=0.5), device="cpu")
    again.load_state(state)
    np.testing.assert_array_equal(again.update(_ppo_batch(seed=2))[
        "total_loss"], ours.update(_ppo_batch(seed=2))["total_loss"])


def test_learner_group_replicas_match_single_learner():
    """The reference's ``test_learner_group.py`` case: the data-parallel
    update over 2 replicas matches one learner (total_loss within 1e-4
    relative, weights within rtol 2e-4 / atol 2e-5 after 3 updates)."""
    from ray_tpu_torch.rllib import ActorCriticMLP, Learner, LearnerGroup
    from ray_tpu_torch.rllib.ppo import ppo_loss

    module = ActorCriticMLP(6, 3, hidden=(16,))
    single = Learner(module, ppo_loss, seed=3, device="cpu")
    group = LearnerGroup(
        lambda: Learner(module, ppo_loss, seed=3, device="cpu"),
        num_learners=2)
    assert len(group._learner._devices) == 2
    batch = _ppo_batch()
    for step in range(3):
        m1 = single.update(batch)
        m2 = group.update(batch)
        assert m1["total_loss"] == pytest.approx(m2["total_loss"],
                                                 rel=1e-4), step
    for a, b in zip(_leaves(single.get_weights()),
                    _leaves(group.get_weights())):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5)


def test_learner_group_matches_jax_learner_group():
    """The port's 2-replica group against the reference's
    ``LearnerGroup(num_learners=2)`` (a 2-device dp mesh over the CPU
    devices), from the reference group's weights, with the default
    optimizers (clip 0.5, adam 3e-4): metrics and weights within 1e-5
    over three updates on different batches."""
    import jax

    from ray_tpu.rllib.learner import Learner as JaxLearner
    from ray_tpu.rllib.learner import LearnerGroup as JaxLearnerGroup
    from ray_tpu.rllib.models import ActorCriticMLP as JaxMLP
    from ray_tpu.rllib.ppo import ppo_loss as jax_ppo_loss
    from ray_tpu_torch.rllib import ActorCriticMLP, Learner, LearnerGroup
    from ray_tpu_torch.rllib.ppo import ppo_loss

    ref = JaxLearnerGroup(
        lambda mesh=None: JaxLearner(JaxMLP(6, 3, (16, 16)), jax_ppo_loss,
                                     seed=3, mesh=mesh),
        num_learners=2)
    assert ref._learner._mesh.shape["dp"] == 2
    ours = LearnerGroup(
        lambda: Learner(ActorCriticMLP(6, 3, (16, 16)), ppo_loss,
                        device="cpu"),
        num_learners=2)
    assert len(ours._learner._devices) == 2
    ours._learner.set_weights(jax.tree.map(np.asarray, ref.get_weights()))
    for seed in range(3):
        batch = _ppo_batch(seed=seed)
        want = ref.update(batch)
        got = ours.update(batch)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       atol=1e-5, err_msg=f"{seed} {k}")
    for a, b in zip(_leaves(ours.get_weights()),
                    _leaves(jax.tree.map(np.asarray, ref.get_weights()))):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_learner_without_card_raises():
    """A learner that was not told ``device="cpu"`` needs the card."""
    from ray_tpu_torch.rllib import ActorCriticMLP, Learner
    from ray_tpu_torch.rllib.ppo import ppo_loss

    with pytest.raises(RuntimeError, match="CUDA"):
        Learner(ActorCriticMLP(4, 2), ppo_loss)


def test_h2d_queue_order_and_stalls():
    """The loader thread keeps FIFO order, hands out tensors on the
    device, and mirrors every stall into the module counter."""
    import torch

    from ray_tpu_torch.rllib.impala import _HostToDeviceQueue
    from ray_tpu_torch.train.pipeline_actors import train_stats

    base = train_stats()["learner_queue_stalls"]
    q = _HostToDeviceQueue(depth=2, device="cpu")
    try:
        for i in range(3):
            q.put({"x": np.full((4,), i, np.float32)})
        got = [q.get() for _ in range(3)]
        assert [int(g["x"][0]) for g in got] == [0, 1, 2]
        assert all(isinstance(g["x"], torch.Tensor) for g in got)
        st = q.queue_stats()
        assert st["gets"] == 3 and st["pinned_copies"] == 0
        assert st["stalls"] == \
            train_stats()["learner_queue_stalls"] - base
    finally:
        q.stop()


def test_aggregator_matches_to_time_major(runtime):
    from ray_tpu.rllib.impala import _to_time_major as jax_time_major
    from ray_tpu_torch.rllib.impala import _BatchAggregator, _to_time_major

    frag, n_envs, obs_dim = 5, 3, 4
    n = frag * n_envs

    @ray.remote
    def fake_sample(seed):
        rng = np.random.default_rng(seed)
        return SampleBatch({
            OBS: rng.normal(size=(n, obs_dim)).astype(np.float32),
            ACTIONS: rng.integers(0, 2, size=n).astype(np.int32),
            REWARDS: np.ones(n, np.float32),
            DONES: np.zeros(n, bool),
            LOGP: rng.normal(size=n).astype(np.float32),
            NEXT_OBS: rng.normal(size=(n, obs_dim)).astype(np.float32),
        })

    flat = ray.get(fake_sample.remote(7))
    agg = _BatchAggregator.options(num_cpus=1).remote()
    got = ray.get(agg.aggregate.remote(frag, fake_sample.remote(7)),
                  timeout=120)
    want = jax_time_major(flat, frag)
    assert set(got) == set(want) == set(_to_time_major(flat, frag))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert got[ACTIONS].shape == (frag, n_envs)
    ray.kill(agg)


def test_vector_env_autoreset():
    from ray_tpu_torch.rllib.env import VectorEnv

    venv = VectorEnv(cartpole, 3, seed=0)
    obs = venv.vector_reset()
    assert obs.shape == (3, 4)
    for _ in range(50):
        obs, rews, terms, truncs, finals, _ = venv.vector_step([0, 1, 0])
        assert obs.shape == (3, 4) and finals.shape == (3, 4)
        if (terms | truncs).any():
            break
    else:
        raise AssertionError("no episode terminated in 50 steps")
    venv.close()


def test_ppo_learns_cartpole_and_checkpoints(runtime):
    """The reference's PPO settings (2 workers x 2 envs, fragment 256,
    lr 3e-3, 8 SGD iterations, minibatch 256, entropy 0.01) reach
    ``episode_reward_mean >= 120`` within 12 iterations; a checkpoint of
    the trained algorithm restores into a fresh one."""
    from ray_tpu_torch.rllib import PPOConfig

    config = (PPOConfig()
              .environment(cartpole)
              .rollouts(num_rollout_workers=2, num_envs_per_worker=2,
                        rollout_fragment_length=256)
              .training(lr=3e-3, num_sgd_iter=8, sgd_minibatch_size=256,
                        entropy_coeff=0.01)
              .resources(learner_device="cpu"))
    algo = config.build()
    best = 0.0
    for _ in range(12):
        result = algo.train()
        best = max(best, result.get("episode_reward_mean", 0.0))
        if best >= 120.0:
            break
    blob = algo.save()
    w_before = algo.learner_group.get_weights()
    algo.stop()
    assert best >= 120.0, f"PPO failed to learn CartPole: best={best}"

    algo2 = (config.copy().rollouts(num_rollout_workers=1,
                                    num_envs_per_worker=1)).build()
    algo2.restore(blob)
    for a, b in zip(_leaves(w_before),
                    _leaves(algo2.learner_group.get_weights())):
        np.testing.assert_array_equal(a, b)
    algo2.stop()


def test_impala_distributed_and_appo_train(runtime):
    """IMPALA's distributed path (2 aggregators, the H2D queue) and APPO
    each take 3 ``train()`` calls: finite losses, steps sampled, the
    queue fed every update, APPO's target network synced."""
    from ray_tpu_torch.rllib import APPOConfig, ImpalaConfig

    algo = (ImpalaConfig().environment(cartpole)
            .rollouts(num_rollout_workers=2, num_envs_per_worker=2,
                      rollout_fragment_length=16)
            .training(lr=4e-3, num_aggregators=2, max_batches_per_step=4)
            .resources(learner_device="cpu")).build()
    assert len(algo._aggregators) == 2 and algo._h2d is not None
    for _ in range(3):
        result = algo.train()
        assert np.isfinite(result["total_loss"])
        assert result["num_env_steps_sampled"] > 0
    assert algo._h2d.queue_stats()["gets"] >= 3
    algo.stop()

    algo = (APPOConfig().environment(cartpole)
            .rollouts(num_rollout_workers=2, rollout_fragment_length=32)
            .training(max_batches_per_step=4, target_update_frequency=2)
            .resources(learner_device="cpu")).build()
    for _ in range(3):
        result = algo.train()
        assert np.isfinite(result["total_loss"])
        assert np.isfinite(result["mean_ratio"])
    assert algo.target_updates >= 3
    algo.stop()


@pytest.mark.slow
def test_impala_learns_cartpole(runtime):
    from ray_tpu_torch.rllib import ImpalaConfig

    algo = (ImpalaConfig()
            .environment(cartpole)
            .rollouts(num_rollout_workers=2, num_envs_per_worker=2,
                      rollout_fragment_length=64)
            .training(lr=4e-3, entropy_coeff=0.01)
            .resources(learner_device="cpu")).build()
    best = 0.0
    for _ in range(30):
        result = algo.train()
        best = max(best, result.get("episode_reward_mean", 0.0))
        if best >= 100.0:
            break
    algo.stop()
    assert best >= 100.0, f"IMPALA failed to learn CartPole: best={best}"
