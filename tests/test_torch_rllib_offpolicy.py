"""The port's off-policy rllib half (``ray_tpu_torch.rllib``: DQN, SAC and
the replay buffers) against the reference on CPU.

- ``dqn_loss``: value, ``td_errors``, ``mean_q`` and every grad against
  ``jax.value_and_grad`` of the reference's, double-Q on and off (1e-5);
  three updates of the port's DQN against the reference DQN's jitted
  ``_update`` from the same params, target and batch (1e-5).
- SAC: ``SquashedGaussianPolicy.sample`` on the same normal draws, rows
  with pre-tanh values beyond +-10 included (1e-5); one whole update
  (critic, actor, alpha, polyak) against the reference's jitted update,
  the port handed the two draws the reference takes from its key (1e-5).
- ``PrioritizedReplayBuffer`` and ``ReplayBuffer``: indices, weights and
  rows bitwise the reference's over one sequence of add, update and
  sample calls.
- DQN, SAC and multi-agent PPO (with CQL, BC and MARWIL) raise without a
  card when their learner device is left at ``None``.
- The reference's cases (``tests/test_rllib.py``): the prioritized replay
  semantics and the replay actor's round trip, a DQN save/restore round
  trip, and in the slow lane DQN learning CartPole.  SAC, which has no
  reference test, trains three ``train()`` calls on Pendulum-v1.

The algorithms under parity are built with their actors replaced by
stand-ins, so those tests need no runtime.  Rollout workers unpickle this
module's envs: it imports neither torch nor jax at its top.
"""

import types

import numpy as np
import pytest

import ray_tpu_torch as ray
from ray_tpu_torch.rllib.sample_batch import (
    ACTIONS, DONES, NEXT_OBS, OBS, REWARDS, SampleBatch)


@pytest.fixture(scope="module")
def runtime():
    rt = ray.init(num_cpus=8)
    yield rt
    ray.shutdown()


def cartpole():
    import gymnasium
    return gymnasium.make("CartPole-v1")


def pendulum():
    import gymnasium
    return gymnasium.make("Pendulum-v1")


def _leaves(tree):
    """Leaves in JAX's order (sorted dict keys, lists in order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _close(got, want, tol=1e-5, what=""):
    got, want = _leaves(got), _leaves(want)
    assert len(got) == len(want), what
    for a, b in zip(got, want):
        a = a.detach().cpu().numpy() if hasattr(a, "detach") else a
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                                   atol=tol, err_msg=what)


def _np(tree):
    import jax

    return jax.tree.map(np.asarray, tree)


def _torch(tree):
    from ray_tpu_torch.train.pipeline_actors import to_device_tree

    return to_device_tree(_np(tree), "cpu")


def _tensors(batch):
    import torch

    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


class _NoActor:
    """Stands in for an actor class: the update parity needs no runtime."""

    @classmethod
    def options(cls, **_):
        return cls

    @classmethod
    def remote(cls, *_, **__):
        return None


def _bare(monkeypatch, module, config):
    """``config.build()`` with no replay actor, no rollout workers and no
    weight syncs."""
    monkeypatch.setattr(module, "ReplayActor", _NoActor)
    monkeypatch.setattr(config.algo_class, "_sync_worker_weights",
                        lambda self: None)
    return config.rollouts(num_rollout_workers=0).build()


def _discrete_env(obs_dim=6, num_actions=3):
    return lambda: types.SimpleNamespace(
        observation_space=types.SimpleNamespace(shape=(obs_dim,)),
        action_space=types.SimpleNamespace(n=num_actions))


LOW, HIGH = np.array([-2.0, -1.0], np.float32), np.array([2.0, 1.0],
                                                         np.float32)


def _box_env(obs_dim=3):
    return lambda: types.SimpleNamespace(
        observation_space=types.SimpleNamespace(shape=(obs_dim,)),
        action_space=types.SimpleNamespace(shape=LOW.shape, low=LOW,
                                           high=HIGH))


def _dqn_batch(n=64, obs_dim=6, num_actions=3, seed=0):
    rng = np.random.default_rng(seed)
    return {
        OBS: rng.normal(size=(n, obs_dim)).astype(np.float32),
        ACTIONS: rng.integers(num_actions, size=n).astype(np.int32),
        REWARDS: rng.normal(size=n).astype(np.float32),
        NEXT_OBS: rng.normal(size=(n, obs_dim)).astype(np.float32),
        DONES: rng.random(n) < 0.2,
        "weights": rng.uniform(0.2, 1.0, size=n).astype(np.float32),
    }


def _q_weights(seed, obs_dim=6, num_actions=3, hidden=(16, 16)):
    import jax

    from ray_tpu.rllib.dqn import QNetworkMLP as JaxQ

    return _np(JaxQ(obs_dim, num_actions, hidden).init(
        jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("double_q", [True, False])
def test_dqn_loss_and_grads_match_jax(double_q):
    import jax
    import jax.numpy as jnp
    import torch

    from ray_tpu.rllib import dqn as jdqn
    from ray_tpu_torch.rllib import dqn

    params, target = _q_weights(0), _q_weights(1)
    batch = _dqn_batch()
    (jl, jaux), jg = jax.value_and_grad(jdqn.dqn_loss, has_aux=True)(
        params, target, jdqn.QNetworkMLP(6, 3, (16, 16)),
        {k: jnp.asarray(v) for k, v in batch.items()}, gamma=0.97,
        double_q=double_q)
    live = _torch(params)
    leaves = [p.requires_grad_() for p in _leaves(live)]
    loss, aux = dqn.dqn_loss(live, _torch(target),
                             dqn.QNetworkMLP(6, 3, (16, 16)),
                             _tensors(batch), gamma=0.97, double_q=double_q)
    grads = torch.autograd.grad(loss, leaves)
    _close([loss, aux["td_errors"], aux["mean_q"]],
           [jl, jaux["td_errors"], jaux["mean_q"]], what="loss")
    _close(list(grads), jg, what="grads")


def test_dqn_updates_match_jax(monkeypatch):
    """Three updates of the port's DQN against the reference DQN's jitted
    ``_update`` (``chain(clip_by_global_norm, adam)``, clipping on), from
    the same params and target, on one batch: losses, TD errors and
    params within 1e-5."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.rllib import dqn as jdqn
    from ray_tpu_torch.rllib import dqn

    def config(mod):
        return (mod.DQNConfig().environment(_discrete_env())
                .training(lr=1e-2, gamma=0.97, grad_clip=0.5,
                          model={"hidden": (16, 16)}))

    ref = _bare(monkeypatch, jdqn, config(jdqn))
    ours = _bare(monkeypatch, dqn,
                 config(dqn).resources(learner_device="cpu"))
    params, target = _np(ref.params), _q_weights(7)
    ours.params, ours.target_params = _torch(params), _torch(target)
    ours._opt_state = ours._optimizer.init(ours.params)
    jp, jo, jt = ref.params, ref._opt_state, jax.tree.map(jnp.asarray,
                                                            target)
    batch = _dqn_batch(seed=3)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    for step in range(3):
        jp, jo, jl, jaux = ref._update(jp, jt, jo, jbatch)
        loss, aux = ours._update(_tensors(batch))
        _close([loss, aux["td_errors"], aux["mean_q"]],
               [jl, jaux["td_errors"], jaux["mean_q"]], what=f"{step}")
    _close(ours.params, _np(jp), what="params")
    assert ours._opt_state["count"] == 3


def _pi_weights(seed, scale_out=1.0, obs_dim=3, hidden=(16, 16)):
    import jax

    from ray_tpu.rllib.sac import SquashedGaussianPolicy as JaxPolicy

    w = _np(JaxPolicy(obs_dim, 2, LOW, HIGH, hidden).init(
        jax.random.PRNGKey(seed)))
    w[-1] = {k: v * scale_out for k, v in w[-1].items()}
    return w


def test_squashed_gaussian_sample_matches_jax():
    """The same normal draws give the reference's actions and logp, on
    rows whose pre-tanh value lies beyond +-10 (where torch's softplus
    takes its linear branch) and rows inside it."""
    import jax
    import jax.numpy as jnp
    import torch

    from ray_tpu.rllib.sac import SquashedGaussianPolicy as JaxPolicy
    from ray_tpu_torch.rllib.models import mlp_apply
    from ray_tpu_torch.rllib.sac import SquashedGaussianPolicy

    params = _pi_weights(0, scale_out=6.0)
    obs = np.random.default_rng(0).normal(size=(64, 3)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    eps = jax.random.normal(key, (64, 2))
    ja, jlogp = JaxPolicy(3, 2, LOW, HIGH, (16, 16)).sample(
        params, jnp.asarray(obs), key)
    tp, tobs = _torch(params), torch.from_numpy(obs)
    a, logp = SquashedGaussianPolicy(3, 2, LOW, HIGH, (16, 16)).sample(
        tp, tobs, eps=torch.from_numpy(np.array(eps)))
    mu, log_std = mlp_apply(tp, tobs).chunk(2, dim=-1)
    pre = mu + log_std.clamp(-20, 2).exp() * torch.from_numpy(
        np.array(eps))
    assert (pre.abs() > 10).any() and (pre.abs() < 10).any()
    _close([a, logp], [ja, jlogp], what="sample")
    with pytest.raises(ValueError):
        SquashedGaussianPolicy(3, 2, LOW, HIGH).sample(tp, tobs)


def _sac_batch(n=32, obs_dim=3, seed=0):
    rng = np.random.default_rng(seed)
    return {
        OBS: rng.normal(size=(n, obs_dim)).astype(np.float32),
        ACTIONS: rng.uniform(LOW, HIGH, size=(n, 2)).astype(np.float32),
        REWARDS: rng.normal(size=n).astype(np.float32),
        NEXT_OBS: rng.normal(size=(n, obs_dim)).astype(np.float32),
        DONES: (rng.random(n) < 0.2).astype(np.float32),
    }


def test_sac_update_matches_jax(monkeypatch):
    """One whole update (critic, actor against the updated critic, alpha,
    polyak) against the reference SAC's jitted update from the same
    params, target and ``log_alpha``: the port takes the two draws the
    reference makes from ``kc, ka = split(key)``.  pi, q and target
    params, ``log_alpha`` and every metric within 1e-5."""
    import jax
    import jax.numpy as jnp
    import torch

    from ray_tpu.rllib import sac as jsac
    from ray_tpu_torch.rllib import sac

    def config(mod):
        return (mod.SACConfig().environment(_box_env())
                .training(lr=1e-2, critic_lr=2e-2, alpha_lr=5e-2,
                          tau=0.1, gamma=0.97, grad_clip=1.0,
                          model={"hidden": (16, 16)}))

    ref = _bare(monkeypatch, jsac, config(jsac))
    ours = _bare(monkeypatch, sac,
                 config(sac).resources(learner_device="cpu"))
    qt = {"q1": _np(jsac.QNetwork(3, 2, (16, 16)).init(
        jax.random.PRNGKey(11))),
        "q2": _np(jsac.QNetwork(3, 2, (16, 16)).init(
            jax.random.PRNGKey(12)))}
    ours.pi_params, ours.q_params = _torch(ref.pi_params), \
        _torch(ref.q_params)
    ours.q_target = _torch(qt)
    ours.log_alpha = torch.tensor(0.3)
    for opt, state, tree in (("_pi_opt", "_pi_state", "pi_params"),
                             ("_q_opt", "_q_state", "q_params"),
                             ("_a_opt", "_a_state", "log_alpha")):
        setattr(ours, state, getattr(ours, opt).init(getattr(ours, tree)))
    batch = _sac_batch()
    key = jax.random.PRNGKey(9)
    kc, ka = jax.random.split(key)
    eps_c, eps_a = (torch.from_numpy(np.asarray(jax.random.normal(k, (32,
                                                                     2))))
                    for k in (kc, ka))
    (pi, q, qtn, la, _, _, _, jm) = ref._update(
        ref.pi_params, ref.q_params, jax.tree.map(jnp.asarray, qt),
        jnp.asarray(0.3, jnp.float32), ref._pi_state, ref._q_state,
        ref._a_state, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    metrics = ours._update(_tensors(batch), eps_c, eps_a)
    assert set(metrics) == set(jm)
    for k in jm:
        _close(metrics[k], jm[k], what=k)
    _close(ours.pi_params, _np(pi), what="pi")
    _close(ours.q_params, _np(q), what="q")
    _close(ours.q_target, _np(qtn), what="q_target")
    _close(ours.log_alpha, la, what="log_alpha")


def _replay_calls(rb_mod):
    """One fixed sequence of add / update_priorities / sample calls on a
    prioritized and a uniform buffer; every sample's columns."""
    rng = np.random.default_rng(0)
    pr = rb_mod.PrioritizedReplayBuffer(capacity=48, alpha=0.7, seed=3)
    un = rb_mod.ReplayBuffer(capacity=48, seed=3)
    out = []
    for i in range(5):
        batch = SampleBatch({
            "x": rng.normal(size=(20, 2)).astype(np.float32),
            "a": np.arange(20, dtype=np.int32) + 20 * i})
        pr.add(batch)
        un.add(batch)
        s = pr.sample(16, beta=0.4 + 0.1 * i)
        out.append(dict(s))
        pr.update_priorities(s["batch_indexes"],
                             rng.normal(size=16) * (i + 1))
        out.append(dict(un.sample(8)))
    return out


def test_prioritized_replay_bitwise_reference():
    from ray_tpu.rllib import replay_buffers as jrb
    from ray_tpu_torch.rllib import replay_buffers as rb

    got, want = _replay_calls(rb), _replay_calls(jrb)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("algo", ["DQN", "SAC", "PPO-multi-agent", "CQL",
                                  "BC", "MARWIL"])
def test_entry_points_raise_without_card(algo, tmp_path):
    """A learner device left at ``None`` is the card: with none, every
    new entry point raises rather than running on the CPU."""
    from ray_tpu_torch import rllib

    path = str(tmp_path / "data.json")
    w = rllib.JsonWriter(path)
    w.write(SampleBatch({k: v for k, v in _dqn_batch().items()
                         if k != "weights"}))
    w.close()
    config = {
        "DQN": lambda: rllib.DQNConfig().environment(_discrete_env()),
        "SAC": lambda: rllib.SACConfig().environment(_box_env()),
        "PPO-multi-agent": lambda: (
            rllib.PPOConfig().environment(_discrete_env())
            .multi_agent(policies={"p0": None})),
        "CQL": lambda: rllib.CQLConfig().offline_data(input_path=path),
        "BC": lambda: rllib.BCConfig().offline_data(input_path=path),
        "MARWIL": lambda: rllib.MARWILConfig().offline_data(
            input_path=path),
    }[algo]()
    with pytest.raises(RuntimeError, match="CUDA"):
        config.build()


def test_prioritized_replay_semantics():
    from ray_tpu_torch.rllib.replay_buffers import PrioritizedReplayBuffer

    buf = PrioritizedReplayBuffer(capacity=100, alpha=1.0, seed=0)
    buf.add(SampleBatch({"x": np.arange(100)}))
    # uniform priorities first; then make one item dominate
    buf.update_priorities(np.arange(100), np.full(100, 1e-6))
    buf.update_priorities(np.array([7]), np.array([1e6]))
    s = buf.sample(64, beta=0.0)
    assert (s["batch_indexes"] == 7).mean() > 0.9
    # importance weights: beta=1 gives w ∝ 1/P, normalized to max 1
    s = buf.sample(64, beta=1.0)
    assert s["weights"].max() <= 1.0 + 1e-6


def test_replay_actor_roundtrip(runtime):
    from ray_tpu_torch.rllib.replay_buffers import ReplayActor

    actor = ReplayActor.remote(capacity=1000, prioritized=True)
    n = ray.get(actor.add.remote(dict(SampleBatch(
        {"x": np.arange(50, dtype=np.int64)}))))
    assert n == 50
    out = ray.get(actor.sample.remote(16))
    assert len(out["x"]) == 16
    ray.get(actor.update_priorities.remote(out["batch_indexes"],
                                           np.ones(16)))
    ray.kill(actor)


def test_dqn_checkpoint_restore_roundtrip(runtime):
    """The pattern of ``test_checkpoint_restore_roundtrip`` for DQN:
    after learning starts, a checkpoint restores params, target and
    optimizer state into a fresh DQN bitwise, and it trains on."""
    from ray_tpu_torch.rllib import DQNConfig

    config = (DQNConfig().environment(cartpole)
              .rollouts(num_rollout_workers=1, rollout_fragment_length=64)
              .training(num_steps_sampled_before_learning=64,
                        num_train_batches_per_step=4,
                        target_network_update_freq=64)
              .resources(learner_device="cpu"))
    algo = config.build()
    for _ in range(2):
        result = algo.train()
    assert np.isfinite(result["loss"]) and algo.target_syncs == 2
    blob = algo.save()
    state = algo.save_checkpoint()
    algo.stop()
    algo2 = config.copy().build()
    algo2.restore(blob)
    got = algo2.save_checkpoint()
    assert got["steps"] == state["steps"] == 128
    assert got["opt_state"]["count"] == state["opt_state"]["count"] == 8
    for k in ("params", "target_params", "opt_state"):
        for a, b in zip(_leaves(got[k]), _leaves(state[k])):
            np.testing.assert_array_equal(a, b, err_msg=k)
    assert np.isfinite(algo2.train()["loss"])
    algo2.stop()


def test_sac_trains_on_pendulum(runtime):
    """SAC has no reference test: three ``train()`` calls past warm-up on
    Pendulum-v1 give finite losses and move alpha off its initial 1.0."""
    from ray_tpu_torch.rllib import SACConfig

    algo = (SACConfig().environment(pendulum)
            .rollouts(num_rollout_workers=1, rollout_fragment_length=100)
            .training(num_steps_sampled_before_learning=200,
                      warmup_uniform_steps=200, train_batch_size=64,
                      num_train_batches_per_step=8)
            .resources(learner_device="cpu")).build()
    results = [algo.train() for _ in range(4)]
    algo.stop()
    assert "critic_loss" not in results[0]
    for r in results[1:]:
        for k in ("critic_loss", "actor_loss", "alpha", "entropy"):
            assert np.isfinite(r[k]), (k, r)
    assert results[-1]["alpha"] != 1.0
    assert results[-1]["num_env_steps_sampled"] == 400


@pytest.mark.slow
def test_dqn_learns_cartpole(runtime):
    from ray_tpu_torch.rllib import DQNConfig

    config = (DQNConfig()
              .environment(cartpole)
              .rollouts(num_rollout_workers=2, num_envs_per_worker=2,
                        rollout_fragment_length=64)
              .training(lr=1e-3, num_steps_sampled_before_learning=500,
                        epsilon_timesteps=4000,
                        target_network_update_freq=500)
              .resources(learner_device="cpu"))
    algo = config.build()
    best = 0.0
    for _ in range(30):
        result = algo.train()
        best = max(best, result.get("episode_reward_mean", 0.0))
        if best >= 100.0:
            break
    algo.stop()
    assert best >= 100.0, f"DQN failed to learn CartPole: best={best}"
