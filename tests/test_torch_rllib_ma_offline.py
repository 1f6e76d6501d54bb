"""The port's multi-agent and offline rllib half (``ray_tpu_torch.rllib``:
``multi_agent.py``, PPO's multi-agent branch, ``offline.py``) against the
reference on CPU.

- Multi-agent PPO: one update of each policy's learner against the
  reference's multi-agent ``Learner`` s (their seeds, clip and adam), from
  the same weights and minibatch (1e-5); two ``train()`` calls of a
  two-policy PPO through the runtime.
- CQL: three updates with a target sync between them against the
  reference CQL's jitted update (1e-5).  BC and MARWIL: the loss and one
  ``Learner.update`` each (1e-5), MARWIL's ``_with_returns`` bitwise.
- JSON: a file the reference's ``JsonWriter`` writes is read by the
  port's ``JsonReader`` (and the other way round) batch for batch, in the
  same order for the same seed; both writers write the same bytes.
- IS/WIS: the same estimates within 1e-9 on the same logged data.
- The reference's own cases (``tests/test_rllib_ma_offline.py``): BC,
  MARWIL, CQL and IS/WIS on logged data, the seven turn-based and horizon
  cases of the multi-agent rollout worker (weights from the port's
  ``ActorCriticMLP.init``), and in the slow lane two-policy PPO learning
  ``TwoAgentMatch``.

Rollout workers unpickle this module's envs: it imports neither torch nor
jax at its top (``MultiAgentEnv`` loads no torch).
"""
import numpy as np
import pytest

import ray_tpu_torch as ray
from ray_tpu_torch.rllib import MultiAgentEnv, SampleBatch
from ray_tpu_torch.rllib.sample_batch import (
    ACTIONS, DONES, LOGP, NEXT_OBS, OBS, REWARDS,
)


@pytest.fixture(scope="module")
def cluster():
    ray.init(num_cpus=4, ignore_reinit_error=True)
    yield
    ray.shutdown()


def _generator():
    import torch

    return torch.Generator().manual_seed(0)


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


class TwoAgentMatch(MultiAgentEnv):
    """Cooperative: each agent sees a one-hot cue and must answer with the
    matching action; both agents' rewards sum per step.  Solvable to
    reward 2.0/step."""

    N = 4
    HORIZON = 8
    agent_ids = ["a0", "a1"]

    def __init__(self):
        self._rng = np.random.default_rng(0)
        self._t = 0
        self._cues = {}

    class _Box:
        shape = (4,)

    class _Disc:
        n = 4

    observation_space = _Box()
    action_space = _Disc()

    def _obs(self):
        out = {}
        for a in self.agent_ids:
            cue = int(self._rng.integers(self.N))
            self._cues[a] = cue
            vec = np.zeros(self.N, np.float32)
            vec[cue] = 1.0
            out[a] = vec
        return out

    def reset(self, *, seed=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._t = 0
        return self._obs(), {}

    def step(self, action_dict):
        self._t += 1
        rews = {a: float(action_dict[a] == self._cues[a])
                for a in self.agent_ids}
        done = self._t >= self.HORIZON
        obs = self._obs()
        terms = {a: done for a in self.agent_ids}
        terms["__all__"] = done
        truncs = {"__all__": False}
        return obs, rews, terms, truncs, {}


@pytest.mark.slow  # ~8s of PPO convergence; the "X learns" battery is
# slow-tier by convention (test_rllib.py)
def test_two_policy_ppo_learns(cluster):
    from ray_tpu_torch.rllib import PPOConfig

    cfg = (PPOConfig()
           .environment(TwoAgentMatch)
           .rollouts(num_rollout_workers=2, rollout_fragment_length=128)
           .training(lr=3e-3, num_sgd_iter=4, sgd_minibatch_size=64)
           .multi_agent(policies={"p0": None, "p1": None},
                        policy_mapping_fn=lambda aid: "p" + aid[-1])
           .resources(learner_device="cpu"))
    algo = cfg.build()
    first = None
    last = {}
    for i in range(12):
        last = algo.step()
        if first is None and "episode_reward_mean" in last:
            first = last["episode_reward_mean"]
    algo.cleanup()
    # Max is 16.0/episode (2 agents x 8 steps); random is ~4.
    assert last.get("episode_reward_mean", 0.0) > 9.0, (first, last)
    assert last["num_agent_steps_sampled"] == \
        2 * last["num_env_steps_sampled"]


def test_two_policy_ppo_trains_and_checkpoints(cluster):
    """Two ``train()`` calls of a two-policy PPO through the runtime: each
    policy's learner updates, agent steps are twice the env steps, and a
    checkpoint restores both learners into a fresh algorithm."""
    from ray_tpu_torch.rllib import PPOConfig

    cfg = (PPOConfig()
           .environment(TwoAgentMatch)
           .rollouts(num_rollout_workers=1, rollout_fragment_length=32)
           .training(num_sgd_iter=2, sgd_minibatch_size=32)
           .multi_agent(policies={"p0": None, "p1": None},
                        policy_mapping_fn=policy_of)
           .resources(learner_device="cpu"))
    algo = cfg.build()
    for _ in range(2):
        result = algo.train()
    assert np.isfinite(result["p0/total_loss"])
    assert np.isfinite(result["p1/total_loss"])
    assert result["num_agent_steps_sampled"] == \
        2 * result["num_env_steps_sampled"] == 64
    blob = algo.save()
    want = {pid: lr.get_weights() for pid, lr in algo.learners.items()}
    algo.stop()
    algo2 = cfg.copy().build()
    algo2.restore(blob)
    for pid, w in want.items():
        for a, b in zip(_leaves(algo2.learners[pid].get_weights()),
                        _leaves(w)):
            np.testing.assert_array_equal(a, b)
    algo2.stop()


def policy_of(agent_id):
    """A checkpoint pickles the config: a named mapping, not a lambda."""
    return "p" + agent_id[-1]


class _NoWorkers:
    """Stands in for the multi-agent fleet: the update parity needs no
    runtime."""

    def __init__(self, *_, **__):
        pass

    def sync_weights(self, _):
        pass


def _ppo_batch(n=64, seed=0):
    from ray_tpu_torch.rllib.sample_batch import ADVANTAGES, VALUE_TARGETS

    rng = np.random.default_rng(seed)
    return SampleBatch({
        OBS: rng.normal(size=(n, 4)).astype(np.float32),
        ACTIONS: rng.integers(4, size=n).astype(np.int32),
        LOGP: rng.normal(scale=0.1, size=n).astype(np.float32) - 1.4,
        ADVANTAGES: rng.normal(size=n).astype(np.float32),
        VALUE_TARGETS: rng.normal(size=n).astype(np.float32),
    })


def test_multi_agent_ppo_learners_match_jax(monkeypatch):
    """Each policy's learner of the port's multi-agent PPO against the
    reference's (one ``Learner`` per policy, seeded ``seed + i``, clip
    and adam from the config), from the reference learner's weights, on
    the same minibatch: metrics and weights within 1e-5."""
    from ray_tpu.rllib import PPOConfig as JaxPPOConfig
    from ray_tpu.rllib import multi_agent as jma
    from ray_tpu_torch.rllib import PPOConfig
    from ray_tpu_torch.rllib import multi_agent as ma

    def config(cls):
        return (cls().environment(TwoAgentMatch)
                .training(lr=3e-3, grad_clip=0.3, entropy_coeff=0.01,
                          model={"hidden": (16, 16)})
                .multi_agent(policies={"p0": None, "p1": None},
                             policy_mapping_fn=lambda aid: "p" + aid[-1]))

    monkeypatch.setattr(jma, "MultiAgentWorkerSet", _NoWorkers)
    monkeypatch.setattr(ma, "MultiAgentWorkerSet", _NoWorkers)
    ref = config(JaxPPOConfig).build()
    ours = config(PPOConfig).resources(learner_device="cpu").build()
    assert set(ours.learners) == set(ref.learners) == {"p0", "p1"}
    w0, w1 = (_np(ref.learners[p].get_weights()) for p in ("p0", "p1"))
    assert not np.array_equal(w0["pi"][0]["w"], w1["pi"][0]["w"])
    for i, pid in enumerate(("p0", "p1")):
        ours.learners[pid].set_weights(_np(ref.learners[pid].get_weights()))
        batch = _ppo_batch(seed=i)
        want = ref.learners[pid].update(batch)
        got = ours.learners[pid].update(batch)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       atol=1e-5, err_msg=f"{pid} {k}")
        _close(ours.learners[pid].get_weights(),
               _np(ref.learners[pid].get_weights()), what=pid)


def test_multi_agent_ppo_remote_learner_raises(monkeypatch):
    from ray_tpu_torch.rllib import PPOConfig

    cfg = (PPOConfig().environment(TwoAgentMatch)
           .multi_agent(policies={"p0": None})
           .resources(remote_learner=True, learner_device="cpu"))
    with pytest.raises(NotImplementedError, match="remote_learner"):
        cfg.build()


def _logged_batches(tmp_path, n_batches=24, steps=64, good=0.8, seed=0):
    """Behavior policy: picks the correct cue-matching action with prob
    ``good``, else uniform — logged with true action probs."""
    from ray_tpu_torch.rllib import JsonWriter

    rng = np.random.default_rng(seed)
    path = str(tmp_path / "data.json")
    w = JsonWriter(path)
    N = 4
    for _ in range(n_batches):
        cues = rng.integers(N, size=steps)
        obs = np.eye(N, dtype=np.float32)[cues]
        greedy = rng.random(steps) < good
        acts = np.where(greedy, cues, rng.integers(N, size=steps))
        p = good * (acts == cues) + (1 - good) / N
        rews = (acts == cues).astype(np.float32)
        dones = np.zeros(steps, bool)
        dones[7::8] = True  # 8-step episodes
        nxt = np.eye(N, dtype=np.float32)[rng.integers(N, size=steps)]
        w.write(SampleBatch({
            OBS: obs, ACTIONS: acts.astype(np.int32), REWARDS: rews,
            DONES: dones, LOGP: np.log(p).astype(np.float32),
            NEXT_OBS: nxt,
        }))
    w.close()
    return path


def test_bc_learns_from_logged_data(tmp_path):
    from ray_tpu_torch.rllib import BCConfig

    path = _logged_batches(tmp_path)
    algo = (BCConfig()
            .offline_data(input_path=path, num_batches_per_step=12)
            .training(lr=1e-2)
            .resources(learner_device="cpu")
            .build())
    for _ in range(10):
        m = algo.step()
    assert m["bc_loss"] < 0.9, m
    obs = np.eye(4, dtype=np.float32)
    acts = algo.compute_actions(obs)
    # The behavior policy mostly matches the cue; BC must clone that.
    assert (acts == np.arange(4)).mean() >= 0.75, acts


def test_marwil_beats_behavior(tmp_path):
    from ray_tpu_torch.rllib import MARWILConfig

    path = _logged_batches(tmp_path, good=0.6)
    algo = (MARWILConfig()
            .offline_data(input_path=path, num_batches_per_step=12)
            .training(lr=1e-2, beta=1.0)
            .resources(learner_device="cpu")
            .build())
    for _ in range(12):
        algo.step()
    obs = np.eye(4, dtype=np.float32)
    acts = algo.compute_actions(obs)
    assert (acts == np.arange(4)).mean() >= 0.75, acts


def test_cql_learns_q_from_logged_data(tmp_path):
    from ray_tpu_torch.rllib import CQLConfig

    path = _logged_batches(tmp_path, good=0.7)
    algo = (CQLConfig()
            .offline_data(input_path=path, num_batches_per_step=12)
            .training(lr=1e-2, min_q_weight=1.0)
            .resources(learner_device="cpu")
            .build())
    for _ in range(12):
        m = algo.step()
    obs = np.eye(4, dtype=np.float32)
    acts = algo.compute_actions(obs)
    assert (acts == np.arange(4)).mean() >= 0.75, (acts, m)


def test_is_wis_estimators(tmp_path):
    """Target = always-correct policy; behavior = 70% correct.  IS/WIS
    must estimate the target's value ABOVE the behavior value."""
    from ray_tpu_torch.rllib import (
        ImportanceSampling, JsonReader, WeightedImportanceSampling)

    path = _logged_batches(tmp_path, good=0.7, n_batches=40)
    batch = JsonReader(path, shuffle=False).read_all()

    def target_logp(obs, actions):
        cue = np.argmax(obs, axis=-1)
        # near-deterministic correct policy
        p = np.where(actions == cue, 0.97, 0.01)
        return np.log(p)

    is_est = ImportanceSampling(target_logp, gamma=1.0).estimate(batch)
    wis_est = WeightedImportanceSampling(target_logp,
                                         gamma=1.0).estimate(batch)
    assert is_est["episodes"] > 100
    # Behavior: P(correct) = 0.7 + 0.3/4 = 0.775 -> ~6.2 per 8-step
    # episode; target ~7.8.
    assert is_est["v_behavior"] == pytest.approx(6.2, abs=0.5)
    assert wis_est["v_target"] > wis_est["v_behavior"]
    assert is_est["v_target"] > is_est["v_behavior"]
    assert wis_est["v_gain"] > 1.05


def test_json_round_trip_both_ways(tmp_path):
    """A file the reference writes, the port reads, and the other way
    round: the same bytes, and the same batches in the same order for the
    same seed (shuffled and in file order)."""
    from ray_tpu.rllib import offline as joffline
    from ray_tpu_torch.rllib import offline

    rng = np.random.default_rng(0)
    batches = [SampleBatch({
        OBS: rng.normal(size=(5, 3)).astype(np.float32),
        ACTIONS: rng.integers(4, size=5).astype(np.int32),
        REWARDS: rng.normal(size=5).astype(np.float32),
        DONES: rng.random(5) < 0.3,
        LOGP: rng.normal(size=5).astype(np.float32)}) for _ in range(6)]
    paths = {}
    for name, mod in (("ref", joffline), ("port", offline)):
        paths[name] = str(tmp_path / name / "data.json")
        w = mod.JsonWriter(paths[name])
        for b in batches:
            w.write(b)
        w.close()
    with open(paths["ref"], "rb") as f, open(paths["port"], "rb") as g:
        assert f.read() == g.read()
    for written, reader_mod, other in (("ref", offline, joffline),
                                       ("port", joffline, offline)):
        for shuffle in (True, False):
            got = reader_mod.JsonReader(paths[written], shuffle=shuffle,
                                        seed=3)
            want = other.JsonReader(paths[written], shuffle=shuffle,
                                    seed=3)
            for _ in range(9):  # past one pass: the order re-draws
                g, w = got.next(), want.next()
                assert set(g) == set(w)
                for k in w:
                    assert g[k].dtype == w[k].dtype
                    np.testing.assert_array_equal(g[k], w[k])
    first = offline.JsonReader(paths["ref"], shuffle=False).next()
    for k in batches[0]:
        np.testing.assert_array_equal(first[k], batches[0][k])


@pytest.mark.parametrize("weighted", [False, True])
def test_is_wis_match_reference(tmp_path, weighted):
    from ray_tpu.rllib import offline as joffline
    from ray_tpu_torch.rllib import offline

    path = _logged_batches(tmp_path, good=0.7, n_batches=10)
    batch = offline.JsonReader(path, shuffle=False).read_all()
    # episodes of 8 plus a ragged tail: cut the last one short
    batch = batch.slice(0, len(batch) - 3)

    def target_logp(obs, actions):
        cue = np.argmax(obs, axis=-1)
        return np.log(np.where(actions == cue, 0.9, 0.1 / 3))

    name = "WeightedImportanceSampling" if weighted else "ImportanceSampling"
    got = getattr(offline, name)(target_logp, gamma=0.95).estimate(batch)
    want = getattr(joffline, name)(target_logp, gamma=0.95).estimate(batch)
    assert set(got) == set(want) and got["episodes"] == want["episodes"]
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-9, abs=1e-9), k


@pytest.mark.parametrize("algo", ["BC", "MARWIL"])
def test_bc_marwil_loss_and_update_match_jax(tmp_path, algo):
    """The loss at the reference learner's weights and one
    ``Learner.update`` (adam, no clip) against the reference's, on a
    logged batch: 1e-5; MARWIL's returns-to-go bitwise."""
    import jax.numpy as jnp
    import torch

    from ray_tpu.rllib import offline as joffline
    from ray_tpu_torch.rllib import offline

    path = _logged_batches(tmp_path, n_batches=4)

    def config(mod):
        cfg = getattr(mod, algo + "Config")().offline_data(input_path=path)
        return cfg.training(lr=1e-2, model={"hidden": (16, 16)})

    ref = config(joffline).build()
    ours = config(offline).resources(learner_device="cpu").build()
    batch = ref.reader.next()
    if algo == "MARWIL":
        want_b, got_b = ref._with_returns(batch), ours._with_returns(batch)
        np.testing.assert_array_equal(got_b["returns"], want_b["returns"])
        batch = want_b
    w = _np(ref.learner.get_weights())
    ours.learner.set_weights(w)
    jl, jm = ref.learner._loss_fn(w, ref.module, {
        k: jnp.asarray(v) for k, v in batch.items()})
    tl, tm = ours.learner._loss_fn(ours.learner.params, ours.module, {
        k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()})
    _close([tl] + [tm[k] for k in sorted(jm)],
           [jl] + [jm[k] for k in sorted(jm)], what="loss")
    want = ref.learner.update(batch)
    got = ours.learner.update(batch)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    _close(ours.learner.get_weights(), _np(ref.learner.get_weights()),
           what="weights")


def test_cql_updates_match_jax(tmp_path):
    """Three CQL updates with a target sync between them against the
    reference CQL's jitted update, from the same params and target:
    metrics and params within 1e-5."""
    import jax
    import jax.numpy as jnp
    import torch

    from ray_tpu.rllib import offline as joffline
    from ray_tpu_torch.rllib import offline
    from ray_tpu_torch.train.pipeline_actors import to_device_tree

    path = _logged_batches(tmp_path, n_batches=4)

    def config(mod):
        return (mod.CQLConfig().offline_data(input_path=path)
                .training(lr=1e-2, gamma=0.97, min_q_weight=0.7,
                          model={"hidden": (16, 16)}))

    ref = config(joffline).build()
    ours = config(offline).resources(learner_device="cpu").build()
    params = _np(ref.params)
    target = _np(jax.tree.map(lambda x: x * 0.5, ref.params))
    ours.params = to_device_tree(params, "cpu")
    ours.target_params = to_device_tree(target, "cpu")
    ours._opt_state = ours._opt.init(ours.params)
    jp, jt, jo = ref.params, jax.tree.map(jnp.asarray, target), \
        ref._opt_state
    for step in range(3):
        batch = ref.reader.next()
        jp, jo, jm = ref._update(jp, jt, jo, {
            k: jnp.asarray(v) for k, v in batch.items()})
        got = ours._update({k: torch.from_numpy(np.asarray(v))
                            for k, v in batch.items()})
        assert set(got) == set(jm)
        for k in jm:
            _close(got[k], jm[k], what=f"{step} {k}")
        _close(ours.params, _np(jp), what=f"{step} params")
        jt = jax.tree.map(jnp.copy, jp)
        ours.target_params = to_device_tree(_np(jp), "cpu")


class TurnBasedDuel(MultiAgentEnv):
    """Strictly turn-based: exactly ONE agent acts per step (only it
    appears in the obs dict), but the env pays BOTH agents a reward on
    every step — the non-acting agent's reward arrives on a step where
    it has no entry in the action dict, the exact shape that used to be
    dropped from trajectories and episode returns."""

    HORIZON = 6
    agent_ids = ["a0", "a1"]

    class _Box:
        shape = (4,)

    class _Disc:
        n = 4

    observation_space = _Box()
    action_space = _Disc()

    def __init__(self):
        self._t = 0

    def _obs_for(self, aid):
        vec = np.zeros(4, np.float32)
        vec[int(aid[-1])] = 1.0
        return {aid: vec}

    def reset(self, *, seed=None):
        self._t = 0
        return self._obs_for("a0"), {}

    def step(self, action_dict):
        assert list(action_dict) == [self.agent_ids[self._t % 2]]
        self._t += 1
        done = self._t >= self.HORIZON
        # Acting agent earns 1.0; the OTHER (non-acting) agent earns 0.5
        # this same step — deliverable only via its last transition.
        actor = self.agent_ids[(self._t - 1) % 2]
        other = self.agent_ids[self._t % 2]
        rews = {actor: 1.0, other: 0.5}
        terms = {a: done for a in self.agent_ids}
        terms["__all__"] = done
        return (self._obs_for(self.agent_ids[self._t % 2]), rews, terms,
                {"__all__": False}, {})


def test_turn_based_rewards_credit_non_acting_agents():
    """Rewards returned for agents absent from the action dict must fold
    into their buffered last transition (trajectory) AND the episode
    return — a turn-based env's terminal rewards otherwise vanish."""
    from ray_tpu_torch.rllib.multi_agent import MultiAgentRolloutWorker

    worker_cls = MultiAgentRolloutWorker._cls  # in-process, no cluster
    w = worker_cls(TurnBasedDuel,
                   {"p": {"obs_dim": 4, "num_actions": 4}},
                   lambda aid: "p", seed=0)
    from ray_tpu_torch.rllib.models import ActorCriticMLP

    w.set_weights({"p": ActorCriticMLP(obs_dim=4, num_actions=4).init(
        _generator())})
    batch = w.sample(TurnBasedDuel.HORIZON)  # exactly one episode
    # Each step hands out 1.0 + 0.5; a0 never receives a1's final-step
    # 0.5 unless non-acting credit works.  Episode return = 6 * 1.5.
    returns = w.episode_returns()
    assert returns == [pytest.approx(TurnBasedDuel.HORIZON * 1.5)], returns
    # Trajectory-level: each agent acted HORIZON/2 times and every
    # waiting-step 0.5 landed on a transition (a1's first carries the
    # pre-first-action accrual AND the 0.5 earned right after it ->
    # 2.0; its last has no later waiting step -> 1.0).  Nothing of the
    # 9.0 total is dropped.
    b = batch["p"]
    assert len(b) == TurnBasedDuel.HORIZON  # 3 transitions per agent
    assert b[REWARDS].sum() == pytest.approx(9.0)
    np.testing.assert_allclose(np.sort(b[REWARDS]),
                               [1.0, 1.5, 1.5, 1.5, 1.5, 2.0])


def test_terminal_reward_after_horizon_flush_reaches_trajectory():
    """The sample horizon splitting an agent's last action from its
    off-turn terminal reward must not drop the reward: the horizon flush
    holds each agent's newest transition buffered, so the opponent's
    game-ending move in the NEXT sample() still credits a real
    transition (and flips its done flag) instead of evaporating with
    the episode reset."""
    from ray_tpu_torch.rllib.multi_agent import MultiAgentRolloutWorker

    worker_cls = MultiAgentRolloutWorker._cls  # in-process, no cluster
    w = worker_cls(TurnBasedDuel,
                   {"p": {"obs_dim": 4, "num_actions": 4}},
                   lambda aid: "p", seed=0)
    from ray_tpu_torch.rllib.models import ActorCriticMLP

    w.set_weights({"p": ActorCriticMLP(obs_dim=4, num_actions=4).init(
        _generator())})
    # Steps 1..5: episode NOT done; a0's last action (step 5) would be
    # flushed here, before its terminal 0.5 arrives on step 6.
    b1 = w.sample(TurnBasedDuel.HORIZON - 1)
    # Step 6: a1 acts, game ends, a0 is paid 0.5 off-turn.
    b2 = w.sample(1)
    assert w.episode_returns() == \
        [pytest.approx(TurnBasedDuel.HORIZON * 1.5)]
    # Held-back transitions ship with the terminal flush: 3 + 3 rows,
    # and the full 9.0 reaches trajectories across the two batches.
    assert len(b1["p"]) == 3 and len(b2["p"]) == 3
    total = b1["p"][REWARDS].sum() + b2["p"][REWARDS].sum()
    assert total == pytest.approx(9.0)
    # a0's held transition carries 1.0 (its action) + 0.5 (terminal,
    # off-turn) and is marked done; a1's held row stays mid-episode.
    np.testing.assert_allclose(np.sort(b2["p"][REWARDS]),
                               [1.0, 1.5, 1.5])
    assert b2["p"][DONES].sum() == 2  # a0 held + a1's acting row
    assert not b1["p"][DONES].any()


def test_turn_based_sample1_horizons_keep_terminal_rewards():
    """Turn-based detection must not depend on a buffered agent
    surviving into the next step: with sample(1) horizons every flush
    empties the buffers, so the env's declared roster (an agent absent
    from the action dict from step 1) is what flips the flag — and the
    full 9.0 still reaches trajectories across the six one-step
    batches."""
    from ray_tpu_torch.rllib.models import ActorCriticMLP
    from ray_tpu_torch.rllib.multi_agent import MultiAgentRolloutWorker

    worker_cls = MultiAgentRolloutWorker._cls
    w = worker_cls(TurnBasedDuel,
                   {"p": {"obs_dim": 4, "num_actions": 4}},
                   lambda aid: "p", seed=0)
    w.set_weights({"p": ActorCriticMLP(obs_dim=4, num_actions=4).init(
        _generator())})
    batches = [w.sample(1) for _ in range(TurnBasedDuel.HORIZON)]
    assert w._turn_based  # roster signal: a1 absent on step 1
    assert w.episode_returns() == \
        [pytest.approx(TurnBasedDuel.HORIZON * 1.5)]
    total = sum(float(b["p"][REWARDS].sum()) for b in batches
                if "p" in b.policy_batches)
    rows = sum(len(b["p"]) for b in batches
               if "p" in b.policy_batches)
    assert rows == TurnBasedDuel.HORIZON
    assert total == pytest.approx(9.0)


def test_simultaneous_env_horizon_flush_holds_nothing():
    """hold_last is gated on turn-based dynamics: a simultaneous-action
    env (every agent acts every step, off-turn rewards impossible) keeps
    the flush-everything horizon path — sample(1) returns both agents'
    transitions immediately, never an empty batch nor a one-transition
    training lag."""
    from ray_tpu_torch.rllib.models import ActorCriticMLP
    from ray_tpu_torch.rllib.multi_agent import MultiAgentRolloutWorker

    worker_cls = MultiAgentRolloutWorker._cls
    w = worker_cls(TwoAgentMatch,
                   {"p": {"obs_dim": 4, "num_actions": 4}},
                   lambda aid: "p", seed=0)
    w.set_weights({"p": ActorCriticMLP(obs_dim=4, num_actions=4).init(
        _generator())})
    b = w.sample(1)  # horizon cut after one simultaneous step
    assert len(b["p"]) == 2  # one transition per agent, nothing held


class RosterlessDuel(TurnBasedDuel):
    """Turn-based like the parent but (a) declares no ``agent_ids``
    roster and (b) pays the off-turn agent ONLY at game end — so
    neither the env's roster nor an early off-turn reward can flip the
    turn-based flag; only the seen-agents fallback can."""

    agent_ids = ()
    _CAST = ("a0", "a1")

    def step(self, action_dict):
        self._t += 1
        done = self._t >= self.HORIZON
        actor = self._CAST[(self._t - 1) % 2]
        rews = {actor: 1.0}
        if done:
            rews[self._CAST[self._t % 2]] = 3.0  # terminal, off-turn
        terms = {a: done for a in self._CAST}
        terms["__all__"] = done
        return (self._obs_for(self._CAST[self._t % 2]), rews, terms,
                {"__all__": False}, {})


def test_rosterless_env_seen_agents_fallback_keeps_terminal_reward():
    """Without a declared roster, agents OBSERVED this episode form the
    fallback roster: a0 sitting out step 2 flips the flag, so the
    horizon flush before the final step holds its newest transition and
    the off-turn terminal 3.0 still reaches a trajectory."""
    from ray_tpu_torch.rllib.models import ActorCriticMLP
    from ray_tpu_torch.rllib.multi_agent import MultiAgentRolloutWorker

    worker_cls = MultiAgentRolloutWorker._cls
    w = worker_cls(RosterlessDuel,
                   {"p": {"obs_dim": 4, "num_actions": 4}},
                   lambda aid: "p", seed=0)
    w.set_weights({"p": ActorCriticMLP(obs_dim=4, num_actions=4).init(
        _generator())})
    b1 = w.sample(RosterlessDuel.HORIZON - 1)
    assert w._turn_based  # flipped by the seen-agents roster at step 2
    b2 = w.sample(1)
    assert w.episode_returns() == [pytest.approx(9.0)]  # 6x1.0 + 3.0
    total = sum(float(b["p"][REWARDS].sum()) for b in (b1, b2)
                if "p" in b.policy_batches)
    assert total == pytest.approx(9.0)


def test_turn_based_truncation_bootstraps_off_turn_agents():
    """Time-limit truncation mid-game: the off-turn agent (absent from
    the final obs dict) must bootstrap from its last recorded value
    prediction, not a flat 0.0 that biases its advantages."""
    from ray_tpu_torch.rllib.models import ActorCriticMLP
    from ray_tpu_torch.rllib.multi_agent import MultiAgentRolloutWorker
    from ray_tpu_torch.rllib.sample_batch import ADVANTAGES, VF_PREDS

    class TruncatedDuel(TurnBasedDuel):
        def step(self, action_dict):
            obs, rews, terms, truncs, info = super().step(action_dict)
            if self._t >= 3:  # time limit BEFORE the game decides
                terms = {a: False for a in terms}
                truncs = {"__all__": True}
            return obs, rews, terms, truncs, info

    worker_cls = MultiAgentRolloutWorker._cls
    gamma = 0.97
    w = worker_cls(TruncatedDuel,
                   {"a0": {"obs_dim": 4, "num_actions": 4},
                    "a1": {"obs_dim": 4, "num_actions": 4}},
                   lambda aid: aid, seed=0, gamma=gamma)
    params = ActorCriticMLP(obs_dim=4, num_actions=4).init(_generator())
    w.set_weights({"a0": params, "a1": params})
    b = w.sample(3)  # steps 1-3; truncation after step 3, a0 off-turn
    a0 = b["a0"]
    # Last-row GAE delta with the VF bootstrap: r + g*vf - vf (done
    # False); with the old 0.0 bootstrap it would be r - vf.
    r, vf, adv = (float(a0[REWARDS][-1]), float(a0[VF_PREDS][-1]),
                  float(a0[ADVANTAGES][-1]))
    assert adv == pytest.approx(r + gamma * vf - vf, abs=1e-5)


class EarlyDropout(MultiAgentEnv):
    """Simultaneous-action env where a1 terminates on step 1 while the
    episode (and a0) continues: a1 then sits in the buffers without
    acting, which must NOT read as turn-based dynamics — its trajectory
    is done, not waiting a turn."""

    HORIZON = 4
    agent_ids = ["a0", "a1"]

    class _Box:
        shape = (4,)

    class _Disc:
        n = 4

    observation_space = _Box()
    action_space = _Disc()

    def __init__(self):
        self._t = 0

    def _obs(self, agents):
        return {a: np.zeros(4, np.float32) for a in agents}

    def reset(self, *, seed=None):
        self._t = 0
        return self._obs(self.agent_ids), {}

    def step(self, action_dict):
        self._t += 1
        done = self._t >= self.HORIZON
        rews = {a: 1.0 for a in action_dict}
        terms = {"a0": done, "a1": True, "__all__": done}
        live = ["a0"] if not done else []
        return self._obs(live), rews, terms, {"__all__": False}, {}


def test_early_terminated_agent_does_not_mark_turn_based():
    """An agent that terminated early in a simultaneous env must not
    flip the sticky turn-based flag: horizon flushes keep shipping every
    transition immediately (no hold-back lag) because no off-turn reward
    can ever arrive for a finished agent."""
    from ray_tpu_torch.rllib.models import ActorCriticMLP
    from ray_tpu_torch.rllib.multi_agent import MultiAgentRolloutWorker

    worker_cls = MultiAgentRolloutWorker._cls
    w = worker_cls(EarlyDropout,
                   {"p": {"obs_dim": 4, "num_actions": 4}},
                   lambda aid: "p", seed=0)
    w.set_weights({"p": ActorCriticMLP(obs_dim=4, num_actions=4).init(
        _generator())})
    # Steps 1-2: a1 dies on step 1, a0 plays on.  The horizon flush
    # after step 2 must ship ALL three transitions (a0 x2 + a1 x1).
    b1 = w.sample(2)
    assert not w._turn_based
    assert len(b1["p"]) == 3
    # Steps 3-4 end the episode; every step paid 1.0 per acting agent.
    w.sample(2)
    assert w.episode_returns() == [pytest.approx(5.0)]
