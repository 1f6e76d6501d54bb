"""DQN: off-policy Q-learning with prioritized replay and a target network
(counterpart: ``ray_tpu/rllib/dqn.py``).

Reference: ``rllib/algorithms/dqn/dqn.py`` (``training_step``: sample ->
store in replay -> train on prioritized batches -> update priorities ->
periodic target sync) with double-Q (van Hasselt) as the reference's
default.  CPU rollout workers act epsilon-greedily and push transitions
straight to a ReplayActor (the Ape-X arrangement); the learner's update
(loss -> autograd -> ``adam`` behind a global-norm clip) runs on the
learner's device, the card unless ``learner_device="cpu"``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

import ray_tpu_torch as ray
from ray_tpu_torch.remote_function import _bulk_submit
from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.env import VectorEnv
from ray_tpu_torch.rllib.models import mlp_apply, mlp_init
from ray_tpu_torch.rllib.replay_buffers import (
    BATCH_INDEXES, WEIGHTS, ReplayActor,
)
from ray_tpu_torch.rllib.sample_batch import (
    ACTIONS, DONES, NEXT_OBS, OBS, REWARDS, SampleBatch,
)


class QNetworkMLP:
    """obs -> Q(s, ·) MLP (reference: the default dueling-off q-model), a
    pure function of the reference's ``[{"w", "b"}, ...]`` tree."""

    def __init__(self, obs_dim: int, num_actions: int, hidden=(64, 64)):
        self.obs_dim = obs_dim
        self.num_actions = num_actions
        self.hidden = tuple(hidden)

    def init(self, generator):
        """He-normal weights from ``generator`` (a ``torch.Generator``),
        zero biases (``jax.random``'s numbers are not reproduced)."""
        return mlp_init(generator, (self.obs_dim,) + self.hidden
                        + (self.num_actions,))

    def apply(self, params, obs):
        return mlp_apply(params, obs)  # (B, num_actions)


def _take(values, idx):
    """``values[b, idx[b]]`` (``take_along_axis`` on the last axis)."""
    import torch

    return torch.gather(values, -1, idx[:, None].long())[:, 0]


@ray.remote
class DQNRolloutWorker:
    """Epsilon-greedy vectorized rollouts pushed directly to the replay
    actor (reference: Ape-X workers writing to replay shards).  A CPU
    actor: the Q-net runs on the CPU under ``no_grad``."""

    def __init__(self, env_maker, model_config: Dict[str, Any],
                 replay_actor, num_envs: int = 1, worker_index: int = 0,
                 seed: Optional[int] = None):
        self._venv = VectorEnv(env_maker, num_envs,
                               seed=(seed if seed is not None
                                     else worker_index))
        self._model = QNetworkMLP(**model_config)
        self._params = None
        self._replay = replay_actor
        self._rng = np.random.default_rng(
            seed if seed is not None else worker_index)
        self._obs = self._venv.vector_reset()
        self._ep_returns = np.zeros(num_envs)
        self._completed: List[float] = []

    def _q(self, obs) -> np.ndarray:
        import torch

        with torch.no_grad():
            return self._model.apply(self._params, torch.from_numpy(
                np.asarray(obs, np.float32))).numpy()

    def set_weights(self, weights):
        from ray_tpu_torch.train.pipeline_actors import to_device_tree

        self._params = to_device_tree(weights, "cpu")
        return True

    def sample(self, num_steps: int, epsilon: float) -> int:
        """Step envs for ``num_steps``; push transitions to replay.
        Returns env-steps collected."""
        assert self._params is not None, "set_weights first"
        n = self._venv.num_envs
        cols = {k: [] for k in (OBS, ACTIONS, REWARDS, NEXT_OBS, DONES)}
        for _ in range(num_steps):
            q = self._q(self._obs)
            acts = q.argmax(axis=-1)
            explore = self._rng.random(n) < epsilon
            acts = np.where(
                explore,
                self._rng.integers(0, q.shape[-1], size=n), acts)
            next_obs, rews, terms, truncs, finals, _ = \
                self._venv.vector_step(acts)
            cols[OBS].append(self._obs)
            cols[ACTIONS].append(acts)
            cols[REWARDS].append(rews)
            cols[NEXT_OBS].append(finals)  # pre-reset obs for bootstrap
            # DONES carries TERMINATION only: a time-limit truncation must
            # still bootstrap gamma*Q(final_obs) in the TD target.
            cols[DONES].append(terms)
            self._ep_returns += rews
            for i in np.nonzero(terms | truncs)[0]:
                self._completed.append(float(self._ep_returns[i]))
                self._ep_returns[i] = 0.0
            self._obs = next_obs
        batch = SampleBatch({
            OBS: np.concatenate(cols[OBS]).astype(np.float32),
            ACTIONS: np.concatenate(cols[ACTIONS]).astype(np.int32),
            REWARDS: np.concatenate(cols[REWARDS]).astype(np.float32),
            NEXT_OBS: np.concatenate(cols[NEXT_OBS]).astype(np.float32),
            DONES: np.concatenate(cols[DONES]),
        })
        ray.get(self._replay.add.remote(dict(batch)))
        return len(batch)

    def episode_returns(self, clear: bool = True) -> List[float]:
        out = list(self._completed)
        if clear:
            self._completed.clear()
        return out


class DQNConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 1e-3
        self.train_batch_size = 64
        self.replay_buffer_capacity = 100_000
        self.prioritized_replay = True
        self.prioritized_replay_alpha = 0.6
        self.prioritized_replay_beta = 0.4
        self.target_network_update_freq = 500   # env steps
        self.num_steps_sampled_before_learning = 1000
        self.epsilon_initial = 1.0
        self.epsilon_final = 0.05
        self.epsilon_timesteps = 10_000
        self.double_q = True
        self.num_train_batches_per_step = 16
        self.grad_clip = 10.0

    @property
    def algo_class(self):
        return DQN


def dqn_loss(params, target_params, module, batch, *, gamma: float,
             double_q: bool):
    """Double-DQN TD loss with importance weights; returns per-item TD
    errors for priority updates (reference: dqn_torch_policy.py).  The
    double-Q argmax keeps the first maximum, as ``jnp.argmax`` does."""
    q = module.apply(params, batch[OBS])
    q_sa = _take(q, batch[ACTIONS])
    q_next_target = module.apply(target_params, batch[NEXT_OBS])
    if double_q:
        q_next_online = module.apply(params, batch[NEXT_OBS])
        q_next = _take(q_next_target, q_next_online.argmax(dim=-1))
    else:
        q_next = q_next_target.max(dim=-1).values
    not_done = 1.0 - batch[DONES].float()
    target = batch[REWARDS] + gamma * not_done * q_next
    td = q_sa - target.detach()
    loss = (batch[WEIGHTS] * td.square()).mean()
    return loss, {"td_errors": td, "mean_q": q_sa.mean()}


def _copy_tree(tree):
    from ray_tpu_torch.train.trees import tree_map

    return tree_map(lambda t: t.detach().clone(), tree)


class DQN(Algorithm):
    config_class = DQNConfig

    def _setup(self, cfg: DQNConfig):
        import torch

        from ray_tpu_torch._private.device import resolve_device
        from ray_tpu_torch.train.core import adam
        from ray_tpu_torch.train.pipeline_actors import to_device_tree

        self._dev = resolve_device(cfg.learner_device)
        env = cfg.env_maker()
        obs_dim = int(np.prod(env.observation_space.shape))
        num_actions = int(env.action_space.n)
        if hasattr(env, "close"):
            env.close()
        model_config = {"obs_dim": obs_dim, "num_actions": num_actions,
                        "hidden": tuple(cfg.model.get("hidden", (64, 64)))}
        self.module = QNetworkMLP(**model_config)
        self.replay = ReplayActor.options(num_cpus=1).remote(
            capacity=cfg.replay_buffer_capacity,
            alpha=cfg.prioritized_replay_alpha,
            prioritized=cfg.prioritized_replay, seed=cfg.seed)
        self.workers = [
            DQNRolloutWorker.options(num_cpus=1).remote(
                cfg.env_maker, model_config, self.replay,
                num_envs=cfg.num_envs_per_worker, worker_index=i, seed=i)
            for i in range(cfg.num_rollout_workers)]
        # Drawn on the CPU so a seed gives the same weights on any device.
        self.params = to_device_tree(self.module.init(
            torch.Generator().manual_seed(cfg.seed)), self._dev)
        self.target_params = _copy_tree(self.params)
        self._optimizer = adam(cfg.lr, grad_clip=cfg.grad_clip)
        self._opt_state = self._optimizer.init(self.params)
        self._steps_sampled = 0
        self._steps_since_target_sync = 0
        self.target_syncs = 0
        self._sync_worker_weights()

    def _update(self, batch):
        """One update of ``params`` on a batch of device tensors; returns
        (loss, {"td_errors", "mean_q"}), detached, on the device."""
        from ray_tpu_torch.rllib.learner import grad_step

        cfg: DQNConfig = self.algo_config
        return grad_step(
            self.params, self._opt_state, self._optimizer,
            lambda p: dqn_loss(p, self.target_params, self.module, batch,
                               gamma=cfg.gamma, double_q=cfg.double_q))

    def _sync_worker_weights(self):
        from ray_tpu_torch.train.pipeline_actors import to_numpy_tree

        w = to_numpy_tree(self.params)
        ray.get(_bulk_submit([(wk.set_weights, (w,), None)
                              for wk in self.workers]))

    def _epsilon(self) -> float:
        cfg: DQNConfig = self.algo_config
        frac = min(1.0, self._steps_sampled / max(cfg.epsilon_timesteps, 1))
        return cfg.epsilon_initial + frac * (cfg.epsilon_final
                                             - cfg.epsilon_initial)

    def training_step(self) -> Dict[str, Any]:
        import torch

        cfg: DQNConfig = self.algo_config
        # 1. rollouts at the current epsilon -> replay actor
        eps = self._epsilon()
        steps = ray.get([w.sample.remote(cfg.rollout_fragment_length, eps)
                         for w in self.workers])
        self._steps_sampled += sum(steps)
        self._steps_since_target_sync += sum(steps)
        metrics: Dict[str, Any] = {"epsilon": eps,
                                   "num_env_steps_sampled":
                                       self._steps_sampled}
        # 2. learn from prioritized batches once warm
        if self._steps_sampled >= cfg.num_steps_sampled_before_learning:
            losses, qs = [], []
            for _ in range(cfg.num_train_batches_per_step):
                raw = ray.get(self.replay.sample.remote(
                    cfg.train_batch_size, cfg.prioritized_replay_beta))
                if raw is None:
                    break
                batch = {k: torch.from_numpy(np.asarray(v)).to(self._dev)
                         for k, v in raw.items() if k != BATCH_INDEXES}
                loss, aux = self._update(batch)
                if cfg.prioritized_replay:
                    self.replay.update_priorities.remote(
                        raw[BATCH_INDEXES], aux["td_errors"].cpu().numpy())
                losses.append(float(loss))
                qs.append(float(aux["mean_q"]))
            if losses:
                metrics["loss"] = float(np.mean(losses))
                metrics["mean_q"] = float(np.mean(qs))
            # 3. periodic hard target sync
            if self._steps_since_target_sync >= \
                    cfg.target_network_update_freq:
                self.target_params = _copy_tree(self.params)
                self._steps_since_target_sync = 0
                self.target_syncs += 1
            self._sync_worker_weights()
        returns = []
        for w in self.workers:
            try:
                returns.extend(ray.get(w.episode_returns.remote()))
            except Exception:
                pass
        if returns:
            metrics["episode_reward_mean"] = float(np.mean(returns))
            metrics["episodes_this_iter"] = len(returns)
        return metrics

    def save_checkpoint(self):
        from ray_tpu_torch.train.pipeline_actors import to_numpy_tree

        return {"params": to_numpy_tree(self.params),
                "target_params": to_numpy_tree(self.target_params),
                "opt_state": to_numpy_tree(self._opt_state),
                "steps": self._steps_sampled}

    def load_checkpoint(self, state):
        from ray_tpu_torch.train.pipeline_actors import to_device_tree

        self.params = to_device_tree(state["params"], self._dev)
        self.target_params = to_device_tree(state["target_params"],
                                            self._dev)
        self._opt_state = to_device_tree(state["opt_state"], self._dev)
        self._steps_sampled = state.get("steps", 0)
        self._sync_worker_weights()

    def cleanup(self):
        for w in self.workers:
            try:
                ray.kill(w)
            except Exception:
                pass
        try:
            ray.kill(self.replay)
        except Exception:
            pass
