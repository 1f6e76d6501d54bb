"""SAC: off-policy maximum-entropy RL for continuous actions (counterpart:
``ray_tpu/rllib/sac.py``).

Reference: ``rllib/algorithms/sac/sac.py`` + ``sac_torch_policy.py`` —
twin Q critics with polyak-averaged targets, a tanh-squashed Gaussian
policy trained by the reparameterization trick, and a learned entropy
temperature alpha against a target entropy of ``-act_dim``.  CPU rollout
workers act stochastically and push transitions to the ReplayActor; the
update (critic, actor against the updated critic, alpha, polyak) runs on
the learner's device, the card unless ``learner_device="cpu"``.

The reference draws its normals with ``jax.random`` inside the jitted
update.  Here the update takes its two standard-normal draws (critic,
actor) as arguments; the algorithm draws them from a ``torch.Generator``
on the learner's device seeded ``seed + 1``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List

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
    ACTIONS, DONES, NEXT_OBS, OBS, REWARDS,
)
from ray_tpu_torch.train.trees import tree_leaves

LOG_STD_MIN, LOG_STD_MAX = -20.0, 2.0


class SquashedGaussianPolicy:
    """obs -> (mu, log_std); actions tanh-squashed into [low, high]
    (reference: SquashedGaussian distribution in rllib/models)."""

    def __init__(self, obs_dim: int, act_dim: int, low, high,
                 hidden=(64, 64)):
        self.obs_dim = obs_dim
        self.act_dim = act_dim
        self.hidden = tuple(hidden)
        self.low = np.asarray(low, np.float32)
        self.high = np.asarray(high, np.float32)

    def init(self, generator):
        return mlp_init(generator, (self.obs_dim,) + self.hidden
                        + (2 * self.act_dim,))

    def sample(self, params, obs, *, generator=None, eps=None):
        """Reparameterized (action, logp) with the tanh change-of-
        variables correction.  ``eps`` is the standard-normal draw of
        mu's shape; without it the draw comes from ``generator``."""
        import torch
        import torch.nn.functional as F

        out = mlp_apply(params, obs)
        mu, log_std = out.chunk(2, dim=-1)
        log_std = torch.clamp(log_std, LOG_STD_MIN, LOG_STD_MAX)
        std = torch.exp(log_std)
        if eps is None:
            if generator is None:
                raise ValueError("sample needs eps or a generator")
            eps = torch.randn(mu.shape, generator=generator,
                              device=mu.device, dtype=mu.dtype)
        pre = mu + std * eps
        # N(mu, std) log-density of pre
        logp = torch.sum(
            -0.5 * ((pre - mu) / std) ** 2 - log_std
            - 0.5 * math.log(2 * math.pi), dim=-1)
        # tanh squash correction: log det |d tanh / dx| summed over dims
        logp = logp - torch.sum(2.0 * (math.log(2.0) - pre
                                       - F.softplus(-2.0 * pre)), dim=-1)
        squashed = torch.tanh(pre)
        scale = (self.high - self.low) / 2.0
        mid = (self.high + self.low) / 2.0
        action = squashed * torch.as_tensor(scale, device=mu.device) + \
            torch.as_tensor(mid, device=mu.device)
        # affine-rescale log-det (constant; keeps alpha's entropy target
        # in the true action measure)
        logp = logp - float(np.sum(np.log(scale + 1e-8)))
        return action, logp


class QNetwork:
    def __init__(self, obs_dim: int, act_dim: int, hidden=(64, 64)):
        self.sizes = (obs_dim + act_dim,) + tuple(hidden) + (1,)

    def init(self, generator):
        return mlp_init(generator, self.sizes)

    def apply(self, params, obs, act):
        import torch

        return mlp_apply(params, torch.cat([obs, act], -1))[..., 0]


@ray.remote
class SACRolloutWorker:
    """Stochastic continuous-action rollouts -> replay (reference:
    SAC's default sample collection; exploration IS the policy).  A CPU
    actor: the policy runs on the CPU under ``no_grad``, its draws from a
    CPU generator seeded by the worker's index."""

    def __init__(self, env_maker, policy_config: Dict[str, Any],
                 replay_actor, num_envs: int = 1, worker_index: int = 0,
                 warmup_uniform_steps: int = 500):
        self._venv = VectorEnv(env_maker, num_envs, seed=worker_index)
        self._policy = SquashedGaussianPolicy(**policy_config)
        self._params = None
        self._replay = replay_actor
        self._index = worker_index
        self._gen = None
        self._obs = self._venv.vector_reset()
        self._ep_returns = np.zeros(num_envs)
        self._completed: List[float] = []
        self._steps = 0
        self._warmup = warmup_uniform_steps
        self._rng = np.random.default_rng(worker_index)

    def set_weights(self, weights):
        from ray_tpu_torch.train.pipeline_actors import to_device_tree

        self._params = to_device_tree(weights, "cpu")
        return True

    def _act(self, obs) -> np.ndarray:
        import torch

        if self._gen is None:
            self._gen = torch.Generator().manual_seed(self._index)
        with torch.no_grad():
            act, _ = self._policy.sample(
                self._params, torch.from_numpy(np.asarray(obs, np.float32)),
                generator=self._gen)
        return act.numpy()

    def sample(self, num_steps: int) -> int:
        n = self._venv.num_envs
        cols = {k: [] for k in (OBS, ACTIONS, REWARDS, NEXT_OBS, DONES)}
        for _ in range(max(1, num_steps // n)):
            if self._steps < self._warmup or self._params is None:
                act = self._rng.uniform(
                    self._policy.low, self._policy.high,
                    size=(n, self._policy.act_dim)).astype(np.float32)
            else:
                act = self._act(self._obs)
            next_obs, rews, terms, truncs, finals, _ = \
                self._venv.vector_step(act)
            cols[OBS].append(self._obs.copy())
            cols[ACTIONS].append(act)
            cols[REWARDS].append(rews)
            cols[NEXT_OBS].append(finals)  # pre-reset obs for bootstrap
            # DONES carries TERMINATION only: truncation still bootstraps
            # (time-limit bias; same convention as the DQN worker).
            cols[DONES].append(terms.astype(np.float32))
            self._ep_returns += rews
            for i in np.nonzero(terms | truncs)[0]:
                self._completed.append(float(self._ep_returns[i]))
                self._ep_returns[i] = 0.0
            self._obs = next_obs
            self._steps += n
        ray.get(self._replay.add.remote({
            OBS: np.concatenate(cols[OBS]).astype(np.float32),
            ACTIONS: np.concatenate(cols[ACTIONS]).astype(np.float32),
            REWARDS: np.concatenate(cols[REWARDS]).astype(np.float32),
            NEXT_OBS: np.concatenate(cols[NEXT_OBS]).astype(np.float32),
            DONES: np.concatenate(cols[DONES]).astype(np.float32)}))
        return max(1, num_steps // n) * n

    def episode_returns(self, clear: bool = True) -> List[float]:
        out = list(self._completed)
        if clear:
            self._completed = []
        return out


class SACConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 3e-4
        self.critic_lr = 3e-4
        self.alpha_lr = 3e-4
        self.train_batch_size = 256
        self.replay_buffer_capacity = 100_000
        self.tau = 0.005
        self.target_entropy = None  # default: -act_dim
        self.num_steps_sampled_before_learning = 600
        self.num_train_batches_per_step = 32
        self.warmup_uniform_steps = 600
        self.grad_clip = 40.0

    @property
    def algo_class(self):
        return SAC


class SAC(Algorithm):
    config_class = SACConfig

    def _setup(self, cfg: SACConfig):
        import torch

        from ray_tpu_torch._private.device import resolve_device
        from ray_tpu_torch.rllib.dqn import _copy_tree
        from ray_tpu_torch.train.core import adam
        from ray_tpu_torch.train.pipeline_actors import to_device_tree

        self._dev = resolve_device(cfg.learner_device)
        env = cfg.env_maker()
        obs_dim = int(np.prod(env.observation_space.shape))
        act_space = env.action_space
        act_dim = int(np.prod(act_space.shape))
        low, high = act_space.low, act_space.high
        if hasattr(env, "close"):
            env.close()
        hidden = tuple(cfg.model.get("hidden", (64, 64)))
        policy_config = {"obs_dim": obs_dim, "act_dim": act_dim,
                         "low": low, "high": high, "hidden": hidden}
        self.policy = SquashedGaussianPolicy(**policy_config)
        self.q = QNetwork(obs_dim, act_dim, hidden)
        self.act_dim = act_dim
        # Drawn on the CPU so a seed gives the same weights on any device.
        gen = torch.Generator().manual_seed(cfg.seed)
        self.pi_params = to_device_tree(self.policy.init(gen), self._dev)
        self.q_params = to_device_tree(
            {"q1": self.q.init(gen), "q2": self.q.init(gen)}, self._dev)
        self.q_target = _copy_tree(self.q_params)
        self.log_alpha = torch.zeros((), device=self._dev)
        self._target_entropy = (cfg.target_entropy
                                if cfg.target_entropy is not None
                                else -float(act_dim))
        self._pi_opt = adam(cfg.lr, grad_clip=cfg.grad_clip)
        self._q_opt = adam(cfg.critic_lr, grad_clip=cfg.grad_clip)
        self._a_opt = adam(cfg.alpha_lr)
        self._pi_state = self._pi_opt.init(self.pi_params)
        self._q_state = self._q_opt.init(self.q_params)
        self._a_state = self._a_opt.init(self.log_alpha)
        self._gen = torch.Generator(device=self._dev).manual_seed(
            cfg.seed + 1)

        self.replay = ReplayActor.options(num_cpus=1).remote(
            capacity=cfg.replay_buffer_capacity, prioritized=False,
            seed=cfg.seed)
        self.workers = [
            SACRolloutWorker.options(num_cpus=1).remote(
                cfg.env_maker, policy_config, self.replay,
                num_envs=cfg.num_envs_per_worker, worker_index=i,
                warmup_uniform_steps=cfg.warmup_uniform_steps)
            for i in range(cfg.num_rollout_workers)]
        self._steps_sampled = 0
        self._sync_worker_weights()

    def _update(self, batch, eps_critic, eps_actor) -> Dict[str, Any]:
        """One update on a batch of device tensors, in the reference's
        order: the critic step; the actor step against the UPDATED
        critic; the alpha step on the actor's logp; the polyak target.
        ``eps_critic``/``eps_actor`` are the (B, act_dim) normal draws of
        the next-state and the current-state action samples.  Returns the
        metrics, detached, on the device."""
        import torch

        from ray_tpu_torch.rllib.learner import grad_step

        cfg: SACConfig = self.algo_config
        policy, q = self.policy, self.q
        gamma, tau = cfg.gamma, cfg.tau
        pi_params, q_target = self.pi_params, self.q_target
        alpha = torch.exp(self.log_alpha)

        with torch.no_grad():
            next_a, next_logp = policy.sample(pi_params, batch[NEXT_OBS],
                                              eps=eps_critic)
            tq1 = q.apply(q_target["q1"], batch[NEXT_OBS], next_a)
            tq2 = q.apply(q_target["q2"], batch[NEXT_OBS], next_a)
            next_v = torch.minimum(tq1, tq2) - alpha * next_logp
            target = batch[REWARDS] + gamma * (1 - batch[DONES]) * next_v

        def critic_loss(qp):
            q1 = q.apply(qp["q1"], batch[OBS], batch[ACTIONS])
            q2 = q.apply(qp["q2"], batch[OBS], batch[ACTIONS])
            return (((q1 - target) ** 2).mean()
                    + ((q2 - target) ** 2).mean()), q1.mean()

        closs, mean_q = grad_step(self.q_params, self._q_state, self._q_opt,
                                  critic_loss)

        def actor_loss(pp):
            a, logp = policy.sample(pp, batch[OBS], eps=eps_actor)
            q1 = q.apply(self.q_params["q1"], batch[OBS], a)
            q2 = q.apply(self.q_params["q2"], batch[OBS], a)
            return (alpha * logp - torch.minimum(q1, q2)).mean(), logp

        aloss, logp = grad_step(self.pi_params, self._pi_state,
                                self._pi_opt, actor_loss)
        grad_step(
            self.log_alpha, self._a_state, self._a_opt,
            lambda la: (-(la * (logp + self._target_entropy)).mean(), {}))
        with torch.no_grad():
            for t, s in zip(*(tree_leaves(x) for x in (self.q_target,
                                                      self.q_params))):
                t.copy_((1 - tau) * t + tau * s)
        return {"critic_loss": closs, "actor_loss": aloss,
                "alpha": torch.exp(self.log_alpha), "mean_q": mean_q,
                "entropy": -logp.mean()}

    def _sync_worker_weights(self):
        from ray_tpu_torch.train.pipeline_actors import to_numpy_tree

        w = to_numpy_tree(self.pi_params)
        ray.get(_bulk_submit([(wk.set_weights, (w,), None)
                              for wk in self.workers]))

    def training_step(self) -> Dict[str, Any]:
        import torch

        cfg: SACConfig = self.algo_config
        steps = ray.get([w.sample.remote(cfg.rollout_fragment_length)
                         for w in self.workers])
        self._steps_sampled += sum(steps)
        metrics: Dict[str, Any] = {
            "num_env_steps_sampled": self._steps_sampled}
        if self._steps_sampled >= cfg.num_steps_sampled_before_learning:
            aux = None
            for _ in range(cfg.num_train_batches_per_step):
                raw = ray.get(self.replay.sample.remote(
                    cfg.train_batch_size, 0.0))
                if raw is None:
                    break
                batch = {k: torch.from_numpy(np.asarray(v)).to(self._dev)
                         for k, v in raw.items()
                         if k != BATCH_INDEXES and k != WEIGHTS}
                shape = (len(batch[OBS]), self.act_dim)
                eps_c, eps_a = (torch.randn(shape, generator=self._gen,
                                            device=self._dev)
                                for _ in range(2))
                aux = self._update(batch, eps_c, eps_a)
            if aux is not None:
                metrics.update({k: float(v) for k, v in aux.items()})
            self._sync_worker_weights()
        returns = []
        for w in self.workers:
            try:
                returns.extend(ray.get(w.episode_returns.remote()))
            except Exception:
                pass
        if returns:
            metrics["episode_reward_mean"] = float(np.mean(returns))
        return metrics

    def save_checkpoint(self):
        from ray_tpu_torch.train.pipeline_actors import to_numpy_tree

        return to_numpy_tree({
            "pi": self.pi_params, "q": self.q_params, "qt": self.q_target,
            "log_alpha": self.log_alpha, "steps": self._steps_sampled})

    def load_checkpoint(self, state):
        from ray_tpu_torch.train.pipeline_actors import to_device_tree

        state = to_device_tree(state, self._dev)
        self.pi_params, self.q_params = state["pi"], state["q"]
        self.q_target, self.log_alpha = state["qt"], state["log_alpha"]
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
