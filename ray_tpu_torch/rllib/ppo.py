"""PPO: synchronous on-policy training (counterpart:
``ray_tpu/rllib/ppo.py``).

Reference: ``rllib/algorithms/ppo/ppo.py:343`` (``training_step`` :384):
synchronous_parallel_sample from the worker fleet -> learner update ->
weight sync (:447).  The loss is the clipped-surrogate + value + entropy
objective of ``ppo_torch_policy.py``; SGD epochs and minibatching happen
driver-side, each minibatch one learner update.
With ``policies`` set, each policy gets its own ``Learner`` and the
rollouts are policy-mapped (``multi_agent.py``).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.learner import Learner, LearnerGroup
from ray_tpu_torch.rllib.models import ActorCriticMLP
from ray_tpu_torch.rllib.rollout_worker import WorkerSet
from ray_tpu_torch.rllib.sample_batch import (
    ACTIONS, ADVANTAGES, LOGP, OBS, VALUE_TARGETS,
)
from ray_tpu_torch.train.core import adam


def ppo_loss(params, module, batch, *, clip: float = 0.2,
             vf_coef: float = 0.5, ent_coef: float = 0.0):
    logits, values = module.apply(params, batch[OBS])
    logp_all = F.log_softmax(logits, dim=-1)
    logp = torch.gather(logp_all, -1, batch[ACTIONS][:, None].long())[:, 0]
    ratio = torch.exp(logp - batch[LOGP])
    adv = batch[ADVANTAGES]
    adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    surr = torch.minimum(ratio * adv,
                         torch.clamp(ratio, 1 - clip, 1 + clip) * adv)
    pi_loss = -torch.mean(surr)
    vf_loss = torch.mean((values - batch[VALUE_TARGETS]) ** 2)
    entropy = -torch.mean(torch.sum(torch.exp(logp_all) * logp_all, dim=-1))
    loss = pi_loss + vf_coef * vf_loss - ent_coef * entropy
    return loss, {"policy_loss": pi_loss, "vf_loss": vf_loss,
                  "entropy": entropy,
                  "kl": torch.mean(batch[LOGP] - logp)}


class PPOConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.clip_param = 0.2
        self.vf_loss_coeff = 0.5
        self.entropy_coeff = 0.0
        self.num_sgd_iter = 6
        self.sgd_minibatch_size = 128
        self.lam = 0.95
        self.grad_clip = 0.5

    @property
    def algo_class(self):
        return PPO


class PPO(Algorithm):
    config_class = PPOConfig

    def _setup(self, cfg: PPOConfig):
        if cfg.policies:
            self._setup_multi_agent(cfg)
            return
        env = cfg.env_maker()
        obs_dim = int(np.prod(env.observation_space.shape))
        num_actions = int(env.action_space.n)
        env.close() if hasattr(env, "close") else None
        model_config = {"obs_dim": obs_dim, "num_actions": num_actions,
                        "hidden": tuple(cfg.model.get("hidden", (64, 64)))}
        self.workers = WorkerSet(
            cfg.env_maker, model_config, cfg.num_rollout_workers,
            cfg.num_envs_per_worker, gamma=cfg.gamma, lam=cfg.lam)
        module = ActorCriticMLP(**model_config)

        def loss(params, mod, batch):
            return ppo_loss(params, mod, batch, clip=cfg.clip_param,
                            vf_coef=cfg.vf_loss_coeff,
                            ent_coef=cfg.entropy_coeff)

        def make_learner():
            return Learner(module, loss,
                           optimizer=adam(cfg.lr, grad_clip=cfg.grad_clip),
                           seed=cfg.seed, device=cfg.learner_device)

        self.learner_group = LearnerGroup(
            make_learner, remote=cfg.remote_learner,
            num_tpus=cfg.learner_num_tpus,
            num_learners=cfg.num_learners)
        self.workers.sync_weights(self.learner_group.get_weights())
        self._rng = np.random.default_rng(cfg.seed)

    def _setup_multi_agent(self, cfg: PPOConfig):
        """Per-policy Learners + policy-mapped rollouts (reference:
        multi-agent PPO through the Learner stack — one LearnerGroup per
        policy in learner_group.py; here one Learner per policy, seeded
        ``seed + i``, data-parallel over ``num_learners`` replicas)."""
        from ray_tpu_torch.rllib.multi_agent import MultiAgentWorkerSet

        if cfg.remote_learner:
            raise NotImplementedError(
                "remote_learner is not supported in multi-agent mode; "
                "the per-policy learners run in this process (use "
                "num_learners to make their updates data-parallel)")
        env = cfg.env_maker()
        default_model = None
        if any(mc is None for mc in cfg.policies.values()):
            obs_dim = int(np.prod(env.observation_space.shape))
            num_actions = int(env.action_space.n)
            default_model = {
                "obs_dim": obs_dim, "num_actions": num_actions,
                "hidden": tuple(cfg.model.get("hidden", (64, 64)))}
        env.close() if hasattr(env, "close") else None
        model_configs = {pid: (dict(mc) if mc is not None
                               else dict(default_model))
                         for pid, mc in cfg.policies.items()}
        mapping = cfg.policy_mapping_fn or (lambda aid: next(
            iter(model_configs)))

        def loss(params, mod, batch):
            return ppo_loss(params, mod, batch, clip=cfg.clip_param,
                            vf_coef=cfg.vf_loss_coeff,
                            ent_coef=cfg.entropy_coeff)

        self.learners: Dict[str, Learner] = {}
        for i, (pid, mc) in enumerate(model_configs.items()):
            lr = Learner(ActorCriticMLP(**mc), loss,
                         optimizer=adam(cfg.lr, grad_clip=cfg.grad_clip),
                         seed=cfg.seed + i, device=cfg.learner_device)
            if cfg.num_learners and cfg.num_learners > 1:
                lr.set_replicas(cfg.num_learners)
            self.learners[pid] = lr
        self.ma_workers = MultiAgentWorkerSet(
            cfg.env_maker, model_configs, mapping,
            cfg.num_rollout_workers, gamma=cfg.gamma, lam=cfg.lam)
        self.ma_workers.sync_weights(
            {pid: lr.get_weights() for pid, lr in self.learners.items()})
        self._rng = np.random.default_rng(cfg.seed)

    def _training_step_multi_agent(self) -> Dict[str, Any]:
        cfg: PPOConfig = self.algo_config
        ma_batch = self.ma_workers.sample_sync(cfg.rollout_fragment_length)
        metrics: Dict[str, Any] = {}
        for pid, batch in ma_batch.items():
            if not len(batch):
                continue
            pm: Dict[str, Any] = {}  # num_sgd_iter=0 must not NameError
            for _ in range(cfg.num_sgd_iter):
                shuffled = batch.shuffle(self._rng)
                mb_size = min(cfg.sgd_minibatch_size, len(shuffled))
                for mb in shuffled.minibatches(mb_size):
                    pm = self.learners[pid].update(mb)
            metrics.update({f"{pid}/{k}": v for k, v in pm.items()})
        self.ma_workers.sync_weights(
            {pid: lr.get_weights() for pid, lr in self.learners.items()})
        returns = self.ma_workers.episode_returns()
        if returns:
            metrics["episode_reward_mean"] = float(np.mean(returns))
            metrics["episodes_this_iter"] = len(returns)
        metrics["num_env_steps_sampled"] = ma_batch.env_steps()
        metrics["num_agent_steps_sampled"] = ma_batch.agent_steps()
        return metrics

    def training_step(self) -> Dict[str, Any]:
        cfg: PPOConfig = self.algo_config
        if cfg.policies:
            return self._training_step_multi_agent()
        batch = self.workers.sample_sync(cfg.rollout_fragment_length)
        metrics: Dict[str, Any] = {}
        if len(batch) == 0:
            # every worker failed this round; fleet was rebuilt — skip update
            self.workers.sync_weights(self.learner_group.get_weights())
            return {"num_env_steps_sampled": 0}
        for _ in range(cfg.num_sgd_iter):
            shuffled = batch.shuffle(self._rng)
            mb_size = min(cfg.sgd_minibatch_size, len(shuffled))
            for mb in shuffled.minibatches(mb_size):
                metrics = self.learner_group.update(mb)
        self.workers.sync_weights(self.learner_group.get_weights())
        returns = self.workers.episode_returns()
        if returns:
            metrics["episode_reward_mean"] = float(np.mean(returns))
            metrics["episodes_this_iter"] = len(returns)
        metrics["num_env_steps_sampled"] = len(batch)
        return metrics

    def save_checkpoint(self):
        if self.algo_config.policies:
            return {pid: lr.state() for pid, lr in self.learners.items()}
        return self.learner_group.state()

    def load_checkpoint(self, state):
        if self.algo_config.policies:
            for pid, s in state.items():
                self.learners[pid].load_state(s)
            self.ma_workers.sync_weights(
                {pid: lr.get_weights()
                 for pid, lr in self.learners.items()})
            return
        self.learner_group.load_state(state)
        self.workers.sync_weights(self.learner_group.get_weights())

    def cleanup(self):
        if self.algo_config.policies:
            self.ma_workers.stop()
        else:
            self.workers.stop()
