"""APPO: asynchronous PPO on the IMPALA actor-learner skeleton
(counterpart: ``ray_tpu/rllib/appo.py``).

Reference: ``rllib/algorithms/appo/appo.py`` — IMPALA's asynchronous
sampling pipeline, but the learner optimizes the PPO clipped surrogate
on V-trace-corrected advantages against a periodically-synced TARGET
policy (the reference updates it every ``target_update_frequency``
learner steps).  Staleness robustness comes from both mechanisms:
V-trace reweights old trajectories; the clip bounds the update.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

import ray_tpu_torch as ray
from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.remote_function import _bulk_submit
from ray_tpu_torch.rllib.impala import Impala, ImpalaConfig
from ray_tpu_torch.rllib.learner import Learner, LearnerGroup
from ray_tpu_torch.rllib.models import ActorCriticMLP
from ray_tpu_torch.rllib.rollout_worker import WorkerSet
from ray_tpu_torch.rllib.sample_batch import (
    ACTIONS, DONES, LOGP, OBS, REWARDS, SampleBatch,
)
from ray_tpu_torch.rllib.vtrace import vtrace
from ray_tpu_torch.train.core import adam
from ray_tpu_torch.train.pipeline_actors import to_device_tree


def appo_loss(params, module, batch, *, gamma: float, clip_param: float,
              vf_coef: float, ent_coef: float, clip_rho: float,
              clip_c: float):
    """PPO clipped surrogate on V-trace advantages computed from the
    TARGET policy's log-probs and values (riders in the batch:
    'target_logp', 'target_values', 'target_bootstrap')."""
    t, b = batch[ACTIONS].shape
    obs = batch[OBS].reshape(t * b, -1)
    logits, values = module.apply(params, obs)
    logits = logits.reshape(t, b, -1)
    values = values.reshape(t, b)
    logp_all = F.log_softmax(logits, dim=-1)
    cur_logp = torch.gather(
        logp_all, -1, batch[ACTIONS][..., None].long())[..., 0]
    _, bootstrap = module.apply(params, batch["bootstrap_obs"])
    discounts = gamma * (1.0 - batch[DONES].float())
    # V-trace targets/advantages from the TARGET policy's logp (no
    # gradient: the target params produced these outside the update).
    vt = vtrace(batch[LOGP], batch["target_logp"], batch[REWARDS],
                batch["target_values"], batch["target_bootstrap"],
                discounts, clip_rho, clip_c)
    ratio = torch.exp(cur_logp - batch[LOGP])
    adv = vt.pg_advantages
    surrogate = torch.minimum(
        ratio * adv,
        torch.clamp(ratio, 1 - clip_param, 1 + clip_param) * adv)
    pi_loss = -torch.mean(surrogate)
    vf_loss = torch.mean((values - vt.vs) ** 2)
    entropy = -torch.mean(torch.sum(torch.exp(logp_all) * logp_all, dim=-1))
    loss = pi_loss + vf_coef * vf_loss - ent_coef * entropy
    return loss, {"policy_loss": pi_loss, "vf_loss": vf_loss,
                  "entropy": entropy,
                  "mean_ratio": torch.mean(ratio)}


class APPOConfig(ImpalaConfig):
    def __init__(self):
        super().__init__()
        self.clip_param = 0.3
        self.target_update_frequency = 4  # learner updates per sync

    @property
    def algo_class(self):
        return APPO


class APPO(Impala):
    """reference: appo.py:51 APPO(Impala)."""

    config_class = APPOConfig

    def _setup(self, cfg: APPOConfig):
        env = cfg.env_maker()
        obs_dim = int(np.prod(env.observation_space.shape))
        num_actions = int(env.action_space.n)
        if hasattr(env, "close"):
            env.close()
        model_config = {"obs_dim": obs_dim, "num_actions": num_actions,
                        "hidden": tuple(cfg.model.get("hidden", (64, 64)))}
        self._obs_dim = obs_dim
        self.workers = WorkerSet(
            cfg.env_maker, model_config, cfg.num_rollout_workers,
            cfg.num_envs_per_worker, gamma=cfg.gamma)
        module = ActorCriticMLP(**model_config)
        self._module = module

        def loss(params, mod, batch):
            return appo_loss(params, mod, batch, gamma=cfg.gamma,
                             clip_param=cfg.clip_param,
                             vf_coef=cfg.vf_loss_coeff,
                             ent_coef=cfg.entropy_coeff,
                             clip_rho=cfg.clip_rho_threshold,
                             clip_c=cfg.clip_c_threshold)

        self.learner_group = LearnerGroup(lambda: Learner(
            module, loss, optimizer=adam(cfg.lr, grad_clip=cfg.grad_clip),
            seed=cfg.seed, device=cfg.learner_device))
        self._dev = resolve_device(cfg.learner_device)
        self._target_params = to_device_tree(self.learner_group.get_weights(),
                                         self._dev)
        self._updates_since_target_sync = 0
        self.target_updates = 0

        @torch.no_grad()
        def target_fwd(params, obs_flat, actions, bootstrap_obs):
            logits, values = module.apply(params, obs_flat)
            logp_all = F.log_softmax(logits, dim=-1)
            tl = torch.gather(logp_all, -1, actions[..., None].long())[..., 0]
            _, bs = module.apply(params, bootstrap_obs)
            return tl, values, bs

        self._target_fwd = target_fwd
        w = self.learner_group.get_weights()
        self.workers.sync_weights(w)
        sample_futs = _bulk_submit([
            (worker.sample, (cfg.rollout_fragment_length,), None)
            for worker in self.workers.workers])
        self._inflight = {fut: i for i, fut in enumerate(sample_futs)}

    def _augment_with_target(self, tm: Dict[str, Any]) -> Dict[str, Any]:
        t, b = tm[ACTIONS].shape

        def dev(v):
            return torch.from_numpy(np.ascontiguousarray(v)).to(self._dev)

        tl, tv, bs = self._target_fwd(
            self._target_params, dev(tm[OBS].reshape(t * b, -1)),
            dev(tm[ACTIONS].reshape(t * b)), dev(tm["bootstrap_obs"]))
        tm["target_logp"] = tl.cpu().numpy().reshape(t, b)
        tm["target_values"] = tv.cpu().numpy().reshape(t, b)
        tm["target_bootstrap"] = bs.cpu().numpy()
        return tm

    def training_step(self) -> Dict[str, Any]:
        cfg: APPOConfig = self.algo_config

        metrics: Dict[str, Any] = {}
        steps = 0
        processed = 0
        while processed < cfg.max_batches_per_step and self._inflight:
            done, _ = ray.wait(list(self._inflight), num_returns=1,
                               timeout=30.0)
            if not done:
                break
            fut = done[0]
            idx = self._inflight.pop(fut)
            worker = self.workers.workers[idx]
            try:
                flat = ray.get(fut)
            except Exception:
                worker = self.workers.recreate(idx)
                self._resubmit(worker, idx)
                continue
            tm = self._to_time_major(flat, cfg.rollout_fragment_length)
            tm = self._augment_with_target(tm)
            metrics = self.learner_group.update(SampleBatch(tm))
            steps += len(flat)
            processed += 1
            self._updates_since_target_sync += 1
            if self._updates_since_target_sync >= \
                    cfg.target_update_frequency:
                self._target_params = to_device_tree(
                    self.learner_group.get_weights(), self._dev)
                self._updates_since_target_sync = 0
                self.target_updates += 1
            self._resubmit(worker, idx)
        returns = self.workers.episode_returns()
        if returns:
            metrics["episode_reward_mean"] = float(np.mean(returns))
        metrics["num_env_steps_sampled"] = steps
        return metrics
