"""RolloutWorker: CPU actor stepping environments with the current policy
(counterpart: ``ray_tpu/rllib/rollout_worker.py``).

Reference: ``rllib/evaluation/rollout_worker.py:166`` (``sample`` :886) +
``worker_set.py`` (fault-tolerant fleet) + GAE postprocessing
(``rllib/evaluation/postprocessing.py``).  Division of labor: rollout
workers are CPU actors that hold no card — they run the policy's forward
with the port's ``ActorCriticMLP.apply`` on the CPU and ship
SampleBatches; the learner owns the card.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

import ray_tpu_torch as ray
from ray_tpu_torch.remote_function import _bulk_submit
from ray_tpu_torch.rllib.models import ActorCriticMLP, sample_action
from ray_tpu_torch.rllib.sample_batch import (
    ACTIONS, DONES, LOGP, NEXT_OBS, OBS, REWARDS, SampleBatch, VF_PREDS,
    ADVANTAGES, VALUE_TARGETS, concat_batches,
)


def compute_gae(batch: SampleBatch, last_value: float, gamma: float,
                lam: float) -> SampleBatch:
    """Generalized advantage estimation (reference:
    rllib/evaluation/postprocessing.py compute_advantages)."""
    rewards = batch[REWARDS]
    values = batch[VF_PREDS]
    dones = batch[DONES]
    n = len(rewards)
    adv = np.zeros(n, dtype=np.float32)
    last = 0.0
    next_value = last_value
    for t in reversed(range(n)):
        nonterminal = 1.0 - float(dones[t])
        delta = rewards[t] + gamma * next_value * nonterminal - values[t]
        last = delta + gamma * lam * nonterminal * last
        adv[t] = last
        next_value = values[t]
    batch[ADVANTAGES] = adv
    batch[VALUE_TARGETS] = (adv + values).astype(np.float32)
    return batch


@ray.remote
class RolloutWorker:
    def __init__(self, env_maker, model_config: Dict[str, Any],
                 worker_index: int = 0, num_envs: int = 1,
                 gamma: float = 0.99, lam: float = 0.95,
                 seed: Optional[int] = None):
        self._envs = [env_maker() for _ in range(num_envs)]
        self._model = ActorCriticMLP(**model_config)
        self._weights = None
        self._params = None
        self._rng = np.random.default_rng(
            seed if seed is not None else worker_index)
        self._gamma, self._lam = gamma, lam
        self._obs = [e.reset(seed=int(self._rng.integers(2**31)))[0]
                     for e in self._envs]
        self._ep_returns = [0.0] * num_envs
        self._completed_returns: List[float] = []

    def _apply(self, obs: np.ndarray):
        """The policy on a (B, obs_dim) numpy batch -> numpy (logits,
        values)."""
        import torch

        with torch.no_grad():
            logits, values = self._model.apply(self._params,
                                               torch.from_numpy(obs))
        return logits.numpy(), values.numpy()

    def set_weights(self, weights):
        self._weights = weights
        from ray_tpu_torch.train.pipeline_actors import to_device_tree

        # Rollout workers are CPU actors: they hold no grant and see no card.
        self._params = to_device_tree(weights, "cpu")
        return True

    def get_weights(self):
        return self._weights

    def sample(self, num_steps: int) -> SampleBatch:
        """Collect ``num_steps`` per env; returns a GAE-postprocessed batch
        (reference: SyncSampler, evaluation/sampler.py:144)."""
        assert self._params is not None, "set_weights first"
        per_env: List[Dict[str, list]] = [
            {k: [] for k in (OBS, ACTIONS, REWARDS, DONES, LOGP, VF_PREDS,
                             NEXT_OBS)}
            for _ in self._envs]
        for _ in range(num_steps):
            obs_arr = np.stack(self._obs).astype(np.float32)
            logits, values = self._apply(obs_arr)
            acts, logp = sample_action(logits, self._rng)
            for i, env in enumerate(self._envs):
                nobs, rew, term, trunc, _ = env.step(int(acts[i]))
                done = term or trunc
                buf = per_env[i]
                buf[OBS].append(self._obs[i])
                buf[ACTIONS].append(acts[i])
                buf[REWARDS].append(rew)
                buf[DONES].append(done)
                buf[LOGP].append(logp[i])
                buf[VF_PREDS].append(values[i])
                buf[NEXT_OBS].append(nobs)  # pre-reset obs for bootstrap
                self._ep_returns[i] += rew
                if done:
                    self._completed_returns.append(self._ep_returns[i])
                    self._ep_returns[i] = 0.0
                    nobs = env.reset()[0]
                self._obs[i] = nobs
        batches = []
        obs_arr = np.stack(self._obs).astype(np.float32)
        _, bootstrap = self._apply(obs_arr)
        for i, buf in enumerate(per_env):
            b = SampleBatch({
                OBS: np.asarray(buf[OBS], np.float32),
                ACTIONS: np.asarray(buf[ACTIONS], np.int32),
                REWARDS: np.asarray(buf[REWARDS], np.float32),
                DONES: np.asarray(buf[DONES], bool),
                LOGP: np.asarray(buf[LOGP], np.float32),
                VF_PREDS: np.asarray(buf[VF_PREDS], np.float32),
                NEXT_OBS: np.asarray(buf[NEXT_OBS], np.float32),
            })
            last_v = 0.0 if buf[DONES] and buf[DONES][-1] else \
                float(bootstrap[i])
            batches.append(compute_gae(b, last_v, self._gamma, self._lam))
        return concat_batches(batches)

    def episode_returns(self, clear: bool = True) -> List[float]:
        out = list(self._completed_returns)
        if clear:
            self._completed_returns.clear()
        return out


class WorkerSet:
    """Fault-tolerant rollout fleet (reference:
    rllib/evaluation/worker_set.py — recreate failed workers).

    Subclasses swap the worker factory (``_make``) and batch merge
    (``_concat``/``_empty``) — the multi-agent fleet reuses the whole
    recreate/sample/returns machinery this way."""

    def __init__(self, env_maker, model_config, num_workers: int,
                 num_envs_per_worker: int = 1, gamma: float = 0.99,
                 lam: float = 0.95, recreate_failed: bool = True):
        # CPU actors: a rollout worker holds no card and sees none.
        self._make = lambda idx: RolloutWorker.options(num_cpus=1).remote(
            env_maker, model_config, worker_index=idx,
            num_envs=num_envs_per_worker, gamma=gamma, lam=lam, seed=idx)
        self._workers = [self._make(i) for i in range(num_workers)]
        self._recreate = recreate_failed

    @staticmethod
    def _concat(batches):
        return concat_batches(batches)

    @staticmethod
    def _empty():
        return SampleBatch()

    @property
    def workers(self):
        return list(self._workers)

    def recreate(self, idx: int):
        """Replace a dead worker in place; returns the new handle."""
        try:
            ray.kill(self._workers[idx])
        except Exception:
            pass
        self._workers[idx] = self._make(idx)
        return self._workers[idx]

    def sync_weights(self, weights):
        ray.get(_bulk_submit([(w.set_weights, (weights,), None)
                              for w in self._workers]))

    def sample_sync(self, steps_per_worker: int):
        """synchronous_parallel_sample (reference:
        rllib/execution/rollout_ops.py:21) with worker recreation.  The
        whole collection wave goes out in one dispatch pass."""
        futs = _bulk_submit([(w.sample, (steps_per_worker,), None)
                             for w in self._workers])
        out = []
        for i, fut in enumerate(futs):
            try:
                out.append(ray.get(fut))
            except Exception:
                if not self._recreate:
                    raise
                self.recreate(i)
        return self._concat(out) if out else self._empty()

    def episode_returns(self) -> List[float]:
        rets = []
        futs = _bulk_submit([(w.episode_returns, (), None)
                             for w in self._workers])
        for fut in futs:
            try:
                rets.extend(ray.get(fut))
            except Exception:
                pass
        return rets

    def stop(self):
        for w in self._workers:
            try:
                ray.kill(w)
            except Exception:
                pass
