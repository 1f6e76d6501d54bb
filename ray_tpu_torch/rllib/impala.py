"""IMPALA: asynchronous off-policy actor-learner training (counterpart:
``ray_tpu/rllib/impala.py``).

Reference: ``rllib/algorithms/impala/impala.py:474`` (``training_step``
:616): workers sample asynchronously; batches flow to the learner without
waiting for the fleet; staleness is corrected by V-trace.  Weights flow
back per-worker on batch receipt (the broadcast-interval pattern of :571).

Distributed mode (``num_aggregators > 0`` and the
``distributed_training`` master switch): rollout batches flow
worker -> aggregator over the data plane (the sample ObjectRef is passed
as an argument, so only the descriptor crosses the control plane),
aggregators reshape to time-major off the driver, and the learner feeds
from a host->device double-buffered queue — the
``multi_gpu_learner_thread.py`` analog: a loader thread copies batch t+1
from pinned host memory to the card with ``non_blocking`` copies on a
side CUDA stream while the update for batch t computes, and ``get()``
makes the learner's stream wait on the copy's event.  Queue depth is
``impala_queue_depth``; a blocking get on an empty queue counts a
``learner_queue_stalls``.  With the switch off the plain path below runs
and every new counter stays zero.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Dict, List

import numpy as np
import torch
import torch.nn.functional as F

import ray_tpu_torch as ray
from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.remote_function import _bulk_submit
from ray_tpu_torch.train.core import adam
from ray_tpu_torch.train.pipeline_actors import active_config, note
from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.learner import Learner, LearnerGroup
from ray_tpu_torch.rllib.models import ActorCriticMLP
from ray_tpu_torch.rllib.rollout_worker import WorkerSet
from ray_tpu_torch.rllib.sample_batch import (
    ACTIONS, DONES, LOGP, NEXT_OBS, OBS, REWARDS, SampleBatch,
)
from ray_tpu_torch.rllib.vtrace import vtrace


def impala_loss(params, module, batch, *, gamma: float = 0.99,
                vf_coef: float = 0.5, ent_coef: float = 0.01,
                clip_rho: float = 1.0, clip_c: float = 1.0):
    """batch arrays are (T, B, ...) time-major."""
    t, b = batch[ACTIONS].shape
    obs = batch[OBS].reshape(t * b, -1)
    logits, values = module.apply(params, obs)
    logits = logits.reshape(t, b, -1)
    values = values.reshape(t, b)
    logp_all = F.log_softmax(logits, dim=-1)
    target_logp = torch.gather(
        logp_all, -1, batch[ACTIONS][..., None].long())[..., 0]
    _, bootstrap = module.apply(params, batch["bootstrap_obs"])
    discounts = gamma * (1.0 - batch[DONES].float())
    vt = vtrace(batch[LOGP], target_logp, batch[REWARDS], values,
                bootstrap, discounts, clip_rho, clip_c)
    pi_loss = -torch.mean(target_logp * vt.pg_advantages)
    vf_loss = torch.mean((values - vt.vs) ** 2)
    entropy = -torch.mean(torch.sum(torch.exp(logp_all) * logp_all, dim=-1))
    loss = pi_loss + vf_coef * vf_loss - ent_coef * entropy
    return loss, {"policy_loss": pi_loss, "vf_loss": vf_loss,
                  "entropy": entropy}


def _to_time_major(flat: SampleBatch, frag: int) -> Dict[str, Any]:
    """Worker batches concatenate per-env fragments of length ``frag``;
    reshape (n*frag, ...) -> (frag, n, ...) time-major."""
    n = len(flat) // frag
    out = {}
    for k in (OBS, ACTIONS, REWARDS, DONES, LOGP):
        v = flat[k][: n * frag]
        out[k] = np.moveaxis(
            v.reshape(n, frag, *v.shape[1:]), 0, 1)
    next_obs = flat[NEXT_OBS][: n * frag].reshape(
        n, frag, -1)
    out["bootstrap_obs"] = next_obs[:, -1, :]
    return out


@ray.remote
class _BatchAggregator:
    """Off-driver batch prep (reference: IMPALA's aggregation workers,
    ``impala.py`` aggregator actors).  The sample ObjectRef arrives as an
    argument, so the payload flows rollout worker -> aggregator over the
    data plane and the driver only ever touches the time-major result."""

    def aggregate(self, frag: int, flat: SampleBatch) -> Dict[str, Any]:
        return _to_time_major(flat, frag)


def _to_device(tm: Dict[str, Any], device: torch.device) -> Dict[str, Any]:
    """Host->device copy of one time-major batch (both learner paths,
    queued and direct, route through this one hop on a CPU device)."""
    return {k: torch.from_numpy(np.array(v)).to(device)
            for k, v in tm.items()}


class _HostToDeviceQueue:
    """``multi_gpu_learner_thread.py`` analog: a daemon loader thread
    moves time-major host batches onto ``device`` so the copy of batch
    t+1 is in flight while the learner update for batch t computes.

    On the card each column is staged in pinned host memory and copied
    ``non_blocking`` on a side stream; an event recorded after the
    copies travels with the batch, and ``get()`` makes the caller's
    stream wait on it (the host never blocks) and marks the device
    tensors as used on that stream (``record_stream``), so the caching
    allocator does not hand their memory back to the side stream while
    the update may still read them.  The pinned buffers stay referenced
    until their event has completed.  On a CPU device it is the plain
    copy.  ``depth`` bounds host batches awaiting transfer; a blocking
    ``get`` on an empty device queue counts one ``learner_queue_stalls``."""

    def __init__(self, depth: int, device=None):
        self._dev = resolve_device(device)
        self._stream = (torch.cuda.Stream(self._dev)
                        if self._dev.type == "cuda" else None)
        self._in: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._out: "queue.Queue" = queue.Queue()
        self._in_flight: List[Any] = []   # (event, pinned columns)
        self._gets = 0
        self._stalls = 0
        self._occupancy_sum = 0
        self._pinned_copies = 0
        self._thread = threading.Thread(
            target=self._loader, name="impala-h2d", daemon=True)
        self._thread.start()

    def _loader(self):
        while True:
            tm = self._in.get()
            if tm is None:
                return
            if self._stream is None:
                self._out.put((_to_device(tm, self._dev), None, None))
                continue
            # The copy overlaps whatever update is currently running on
            # the caller's stream.
            pinned = {k: torch.from_numpy(np.array(v)).pin_memory()
                      for k, v in tm.items()}
            with torch.cuda.device(self._dev), \
                    torch.cuda.stream(self._stream):
                dev = {k: v.to(self._dev, non_blocking=True)
                       for k, v in pinned.items()}
                done = torch.cuda.Event()
                done.record(self._stream)
            self._out.put((dev, done, pinned))

    def put(self, tm: Dict[str, Any]):
        self._in.put(tm)

    def get(self) -> Dict[str, Any]:
        self._gets += 1
        self._occupancy_sum += self._out.qsize()
        if self._out.empty():
            self._stalls += 1
            note("learner_queue_stalls")
        dev, done, pinned = self._out.get()
        if done is not None:
            consumer = torch.cuda.current_stream(self._dev)
            consumer.wait_event(done)
            for v in dev.values():
                v.record_stream(consumer)
            self._in_flight = [(e, p) for e, p in self._in_flight
                               if not e.query()]
            self._in_flight.append((done, pinned))
            self._pinned_copies += len(dev)
        return dev

    def queue_stats(self) -> Dict[str, float]:
        return {
            "gets": self._gets,
            "stalls": self._stalls,
            "occupancy_avg": (self._occupancy_sum / self._gets
                              if self._gets else 0.0),
            "pinned_copies": self._pinned_copies,
        }

    def stop(self):
        self._in.put(None)
        self._thread.join(timeout=5.0)


class ImpalaConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.vf_loss_coeff = 0.5
        self.entropy_coeff = 0.01
        self.clip_rho_threshold = 1.0
        self.clip_c_threshold = 1.0
        self.grad_clip = 40.0
        self.rollout_fragment_length = 50
        self.max_batches_per_step = 8
        # > 0 engages the distributed path: off-driver time-major prep +
        # the h2d double-buffer (gated by cfg.distributed_training).
        self.num_aggregators = 0

    @property
    def algo_class(self):
        return Impala


class Impala(Algorithm):
    config_class = ImpalaConfig

    def _setup(self, cfg: ImpalaConfig):
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

        def loss(params, mod, batch):
            return impala_loss(params, mod, batch, gamma=cfg.gamma,
                               vf_coef=cfg.vf_loss_coeff,
                               ent_coef=cfg.entropy_coeff,
                               clip_rho=cfg.clip_rho_threshold,
                               clip_c=cfg.clip_c_threshold)

        def make_learner():
            return Learner(module, loss,
                           optimizer=adam(cfg.lr, grad_clip=cfg.grad_clip),
                           seed=cfg.seed, device=cfg.learner_device)

        self.learner_group = LearnerGroup(
            make_learner, num_learners=cfg.num_learners)
        w = self.learner_group.get_weights()
        self.workers.sync_weights(w)
        self._aggregators: List[Any] = []
        self._h2d = None
        sys_cfg = active_config()
        if sys_cfg.distributed_training and \
                getattr(cfg, "num_aggregators", 0) > 0:
            self._aggregators = [
                _BatchAggregator.options(num_cpus=1).remote()
                for _ in range(cfg.num_aggregators)]
            if sys_cfg.impala_queue_depth > 0:
                self._h2d = _HostToDeviceQueue(
                    sys_cfg.impala_queue_depth,
                    device=resolve_device(cfg.learner_device))
        # Kick off the async pipeline: one outstanding sample per worker —
        # the whole wave goes out in one dispatch pass.
        sample_futs = _bulk_submit([
            (worker.sample, (cfg.rollout_fragment_length,), None)
            for worker in self.workers.workers])
        self._inflight = {self._chain(fut, i): i
                          for i, fut in enumerate(sample_futs)}

    def _chain(self, sample_fut, idx: int):
        """Route a sample future through an aggregator (payload flows
        worker -> aggregator over the data plane); identity when the
        distributed path is off."""
        if not getattr(self, "_aggregators", None):
            return sample_fut
        agg = self._aggregators[idx % len(self._aggregators)]
        return agg.aggregate.remote(
            self.algo_config.rollout_fragment_length, sample_fut)

    def _resubmit(self, worker, idx: int):
        """Weight refresh + resample for one worker in one dispatch pass."""
        _, s_ref = _bulk_submit([
            (worker.set_weights, (self.learner_group.get_weights(),), None),
            (worker.sample, (self.algo_config.rollout_fragment_length,),
             None)])
        self._inflight[self._chain(s_ref, idx)] = idx

    def _to_time_major(self, flat: SampleBatch, frag: int) -> Dict[str, Any]:
        return _to_time_major(flat, frag)

    def training_step(self) -> Dict[str, Any]:
        cfg: ImpalaConfig = self.algo_config
        if getattr(self, "_aggregators", None):
            return self._training_step_distributed(cfg)
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
                # Rebuild the dead worker before resubmitting — resubmitting
                # to a dead handle busy-spins on instantly-errored futures.
                worker = self.workers.recreate(idx)
                self._resubmit(worker, idx)
                continue
            tm = self._to_time_major(flat, cfg.rollout_fragment_length)
            metrics = self.learner_group.update(SampleBatch(tm))
            steps += len(flat)
            processed += 1
            # per-worker weight refresh, then immediately resample (async)
            self._resubmit(worker, idx)
        returns = self.workers.episode_returns()
        if returns:
            metrics["episode_reward_mean"] = float(np.mean(returns))
        metrics["num_env_steps_sampled"] = steps
        return metrics

    def _training_step_distributed(self, cfg: ImpalaConfig) -> Dict[str, Any]:
        """Aggregator-fed variant: the driver receives time-major batches
        (prepped off-driver) and keeps one batch in flight through the h2d
        queue so transfer of batch t+1 overlaps the update of batch t."""
        metrics: Dict[str, Any] = {}
        steps = 0
        processed = 0
        buffered = 0
        while processed < cfg.max_batches_per_step and self._inflight:
            done, _ = ray.wait(list(self._inflight), num_returns=1,
                               timeout=30.0)
            if not done:
                break
            fut = done[0]
            idx = self._inflight.pop(fut)
            worker = self.workers.workers[idx]
            try:
                tm = ray.get(fut)
            except Exception:
                worker = self.workers.recreate(idx)
                self._resubmit(worker, idx)
                continue
            steps += tm[ACTIONS].shape[0] * tm[ACTIONS].shape[1]
            processed += 1
            if self._h2d is not None:
                self._h2d.put(tm)
                buffered += 1
                if buffered > 1:
                    metrics = self.learner_group.update(
                        SampleBatch(self._h2d.get()))
                    buffered -= 1
            else:
                metrics = self.learner_group.update(SampleBatch(
                    _to_device(tm, resolve_device(cfg.learner_device))))
            self._resubmit(worker, idx)
        while buffered > 0:  # drain the double-buffer
            metrics = self.learner_group.update(SampleBatch(self._h2d.get()))
            buffered -= 1
        returns = self.workers.episode_returns()
        if returns:
            metrics["episode_reward_mean"] = float(np.mean(returns))
        metrics["num_env_steps_sampled"] = steps
        return metrics

    def save_checkpoint(self):
        return self.learner_group.state()

    def load_checkpoint(self, state):
        self.learner_group.load_state(state)
        self.workers.sync_weights(self.learner_group.get_weights())

    def cleanup(self):
        if getattr(self, "_h2d", None) is not None:
            self._h2d.stop()
        for agg in getattr(self, "_aggregators", []):
            try:
                ray.kill(agg)
            except Exception:
                pass
        self.workers.stop()
