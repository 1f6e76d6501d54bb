"""Learner / LearnerGroup: the gradient-update half of the RL stack
(counterpart: ``ray_tpu/rllib/learner.py``).

Reference: ``rllib/core/learner/learner.py:89`` + ``learner_group.py:51``.
One Learner owns its device; ``update(batch)`` is loss -> autograd ->
the optimizer (``train.core.adam`` behind a global-norm clip, optax's
``chain(clip_by_global_norm, adam)``), eagerly on that device.  Weights
and optimizer state go in and out as numpy trees.

Data parallelism (``num_learners=N > 1``, the reference's dp mesh):
the Learner keeps N replicas of its params, one per device (the CPU
for a CPU learner, cards 0..N-1 for a card learner), and the module the
loss sees splits every batch's rows over them and concatenates the
outputs.  The loss is then the whole batch's, and the sum of the
replicas' grads is its gradient — the reference's sharded program, for
any loss (PPO's advantage normalisation included).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List

import numpy as np
import torch

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.rllib.sample_batch import SampleBatch
from ray_tpu_torch.train.core import adam, global_norm
from ray_tpu_torch.train.pipeline_actors import (
    to_device_tree, to_numpy_tree)
from ray_tpu_torch.train.trees import tree_leaves, tree_map, tree_unflatten


def grad_step(params, opt_state, optimizer, loss_fn: Callable):
    """One optimizer step on ``params`` (and ``opt_state``) in place:
    ``loss_fn(live)`` gives ``(loss, aux)`` at a copy of ``params`` whose
    leaves require grad (jax's ``value_and_grad(has_aux=True)`` then
    optax's update).  Returns the loss and aux, detached."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    with torch.enable_grad():
        loss, aux = loss_fn(tree_unflatten(params, leaves))
        # A leaf the loss does not use gets a zero grad, as under jax.grad.
        grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
    optimizer.update_(tree_unflatten(params, grads), opt_state, params,
                      global_norm(grads))
    return loss.detach(), tree_map(lambda t: t.detach(), aux)


class _DataParallel:
    """``module`` over replicas: ``apply(replicas, obs)`` runs rows
    ``obs.tensor_split(len(replicas))[i]`` through replica i on its
    device and concatenates the outputs on the first."""

    def __init__(self, module):
        self._module = module

    def apply(self, replicas: List[Any], obs: torch.Tensor):
        home = obs.device
        outs = []
        for params, rows in zip(replicas,
                                obs.tensor_split(len(replicas))):
            dev = tree_leaves(params)[0].device
            outs.append(self._module.apply(params, rows.to(dev)))
        return tuple(torch.cat([o[j].to(home) for o in outs])
                     for j in range(len(outs[0])))


class Learner:
    """Holds params + optimizer on ``device`` (None: the card)."""

    def __init__(self, module, loss_fn: Callable, *, optimizer=None,
                 seed: int = 0, device=None):
        self.module = module
        self._loss_fn = loss_fn
        self._optimizer = optimizer or adam(3e-4, grad_clip=0.5)
        self._dev = resolve_device(device)
        # Drawn on the CPU so a seed gives the same weights on any device.
        self.params = to_device_tree(module.init(
            torch.Generator().manual_seed(seed)), self._dev)
        self._opt_state = self._optimizer.init(self.params)
        self._devices = [self._dev]

    @property
    def device(self) -> torch.device:
        return self._dev

    def set_replicas(self, n: int) -> None:
        """Data-parallel over ``n`` replicas (see the module docstring);
        a card learner needs ``n`` cards."""
        n = max(1, n)
        if self._dev.type == "cuda":
            if torch.cuda.device_count() < n:
                raise RuntimeError(
                    f"{n} learner replicas need {n} cards, "
                    f"{torch.cuda.device_count()} visible")
            self._devices = [torch.device("cuda", i) for i in range(n)]
        else:
            self._devices = [self._dev] * n

    def _to_device(self, v) -> torch.Tensor:
        if isinstance(v, torch.Tensor):
            return v.to(self._dev)
        return torch.from_numpy(np.ascontiguousarray(v)).to(self._dev)

    def update(self, batch: SampleBatch) -> Dict[str, float]:
        dev_batch = {k: self._to_device(v) for k, v in batch.items()}
        leaves = [p.detach().requires_grad_()
                  for p in tree_leaves(self.params)]
        replicas = [leaves] + [
            [p.detach().to(d).requires_grad_() for p in leaves]
            for d in self._devices[1:]]
        trees = [tree_unflatten(self.params, r) for r in replicas]
        with torch.enable_grad():
            if len(trees) > 1:
                loss, metrics = self._loss_fn(
                    trees, _DataParallel(self.module), dev_batch)
            else:
                loss, metrics = self._loss_fn(trees[0], self.module,
                                              dev_batch)
            # A leaf the loss does not use (BC's value head) gets a zero
            # grad, as under jax.grad.
            per = torch.autograd.grad(loss, [p for r in replicas
                                             for p in r],
                                      materialize_grads=True)
        n = len(leaves)
        grads = list(per[:n])
        for i in range(1, len(replicas)):
            grads = [g + h.to(self._dev)
                     for g, h in zip(grads, per[i * n:(i + 1) * n])]
        norm = global_norm(grads)
        self._optimizer.update_(tree_unflatten(self.params, grads),
                                self._opt_state, self.params, norm)
        out = {k: float(v.detach()) for k, v in metrics.items()}
        out.update(total_loss=float(loss.detach()), grad_norm=float(norm))
        return out

    def get_weights(self):
        return to_numpy_tree(self.params)

    def set_weights(self, weights):
        self.params = to_device_tree(weights, self._dev)
        self._opt_state = self._optimizer.init(self.params)

    def state(self):
        return {"params": to_numpy_tree(self.params),
                "opt_state": to_numpy_tree(self._opt_state)}

    def load_state(self, state):
        self.params = to_device_tree(state["params"], self._dev)
        self._opt_state = to_device_tree(state["opt_state"], self._dev)


class LearnerGroup:
    """Reference: rllib/core/learner/learner_group.py:51 (the scaling
    config's num_learners).  ``num_learners=N > 1`` makes the one
    Learner data-parallel over N replicas (``Learner.set_replicas``).
    ``remote=True`` places it in an actor granted ``num_tpus`` cards: a
    granted learner runs on its card (its factory's ``device=None``)."""

    def __init__(self, learner_factory: Callable[[], Learner],
                 remote: bool = False, num_tpus: int = 0,
                 num_learners: int = 0):
        self._remote = remote

        def build() -> Learner:
            lr = learner_factory()
            if num_learners and num_learners > 1:
                lr.set_replicas(num_learners)
            return lr

        if remote:
            import ray_tpu_torch as ray

            @ray.remote
            class _LearnerActor:
                def __init__(self):
                    self.learner = build()

                def update(self, batch):
                    return self.learner.update(batch)

                def get_weights(self):
                    return self.learner.get_weights()

                def state(self):
                    return self.learner.state()

                def load_state(self, s):
                    return self.learner.load_state(s)

                def device(self):
                    return str(self.learner.device)

            self._actor = _LearnerActor.options(
                num_tpus=num_tpus, num_cpus=1).remote()
            self._ray = ray
        else:
            self._learner = build()

    def update(self, batch: SampleBatch) -> Dict[str, float]:
        if self._remote:
            return self._ray.get(self._actor.update.remote(batch))
        return self._learner.update(batch)

    def get_weights(self):
        if self._remote:
            return self._ray.get(self._actor.get_weights.remote())
        return self._learner.get_weights()

    def state(self):
        if self._remote:
            return self._ray.get(self._actor.state.remote())
        return self._learner.state()

    def load_state(self, s):
        if self._remote:
            return self._ray.get(self._actor.load_state.remote(s))
        return self._learner.load_state(s)

    def device(self) -> str:
        """The learner's device, as seen in its own process."""
        if self._remote:
            return self._ray.get(self._actor.device.remote())
        return str(self._learner.device)
