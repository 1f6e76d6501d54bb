"""Policy networks as pure functions of a param tree (counterpart:
``ray_tpu/rllib/models.py``).

The params are the reference's tree, ``{"pi": [{"w", "b"}, ...], "vf":
[...]}``, of tensors: ``apply`` takes the reference's numpy tree converted
leaf by leaf (``train.pipeline_actors.to_device_tree``).  No ``nn.Module``: the
learner differentiates ``apply`` with respect to the leaves, as the
reference's JAX functions are differentiated.  The products are plain
``torch.matmul``, as the reference leaves them to XLA.  torch is imported
where weights are drawn, not at import: a CPU worker that unpickles a
rollout worker or a multi-agent env needs none of it.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import numpy as np


def mlp_init(generator: torch.Generator, sizes) -> List[Dict[str, Any]]:
    """``[{"w", "b"}, ...]`` for ``sizes``: He-normal weights drawn from
    ``generator`` in layer order, zero biases, f32 on its device."""
    import torch

    dev = generator.device
    return [{"w": torch.randn(a, b, generator=generator, device=dev)
             * math.sqrt(2.0 / a),
             "b": torch.zeros(b, device=dev)}
            for a, b in zip(sizes[:-1], sizes[1:])]


def mlp_apply(layers, x: torch.Tensor) -> torch.Tensor:
    """The layers in order, tanh between them, none after the last."""
    for i, lyr in enumerate(layers):
        x = x @ lyr["w"] + lyr["b"]
        if i < len(layers) - 1:
            x = x.tanh()
    return x


class ActorCriticMLP:
    """Shared-nothing actor-critic MLP with categorical policy head."""

    def __init__(self, obs_dim: int, num_actions: int,
                 hidden: Tuple[int, ...] = (64, 64)):
        self.obs_dim = obs_dim
        self.num_actions = num_actions
        self.hidden = tuple(hidden)

    def init(self, generator: torch.Generator) -> Dict[str, Any]:
        """He-normal weights, zero biases, f32 on the generator's device
        (the reference's scheme; ``jax.random``'s numbers are not
        reproduced)."""
        pi_sizes = (self.obs_dim,) + self.hidden + (self.num_actions,)
        vf_sizes = (self.obs_dim,) + self.hidden + (1,)
        return {"pi": mlp_init(generator, pi_sizes),
                "vf": mlp_init(generator, vf_sizes)}

    def apply(self, params, obs: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """obs (B, obs_dim) -> (logits (B, A), value (B,))."""
        logits = mlp_apply(params["pi"], obs)
        value = mlp_apply(params["vf"], obs)[..., 0]
        return logits, value


def sample_action(logits: np.ndarray,
                  rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
    """Categorical sample + logp, numpy-side (rollout hot loop)."""
    z = logits - logits.max(axis=-1, keepdims=True)
    p = np.exp(z)
    p /= p.sum(axis=-1, keepdims=True)
    cum = np.cumsum(p, axis=-1)
    r = rng.random(size=(len(p), 1))
    acts = np.minimum((r > cum).sum(axis=-1), p.shape[-1] - 1)
    logp = np.log(p[np.arange(len(p)), acts] + 1e-20)
    return acts.astype(np.int32), logp.astype(np.float32)
